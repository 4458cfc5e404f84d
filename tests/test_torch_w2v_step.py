"""PyTorch port: the sparse Word2Vec and GloVe steps against the JAX
package's.

The same tables and batch (numpy, from a seed) go through JAX's
`_build_hs_step` / `_build_neg_step` (its negatives drawn from the key,
then fed to the port's step) and GloVe's `_build_step`, and through the
port's `hs_step`, `neg_step` and `glove_step` on the CPU.  Every batch
holds duplicate rows (their deltas add up); the HS batch holds pairs whose
dot saturates (|dot| >= 6, no update).  Tolerance: relative 1e-6 of the
largest value for the tables.  The loss is a float32 sum of N masked
terms whose order differs between XLA and torch, so JAX's own loss can
lie more than 1e-6 from the float64 sum at these sizes: the port's loss
is held to a float64 recompute at 1e-6 and to JAX's at N * 2**-24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp.glove import Glove as JGlove
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JWord2Vec
from deeplearning4j_tpu_torch.nlp import word2vec as tw
from deeplearning4j_tpu_torch.nlp.glove import glove_step
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

REL = 1e-6
B = 96


def _sentences(seed=0, vocab=60, n=40, length=10):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    # a zipf-ish draw, so the Huffman paths have several lengths
    p = 1.0 / np.arange(1, vocab + 1)
    return [" ".join(rng.choice(words, length, p=p / p.sum()))
            for _ in range(n)]


def _jax_model(negative):
    w = JWord2Vec(vector_length=16, window=3, negative=negative, epochs=1,
                  batch_size=B, seed=5)
    w.build_vocab(w._sentences_to_tokens(_sentences()))
    w.reset_weights()
    return w


def _batch(v, seed):
    """Inputs and targets with heavy duplication, and a valid mask with a
    padded tail."""
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, v, B).astype(np.int32)
    inputs[:24] = 3                                 # one row, many times
    targets = rng.integers(0, v, B).astype(np.int32)
    targets[24:40] = 0                              # the most frequent word
    valid = np.ones(B, np.int32)
    valid[-7:] = 0
    return inputs, targets, valid


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check_loss(loss, jloss, exact, n_terms):
    assert _rel(loss.item(), exact) <= REL
    assert _rel(loss.item(), float(jloss)) <= n_terms * 2.0 ** -24


def _log_sigmoid(x):
    return -np.logaddexp(0.0, -x)


def _hs_loss64(syn0, syn1, points, codes, lengths, inputs, targets, valid):
    mask = ((np.arange(points.shape[1])[None, :]
             < lengths[targets][:, None]) * valid[:, None])
    dots = np.einsum("bd,bld->bl", syn0[inputs].astype(np.float64),
                     syn1[points[targets]].astype(np.float64))
    sign = 1.0 - 2.0 * codes[targets]
    return -np.sum(_log_sigmoid(sign * dots) * mask), int(mask.sum())


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _port_hs(w):
    return tuple(_t(a).long() for a in w.vocab.hs_arrays())


@pytest.mark.parametrize("trained", [False, True])
def test_hs_step_matches_jax(trained):
    w = _jax_model(negative=0)
    rng = np.random.default_rng(7)
    syn0 = w.syn0.copy()
    syn1 = (rng.standard_normal(w.syn1.shape).astype(np.float32) * 0.3
            if trained else w.syn1.copy())
    inputs, targets, valid = _batch(len(w.vocab), seed=1)
    if trained:
        # saturate two pairs: a large input row aligned with a target's
        # whole Huffman path
        points, _, lengths = w.vocab.hs_arrays()
        syn0[inputs[50]] = 2.0
        syn1[points[targets[50], :lengths[targets[50]]]] = 2.0
    lr = 0.05
    j0, j1, jloss = w._step(jnp.asarray(syn0), jnp.asarray(syn1),
                            jnp.asarray(inputs), jnp.asarray(targets),
                            jnp.float32(lr), jax.random.PRNGKey(0),
                            jnp.asarray(valid))
    t0, t1 = _t(syn0), _t(syn1)
    loss = tw.hs_step(t0, t1, _port_hs(w), _t(inputs).long(),
                      _t(targets).long(), lr, _t(valid, torch.float32))
    _check_loss(loss, jloss, *_hs_loss64(syn0, syn1, *w.vocab.hs_arrays(),
                                         inputs, targets, valid))
    assert _rel(t0.numpy(), j0) <= REL
    assert _rel(t1.numpy(), j1) <= REL
    if trained:
        # the saturated pair moved nothing: its |dot| >= MAX_EXP
        dots = syn1[points[targets[50], :lengths[targets[50]]]] @ \
            syn0[inputs[50]]
        assert (np.abs(dots) >= tw.MAX_EXP).all()


def test_hs_step_with_no_valid_pair_changes_nothing():
    """Padded pairs and padded path columns index real rows (row 0 of
    syn1 among them) with an exactly zero delta."""
    w = _jax_model(negative=0)
    rng = np.random.default_rng(3)
    syn1 = rng.standard_normal(w.syn1.shape).astype(np.float32)
    inputs, targets, _ = _batch(len(w.vocab), seed=2)
    t0, t1 = _t(w.syn0), _t(syn1)
    loss = tw.hs_step(t0, t1, _port_hs(w), _t(inputs).long(),
                      _t(targets).long(), 0.05, torch.zeros(B))
    assert loss.item() == 0.0
    np.testing.assert_array_equal(t0.numpy(), w.syn0)
    np.testing.assert_array_equal(t1.numpy(), syn1)


def _jax_negatives(w, key, n):
    table = np.asarray(w._neg_table)
    idx = np.asarray(jax.random.randint(key, (n, w.negative), 0,
                                        table.shape[0]))
    return table[idx]


@pytest.mark.parametrize("seed", [4, 11])
def test_neg_step_matches_jax_with_its_negatives(seed):
    """JAX's step draws its negatives from `key`; the test replays that
    draw and feeds it to the port's step.  The batch's targets repeat the
    most frequent word, so some negatives collide with their target (and
    are masked out on both sides)."""
    w = _jax_model(negative=5)
    rng = np.random.default_rng(seed)
    syn1n = rng.standard_normal(w.syn1neg.shape).astype(np.float32) * 0.3
    inputs, targets, valid = _batch(len(w.vocab), seed=seed)
    key = jax.random.PRNGKey(seed)
    negs = _jax_negatives(w, key, B)
    assert (negs == targets[:, None]).any()
    assert len(np.unique(negs)) < negs.size          # duplicate rows
    j0, j1, jloss = w._step(jnp.asarray(w.syn0), jnp.asarray(syn1n),
                            jnp.asarray(inputs), jnp.asarray(targets),
                            jnp.float32(0.03), key, jnp.asarray(valid))
    t0, t1 = _t(w.syn0), _t(syn1n)
    loss = tw.neg_step(t0, t1, _t(inputs).long(), _t(targets).long(),
                       _t(negs).long(), 0.03, _t(valid, torch.float32))
    h = w.syn0[inputs].astype(np.float64)
    pos_dot = np.sum(h * syn1n[targets], axis=1)
    neg_dot = np.einsum("bd,bkd->bk", h, syn1n[negs].astype(np.float64))
    neg_mask = np.where(negs == targets[:, None], 0.0, valid[:, None])
    exact = -(np.sum(_log_sigmoid(pos_dot) * valid)
              + np.sum(_log_sigmoid(-neg_dot) * neg_mask))
    _check_loss(loss, jloss, exact, int(valid.sum() + neg_mask.sum()))
    assert _rel(t0.numpy(), j0) <= REL
    assert _rel(t1.numpy(), j1) <= REL


def test_hs_step_stays_finite_where_one_row_gets_most_of_a_batch():
    """The MAX_EXP skip is the stability guard: one input row receiving
    hundreds of same-direction contributions per batch stays finite."""
    w = _jax_model(negative=0)
    hs = _port_hs(w)
    t0, t1 = _t(w.syn0), _t(w.syn1)
    rng = np.random.default_rng(11)
    b = 512
    for _ in range(120):
        inputs = np.where(rng.random(b) < 0.6, 3,
                          rng.integers(0, len(w.vocab), b))
        targets = rng.integers(0, len(w.vocab), b)
        loss = tw.hs_step(t0, t1, hs, _t(inputs).long(), _t(targets).long(),
                          0.025, torch.ones(b))
    assert torch.isfinite(t0).all() and torch.isfinite(loss)
    assert float(t0.norm(dim=1).max()) < 100.0


def test_glove_step_matches_jax():
    rng = np.random.default_rng(0)
    g = JGlove(vector_length=8, window=3, epochs=1, batch_size=B, seed=1)
    g.vocab.fit(g._tokenize_all(_sentences(seed=1, vocab=30, n=30)))
    g._init_params()
    v = len(g.vocab)
    ii = rng.integers(0, v, B).astype(np.int32)
    jj = rng.integers(0, v, B).astype(np.int32)
    ii[:20] = 2                                   # duplicate rows
    jj[10:30] = 2
    xx = rng.random(B).astype(np.float32) * 5 + 0.5
    valid = (rng.random(B) < 0.9).astype(np.float32)
    # a warm accumulator, so the batch-inclusive denominator matters
    params = [np.asarray(p) for p in g._params]
    ada = [rng.random(np.shape(p)).astype(np.float32) for p in params]
    jp, jh, jloss = g._step(tuple(jnp.asarray(p) for p in params),
                            tuple(jnp.asarray(h) for h in ada),
                            jnp.asarray(ii), jnp.asarray(jj),
                            jnp.asarray(xx), jnp.asarray(valid))
    tp = tuple(_t(p) for p in params)
    th = tuple(_t(h) for h in ada)
    loss = glove_step(tp, th, _t(ii).long(), _t(jj).long(), _t(xx),
                      _t(valid), g.learning_rate, g.x_max, g.alpha)
    w, wc, b, bc = (p.astype(np.float64) for p in params)
    diff = (np.sum(w[ii] * wc[jj], 1) + b[ii] + bc[jj]
            - np.log(xx.astype(np.float64)))
    e = valid * np.minimum((xx / g.x_max) ** g.alpha, 1.0) * diff
    _check_loss(loss, jloss, 0.5 * np.sum(e * diff), int(valid.sum()))
    for got, want in zip(tp + th, tuple(jp) + tuple(jh)):
        assert _rel(got.numpy(), want) <= REL
