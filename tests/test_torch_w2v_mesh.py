"""PyTorch port, slice 18: Word2Vec and GloVe ``mesh=`` (the port's
counterparts of `tests/test_w2v_mesh.py:39-93`, and held against JAX's
``mesh=`` on the same corpus).

The pair (or COO) batch is cut over the mesh's first axis, every shard
computes its sparse (row, delta) pieces, the pieces are gathered in
shard order and one scatter updates the tables.  On the CPU the scatter
adds in order, so a mesh of any width trains the single-device tables
exactly: hierarchical softmax and GloVe have no randomness, and the
port draws a step's negatives for the whole batch before sharding it.
Against JAX: HS and GloVe tables within the single-device parity bound
of `tests/test_torch_nlp.py` (1e-5), NEG by the learned structure (JAX
draws per-shard negatives from threefry).
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.nlp.glove import Glove as JGlove
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JW2V
from deeplearning4j_tpu.parallel import make_mesh as jmesh
from deeplearning4j_tpu_torch.nlp.glove import Glove as TGlove
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec as TW2V
from deeplearning4j_tpu_torch.parallel import make_mesh as tmesh
from deeplearning4j_tpu_torch.parallel import mesh as tmesh_lib
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


@pytest.fixture(scope="module")
def corpus():
    """Two disjoint topic clusters (w0-49 vs w50-99), JAX's fixture."""
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(100)]
    sents = []
    for k in range(400):
        lo = 0 if k % 2 == 0 else 50
        sents.append(" ".join(
            vocab[lo + int(rng.integers(0, 50))] for _ in range(12)))
    return sents


def _mesh(n=4):
    return tmesh((n,), ("data",), devices=["cpu"] * n)


def _train(corpus, mesh, negative, epochs=3, learning_rate=0.025,
           cls=TW2V, **kw):
    w = cls(vector_length=32, window=3, negative=negative, epochs=epochs,
            learning_rate=learning_rate, batch_size=512, seed=7, mesh=mesh,
            **kw)
    return w.fit(corpus)


def test_hs_mesh_training_matches_single_device_exactly(corpus):
    single = _train(corpus, None, 0, device="cpu")
    sharded = _train(corpus, _mesh(), 0, device="cpu")
    np.testing.assert_array_equal(single.syn0, sharded.syn0)
    np.testing.assert_array_equal(single.syn1, sharded.syn1)


def test_neg_mesh_training_converges_like_single_device(corpus):
    single = _train(corpus, None, 5, epochs=8, learning_rate=0.05,
                    device="cpu")
    sharded = _train(corpus, _mesh(), 5, epochs=8, learning_rate=0.05,
                     device="cpu")
    rng = np.random.default_rng(1)
    for w2v in (single, sharded):
        within = np.mean([w2v.similarity(f"w{a}", f"w{b}")
                          for a, b in rng.integers(0, 50, (20, 2))])
        across = np.mean([w2v.similarity(f"w{a}", f"w{b + 50}")
                          for a, b in rng.integers(0, 50, (20, 2))])
        assert within > across + 0.1, (within, across)
    assert abs(single.similarity("w10", "w12")
               - sharded.similarity("w10", "w12")) < 0.15
    # the whole batch's negatives are drawn before it is sharded
    np.testing.assert_array_equal(single.syn0, sharded.syn0)


def test_mesh_batch_size_rounds_up_to_shardable():
    w = TW2V(batch_size=1022, mesh=_mesh(), device="cpu")
    assert w.batch_size == 1024
    assert tmesh_lib.round_batch_to_mesh(1022, _mesh()) == \
        jax_round(1022, 4)


def jax_round(b, n):
    from deeplearning4j_tpu.parallel.mesh import round_batch_to_mesh

    return round_batch_to_mesh(b, jmesh((n,), ("data",),
                                        devices=jax.devices()[:n]))


def _glove(cls, corpus, mesh, **kw):
    g = cls(vector_length=16, window=4, epochs=5, batch_size=512, seed=3,
            mesh=mesh, **kw)
    return g.fit(corpus[:120])


def test_glove_mesh_matches_single_device(corpus):
    single = _glove(TGlove, corpus, None, device="cpu")
    sharded = _glove(TGlove, corpus, _mesh(), device="cpu")
    np.testing.assert_array_equal(single.syn0, sharded.syn0)
    assert sharded.losses[-1] < sharded.losses[0]


@pytest.mark.parametrize("n", [2, 4])
def test_hs_and_glove_mesh_match_jax_mesh(corpus, n):
    jm = jmesh((n,), ("data",), devices=jax.devices()[:n])
    j = _train(corpus[:200], jm, 0, epochs=2, cls=JW2V)
    t = _train(corpus[:200], _mesh(n), 0, epochs=2, device="cpu")
    assert j.batch_size == t.batch_size
    np.testing.assert_allclose(t.syn0, np.asarray(j.syn0), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t.syn1, np.asarray(j.syn1), rtol=0,
                               atol=1e-5)
    jg = _glove(JGlove, corpus, jm)
    tg = _glove(TGlove, corpus, _mesh(n), device="cpu")
    np.testing.assert_allclose(tg.syn0, np.asarray(jg.syn0), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tg.losses, jg.losses, rtol=1e-5)


def test_neg_mesh_learns_jax_meshs_structure(corpus):
    jm = jmesh((4,), ("data",), devices=jax.devices()[:4])
    j = _train(corpus, jm, 5, epochs=8, learning_rate=0.05, cls=JW2V)
    t = _train(corpus, _mesh(), 5, epochs=8, learning_rate=0.05,
               device="cpu")
    rng = np.random.default_rng(2)
    pairs = rng.integers(0, 50, (20, 2))
    for w2v in (j, t):
        within = np.mean([w2v.similarity(f"w{a}", f"w{b}")
                          for a, b in pairs])
        across = np.mean([w2v.similarity(f"w{a}", f"w{b + 50}")
                          for a, b in pairs])
        assert within > across + 0.1, (within, across)
    assert abs(j.similarity("w10", "w12") - t.similarity("w10", "w12")) \
        < 0.15
