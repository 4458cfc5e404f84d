"""PyTorch port: the parse-tree programs and the tree models
(`nlp/tree.py`, `models/rntn.py`, `models/recursive_autoencoder.py`)
against the JAX package's, on the CPU.

- `compile_trees`: the arrays are bitwise equal to JAX's;
- initial parameters: bitwise equal (both draw numpy ``default_rng``);
- RNTN and RAE loss and gradients against ``jax.value_and_grad`` of JAX's
  `_batch_logits` / `_forward` with the loss written out as JAX's fit
  writes it: loss within 1e-6 relative, every gradient within 1e-5
  relative max error (max |g - g_jax| / max |g_jax|, a leaf);
- three epochs of `fit`: the loss curve within 1e-5 relative, the
  parameters within 1e-4; `predict`, `predict_nodes` and `RNTNEval`'s
  counts equal; a JAX model's parameters carried across give JAX's
  predictions, and the port's tensors never alias the source arrays.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import rntn as jrntn
from deeplearning4j_tpu.models import recursive_autoencoder as jrae
from deeplearning4j_tpu.nlp import tree as jtree
from deeplearning4j_tpu_torch.models import rntn as trntn
from deeplearning4j_tpu_torch.models import recursive_autoencoder as trae
from deeplearning4j_tpu_torch.nlp import tree as ttree
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

SENTIMENT = [
    "(1 (1 good) (1 movie))",
    "(1 (1 great) (1 film))",
    "(0 (0 bad) (1 movie))",
    "(0 (0 awful) (1 film))",
    "(0 (0 not) (1 good))",
    "(1 (0 not) (0 bad))",
    "(1 (1 (1 very) (1 good)) (1 movie))",
    "(0 (0 (0 very) (0 bad)) (1 film))",
    "(3 (2 (2 a) (4 (2 truly) (4 (3 fine) (2 film)))) (2 .))",
    "(1 (2 it) (1 (2 (2 is) (1 dull)) (2 (2 and) (1 (1 slow) (2 .)))))",
    "(2 (2 x) (2 y) (3 z))",
]
ROOT_ONLY = ["(1 (good) (movie))", "(0 (bad) (film))",
             "(1 (not) ((very) (bad)))", "(0 (dull) ((slow) (plot)))"]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _random_trees(pkg, n, seed, vocab=30, labelled=True):
    """Seeded right-branching trees of 1-9 tokens with labels 0-4 on
    every node (or none)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = [f"w{i}" for i in rng.integers(0, vocab, rng.integers(1, 10))]
        t = pkg.right_branching(toks)
        for node in t.nodes():
            node.label = int(rng.integers(0, 5)) if labelled else None
        out.append(t)
    return out


def _corpora(pkg):
    return {"tiny": [pkg.parse_ptb(s) for s in SENTIMENT[:8]],
            "sentiment": [pkg.parse_ptb(s) for s in SENTIMENT],
            "root_only": [pkg.parse_ptb(s) for s in ROOT_ONLY],
            "random": _random_trees(pkg, 12, 3),
            "unlabelled": _random_trees(pkg, 5, 4, labelled=False)}


@pytest.mark.parametrize("name", ["sentiment", "root_only", "random",
                                  "unlabelled"])
@pytest.mark.parametrize("max_nodes", [None, 24])
def test_compile_trees_arrays_are_bitwise_jax(name, max_nodes):
    jt, tt = _corpora(jtree)[name], _corpora(ttree)[name]
    vocab = {"<unk>": 0, "good": 1, "movie": 2, "w3": 3, "w7": 4, "bad": 5}
    want = jtree.compile_trees(jt, vocab, max_nodes)
    got = ttree.compile_trees(tt, vocab, max_nodes)
    assert got.n_nodes == want.n_nodes and len(got) == len(want)
    for field in ("is_leaf", "word", "left", "right", "label", "mask",
                  "labeled", "root"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_tree_surface_matches_jax():
    for s in SENTIMENT + ROOT_ONLY:
        j, t = jtree.parse_ptb(s), ttree.parse_ptb(s)
        assert t.tokens() == j.tokens() and t.depth() == j.depth()
        assert ([n.label for n in t.binarize().nodes()]
                == [n.label for n in j.binarize().nodes()])
    with pytest.raises(ValueError):
        ttree.parse_ptb("(1 a) (2 b)")
    with pytest.raises(ValueError):
        ttree.right_branching([])
    with pytest.raises(ValueError, match="max_nodes"):
        ttree.compile_trees([ttree.parse_ptb(SENTIMENT[-2])], {}, 3)


def _jax_rntn(trees, **kw):
    m = jrntn.RNTN(**kw)
    m._build_vocab(trees)
    return m


def _jax_rntn_loss(params, arrays, reg):
    """JAX's RNTN objective as its fit writes it (rntn.py:109-121)."""
    is_leaf, word, left, right, label, mask = arrays
    _, logits = jrntn._batch_logits(params, (is_leaf, word, left, right))
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, label[..., None], axis=-1)[..., 0]
    data = jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)
    l2 = sum(jnp.sum(p * p) for k, p in params.items()
             if k not in ("b", "bs"))
    return data + reg * l2


def _check_grads(loss, grads, jloss, jgrads, tol=1e-5):
    assert _rel(float(loss), float(jloss)) <= 1e-6
    assert sorted(grads) == sorted(jgrads)
    for k in jgrads:
        assert grads[k].shape == jgrads[k].shape, k
        assert _rel(grads[k], jgrads[k]) <= tol, (k, _rel(grads[k],
                                                           jgrads[k]))


@pytest.mark.parametrize("name,d,c", [("sentiment", 6, 5),
                                      ("root_only", 4, 2),
                                      ("random", 8, 5)])
def test_rntn_init_loss_and_gradients_match_jax(name, d, c):
    trees = _corpora(jtree)[name]
    jm = _jax_rntn(trees, num_classes=c, d=d, reg=1e-3, seed=2)
    jparams = jm._init_params()
    tm = trntn.RNTN(num_classes=c, d=d, reg=1e-3, seed=2, device="cpu")
    tm._build_vocab(_corpora(ttree)[name])
    assert tm.vocab == jm.vocab
    init = tm._init_params()
    for k, v in jparams.items():
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(v), k)

    prog = jtree.compile_trees(trees, jm.vocab, max_nodes=20)
    jarrays = tuple(jnp.asarray(a) for a in (
        prog.is_leaf, prog.word, prog.left, prog.right, prog.label,
        prog.mask * prog.labeled))
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_rntn_loss))(
        jparams, jarrays, 1e-3)
    loss, grads = trntn.loss_and_grads(
        trntn.loss_fn, init, trntn.program_arrays(prog, "cpu"), 1e-3)
    _check_grads(loss, grads, jloss, jgrads)


def _jax_rae_loss(params, arrays):
    """JAX's autoencoder objective as its fit writes it."""
    is_leaf, word, left, right, mask = arrays
    _, errs = jax.vmap(lambda il, w, l, r: jrae.RecursiveAutoEncoder
                       ._forward(params, il, w, l, r))(is_leaf, word, left,
                                                       right)
    return jnp.sum(errs * mask) / jnp.maximum(jnp.sum(mask), 1.0)


@pytest.mark.parametrize("name,d", [("sentiment", 6), ("random", 8)])
def test_rae_loss_and_gradients_match_jax(name, d):
    trees = _corpora(jtree)[name]
    jm = jrae.RecursiveAutoEncoder(d=d, seed=1)
    for t in trees:
        for w in t.tokens():
            jm.vocab.setdefault(w, len(jm.vocab))
    jparams = jm._init_params()
    tm = trae.RecursiveAutoEncoder(d=d, seed=1, device="cpu")
    tm.vocab = dict(jm.vocab)
    init = tm._init_params()
    for k, v in jparams.items():
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(v), k)
    prog = jtree.compile_trees(trees, jm.vocab)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_rae_loss))(
        jparams, tuple(jnp.asarray(a) for a in (
            prog.is_leaf, prog.word, prog.left, prog.right, prog.mask)))
    arrays = trntn.program_arrays(prog, "cpu", with_targets=False) + (
        torch.from_numpy(prog.mask),)
    loss, grads = trntn.loss_and_grads(trae.loss_fn, init, arrays)
    _check_grads(loss, grads, jloss, jgrads)


def _fit_pair(name, **kw):
    jm = jrntn.RNTN(**kw).fit(_corpora(jtree)[name])
    tm = trntn.RNTN(device="cpu", **kw).fit(_corpora(ttree)[name])
    return jm, tm


@pytest.mark.parametrize("name,kw", [
    ("tiny", dict(num_classes=2, d=8, lr=0.1, epochs=3, seed=0)),
    ("sentiment", dict(num_classes=5, d=8, lr=0.1, epochs=3, seed=3)),
    ("random", dict(num_classes=5, d=6, lr=0.05, epochs=3, seed=1,
                    max_nodes=20))])
def test_rntn_fit_predict_and_eval_match_jax(name, kw):
    jm, tm = _fit_pair(name, **kw)
    assert len(tm.losses) == 3
    assert _rel(tm.losses, jm.losses) <= 1e-5
    for k, v in jm.params.items():
        assert _rel(tm.params[k], v) <= 1e-4, k
    jt, tt = _corpora(jtree)[name], _corpora(ttree)[name]
    np.testing.assert_array_equal(tm.predict(tt), jm.predict(jt))
    for a, b in zip(tm.predict_nodes(tt), jm.predict_nodes(jt)):
        np.testing.assert_array_equal(a, b)
    jev, tev = jrntn.RNTNEval(), trntn.RNTNEval()
    jev.eval(jm, jt)
    tev.eval(tm, tt)
    assert vars(tev) == vars(jev)
    assert tev.stats() == jev.stats()


def test_params_from_numpy_gives_jax_predictions_and_copies():
    jm = jrntn.RNTN(num_classes=2, d=8, lr=0.1, epochs=30, seed=0).fit(
        _corpora(jtree)["tiny"])
    src = {k: np.array(v) for k, v in jm.params.items()}
    tm = trntn.RNTN.from_numpy(src, jm.vocab, device="cpu")
    assert (tm.d, tm.num_classes) == (8, 2) and tm.vocab == jm.vocab
    trees = _corpora(ttree)["sentiment"] + _corpora(ttree)["root_only"]
    jtrees = _corpora(jtree)["sentiment"] + _corpora(jtree)["root_only"]
    # unseen words and wider trees than the fit saw go through <unk>
    want = jm.predict(jtrees)
    np.testing.assert_array_equal(tm.predict(trees), want)
    for a, b in zip(tm.predict_nodes(trees), jm.predict_nodes(jtrees)):
        np.testing.assert_array_equal(a, b)
    src["Ws"][:] = 0.0            # the port holds copies, not views
    src["bs"][:] = 0.0
    np.testing.assert_array_equal(tm.predict(trees), want)
    for k, v in tm.params.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jm.params[k]))


def test_rae_fit_and_encode_match_jax():
    texts = ("the cat sat", "the dog ran", "a cat ran", "the dog sat",
             "a dog sat on the mat", "the cat ran home")
    jm = jrae.RecursiveAutoEncoder(d=12, lr=0.05, epochs=3, seed=1).fit(
        [jtree.right_branching(s.split()) for s in texts])
    ttrees = [ttree.right_branching(s.split()) for s in texts]
    tm = trae.RecursiveAutoEncoder(d=12, lr=0.05, epochs=3, seed=1,
                                   device="cpu").fit(ttrees)
    assert _rel(tm.losses, jm.losses) <= 1e-5
    for k, v in jm.params.items():
        assert _rel(tm.params[k], v) <= 1e-4, k
    want = jm.encode([jtree.right_branching(s.split()) for s in texts])
    got = tm.encode(ttrees)
    assert got.shape == (6, 12) and _rel(got, want) <= 1e-4
    carried = trae.RecursiveAutoEncoder.from_numpy(
        {k: np.asarray(v) for k, v in jm.params.items()}, jm.vocab,
        device="cpu")
    assert _rel(carried.encode(ttrees), want) <= 1e-6


def test_padded_nodes_get_no_gradient_and_leave_the_loss_alone():
    """Padding a batch to more nodes changes neither the loss nor any
    gradient: a padded node combines buf[0] with itself, the mask drops
    it, and the unselected branch of the leaf/combine select carries no
    gradient."""
    trees = _corpora(ttree)["sentiment"]
    m = trntn.RNTN(num_classes=5, d=6, seed=0, device="cpu")
    m._build_vocab(trees)
    params = m._init_params()
    out = []
    for max_nodes in (None, 40):
        prog = ttree.compile_trees(trees, m.vocab, max_nodes)
        out.append(trntn.loss_and_grads(trntn.loss_fn, params,
                                        trntn.program_arrays(prog, "cpu"),
                                        1e-4))
    (l0, g0), (l1, g1) = out
    assert _rel(l1, l0) <= 1e-6
    for k in g0:
        assert _rel(g1[k], g0[k]) <= 1e-6, k


def test_rntn_learns_the_tiny_grammar_on_the_port():
    """JAX's `TestRNTN.test_learns_tiny_sentiment` on the port."""
    trees = _corpora(ttree)["tiny"]
    model = trntn.RNTN(num_classes=2, d=8, lr=0.1, epochs=150, seed=0,
                       device="cpu").fit(trees)
    assert model.losses[-1] < model.losses[0]
    ev = trntn.RNTNEval()
    ev.eval(model, trees)
    assert ev.root_accuracy() == 1.0, ev.stats()
    assert ev.node_accuracy() > 0.8, ev.stats()
