"""PyTorch port, slice 19: `HybridParallelTrainer` and the mesh half of
`transformer` against the JAX package's.

The JAX trainer runs on the conftest's 8 virtual CPU devices as a
(data 2, seq 2, model 2) mesh; the port's on 8 host shards
(``devices=["cpu"] * 8``), started from the JAX trainer's own initial
weights (``export_params`` before any step: JAX's threefry init is not
reproducible in torch).  The same numpy batches go through both.

Tolerances: dense SGD losses within 1e-5 and every leaf within 5e-5
after 3 steps; Adam within JAX's own 1e-4 / 5e-4 (its first steps move
an element near its rounding noise by about lr); MoE with dropped
tokens within 1e-5 / 5e-5 (the same routing, which pins the global
capacity and order).  Inside the port, ZeRO-1 equals the replicated
update bitwise.

Remat on the mesh recomputes the whole block, ring included, as
``jax.checkpoint(block)`` does: with ``remat`` the trainers match JAX's
(remat on too) at the tolerances above, the ring's forward runs twice a
block pair and step (counted by wrapping the plain forward it calls),
and the bytes autograd keeps grow by about one block boundary a layer
(counted through `torch.autograd.graph.saved_tensors_hooks`).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import make_mesh as jmesh
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.parallel.hybrid import HybridParallelTrainer as JHy
from deeplearning4j_tpu_torch.parallel import kernels as tk
from deeplearning4j_tpu_torch.parallel import make_mesh as tmesh
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.parallel.hybrid import (
    HybridParallelTrainer as THy,
)
from deeplearning4j_tpu_torch.parallel.hybrid import place_params
from deeplearning4j_tpu_torch.tree import flatten_tree, tree_leaves
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

AXES = ("data", "seq", "model")


def _meshes(shape=(2, 2, 2)):
    n = int(np.prod(shape))
    return (jmesh(shape, AXES, devices=jax.devices()[:n]),
            tmesh(shape, AXES, devices=["cpu"] * n))


def _cfg(**kw):
    base = dict(vocab_size=61, d_model=16, n_heads=4, n_layers=2, d_ff=32,
                max_len=32)
    base.update(kw)
    return base


def _batch(vocab, b=4, s=16, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, s)), rng.integers(0, vocab, (b, s)))


def _leaves_close(got, want, atol):
    g = flatten_tree(got)
    w = {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, want)).items()}
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, err_msg=k)


def _pair(cfg_kw, steps, lr=0.05, updater="sgd", shape=(2, 2, 2),
          batch=None):
    """(JAX losses, port losses, JAX trainer, port trainer)."""
    jm, tm = _meshes(shape)
    jcfg = jt.TransformerConfig(**cfg_kw)
    tcfg = tt.TransformerConfig(**cfg_kw)
    jtr = JHy(jcfg, jm, lr=lr, seed=9, updater=updater)
    ttr = THy(tcfg, tm, lr=lr, updater=updater, params=jtr.export_params())
    tok, tgt = batch or _batch(cfg_kw["vocab_size"])
    jl = [jtr.fit_batch(tok, tgt) for _ in range(steps)]
    tl = [ttr.fit_batch(tok, tgt) for _ in range(steps)]
    return jl, tl, jtr, ttr


def test_dense_sgd_matches_jax():
    jl, tl, jtr, ttr = _pair(_cfg(), 3)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    _leaves_close(ttr.export_params(), jtr.export_params(), 5e-5)


def test_dense_adam_matches_jax():
    # no attention biases: a key bias's exact gradient is zero (softmax
    # is shift-invariant in a row), and Adam turns its rounding noise
    # into moves of about lr either way
    jl, tl, jtr, ttr = _pair(_cfg(tie_embeddings=True), 3, lr=0.01,
                             updater="adam")
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    _leaves_close(ttr.export_params(), jtr.export_params(), 5e-4)


def test_moe_with_dropped_tokens_matches_jax():
    """cf 0.5 at top-2 over 4 experts: each expert's buffer holds a
    quarter of the global assignments, so tokens drop; a per-shard
    router would drop others."""
    kw = _cfg(n_layers=1, n_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
    tok, tgt = _batch(61)
    p = tt.params_from_numpy(tt.numpy_params(tt.TransformerConfig(**kw)),
                             device="cpu")
    h = tt._layer_norm(p["layers"][0]["ln2"], p["embed"][torch.from_numpy(
        tok)] + p["pos"][None, :16])
    _, _, _, keep, c = tt._moe_route(p["layers"][0]["moe"],
                                     h.reshape(-1, 16), 0.5, 2)
    assert c == int(np.ceil(0.5 * tok.size * 2 / 4))   # global capacity
    assert float(keep.sum()) < keep.numel()           # tokens do drop
    jl, tl, jtr, ttr = _pair(kw, 2, batch=(tok, tgt))
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    _leaves_close(ttr.export_params(), jtr.export_params(), 5e-5)


def test_mesh_apply_and_loss_match_jax():
    kw = _cfg(attn_bias=True, n_experts=4, moe_top_k=2)
    jm, tm = _meshes()
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    tree = tt.numpy_params(tcfg, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tt.params_from_numpy(tree, device="cpu")
    tok, tgt = _batch(61)
    for train in (False, True):
        want = jt.apply(jcfg, jp, jnp.asarray(tok), jm, train=train)
        got = tt.apply(tcfg, tp, tok, tm, train=train)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-5)
    want = jt.lm_loss(jcfg, jp, jnp.asarray(tok), jnp.asarray(tgt), jm)
    got = tt.lm_loss(tcfg, tp, tok, tgt, tm)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_apply_and_lm_loss_take_jax_argument_order():
    for name in ("apply", "lm_loss"):
        assert list(inspect.signature(getattr(tt, name)).parameters) == \
            list(inspect.signature(getattr(jt, name)).parameters)


def test_param_specs_follow_jax():
    cfg = dict(n_experts=4, attn_bias=True)
    for kw in ({}, cfg):
        jspec = jt.param_specs(jt.TransformerConfig(**kw), "model")
        tspec = tt.param_specs(tt.TransformerConfig(**kw), "model")
        jl = jax.tree_util.tree_flatten(
            jspec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        )[0]
        tl = tree_leaves(tspec)
        assert len(jl) == len(tl)
        jflat = flatten_tree(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tt.param_shapes(
                tt.TransformerConfig(**kw)), is_leaf=lambda x: isinstance(
                    x, tuple)), jl))
        for key, ts in flatten_tree(tspec).items():
            js = tuple(jflat[key])
            dim = js.index("model") if "model" in js else None
            assert (ts.dim if not ts.is_replicated else None) == dim, key


def test_zero1_shards_moments_and_equals_replicated_bitwise():
    kw = _cfg(n_layers=1)
    _, tm = _meshes()
    tok, tgt = _batch(61, seed=5)
    init = tt.numpy_params(tt.TransformerConfig(**kw), seed=1)
    runs = {}
    for shard in (True, False):
        tr = THy(tt.TransformerConfig(**kw), tm, lr=0.01, updater="adam",
                 shard_update=shard, params=init)
        for _ in range(3):
            tr.fit_batch(tok, tgt)
        runs[shard] = tr
    for a, b in zip(tree_leaves(runs[True].export_params()),
                    tree_leaves(runs[False].export_params())):
        np.testing.assert_array_equal(a, b)
    zero = runs[True]
    units = flatten_tree(zero.params)
    part = zero.opt_partition()
    split = [k for k, s in part.items() if not s.is_replicated]
    # every leaf has a free dim of even size but the MLP's b1 slices,
    # whose one dim is the model split: they stay whole with data shard 0
    assert sorted(set(units) - set(split)) == [
        "layers//0//mlp//b1//0", "layers//0//mlp//b1//1"]
    assert all(k in zero.opt_state[0]["m"] and k not in
               zero.opt_state[1]["m"] for k in set(units) - set(split))
    for key in split:
        sizes = [st["m"][key].numel() for st in zero.opt_state]
        assert sizes == [units[key].numel() // 2] * 2, key
    full_m = flatten_tree(runs[False].opt_state["m"])
    for key in split:
        joined = torch.cat([st["m"][key] for st in zero.opt_state],
                           dim=part[key].dim)
        assert torch.equal(joined, full_m[key]), key


def test_each_model_shard_holds_only_its_slice():
    kw = _cfg(attn_bias=True, n_experts=4)
    _, tm = _meshes()
    tr = THy(tt.TransformerConfig(**kw), tm)
    layer = tr.params["layers"][0]
    for name, dim in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0),
                      ("bq", 0)):
        shards = layer["attn"][name]
        assert isinstance(shards, list) and len(shards) == 2
        assert shards[0].shape[dim] * 2 == \
            tt.param_shapes(tr.cfg)["layers"][0]["attn"][name][dim]
        assert shards[0].data_ptr() != shards[1].data_ptr()
    assert torch.is_tensor(layer["attn"]["bo"])
    assert [t.shape[0] for t in layer["moe"]["w1"]] == [2, 2]
    assert torch.is_tensor(layer["moe"]["gate"])
    placed = place_params(tm, tt.numpy_params(tr.cfg), tt.param_specs(
        tr.cfg, "model"))
    assert isinstance(placed["layers"][1]["moe"]["b2"], list)


@pytest.mark.parametrize("kw,shape,batch,match", [
    (dict(n_heads=3, d_model=12), (1, 1, 2), (2, 4), "n_heads"),
    (dict(n_experts=3), (1, 1, 2), (2, 4), "n_experts"),
    ({}, (1, 2, 1), (2, 5), "sequence length"),
    ({}, (2, 1, 1), (3, 4), "batch"),
])
def test_indivisible_layouts_raise(kw, shape, batch, match):
    _, tm = _meshes(shape)
    with pytest.raises(ValueError, match=match):
        tr = THy(tt.TransformerConfig(**_cfg(**kw)), tm)
        tr.fit_batch(np.zeros(batch, np.int64), np.zeros(batch, np.int64))


# ---------------------------------------------------------------------------
# remat on the mesh: the whole block, ring included, is recomputed


@pytest.mark.parametrize("kw", [
    dict(attn_bias=True),
    dict(n_layers=1, n_experts=4, moe_top_k=2, moe_capacity_factor=0.5)],
    ids=["dense", "moe"])
def test_remat_on_the_mesh_matches_jax(kw):
    jl, tl, jtr, ttr = _pair(_cfg(remat=True, **kw), 3)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    _leaves_close(ttr.export_params(), jtr.export_params(), 5e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_ring_forwards_a_step(monkeypatch, remat):
    """The ring's block pairs a step on (1, 2, 2), causal: each layer runs
    L dp tp sp (sp + 1) / 2 plain forwards, twice with remat (the
    forward, then the recompute), and the backward recomputes none."""
    calls = [0]
    real = tk.flash_forward_plain

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(tk, "flash_forward_plain", counted)
    cfg = tt.TransformerConfig(**_cfg(n_layers=3, remat=remat))
    _, tm = _meshes((1, 2, 2))
    tr = THy(cfg, tm, lr=0.05, params=tt.numpy_params(cfg, seed=0))
    tok, tgt = _batch(61)
    tr.fit_batch(tok, tgt)
    calls[0] = 0
    tr.fit_batch(tok, tgt)
    assert calls[0] == (1 + remat) * 3 * 1 * 2 * (2 * 3 // 2)


def _kept_bytes(monkeypatch, n_layers, remat):
    """The bytes autograd keeps for the backward of one mesh `lm_loss` on
    (1, 2, 2), batch 4 x 16: the distinct storages of the tensors that
    pass through the saved-tensor hooks, less the parameters' (the
    masters and the shard copies `_shard_params` made, which every
    layer's products save either way).  Also one block boundary: every
    local shard's block input ``[b, S / sp, d]``."""
    cfg = tt.TransformerConfig(**_cfg(n_layers=n_layers, remat=remat))
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=0),
                                  device="cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    copies = []
    real = tt._shard_params

    def spy(*a):
        copies.append(real(*a))
        return copies[-1]

    monkeypatch.setattr(tt, "_shard_params", spy)
    kept = {}

    def pack(t):
        st = t.untyped_storage()
        kept[st.data_ptr()] = st.nbytes()
        return t

    _, tm = _meshes((1, 2, 2))
    tok, tgt = _batch(61)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tt.lm_loss(cfg, params, tok, tgt, tm)
    own = {t.untyped_storage().data_ptr() for t in tree_leaves(params)}
    for sp in copies:
        for tree in sp.values():
            own |= {t.untyped_storage().data_ptr()
                    for t in tree_leaves(tree)}
    loss.backward()                 # the kept graph is a working one
    boundary = 4 * 4 * (16 // 2) * cfg.d_model * 4
    return sum(n for p, n in kept.items() if p not in own), boundary


def test_remat_keeps_only_block_boundaries(monkeypatch):
    """With remat, two more layers keep at most 1.25 boundaries each;
    without it, at least 4 each (q, k, v, o, the norms, the MLP)."""
    grow = {}
    for remat in (True, False):
        two, boundary = _kept_bytes(monkeypatch, 2, remat)
        four, _ = _kept_bytes(monkeypatch, 4, remat)
        grow[remat] = (four - two) / 2
    assert grow[True] <= 1.25 * boundary, (grow, boundary)
    assert grow[False] >= 4 * boundary, (grow, boundary)
