"""PyTorch port, slice 19: `gpipe_apply` and `PipelineParallelTrainer`
against the JAX package's.

The JAX side runs on the conftest's virtual CPU devices (the schedule
under ``shard_map`` over a 4-stage axis; the trainer on a (data 2,
stage 4) mesh); the port's on host shards, each stage a list entry, the
schedule's transfers through a one-process `mesh.Program`.
The trainers start from the JAX trainer's own initial weights
(``export_params`` before any step).  The same numpy inputs go through
both.

Tolerances: the schedule's outputs and gradients within 1e-5 absolute;
trainer losses within 1e-5 and every leaf within 5e-5 after 3 SGD steps
(float32).  Inside the port, the ZeRO-1 flat planes equal the replicated
update bitwise (JAX's own pipeline check of this is one of its known
reds, so it is no oracle here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deeplearning4j_tpu.parallel import make_mesh as jmesh
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.parallel.data_parallel import shard_map
from deeplearning4j_tpu.parallel.hybrid import (
    PipelineParallelTrainer as JPipe,
)
from deeplearning4j_tpu.parallel.pipeline import gpipe_apply as jgpipe
from deeplearning4j_tpu_torch.parallel import make_mesh as tmesh
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.parallel.mesh import Program
from deeplearning4j_tpu_torch.parallel.hybrid import (
    PipelineParallelTrainer as TPipe,
)
from deeplearning4j_tpu_torch.parallel.pipeline import gpipe_apply as tgpipe
from deeplearning4j_tpu_torch.tree import flatten_tree, tree_leaves
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

AXES = ("data", "stage")


def _schedule_inputs(p, m, mbb=4, f=16):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((p, 1, f, f)) / np.sqrt(f)).astype(np.float32)
    x = rng.standard_normal((m, mbb, f)).astype(np.float32)
    k = -(-m // p)
    return w, np.pad(x, ((0, k * p - m), (0, 0), (0, 0))), k


def _stages(p):
    """`gpipe_apply`'s program and stage shards: one process's p host
    stages, as the pipeline trainer passes them."""
    mesh = tmesh((p,), ("stage",), devices=["cpu"] * p)
    return {"program": Program(mesh), "shards": list(range(p))}


@pytest.mark.parametrize("m", [8, 6])   # 6 over 4 stages: padding slots
@pytest.mark.parametrize("remat", [True, False])
def test_gpipe_apply_matches_jax(m, remat):
    p = 4
    w, xp, k = _schedule_inputs(p, m)
    mesh = jmesh((p,), ("stage",), devices=jax.devices()[:p])
    fn = shard_map(
        lambda sp, xl: jgpipe(lambda pp, a: jnp.tanh(a @ pp[0]), sp, xl,
                              "stage", m, remat_stage=remat),
        mesh=mesh, in_specs=(P("stage"), P("stage")), out_specs=P("stage"),
        check_rep=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(w), jnp.asarray(xp)))
    want_g = jax.grad(lambda w_, x_: jnp.sum(fn(w_, x_) ** 2), (0, 1))(
        jnp.asarray(w), jnp.asarray(xp))

    tw = torch.from_numpy(w).requires_grad_(True)
    tx = torch.from_numpy(xp).requires_grad_(True)
    ys = tgpipe(lambda pp, a: torch.tanh(a @ pp[0]),
                list(tw), list(tx.chunk(p)), "stage", m, remat_stage=remat,
                **_stages(p))
    got = torch.cat(ys)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    assert not got[m:].any()                 # padding slots stay zero
    (got ** 2).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_g[0]),
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g[1]),
                               atol=1e-5)


def test_gpipe_runs_each_microbatch_once_a_stage():
    p, m = 4, 6
    w, xp, _ = _schedule_inputs(p, m)
    calls = []

    def stage_fn(pp, a):
        calls.append(pp)
        return a @ pp[0]

    with torch.no_grad():
        tgpipe(stage_fn, list(torch.from_numpy(w)),
               list(torch.from_numpy(xp).chunk(p)), "stage", m,
               **_stages(p))
    assert len(calls) == p * m               # bubble ticks run nothing
    with pytest.raises(ValueError, match="microbatches"):
        tgpipe(stage_fn, list(torch.from_numpy(w)),
               [torch.zeros(1, 4, 16)] * p, "stage", 6, **_stages(p))


def _cfg(tied, **kw):
    base = dict(vocab_size=41, d_model=16, n_heads=4, n_layers=4, d_ff=32,
                max_len=16, tie_embeddings=tied)
    base.update(kw)
    return base


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 41, (8, 8)), rng.integers(0, 41, (8, 8))


@pytest.mark.parametrize("tied", [True, False])
def test_trainer_matches_jax(tied):
    kw = _cfg(tied)
    jtr = JPipe(jt.TransformerConfig(**kw),
                jmesh((2, 4), AXES, devices=jax.devices()[:8]),
                n_microbatches=2, lr=0.05, seed=11)
    ttr = TPipe(tt.TransformerConfig(**kw),
                tmesh((2, 4), AXES, devices=["cpu"] * 8), n_microbatches=2,
                lr=0.05, params=jtr.export_params())
    tok, tgt = _batch()
    jl = [jtr.fit_batch(tok, tgt) for _ in range(3)]
    tl = [ttr.fit_batch(tok, tgt) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    got = flatten_tree(ttr.export_params())
    want = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                               jtr.export_params()))
    assert sorted(got) == sorted(want)       # JAX's layout, key for key
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], atol=5e-5,
                                   err_msg=key)
    assert ("head" in ttr.io_params) == (not tied)


def test_zero1_planes_equal_replicated_bitwise():
    mesh = tmesh((2, 4), AXES, devices=["cpu"] * 8)
    cfg = tt.TransformerConfig(**_cfg(True))
    init = tt.numpy_params(cfg, seed=6)
    tok, tgt = _batch(6)
    runs = {}
    for shard in (True, False):
        tr = TPipe(cfg, mesh, n_microbatches=2, lr=0.01, updater="adam",
                   shard_update=shard, params=init)
        for _ in range(3):
            tr.fit_batch(tok, tgt)
        runs[shard] = tr
    for a, b in zip(tree_leaves(runs[True].export_params()),
                    tree_leaves(runs[False].export_params())):
        np.testing.assert_array_equal(a, b)
    zero = runs[True]
    # [n_stages, data shards] flat slices of the stage planes, [data] of
    # the io plane, each 1/2 of its padded plane
    assert len(zero.stage_opt) == 4 and len(zero.stage_opt[0]) == 2
    assert zero.stage_opt[0][0]["m"]["p"].numel() * 2 == zero._pe_stage
    assert len(zero.io_opt) == 2
    assert zero.io_opt[1]["m"]["p"].numel() * 2 == zero._pe_io
    assert zero._pe_stage >= zero._k0_stage == sum(
        t.numel() for t in zero._stage_leaves(0))


def test_trainer_refuses_moe_and_indivisible_layers():
    mesh = tmesh((2, 4), AXES, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="dense MLP"):
        TPipe(tt.TransformerConfig(**_cfg(True, n_experts=4)), mesh)
    with pytest.raises(ValueError, match="divide into 4 stages"):
        TPipe(tt.TransformerConfig(**_cfg(True, n_layers=3)), mesh)
    tr = TPipe(tt.TransformerConfig(**_cfg(True)), mesh, n_microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        tr.fit_batch(*_batch())


def test_stage_params_stack_layers_a_stage():
    mesh = tmesh((1, 2), AXES, devices=["cpu"] * 2)
    cfg = tt.TransformerConfig(**_cfg(False))
    init = tt.numpy_params(cfg, seed=2)
    tr = TPipe(cfg, mesh, params=init)
    w1 = tr.stage_params["mlp"]["w1"]
    assert [tuple(t.shape) for t in w1] == [(2, 16, 32)] * 2
    np.testing.assert_array_equal(w1[1][0].detach().numpy(),
                                  init["layers"][2]["mlp"]["w1"])
    for a, b in zip(tree_leaves(tr.export_params()), tree_leaves(init)):
        np.testing.assert_array_equal(a, b)
