"""PyTorch port, slice 21: the LM mesh trainers across processes (A7
part 3b).

Two worker processes (`tests/torch_multiproc_worker.py`: torch and the
port only, one torch thread each, gloo on a free local TCP port, a group
timeout of 30 s and a deadline for the job) join one job through
`initialize_multihost` and run every case of the worker's `LM_CASES`
over a mesh of 2 host shards a process, in one job:

- `HybridParallelTrainer` over (data, seq, model) = (2, 1, 2), (1, 2, 2),
  (1, 4, 1) and (1, 1, 4), so that each axis in turn crosses the process
  boundary (the ring over ``seq``, the ``model`` sums, the ``data``
  gradient sums and ZeRO-1 slices); Adam with ZeRO-1 and replicated;
  MoE over (1, 1, 4) and (1, 2, 2) with dropped tokens; dense and MoE
  over (1, 2, 2) with remat, whose backward recomputes each block, ring
  and exchanges included, in the same order on both processes;
- `PipelineParallelTrainer` over (data, stage) = (1, 4) and (2, 2);
- `make_accum_train_step` over a (4,) data mesh;
- the ring alone (`ring_flash_attention`, `ring_attention`), causal and
  not, outputs and gradients;
- a direct `mesh._p2p` exchange, and a count of the batches it posts.

This process holds what they write against

- the same runs over one process's 4 host shards, by the same functions
  (the worker's `lm_run` and `ring_run`), **bitwise**: every exchange
  adds in global shard order in its forward and its backward, so the
  process count changes no addition;
- the JAX package's trainers on 4 of the conftest's 8 virtual devices,
  started from the JAX trainer's own initial weights (JAX's threefry
  init is not reproducible in torch), within the one-process tests'
  tolerances: losses 1e-5 and every leaf 5e-5 after 3 SGD steps, Adam
  within JAX's own 1e-4 / 5e-4; the ring 2e-5 (outputs) and 2e-4
  (gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_multiproc_worker as w
from deeplearning4j_tpu.parallel import make_mesh as jmesh
from deeplearning4j_tpu.parallel import ring_attention as jring
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.parallel.data_parallel import shard_map
from deeplearning4j_tpu.parallel.hybrid import HybridParallelTrainer as JHy
from deeplearning4j_tpu.parallel.hybrid import (
    PipelineParallelTrainer as JPipe,
)
from deeplearning4j_tpu.parallel.hybrid import (
    make_accum_train_step as jaccum,
)
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.tree import flatten_tree
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

GROUP_TIMEOUT_S = 30
JOB_DEADLINE_S = 180
CASES = list(w.LM_CASES)
HYBRID = [c for c in CASES if w.LM_CASES[c][0] == "hybrid"]
RINGS = [(flash, causal) for flash in (True, False)
         for causal in (True, False)]
RING_IDS = [f"{'flash' if f else 'plain'}-{'causal' if c else 'full'}"
            for f, c in RINGS]
SGD_TOL, ADAM_TOL = (1e-5, 5e-5), (1e-4, 5e-4)
RING_TOL = (2e-5, 2e-4)


def _tol(case: str):
    kw = w.LM_CASES[case][3]
    return ADAM_TOL if kw.get("updater", "sgd") == "adam" \
        or w.LM_CASES[case][0] == "accum" else SGD_TOL


def _jax_start(case: str):
    """(JAX's run of the case, not stepped yet: its trainer, or the
    accum step's (step, state init, parameters); the initial weights
    flat)."""
    kind, shape, _, kw = w.LM_CASES[case]
    cfg = jt.TransformerConfig(**{**w.LM_BASE, **w.LM_CASES[case][2]})
    kw = dict(kw)
    kw.setdefault("lr", 0.05)
    if kind == "accum":
        # JAX's accum step has no mesh: its mesh form computes the same
        init = tt.numpy_params(w.lm_config(case), seed=4)
        step, opt_init = jaccum(cfg, lr=1e-2, accum=2, updater="adam")
        return ((step, opt_init, jax.tree_util.tree_map(jnp.asarray, init)),
                flatten_tree(init))
    names = ("data", "seq", "model") if kind == "hybrid" \
        else ("data", "stage")
    mesh = jmesh(shape, names, devices=jax.devices()[:4])
    tr = (JHy if kind == "hybrid" else JPipe)(cfg, mesh, seed=3, **kw)
    return tr, flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                   tr.export_params()))


def _jax_finish(case: str, run) -> tuple:
    """(losses, final weights flat) of `LM_STEPS` steps of the run."""
    if w.LM_CASES[case][0] == "accum":
        step, opt_init, params = run
        opt, losses = opt_init(params), []
        for b in w.lm_batch(case):
            params, opt, loss = step(params, opt, jnp.asarray(b[:, :-1]),
                                     jnp.asarray(b[:, 1:]))
            losses.append(float(loss))
        return losses, flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                           params))
    tok, tgt = w.lm_batch(case)
    losses = [run.fit_batch(tok, tgt) for _ in range(w.LM_STEPS)]
    return losses, flatten_tree(jax.tree_util.tree_map(
        np.asarray, run.export_params()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The job (started first, from JAX's initial weights), JAX's runs
    while it works, the same runs over one process's 4 host shards (one
    torch thread), then the job's results."""
    tmp = tmp_path_factory.mktemp("multiproc-lm")
    started = {case: _jax_start(case) for case in CASES}
    weights = {}
    for case, (_, init) in started.items():
        weights[case] = str(tmp / f"weights_{case}.npz")
        np.savez(weights[case], **init)
    out = tmp / "job"
    job = w.start_job(out, ["lm"], {"lm_cases": CASES,
                                    "lm_weights": weights}, GROUP_TIMEOUT_S)
    try:
        jax_runs = {case: _jax_finish(case, run)
                    for case, (run, _) in started.items()}
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = {case: w.lm_run(case, w.lm_mesh(case, per_process=4),
                                  started[case][1]) for case in CASES}
            ring = w.make_mesh((4,), ("seq",), devices=["cpu"] * 4)
            for flash, causal in RINGS:
                one["ring", flash, causal] = w.ring_run(flash, causal, ring)
        finally:
            torch.set_num_threads(prev)
    finally:
        try:
            rcs = w.wait_job(out, job, JOB_DEADLINE_S)
        except TimeoutError as e:
            pytest.fail(str(e))
    assert rcs == [0, 0], w.job_logs(out)
    res, arrays = zip(*(w.job_results(out, r) for r in range(2)))
    return {"res": res, "arrays": arrays, "jax": jax_runs, "one": one}


@pytest.fixture(scope="module")
def job(runs):
    return runs


@pytest.fixture(scope="module")
def one_process(runs):
    return runs["one"]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


def _sub(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("case", CASES)
def test_two_processes_equal_one_process_bitwise(job, one_process, case):
    """2 processes x 2 shards = 1 process x 4 shards: every loss and
    every exported leaf, on both processes."""
    losses, params, _ = one_process[case]
    for res, arrays in zip(job["res"], job["arrays"]):
        assert res[f"{case}/losses"] == losses
        got = _sub(arrays, f"{case}/")
        assert set(got) == set(params)
        for k in params:
            np.testing.assert_array_equal(got[k], params[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_one_process_matches_jax_on_four_devices(one_process, jax_runs,
                                                 case):
    losses, params, _ = one_process[case]
    want_losses, want = jax_runs[case]
    loss_tol, leaf_tol = _tol(case)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=loss_tol)
    assert set(params) == set(want)          # JAX's layout, key for key
    for k in want:
        assert params[k].shape == want[k].shape, k
        np.testing.assert_allclose(params[k], want[k], rtol=0,
                                   atol=leaf_tol, err_msg=k)


@pytest.mark.parametrize("case", HYBRID)
def test_each_process_runs_its_own_block_pairs(job, one_process, case):
    """The ring's flash block pairs (B2's forward, B3 / B4's backward,
    plain on the host) run where their query block lives: a causal ring
    block at seq position j runs j + 1 pairs a layer and step, the
    forward once more with remat (the block is recomputed, ring
    included), and the processes' counts add up to the one process's."""
    _, shape, _, _ = w.LM_CASES[case]
    cfg = w.lm_config(case)
    sp = shape[1]
    per_shard = [(s // shape[2]) % sp + 1 for s in range(4)]
    counts = [res[f"{case}/launches"] for res in job["res"]]
    for rank, got in enumerate(counts):
        want = w.LM_STEPS * cfg.n_layers * sum(per_shard[2 * rank:
                                                         2 * rank + 2])
        assert got == {"fwd": (1 + cfg.remat) * want, "bwd": want}
    assert {k: sum(c[k] for c in counts) for k in ("fwd", "bwd")} == \
        one_process[case][2]


def _jax_ring(flash: bool, causal: bool):
    fn = jring.ring_flash_attention if flash else jring.ring_attention
    mesh = jmesh((4,), ("seq",), devices=jax.devices()[:4])
    ring = jax.jit(shard_map(
        lambda q, k, v: fn(q, k, v, "seq", causal=causal), mesh=mesh,
        in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
        check_rep=False))
    q, k, v = (jnp.asarray(a) for a in w.ring_inputs())
    grads = jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2),
                     (0, 1, 2))(q, k, v)
    return np.asarray(ring(q, k, v)), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("flash,causal", RINGS, ids=RING_IDS)
def test_ring_across_processes(job, one_process, flash, causal):
    """Each process's blocks of the output and of dq / dk / dv: bitwise
    the one process's, and within the JAX ring's tolerances."""
    one = one_process["ring", flash, causal]
    got = {}
    for arrays in job["arrays"]:
        mine = _sub(arrays, f"ring/{flash}/{causal}/")
        assert len(mine) == 8                # 2 blocks x (out, dq, dk, dv)
        got.update(mine)
    assert set(got) == set(one)
    for k in one:
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    want, want_g = _jax_ring(flash, causal)
    for name, full in zip(("out", "dq", "dk", "dv"), [want, *want_g]):
        joined = np.concatenate([got[f"{name}/{s}"] for s in range(4)],
                                axis=1)
        tol = RING_TOL[0] if name == "out" else RING_TOL[1]
        np.testing.assert_allclose(joined, full, rtol=0, atol=tol,
                                   err_msg=name)


def test_p2p_posts_each_round_as_one_batch(job):
    """Every exchange between the processes, the direct one and all of
    the LM cases' and rings', posts its two rounds (byte counts, bytes)
    each as one `batch_isend_irecv` batch, and the direct one delivers
    the peer's tensors, dtypes and shapes kept."""
    for rank, (res, arrays) in enumerate(zip(job["res"], job["arrays"])):
        assert res["p2p"]["calls"] > 1
        assert res["p2p"]["batches"] == 2 * res["p2p"]["calls"]
        want = w.p2p_payload(1 - rank)
        for i, t in enumerate(want):
            got = arrays[f"p2p/{i}"]
            assert got.dtype == t.numpy().dtype
            np.testing.assert_array_equal(got, t.numpy())
