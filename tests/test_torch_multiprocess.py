"""PyTorch port, slice 20: training across processes (A7 part 3a).

Two worker processes (`tests/torch_multiproc_worker.py`: torch and the
port only, one torch thread each, gloo on a free local TCP port, a group
timeout of 30 s and a deadline for the job) join one job through
`initialize_multihost` and train over a 4-shard mesh of 2 host shards a
process.  This process holds what they write against

- the same runs over one process's 4 host shards, by the same functions
  (the worker's `dp_run`, `poison_run`, `ckpt_run`, `resume_run`,
  `embedding_run`), **bitwise**: the collectives gather every shard and
  add in global shard order, so the process count changes no addition;
- JAX's `DataParallelTrainer` on 4 of the conftest's virtual devices,
  within 1e-5 (`tests/test_torch_data_parallel.py`'s bound);
- JAX's v1 per-host checkpoint layout, read back by JAX's single-process
  `load_checkpoint` (the ``proc00000`` file) bitwise.

The Iris-shaped MLP (Adam) and the tiny char-LSTM (vocab 11, H 16, T 8:
B5's plain version on every shard of every process) run replicated,
ZeRO-1 and local SGD; "mixed" skips a poisoned step in lockstep; Word2Vec
(HS, NEG) and GloVe run ``mesh=`` across the processes; a process killed
between its shard file and the commit leaves no COMMIT; a collective
given no mesh raises.  The LM mesh trainers across processes are
`tests/test_torch_multiprocess_lm.py`'s.
"""

import json
import pathlib
import socket
from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch

import torch_multiproc_worker as w
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.parallel import DataParallelTrainer as JDP
from deeplearning4j_tpu.parallel import make_mesh as jmesh
from deeplearning4j_tpu.runtime import checkpoint as jck
from deeplearning4j_tpu.runtime.launcher import TpuPodProvisioner as JPod
from deeplearning4j_tpu_torch.runtime import checkpoint as tck
from deeplearning4j_tpu_torch.runtime.launcher import TpuPodProvisioner as TPod
from deeplearning4j_tpu_torch.runtime.launcher import initialize_multihost
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

TOL = 1e-5
GROUP_TIMEOUT_S = 30
JOB_DEADLINE_S = 180
NETS = ("mlp", "lstm")


def _mlp(dropout: float = 0.0):
    return jconf.MultiLayerConfiguration(
        conf=jconf.NeuralNetConfiguration(learning_rate=0.02,
                                          updater="adam", seed=5),
        layers=(jconf.DenseLayerConf(n_in=4, n_out=16, activation="relu",
                                     dropout=dropout),
                jconf.OutputLayerConf(n_in=16, n_out=3)))


def _confs() -> dict:
    return {"mlp": _mlp(), "lstm": jzoo.char_lstm(vocab_size=w.V, hidden=w.H)}


def _run_job(out: pathlib.Path, scenarios, extra: dict) -> list:
    try:
        return w.run_job(out, scenarios, extra, GROUP_TIMEOUT_S,
                         JOB_DEADLINE_S)
    except TimeoutError as e:
        pytest.fail(str(e))


@contextmanager
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The confs (JSON) and JAX-initialized weights every run starts from."""
    tmp = tmp_path_factory.mktemp("multiproc")
    confs = _confs()
    weights = {}
    for net, conf in confs.items():
        path = tmp / f"weights_{net}.npz"
        np.savez(path, **{f"{i}/{k}": np.asarray(v) for i, layer in
                          enumerate(JNet(conf).init().params)
                          for k, v in layer.items()})
        weights[net] = str(path)
    return {"tmp": tmp, "conf": {k: c.to_json() for k, c in
                                 dict(confs, mlp_dropout=_mlp(0.5)).items()},
            "weights": weights}


@pytest.fixture(scope="module")
def job(inputs):
    tmp = inputs["tmp"]
    extra = {"conf": inputs["conf"], "weights": inputs["weights"],
             "ckpt_dir": str(tmp / "ckpt"), "remote_dir": str(tmp / "remote")}
    out = tmp / "job"
    rcs = _run_job(out, ["dp", "poison", "ckpt", "remote", "refusals",
                         "embeddings"], extra)
    assert rcs == [0, 0], w.job_logs(out)
    res, arrays = zip(*(w.job_results(out, r) for r in range(2)))
    return {"res": res, "arrays": arrays, **extra}


@pytest.fixture(scope="module")
def kill_job(inputs):
    tmp = inputs["tmp"]
    extra = {"conf": inputs["conf"], "weights": inputs["weights"],
             "ckpt_dir": str(tmp / "kill-ckpt")}
    out = tmp / "kill"
    rcs = _run_job(out, ["kill"], extra)
    return {"rcs": rcs, "out": out, **extra}


@pytest.fixture(scope="module")
def one_process(inputs):
    """The same runs over one process's 4 host shards."""
    conf, wpath = inputs["conf"], inputs["weights"]
    mesh = w.host_mesh(per_process=4)
    batches = {"mlp": w.mlp_data(), "lstm": w.lstm_data()}
    out = {}
    with _one_thread():
        for net in NETS:
            for mode in w.MODES:
                steps = (w.LOCAL_STEPS if mode == "local_sgd"
                         else w.STEPS)[net]
                out[net, mode] = w.dp_run(conf[net],
                                          w.load_weights(wpath[net]), mode,
                                          mesh, batches[net], steps)
        out["mlp_dropout"] = w.dp_run(conf["mlp_dropout"],
                                      w.load_weights(wpath["mlp"]), "zero1",
                                      mesh, batches["mlp"], w.STEPS["mlp"])
        for shard in (True, False):
            out["poison", shard] = w.poison_run(
                conf["mlp"], w.load_weights(wpath["mlp"]), shard, mesh,
                batches["mlp"], plant=True)
        for kind in ("hs", "neg", "glove"):
            out[kind] = w.embedding_run(kind, mesh)
    return out


def _sub(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _assert_trees_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- joining the job -------------------------------------------------------

def test_initialize_multihost_returns_jax_s_keys(job):
    for rank, res in enumerate(job["res"]):
        assert res["info"] == {"process_index": rank, "process_count": 2,
                               "local_devices": 1, "global_devices": 2}


def test_initialize_multihost_needs_a_card_unless_the_cpu_is_asked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_multihost("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,local", [("cuda:3", 1), (None, 8)])
def test_initialize_multihost_counts_the_cards_this_process_was_given(
        monkeypatch, device, local):
    """On a host of 8 cards a process given card 3 (one card a process,
    NCCL's layout) holds 1 device; one left to the default holds every
    visible card.  The card is faked; the group is gloo's, of one."""
    for name, fn in (("is_available", lambda: True),
                     ("device_count", lambda: 8),
                     ("current_device", lambda: 0),
                     ("set_device", lambda d: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = initialize_multihost(f"127.0.0.1:{port}", 1, 0, backend="gloo",
                                device=device, timeout_s=GROUP_TIMEOUT_S)
    torch.distributed.destroy_process_group()
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": local, "global_devices": local}


def test_the_mesh_is_process_major(job):
    for rank, res in enumerate(job["res"]):
        assert res["process_of"] == [0, 0, 1, 1]
        assert res["local_shards"] == [2 * rank, 2 * rank + 1]
        assert f"process {rank} of 2" in res["mesh"]


# ---- data parallelism across processes ------------------------------------

@pytest.mark.parametrize("mode", list(w.MODES))
@pytest.mark.parametrize("net", NETS)
def test_two_processes_equal_one_process_bitwise(job, one_process, net,
                                                 mode):
    """2 processes x 2 shards = 1 process x 4 shards: every loss, every
    published parameter and moment, on both processes."""
    losses, params, upd = one_process[net, mode]
    for res, arrays in zip(job["res"], job["arrays"]):
        assert res[f"{net}/{mode}/losses"] == losses
        _assert_trees_equal(_sub(arrays, f"{net}/{mode}/params/"), params)
        _assert_trees_equal(_sub(arrays, f"{net}/{mode}/updater/"), upd)


def test_dropout_draws_follow_the_global_shard_index(job, one_process):
    """With dropout 0.5 each shard draws from the generator of its global
    index, so the two processes' shards draw what one process's 4 do."""
    losses, params, _ = one_process["mlp_dropout"]
    assert losses != one_process["mlp", "zero1"][0]
    for res, arrays in zip(job["res"], job["arrays"]):
        assert res["mlp_dropout/losses"] == losses
        _assert_trees_equal(_sub(arrays, "mlp_dropout/params/"), params)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    out = {}
    batches = {"mlp": w.mlp_data(), "lstm": w.lstm_data()}
    for net in NETS:
        for mode in w.MODES:
            jn = JNet(jconf.MultiLayerConfiguration.from_json(
                inputs["conf"][net])).init()
            jn.params = [dict(layer) for layer in
                         w.load_weights(inputs["weights"][net])]
            jt = JDP(jn, mesh=jmesh((4,), ("data",),
                                    devices=jax.devices()[:4]),
                     **w.MODES[mode])
            steps = (w.LOCAL_STEPS if mode == "local_sgd" else w.STEPS)[net]
            losses = [jt.fit_batch(*batches[net]) for _ in range(steps)]
            jt.finalize()
            out[net, mode] = (losses, jck._flatten_with_paths(jn.params),
                              jck._flatten_with_paths(jn.updater_state))
    return out


@pytest.mark.parametrize("mode", list(w.MODES))
@pytest.mark.parametrize("net", NETS)
def test_two_processes_match_jax_on_four_devices(job, jax_runs, net, mode):
    losses, params, upd = jax_runs[net, mode]
    res, arrays = job["res"][1], job["arrays"][1]
    np.testing.assert_allclose(res[f"{net}/{mode}/losses"], losses, rtol=0,
                               atol=TOL)
    for prefix, want in (("params", params), ("updater", upd)):
        got = _sub(arrays, f"{net}/{mode}/{prefix}/")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k],
                                                          got[k].dtype),
                                       rtol=0, atol=TOL, err_msg=k)


def test_b5_s_plain_version_runs_on_each_process_s_shards(job):
    """Every char-LSTM step runs the fused scan once on each of the
    process's 2 shards, on the shard's 2 rows (8 rows over 4 shards)."""
    steps = 2 * w.STEPS["lstm"] + w.LOCAL_STEPS["lstm"]
    for res in job["res"]:
        assert res["lstm_calls"] == [2] * (2 * steps)


def test_scaling_report_names_the_processes(job):
    for res in job["res"]:
        assert res["scaling_report"] == {
            "devices": 4, "mesh": {"data": 4}, "processes": 2,
            "collective": "psum_scatter+all_gather (zero-1 weight update)"}


@pytest.mark.parametrize("shard", [True, False], ids=["zero1", "replicated"])
def test_poisoned_steps_skip_in_lockstep(job, one_process, shard):
    """An inf input row on process 0's shard, then an inf planted in
    process 0's gradient at the lane process 1's slice holds: both
    processes skip both steps (parameters and moments bitwise, the scale
    halved, one overflow each) as the one-process run does."""
    want = one_process["poison", shard]
    for res, arrays in zip(job["res"], job["arrays"]):
        got = res[f"poison/{shard}"]
        assert got["clean"] == want["clean"]
        for leg, ref in zip(got["legs"], want["legs"]):
            assert leg["unchanged"] and ref["unchanged"]
            before, after = leg["scaler_before"], leg["scaler_after"]
            assert after["scale"] == before["scale"] / 2
            assert after["overflow_count"] == before["overflow_count"] + 1
            assert leg["scaler_after"] == ref["scaler_after"]
        assert np.isfinite(got["legs"][1]["loss"])
        assert got["next_loss"] == want["next_loss"]
        _assert_trees_equal(_sub(arrays, f"poison/{shard}/params/"),
                            want["params"])


# ---- checkpoints ------------------------------------------------------------

def test_checkpoint_of_two_processes_has_jax_s_v1_layout(job):
    ckpt = pathlib.Path(job["ckpt_dir"]) / f"ckpt-{w.RESUME_AT}"
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "COMMIT", "meta.json", "params.proc00000.npz",
        "params.proc00001.npz", "updater.proc00000.npz",
        "updater.proc00001.npz"]
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["processes"] == 2 and meta["step"] == w.RESUME_AT
    assert (ckpt / "COMMIT").read_text() == "ok"
    for tree in ("params", "updater"):
        a, b = (tck._load_npz(ckpt / f"{tree}.proc0000{r}.npz")
                for r in range(2))
        _assert_trees_equal(a, b)
        _assert_trees_equal(a, _sub(job["arrays"][0], f"ckpt/saved_{tree}/"))


def test_jax_loads_the_two_process_checkpoint_bitwise(job, inputs):
    jn = JNet(jconf.MultiLayerConfiguration.from_json(
        inputs["conf"]["mlp"])).init()
    step, params, upd, _ = jck.load_checkpoint(job["ckpt_dir"], jn.params,
                                               jn.updater_state)
    assert step == w.RESUME_AT
    for tree, got in (("params", params), ("updater", upd)):
        want = _sub(job["arrays"][0], f"ckpt/saved_{tree}/")
        flat = jck._flatten_with_paths(got)
        assert set(flat) == set(want)
        for k in want:
            np.testing.assert_array_equal(
                np.asarray(flat[k]).astype(want[k].dtype), want[k])


def test_resume_at_one_process_continues_bitwise(job, inputs):
    """The port in one process (4 shards) reads ``proc00000`` and its
    next steps equal the uninterrupted two-process run."""
    with _one_thread():
        got = w.resume_run(inputs["conf"]["mlp"],
                           w.load_weights(inputs["weights"]["mlp"]),
                           w.host_mesh(per_process=4), w.mlp_data(),
                           job["ckpt_dir"])
    res, arrays = job["res"][0], job["arrays"][0]
    assert got["step"] == w.RESUME_AT
    assert got["losses"] == res["ckpt"]["losses"][w.RESUME_AT:]
    _assert_trees_equal(got["params"], _sub(arrays, "ckpt/params/"))
    _assert_trees_equal(got["updater"], _sub(arrays, "ckpt/updater/"))


def test_resume_at_two_processes_continues_bitwise(job):
    for res, arrays in zip(job["res"], job["arrays"]):
        assert res["ckpt"]["resumed_step"] == w.RESUME_AT
        assert (res["ckpt"]["resumed_losses"]
                == res["ckpt"]["losses"][w.RESUME_AT:])
        _assert_trees_equal(_sub(arrays, "ckpt/resumed_params/"),
                            _sub(arrays, "ckpt/params/"))
        _assert_trees_equal(_sub(arrays, "ckpt/resumed_updater/"),
                            _sub(arrays, "ckpt/updater/"))


def test_async_listener_refuses_with_jax_s_text(job):
    for res in job["res"]:
        assert res["async_refusal"] == (
            "AsyncCheckpointListener is single-host (background-thread "
            "barriers would deadlock); use CheckpointListener in "
            "multi-host jobs")


def test_killed_process_leaves_no_commit(kill_job):
    """Process 1 dies right after its params file of step 2: process 0
    fails at the ``written`` barrier (when the peer's socket closes, at
    the group timeout at the latest), no COMMIT appears, and the latest
    checkpoint stays step 1."""
    out, ckdir = kill_job["out"], pathlib.Path(kill_job["ckpt_dir"])
    assert kill_job["rcs"] == [0, -9], w.job_logs(out)
    res, _ = w.job_results(out, 0)
    assert "barrier 'ckpt-2-written' failed" in res["second_save"]
    assert res["second_save_s"] < GROUP_TIMEOUT_S + 15
    assert (ckdir / "ckpt-2" / "params.proc00001.npz").exists()
    assert not (ckdir / "ckpt-2" / "COMMIT").exists()
    assert tck.latest_checkpoint(ckdir).name == "ckpt-1"
    assert jck.latest_checkpoint(ckdir).name == "ckpt-1"


def test_remote_commit_goes_up_after_every_process_s_shards(job):
    """Process 1 uploads half a second late; process 0, held at the
    barrier, writes COMMIT only after process 1's last shard is up."""
    r0, r1 = job["res"]
    step = pathlib.Path(job["remote_dir"]) / "ckpt-7"
    assert sorted(p.name for p in step.iterdir()) == [
        "COMMIT", "meta.json", "params.proc00000.npz",
        "params.proc00001.npz", "updater.proc00000.npz",
        "updater.proc00001.npz"]
    assert {"params.proc00001.npz", "updater.proc00001.npz"} <= set(
        r0["remote_at_commit"])
    commit_t = dict(r0["remote_writes"])["COMMIT"]
    assert r0["remote_writes"][-1][0] == "COMMIT"
    assert all(t < commit_t for _, t in r1["remote_writes"])
    assert "COMMIT" not in dict(r1["remote_writes"])


# ---- the embeddings ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["hs", "neg", "glove"])
def test_embeddings_across_processes_equal_one_process_bitwise(
        job, one_process, kind):
    for arrays in job["arrays"]:
        _assert_trees_equal(_sub(arrays, f"{kind}/"), one_process[kind])


# ---- what is refused --------------------------------------------------------

def test_a_collective_without_the_mesh_raises_in_a_job(job):
    """`psum` given no mesh in a job of 2 processes would sum this
    process's shards alone: it raises."""
    for res in job["res"]:
        msg = res["collective_without_mesh"]
        assert msg is not None and "2 processes" in msg


# ---- pod provisioning -----------------------------------------------------

PODS = {
    "procfleet": dict(name="pod-a", zone="us-central2-b",
                      accelerator_type="v5litepod-16", project="proj",
                      labels={"team": "ml", "env": "prod"}),
    "ml": dict(name="pod0", zone="us-east5-b", project="proj",
               labels={"team": "ml"}),
    "plain": dict(name="pod-a", zone="us-central2-b"),
}


@pytest.mark.parametrize("case", list(PODS))
def test_tpu_pod_provisioner_argv_equals_jax(case):
    j, t = JPod(**PODS[case]), TPod(**PODS[case])
    for spot in (True, False):
        assert t.create_command(spot=spot) == j.create_command(spot=spot)
    for worker in ("all", "3"):
        assert (t.run_command("pip install -e .", worker=worker)
                == j.run_command("pip install -e .", worker=worker))
        assert (t.scp_command("model.npz", "/tmp/model.npz", worker=worker)
                == j.scp_command("model.npz", "/tmp/model.npz",
                                 worker=worker))
    assert t.delete_command() == j.delete_command()
