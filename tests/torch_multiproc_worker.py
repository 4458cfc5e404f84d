"""One process of a job of several, for `tests/test_torch_multiprocess.py`.

The test spawns it as ``python tests/torch_multiproc_worker.py SPEC``
(SPEC: a JSON object), once a rank, on a free local TCP port.  It
imports torch and the PyTorch port only, runs torch in one thread, joins
the job through `runtime.launcher.initialize_multihost` (gloo, the
spec's group timeout), builds a 4-shard mesh of 2 shards a process (host
shards, or card 0's for `tests/test_torch_cuda.py`) and runs the spec's
scenarios.  Each writes what the parent
compares into ``rank{r}.json`` (scalars, messages) and ``rank{r}.npz``
(trees as ``//``-keyed arrays, the checkpoint keys).

The run functions here (`dp_run`, `poison_run`, `ckpt_run`,
`embedding_run`) are the parent's too: it calls them on a one-process
mesh of 4 shards, so both sides run the same code on the same inputs.
"""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.parallel import DataParallelTrainer as TDP
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.runtime import checkpoint as tck

V, H, T = 11, 16, 8          # the tiny char-LSTM
MODES = {"zero1": {}, "replicated": {"shard_update": False},
         "local_sgd": {"sync_every": 3}}
STEPS = {"mlp": 5, "lstm": 3}
LOCAL_STEPS = {"mlp": 9, "lstm": 6}     # local SGD: sync rounds of 3
RESUME_AT, RESUME_STEPS = 5, 5


def mlp_data(n: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = rng.normal(0, 0.3, (n, 4)).astype(np.float32) + y[:, None]
    return x, np.eye(3, dtype=np.float32)[y]


def lstm_data(b: int = 8, seed: int = 1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (b, T))
    x = rng.standard_normal((b, T, V)).astype(np.float32)
    return x, np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)]


def corpus():
    """Two topic clusters (w0-49 vs w50-99), `test_torch_w2v_mesh`'s."""
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(100)]
    return [" ".join(vocab[(0 if k % 2 == 0 else 50)
                           + int(rng.integers(0, 50))] for _ in range(12))
            for k in range(400)]


def host_mesh(shards: int = 4, per_process: int = 2, device: str = "cpu"):
    """The 4-shard data mesh: `per_process` shards on `device` (the host
    by default) of each process in a job, all 4 in one process."""
    return make_mesh((shards,), ("data",), devices=[device] * per_process)


def flat(tree) -> dict:
    """A tree's leaves by checkpoint keypath, as numpy copies."""
    return {k: np.array(v, copy=True)
            for k, v in tck._flatten_with_paths(tree).items()}


def load_weights(path) -> list:
    with np.load(path) as z:
        layers = {}
        for key in z.files:
            i, name = key.split("/", 1)
            layers.setdefault(int(i), {})[name] = z[key]
    return [layers[i] for i in sorted(layers)]


def make_net(conf_json: str, weights: list, precision=None):
    net = TNet(tconf.MultiLayerConfiguration.from_json(conf_json),
               device="cpu").init()
    net.params = params_from_numpy(net, weights)
    if precision:
        net.set_precision(precision)
    return net


def dp_run(conf_json, weights, mode: str, mesh, batch, steps: int):
    """`steps` data-parallel steps of `mode` on `batch` from `weights`:
    (losses, published params, published updater state)."""
    net = make_net(conf_json, weights)
    tr = TDP(net, mesh=mesh, **MODES[mode])
    losses = [tr.fit_batch(*batch) for _ in range(steps)]
    tr.finalize()
    return losses, flat(net.params), flat(net.updater_state)


def poison_run(conf_json, weights, shard: bool, mesh, batch,
               plant: bool) -> dict:
    """"mixed": 3 clean steps, a batch infinite in row 3 (global shard 0
    of 4), then a clean batch whose shard-0 gradient carries an inf at
    flat lane k0 - 1, which the reduce-scatter hands the last shard
    (`plant`: this process holds global shard 0).  Each poisoned step
    must leave params and moments bitwise and halve the scale."""
    net = make_net(conf_json, weights, "mixed")
    tr = TDP(net, mesh=mesh, shard_update=shard)
    x, y = batch
    out = {"clean": [tr.fit_batch(x, y) for _ in range(3)], "legs": []}

    def leg(xb, yb):
        tr.publish_train_state()
        p0, u0 = flat(net.params), flat(net.updater_state)
        s0 = net.scaler_stats()
        loss = tr.fit_batch(xb, yb)
        tr.publish_train_state()
        p1, u1 = flat(net.params), flat(net.updater_state)
        s1 = net.scaler_stats()
        out["legs"].append({
            "loss": loss, "scaler_before": s0, "scaler_after": s1,
            "unchanged": all(np.array_equal(p0[k], p1[k]) for k in p0)
            and all(np.array_equal(u0[k], u1[k]) for k in u0)})

    bad = x.copy()
    bad[3, 1] = np.inf
    leg(bad, y)
    plain = tr._shard_grads

    def planted(*args, **kwargs):
        pieces = plain(*args, **kwargs)
        if plant:
            grads = pieces[0][2]
            grads[-1] = grads[-1].clone()
            grads[-1].view(-1)[-1] = float("inf")
        return pieces

    tr._shard_grads = planted
    leg(x, y)
    del tr._shard_grads
    out["next_loss"] = tr.fit_batch(x, y)
    tr.publish_train_state()
    out["params"] = flat(net.params)
    return out


def ckpt_run(conf_json, weights, mesh, batch, directory) -> dict:
    """ZeRO-1: `RESUME_AT` steps, a checkpoint, `RESUME_STEPS` more (the
    uninterrupted run)."""
    net = make_net(conf_json, weights)
    tr = TDP(net, mesh=mesh)
    losses = [tr.fit_batch(*batch) for _ in range(RESUME_AT)]
    tr.publish_train_state()
    saved = (flat(net.params), flat(net.updater_state))
    tck.save_checkpoint(directory, RESUME_AT, net.params,
                        updater_state=net.updater_state)
    losses += [tr.fit_batch(*batch) for _ in range(RESUME_STEPS)]
    tr.finalize()
    return {"losses": losses, "saved": saved,
            "params": flat(net.params), "updater": flat(net.updater_state)}


def resume_run(conf_json, weights, mesh, batch, directory) -> dict:
    """A fresh trainer resumed from the checkpoint, `RESUME_STEPS` on."""
    net = make_net(conf_json, weights)
    tr = TDP(net, mesh=mesh)
    step = tr.resume(directory)
    losses = [tr.fit_batch(*batch) for _ in range(RESUME_STEPS)]
    tr.finalize()
    return {"step": step, "losses": losses, "params": flat(net.params),
            "updater": flat(net.updater_state)}


def embedding_run(kind: str, mesh, device: str = "cpu") -> dict:
    """Word2Vec HS / NEG or GloVe over `mesh` on `device`: the learned
    tables."""
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    sents = corpus()
    if kind == "glove":
        g = Glove(vector_length=16, window=4, epochs=2, batch_size=512,
                  seed=3, mesh=mesh, device=device).fit(sents[:120])
        return {"syn0": g.syn0, "losses": np.asarray(g.losses)}
    neg = 5 if kind == "neg" else 0
    w = Word2Vec(vector_length=32, window=3, negative=neg, epochs=1,
                 batch_size=512, seed=7, mesh=mesh, device=device).fit(sents)
    return {"syn0": w.syn0, "out": w.syn1neg if neg else w.syn1}


def card_dp_run(mesh, steps: int = 3):
    """`tests/test_torch_cuda.py`'s run: a bf16 char-LSTM (vocab 20, H 32)
    through ZeRO-1 over `mesh` on card 0 from the seeded init; (losses,
    params, updater state, B5 launches)."""
    from deeplearning4j_tpu_torch.models import char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as tlk

    net = TNet(char_lstm(vocab_size=20, hidden=32,
                         compute_dtype="bfloat16")).init()
    tr = TDP(net, mesh=mesh)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 20, (16, 12))
    eye = np.eye(20, dtype=np.float32)
    x, y = eye[ids], eye[np.roll(ids, -1, axis=1)]
    tlk.fused_lstm_forward.launches.reset()
    losses = [tr.fit_batch(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    launches = tlk.fused_lstm_forward.launches.value
    tr.finalize()
    return losses, flat(net.params), flat(net.updater_state), launches


# ---------------------------------------------------------------------------
# the scenarios of a job

def _dp(spec, res, arrays, mesh):
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as tlk

    calls = []
    plain = tlk.fused_lstm_forward_plain

    def counted(xz, *a, **k):
        calls.append(int(xz.shape[1]))
        return plain(xz, *a, **k)

    tlk.fused_lstm_forward_plain = counted
    try:
        for net, batch in (("mlp", mlp_data()), ("lstm", lstm_data())):
            for mode in MODES:
                steps = (LOCAL_STEPS if mode == "local_sgd" else STEPS)[net]
                losses, p, u = dp_run(spec["conf"][net],
                                      load_weights(spec["weights"][net]),
                                      mode, mesh, batch, steps)
                res[f"{net}/{mode}/losses"] = losses
                arrays.update({f"{net}/{mode}/params/{k}": v
                               for k, v in p.items()})
                arrays.update({f"{net}/{mode}/updater/{k}": v
                               for k, v in u.items()})
    finally:
        tlk.fused_lstm_forward_plain = plain
    res["lstm_calls"] = calls
    # dropout: each shard draws from its global index's generator
    losses, p, _ = dp_run(spec["conf"]["mlp_dropout"],
                          load_weights(spec["weights"]["mlp"]), "zero1",
                          mesh, mlp_data(), STEPS["mlp"])
    res["mlp_dropout/losses"] = losses
    arrays.update({f"mlp_dropout/params/{k}": v for k, v in p.items()})
    res["scaling_report"] = TDP(make_net(spec["conf"]["mlp"], load_weights(
        spec["weights"]["mlp"])), mesh=mesh).scaling_report()


def _poison(spec, res, arrays, mesh):
    for shard in (True, False):
        out = poison_run(spec["conf"]["mlp"],
                         load_weights(spec["weights"]["mlp"]), shard, mesh,
                         mlp_data(), plant=0 in mesh.local_shards())
        arrays.update({f"poison/{shard}/params/{k}": v
                       for k, v in out.pop("params").items()})
        res[f"poison/{shard}"] = out


def _ckpt(spec, res, arrays, mesh):
    directory = spec["ckpt_dir"]
    conf, weights = spec["conf"]["mlp"], load_weights(spec["weights"]["mlp"])
    run = ckpt_run(conf, weights, mesh, mlp_data(), directory)
    resumed = resume_run(conf, weights, mesh, mlp_data(), directory)
    res["ckpt"] = {"losses": run["losses"], "resumed_step": resumed["step"],
                   "resumed_losses": resumed["losses"]}
    for name, tree in (("saved_params", run["saved"][0]),
                       ("saved_updater", run["saved"][1]),
                       ("params", run["params"]), ("updater", run["updater"]),
                       ("resumed_params", resumed["params"]),
                       ("resumed_updater", resumed["updater"])):
        arrays.update({f"ckpt/{name}/{k}": v for k, v in tree.items()})
    try:
        tck.AsyncCheckpointListener(directory)
        res["async_refusal"] = None
    except NotImplementedError as e:
        res["async_refusal"] = str(e)


def _remote(spec, res, arrays, mesh):
    """`save_checkpoint_remote` into a local directory: process 1 uploads
    late, so process 0 waits at the barrier; process 0 lists the remote
    step when it writes COMMIT."""
    from deeplearning4j_tpu_torch.runtime import storage

    rank = mesh.process_index
    writes = []
    store = storage.LocalStore
    write, upload = store.write_bytes, store.upload_dir

    def logged_write(self, path, data):
        if path.endswith("COMMIT"):
            res["remote_at_commit"] = sorted(os.listdir(os.path.dirname(path)))
        write(self, path, data)
        writes.append((os.path.basename(path), time.time()))

    def late_upload(self, local, path):
        if rank == 1:
            time.sleep(0.5)
        return upload(self, local, path)

    store.write_bytes, store.upload_dir = logged_write, late_upload
    try:
        net = make_net(spec["conf"]["mlp"], load_weights(
            spec["weights"]["mlp"]))
        storage.save_checkpoint_remote(spec["remote_dir"], 7, net.params,
                                       net._updater.init(net.params))
    finally:
        store.write_bytes, store.upload_dir = write, upload
    res["remote_writes"] = writes


def _refusals(spec, res, arrays, mesh):
    """The LM mesh trainers and the ring over this mesh, and a collective
    given no mesh."""
    from deeplearning4j_tpu_torch.parallel import hybrid as th
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.parallel import transformer as tt

    cfg = tt.TransformerConfig(vocab_size=16, d_model=8, n_heads=2,
                               n_layers=2, d_ff=16, max_len=8)
    tokens = torch.zeros((4, 8), dtype=torch.long)
    # the ring runs over a "seq" axis: here all 4 shards, across processes
    ring = make_mesh((1, 4), ("data", "seq"), devices=["cpu"] * 2)
    calls = {
        "hybrid": lambda: th.HybridParallelTrainer(cfg, mesh),
        "pipeline": lambda: th.PipelineParallelTrainer(cfg, mesh),
        "accum_step": lambda: th.make_accum_train_step(cfg, mesh=mesh),
        "lm_loss": lambda: tt.lm_loss(cfg, {}, tokens, tokens, mesh),
        "ring": lambda: tt.lm_loss(cfg, {}, tokens, tokens, ring),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    res["refusals"] = out
    try:
        mesh_lib.psum([torch.ones(2)] * 2, torch.device("cpu"))
        res["collective_without_mesh"] = None
    except RuntimeError as e:
        res["collective_without_mesh"] = str(e)


def _embeddings(spec, res, arrays, mesh):
    for kind in ("hs", "neg", "glove"):
        for k, v in embedding_run(kind, mesh).items():
            arrays[f"{kind}/{k}"] = v


def _kill(spec, res, arrays, mesh):
    """One good checkpoint, then a save in which process 1 is SIGKILLed
    right after writing its params file: process 0 must fail at the
    ``written`` barrier instead of committing."""
    net = make_net(spec["conf"]["mlp"], load_weights(spec["weights"]["mlp"]))
    tr = TDP(net, mesh=mesh)
    x, y = mlp_data()
    tr.fit_batch(x, y)
    tr.publish_train_state()
    tck.save_checkpoint(spec["ckpt_dir"], 1, net.params,
                        updater_state=net.updater_state)
    tr.fit_batch(x, y)
    tr.publish_train_state()
    if mesh.process_index == 1:
        def die(phase, path):
            if phase == "shard:params.proc00001.npz":
                os.kill(os.getpid(), signal.SIGKILL)
        tck.set_phase_hook(die)
    t0 = time.monotonic()
    try:
        tck.save_checkpoint(spec["ckpt_dir"], 2, net.params,
                            updater_state=net.updater_state)
        res["second_save"] = "returned"
    except RuntimeError as e:
        res["second_save"] = str(e)
    res["second_save_s"] = time.monotonic() - t0


def _card_dp(spec, res, arrays, mesh):
    losses, p, u, res["b5"] = card_dp_run(mesh)
    res["losses"] = losses
    arrays.update({f"params/{k}": v for k, v in p.items()})
    arrays.update({f"updater/{k}": v for k, v in u.items()})


def _card_embeddings(spec, res, arrays, mesh):
    for kind in ("neg", "glove"):
        for k, v in embedding_run(kind, mesh, spec["device"]).items():
            arrays[f"{kind}/{k}"] = v


SCENARIOS = {"dp": _dp, "card_dp": _card_dp, "poison": _poison,
             "ckpt": _ckpt, "remote": _remote,
             "refusals": _refusals, "embeddings": _embeddings,
             "card_embeddings": _card_embeddings, "kill": _kill}


# ---------------------------------------------------------------------------
# the parent's side

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_job(out: pathlib.Path, scenarios, extra: dict, timeout_s: float,
            deadline_s: float, world: int = 2) -> list:
    """`world` worker processes through `scenarios` on a free local port,
    the group timeout `timeout_s`; their exit codes.  A job past
    `deadline_s` is killed and raises `TimeoutError` with the logs."""
    out.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(world):
        spec = dict(extra, rank=rank, world=world, out=str(out),
                    address=f"127.0.0.1:{port}", scenarios=scenarios,
                    timeout_s=timeout_s)
        with open(out / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, json.dumps(spec)], cwd=ROOT,
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"job {out.name} passed its {deadline_s} s "
                           f"deadline:\n{job_logs(out)}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def job_logs(out: pathlib.Path) -> str:
    return "\n".join(f"--- {p.name}\n{p.read_text()[-3000:]}"
                     for p in sorted(out.glob("rank*.log")))


def job_results(out: pathlib.Path, rank: int):
    """A rank's (json record, arrays)."""
    with np.load(out / f"rank{rank}.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads((out / f"rank{rank}.json").read_text()), arrays


def main(spec: dict) -> int:
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.runtime.launcher import (
        initialize_multihost,
    )

    torch.set_num_threads(1)
    rank = int(spec["rank"])
    device = spec.get("device", "cpu")
    # two processes on one card need gloo: NCCL refuses two ranks there
    info = initialize_multihost(spec["address"], spec["world"], rank,
                                backend=None if device == "cpu" else "gloo",
                                device=device, timeout_s=spec["timeout_s"])
    mesh = host_mesh(device=device)
    res = {"info": info, "local_shards": mesh.local_shards(),
           "process_of": mesh.process_of.tolist(), "mesh": repr(mesh)}
    arrays: dict = {}
    for name in spec["scenarios"]:
        SCENARIOS[name](spec, res, arrays, mesh)
    out = pathlib.Path(spec["out"])
    np.savez(out / f"rank{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    if "kill" in spec["scenarios"]:
        # the group lost a member: leave without tearing it down
        sys.stdout.flush()
        os._exit(0)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(json.loads(sys.argv[1])))
