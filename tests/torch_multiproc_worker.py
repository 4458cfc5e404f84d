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
`embedding_run`, `lm_run`, `ring_run`) are the parent's too: it calls
them on a one-process mesh of 4 shards, so both sides run the same code
on the same inputs.
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


# ---- the LM mesh trainers and the ring (test_torch_multiprocess_lm.py)

LM_BASE = dict(vocab_size=61, d_model=16, n_heads=4, n_layers=2, d_ff=32,
               max_len=16)
LM_MOE = dict(n_layers=1, n_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
LM_PIPE = dict(vocab_size=41, n_layers=4, tie_embeddings=True)
LM_STEPS = 3
# name -> (trainer, mesh shape, config, trainer keywords)
LM_CASES = {
    "hybrid_2x1x2": ("hybrid", (2, 1, 2), {}, {}),
    "hybrid_1x2x2": ("hybrid", (1, 2, 2), {}, {}),
    "hybrid_1x4x1": ("hybrid", (1, 4, 1), {}, {}),
    "hybrid_1x1x4": ("hybrid", (1, 1, 4), {}, {}),
    "hybrid_adam_2x1x2": ("hybrid", (2, 1, 2), dict(tie_embeddings=True),
                          dict(updater="adam", lr=0.01)),
    "hybrid_adam_replicated_1x2x2": ("hybrid", (1, 2, 2),
                                     dict(tie_embeddings=True),
                                     dict(updater="adam", lr=0.01,
                                          shard_update=False)),
    "moe_1x1x4": ("hybrid", (1, 1, 4), LM_MOE, {}),
    "moe_1x2x2": ("hybrid", (1, 2, 2), LM_MOE, {}),
    "hybrid_remat_1x2x2": ("hybrid", (1, 2, 2), dict(remat=True), {}),
    "moe_remat_1x2x2": ("hybrid", (1, 2, 2), dict(LM_MOE, remat=True), {}),
    "pipeline_1x4": ("pipeline", (1, 4), LM_PIPE, dict(n_microbatches=4)),
    "pipeline_2x2": ("pipeline", (2, 2), LM_PIPE, dict(n_microbatches=2)),
    "pipeline_adam_replicated_2x2": ("pipeline", (2, 2), LM_PIPE,
                                     dict(n_microbatches=2, updater="adam",
                                          lr=0.01, shard_update=False)),
    "accum_4": ("accum", (4,), dict(vocab_size=31, max_len=8), {}),
}
RING_SHAPE = (2, 16, 2, 8)       # [B, S, H, D], S over 4 seq shards


def lm_config(case: str):
    from deeplearning4j_tpu_torch.parallel import transformer as tt

    return tt.TransformerConfig(**{**LM_BASE, **LM_CASES[case][2]})


def lm_batch(case: str):
    """The case's (tokens, targets): [4, 16] for the hybrid, [8, 8] for
    the pipeline, 3 batches [8, 8] of next tokens for the accum step."""
    kind, vocab = LM_CASES[case][0], lm_config(case).vocab_size
    rng = np.random.default_rng(2)
    if kind == "accum":
        return [rng.integers(0, vocab, (8, 9)) for _ in range(3)]
    b, s = (4, 16) if kind == "hybrid" else (8, 8)
    return rng.integers(0, vocab, (b, s)), rng.integers(0, vocab, (b, s))


def lm_mesh(case: str, per_process: int = 2):
    kind, shape = LM_CASES[case][:2]
    names = {"hybrid": ("data", "seq", "model"), "pipeline": ("data", "stage"),
             "accum": ("data",)}[kind]
    return make_mesh(shape, names, devices=["cpu"] * per_process)


def unflatten(flat: dict):
    """``{"a//0//b": v}`` -> ``{"a": [{"b": v}]}`` (a node whose keys are
    all digits is a list)."""
    tree: dict = {}
    for key, v in flat.items():
        *parents, last = key.split("//")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = v
    return _lists(tree)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def lm_run(case: str, mesh, weights: dict) -> tuple:
    """`LM_STEPS` steps of the case's trainer over `mesh` from `weights`
    (a flat ``//``-keyed numpy map, the `init_params` layout): (losses,
    the exported parameters flat, the flash launches of this process)."""
    from deeplearning4j_tpu_torch.parallel import hybrid as th
    from deeplearning4j_tpu_torch.parallel import ring_attention as tr
    from deeplearning4j_tpu_torch.parallel import transformer as tt
    from deeplearning4j_tpu_torch.tree import flatten_tree

    kind, _, _, kw = LM_CASES[case]
    cfg, tree = lm_config(case), unflatten(weights)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tr.flash_forward, tr.flash_bwd_block

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    tr.flash_forward, tr.flash_bwd_block = count_fwd, count_bwd
    try:
        if kind == "accum":
            params = th._master_f32(tt.params_from_numpy(tree, device="cpu"))
            step, init = th.make_accum_train_step(cfg, lr=1e-2, accum=2,
                                                  updater="adam", mesh=mesh)
            opt, losses = init(params), []
            for b in lm_batch(case):
                b = torch.from_numpy(b)
                params, opt, loss = step(params, opt, b[:, :-1], b[:, 1:])
                losses.append(float(loss))
            out = tt.params_to_numpy(params)
        else:
            cls = (th.HybridParallelTrainer if kind == "hybrid"
                   else th.PipelineParallelTrainer)
            kw = dict(kw)
            kw.setdefault("lr", 0.05)
            trainer = cls(cfg, mesh, params=tree, **kw)
            tok, tgt = lm_batch(case)
            losses = [trainer.fit_batch(tok, tgt) for _ in range(LM_STEPS)]
            out = trainer.export_params()
    finally:
        tr.flash_forward, tr.flash_bwd_block = fwd, bwd
    return losses, flatten_tree(out), calls


def ring_inputs():
    rng = np.random.default_rng(7)
    return [rng.standard_normal(RING_SHAPE).astype(np.float32)
            for _ in range(3)]


def ring_run(flash: bool, causal: bool, mesh) -> dict:
    """The ring over the 4 "seq" shards of `mesh` on `ring_inputs`: this
    process's blocks of the output and of the gradients of
    ``sum(out ** 2)``, by global block index."""
    from deeplearning4j_tpu_torch.parallel import ring_attention as tr
    from deeplearning4j_tpu_torch.parallel.mesh import Program

    prog = Program(mesh)
    n = mesh.shape["seq"]
    blocks = [dict(zip(range(n), torch.from_numpy(a).chunk(n, dim=1)))
              for a in ring_inputs()]
    leaves = [{s: b[s].clone().requires_grad_(True) for s in prog.local}
              for b in blocks]
    fn = tr.ring_flash_attention if flash else tr.ring_attention
    out = fn(*leaves, "seq", causal, program=prog)
    loss = sum((o ** 2).sum() for o in out.values())
    grads = torch.autograd.grad(loss, [t for lv in leaves
                                       for t in lv.values()])
    res = {f"out/{s}": o.detach().numpy() for s, o in out.items()}
    it = iter(grads)
    for name, lv in zip("qkv", leaves):
        for s in lv:
            res[f"d{name}/{s}"] = next(it).numpy()
    return res


def card_lm_run(mesh, steps: int = 3) -> tuple:
    """`tests/test_torch_cuda.py`'s LM run: a bf16 TransformerLM (vocab
    256, d 64, 4 heads, 2 layers, attention biases) through
    `HybridParallelTrainer` (Adam, ZeRO-1) over `mesh` on card 0, batch 4
    x 128, from ``numpy_params(seed=0)``; (losses, exported parameters
    flat, this process's B2 / B3 / B4 launches)."""
    from deeplearning4j_tpu_torch.parallel import hybrid as th
    from deeplearning4j_tpu_torch.parallel import kernels as fk
    from deeplearning4j_tpu_torch.parallel import transformer as tt
    from deeplearning4j_tpu_torch.tree import flatten_tree

    cfg = tt.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                               n_layers=2, d_ff=256, max_len=128,
                               dtype="bfloat16", attn_bias=True,
                               remat=True)
    tr = th.HybridParallelTrainer(cfg, mesh, lr=1e-3, updater="adam",
                                  params=tt.numpy_params(cfg, seed=0))
    rng = np.random.default_rng(0)
    tok, tgt = (rng.integers(0, 256, (4, 128)) for _ in range(2))
    counters = (fk.flash_forward.launches, fk.flash_bwd_dkv.launches,
                fk.flash_bwd_dq.launches)
    for c in counters:
        c.reset()
    losses = [tr.fit_batch(tok, tgt) for _ in range(steps)]
    torch.cuda.synchronize()
    launches = [c.value for c in counters]
    return losses, flatten_tree(tr.export_params()), launches


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
    """A collective given no mesh in a job of several processes."""
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib

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


def _card_lm(spec, res, arrays, mesh):
    ring = make_mesh((1, 2, 2), ("data", "seq", "model"),
                     devices=[spec["device"]] * 2)
    res["losses"], params, res["launches"] = card_lm_run(ring)
    arrays.update(params)


def _card_embeddings(spec, res, arrays, mesh):
    for kind in ("neg", "glove"):
        for k, v in embedding_run(kind, mesh, spec["device"]).items():
            arrays[f"{kind}/{k}"] = v


def p2p_payload(rank: int) -> list:
    """What process `rank` sends its peer in the direct `_p2p` check:
    three dtypes, one of them 4 MiB."""
    return [torch.arange(6, dtype=torch.int64).reshape(2, 3) + 10 * rank,
            torch.full((1 << 20,), float(rank) + 0.5),
            torch.tensor([rank == 0, rank == 1, True]).to(torch.float16)]


def _lm(spec, res, arrays, mesh):
    """A direct `_p2p` exchange, every LM case, then every ring, over
    meshes of 2 host shards a process (each mesh built by both
    processes, in the same order); every `_p2p` call and every
    `batch_isend_irecv` batch counted."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib

    counts = {"calls": 0, "batches": 0}
    p2p, batch = mesh_lib._p2p, dist.batch_isend_irecv

    def count_p2p(*a, **k):
        counts["calls"] += 1
        return p2p(*a, **k)

    def count_batch(ops):
        counts["batches"] += 1
        return batch(ops)

    mesh_lib._p2p, dist.batch_isend_irecv = count_p2p, count_batch
    try:
        peer = 1 - mesh.process_index
        got = mesh_lib._p2p(mesh, {peer: p2p_payload(mesh.process_index)},
                            [peer], torch.device("cpu"))
        for i, t in enumerate(got[peer]):
            arrays[f"p2p/{i}"] = t.numpy()
        for case in spec["lm_cases"]:
            with np.load(spec["lm_weights"][case]) as z:
                weights = {k: z[k] for k in z.files}
            losses, params, calls = lm_run(case, lm_mesh(case), weights)
            res[f"{case}/losses"] = losses
            res[f"{case}/launches"] = calls
            arrays.update({f"{case}/{k}": v for k, v in params.items()})
        ring = make_mesh((4,), ("seq",), devices=["cpu"] * 2)
        for flash in (True, False):
            for causal in (True, False):
                for k, v in ring_run(flash, causal, ring).items():
                    arrays[f"ring/{flash}/{causal}/{k}"] = v
    finally:
        mesh_lib._p2p, dist.batch_isend_irecv = p2p, batch
    res["p2p"] = counts


SCENARIOS = {"dp": _dp, "lm": _lm, "card_dp": _card_dp,
             "card_lm": _card_lm, "poison": _poison, "ckpt": _ckpt,
             "remote": _remote, "refusals": _refusals,
             "embeddings": _embeddings,
             "card_embeddings": _card_embeddings, "kill": _kill}


# ---------------------------------------------------------------------------
# the parent's side

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_job(out: pathlib.Path, scenarios, extra: dict, timeout_s: float,
            deadline_s: float, world: int = 2) -> list:
    """`world` worker processes through `scenarios` on a free local port,
    the group timeout `timeout_s`; their exit codes.  A job past
    `deadline_s` is killed and raises `TimeoutError` with the logs."""
    return wait_job(out, start_job(out, scenarios, extra, timeout_s, world),
                    deadline_s)


def start_job(out: pathlib.Path, scenarios, extra: dict, timeout_s: float,
              world: int = 2) -> list:
    """`run_job`'s first half: the started workers, with the time they
    started (`wait_job` counts the deadline from it)."""
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
    return [time.monotonic(), procs]


def wait_job(out: pathlib.Path, job: list, deadline_s: float) -> list:
    """`run_job`'s second half: the exit codes, or `TimeoutError` (the
    workers killed) once `deadline_s` from the start has passed."""
    started, procs = job
    deadline = started + deadline_s
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
