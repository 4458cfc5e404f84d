"""Training steps of the port's single-device LM trainer.

Set-up makes the float32 masters on the device from the seed, builds one
step object (`make_accum_train_step` with the mix's optimizer), stages
``staged_batches`` distinct batches on the card, and drives that same
object through its first ``setup_steps`` steps on batches 0, 1, 2 (rows
that all differ), through the window's own call: these build and warm
every kernel, and they are what the reference follows.  After the first
step the gradient the optimizer took is read back from its first moment
(``m / (1 - beta1)``, kept in host memory); after the last, each leaf's
change.

The window steps on through the staged batches in turn for
``--seconds`` and ends with a synchronise; no loss is read on the host
inside it.  ``train_tokens_per_s``: tokens of the window's steps over the
time from its first step to that synchronise.  With a trace,
``trace_steps`` more steps run under the profiler.

``correct``: the set-up steps' losses, first gradients and changes
against the plain float32 reference from the same weights and batches
(`reference.judge`), and every loss of the run finite.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import gen, peaks, weights
from benchmark.kinds import peak_bytes, port_config, release, sync
from benchmark.reference import gpt2 as ref
from benchmark.reference import judge
from benchmark.trace import Tracer


def _launches(fk) -> dict:
    return {"flash_fwd": fk.flash_forward.launches.value,
            "flash_bwd_dkv": fk.flash_bwd_dkv.launches.value,
            "flash_bwd_dq": fk.flash_bwd_dq.launches.value}


def _step_adam() -> dict:
    """The Adam constants `make_accum_train_step` runs, which it takes no
    argument for: `UpdaterConfig`'s betas and an epsilon of 1e-8."""
    from deeplearning4j_tpu_torch.ops.updaters import UpdaterConfig

    u = UpdaterConfig()
    return {"beta1": u.beta1, "beta2": u.beta2, "eps": 1e-8}


def run(cell, cfg, mix, seed, seconds, trace, device, t_start) -> dict:
    from deeplearning4j_tpu_torch.parallel import kernels as fk
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        make_accum_train_step,
    )

    dims = weights.gpt2_dims(cfg)
    o = mix["optimizer"]
    # the reference reads the mix's constants: they have to be the step's
    for k, v in _step_adam().items():
        if float(o[k]) != v:
            raise ValueError(f"the mix's optimizer {k} is {o[k]}, the "
                             f"port's step runs {v}")
    gb, seq, accum = int(mix["global_batch"]), int(mix["seq_len"]), \
        int(mix["accum"])
    step, init = make_accum_train_step(
        port_config(cfg, remat=mix["remat"]), lr=float(o["lr"]),
        accum=accum, updater=o["updater"], clip_norm=float(o["clip_norm"]),
        weight_decay=float(o["weight_decay"]))
    params = weights.make(cfg, seed, device, torch.float32, separate=True)
    for _, p in weights.leaves(params):
        p.requires_grad_(True)
    names = [weights.path_name(p) for p, _ in weights.leaves(params)]
    opt = init(params)
    data = torch.from_numpy(gen.train_batches(mix, dims["V"], seed)).to(
        device)
    tok = data[:, :, :-1].contiguous()
    tgt = data[:, :, 1:].contiguous()
    n_staged = data.shape[0]
    start = [p.detach().clone() for _, p in weights.leaves(params)]
    losses = []
    for i in range(int(mix["setup_steps"])):
        params, opt, loss = step(params, opt, tok[i], tgt[i])
        losses.append(loss)
        if i == 0:
            # the gradient the optimizer took: m / (1 - beta1) after one
            # step, its norms, and itself in host memory
            first = {n: (m.detach() / (1.0 - float(o["beta1"]))).cpu()
                     for n, (_, m) in zip(names, weights.leaves(opt["m"]))}
            grad = torch.stack([torch.linalg.vector_norm(first[n])
                                for n in names])
    change = torch.stack([torch.linalg.vector_norm(p.detach() - s)
                          for (_, p), s in zip(weights.leaves(params),
                                               start)])
    del start
    k = len(losses)
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds:
        params, opt, loss = step(params, opt, tok[k % n_staged],
                                 tgt[k % n_staged])
        losses.append(loss)
        k += 1
    sync(device)
    t1 = time.perf_counter()
    steps = k - int(mix["setup_steps"])
    traced = None
    if trace:
        tracer = Tracer(device)
        tracer.start()
        la = _launches(fk)
        for _ in range(int(mix["trace_steps"])):
            params, opt, loss = step(params, opt, tok[k % n_staged],
                                     tgt[k % n_staged])
            losses.append(loss)
            k += 1
        lb = _launches(fk)
        traced = tracer.stop()
        traced["counters"] = {n: lb[n] - la[n] for n in la}
        traced["steps"] = int(mix["trace_steps"])
    memory_peak = peak_bytes(device)
    t_after = time.perf_counter()
    loss_values = [float(x) for x in losses]
    prog = {"loss": loss_values[:int(mix["setup_steps"])],
            "grad": dict(zip(names, grad.tolist())), "first": first,
            "change": dict(zip(names, change.tolist()))}
    e2e = {"train_tokens_per_s": steps * gb * seq / (t1 - t0),
           "setup_s": setup_s}
    mb = gb // accum
    ctx = {"kind": "train", "dims": dims, "dtype": cfg["dtype"],
           "seconds": t1 - t0, "steps": steps,
           "step_flops": peaks.train_step_flops(dims, gb, seq),
           "shapes": {"b": mb, "s": seq, "h": dims["H"], "d": dims["K"],
                      "causal": True, "dtype": cfg["dtype"]},
           "trace": traced}

    # the comparison, once the program's state is gone
    seen = [data[i].clone() for i in range(int(mix["setup_steps"]))]
    del params, opt, step, grad, change, data, tok, tgt, losses
    release(device)
    w = weights.make(cfg, seed, device, torch.float32, separate=True)
    ref.exact_float32()
    r = ref.train_steps(w, seen, dims["eps"], o, accum,
                        int(mix["reference_rows"]))
    del w, seen
    release(device)
    timing = {"setup_s": setup_s, "window_s": t1 - t0,
              "after_window_s": t_after - t1,
              "reference_s": time.perf_counter() - t_after}
    numbers = judge.train_numbers(prog, r)
    numbers["nonfinite_losses"] = {
        "value": float(sum(not math.isfinite(x) for x in loss_values))}
    return {"attempted": len(loss_values), "failed": 0, "timing": timing,
            "end_to_end": e2e, "ctx": ctx, "trace": traced,
            "memory_peak_bytes": memory_peak, "numbers": numbers,
            "program": prog, "reference": r}
