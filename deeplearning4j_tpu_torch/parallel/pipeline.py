"""Pipeline parallelism: layers cut over a ``stage`` mesh axis
(counterpart of `deeplearning4j_tpu.parallel.pipeline`).

GPipe's schedule: the microbatches enter stage 0 one a tick and hop
stage to stage, one stage a tick (copied onto the next stage's device,
where JAX shifts them with ``lax.ppermute``), so a step runs ``M + P -
1`` ticks for M microbatches over P stages.  As in the JAX module,
microbatches are not replicated to every stage: stage s holds only its
blocked share, microbatches ``[s K, (s + 1) K)`` with ``K = ceil(M /
P)``, injects each
when its tick comes, and banks the outputs of the same slots; slots past
M are padding and are never injected.  A bubble tick (stage s before
tick s or after tick ``s + M - 1``) runs nothing — a Python branch where
JAX has ``lax.cond``.  The JAX function is one ``shard_map`` program over
the stage axis; here the stages are lists, one entry a stage, each on its
stage's device, and autograd differentiates through the schedule for the
backward pipeline.

`zero1_flat_update` is the ZeRO-1 round over a flat update plane (the
pipeline trainer's stage and io planes): the padded flat gradients of
the data shards are reduce-scattered (`mesh.psum_scatter`, in shard
order, then divided by the shard count — the additions of `mesh.pmean`,
so the result equals the replicated update bitwise), each shard updates
its slice of the parameters and its optimizer state, and the slices are
gathered back with the padding stripped.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.ops.updaters import apply_updates
from deeplearning4j_tpu_torch.parallel.mesh import all_gather, psum_scatter


def zero1_flat_update(transform, opt_shards: list,
                      flat_g: Sequence[torch.Tensor], flat_p: torch.Tensor,
                      devices: Sequence[torch.device], k0: int):
    """One ZeRO-1 weight-update round (arXiv 2004.13336) over the data
    shards of a flat plane.

    flat_g: each data shard's flat gradient, padded to a multiple of the
    shard count (padding lanes zero); flat_p: the flat parameters, padded
    alike; opt_shards: each shard's `transform` state over ``{"p": its
    slice}``, on ``devices[j]``.  Returns (the new flat parameters, k0
    long, on flat_p's device; the updated opt_shards)."""
    n = len(flat_g)
    ksh = flat_g[0].shape[0] // n
    g_sh = [g / n for g in psum_scatter(flat_g, devices)]
    new = []
    for j, dev in enumerate(devices):
        p_sh = flat_p[j * ksh:(j + 1) * ksh].to(dev, copy=True)
        up, opt_shards[j] = transform.update({"p": g_sh[j]}, opt_shards[j],
                                             {"p": p_sh})
        new.append(apply_updates({"p": p_sh}, up)["p"])
    return all_gather(new, flat_p.device)[:k0], opt_shards


def gpipe_apply(stage_fn: Callable, stage_params: Sequence,
                x_local: Sequence[torch.Tensor], axis: str,
                n_microbatches: int,
                remat_stage: bool = True) -> List[torch.Tensor]:
    """Run the microbatch pipeline over the stages' local input shares.

    stage_fn(params, x) -> y, the activation shape kept.  stage_params:
    each stage's parameters, in stage order.  x_local: each stage's
    blocked share ``[K, mb, ...]`` of the `n_microbatches` microbatches
    (stage s owns ``[s K, (s + 1) K)``; slots past `n_microbatches` are
    padding), on its stage's device — the devices of the `axis` stages.
    Returns each stage's share of the outputs in the same layout
    (padding slots zero).

    remat_stage (default True): the stage forward of each tick is
    recomputed in the backward (`torch.utils.checkpoint`), so only each
    tick's input is kept, GPipe's memory discipline."""
    n_stages = len(x_local)
    if len(stage_params) != n_stages:
        raise ValueError(f"{len(stage_params)} stage parameter sets for "
                         f"{n_stages} '{axis}' stages")
    k = x_local[0].shape[0]
    m = n_microbatches
    if k * n_stages < m:
        raise ValueError(
            f"x_local holds {k} slots/stage x {n_stages} stages "
            f"< {m} microbatches; pad each stage's share to "
            f"ceil(M/P) slots")
    devices = [x.device for x in x_local]

    def run(params, x):
        if remat_stage and torch.is_grad_enabled():
            return checkpoint(stage_fn, params, x, use_reentrant=False)
        return stage_fn(params, x)

    outputs = [[None] * k for _ in range(n_stages)]
    incoming = [None] * n_stages
    for t in range(m + n_stages - 1):
        ys = [None] * n_stages
        for s in range(n_stages):
            if not s <= t < s + m:
                continue                       # a bubble tick: no work
            # stage 0 takes microbatch t from the stage that owns it
            x_in = (x_local[t // k][t % k].to(devices[0]) if s == 0
                    else incoming[s])
            ys[s] = run(stage_params[s], x_in)
        # the last stage's result is microbatch t - (P - 1); the owner
        # of that output slot banks it
        out_idx = t - (n_stages - 1)
        if 0 <= out_idx < m:
            owner = out_idx // k
            outputs[owner][out_idx % k] = ys[-1].to(devices[owner])
        # activations hop one stage along the ring
        incoming = [None] + [None if y is None else y.to(devices[s + 1])
                             for s, y in enumerate(ys[:-1])]
    out = []
    for s, slots in enumerate(outputs):
        zero = torch.zeros_like(x_local[s][0])
        out.append(torch.stack([zero if y is None else y for y in slots]))
    return out


__all__ = ["gpipe_apply", "zero1_flat_update"]
