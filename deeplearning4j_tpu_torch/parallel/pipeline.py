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
the stage axis; here it is one `mesh.Program` a process, the stages
lists with one entry a stage (None for a stage of another process), and
autograd differentiates through the schedule for the backward pipeline.
Each transfer — a microbatch from its owner stage to stage 0, the hop to
the next stage, an output to the stage that banks it — is a
`Program.move` (a copy within a process, a send paired with a receive
across two), one exchange a tick, in the same order on every process.

`zero1_flat_update` is the ZeRO-1 round over a flat update plane (the
pipeline trainer's stage and io planes): the padded flat gradients of
the data shards are reduce-scattered (`Program.psum_scatter`, in shard
order, then divided by the shard count — the additions of `mesh.pmean`,
so the result equals the replicated update bitwise), each shard updates
its slice of the parameters and its optimizer state, and the slices are
gathered back (`Program.all_gather`) with the padding stripped.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.ops.updaters import apply_updates
from deeplearning4j_tpu_torch.parallel.mesh import Program


def zero1_flat_update(transform, opt_shards: dict, flat_g: dict,
                      flat_p: dict, program: Program, axis: str, k0: int):
    """One ZeRO-1 weight-update round (arXiv 2004.13336) over the `axis`
    groups of `program`, each a flat plane, all planes at once.

    flat_g: ``{shard: its flat gradient}`` over this process's shards,
    padded to a multiple of the axis size (padding lanes zero); flat_p:
    ``{shard: the flat parameters of its plane}``, padded alike;
    opt_shards: ``{shard: its `transform` state over {"p": its slice}}``,
    on the shard's device.  Returns (``{shard: the new flat parameters
    of its plane, k0 long}``, the updated opt_shards)."""
    n = program.mesh.shape.get(axis, 1)
    g_sh = program.psum_scatter(flat_g, axis)
    new = {}
    for s in program.local:
        j = program.mesh.coord(s, axis)
        ksh = flat_p[s].shape[0] // n
        p_sh = flat_p[s][j * ksh:(j + 1) * ksh].to(program.device(s),
                                                  copy=True)
        up, opt_shards[s] = transform.update({"p": g_sh[s] / n},
                                             opt_shards[s], {"p": p_sh})
        new[s] = apply_updates({"p": p_sh}, up)["p"]
    return ({s: f[:k0] for s, f in program.all_gather(new, axis).items()},
            opt_shards)


def gpipe_apply(stage_fn: Callable, stage_params: Sequence,
                x_local: Sequence[Optional[torch.Tensor]], axis: str,
                n_microbatches: int, remat_stage: bool = True, *,
                program: Program, shards: Sequence[int]) -> list:
    """Run the microbatch pipeline over the stages' local input shares.

    stage_fn(params, x) -> y, the activation shape kept.  stage_params:
    each stage's parameters, in stage order.  x_local: each stage's
    blocked share ``[K, mb, ...]`` of the `n_microbatches` microbatches
    (stage s owns ``[s K, (s + 1) K)``; slots past `n_microbatches` are
    padding), on its stage's device — the devices of the `axis` stages.
    Returns each stage's share of the outputs in the same layout
    (padding slots zero).

    ``shards[s]`` is stage s's shard of `program`: the entries of the
    stages on other processes are None in both lists and in the result,
    and the transfers are the program's `move`s.

    remat_stage (default True): the stage forward of each tick is
    recomputed in the backward (`torch.utils.checkpoint`), so only each
    tick's input is kept, GPipe's memory discipline."""
    n_stages = len(x_local)
    if len(stage_params) != n_stages:
        raise ValueError(f"{len(stage_params)} stage parameter sets for "
                         f"{n_stages} '{axis}' stages")
    present = [x for x in x_local if x is not None]
    k = present[0].shape[0]
    m = n_microbatches
    if k * n_stages < m:
        raise ValueError(
            f"x_local holds {k} slots/stage x {n_stages} stages "
            f"< {m} microbatches; pad each stage's share to "
            f"ceil(M/P) slots")

    def move(pairs, xs):
        return program.move([(shards[a], shards[b]) for a, b in pairs], xs)

    def run(params, x):
        if remat_stage and torch.is_grad_enabled():
            return checkpoint(stage_fn, params, x, use_reentrant=False)
        return stage_fn(params, x)

    def local(s):
        return x_local[s] is not None

    outputs = [[None] * k for _ in range(n_stages)]
    incoming = [None] * n_stages

    def deliver(transfers):
        """(output slot or None, src, dst, value) each: one exchange."""
        got = move([(a, b) for _, a, b, _ in transfers],
                   {i: v for i, (_, a, _, v) in enumerate(transfers)
                    if local(a)})
        for i, (slot, _, b, _) in enumerate(transfers):
            if i in got:
                if slot is None:
                    incoming[b] = got[i]
                else:
                    outputs[b][slot] = got[i]

    def inject(t):
        """Microbatch t from the stage that owns it to stage 0."""
        a = t // k
        return (None, a, 0, x_local[a][t % k] if local(a) else None)

    deliver([inject(0)])
    for t in range(m + n_stages - 1):
        ys = [None] * n_stages
        for s in range(n_stages):
            if local(s) and s <= t < s + m:    # else a bubble tick
                ys[s] = run(stage_params[s], incoming[s])
        incoming[:] = [None] * n_stages
        # activations hop one stage along the ring; the last stage's
        # result is microbatch t - (P - 1), banked by the owner of that
        # output slot; the next microbatch goes to stage 0
        transfers = [(None, s, s + 1, ys[s]) for s in range(n_stages - 1)
                     if s <= t < s + m]
        out_idx = t - (n_stages - 1)
        if 0 <= out_idx < m:
            transfers.append((out_idx % k, n_stages - 1, out_idx // k,
                              ys[-1]))
        if t + 1 < m:
            transfers.append(inject(t + 1))
        deliver(transfers)
    out = []
    for s, slots in enumerate(outputs):
        if not local(s):
            out.append(None)
            continue
        zero = torch.zeros_like(x_local[s][0])
        out.append(torch.stack([zero if y is None else y for y in slots]))
    return out


__all__ = ["gpipe_apply", "zero1_flat_update"]
