"""Ring attention: exact attention over a sequence cut across shards
(counterpart of `deeplearning4j_tpu.parallel.ring_attention`).

The sequence dimension is split over a mesh axis: shard i holds the
query, key and value block of positions ``[i * S_local, (i + 1) *
S_local)``, and the key / value blocks rotate one step around the ring
(`Program.ppermute`) while each shard folds the block it holds into its
running softmax, so the result is exact attention over the whole
sequence with O(S / P) memory a shard.  At ring step r, shard i holds
block ``(i - r) mod P``, as under ``lax.ppermute`` in JAX.

The JAX functions run inside ``shard_map`` on one local block.  The port
runs one SPMD program a process (`mesh.Program`): q, k and v are dicts
``{shard: block}`` over this process's shards of every ring along the
axis at once, each block at its global ring position, and the blocks hop
through the program's exchanges (a copy, or nothing, within a process; a
send paired with a receive across two).  The pairs a shard computes
depend on global block indices only, so a ring cut over processes
computes the same pairs, bit for bit, as in one process.  A caller with
one process's blocks builds the program over a one-process mesh.
``axis_name=None`` is the one-shard case: single tensors, the
single-device path.

- `ring_attention` — the plain blockwise ring: an ``(m, l, o)``
  accumulator in float32 over ``[S_local, S_local]`` score blocks,
  differentiated by autograd.
- `ring_flash_attention` — the flash kernels as the inner block
  (`kernels.flash_forward`, B2, for each block pair that is not fully
  masked: the diagonal pair causal, the earlier ones full), combined by
  ``logaddexp`` of the block lse; its backward is a second ring pass
  that computes ``delta = rowsum(dO * O)`` once against the global lse
  and runs `kernels.flash_bwd_block` (B3 then B4) on each such pair: dQ
  accumulates on its shard, dK and dV on the rotating block, which comes
  home after the full circle.  A fully masked pair (a later block under
  the causal mask) launches nothing, so a causal ring of P shards runs
  ``P (P + 1) / 2`` block pairs and a non-causal one ``P**2``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.parallel.kernels import (
    NEG_INF,
    flash_attention,
    flash_bwd_block,
    flash_forward,
    row_delta,
)
from deeplearning4j_tpu_torch.parallel.mesh import Program


class _ProgramRing:
    """Every ring along `axis` of a `Program`, as this process holds it:
    its local shards' blocks (in `program.local` order) at their global
    positions, hops through `Program.hop` (one exchange for all lists)."""

    def __init__(self, program: Program, axis: str):
        # the tensor-free wiring: the autograd node keeps this object
        self.wiring, self.axis = program.wiring, axis
        self.n = program.mesh.shape.get(axis, 1)
        self.pos = [program.mesh.coord(s, axis) for s in program.local]

    def hop(self, *lists) -> List[list]:
        if self.n == 1:
            return [list(b) for b in lists]
        keys = self.wiring.local
        moved = self.wiring.hop(self.axis, 1,
                                *(dict(zip(keys, b)) for b in lists))
        return [[m[k] for k in keys] for m in moved]


def _block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor):
    """One query block against one key block, in float32: q ``[B, Sq, H,
    D]``, k and v ``[B, Sk, H, D]``, mask ``[Sq, Sk]`` (True = attend) ->
    (row max m ``[B, Sq, H]``, row sum l ``[B, Sq, H]``, unnormalised
    out o ``[B, Sq, H, D]``).  A row with no key to attend has l = 0."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) / math.sqrt(d)
    m4 = mask[None, :, None, :]
    s = torch.where(m4, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(m4, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return m, p.sum(dim=-1), torch.einsum("bqhk,bkhd->bqhd", p, v.float())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Plain single-device attention over [B, S, H, D] (the JAX
    `ring_attention.attention`), with f32 scores and sums."""
    sq, sk = q.shape[1], k.shape[1]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril()
    _, lsum, o = _block_attn(q, k, v, mask)
    return (o / lsum.clamp_min(1e-30)[..., None]).to(q.dtype)


def _local_blocks(q, k, v, axis_name: str, program: Optional[Program]):
    """This process's q, k and v blocks as lists in `program.local`
    order; ValueError unless `program` is given, the three dicts hold
    the same shards and the blocks share one shape."""
    if program is None:
        raise ValueError(f"a ring over {axis_name!r} needs the program of "
                         f"its mesh (program=)")
    keys = program.local
    if not (set(q) == set(k) == set(v) == set(keys)):
        raise ValueError(f"ring blocks: q on shards {sorted(q)}, k on "
                         f"{sorted(k)}, v on {sorted(v)}; need the same "
                         f"number, on the program's local shards {keys}")
    q, k, v = ([t[s] for s in keys] for t in (q, k, v))
    shapes = {tuple(t.shape) for t in (*q, *k, *v)}
    if len(shapes) > 1:
        raise ValueError(f"ring blocks must share one shape [B, S_local, H, "
                         f"D], got {sorted(shapes)}")
    return keys, q, k, v


def ring_attention(q, k, v, axis_name: Optional[str], causal: bool = True,
                   program: Optional[Program] = None):
    """Attention with the sequence cut over `axis_name`: q, k and v are
    dicts of the ring's local blocks ``[B, S_local, H, D]`` over
    `program`'s shards; returns the output blocks alike.
    ``axis_name=None``: single tensors through `attention`.
    Differentiated by autograd (`Program.ppermute` for the hops)."""
    if axis_name is None:
        return attention(q, k, v, causal)
    keys, q, k, v = _local_blocks(q, k, v, axis_name, program)
    n = program.mesh.shape.get(axis_name, 1)
    pos = [program.mesh.coord(s, axis_name) for s in keys]
    devices = [t.device for t in q]
    b, s_local, h, dh = q[0].shape if q else (0, 0, 0, 0)
    m = [torch.full((b, s_local, h), NEG_INF, device=d) for d in devices]
    lsum = [torch.zeros((b, s_local, h), device=d) for d in devices]
    o = [torch.zeros((b, s_local, h, dh), device=d) for d in devices]
    ks, vs = list(k), list(v)
    idx = torch.arange(s_local)
    for r in range(n):
        for i in range(len(q)):
            kv = (pos[i] - r) % n
            if causal:
                mask = ((pos[i] * s_local + idx)[:, None]
                        >= (kv * s_local + idx)[None, :])
            else:
                mask = torch.ones(s_local, s_local, dtype=torch.bool)
            bm, bl, bo = _block_attn(q[i], ks[i], vs[i],
                                     mask.to(devices[i]))
            new_m = torch.maximum(m[i], bm)
            scale_old = torch.exp(m[i] - new_m)
            scale_new = torch.exp(bm - new_m)
            lsum[i] = lsum[i] * scale_old + bl * scale_new
            o[i] = o[i] * scale_old[..., None] + bo * scale_new[..., None]
            m[i] = new_m
        if r == n - 1:
            break
        ks = list(program.ppermute(dict(zip(keys, ks)), axis_name).values())
        vs = list(program.ppermute(dict(zip(keys, vs)), axis_name).values())
    out = [(oi / li.clamp_min(1e-30)[..., None]).to(qi.dtype)
           for oi, li, qi in zip(o, lsum, q)]
    return dict(zip(keys, out))


def _ring_cases(causal: bool, my_idx: int, kv_idx: int) -> int:
    """0 = fully masked (skip), 1 = diagonal (causal mask), 2 = full."""
    if not causal:
        return 2
    return (my_idx > kv_idx) - (my_idx < kv_idx) + 1


def _unfold_rows(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """``[B*H, S]`` row statistics -> ``[B, S, H, 1]``, to weight outputs."""
    return x.reshape(b, h, -1).permute(0, 2, 1)[..., None]


def _ring_flash_forward(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                        v: Sequence[torch.Tensor], causal: bool, ring):
    """The forward ring: (outputs in q's dtype, global lse ``[B*H,
    S_local]`` float32) a local block.  At step r the block at position p
    holds key / value block ``(p - r) mod n``."""
    n = ring.n
    o = [torch.zeros_like(t) for t in q]
    lse = [torch.full((t.shape[0] * t.shape[2], t.shape[1]), NEG_INF,
                      dtype=torch.float32, device=t.device) for t in q]
    ks, vs = list(k), list(v)
    for r in range(n):
        for i, p in enumerate(ring.pos):
            case = _ring_cases(causal, p, (p - r) % n)
            if case == 0:
                continue
            b, _, h, _ = q[i].shape
            bo, blse = flash_forward(q[i], ks[i], vs[i], case == 1)
            # lse-weighted combine of normalised block outputs; the
            # weights are exponentials of non-positive numbers
            new_lse = torch.logaddexp(lse[i], blse)
            w_old = _unfold_rows(torch.exp(lse[i] - new_lse), b, h)
            w_new = _unfold_rows(torch.exp(blse - new_lse), b, h)
            o[i] = (o[i].float() * w_old + bo.float() * w_new).to(q[i].dtype)
            lse[i] = new_lse
        if r < n - 1:
            ks, vs = ring.hop(ks, vs)
    return o, lse


def _ring_flash_backward(q, k, v, o, lse, g, causal: bool, ring):
    """The second ring pass: (dq, dk, dv) lists, each local block's pairs
    through `flash_bwd_block` with the global lse and delta; dq, dk and
    dv accumulate in float32."""
    n = ring.n
    delta = [row_delta(gi, oi) for gi, oi in zip(g, o)]
    dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
          for t in q]
    dk = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
          for t in k]
    dv = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
          for t in v]
    ks, vs = list(k), list(v)
    for r in range(n):
        for i, p in enumerate(ring.pos):
            case = _ring_cases(causal, p, (p - r) % n)
            if case == 0:
                continue
            dqc, dkc, dvc = flash_bwd_block(q[i], ks[i], vs[i], g[i],
                                            lse[i], delta[i], case == 1)
            dq[i] = dq[i] + dqc.float()
            dk[i] = dk[i] + dkc.float()
            dv[i] = dv[i] + dvc.float()
        # dK / dV ride with their block: after the full circle each block
        # carries every shard's contribution and is back home
        if r < n - 1:
            ks, vs, dk, dv = ring.hop(ks, vs, dk, dv)
        else:
            dk, dv = ring.hop(dk, dv)
    return ([a.to(t.dtype) for a, t in zip(dq, q)],
            [a.to(t.dtype) for a, t in zip(dk, k)],
            [a.to(t.dtype) for a, t in zip(dv, v)])


class _RingFlash(torch.autograd.Function):
    """The flash ring; its `Program`'s ordering token goes in and a new
    one comes out."""

    @staticmethod
    def forward(ctx, causal, ring, token, *qkv):
        n = len(qkv) // 3
        qkv = [t.contiguous() for t in qkv]
        q, k, v = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        o, lse = _ring_flash_forward(q, k, v, causal, ring)
        ctx.save_for_backward(*q, *k, *v, *o, *lse)
        ctx.causal, ctx.ring, ctx.n = causal, ring, n
        return (token.new_zeros(()), *o)

    @staticmethod
    def backward(ctx, _token, *g):
        n = ctx.n
        saved = ctx.saved_tensors
        q, k, v, o, lse = (saved[i * n:(i + 1) * n] for i in range(5))
        g = [gi.contiguous() for gi in g]
        dq, dk, dv = _ring_flash_backward(q, k, v, o, lse, g, ctx.causal,
                                          ctx.ring)
        return (None, None, None, *dq, *dk, *dv)


def ring_flash_attention(q, k, v, axis_name: Optional[str],
                         causal: bool = True,
                         program: Optional[Program] = None):
    """Ring attention with the flash kernels as the inner block and the
    distributed flash backward.  q, k and v are dicts of the ring's
    local blocks ``[B, S_local, H, D]`` over `program`'s shards (every
    ring along the axis at once, across processes); returns the output
    blocks alike.  ``axis_name=None``: single tensors through the
    single-device `flash_attention`."""
    if axis_name is None:
        return flash_attention(q, k, v, causal)
    keys, q, k, v = _local_blocks(q, k, v, axis_name, program)
    out = _RingFlash.apply(bool(causal), _ProgramRing(program, axis_name),
                           program.token(), *q, *k, *v)
    program.advance(out[0])
    return dict(zip(keys, out[1:]))


__all__ = ["NEG_INF", "attention", "ring_attention", "ring_flash_attention"]
