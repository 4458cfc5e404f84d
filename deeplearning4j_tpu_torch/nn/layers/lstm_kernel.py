"""Fused LSTM scan: the whole time loop of a layer in one kernel launch
(counterpart of `deeplearning4j_tpu.nn.layers.lstm_kernel`).

`fused_lstm_scan(xz, rw, pi, pf, po)` runs the peephole LSTM over time:
``xz [T, B, 4H]`` is the input projection plus bias (time-major; any
strides with a unit last stride, so a ``transpose(0, 1)`` view of a
batch-major ``[B, T, 4H]`` tensor goes in without a copy), ``rw [H,
4H]``, ``pi/pf/po [H]`` (zeros for a vanilla LSTM); gate order ``[i, f,
o, g]``, cell activation tanh, the ``(h, c)`` carry in f32.  It returns
``hs [T, B, H]`` in xz's dtype.

Its forward is `fused_lstm_forward`: on a CUDA tensor the hand-written
Hopper kernel of ``csrc/lstm.cu`` or an error; on a CPU tensor its plain
PyTorch version `fused_lstm_forward_plain`.  The kernel has two routes
(`lstm_route_rule`, which `launch_plan` reports as the C entry plans
them): the cluster route, a thread-block cluster of up to 16 CTAs per
16 batch rows with RW resident in shared memory, h exchanged through
distributed shared memory and the products on the tensor cores (bf16
and f16 up to H = 512, f32 up to H = 384 on an H100); and the wide route, the
units over all SMs with a grid barrier a step, in cooperative launches
over batch slices that fit (the rest, up to `MAX_HIDDEN`).  Either way a
call counts one launch in ``fused_lstm_forward.launches`` (and, when it
saves the residuals, in ``fused_lstm_forward.residual_launches``).
With residuals it also returns the f32 cell states ``cs [T, B, H]`` and
the f32 gate pre-activations before the peephole terms, ``zs [T, B,
4H]``.  The inference forward writes hs only.

The backward is not a kernel in the JAX package either: `lstm_backward`
is `_bwd`'s reverse-time BPTT in torch ops, line by line with its
rounding (``h_{t-1}`` from hs cast to f32, so the rounded output and not
the f32 carry; ``dc`` includes ``dzo * po``; dxz in hs's dtype, the
weight gradients in their parameters' dtypes).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.parallel.kernels import LaunchCounter

# The largest hidden size the kernel's shared-memory plan is held to
# (csrc/lstm.cu: a block of the wide route keeps its [4u, H] f32 slice of
# RW in shared memory).
MAX_HIDDEN = 1024
# What csrc/lstm.cu's plan reads of an H100: SMs and the opt-in shared
# memory of a block; the cluster route's batch tile and largest cluster.
H100_SMS = 132
H100_SMEM_OPTIN = 232448
TILE_ROWS = 16
MAX_CLUSTER = 16
_PLAN_KEYS = ("route", "cluster", "units", "blocks", "threads", "smem_bytes",
              "batch_tile", "launches", "rows", "group", "k_parts",
              "active_clusters")
_ROUTES = ("cluster", "wide")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None

Residuals = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def _lib() -> ctypes.CDLL:
    """The LSTM library, built and bound on first use."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            from deeplearning4j_tpu_torch import _build

            lib = _build.load("lstm")
            vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.dl4j_lstm_forward.argtypes = ([vp] * 9 + [ci] * 3 + [ll] * 4
                                              + [ci, vp])
            lib.dl4j_lstm_forward.restype = ci
            lib.dl4j_lstm_plan.argtypes = [ci, ci, ci, ctypes.POINTER(ll)]
            lib.dl4j_lstm_plan.restype = ci
            lib.dl4j_lstm_error_string.argtypes = [ci]
            lib.dl4j_lstm_error_string.restype = ctypes.c_char_p
            _lib_handle = lib
        return _lib_handle


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def lstm_route_rule(dtype: torch.dtype, b: int, h: int,
                    n_sm: int = H100_SMS,
                    smem_optin: int = H100_SMEM_OPTIN) -> dict:
    """The plan of ``csrc/lstm.cu`` (`make_plan`) for a ``[B, H]``
    problem in `dtype`, mirrored in Python for a card of `n_sm` SMs and
    `smem_optin` bytes of shared memory a block: the keys of
    `launch_plan` but ``active_clusters``.

    Cluster route when a CTA's shared memory holds its RW slice ``[H,
    4u]`` (in `dtype`, rows padded), the h double buffer ``[2, 16, H]``
    f32 and the k-split partials (float16 plans as bfloat16 does: both
    are 2-byte elements): u = roundup(ceil(H / 16), 8) units a CTA, the cluster the next power of two of ceil(H / u) CTAs, one
    cluster a 16-row batch tile.  Else the wide route: u = ceil(H /
    SMs) units a block over ceil(H / u) blocks, c of the launch's rows
    in shared memory, so a batch whose c does not fit is cut into the
    fewest equal slices that do (one cooperative launch each)."""
    es = dtype.itemsize
    plan = dict.fromkeys(_PLAN_KEYS, 0)
    u = _round_up(-(-h // MAX_CLUSTER), 8)
    n = 1
    while n < -(-h // u):
        n *= 2
    tasks = u // 8
    k_parts = min(max(1, 8 // tasks), -(-h // 16))
    hs = _round_up(h, 32) + (8 if es == 2 else 4)
    rs = _round_up(h, 64) + 8 if es == 2 else _round_up(h, 32) + 4
    smem = (2 * TILE_ROWS * hs * 4 + (k_parts - 1) * tasks * 512 * 4
            + 4 * u * rs * es)
    if smem <= smem_optin and tasks <= 8:
        plan.update(route="cluster", cluster=n, units=u,
                    blocks=n * -(-b // TILE_ROWS),
                    threads=32 * tasks * k_parts, smem_bytes=smem,
                    batch_tile=TILE_ROWS, launches=1, k_parts=k_parts)
        return plan
    u = -(-h // n_sm)

    def floats(rows_b, rows):
        return 4 * u * h + rows * (h + 4) + rows_b * u

    def staging_rows(rows_b):
        rows = min(rows_b, 32)
        while floats(rows_b, rows) * 4 > smem_optin and rows > 1:
            rows = -(-rows // 2)
        return rows if floats(rows_b, rows) * 4 <= smem_optin else 0

    bs, launches = b, 1
    rows = staging_rows(b)
    if rows == 0:
        bmax = (smem_optin // 4 - 4 * u * h - 16 * (h + 4)) // u
        launches = -(-b // bmax)
        bs = -(-b // launches)
        rows = staging_rows(bs)
    group = 32
    while group > 1 and 256 // group < rows * u:
        group //= 2
    plan.update(route="wide", units=u, blocks=-(-h // u), threads=256,
                smem_bytes=floats(bs, rows) * 4, batch_tile=bs,
                launches=launches, rows=rows, group=group)
    return plan


def launch_plan(dtype: torch.dtype, b: int, h: int) -> dict:
    """How the kernel takes a ``[B, H]`` problem in `dtype` on the
    current card, as the C entry plans it: the route (``"cluster"`` or
    ``"wide"``), the cluster size, hidden units a block, blocks and
    threads a launch, shared-memory bytes a block, batch rows a cluster
    (cluster route) or a launch (wide route), launches a call, staging
    rows and lanes a pair (wide), k-parts and the clusters the card holds
    at once (cluster), and the entry's error code (0 when it fits)."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    err = _lib().dl4j_lstm_plan(b, h, _DTYPE_CODES[dtype], out)
    plan = dict(zip(_PLAN_KEYS, (int(v) for v in out)))
    plan["route"] = _ROUTES[plan["route"]]
    plan["error"] = err
    return plan


@functools.lru_cache(maxsize=256)
def _device_plan(dtype: torch.dtype, b: int, h: int,
                 device_index: int) -> dict:
    """`launch_plan` on card `device_index`, once per shape."""
    with torch.cuda.device(device_index):
        return launch_plan(dtype, b, h)


def _check_cuda(xz, rw, pi, pf, po) -> None:
    """Device, dtype, shape and layout checks before a launch."""
    if xz.dim() != 3 or xz.shape[-1] % 4:
        raise ValueError(f"xz must be [T, B, 4H], got {tuple(xz.shape)}")
    t, b, four_h = xz.shape
    h = four_h // 4
    if t < 1 or b < 1 or h < 1:
        raise ValueError(f"xz has an empty axis: {tuple(xz.shape)}")
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden size {h} exceeds the kernel's limit of "
                         f"{MAX_HIDDEN} (its [4u, H] slice of RW must fit "
                         f"a block's shared memory)")
    if xz.dtype not in _DTYPE_CODES:
        raise TypeError(f"xz dtype {xz.dtype} unsupported: the kernel "
                        f"takes float32, bfloat16 or float16")
    if xz.stride(-1) != 1:
        raise ValueError("xz must have a unit stride on its last axis")
    for name, p, shape in (("rw", rw, (h, four_h)), ("pi", pi, (h,)),
                           ("pf", pf, (h,)), ("po", po, (h,))):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(p.shape)}, needs "
                             f"{shape} for xz {tuple(xz.shape)}")
        if p.dtype != xz.dtype:
            raise TypeError(f"{name} dtype {p.dtype} must equal xz's "
                            f"{xz.dtype}")
        if p.device != xz.device:
            raise ValueError(f"{name} is on {p.device}, xz on {xz.device}")
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_lstm_forward_plain(xz: torch.Tensor, rw: torch.Tensor,
                             pi: torch.Tensor, pf: torch.Tensor,
                             po: torch.Tensor, save_residuals: bool = False
                             ) -> Residuals:
    """The plain version of `fused_lstm_forward` (the JAX `_forward`):
    one step at a time with the f32 carry; hs in xz's dtype, and with
    `save_residuals` the f32 cs and zs."""
    t_len, b, four_h = xz.shape
    n = four_h // 4
    f32 = torch.float32
    h = torch.zeros((b, n), dtype=f32, device=xz.device)
    c = torch.zeros((b, n), dtype=f32, device=xz.device)
    rw_f = rw.to(f32)
    pi_f, pf_f, po_f = (p.to(f32) for p in (pi, pf, po))
    hs, cs, zs = [], [], []
    for t in range(t_len):
        z = xz[t].to(f32) + h @ rw_f
        zi, zf, zo, zg = (z[:, :n], z[:, n:2 * n], z[:, 2 * n:3 * n],
                          z[:, 3 * n:])
        i = torch.sigmoid(zi + c * pi_f)
        f = torch.sigmoid(zf + c * pf_f)
        g = torch.tanh(zg)
        c = f * c + i * g
        o = torch.sigmoid(zo + c * po_f)
        h = o * torch.tanh(c)
        hs.append(h.to(xz.dtype))
        if save_residuals:
            zs.append(z)
            cs.append(c)
    if not save_residuals:
        return torch.stack(hs), None, None
    return torch.stack(hs), torch.stack(cs), torch.stack(zs)


def fused_lstm_forward(xz: torch.Tensor, rw: torch.Tensor, pi: torch.Tensor,
                       pf: torch.Tensor, po: torch.Tensor,
                       save_residuals: bool = False) -> Residuals:
    """hs ``[T, B, H]`` (xz's dtype), and with `save_residuals` the f32
    cs ``[T, B, H]`` and zs ``[T, B, 4H]`` (else None, None).

    CPU tensors run `fused_lstm_forward_plain`; CUDA tensors launch the
    kernel (float32, bfloat16 or float16, H <= `MAX_HIDDEN`, any B) on
    the route `launch_plan` names, or raise.  hs comes back in xz's layout:
    batch-major storage for a transposed batch-major xz."""
    if xz.device.type == "cpu":
        return fused_lstm_forward_plain(xz, rw, pi, pf, po, save_residuals)
    if xz.device.type != "cuda":
        raise ValueError(f"fused_lstm_forward runs on cuda (kernel) or cpu "
                         f"(plain version), not {xz.device}")
    _check_cuda(xz, rw, pi, pf, po)
    t_len, b, four_h = xz.shape
    h = four_h // 4
    dev = xz.device
    if xz.stride(1) > xz.stride(0):        # batch-major storage
        hs = torch.empty((b, t_len, h), dtype=xz.dtype,
                         device=dev).transpose(0, 1)
    else:
        hs = torch.empty((t_len, b, h), dtype=xz.dtype, device=dev)
    cs = zs = None
    if save_residuals:
        cs = torch.empty((t_len, b, h), dtype=torch.float32, device=dev)
        zs = torch.empty((t_len, b, four_h), dtype=torch.float32, device=dev)
    plan = _device_plan(xz.dtype, b, h, dev.index if dev.index is not None
                        else torch.cuda.current_device())
    lib = _lib()
    if plan["error"] != 0:
        raise RuntimeError(
            f"LSTM kernel has no route for [T, B, H] = {[t_len, b, h]}: "
            f"{lib.dl4j_lstm_error_string(plan['error']).decode()} (plan "
            f"{plan})")
    hbuf = (torch.empty((2, plan["batch_tile"], h), dtype=torch.float32,
                        device=dev) if plan["route"] == "wide" else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dl4j_lstm_forward(
            xz.data_ptr(), rw.data_ptr(), pi.data_ptr(), pf.data_ptr(),
            po.data_ptr(), hs.data_ptr(),
            None if cs is None else cs.data_ptr(),
            None if zs is None else zs.data_ptr(),
            None if hbuf is None else hbuf.data_ptr(),
            t_len, b, h, xz.stride(0), xz.stride(1), hs.stride(0),
            hs.stride(1), _DTYPE_CODES[xz.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"LSTM kernel launch failed: "
            f"{lib.dl4j_lstm_error_string(err).decode()} (error {err}; "
            f"[T, B, H] = {[t_len, b, h]}, plan {plan})")
    fused_lstm_forward.launches.add()
    if save_residuals:
        fused_lstm_forward.residual_launches.add()
    return hs, cs, zs


fused_lstm_forward.launches = LaunchCounter()
fused_lstm_forward.residual_launches = LaunchCounter()


def lstm_backward(hs: torch.Tensor, cs: torch.Tensor, zs: torch.Tensor,
                  rw: torch.Tensor, pi: torch.Tensor, pf: torch.Tensor,
                  po: torch.Tensor, dhs: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """Reverse-time BPTT over the forward's residuals (the JAX `_bwd`):
    (dxz in hs's dtype, drw, dpi, dpf, dpo in their parameters'
    dtypes)."""
    t_len, b, n = hs.shape
    f32 = torch.float32
    dhs = dhs.to(f32)
    hs_f = hs.to(f32)
    zeros_bn = torch.zeros((b, n), dtype=f32, device=hs.device)
    rw_f = rw.to(f32)
    pi_f, pf_f, po_f = (p.to(f32) for p in (pi, pf, po))
    dh_next, dc_next = zeros_bn, zeros_bn
    drw = torch.zeros_like(rw_f)
    dpi = torch.zeros((n,), dtype=f32, device=hs.device)
    dpf = torch.zeros_like(dpi)
    dpo = torch.zeros_like(dpi)
    dzs = [None] * t_len
    for t in reversed(range(t_len)):
        z, c_t = zs[t], cs[t]
        # previous-step states (h_{-1} = c_{-1} = 0)
        c_prev = cs[t - 1] if t else zeros_bn
        h_prev = hs_f[t - 1] if t else zeros_bn
        zi, zf, zo, zg = (z[:, :n], z[:, n:2 * n], z[:, 2 * n:3 * n],
                          z[:, 3 * n:])
        i = torch.sigmoid(zi + c_prev * pi_f)
        f = torch.sigmoid(zf + c_prev * pf_f)
        g = torch.tanh(zg)
        o = torch.sigmoid(zo + c_t * po_f)
        tc = torch.tanh(c_t)
        dh = dhs[t] + dh_next
        do = dh * tc
        dzo = do * o * (1 - o)
        dc = dh * o * (1 - tc * tc) + dc_next + dzo * po_f
        di = dc * g
        dzi = di * i * (1 - i)
        df = dc * c_prev
        dzf = df * f * (1 - f)
        dg = dc * i
        dzg = dg * (1 - g * g)
        dz = torch.cat([dzi, dzf, dzo, dzg], dim=-1)          # [B, 4H]
        dh_next = dz @ rw_f.T
        drw = drw + h_prev.T @ dz
        dpi = dpi + torch.sum(dzi * c_prev, dim=0)
        dpf = dpf + torch.sum(dzf * c_prev, dim=0)
        dpo = dpo + torch.sum(dzo * c_t, dim=0)
        dc_next = dc * f + dzi * pi_f + dzf * pf_f
        dzs[t] = dz
    return (torch.stack(dzs).to(hs.dtype), drw.to(rw.dtype),
            dpi.to(pi.dtype), dpf.to(pf.dtype), dpo.to(po.dtype))


class _FusedLSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xz, rw, pi, pf, po):
        hs, cs, zs = fused_lstm_forward(xz, rw, pi, pf, po,
                                        save_residuals=True)
        ctx.save_for_backward(hs, cs, zs, rw, pi, pf, po)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        return lstm_backward(*ctx.saved_tensors, dhs)


def fused_lstm_scan(xz: torch.Tensor, rw: torch.Tensor, pi: torch.Tensor,
                    pf: torch.Tensor, po: torch.Tensor) -> torch.Tensor:
    """Fused LSTM over time: ``xz [T, B, 4H]`` -> ``hs [T, B, H]``,
    differentiable in every input.  Under autograd the forward saves the
    residuals; without it (inference, ``torch.no_grad()``) it writes hs
    only.  Either way one forward launch per call."""
    tracked = torch.is_grad_enabled() and any(
        a.requires_grad for a in (xz, rw, pi, pf, po))
    if tracked:
        return _FusedLSTMScan.apply(xz, rw, pi, pf, po)
    return fused_lstm_forward(xz, rw, pi, pf, po)[0]


def fused_lstm_scan_plain(xz: torch.Tensor, rw: torch.Tensor,
                          pi: torch.Tensor, pf: torch.Tensor,
                          po: torch.Tensor) -> torch.Tensor:
    """`fused_lstm_scan` with the plain forward on any device: autograd
    differentiates the plain steps directly (the yardstick the kernel's
    gradients are held against on the card)."""
    return fused_lstm_forward_plain(xz, rw, pi, pf, po)[0]


__all__ = ["MAX_HIDDEN", "fused_lstm_forward", "fused_lstm_forward_plain",
           "fused_lstm_scan", "fused_lstm_scan_plain", "launch_plan",
           "lstm_backward", "lstm_route_rule"]
