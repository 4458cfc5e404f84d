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
Hopper kernel of ``csrc/lstm.cu`` (one cooperative launch per call,
counted in ``fused_lstm_forward.launches``, and those that save the
residuals also in ``fused_lstm_forward.residual_launches``) or an error;
on a CPU tensor its plain PyTorch version `fused_lstm_forward_plain`.
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
import threading
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.parallel.kernels import LaunchCounter

# The largest hidden size the kernel's shared-memory plan is held to
# (csrc/lstm.cu: a block keeps its [4u, H] slice of RW in shared memory).
MAX_HIDDEN = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
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
            lib.dl4j_lstm_plan.argtypes = [ci, ci, ctypes.POINTER(ll)]
            lib.dl4j_lstm_plan.restype = ci
            lib.dl4j_lstm_error_string.argtypes = [ci]
            lib.dl4j_lstm_error_string.restype = ctypes.c_char_p
            _lib_handle = lib
        return _lib_handle


def launch_plan(b: int, h: int) -> dict:
    """How the kernel splits a ``[B, H]`` problem on the current card:
    hidden units per block, blocks, batch rows per staging pass, lanes
    per (row, unit) pair and shared-memory bytes per block."""
    out = (ctypes.c_longlong * 5)()
    err = _lib().dl4j_lstm_plan(b, h, out)
    plan = dict(zip(("units", "blocks", "rows", "group", "smem_bytes"),
                    (int(v) for v in out)))
    plan["error"] = err
    return plan


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
                        f"takes float32 or bfloat16")
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
    kernel (float32 or bfloat16, H <= `MAX_HIDDEN`) or raise.  hs comes
    back in xz's layout: batch-major storage for a transposed
    batch-major xz."""
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
    hbuf = torch.empty((2, b, h), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dl4j_lstm_forward(
            xz.data_ptr(), rw.data_ptr(), pi.data_ptr(), pf.data_ptr(),
            po.data_ptr(), hs.data_ptr(),
            None if cs is None else cs.data_ptr(),
            None if zs is None else zs.data_ptr(), hbuf.data_ptr(),
            t_len, b, h, xz.stride(0), xz.stride(1), hs.stride(0),
            hs.stride(1), _DTYPE_CODES[xz.dtype], stream)
    if err != 0:
        plan = launch_plan(b, h)
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
           "lstm_backward"]
