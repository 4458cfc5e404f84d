"""Flash attention and shared kernel helpers (counterpart of
`deeplearning4j_tpu.parallel.kernels`).

`flash_attention(q, k, v, causal)` is fused attention over ``[B, S, H,
D]`` as a `torch.autograd.Function`: its forward is `flash_forward`
(out and the per-row logsumexp), its backward the FlashAttention-2
scheme of `flash_bwd_block`, which recomputes ``P = exp(S * scale -
lse)`` tile by tile and so keeps training memory O(S).  On a CUDA tensor
each wrapper launches its hand-written Hopper kernel from
``csrc/flash_attention.cu`` (built with ``nvcc`` on first use) or raises;
on a CPU tensor it runs its plain PyTorch version (`flash_forward_plain`,
`flash_bwd_block_plain`).  There is no switch: on the card the kernels
always run.

Row statistics (lse, delta) are ``[B*H, S]`` float32 with rows ordered
``b * H + h``; lse is ``m + log(l)`` of the scaled f32 scores with ``l``
clamped at 1e-30.  The backward takes lse and delta from outside, so a
caller holding global statistics (ring attention) can pass them.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

# Score mask of the flash kernels (the JAX module's NEG_INF).
NEG_INF = -1e30
# The widest head dim of the CUDA entries (csrc/flash_attention.cu kMaxD);
# the widest the FMA route takes whole (above it the D-chunked route cuts
# the outputs into 128-column chunks); the widest each entry takes on the
# tensor cores.
MAX_HEAD_DIM = 512
CHUNK_HEAD_DIM = 128
MAX_MMA_HEAD_DIM = {"fwd": 256, "dkv": 128, "dq": 128}
# route names, in the C entries' codes
_ROUTES = ("fma", "tensor_cores", "fma_chunks")


def mask_value(dtype: torch.dtype) -> float:
    """Finite large-negative mask constant for `dtype` softmax scores.

    ``finfo.min / 2`` is representable in every float dtype (a hardcoded
    ``-1e30`` overflows to ``-inf`` in fp16 and turns a fully masked row
    into NaN) and still underflows to exactly 0 through
    ``exp(s - max)``."""
    return float(torch.finfo(dtype).min) / 2


_capture = threading.local()


@contextlib.contextmanager
def counting_into(tally: dict):
    """While a program is captured into a CUDA graph on this thread, the
    launch counters add to `tally` (``{(counter, key): n}``) and not to
    their counts: a capture executes nothing, and each replay of the
    graph adds the tally (`runtime.programs.Program`)."""
    prev = getattr(_capture, "tally", None)
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = prev


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one per kernel launch,
    under an optional key (the paged wrapper keys its launches by query
    width), read back as a total (`value`) and per key (`by_key`).  A
    launch recorded into a CUDA graph counts at each replay
    (`counting_into`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._keys: dict = {}

    def add(self, n: int = 1, key=None) -> None:
        tally = getattr(_capture, "tally", None)
        if tally is not None:
            tally[(self, key)] = tally.get((self, key), 0) + n
            return
        with self._lock:
            self._n += n
            if key is not None:
                self._keys[key] = self._keys.get(key, 0) + n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._keys = {}

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def by_key(self) -> dict:
        with self._lock:
            return dict(self._keys)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The flash-attention library, built and bound on first use."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            from deeplearning4j_tpu_torch import _build

            lib = _build.load("flash_attention")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.dl4j_flash_fwd.argtypes = [vp] * 5 + [ci] * 6 + [vp]
            lib.dl4j_flash_bwd_dkv.argtypes = [vp] * 8 + [ci] * 6 + [vp]
            lib.dl4j_flash_bwd_dq.argtypes = [vp] * 7 + [ci] * 6 + [vp]
            for fn in (lib.dl4j_flash_fwd, lib.dl4j_flash_bwd_dkv,
                       lib.dl4j_flash_bwd_dq):
                fn.restype = ci
            lib.dl4j_flash_route.argtypes = [ci] + [vp] * 6 + [ci, ci]
            lib.dl4j_flash_route.restype = ci
            lib.dl4j_flash_smem_bytes.argtypes = [ci, ci, ci]
            lib.dl4j_flash_smem_bytes.restype = ctypes.c_size_t
            lib.dl4j_flash_error_string.argtypes = [ci]
            lib.dl4j_flash_error_string.restype = ctypes.c_char_p
            _lib_handle = lib
        return _lib_handle


# flash_route kinds -> the C entries' kernel codes
_KINDS = {"fwd": 0, "dkv": 1, "dq": 2}


def _raise_on(err: int, kind: str, what: str, tensors) -> None:
    """Raise RuntimeError for a failed launch of `kind` on `tensors` (q,
    k, v, then the entry's other bf16/f32 tensors as `flash_route` takes
    them), naming the route and the shared memory of the kernel that was
    refused."""
    if err != 0:
        lib = _lib()
        shape = tensors[0].shape
        route = flash_route(kind, *tensors)
        smem = lib.dl4j_flash_smem_bytes(_KINDS[kind], shape[-1],
                                         _ROUTES.index(route))
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.dl4j_flash_error_string(err).decode()} (error {err}; "
            f"[B, S, H, D] = {list(shape)} on the {route} route needs "
            f"{smem} bytes of shared memory per block)")


def _check_cuda(name_tensors, stats=()) -> None:
    """Device, dtype, shape and contiguity checks before a launch."""
    q = name_tensors[0][1]
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} unsupported: the kernels take "
                        f"float32, bfloat16 or float16")
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} outside 1..{MAX_HEAD_DIM}")
    b, s, h, _ = q.shape
    for name, t in name_tensors:
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} must equal q's "
                            f"{q.dtype}")
    for name, t in stats:
        if tuple(t.shape) != (b * h, s) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B*H={b * h}, S={s}]"
                             f", got {t.dtype} {tuple(t.shape)}")
    for name, t in (*name_tensors, *stats):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            pre_scale: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f32 scaled scores ``[B, H, Sq, Sk]`` with masked entries at
    NEG_INF, and the boolean mask (None when nothing is masked).  The
    forward scales q before the product, the backward the product (the
    TPU kernels' order)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf = q.float(), k.float()
    if pre_scale:
        s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if not causal:
        return s, None
    mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                      device=q.device).tril()
    return s.masked_fill(~mask, NEG_INF), mask


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `flash_forward`: the whole score matrix in
    f32, the same masking, normaliser clamp and lse as the kernel."""
    b, s, h, _ = q.shape
    sc, mask = _scores(q, k, causal, pre_scale=True)
    m = sc.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(sc - m)
    if mask is not None:
        p = p * mask
    l = p.sum(dim=-1).clamp_min(1e-30)                       # [B, H, S]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / l.permute(0, 2, 1)[..., None]
    lse = (m[..., 0] + torch.log(l)).reshape(b * h, s)
    return o.to(q.dtype), lse


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: q, k, v ``[B, S, H, D]`` (float32,
    bfloat16 or float16, D <= `MAX_HEAD_DIM`) -> (out ``[B, S, H, D]`` in q's dtype,
    lse ``[B*H, S]`` float32).

    CPU tensors run `flash_forward_plain`; CUDA tensors launch the
    kernel (counted in ``flash_forward.launches``) or raise."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on cuda (kernel) or cpu "
                         f"(plain version), not {q.device}")
    _check_cuda((("q", q), ("k", k), ("v", v)))
    b, s, h, d = q.shape
    lib = _lib()
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), lse.data_ptr(), b, s, h, d,
                                 int(causal), _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "fwd", "flash forward", (q, k, v, out))
    flash_forward.launches.add()
    return out, lse


flash_forward.launches = LaunchCounter()


def flash_route_rule(dtype: torch.dtype, head_dim: int, data_ptrs,
                     kind: str = "fwd") -> str:
    """The route rule of the CUDA entry of `kind`, mirrored in Python:
    ``"tensor_cores"`` (wgmma) for bfloat16 with a head dim that is a
    multiple of 8, up to `MAX_MMA_HEAD_DIM` of the entry (256 forward,
    128 backward), and every tensor the entry reads or writes (q, k, v,
    dO and the outputs; `data_ptrs`) on a 16-byte boundary; else
    ``"fma"`` up to `CHUNK_HEAD_DIM` and ``"fma_chunks"`` (the FMA
    kernels over 128-column chunks of the outputs, one block a chunk)
    above it.  float32 and float16 always take the FMA routes.
    `flash_route` asks the C entries themselves."""
    aligned = all(p % 16 == 0 for p in data_ptrs)
    if (dtype == torch.bfloat16 and head_dim % 8 == 0 and aligned
            and head_dim <= MAX_MMA_HEAD_DIM[kind]):
        return "tensor_cores"
    return "fma_chunks" if head_dim > CHUNK_HEAD_DIM else "fma"


def flash_route(kind: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, *rest: torch.Tensor) -> str:
    """The route the CUDA entry of `kind` takes for these card tensors,
    as the entry reports it: ``"fwd"`` with `rest` = (out,), ``"dkv"``
    with (g, dk, dv), ``"dq"`` with (g, dq)."""
    want = {"fwd": 1, "dkv": 3, "dq": 2}[kind]
    if len(rest) != want:
        raise ValueError(f"flash_route({kind!r}) takes q, k, v and {want} "
                         f"more tensors, got {len(rest)}")
    ptrs = [t.data_ptr() for t in (q, k, v, *rest)]
    code = _lib().dl4j_flash_route(_KINDS[kind], *ptrs,
                                   *[None] * (6 - len(ptrs)), q.shape[-1],
                                   _DTYPE_CODES[q.dtype])
    return _ROUTES[code]


def _bwd_plain(q, k, v, g, lse, delta, causal, want):
    """dq, dk and dv (those named in `want`, else None) in f32 over the
    whole score matrix, with P recomputed from the given lse and
    ``dS = P * (dP - delta)``."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    sc, _ = _scores(q, k, causal, pre_scale=False)
    p = torch.exp(sc - lse.reshape(b, h, s, 1))
    gf = g.float()
    dv = (torch.einsum("bhqk,bqhd->bkhd", p, gf).to(v.dtype)
          if "dv" in want else None)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
    ds = p * (dp - delta.reshape(b, h, s, 1))
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).mul(scale)
          .to(k.dtype) if "dk" in want else None)
    dq = (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).mul(scale)
          .to(q.dtype) if "dq" in want else None)
    return dq, dk, dv


def flash_bwd_block_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          g: torch.Tensor, lse: torch.Tensor,
                          delta: torch.Tensor, causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The plain version of `flash_bwd_block`: P recomputed from the
    given lse, ``dS = P * (dP - delta)``, in f32 over the whole score
    matrix."""
    return _bwd_plain(q, k, v, g, lse, delta, causal, ("dq", "dk", "dv"))


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=True):
    """The plain version of `flash_bwd_dkv`: (dk, dv)."""
    return _bwd_plain(q, k, v, g, lse, delta, causal, ("dk", "dv"))[1:]


def flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=True):
    """The plain version of `flash_bwd_dq`: dq."""
    return _bwd_plain(q, k, v, g, lse, delta, causal, ("dq",))[0]


def _bwd_device_check(q, k, v, g, lse, delta, what: str) -> bool:
    """True for CPU tensors (the plain path); checks a CUDA launch."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain "
                         f"version), not {q.device}")
    _check_cuda((("q", q), ("k", k), ("v", v), ("g", g)),
                (("lse", lse), ("delta", delta)))
    return False


def _launch_dkv(q, k, v, g, lse, delta, causal):
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().dl4j_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, d, int(causal), _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "dkv", "flash backward dK/dV", (q, k, v, g, dk, dv))
    flash_bwd_dkv.launches.add()
    return dk, dv


def _launch_dq(q, k, v, g, lse, delta, causal):
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().dl4j_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h, d,
            int(causal), _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "dq", "flash backward dQ", (q, k, v, g, dq))
    flash_bwd_dq.launches.add()
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of one attention block: the dK/dV kernel on a CUDA tensor
    (counted in ``flash_bwd_dkv.launches``), the plain version on a CPU
    tensor."""
    if _bwd_device_check(q, k, v, g, lse, delta, "flash_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal)
    return _launch_dkv(q, k, v, g, lse, delta, causal)


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = True) -> torch.Tensor:
    """dq of one attention block: the dQ kernel on a CUDA tensor (counted
    in ``flash_bwd_dq.launches``), the plain version on a CPU tensor."""
    if _bwd_device_check(q, k, v, g, lse, delta, "flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, causal)
    return _launch_dq(q, k, v, g, lse, delta, causal)


def flash_bwd_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of one attention block given dO = `g` and the
    Q-side row stats lse and delta (``[B*H, S]`` float32).

    CPU tensors run `flash_bwd_block_plain`; CUDA tensors launch the dK/dV
    kernel, then the dQ kernel, or raise."""
    if _bwd_device_check(q, k, v, g, lse, delta, "flash_bwd_block"):
        return flash_bwd_block_plain(q, k, v, g, lse, delta, causal)
    dk, dv = _launch_dkv(q, k, v, g, lse, delta, causal)
    return _launch_dq(q, k, v, g, lse, delta, causal), dk, dv


flash_bwd_dkv.launches = LaunchCounter()
flash_bwd_dq.launches = LaunchCounter()


def row_delta(g: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32 as ``[B*H, S]`` (the softmax
    Jacobian's row correction, FlashAttention-2 eq. 4)."""
    b, s, h, _ = o.shape
    d = (g.float() * o.float()).sum(dim=-1)                  # [B, S, H]
    return d.permute(0, 2, 1).reshape(b * h, s).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        dq, dk, dv = flash_bwd_block(q, k, v, g, lse, row_delta(g, out),
                                     ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Fused attention ``[B, S, H, D] -> [B, S, H, D]`` with the
    FlashAttention-2 backward; differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal)


__all__ = ["LaunchCounter", "MAX_HEAD_DIM", "NEG_INF", "counting_into",
           "flash_attention", "flash_bwd_block", "flash_bwd_block_plain",
           "flash_bwd_dkv", "flash_bwd_dkv_plain", "flash_bwd_dq",
           "flash_bwd_dq_plain", "flash_forward", "flash_forward_plain",
           "flash_route", "flash_route_rule", "mask_value", "row_delta"]
