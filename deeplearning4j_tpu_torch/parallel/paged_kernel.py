"""Paged attention over a block-tabled K/V pool (counterpart of
`deeplearning4j_tpu.parallel.paged_kernel`).

`paged_flash_attention` walks each lane's block table and runs one online
softmax over the lane's live pages.  For a CUDA tensor it launches the
hand-written Hopper kernel in ``csrc/paged_attention.cu`` (built with
``nvcc`` on first use) or raises; for a CPU tensor it runs
`paged_flash_attention_plain`, the plain PyTorch version.  There is no
switch: on the card the kernel always runs.

Semantics (identical to the TPU kernel): query column ``c`` of lane ``b``
sits at position ``pos[b] + c`` and sees keys ``t <= pos[b] + c``; the
pools already hold this dispatch's own keys.  At every fed column
(``c < n_feed[b]``) kernel and plain version agree; padding columns
attend only through the lane's frontier page in the kernel and through
the full horizon in the plain version, and no caller reads them.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel.kernels import (
    LaunchCounter,
    mask_value,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            from deeplearning4j_tpu_torch import _build

            lib = _build.load("paged_attention")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.dl4j_paged_attention.argtypes = [vp] * 7 + [ci] * 8 + [vp]
            lib.dl4j_paged_attention.restype = ci
            lib.dl4j_paged_attention_smem_bytes.argtypes = [ci, ci]
            lib.dl4j_paged_attention_smem_bytes.restype = ctypes.c_size_t
            lib.dl4j_cuda_error_string.argtypes = [ci]
            lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
            _lib_handle = lib
        return _lib_handle


def paged_flash_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, table: torch.Tensor,
                                pos: torch.Tensor,
                                n_feed: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The plain version: gather each lane's whole logical history
    ``[B, MP*ps, H, K]`` through the block table and run a masked
    softmax over it in f32.  Returns ``[B, C, H, K]`` in q's dtype.
    (`n_feed` is accepted for signature parity; the plain version scores
    every column over its full ``pos + c`` horizon.)"""
    b, c, h, kd = q.shape
    pages, ps = k_pages.shape[0], k_pages.shape[1]
    mp = table.shape[1]
    dev = q.device
    table = table.to(device=dev, dtype=torch.long)
    pos = pos.to(device=dev, dtype=torch.long)
    gidx = (table[:, :, None] * ps
            + torch.arange(ps, device=dev)[None, None, :]).reshape(b, mp * ps)
    hk = k_pages.reshape(pages * ps, h, kd)[gidx].float()    # [B, S, H, K]
    hv = v_pages.reshape(pages * ps, h, kd)[gidx].float()
    s = torch.einsum("bqhk,bshk->bqhs", q.float(), hk) / math.sqrt(kd)
    wpos = pos[:, None] + torch.arange(c, device=dev)[None, :]   # [B, C]
    causal = (torch.arange(mp * ps, device=dev)[None, None, :]
              <= wpos[:, :, None])                           # [B, C, S]
    s = torch.where(causal[:, :, None, :], s,
                    torch.full_like(s, mask_value(torch.float32)))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqhs,bshk->bqhk", w, hv).to(q.dtype)


def _check_cuda_inputs(q, k_pages, v_pages, table, pos, n_feed) -> None:
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError(f"q must be [B, C, H, K] and the pools [P, ps, H, "
                         f"K]; got {tuple(q.shape)}, {tuple(k_pages.shape)},"
                         f" {tuple(v_pages.shape)}")
    b, c, h, kd = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (h, kd):
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q's heads "
                         f"and head dim ({h}, {kd})")
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"table must be [B={b}, MP], got "
                         f"{tuple(table.shape)}")
    if tuple(pos.shape) != (b,) or tuple(n_feed.shape) != (b,):
        raise ValueError(f"pos and n_feed must be [B={b}], got "
                         f"{tuple(pos.shape)} and {tuple(n_feed.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} unsupported: the kernel takes "
                        f"float32 or bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"pool dtypes {k_pages.dtype}/{v_pages.dtype} must "
                        f"equal q's {q.dtype}")
    for name, t in (("table", table), ("pos", pos), ("n_feed", n_feed)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("table", table), ("pos", pos), ("n_feed", n_feed)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_flash_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          pos: torch.Tensor,
                          n_feed: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Block-table paged attention.

    q ``[B, C, H, K]`` (C = feed width, 1 for decode); k_pages/v_pages
    ``[P, ps, H, K]`` AFTER this dispatch's scatter; table ``[B, MP]``
    int32 physical page ids; pos ``[B]`` int32 start positions; n_feed
    ``[B]`` int32 real columns (None = all C).  Returns ``[B, C, H, K]``
    in q's dtype, exact at every column ``< n_feed``.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in ``paged_flash_attention.launches``) or raise."""
    b, c = q.shape[0], q.shape[1]
    if n_feed is None:
        n_feed = torch.full((b,), c, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return paged_flash_attention_plain(q, k_pages, v_pages, table, pos,
                                           n_feed)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention runs on cuda (kernel) or "
                         f"cpu (plain version), not {q.device}")
    _check_cuda_inputs(q, k_pages, v_pages, table, pos, n_feed)
    lib = _lib()
    out = torch.empty_like(q)
    h, kd = q.shape[2], q.shape[3]
    pages, ps = k_pages.shape[0], k_pages.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), pos.data_ptr(), n_feed.data_ptr(),
            out.data_ptr(), b, c, h, kd, pages, ps, table.shape[1],
            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        smem = lib.dl4j_paged_attention_smem_bytes(c, kd)
        raise RuntimeError(
            f"paged attention kernel launch failed: "
            f"{lib.dl4j_cuda_error_string(err).decode()} (error {err}; "
            f"B={b} C={c} H={h} K={kd} needs {smem} bytes of shared "
            f"memory per block)")
    paged_flash_attention.launches.add()
    return out


paged_flash_attention.launches = LaunchCounter()


def paged_hbm_bytes(n_layers: int, lanes: int, live_pages: int,
                    max_pages: int, page_size: int, n_heads: int,
                    head_dim: int, itemsize: int, kernel: bool) -> int:
    """Modeled K/V bytes one decode dispatch reads: the gather path
    touches every block-table row (``MP * ps`` pool rows per lane per
    layer), the kernel only the lane's live pages.  Both read k and v
    (the factor 2); q/output/params traffic is the same on both paths
    and excluded."""
    rows = (live_pages if kernel else max_pages) * page_size
    return 2 * n_layers * lanes * rows * n_heads * head_dim * itemsize


__all__ = ["LaunchCounter", "paged_flash_attention",
           "paged_flash_attention_plain", "paged_hbm_bytes"]
