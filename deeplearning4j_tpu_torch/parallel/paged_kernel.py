"""Paged attention over a block-tabled K/V pool (counterpart of
`deeplearning4j_tpu.parallel.paged_kernel`).

`paged_flash_attention` walks each lane's block table and runs one online
softmax over the lane's live pages.  For a CUDA tensor it launches the
hand-written Hopper kernel in ``csrc/paged_attention.cu`` (built with
``nvcc`` on first use) or raises; for a CPU tensor it runs
`paged_flash_attention_plain`, the plain PyTorch version.  There is no
switch: on the card the kernel always runs.

The kernel splits each lane's pages across blocks (flash-decoding): the
plan, `paged_split_plan` (pages and query columns a block), is computed
here from the shapes and the card's SM count and handed to the C entry.
One call counts as one launch in
``paged_flash_attention.launches`` (keyed by its query width C), whether
it ran the split kernel alone (one split) or the split kernel and the
merge kernel.

Semantics (identical to the TPU kernel): query column ``c`` of lane ``b``
sits at position ``pos[b] + c`` and sees keys ``t <= pos[b] + c``; the
pools already hold this dispatch's own keys.  At every fed column
(``c < n_feed[b]``) kernel and plain version agree; padding columns
attend only through the lane's frontier page in the kernel and through
the full horizon in the plain version, and no caller reads them.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel.kernels import (
    LaunchCounter,
    mask_value,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The widest head dim the kernel takes (csrc/paged_attention.cu kMaxK),
# the widest its tensor-core route takes (kMaxMmaK), and the entry's
# return code for a wider one (kErrHeadDim).
MAX_HEAD_DIM = 512
MAX_MMA_HEAD_DIM = 256
_ERR_HEAD_DIM = -1
# The split plan aims at this many blocks per SM, and gives a block at
# least this many keys.
BLOCKS_PER_SM = 8
MIN_SPLIT_KEYS = 128
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
            lib.dl4j_paged_attention.argtypes = [vp] * 9 + [ci] * 11 + [vp]
            lib.dl4j_paged_attention.restype = ci
            lib.dl4j_paged_attention_smem_bytes.argtypes = [ci] * 4
            lib.dl4j_paged_attention_smem_bytes.restype = ctypes.c_size_t
            lib.dl4j_cuda_error_string.argtypes = [ci]
            lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
            _lib_handle = lib
        return _lib_handle


def block_cols(c: int, dtype: torch.dtype, kd: int) -> int:
    """Query columns one block of the split kernel takes, which also
    picks its kernel: 1 at C = 1, and 4 with C > 1 for float32, float16
    or a head dim above `MAX_MMA_HEAD_DIM` (the FMA route); 16 for
    bfloat16 with C > 1 at a head dim up to it (the tensor-core
    route)."""
    if c == 1:
        return 1
    return 16 if dtype == torch.bfloat16 and kd <= MAX_MMA_HEAD_DIM else 4


def paged_split_plan(b: int, c: int, h: int, kd: int, mp: int, ps: int,
                     dtype: torch.dtype, n_sm: int) -> dict:
    """How the kernel splits a ``[B, C, H, K]`` call over a table of
    ``MP`` pages of ``ps`` keys on a card of ``n_sm`` SMs.

    Each block takes one (lane, head, query-column tile, range of at
    most ``pages_per_split`` logical pages).  The plan aims at
    `BLOCKS_PER_SM` blocks per SM with at least `MIN_SPLIT_KEYS` keys a
    block; ``n_splits = ceil(MP / pages_per_split)``.  With more than
    one split every block writes its partial (m, l) into ``part_ml``
    and its unnormalised output into ``part_acc`` (f32 scratch of the
    given shapes), and a merge kernel writes ``out``."""
    cols = block_cols(c, dtype, kd)
    c_tiles = -(-c // cols)
    base = b * h * c_tiles
    want = max(1, -(-BLOCKS_PER_SM * n_sm // base))
    pps = min(mp, max(-(-mp // want), -(-MIN_SPLIT_KEYS // ps)))
    n_splits = -(-mp // pps)
    split = n_splits > 1
    return {"pages_per_split": pps, "n_splits": n_splits, "cols": cols,
            "c_tiles": c_tiles, "blocks": n_splits * base,
            "part_ml": (n_splits, b, c, h, 2) if split else None,
            "part_acc": (n_splits, b, c, h, kd) if split else None}


@functools.lru_cache(maxsize=256)
def _device_plan(b: int, c: int, h: int, kd: int, mp: int, ps: int,
                 dtype: torch.dtype, device_index: int) -> dict:
    """`paged_split_plan` for the card `device_index` (its SM count read
    once; the serving loop calls with a handful of shapes)."""
    n_sm = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    return paged_split_plan(b, c, h, kd, mp, ps, dtype, n_sm)


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
                        f"float32, bfloat16 or float16")
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
    mp = table.shape[1]
    plan = _device_plan(b, c, h, kd, mp, ps, q.dtype,
                        q.device.index if q.device.index is not None
                        else torch.cuda.current_device())
    ml_ptr = acc_ptr = None
    if plan["n_splits"] > 1:
        n_ml = math.prod(plan["part_ml"])
        part = torch.empty(n_ml + math.prod(plan["part_acc"]),
                           dtype=torch.float32, device=q.device)
        ml_ptr = part.data_ptr()
        acc_ptr = ml_ptr + 4 * n_ml
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), pos.data_ptr(), n_feed.data_ptr(),
            out.data_ptr(), ml_ptr, acc_ptr, b, c, h, kd, pages, ps, mp,
            plan["pages_per_split"], plan["n_splits"], plan["cols"],
            _DTYPE_CODES[q.dtype], stream)
    if err == _ERR_HEAD_DIM:
        raise RuntimeError(f"paged attention kernel refused head dim "
                           f"K={kd}: it takes K <= {MAX_HEAD_DIM}")
    if err != 0:
        smem = lib.dl4j_paged_attention_smem_bytes(
            plan["cols"], kd, _DTYPE_CODES[q.dtype],
            plan["pages_per_split"])
        raise RuntimeError(
            f"paged attention kernel launch failed: "
            f"{lib.dl4j_cuda_error_string(err).decode()} (error {err}; "
            f"B={b} C={c} H={h} K={kd}, {plan['n_splits']} splits of "
            f"{plan['pages_per_split']} pages, {smem} bytes of shared "
            f"memory per block)")
    paged_flash_attention.launches.add(key=c)
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


__all__ = ["BLOCKS_PER_SM", "LaunchCounter", "MAX_HEAD_DIM",
           "MIN_SPLIT_KEYS", "block_cols", "paged_flash_attention",
           "paged_flash_attention_plain", "paged_hbm_bytes",
           "paged_split_plan"]
