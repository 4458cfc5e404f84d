"""KV-cached decoding for the continuous LM server and whole-sequence
generation (counterpart of `deeplearning4j_tpu.parallel.generation`).

Three cache layouts, as in the JAX module:

- **dense** ``[L, B, max_len, H, K]`` with one position for the whole
  batch (`init_cache`, `decode_step`): the cache of `generate` and
  `beam_search`.  The prompt is prefilled by ONE causal forward through
  `kernels.flash_forward` (kernel B2 on the card) that writes each
  layer's rows ``[0, P)``; the JAX module scans P single-token steps,
  which is the same function.  The decode steps are plain tensor ops, as
  the JAX module's are XLA einsums.
- **dense slots**: the same buffer with a ``[B]`` position vector
  (`init_slot_cache`, `slot_decode_step`, `make_slot_step`), each row at
  its own depth: the ``kv="dense"`` pool and the model drafter.
- **paged**: one fixed pool of ``[pages, page_size, H, K]`` pages per
  layer plus a per-lane block table ``[B, max_pages]`` int32: a lane's
  logical position ``t`` lives at ``pool[table[b, t // page_size], t %
  page_size]``.  Page 0 is the reserved null page: padding columns and
  inactive lanes write there, unallocated table entries point there, and
  every read of it is masked.  Attention over the pages is
  `paged_kernel.paged_flash_attention` (kernel B1 on the card), for the
  1-wide decode, the prefill chunk and the speculative verify
  (`spec_verify_step`) alike.

The JAX steps donate their buffers and return the updated ones; here the
cache tensors are updated in place (the scatter of each dispatch's new
keys and values, the copy-on-write page copy), and the steps return the
same tensors.

Sampling draws Gumbel noise from a counter-based generator keyed on
``(seed, count)`` (`gumbel_noise`): a pool lane's draws depend only on its
own seed and token index, and row b of a `generate` batch takes the b-th
``V`` values of step t's stream, so its output does not depend on the
batch size.  The bits differ from ``jax.random``'s, so sampled outputs
are compared with the JAX package by rule, not by value.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.parallel.kernels import (
    NEG_INF,
    flash_forward,
    mask_value,
)
from deeplearning4j_tpu_torch.parallel.paged_kernel import (
    paged_flash_attention,
)
from deeplearning4j_tpu_torch.parallel.transformer import (
    TransformerConfig,
    _ffn,
    _forward_cache,
    _layer_norm,
    lm_head,
    map_tree,
    out_proj,
    qkv_proj,
    torch_dtype,
)


def _to_device_ints(device: torch.device, *arrays) -> List[torch.Tensor]:
    """Host int32 arrays -> int32 tensors on `device`, moved in one copy
    (views of one packed buffer, each in its array's shape)."""
    arrays = [np.asarray(a, np.int32) for a in arrays]
    packed = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
    dev = packed.to(device)
    out, at = [], 0
    for a in arrays:
        out.append(dev[at:at + a.size].view(a.shape))
        at += a.size
    return out


def place_params(cfg: TransformerConfig, params: dict,
                 device: torch.device) -> dict:
    """`params` (tensors or numpy arrays, JAX layout) as tensors on
    `device` in the config dtype; leaves already there are returned as
    they are."""
    dt = torch_dtype(cfg.dtype)

    def leaf(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.require(np.asarray(a, np.float32),
                                            requirements=["C", "W"]))
        return a.to(device=device, dtype=dt)

    return map_tree(leaf, params)


# ---------------------------------------------------------------------------
# Dense KV cache: one position for the batch (generate, beam_search) or a
# [B] position vector (the slot pool)


def init_cache(cfg: TransformerConfig, batch: int,
               device: DeviceLike = None) -> dict:
    """Dense KV cache ``{"k", "v"}`` of ``[L, B, max_len, H, K]`` zeros in
    the config dtype, and ``"pos"``, the batch's next position (a host
    int)."""
    shape = (cfg.n_layers, int(batch), cfg.max_len, cfg.n_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


def init_slot_cache(cfg: TransformerConfig, slots: int,
                    device: DeviceLike = None) -> dict:
    """Slot KV cache: `init_cache` with a ``[B]`` int32 position vector
    on the device."""
    cache = init_cache(cfg, slots, device)
    cache["pos"] = torch.zeros((int(slots),), dtype=torch.int32,
                               device=cache["k"].device)
    return cache


def _slot_attn(p, x, layer_k, layer_v, pos, span: Optional[int] = None):
    """Single-position attention against a dense cache, one position per
    row: x ``[B, 1, d]``; layer_k/v ``[B, max_len, H, K]``, updated in
    place with row b's key and value at ``pos[b]``; each row attends to
    its keys ``<= pos[b]``.  Scores, softmax and the weighted sum are
    f32, masked scores ``mask_value(float32)``.  Only the first `span`
    cache positions are read (every ``pos[b] < span``; None = all), which
    drops masked keys whose weights are exactly zero."""
    q, k, v = qkv_proj(p, x)                              # [B, 1, H, K]
    rows = torch.arange(x.shape[0], device=x.device)
    pos = pos.long()
    layer_k[rows, pos] = k[:, 0]
    layer_v[rows, pos] = v[:, 0]
    hk, hv = layer_k[:, :span], layer_v[:, :span]
    s = torch.einsum("bqhk,bshk->bqhs", q.float(), hk.float()) / math.sqrt(
        q.shape[-1])
    valid = (torch.arange(hk.shape[1], device=x.device)[None, :]
             <= pos[:, None])                             # [B, S]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, mask_value(torch.float32)))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhs,bshk->bqhk", w, hv.float()).to(q.dtype)
    return out_proj(p, o)


def _dense_step(cfg: TransformerConfig, params: dict, cache_k, cache_v,
                token: torch.Tensor, pos: torch.Tensor,
                span: Optional[int]) -> torch.Tensor:
    """token ``[B]`` at positions pos ``[B]`` through the stack over a
    dense cache (written in place) -> logits ``[B, V]``.  MoE blocks are
    dense-masked, as in every step here."""
    x = (params["embed"][token.long()][:, None, :]
         + params["pos"][pos.long()][:, None, :])
    for i, layer in enumerate(params["layers"]):
        x = x + _slot_attn(layer["attn"], _layer_norm(layer["ln1"], x),
                           cache_k[i], cache_v[i], pos, span)
        x = x + _ffn(cfg, layer, _layer_norm(layer["ln2"], x))
    x = _layer_norm(params["ln_f"], x)
    return x[:, 0] @ lm_head(params)


def decode_step(cfg: TransformerConfig, params: dict, cache: dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """token ``[B]`` at position ``cache["pos"]`` -> (logits ``[B, V]``
    in the config dtype, as every step of the JAX module gives them; the
    cache with pos + 1, its tensors written in place).  The JAX
    `_cached_attn` is `_slot_attn` with every row at that position."""
    pos = int(cache["pos"])
    posv = torch.full((token.shape[0],), pos, dtype=torch.long,
                      device=token.device)
    logits = _dense_step(cfg, params, cache["k"], cache["v"], token, posv,
                         pos + 1)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def slot_decode_step(cfg: TransformerConfig, params: dict, cache: dict,
                     token: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """token ``[B]``, row b at position ``cache["pos"][b]`` -> (logits
    ``[B, V]``, the cache with every pos advanced).  Per row the math of
    `decode_step`: a slot decoding alone gives the logits of a batch-1
    `generate` at the same position."""
    pos = cache["pos"]
    logits = _dense_step(cfg, params, cache["k"], cache["v"], token, pos,
                         None)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def make_slot_step(cfg: TransformerConfig):
    """Slot-step entry for the ``kv="dense"`` pool and the model drafter:
    fn(params, k, v, pos [B], token [B], temperature [B], seeds [B],
    counts [B]) -> (next_token [B], k, v).  The integer inputs are host
    arrays (one copy to the device); k and v are updated in place.
    Sampling is `sample_tokens`, the paged step's per-slot rule."""

    def step(params, k, v, pos, token, temperature, seeds, counts):
        pos = np.asarray(pos, np.int32)
        token = np.asarray(token, np.int32)
        b = k.shape[1]
        if pos.shape != (b,) or token.shape != (b,):
            raise ValueError(f"slot step over {b} slots got pos "
                             f"{pos.shape} and token {token.shape}")
        pos_t, tok_t = _to_device_ints(k.device, pos, token)
        with torch.no_grad():
            logits = _dense_step(cfg, params, k, v, tok_t, pos_t,
                                 int(pos.max()) + 1)
            nxt = sample_tokens(logits, temperature, seeds, counts)
        return nxt, k, v

    return step


# ---------------------------------------------------------------------------
# Paged KV pool


def pages_per_seq(cfg: TransformerConfig, page_size: int) -> int:
    """Block-table width: logical pages one max_len lane needs."""
    return -(-int(cfg.max_len) // int(page_size))


def init_paged_cache(cfg: TransformerConfig, pages: int, page_size: int,
                     device: DeviceLike = None) -> dict:
    """Paged KV pool ``{"k", "v"}`` of ``[L, pages, page_size, H, K]``
    zeros in the config dtype (page 0 is the reserved null page)."""
    shape = (cfg.n_layers, int(pages), int(page_size), cfg.n_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _scatter_rows(table: torch.Tensor, pos: torch.Tensor,
                  n_feed: torch.Tensor, c: int, ps: int) -> torch.Tensor:
    """Flat pool rows ``page * ps + offset`` the ``[B, C]`` fed columns
    write; padding columns and inactive lanes go to the null page's row
    0.  The same for every layer of one dispatch."""
    mp = table.shape[1]
    j = torch.arange(c, device=table.device)[None, :]
    wpos = pos.long()[:, None] + j                        # [B, C]
    real = j < n_feed.long()[:, None]
    lpage = torch.clamp(wpos // ps, max=mp - 1)
    page = torch.gather(table.long(), 1, lpage)
    page = torch.where(real, page, torch.zeros_like(page))
    off = torch.where(real, wpos % ps, torch.zeros_like(wpos))
    return (page * ps + off).reshape(-1)


def _paged_attn(p, x, layer_k, layer_v, table, pos, n_feed, rows=None):
    """Paged attention for one layer.

    x ``[B, C, d]``; layer_k/v ``[P, ps, H, K]`` (updated in place with
    this dispatch's keys and values); table ``[B, MP]``, pos and n_feed
    ``[B]`` int32.  `rows` is `_scatter_rows` for this dispatch (computed
    here when None)."""
    q, k, v = qkv_proj(p, x)                              # [B, C, H, K]
    b, c, h, kd = q.shape
    pages, ps = layer_k.shape[0], layer_k.shape[1]
    if rows is None:
        rows = _scatter_rows(table, pos, n_feed, c, ps)
    layer_k.view(pages * ps, h, kd)[rows] = k.reshape(b * c, h, kd)
    layer_v.view(pages * ps, h, kd)[rows] = v.reshape(b * c, h, kd)
    o = paged_flash_attention(q, layer_k, layer_v, table, pos, n_feed)
    return out_proj(p, o)


def _paged_hidden(cfg: TransformerConfig, params: dict, cache: dict,
                  table, pos, n_feed, tokens) -> torch.Tensor:
    """The stack up to the final layer norm: ``[B, C, d]``."""
    c = tokens.shape[1]
    ps = cache["k"].shape[2]
    wpos = pos.long()[:, None] + torch.arange(c, device=tokens.device)
    pidx = torch.clamp(wpos, max=cfg.max_len - 1)        # clip padding
    x = params["embed"][tokens.long()] + params["pos"][pidx]
    rows = _scatter_rows(table, pos, n_feed, c, ps)
    for i, layer in enumerate(params["layers"]):
        x = x + _paged_attn(layer["attn"], _layer_norm(layer["ln1"], x),
                            cache["k"][i], cache["v"][i], table, pos,
                            n_feed, rows)
        x = x + _ffn(cfg, layer, _layer_norm(layer["ln2"], x))
    return _layer_norm(params["ln_f"], x)


def paged_forward(cfg: TransformerConfig, params: dict, cache: dict,
                  table, pos, n_feed, tokens) -> Tuple[torch.Tensor, dict]:
    """tokens ``[B, C]``, lane b feeding its first n_feed[b] columns at
    positions pos[b].. -> (logits ``[B, C, V]`` at every column, cache
    with the fed keys/values written into the pool in place)."""
    x = _paged_hidden(cfg, params, cache, table, pos, n_feed, tokens)
    return x @ lm_head(params), cache


def paged_decode_step(cfg: TransformerConfig, params: dict, cache: dict,
                      table, pos, n_feed, tokens
                      ) -> Tuple[torch.Tensor, dict]:
    """`paged_forward` with logits taken at each lane's last fed column,
    ``max(n_feed - 1, 0)`` -> ``[B, V]``.  Only that column goes through
    the LM head."""
    x = _paged_hidden(cfg, params, cache, table, pos, n_feed, tokens)
    col = torch.clamp(n_feed.long() - 1, min=0)
    last = x[torch.arange(x.shape[0], device=x.device), col]   # [B, d]
    return last @ lm_head(params), cache


def gumbel_noise(seed: int, count: int, vocab: int) -> np.ndarray:
    """Gumbel noise for one sampled token, from the counter-based Philox
    generator keyed on ``(seed, count)``: a lane's draws depend only on
    its own seed and token index, never on which other requests share
    its dispatches.  (The bits differ from ``jax.random``'s.)"""
    gen = np.random.Generator(np.random.Philox(
        key=np.array([seed & 0xFFFFFFFFFFFFFFFF, count], np.uint64)))
    u = np.clip(gen.random(vocab), 1e-12, 1.0 - 1e-12)
    return (-np.log(-np.log(u))).astype(np.float32)


def sample_tokens(logits: torch.Tensor, temperature: np.ndarray,
                  seeds: np.ndarray, counts: np.ndarray) -> torch.Tensor:
    """Per-lane next tokens from ``[B, V]`` logits: argmax where the
    temperature is 0, else a draw from ``softmax(logits / temperature)``
    by the Gumbel-max rule over `gumbel_noise`."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    lanes = np.nonzero(np.asarray(temperature) > 0)[0]
    if lanes.size:
        vocab = logits.shape[-1]
        noise = np.stack([gumbel_noise(int(seeds[i]), int(counts[i]), vocab)
                          for i in lanes])
        idx = torch.as_tensor(lanes, device=logits.device)
        temp = torch.as_tensor(np.maximum(np.asarray(temperature)[lanes],
                                          1e-6), dtype=torch.float32,
                               device=logits.device)
        scores = (logits[idx] / temp[:, None]
                  + torch.from_numpy(noise).to(logits.device))
        out[idx] = scores.argmax(dim=-1)
    return out


def make_paged_step(cfg: TransformerConfig, pages: int, page_size: int,
                    chunk: int):
    """Paged-step entry for `serving.lm.ContinuousLMServer`:
    fn(params, k, v, table [B, MP], pos [B], n_feed [B], tokens [B, chunk],
    temperature [B], seeds [B], counts [B]) -> (next_token [B], k, v).

    The integer inputs are host (numpy) arrays; they travel to the pool's
    device in one copy.  k and v are the pool tensors, updated in place
    and returned."""
    pages, page_size, chunk = int(pages), int(page_size), int(chunk)
    mp = pages_per_seq(cfg, page_size)

    def step(params, k, v, table, pos, n_feed, tokens, temperature, seeds,
             counts):
        table = np.asarray(table, np.int32)
        tokens = np.asarray(tokens, np.int32)
        b = table.shape[0]
        if (table.shape != (b, mp) or tokens.shape != (b, chunk)
                or k.shape[1:3] != (pages, page_size)):
            raise ValueError(
                f"paged step built for table [B, {mp}], tokens "
                f"[B, {chunk}] and {pages} pages of {page_size}; got "
                f"table {table.shape}, tokens {tokens.shape}, pool "
                f"{tuple(k.shape)}")
        tbl, pos_t, nf_t, tok_t = _to_device_ints(k.device, table, pos,
                                                  n_feed, tokens)
        with torch.no_grad():
            logits, _ = paged_decode_step(cfg, params, {"k": k, "v": v},
                                          tbl, pos_t, nf_t, tok_t)
            nxt = sample_tokens(logits, temperature, seeds, counts)
        return nxt, k, v

    return step


# ---------------------------------------------------------------------------
# Speculative verify: [last, d_1..d_k] scored in one wide paged dispatch


def spec_verify_step(cfg: TransformerConfig, params: dict, cache: dict,
                     table, pos, n_feed, n_draft, tokens
                     ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """tokens ``[B, W]``; lane b feeds its first n_feed[b] columns.  A
    verify lane feeds ``[last_committed, d_1..d_k]`` with n_feed = k + 1
    and n_draft = k; a teacher-forced lane (prefill chunk, plain decode,
    padding) feeds any n_feed with n_draft = 0.

    -> (bonus logits ``[B, V]`` f32 at each lane's divergence column,
    accepted ``[B]`` int32 drafts accepted, cache).  Draft d_i is accepted
    iff every earlier one was and the target's argmax after column i - 1
    is d_i; the bonus column is ``clip(n_feed - 1 - n_draft + accepted,
    0, W - 1)``, where the logits are those a 1-wide step would give
    after the last accepted token.  Rejected columns' keys and values
    stay in the lane's own pages, hidden by ``pos`` and the causal
    mask."""
    logits, cache = paged_forward(cfg, params, cache, table, pos, n_feed,
                                  tokens)                 # [B, W, V]
    pred = logits.argmax(dim=-1)                          # [B, W]
    b, w = tokens.shape
    live = (torch.arange(1, w, device=logits.device)[None, :]
            <= n_draft.long()[:, None])                   # [B, W-1]
    ok = (pred[:, :-1] == tokens[:, 1:].long()) & live
    accepted = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    bonus_col = torch.clamp(n_feed.long() - 1 - n_draft.long() + accepted,
                            0, w - 1)
    blog = logits[torch.arange(b, device=logits.device), bonus_col].float()
    return blog, accepted.to(torch.int32), cache


def make_spec_step(cfg: TransformerConfig, pages: int, page_size: int,
                   width: int):
    """Speculative-verify entry for the LM pool: fn(params, k, v, table
    [B, MP], pos [B], n_feed [B], n_draft [B], tokens [B, W], temperature
    [B], seeds [B], counts [B]) -> (bonus_token [B], accepted [B], k, v),
    both outputs on the pool's device.  The bonus token is drawn at the
    bonus column by `sample_tokens`, the 1-wide step's per-slot rule, so
    a sampled lane (n_draft = 0) gives the same tokens on either
    program.  A dispatch with no drafts (n_draft all 0, known on the
    host) is `paged_decode_step`, which is `spec_verify_step` there with
    the LM head at each lane's last fed column only; accepted is 0."""
    pages, page_size, width = int(pages), int(page_size), int(width)
    mp = pages_per_seq(cfg, page_size)

    def step(params, k, v, table, pos, n_feed, n_draft, tokens,
             temperature, seeds, counts):
        table = np.asarray(table, np.int32)
        tokens = np.asarray(tokens, np.int32)
        b = table.shape[0]
        if (table.shape != (b, mp) or tokens.shape != (b, width)
                or k.shape[1:3] != (pages, page_size)):
            raise ValueError(
                f"verify step built for table [B, {mp}], tokens "
                f"[B, {width}] and {pages} pages of {page_size}; got "
                f"table {table.shape}, tokens {tokens.shape}, pool "
                f"{tuple(k.shape)}")
        tbl, pos_t, nf_t, nd_t, tok_t = _to_device_ints(
            k.device, table, pos, n_feed, n_draft, tokens)
        cache = {"k": k, "v": v}
        with torch.no_grad():
            if np.any(n_draft):
                blog, accepted, _ = spec_verify_step(
                    cfg, params, cache, tbl, pos_t, nf_t, nd_t, tok_t)
            else:
                blog, _ = paged_decode_step(cfg, params, cache, tbl, pos_t,
                                            nf_t, tok_t)
                accepted = torch.zeros_like(nd_t)
            nxt = sample_tokens(blog, temperature, seeds, counts)
        return nxt, accepted, k, v

    return step


def make_page_copy(cfg: TransformerConfig, pages: int, page_size: int):
    """Copy-on-write entry: fn(k, v, src, dst) -> (k, v), duplicating page
    `src` into page `dst` in every layer, in place."""

    def copy(k, v, src, dst):
        src, dst = int(src), int(dst)
        with torch.no_grad():
            k[:, dst] = k[:, src]
            v[:, dst] = v[:, src]
        return k, v

    return copy


def make_page_gather(cfg: TransformerConfig, pages: int, page_size: int):
    """Export half of KV page shipping (`serving/transfer.py`): fn(k, v,
    table_row [MP]) -> (pages_k ``[L, MP, ps, H, K]``, pages_v), a lane's
    pages gathered out of the pool by block-table row (entries past the
    shipped count point at the null page; the caller slices them off).
    The pool is read, not changed: the exporting lane keeps serving."""

    def gather(k, v, table_row):
        row = torch.as_tensor(np.asarray(table_row, np.int64),
                              device=k.device)
        with torch.no_grad():
            return k[:, row], v[:, row]

    return gather


def make_page_install(cfg: TransformerConfig, pages: int, page_size: int):
    """Import half of KV page shipping: fn(k, v, pages_k ``[L, M, ps, H,
    K]``, pages_v, table_row [MP], n) -> (k, v), the page stack scattered
    into the pool at the row's physical pages in one call, in place.  M
    is at most MP; rows at or past `n` land on the null page 0, whose
    contents are garbage by design."""

    def install(k, v, pages_k, pages_v, table_row, n):
        m = pages_k.shape[1]
        row = np.asarray(table_row, np.int64)[:m]
        dst = torch.as_tensor(np.where(np.arange(m) < int(n), row, 0),
                              device=k.device)
        with torch.no_grad():
            k[:, dst] = pages_k.to(device=k.device, dtype=k.dtype)
            v[:, dst] = pages_v.to(device=v.device, dtype=v.dtype)
        return k, v

    return install


# ---------------------------------------------------------------------------
# Whole-sequence decoding: generate (greedy, temperature, top-k, top-p)
# and beam search, over the dense cache


def _prefill(cfg: TransformerConfig, params: dict, prompt: torch.Tensor
             ) -> Tuple[dict, torch.Tensor]:
    """The prompt ``[B, P]`` through one causal forward -> (a dense cache
    holding every layer's keys and values at ``[0, P)`` with pos = P,
    the logits ``[B, V]`` at P - 1).  The attention is
    `kernels.flash_forward`: kernel B2 on the card, n_layers launches."""
    b, p = prompt.shape
    cache = init_cache(cfg, b, device=prompt.device)

    def store(i, k, v):
        cache["k"][i, :, :p] = k
        cache["v"][i, :, :p] = v

    def attn(q, k, v):
        return flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                             True)[0]

    x = _forward_cache(cfg, params, prompt.long(), attn, store)
    cache["pos"] = p
    return cache, x[:, -1] @ lm_head(params)


def _filter_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the logits at or above each row's top_k-th largest value
    (ties at it included); the rest become -1e30."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                       logits)


def _filter_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose
    probability mass reaches top_p (a token is kept while the mass
    before it is below top_p, so the argmax always survives); the rest
    become -1e30."""
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_l, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    cutoff = torch.where(keep, sorted_l,
                         torch.full_like(sorted_l, math.inf)).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF),
                       logits)


def filtered_logits(logits: torch.Tensor, temperature: float, top_k: int,
                    top_p: float) -> torch.Tensor:
    """The f32 logits a sampled `generate` step draws from:
    ``logits / temperature``, cut by `_filter_top_k` when ``0 < top_k <
    V`` and by `_filter_top_p` when ``top_p < 1``."""
    out = logits.float() / max(float(temperature), 1e-6)
    if 0 < top_k < out.shape[-1]:
        out = _filter_top_k(out, int(top_k))
    if top_p < 1.0:
        out = _filter_top_p(out, float(top_p))
    return out


def _validate_prompt(cfg: TransformerConfig, prompt, max_new_tokens: int,
                     device: torch.device) -> torch.Tensor:
    """The shared generate/beam_search prompt checks -> ``[B, P]`` int64
    on `device`.  Out-of-vocab ids are refused here, on the host: on the
    card an out-of-range embedding index is a device fault."""
    ids = np.asarray(prompt.cpu() if isinstance(prompt, torch.Tensor)
                     else prompt, np.int64)
    if ids.ndim != 2:
        raise ValueError(f"prompt must be [B, P] token ids, got shape "
                         f"{ids.shape}")
    plen = ids.shape[1]
    if plen < 1:
        raise ValueError("prompt must contain at least one token "
                         "(the first sampled token conditions on it)")
    if plen + max_new_tokens > cfg.max_len:
        raise ValueError(f"prompt({plen}) + new({max_new_tokens}) exceeds "
                         f"max_len({cfg.max_len})")
    if ids.size and not (0 <= ids.min() and ids.max() < cfg.vocab_size):
        raise ValueError(f"prompt ids outside vocab [0, {cfg.vocab_size})")
    return torch.from_numpy(ids).to(device)


def generate(cfg: TransformerConfig, params: dict, prompt,
             max_new_tokens: int, temperature: float = 0.0,
             seed: Optional[int] = None, top_k: int = 0, top_p: float = 1.0,
             device: DeviceLike = None) -> torch.Tensor:
    """prompt ``[B, P]`` int -> ``[B, P + max_new_tokens]`` int32 on
    `device` (None = the card).

    Temperature 0 is greedy (`top_k`/`top_p` unused); otherwise each
    step draws from ``softmax(filtered_logits(...))`` by the Gumbel-max
    rule, row b of step t taking the b-th ``V`` values of
    ``gumbel_noise(seed, t, B * V)``: the same seed gives the same ids,
    and a row's ids do not depend on the batch size.  The prompt is
    prefilled in one causal forward (`_prefill`); each new token is one
    `decode_step`."""
    dev = resolve_device(device)
    prompt = _validate_prompt(cfg, prompt, max_new_tokens, dev)
    if temperature > 0 and seed is None:
        raise ValueError("sampling (temperature>0) requires a seed")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    params = place_params(cfg, params, dev)
    b = prompt.shape[0]
    new = []
    with torch.no_grad():
        cache, logits = _prefill(cfg, params, prompt)
        for t in range(max_new_tokens):
            if temperature > 0:
                scores = filtered_logits(logits, temperature, top_k, top_p)
                v = scores.shape[-1]
                noise = gumbel_noise(int(seed), t, b * v).reshape(b, v)
                tok = (scores + torch.from_numpy(noise).to(dev)).argmax(-1)
            else:
                tok = logits.argmax(dim=-1)
            new.append(tok)
            if t + 1 < max_new_tokens:   # the last token is never fed
                logits, cache = decode_step(cfg, params, cache, tok)
    return torch.cat([prompt] + [t[:, None] for t in new],
                     dim=1).to(torch.int32)


def beam_search(cfg: TransformerConfig, params: dict, prompt,
                max_new_tokens: int, beam_size: int = 4,
                device: DeviceLike = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic beam search: prompt ``[B, P]`` int -> (tokens ``[B,
    P + max_new_tokens]`` int32, the winning beams' summed log-probs
    ``[B]`` f32), on `device` (None = the card).  beam_size 1 is greedy.
    Every beam decodes exactly max_new_tokens tokens (no EOS), so no
    length penalty would change the ranking.

    The prompt is prefilled once per input row and the cache tiled to the
    beams; only beam 0 starts live (score 0, the rest -1e30), so step 1
    picks k distinct tokens.  Each step takes the top k of the flattened
    (beam, token) scores and gathers the parent beams' caches and
    histories."""
    dev = resolve_device(device)
    prompt = _validate_prompt(cfg, prompt, max_new_tokens, dev)
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    params = place_params(cfg, params, dev)
    batch, k = prompt.shape[0], int(beam_size)
    with torch.no_grad():
        cache, logits = _prefill(cfg, params, prompt)
        cache["k"] = cache["k"].repeat_interleave(k, dim=1)
        cache["v"] = cache["v"].repeat_interleave(k, dim=1)
        logp = torch.log_softmax(logits.float(), dim=-1).repeat_interleave(
            k, dim=0)                                     # [B*k, V]
        v = logp.shape[-1]
        scores = torch.full((batch, k), NEG_INF, dtype=torch.float32,
                            device=dev)
        scores[:, 0] = 0.0
        toks = torch.zeros((batch * k, max_new_tokens), dtype=torch.long,
                           device=dev)
        base = torch.arange(batch, device=dev)[:, None] * k
        for t in range(max_new_tokens):
            total = scores[:, :, None] + logp.view(batch, k, v)
            # the top k (beam, token) pairs, the lower index first among
            # equal scores as `lax.top_k` orders them (`torch.topk`
            # promises no order): a stable descending sort
            scores, top = torch.sort(total.reshape(batch, k * v), dim=-1,
                                     descending=True, stable=True)
            scores, top = scores[:, :k], top[:, :k]
            token = (top % v).reshape(-1)
            rows = (base + top // v).reshape(-1)          # parent beams
            pos = cache["pos"]
            cache["k"][:, :, :pos] = cache["k"][:, rows, :pos]
            cache["v"][:, :, :pos] = cache["v"][:, rows, :pos]
            toks = toks[rows]
            toks[:, t] = token
            if t + 1 < max_new_tokens:
                logits, cache = decode_step(cfg, params, cache, token)
                logp = torch.log_softmax(logits.float(), dim=-1)
        best = scores.argmax(dim=1)                       # [B]
        rows = torch.arange(batch, device=dev)
        new = toks.view(batch, k, max_new_tokens)[rows, best]
        return (torch.cat([prompt, new], dim=1).to(torch.int32),
                scores[rows, best])


__all__ = ["beam_search", "decode_step", "filtered_logits", "generate",
           "gumbel_noise", "init_cache", "init_paged_cache",
           "init_slot_cache", "make_page_copy", "make_page_gather",
           "make_page_install", "make_paged_step",
           "make_slot_step", "make_spec_step", "paged_decode_step",
           "paged_forward", "pages_per_seq", "place_params",
           "sample_tokens", "slot_decode_step", "spec_verify_step"]
