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

The serving steps (`make_spec_step`, `make_paged_step`, `make_slot_step`
and the page copy, gather and install) are the JAX module's compiled
programs: each is a `runtime.programs.Program` per lane count, a CUDA
graph captured on its first call on the card.  A program's inputs have
fixed shapes and reach it through static buffers filled from the host
in one copy; nothing inside it reads back to the host or branches on the
host: the dense steps attend over the whole ``max_len`` under the mask,
the page ops take one page (copy) or a whole block-table row (gather,
install), and sampling takes host-drawn Gumbel noise in a ``[B, V]``
buffer.  A program holds the parameters and the cache by address, so a
step refuses other tensors than those it was built over.  Each step's
`eager` runs the same function without a program.

Sampling draws Gumbel noise from a counter-based generator keyed on
``(seed, count)`` (`gumbel_noise`): a pool lane's draws depend only on its
own seed and token index, and row b of a `generate` batch takes the b-th
``V`` values of step t's stream, so its output does not depend on the
batch size.  The bits differ from ``jax.random``'s, so sampled outputs
are compared with the JAX package by rule, not by value.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

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
from deeplearning4j_tpu_torch.runtime.programs import Program, StaticInputs


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


class ServingStep:
    """A serving step as programs (the JAX module's jitted programs): one
    `runtime.programs.Program` per lane count, running `compute(*held,
    t)` on static inputs `t`.  `held` (parameters, cache tensors) is read
    by address and fixed at the first call.  A subclass names its `key`
    (for errors), its host inputs (`_spec`), its device-side statics
    (`_statics`) and, with `vocab` > 0, samples: a ``[B, vocab]`` noise
    buffer, copied only in a dispatch where some lane samples."""

    key = ""
    vocab = 0

    def __init__(self, pool=None, key: Optional[str] = None):
        self.pool = pool
        if key is not None:
            self.key = key
        self._built: Dict[int, tuple] = {}

    def _spec(self, b: int) -> dict:
        """{name: (shape, numpy dtype)} of the host inputs."""
        raise NotImplementedError

    def _statics(self, held: tuple) -> dict:
        """Device-side static inputs filled by the caller (none here)."""
        return {}

    def compute(self, *args):
        """The step's function over the held tensors and the inputs."""
        raise NotImplementedError

    @property
    def programs(self) -> List[Program]:
        return [entry[2] for entry in self._built.values()]

    def _entry(self, held: tuple, b: int) -> tuple:
        """(inputs, noise, program, t) of `b` lanes, made on first use over
        `held`; a later call with other held tensors raises."""
        entry = self._built.get(b)
        if entry is None:
            device = held[-1].device
            inputs = StaticInputs(device, self._spec(b))
            t = dict(inputs.tensors, **self._statics(held))
            noise = None
            if self.vocab:
                noise = StaticInputs(device, {"noise": ((b, self.vocab),
                                                        np.float32)})
                t.update(noise.tensors)
            program = Program(self.key, lambda: self.compute(*held, t),
                              device, self.pool)
            entry = self._built[b] = (inputs, noise, program, t, held)
        if any(a is not w for a, w in zip(held, entry[4])):
            raise ValueError(
                f"program {self.key} was built over other parameter or "
                f"cache tensors: a step serves the tensors of its first "
                f"call")
        return entry[:4]

    def _run(self, held: tuple, b: int, host: dict, sampling=None):
        """Fill the static inputs from `host` (and the noise rows of
        `sampling` = (temperature, seeds, counts)), then run the program."""
        inputs, noise, program, _ = self._entry(held, b)
        inputs.put(**host)
        if noise is not None and sampling is not None:
            stage_noise(noise, *sampling)
        return program()

    def _eager(self, held: tuple, b: int, host: dict, sampling=None,
               statics: Optional[dict] = None):
        """`compute` on fresh device copies of the same inputs, without a
        program."""
        device = held[-1].device
        t = {}
        for name, (shape, dt) in self._spec(b).items():
            a = np.asarray(host[name], dt)
            if a.shape != tuple(shape):
                raise ValueError(f"{self.key}: {name} has shape {a.shape}, "
                                 f"the step takes {tuple(shape)}")
            t[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        t.update(statics or {})
        if self.vocab:
            noise = (sampling_noise(*sampling, self.vocab)
                     if sampling is not None else None)
            t["noise"] = (torch.zeros((b, self.vocab), dtype=torch.float32,
                                      device=device) if noise is None
                          else torch.from_numpy(noise).to(device))
        with torch.no_grad():
            return self.compute(*held, t)


class SlotStep(ServingStep):
    """The dense slot program (the ``kv="dense"`` pool's, key
    ``lm:dense``, and the model drafter's, ``lm:draft``): fn(params, k, v,
    pos [B], token [B], temperature [B], seeds [B], counts [B]) ->
    (next_token [B], k, v).  Each row attends over the whole ``max_len``
    under the mask, as the JAX module's one dense program does; k and v
    are updated in place.  Sampling is `sample_tokens`' per-slot rule."""

    key = "lm:dense"

    def __init__(self, cfg: TransformerConfig, pool=None,
                 key: Optional[str] = None):
        super().__init__(pool, key)
        self.cfg = cfg
        self.vocab = cfg.vocab_size

    def _spec(self, b: int) -> dict:
        return {"pos": ((b,), np.int32), "token": ((b,), np.int32),
                "temperature": ((b,), np.float32)}

    def compute(self, params, k, v, t):
        logits = _dense_step(self.cfg, params, k, v, t["token"], t["pos"],
                             None)
        return sample_from_noise(logits, t["temperature"], t["noise"])

    def _host(self, k, pos, token, temperature):
        pos = np.asarray(pos, np.int32)
        token = np.asarray(token, np.int32)
        b = k.shape[1]
        if pos.shape != (b,) or token.shape != (b,):
            raise ValueError(f"slot step over {b} slots got pos "
                             f"{pos.shape} and token {token.shape}")
        return b, {"pos": pos, "token": token, "temperature": temperature}

    def __call__(self, params, k, v, pos, token, temperature, seeds,
                 counts):
        b, host = self._host(k, pos, token, temperature)
        nxt = self._run((params, k, v), b, host,
                        (temperature, seeds, counts))
        return nxt, k, v

    def eager(self, params, k, v, pos, token, temperature, seeds, counts):
        """The same step without a program."""
        b, host = self._host(k, pos, token, temperature)
        return (self._eager((params, k, v), b, host,
                            (temperature, seeds, counts)), k, v)


def make_slot_step(cfg: TransformerConfig, pool=None,
                   key: Optional[str] = None) -> SlotStep:
    """Slot-step entry for the ``kv="dense"`` pool and the model drafter
    (`SlotStep`; `pool` is the server's graph memory pool)."""
    return SlotStep(cfg, pool, key)


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


def sampling_noise(temperature, seeds, counts,
                   vocab: int) -> Optional[np.ndarray]:
    """``[B, V]`` float32 Gumbel noise: `gumbel_noise(seeds[b], counts[b],
    V)` in each sampling lane's row (temperature > 0), zeros elsewhere;
    None when no lane samples."""
    temp = np.asarray(temperature, np.float32)
    lanes = np.nonzero(temp > 0)[0]
    if not lanes.size:
        return None
    noise = np.zeros((temp.shape[0], int(vocab)), np.float32)
    for i in lanes:
        noise[i] = gumbel_noise(int(seeds[i]), int(counts[i]), int(vocab))
    return noise


def stage_noise(inputs: StaticInputs, temperature, seeds, counts) -> None:
    """`sampling_noise` into a program's ``noise`` buffer.  Nothing is
    copied when no lane samples: a greedy lane's row is never chosen
    (`sample_from_noise`)."""
    noise = sampling_noise(temperature, seeds, counts,
                           inputs.tensors["noise"].shape[1])
    if noise is not None:
        inputs.put(noise=noise)


def sample_from_noise(logits: torch.Tensor, temperature: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
    """Per-lane next tokens from ``[B, V]`` logits, on the device and with
    no host branch: ``argmax(logits)`` where temperature ``[B]`` is 0,
    else the Gumbel-max draw ``argmax(logits / max(temperature, 1e-6) +
    noise)`` from ``softmax(logits / temperature)``."""
    logits = logits.float()
    sampled = (logits / torch.clamp(temperature, min=1e-6)[:, None]
               + noise).argmax(dim=-1)
    return torch.where(temperature > 0, sampled, logits.argmax(dim=-1))


def sample_tokens(logits: torch.Tensor, temperature: np.ndarray,
                  seeds: np.ndarray, counts: np.ndarray) -> torch.Tensor:
    """`sample_from_noise` with the host's `sampling_noise`: the pool's
    per-slot rule, greedy where the temperature is 0, else a draw keyed
    on ``(seed, count)``."""
    temp = np.asarray(temperature, np.float32)
    noise = sampling_noise(temp, seeds, counts, logits.shape[-1])
    dev = logits.device
    return sample_from_noise(
        logits, torch.from_numpy(temp).to(dev),
        torch.zeros(logits.shape, dtype=torch.float32, device=dev)
        if noise is None else torch.from_numpy(noise).to(dev))


def make_paged_step(cfg: TransformerConfig, pages: int, page_size: int,
                    chunk: int, pool=None):
    """Paged-step entry without drafts: fn(params, k, v, table [B, MP], pos
    [B], n_feed [B], tokens [B, chunk], temperature [B], seeds [B], counts
    [B]) -> (next_token [B], k, v), the decode head of `SpecStep` (the
    LM head at each lane's last fed column)."""
    step = SpecStep(cfg, pages, page_size, chunk, verify=False, pool=pool)

    def paged(params, k, v, table, pos, n_feed, tokens, temperature, seeds,
              counts):
        n_draft = np.zeros(np.shape(pos), np.int32)
        nxt, _, k, v = step(params, k, v, table, pos, n_feed, n_draft,
                            tokens, temperature, seeds, counts)
        return nxt, k, v

    return paged


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


class SpecStep(ServingStep):
    """The LM pool's paged program at one width (key ``lm:paged[w{W}]``):
    fn(params, k, v, table [B, MP], pos [B], n_feed [B], n_draft [B],
    tokens [B, W], temperature [B], seeds [B], counts [B]) ->
    (next_token [B], accepted [B], k, v), both outputs on the pool's
    device.  With `verify` (the speculating pool's wide program, as the
    JAX module's `_compiled_spec_step`) the step is `spec_verify_step`
    and the token is drawn at the bonus column; without it (the 1-wide
    program and the prefill chunk of a pool without speculation, as JAX's
    `make_paged_step`) it is `paged_decode_step`, the LM head at each
    lane's last fed column only, and accepted is 0.  Both draw by
    `sample_from_noise`, so a teacher-forced lane (n_draft = 0) gives the
    same token on either program."""

    def __init__(self, cfg: TransformerConfig, pages: int, page_size: int,
                 width: int, verify: bool = True, pool=None,
                 key: Optional[str] = None):
        super().__init__(pool, key if key is not None
                         else f"lm:paged[w{int(width)}]")
        self.cfg = cfg
        self.pages, self.page_size = int(pages), int(page_size)
        self.width, self.verify = int(width), bool(verify)
        self.mp = pages_per_seq(cfg, self.page_size)
        self.vocab = cfg.vocab_size

    def _spec(self, b: int) -> dict:
        lanes = ((b,), np.int32)
        return {"table": ((b, self.mp), np.int32), "pos": lanes,
                "n_feed": lanes, "n_draft": lanes,
                "tokens": ((b, self.width), np.int32),
                "temperature": ((b,), np.float32)}

    def compute(self, params, k, v, t):
        cache = {"k": k, "v": v}
        if self.verify:
            blog, accepted, _ = spec_verify_step(
                self.cfg, params, cache, t["table"], t["pos"], t["n_feed"],
                t["n_draft"], t["tokens"])
        else:
            blog, _ = paged_decode_step(self.cfg, params, cache, t["table"],
                                        t["pos"], t["n_feed"], t["tokens"])
            accepted = torch.zeros_like(t["n_draft"])
        return (sample_from_noise(blog, t["temperature"], t["noise"]),
                accepted)

    def _host(self, k, table, pos, n_feed, n_draft, tokens, temperature):
        table = np.asarray(table, np.int32)
        tokens = np.asarray(tokens, np.int32)
        b = table.shape[0]
        if (table.shape != (b, self.mp) or tokens.shape != (b, self.width)
                or tuple(k.shape[1:3]) != (self.pages, self.page_size)):
            raise ValueError(
                f"paged step built for table [B, {self.mp}], tokens "
                f"[B, {self.width}] and {self.pages} pages of "
                f"{self.page_size}; got table {table.shape}, tokens "
                f"{tokens.shape}, pool {tuple(k.shape)}")
        return b, {"table": table, "pos": pos, "n_feed": n_feed,
                   "n_draft": n_draft, "tokens": tokens,
                   "temperature": temperature}

    def __call__(self, params, k, v, table, pos, n_feed, n_draft, tokens,
                 temperature, seeds, counts):
        b, host = self._host(k, table, pos, n_feed, n_draft, tokens,
                             temperature)
        nxt, accepted = self._run((params, k, v), b, host,
                                  (temperature, seeds, counts))
        return nxt, accepted, k, v

    def eager(self, params, k, v, table, pos, n_feed, n_draft, tokens,
              temperature, seeds, counts):
        """The same step without a program."""
        b, host = self._host(k, table, pos, n_feed, n_draft, tokens,
                             temperature)
        nxt, accepted = self._eager((params, k, v), b, host,
                                    (temperature, seeds, counts))
        return nxt, accepted, k, v


def make_spec_step(cfg: TransformerConfig, pages: int, page_size: int,
                   width: int, verify: bool = True, pool=None) -> SpecStep:
    """Speculative-verify entry for the LM pool (`SpecStep`; ``verify=
    False`` is the decode head, the pool's program without drafts)."""
    return SpecStep(cfg, pages, page_size, width, verify, pool)


class PageCopy(ServingStep):
    """Copy-on-write program (key ``lm:page_copy``): fn(k, v, src, dst) ->
    (k, v), page `src` duplicated into page `dst` in every layer, in
    place: one page, as the JAX program."""

    key = "lm:page_copy"

    def __init__(self, cfg: TransformerConfig, pages: int, page_size: int,
                 pool=None):
        super().__init__(pool)
        self.pages = int(pages)

    def _spec(self, b: int) -> dict:
        return {"pages": ((2,), np.int32)}

    def compute(self, k, v, t):
        src, dst = t["pages"][:1].long(), t["pages"][1:].long()
        k.index_copy_(1, dst, k.index_select(1, src))
        v.index_copy_(1, dst, v.index_select(1, src))

    def __call__(self, k, v, src, dst):
        self._run((k, v), 1, {"pages": np.array([src, dst], np.int32)})
        return k, v

    def eager(self, k, v, src, dst):
        """The same step without a program."""
        self._eager((k, v), 1, {"pages": np.array([src, dst], np.int32)})
        return k, v


def make_page_copy(cfg: TransformerConfig, pages: int, page_size: int,
                   pool=None) -> PageCopy:
    """Copy-on-write entry (`PageCopy`)."""
    return PageCopy(cfg, pages, page_size, pool)


class PageGather(ServingStep):
    """Export half of KV page shipping (`serving/transfer.py`; key
    ``lm:page_gather``): fn(k, v, table_row [MP]) -> (pages_k ``[L, MP,
    ps, H, K]``, pages_v), a lane's pages gathered out of the pool by
    block-table row (entries past the shipped count point at the null
    page; the caller slices them off).  The pool is read, not changed:
    the exporting lane keeps serving.  The outputs are the program's
    static buffers: consume them before its next call."""

    key = "lm:page_gather"

    def __init__(self, cfg: TransformerConfig, pages: int, page_size: int,
                 pool=None):
        super().__init__(pool)
        self.mp = pages_per_seq(cfg, page_size)

    def _spec(self, b: int) -> dict:
        return {"row": ((self.mp,), np.int32)}

    def compute(self, k, v, t):
        row = t["row"].long()
        return k.index_select(1, row), v.index_select(1, row)

    def __call__(self, k, v, table_row):
        return self._run((k, v), 1, {"row": table_row})

    def eager(self, k, v, table_row):
        """The same step without a program."""
        return self._eager((k, v), 1, {"row": table_row})


def make_page_gather(cfg: TransformerConfig, pages: int, page_size: int,
                     pool=None) -> PageGather:
    """Page-gather entry (`PageGather`)."""
    return PageGather(cfg, pages, page_size, pool)


class PageInstall(ServingStep):
    """Import half of KV page shipping (key ``lm:page_install``): fn(k, v,
    pages_k ``[L, M, ps, H, K]``, pages_v, table_row [MP], n) -> (k, v),
    the page stack scattered into the pool at the row's physical pages
    in one call, in place.  M is at most MP: the pages are copied into
    the program's ``[L, MP, ps, H, K]`` buffers, and every row at or past
    `n` lands on the null page 0, whose contents are garbage by design,
    so the program's shape never depends on how many pages shipped."""

    key = "lm:page_install"

    def __init__(self, cfg: TransformerConfig, pages: int, page_size: int,
                 pool=None):
        super().__init__(pool)
        self.mp = pages_per_seq(cfg, page_size)

    def _spec(self, b: int) -> dict:
        return {"row": ((self.mp,), np.int32), "n": ((1,), np.int32)}

    def _statics(self, held: tuple) -> dict:
        k = held[0]
        shape = (k.shape[0], self.mp) + tuple(k.shape[2:])
        return {name: torch.zeros(shape, dtype=k.dtype, device=k.device)
                for name in ("pages_k", "pages_v")}

    def compute(self, k, v, t):
        dst = torch.where(torch.arange(self.mp, device=k.device) < t["n"],
                          t["row"], 0).long()
        k.index_copy_(1, dst, t["pages_k"])
        v.index_copy_(1, dst, t["pages_v"])

    def _check(self, pages_k, pages_v) -> int:
        m = pages_k.shape[1]
        if pages_v.shape != pages_k.shape or m > self.mp:
            raise ValueError(f"page install takes at most {self.mp} pages "
                             f"of one shape, got {tuple(pages_k.shape)} and "
                             f"{tuple(pages_v.shape)}")
        return m

    def __call__(self, k, v, pages_k, pages_v, table_row, n):
        m = self._check(pages_k, pages_v)
        t = self._entry((k, v), 1)[3]
        with torch.no_grad():
            t["pages_k"][:, :m].copy_(pages_k)
            t["pages_v"][:, :m].copy_(pages_v)
        self._run((k, v), 1, {"row": table_row, "n": [int(n)]})
        return k, v

    def eager(self, k, v, pages_k, pages_v, table_row, n):
        """The same step without a program."""
        m = self._check(pages_k, pages_v)
        statics = self._statics((k, v))
        statics["pages_k"][:, :m].copy_(pages_k)
        statics["pages_v"][:, :m].copy_(pages_v)
        self._eager((k, v), 1, {"row": table_row, "n": [int(n)]},
                    statics=statics)
        return k, v


def make_page_install(cfg: TransformerConfig, pages: int, page_size: int,
                      pool=None) -> PageInstall:
    """Page-install entry (`PageInstall`)."""
    return PageInstall(cfg, pages, page_size, pool)


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


__all__ = ["PageCopy", "PageGather", "PageInstall", "ServingStep",
           "SlotStep", "SpecStep", "beam_search", "decode_step",
           "filtered_logits", "generate", "gumbel_noise", "init_cache",
           "init_paged_cache", "init_slot_cache", "make_page_copy",
           "make_page_gather", "make_page_install", "make_paged_step",
           "make_slot_step", "make_spec_step", "paged_decode_step",
           "paged_forward", "pages_per_seq", "place_params",
           "sample_from_noise", "sample_tokens", "sampling_noise",
           "slot_decode_step", "spec_verify_step", "stage_noise"]
