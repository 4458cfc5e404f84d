"""Continuous batching for LM generation over a paged or dense KV cache
(counterpart of `deeplearning4j_tpu.serving.lm`).

The server keeps a fixed pool of `slots` decode lanes and advances every
active lane each device dispatch:

- a finished sequence frees its slot (and its pages) immediately;
- a queued prompt joins mid-flight: its prompt feeds up to
  `prefill_chunk` tokens per dispatch (chunked prefill) while the other
  lanes keep decoding;
- every dispatch has `slots` lanes (inactive lanes ride as masked
  padding writing only the null page) and one of two widths: 1, or
  `prefill_chunk` while some lane has a full chunk of prompt left (with
  speculation, `spec_width` while some lane has drafts or a full chunk).

``kv="paged"`` (the default): KV state is one fixed pool of ``[pages, page_size, H, K]`` pages per
layer addressed through a per-lane block table
(`parallel.generation.make_spec_step`, whose dispatches without drafts
are the plain decode and prefill-chunk steps).  Pages are allocated on
admission and refcount-freed on completion (`serving/paged.py`), and a
radix tree over prompt prefixes lets a request whose prompt shares a
cached prefix skip prefill for it (copy-on-write at the divergence page;
reuse is capped at ``len(prompt) - 1`` because the last prompt token must
be fed to produce the first sampled token's logits).  ``kv="dense"``
keeps one ``[max_len]`` row per slot (`parallel.generation.make_slot_step`)
and teacher-forces a prompt one token per dispatch.

Speculation (``speculate="ngram"|"model"``, paged only): a drafter
(`serving/draft.py`) proposes up to `draft_len` tokens for each greedy
decoding lane, and one dispatch of width ``spec_width = max(prefill_chunk,
draft_len + 1)`` scores ``[last, d_1..d_k]`` through the paged kernel,
accepting the longest run the target's argmax agrees with plus one bonus
token (`parallel.generation.make_spec_step`).  Greedy output is that of
1-token decode; a rejected column's keys and values stay in the lane's
own pages, hidden by its position, so a rollback is a pointer move.

Sampling: temperature 0 is greedy; a sampled lane draws from a
counter-based generator keyed on ``(seed, tokens generated)``, so its
output does not depend on which other requests share its dispatches.

Resilience: bounded admission (`max_queue_depth` ->
`ServingOverloadError`), per-request deadlines shed before a prompt
occupies a slot (`DeadlineExceededError`), an abandoned request's slot
and pages are freed at the next admit round, and `begin_drain()`/
`drain()` stop admission for a graceful shutdown.  A failed dispatch
resets the allocator, radix tree and device pool together: the pool
tensors are updated in place, so their contents are no longer trusted.

Not ported yet (ROADMAP.md): page shipping, preemption and brownout,
tenancy, hibernation, the circuit breaker, SSE streaming, request tracing
and the compile watcher.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.parallel.generation import (
    init_paged_cache,
    init_slot_cache,
    make_page_copy,
    make_slot_step,
    make_spec_step,
    pages_per_seq,
    place_params,
)
from deeplearning4j_tpu_torch.parallel.transformer import (
    require_dense,
    torch_dtype,
)
from deeplearning4j_tpu_torch.serving.draft import make_drafter
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.paged import PagePool, RadixPrefixCache
from deeplearning4j_tpu_torch.serving.resilience import (
    DeadlineExceededError,
    ServingUnavailableError,
    check_admission,
)


def validate_request(cfg, prompt_ids, max_new_tokens: int) -> List[int]:
    """The serving-request contract, shared by the HTTP endpoint (as 400s)
    and `ContinuousLMServer` (as ValueErrors): a non-empty prompt of
    in-vocab tokens, a positive budget, and prompt + new tokens within the
    model's max_len.  A bad request fails here, before it reaches the
    worker, where an error would fail every co-travelling request."""
    ids = [int(t) for t in prompt_ids]
    if not ids:
        raise ValueError("prompt_ids must contain at least one token")
    bad = [t for t in ids if not 0 <= t < cfg.vocab_size]
    if bad:
        raise ValueError(f"prompt_ids outside vocab "
                         f"[0, {cfg.vocab_size}): {bad[:5]}")
    max_new = int(max_new_tokens)
    if max_new < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
    if len(ids) + max_new > cfg.max_len:
        raise ValueError(
            f"prompt ({len(ids)} tokens) + max_new_tokens ({max_new}) "
            f"exceeds max_len ({cfg.max_len}); shorten one of them")
    return ids


class _LMRequest:
    __slots__ = ("prompt", "max_new", "temperature", "seed", "event",
                 "result", "error", "enqueued", "deadline", "abandoned",
                 "t_installed", "t_done", "t_first", "prefix_matched")

    def __init__(self, prompt: List[int], max_new: int, temperature: float,
                 seed: int, deadline: Optional[float] = None):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.event = threading.Event()
        self.result: Optional[List[int]] = None
        self.error: Optional[BaseException] = None
        self.enqueued = time.perf_counter()
        self.deadline = deadline   # absolute perf_counter time, or None
        self.abandoned = False     # client gave up waiting
        self.t_installed: Optional[float] = None  # slot-install stamp
        self.t_done: Optional[float] = None       # decode-complete stamp
        self.t_first: Optional[float] = None      # first committed token
        self.prefix_matched = 0                   # radix tokens reused


class _Slot:
    __slots__ = ("req", "pos", "fed", "generated", "table", "owned",
                 "shared", "inserted")

    def __init__(self):
        self.req: Optional[_LMRequest] = None
        self.pos = 0          # next cache position to write
        self.fed = 0          # prompt tokens already fed (prefill cursor)
        self.generated: List[int] = []
        self.table: Optional[np.ndarray] = None   # [max_pages] int32 row
        self.owned: List[int] = []    # pages this lane allocated
        self.shared: List[int] = []   # prefix pages reused from the tree
        self.inserted = False         # prompt pages registered in the tree

    @property
    def active(self) -> bool:
        return self.req is not None


class ContinuousLMServer:
    """Slot-based continuous decode over one transformer LM: a paged KV
    pool with radix prefix reuse, chunked prefill and optional
    speculation (``kv="paged"``), or a dense per-slot cache
    (``kv="dense"``).

    `generate(prompt_ids, max_new_tokens)` is thread-safe and blocks until
    the request's sequence is complete.  `params` is the port's parameter
    tree (tensors or numpy arrays in the JAX layout); it is placed on
    `device` in the config dtype.  `device=None` means the card, and
    raises when there is none."""

    def __init__(self, cfg, params, slots: int = 4,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 kv: str = "paged", page_size: int = 16,
                 pages: Optional[int] = None, prefill_chunk: int = 8,
                 speculate: str = "off", draft_len: int = 4,
                 drafter=None, draft_model=None,
                 device: DeviceLike = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1 or None, got "
                             f"{max_queue_depth}")
        if kv not in ("paged", "dense"):
            raise ValueError(f"kv must be 'paged' or 'dense', got {kv!r}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if speculate not in ("off", "ngram", "model"):
            raise ValueError(f"speculate must be 'off', 'ngram' or "
                             f"'model', got {speculate!r}")
        if drafter is not None and speculate == "off":
            speculate = "custom"           # an injected Drafter instance
        if speculate != "off" and kv != "paged":
            # refused at construction: the rollback is a pointer move on
            # the page tables, and the dense cache has none
            raise ValueError(
                f"speculate={speculate!r} requires kv='paged' "
                f"(got kv={kv!r}): rollback rides the page tables")
        if speculate != "off" and draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        require_dense(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = place_params(cfg, params, self.device)
        self.n_slots = int(slots)
        self.max_queue_depth = max_queue_depth
        self.default_deadline_s = default_deadline_s
        self.kv = kv
        self.page_size = int(page_size)
        self.max_pages = pages_per_seq(cfg, self.page_size)
        # `pages` = usable KV pages (the null page is on top).  Default:
        # every slot can hold max_len, so prefix sharing becomes spare
        # capacity rather than a correctness question.
        self.kv_pages = (int(pages) if pages is not None
                         else self.n_slots * self.max_pages)
        if self.kv_pages < 1:
            raise ValueError(f"pages must be >= 1, got {self.kv_pages}")
        self.prefill_chunk = int(prefill_chunk)
        self.speculate = speculate
        self.draft_len = int(draft_len)
        self._drafter = drafter            # built in _start_locked if None
        self._draft_model = draft_model    # optional (cfg, params) pair
        # the one wide width: chunked prefill and the verify share it
        # ([last, d_1..d_k] needs draft_len + 1 columns)
        self.spec_width = (max(self.prefill_chunk, self.draft_len + 1)
                           if speculate != "off" else 0)
        self._wide = self.spec_width or self.prefill_chunk
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._running = False
        self._accepting = True
        self._thread: Optional[threading.Thread] = None
        self._cache = None    # (k, v) pool tensors, built by the worker
        self._step = None     # ONE dispatch entry point (tests stub it)
        self._copy = None
        self._pool: Optional[PagePool] = None
        self._tree: Optional[RadixPrefixCache] = None
        self._pending_cow: List[Dict] = []
        self._warm_req: Optional[threading.Event] = None
        self._slots = [_Slot() for _ in range(self.n_slots)]
        self._steps = 0
        self._width_dispatches: Dict[int, int] = {}

    # ---- client side ------------------------------------------------------

    def _required_pages(self, plen: int, max_new: int) -> int:
        """Pages one lane needs: positions written = plen + max_new - 1
        (the final sampled token is returned, never fed)."""
        return -(-(plen + max_new - 1) // self.page_size)

    def validate(self, prompt_ids, max_new_tokens: int) -> List[int]:
        """`validate_request` plus the paged pool's hard capacity: a
        request that could never fit the whole pool is the client's
        error."""
        ids = validate_request(self.cfg, prompt_ids, max_new_tokens)
        need = self._required_pages(len(ids), int(max_new_tokens))
        if self.kv == "paged" and need > self.kv_pages:
            raise ValueError(
                f"request needs {need} KV pages ({len(ids)} prompt + "
                f"{int(max_new_tokens)} new, page_size {self.page_size}) "
                f"but the pool holds {self.kv_pages}; raise -lm-pages or "
                f"shorten it")
        return ids

    def _retry_after_locked(self) -> float:
        lat = self.metrics.latency.summary()
        per_req = (lat.get("p50_ms", 100.0) or 100.0) / 1e3
        return max(0.1, per_req * (1 + len(self._queue) / self.n_slots))

    def _cancel_request(self, req: _LMRequest) -> None:
        """Give up on an unresolved request (client timeout).  A queued
        request is removed; one already in a slot is marked abandoned and
        the worker frees the slot at its next admit round (slot state is
        written by the worker thread only)."""
        now = time.perf_counter()
        with self._cond:
            try:
                self._queue.remove(req)
                self.metrics.set_queue_depth(len(self._queue))
                self.metrics.record_shed()
            except ValueError:
                req.abandoned = True
            resolved_with_error = (req.event.is_set()
                                   and req.error is not None)
        if (req.deadline is not None and now >= req.deadline
                and not resolved_with_error):
            self.metrics.record_deadline_missed()

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None,
                 deadline_s: Optional[float] = None) -> List[int]:
        """prompt ids -> full sequence (prompt + generated), blocking.

        `timeout` bounds the client's wait; `deadline_s` (default
        `default_deadline_s`) rides the queue item so the admitter sheds
        the request once it expires."""
        ids = self.validate(prompt_ids, max_new_tokens)
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        seed = int(seed) & 0x7FFFFFFF
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = _LMRequest(ids, int(max_new_tokens), float(temperature), seed)
        if deadline_s is not None:
            req.deadline = req.enqueued + float(deadline_s)
        with self._cond:
            check_admission(
                accepting=self._accepting, queue_depth=len(self._queue),
                max_queue_depth=self.max_queue_depth, metrics=self.metrics,
                retry_after_s=self._retry_after_locked, what="LM")
            if not self._running:
                self._start_locked()
            self._queue.append(req)
            self.metrics.set_queue_depth(len(self._queue))
            self._cond.notify_all()
        if not req.event.wait(timeout):
            self._cancel_request(req)
            raise DeadlineExceededError(
                f"LM request timed out after {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    def warmup(self, timeout: Optional[float] = 600.0) -> int:
        """Start the worker and run one dispatch of every width, the page
        copy and the model drafter's step before traffic (on the card
        this builds the kernel library and warms the math libraries).
        The paged warm dispatches feed nothing (n_feed = 0), so they
        write only the null page; the dense one waits for an idle pool.
        Returns the number of programs warmed, 0 if the warm did not run
        within `timeout`."""
        with self._cond:
            if not self._running:
                self._start_locked()
            ev = self._warm_req
            if ev is None:
                ev = self._warm_req = threading.Event()
            self._cond.notify_all()
        if not ev.wait(timeout):
            return 0
        if self.kv == "dense":
            return 1
        return (len(self._widths()) + 1
                + int(hasattr(self._drafter, "warmup")))

    def _widths(self) -> List[int]:
        """The paged dispatch widths: 1, and the wide program's (the
        prefill chunk, or `spec_width` with speculation) above 1."""
        return [1] + ([self._wide] if self._wide > 1 else [])

    def _warm_programs(self) -> None:
        zi = np.zeros((self.n_slots,), np.int32)
        zf = np.zeros((self.n_slots,), np.float32)
        if self.kv == "dense":
            _, k, v = self._step(self.params, *self._cache, zi, zi, zf, zi,
                                 zi)
            self._cache = (k, v)
        else:
            table = np.zeros((self.n_slots, self.max_pages), np.int32)
            for w in self._widths():
                tok = np.zeros((self.n_slots, w), np.int32)
                _, _, k, v = self._step(self.params, *self._cache, table,
                                        zi, zi, zi, tok, zf, zi, zi)
                self._cache = (k, v)
            self._cache = self._copy(*self._cache, 0, 0)
            if hasattr(self._drafter, "warmup"):
                self._drafter.warmup()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            self.metrics.set_queue_depth(0)
        for req in leftovers:
            self.metrics.record_shed()
            req.error = ServingUnavailableError("LM server stopped")
            req.event.set()

    # ---- drain lifecycle --------------------------------------------------

    @property
    def accepting(self) -> bool:
        """False once draining — the /readyz signal."""
        with self._cond:
            return self._accepting

    def ready(self) -> bool:
        return self.accepting

    def begin_drain(self) -> None:
        """Stop admission: later generates raise `ServingUnavailableError`;
        queued and in-slot work still decodes."""
        with self._cond:
            self._accepting = False
            self._cond.notify_all()

    def drain(self, grace_s: float = 5.0) -> bool:
        """Stop admission, wait up to `grace_s` for queued and in-slot
        requests, then stop the worker.  True when everything drained."""
        self.begin_drain()
        deadline = time.perf_counter() + max(0.0, grace_s)
        while True:
            with self._cond:
                busy = bool(self._queue) or any(
                    s.active for s in self._slots)
            if not busy or time.perf_counter() >= deadline:
                break
            time.sleep(0.01)
        with self._cond:
            drained = not self._queue and not any(
                s.active for s in self._slots)
        self.stop()
        return drained

    def page_ledger(self) -> Dict:
        """The page-accounting invariant (`PagePool.check_ledger`) plus
        the radix tree's node count; ``None`` values before the worker
        first starts."""
        with self._cond:
            if self._pool is None:
                return {"balanced": True, "pages": self.kv_pages,
                        "free": self.kv_pages, "in_use": 0, "held": 0,
                        "radix_nodes": 0}
            out = self._pool.check_ledger()
            out["radix_nodes"] = self._tree.nodes
            return out

    def _kv_bytes(self) -> Dict:
        """Provisioned vs actively held KV bytes: a dense cache pays for
        every slot's max_len; the paged pool holds refcounted pages."""
        cfg = self.cfg
        per_tok = (2 * cfg.n_layers * cfg.n_heads * cfg.head_dim
                   * torch_dtype(cfg.dtype).itemsize)
        if self.kv == "dense":
            provisioned = self.n_slots * cfg.max_len * per_tok
            active = per_tok * sum(s.pos for s in self._slots if s.active)
        else:
            provisioned = self.kv_pages * self.page_size * per_tok
            in_use = self._pool.in_use if self._pool is not None else 0
            active = in_use * self.page_size * per_tok
        return {"provisioned": int(provisioned), "active": int(active),
                "per_token": int(per_tok)}

    def stats(self) -> Dict:
        out = self.metrics.snapshot()
        with self._cond:
            out["slots"] = self.n_slots
            out["active_slots"] = sum(s.active for s in self._slots)
            out["queue_depth"] = len(self._queue)
            out["decode_steps"] = self._steps
            out["accepting"] = self._accepting
            out["kv_bytes"] = self._kv_bytes()
            kv = {"mode": self.kv}
            if self.kv == "paged":
                kv.update({
                    "page_size": self.page_size,
                    "pages": self.kv_pages,
                    "max_pages_per_seq": self.max_pages,
                    "prefill_chunk": self.prefill_chunk,
                    "pages_in_use": (self._pool.in_use
                                     if self._pool is not None else 0),
                    "pages_free": (self._pool.free
                                   if self._pool is not None
                                   else self.kv_pages),
                    "radix_nodes": (self._tree.nodes
                                    if self._tree is not None else 0),
                    "paged_kernel": self.device.type == "cuda"})
            out["kv"] = kv
            out["dispatch_widths"] = {
                str(w): n for w, n in sorted(self._width_dispatches.items())}
            if self.speculate != "off":
                spec = {"mode": self.speculate,
                        "draft_len": self.draft_len,
                        "verify_width": self.spec_width}
                if out.get("spec_drafted"):
                    spec.update({"drafted": out["spec_drafted"],
                                 "accepted": out["spec_accepted"],
                                 "accept_rate": out["spec_accept_rate"]})
                if out.get("decode_rounds"):
                    spec["tokens_per_decode_round"] = out[
                        "tokens_per_decode_round"]
                out["speculate"] = spec
        out["max_len"] = self.cfg.max_len
        out["device"] = str(self.device)
        return out

    # ---- worker side ------------------------------------------------------

    def _reset_cache(self) -> None:
        """(Re)allocate the device cache: at start, and after a failed
        dispatch left its in-place contents untrusted.  Allocated once,
        never per request."""
        if self.kv == "dense":
            cache = init_slot_cache(self.cfg, self.n_slots,
                                    device=self.device)
        else:
            cache = init_paged_cache(self.cfg, self.kv_pages + 1,
                                     self.page_size, device=self.device)
        self._cache = (cache["k"], cache["v"])

    def _reset_pool_locked(self) -> None:
        """Fresh allocator + radix tree + slot page bookkeeping, at start
        and whenever the device pool's contents died (failed dispatch,
        worker stop): a radix entry pointing into a rebuilt pool would
        serve zeros as a cached prefix.  The drafter's lane state goes
        with it.  Caller holds ``self._cond``."""
        if self.kv != "paged":
            return
        self._pool = PagePool(self.kv_pages + 1, self.page_size)
        self._tree = RadixPrefixCache(self._pool)
        self._pending_cow = []
        for s in self._slots:
            s.table = None
            s.owned = []
            s.shared = []
            s.inserted = False
        if self._drafter is not None:
            self._drafter.reset()
        self.metrics.set_pages(0, self.kv_pages, self.kv_pages)

    def _start_locked(self) -> None:
        if self._step is None:
            if self.kv == "dense":
                self._step = make_slot_step(self.cfg)
            else:
                self._step = self._build_paged_dispatch()
            self._reset_pool_locked()
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lm-decode")
        self._thread.start()

    def _build_paged_dispatch(self):
        """The paged programs, one `make_spec_step` per width behind ONE
        entry point, so that fault-injection tests stubbing `self._step`
        intercept each dispatch.  Without speculation every n_draft is 0
        and the programs are the plain decode and prefill-chunk steps."""
        total = self.kv_pages + 1
        self._copy = make_page_copy(self.cfg, total, self.page_size)
        programs = {w: make_spec_step(self.cfg, total, self.page_size, w)
                    for w in self._widths()}
        if self.speculate != "off" and self._drafter is None:
            self._drafter = make_drafter(
                self.speculate, self.cfg, self.params, self.n_slots,
                draft_model=self._draft_model, device=self.device)

        def dispatch(params, k, v, table, pos, n_feed, n_draft, tokens,
                     temperature, seeds, counts):
            return programs[tokens.shape[1]](
                params, k, v, table, pos, n_feed, n_draft, tokens,
                temperature, seeds, counts)

        return dispatch

    # ---- paged admission --------------------------------------------------

    def _free_slot_pages(self, slot: _Slot) -> None:
        """Refcount-release everything a lane held: its own pages return
        to the free list unless the radix tree kept them; shared prefix
        pages drop back to their other holders."""
        if self._pool is None:
            return
        if slot.owned:
            self._pool.release(slot.owned)
        if slot.shared:
            self._pool.release(slot.shared)
        slot.owned = []
        slot.shared = []
        slot.table = None
        slot.inserted = False

    def _plan_admission_paged(self, req: _LMRequest):
        """Radix match, then evict, then alloc for one queued request.
        Returns the install plan, or None when the pool (after eviction)
        cannot supply the fresh pages — the request stays queued.  Every
        page the plan references is already retained."""
        plen = len(req.prompt)
        total_pages = self._required_pages(plen, req.max_new)
        # cap reuse at plen-1: the LAST prompt token is always re-fed —
        # its logits are what the first sampled token comes from
        full, partial = self._tree.match(req.prompt[:plen - 1])
        need = total_pages - len(full)
        if self._pool.free < need:
            # evict only when eviction can cover the shortfall: wiping
            # cached prefixes while still admitting nothing destroys the
            # hit rate for no capacity
            if self._pool.free + self._tree.evictable() >= need:
                self._tree.evict(need)
        fresh = self._pool.alloc(need)
        if fresh is None:
            if full:
                self._pool.release(full)
            if partial is not None:
                self._pool.release([partial[0]])
            return None
        matched = len(full) * self.page_size + (partial[1]
                                                if partial else 0)
        return {"full": full, "partial": partial, "fresh": fresh,
                "matched": matched, "total_pages": total_pages}

    def _install_paged_locked(self, slot: _Slot, req: _LMRequest,
                              plan) -> None:
        """Bind one admitted request to a lane.  Caller holds
        ``self._cond``."""
        slot.req = req
        req.t_installed = time.perf_counter()
        req.prefix_matched = plan["matched"]
        slot.generated = []
        slot.fed = plan["matched"]
        slot.pos = plan["matched"]
        slot.shared = list(plan["full"])
        slot.owned = list(plan["fresh"])
        slot.inserted = False
        row = np.zeros((self.max_pages,), np.int32)
        n_full = len(plan["full"])
        row[:n_full] = plan["full"]
        row[n_full:plan["total_pages"]] = plan["fresh"]
        slot.table = row
        if plan["partial"] is not None:
            # copy-on-write: the divergence page's matched tokens are
            # valid KV; copy it into this lane's first fresh page and
            # overwrite from the divergence offset.  The source stays
            # retained until the copy lands; the dispatch releases it.
            src, _ = plan["partial"]
            self._pending_cow.append({"src": int(src),
                                      "dst": int(plan["fresh"][0])})
        self.metrics.record_prefix_query(plan["matched"])

    def _admit_locked(self) -> None:
        """Queued prompts join free slots, FIFO.  Doomed work is shed
        first: an abandoned request's slot and pages are freed, and an
        expired or abandoned queue item never occupies a slot.  When the
        head's pages cannot be supplied even after eviction, admission
        stops (head-of-line wait) rather than letting smaller later
        requests starve it."""
        for slot in self._slots:
            if slot.active and slot.req.abandoned:
                self.metrics.record_shed()
                self._free_slot_pages(slot)
                slot.req = None
        now = time.perf_counter()
        kept, shed = collections.deque(), 0
        for req in self._queue:
            if req.abandoned:
                shed += 1
            elif req.deadline is not None and now >= req.deadline:
                shed += 1
                self.metrics.record_deadline_missed()
                req.error = DeadlineExceededError(
                    f"deadline exceeded after {now - req.enqueued:.3f}s "
                    f"in LM queue; shed before decode")
                req.event.set()
            else:
                kept.append(req)
        if shed:
            self._queue = kept
            self.metrics.record_shed(shed)
        for slot in self._slots:
            if not self._queue:
                break
            if slot.active:
                continue
            if self.kv == "dense":
                slot.req = self._queue.popleft()
                slot.req.t_installed = time.perf_counter()
                slot.pos = 0
                slot.fed = 0
                slot.generated = []
                continue
            plan = self._plan_admission_paged(self._queue[0])
            if plan is None:
                break              # head-of-line waits for pages
            self._install_paged_locked(slot, self._queue.popleft(), plan)
        self.metrics.set_queue_depth(len(self._queue))
        if self._pool is not None:
            self.metrics.set_pages(self._pool.in_use, self._pool.free,
                                   self.kv_pages)

    def _finish_slot(self, slot: _Slot) -> None:
        """Completion fold: resolve the client, free the lane and pages."""
        req = slot.req
        if req.abandoned:
            # the client already got DeadlineExceededError: discarded work
            self.metrics.record_shed()
        else:
            req.result = req.prompt + slot.generated
            now = time.perf_counter()
            req.t_done = now
            t_in = req.t_installed or now
            self.metrics.record_request(now - req.enqueued,
                                        queue_wait_s=t_in - req.enqueued,
                                        compute_s=now - t_in)
            req.event.set()
        self._free_slot_pages(slot)
        slot.req = None

    def _insert_prompt_pages(self, slot: _Slot) -> None:
        """Prefill just completed: register the prompt's FULL pages in the
        radix tree so the next shared-prefix request skips them."""
        if slot.inserted:
            return
        slot.inserted = True
        n_full = len(slot.req.prompt) // self.page_size
        if n_full:
            self._tree.insert(slot.req.prompt[:n_full * self.page_size],
                              [int(p) for p in slot.table[:n_full]])

    def _commit_tokens(self, slot: _Slot, toks: List[int]) -> None:
        req = slot.req
        if req.t_first is None:
            req.t_first = time.perf_counter()
            self.metrics.record_first_token(req.t_first - req.enqueued)
        slot.generated.extend(int(t) for t in toks)

    def _drain_step(self) -> bool:
        """One scheduling round: admit, build the step inputs, dispatch,
        fold the sampled tokens back into each lane.  False when idle."""
        with self._cond:
            # the dense warm writes position 0 of every row, so it waits
            # for an idle pool; the paged one writes only the null page
            warm = self._warm_req
            if warm is not None and (self.kv == "paged" or not any(
                    s.active for s in self._slots)):
                self._warm_req = None
            else:
                warm = None
        if self._cache is None:
            # first round, or a failed dispatch left the pool untrusted:
            # rebuild inside the protected loop so a failing rebuild
            # fails this round's requests, not the worker thread
            self._reset_cache()
        if warm is not None:
            # inactive lanes write only the null page, so the warm is
            # safe alongside live lanes
            try:
                self._warm_programs()
            finally:
                warm.set()
            return True
        with self._cond:
            self._admit_locked()
            active = [s for s in self._slots if s.active]
            if not active:
                return False
            cow, self._pending_cow = self._pending_cow, []
        if self.kv == "dense":
            return self._dispatch_dense(active)
        return self._dispatch_paged(active, cow)

    def _dispatch_dense(self, active) -> bool:
        """One 1-wide dispatch of the dense slot pool: a lane in prefill
        is teacher-forced one prompt token, a decoding lane feeds its
        last sample."""
        token = np.zeros((self.n_slots,), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        temp = np.zeros((self.n_slots,), np.float32)
        seeds = np.zeros((self.n_slots,), np.int32)
        counts = np.zeros((self.n_slots,), np.int32)
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            req = slot.req
            token[i] = (req.prompt[slot.fed] if slot.fed < len(req.prompt)
                        else slot.generated[-1])
            pos[i] = slot.pos
            temp[i] = req.temperature
            seeds[i] = req.seed
            counts[i] = len(slot.generated)
        nxt, k, v = self._step(self.params, *self._cache, pos, token, temp,
                               seeds, counts)
        self._cache = (k, v)
        nxt = nxt.cpu().numpy()    # the round's one host sync
        self._steps += 1
        self._width_dispatches[1] = self._width_dispatches.get(1, 0) + 1
        emitted = 0
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            slot.pos += 1
            if slot.fed < len(slot.req.prompt):
                slot.fed += 1
                # the last prompt token's logits yield the first sample
                if slot.fed < len(slot.req.prompt):
                    continue
            self._commit_tokens(slot, [int(nxt[i])])
            emitted += 1
            if len(slot.generated) >= slot.req.max_new:
                self._finish_slot(slot)
        self.metrics.record_dispatch(len(active), self.n_slots)
        if emitted:
            self.metrics.record_tokens(emitted)
        return True

    def _draft_proposals(self) -> Dict[int, List[int]]:
        """One drafting round: proposals for greedy lanes past prefill
        with at least 2 tokens left, each capped at ``min(draft_len,
        remaining - 1)``.  Sampled lanes are never drafted for (a greedy
        accept rule would mis-sample them) and decode one token a round.
        A proposal is cut at its first out-of-vocab token, so the verify
        feed stays valid whatever a custom drafter returns."""
        histories: List[Optional[List[int]]] = [None] * self.n_slots
        budgets = [0] * self.n_slots
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            req = slot.req
            remaining = req.max_new - len(slot.generated)
            if (slot.fed >= len(req.prompt) and req.temperature == 0
                    and remaining >= 2 and slot.generated):
                histories[i] = req.prompt + slot.generated
                budgets[i] = min(self.draft_len, remaining - 1)
        if not any(budgets):
            return {}
        proposals = self._drafter.propose(histories, budgets)
        out: Dict[int, List[int]] = {}
        for i, prop in enumerate(proposals):
            if not budgets[i] or not prop:
                continue
            clean: List[int] = []
            for t in prop[:budgets[i]]:
                t = int(t)
                if not 0 <= t < self.cfg.vocab_size:
                    break
                clean.append(t)
            if clean:
                out[i] = clean
        return out

    def _dispatch_paged(self, active, cow) -> bool:
        for item in cow:
            self._cache = self._copy(*self._cache, item["src"], item["dst"])
            self._pool.release([item["src"]])
        drafts = self._draft_proposals() if self.speculate != "off" else {}
        # the wide program dispatches only while some lane has a FULL
        # chunk of prompt left (or, with speculation, drafts to verify);
        # sub-chunk tails and pure-decode rounds ride the 1-wide program
        full_chunk = any(len(s.req.prompt) - s.fed >= self.prefill_chunk
                         for s in active)
        wide = drafts or (full_chunk and self.prefill_chunk > 1)
        width = self._wide if wide else 1
        tokens = np.zeros((self.n_slots, width), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        n_feed = np.zeros((self.n_slots,), np.int32)
        n_draft = np.zeros((self.n_slots,), np.int32)
        temp = np.zeros((self.n_slots,), np.float32)
        seeds = np.zeros((self.n_slots,), np.int32)
        counts = np.zeros((self.n_slots,), np.int32)
        table = np.zeros((self.n_slots, self.max_pages), np.int32)
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            req = slot.req
            remaining = len(req.prompt) - slot.fed
            if remaining > 0:                  # chunked prefill
                f = min(remaining, width, self.prefill_chunk)
                tokens[i, :f] = req.prompt[slot.fed:slot.fed + f]
                n_feed[i] = f
            elif width > 1 and i in drafts:    # speculative verify
                prop = drafts[i]
                tokens[i, 0] = slot.generated[-1]
                tokens[i, 1:1 + len(prop)] = prop
                n_feed[i] = 1 + len(prop)
                n_draft[i] = len(prop)
            else:                              # decode: feed last sample
                tokens[i, 0] = slot.generated[-1]
                n_feed[i] = 1
            pos[i] = slot.pos
            temp[i] = req.temperature
            seeds[i] = req.seed
            counts[i] = len(slot.generated)
            table[i] = slot.table
        nxt, acc, k, v = self._step(self.params, *self._cache, table, pos,
                                    n_feed, n_draft, tokens, temp, seeds,
                                    counts)
        # the round's one host sync: next tokens and accepted counts
        both = torch.stack([nxt.to(torch.int32),
                            acc.to(torch.int32)]).cpu().numpy()
        nxt, acc = both[0], both[1]
        self._cache = (k, v)
        self._steps += 1
        self._width_dispatches[width] = (
            self._width_dispatches.get(width, 0) + 1)
        emitted = 0
        for i, slot in enumerate(self._slots):
            if not slot.active or n_feed[i] == 0:
                continue
            if slot.fed < len(slot.req.prompt):
                slot.pos += int(n_feed[i])
                slot.fed += int(n_feed[i])
                if slot.fed < len(slot.req.prompt):
                    continue
                # prefill complete: its full pages become reusable, and
                # the last prompt token's logits yield the first sample
                self._insert_prompt_pages(slot)
                self._commit_tokens(slot, [int(nxt[i])])
                emitted += 1
            else:
                # commit the accepted drafts plus the bonus token; pos
                # moves past the committed feeds only, so a rejected
                # column's keys and values (in this lane's own pages)
                # stay masked until real writes land on them
                a = int(acc[i])
                k_drafted = int(n_draft[i])
                slot.pos += 1 + a
                self._commit_tokens(slot, (drafts[i][:a] if k_drafted
                                           else []) + [int(nxt[i])])
                emitted += 1 + a
                self.metrics.record_decode_round(1 + a, drafted=k_drafted,
                                                 accepted=a)
            if len(slot.generated) >= slot.req.max_new:
                self._finish_slot(slot)
        self.metrics.record_dispatch(len(active), self.n_slots)
        if emitted:
            self.metrics.record_tokens(emitted)
        self.metrics.set_pages(self._pool.in_use, self._pool.free,
                               self.kv_pages)
        return True

    def _run(self) -> None:
        while True:
            with self._cond:
                if not self._running:
                    # abort in-flight + queued rather than leaving
                    # clients blocked on a dead worker
                    victims = [s.req for s in self._slots if s.active]
                    victims += list(self._queue)
                    for s in self._slots:
                        s.req = None
                    self._queue.clear()
                    self._reset_pool_locked()
                    if self._warm_req is not None:
                        self._warm_req.set()
                        self._warm_req = None
                    for r in victims:
                        self.metrics.record_shed()
                        r.error = ServingUnavailableError(
                            "LM server stopped")
                        r.event.set()
                    return
            try:
                busy = self._drain_step()
            except Exception as e:  # noqa: BLE001 — fail in-flight, keep serving
                with self._cond:
                    for s in self._slots:
                        if s.active:
                            s.req.error = e
                            s.req.event.set()
                            s.req = None
                    # the failed dispatch may have written part of the
                    # pool in place: reset the host page state now and
                    # rebuild the device pool at the next round
                    self._reset_pool_locked()
                    self._cache = None
                busy = True
            if not busy:
                with self._cond:
                    if not self._running:
                        return
                    if not self._queue and self._warm_req is None:
                        self._cond.wait(0.05)
            else:
                time.sleep(0)  # yield: let submitters enqueue mid-decode


__all__ = ["ContinuousLMServer", "validate_request"]
