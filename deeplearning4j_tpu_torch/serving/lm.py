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
A ``breaker`` (`CircuitBreaker`) is asked before every dispatch and told
each dispatch's outcome; while it is open, admission fails fast
(`CircuitOpenError`, 503) and the lanes in flight fail with it.

Page mobility (paged KV only): a lane's pages leave the pool through
`parallel.generation.make_page_gather` as one `serving/transfer.py`
frame and come back through `make_page_install`, in one call each.

- ``ship=True``: `prefill_export` admits a request normally but resolves
  at prefill completion (first token sampled, prompt pages in the radix
  tree) with the lane's `PageExport`; `admit_with_pages` installs a
  shipped lane in another pool, which decodes on exactly where the
  prefill pool left off.
- ``preempt=True``: requests carry a priority (`serving/pressure.py`;
  the queue is ordered by (priority, arrival)), and a request that would
  wait on a dry pool preempts the lowest-priority active lane: its pages
  are gathered, framed (int8 with ``swap_quantize``) and parked in a
  byte-capped host store, and the request requeues with its arrival
  stamp.  On re-admission the lane is installed again and resumes; a
  lane whose swap was evicted or corrupted recomputes from its prompt.
  ``brownout`` adds the degradation ladder: speculation off, the prefill
  width halved, best_effort lanes preempted, best_effort admissions
  shed with Retry-After.
- ``hibernate_idle_s``: a request with a `session_id` leaves its whole
  committed sequence's full pages in the radix tree; once the session
  has been idle that long its pages are framed into the tiered store
  (`serving/hibernate.py`, spilling to ``state_dir`` on disk) and freed.
  A later prompt with that prefix resumes them instead of prefilling,
  also in a fresh server over the same ``state_dir``.

KV at position t is a function of tokens[0..t] and the weights, so a
shipped, restored or resumed lane decodes the tokens a local one does,
greedy or seeded sampling.

Tenancy (``tenants=``, a `TenantRegistry`, a spec mapping or the
``-tenants`` JSON): a request names a registered tenant (None is
"default"; without a registry any other name is the client's
ValueError).  Admission charges the tenant's token bucket (prompt + new
tokens) before the shared gate (`TenantQuotaError`, 429), the queue is
ordered by ``(priority rank, WFQ virtual finish time, enqueued)``, the
brownout shed and preemption take from non-compliant tenants first
(`TenantRegistry.badness`), and each finished request feeds the
tenant's ledgers and SLO burn rate.

Streaming: `generate_stream` admits like `generate` (typed errors raise
before the first token) and yields each committed token as the worker
folds it; closing the iterator abandons the request.  With ``tracer``
every request leaves one trace (``queue_wait`` and ``decode`` spans, and
an ``xla_compile`` span for each program built inside its decode window)
under its request id; with ``registry`` the pool's metric cells publish
under ``plane="lm"``.

Spans (the span store of `obs.trace`, on unless switched off): each
scheduling round that dispatches records ``serve.round`` (counts: the
pool id, the width, the lanes fed, the tokens fed, ``kv_pages`` — the
pages paged attention reads a layer, the sum over the fed lanes of
``ceil((pos + n_feed) / page_size)`` — the page size and ``qk_pairs``,
the causal query-key pairs of the fed columns) and, back to back inside
it, ``serve.admit`` (with ``serve.lock``, the wait for the pool lock),
``serve.stage`` (installs, copy-on-write copies, drafts and the input
fill), ``serve.launch`` (the step call: input copies and the graph
replay), ``serve.wait`` (the round's one host sync) and
``serve.commit`` (the token fold, streams, finished lanes, metrics).
Each install records the request's ``serve.queue`` span, enqueue to
install (the interval ``serving_queue_wait_seconds`` observes), tagged
with its request id.

Programs: every device step is a `runtime.programs.Program` built once
and replayed (a CUDA graph on the card, sharing one graph memory pool):
the paged program at each width (``lm:paged[w{W}]``), the dense one
(``lm:dense``), the page copy, gather and install and the model
drafter's step (``lm:draft``), each run under `compile_scope` with the
JAX package's program key.  `warmup()` builds them all, so no request
builds one afterwards (``stats()["compiles_total"]`` stays flat); the
programs hold the pool tensors by address, so a failed dispatch zeroes
the pool in place instead of reallocating it.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.obs.compilewatch import (
    compile_scope,
    compile_watcher,
)
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry
from deeplearning4j_tpu_torch.obs.trace import (
    TraceRecorder,
    new_pool_id,
    new_request_id,
    new_span_id,
    record_span,
    span,
    trace,
)
from deeplearning4j_tpu_torch.parallel.generation import (
    init_paged_cache,
    init_slot_cache,
    make_page_copy,
    make_page_gather,
    make_page_install,
    make_slot_step,
    make_spec_step,
    pages_per_seq,
    place_params,
)
from deeplearning4j_tpu_torch.parallel.transformer import torch_dtype
from deeplearning4j_tpu_torch.runtime.programs import new_pool
from deeplearning4j_tpu_torch.serving.draft import make_drafter
from deeplearning4j_tpu_torch.serving.hibernate import (
    TieredStateStore,
    prefix_key,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.paged import PagePool, RadixPrefixCache
from deeplearning4j_tpu_torch.serving.pressure import (
    PRIORITY_RANK,
    RANK_BEST_EFFORT,
    BrownoutLadder,
    PressureConfig,
    SwapEvictedError,
    normalize_priority,
)
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    ServingError,
    ServingOverloadError,
    ServingUnavailableError,
    check_admission,
)
from deeplearning4j_tpu_torch.serving.tenancy import (
    DEFAULT_TENANT,
    TenantQuotaError,
    TenantRegistry,
)
from deeplearning4j_tpu_torch.serving.transfer import (
    PageExport,
    PageShipError,
    check_compatible,
    deserialize_export,
    model_signature,
    quantize_export,
    serialize_export,
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
                 "request_id", "t_installed", "t_done", "t_first",
                 "prefix_matched", "drafted", "accepted", "export",
                 "export_result", "import_pages", "stream", "session_id",
                 "priority", "rank", "swap_key", "swap_restore",
                 "swap_error", "stream_pushed", "preempted", "tenant",
                 "vft", "cost")

    def __init__(self, prompt: List[int], max_new: int, temperature: float,
                 seed: int, deadline: Optional[float] = None,
                 request_id: Optional[str] = None):
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
        self.request_id = request_id   # X-Request-Id: names the trace
        self.t_installed: Optional[float] = None  # slot-install stamp
        self.t_done: Optional[float] = None       # decode-complete stamp
        self.t_first: Optional[float] = None      # first committed token
        self.prefix_matched = 0                   # radix tokens reused
        self.drafted = 0               # speculative tokens proposed
        self.accepted = 0              # speculative tokens accepted
        self.export = False            # resolve at prefill completion
        self.export_result: Optional[PageExport] = None
        self.import_pages: Optional[PageExport] = None  # shipped-in lane
        self.stream = None             # per-token queue (the SSE leg)
        self.session_id: Optional[str] = None
        self.priority = "interactive"  # admission class
        self.rank = 0                  # PRIORITY_RANK[priority]
        self.swap_key: Optional[str] = None  # swap store key while queued
        self.swap_restore = False      # import_pages came from the swap
        self.swap_error: Optional[str] = None  # why a restore failed
        self.stream_pushed = 0         # tokens already streamed
        self.preempted = 0             # times this lane was preempted
        self.tenant = DEFAULT_TENANT   # normalized tenant name
        self.vft = 0.0                 # WFQ virtual finish time
        self.cost = self.max_new + len(self.prompt)  # tokens charged


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
    (``kv="dense"``).  MoE configs decode dense-masked in every step.

    `generate(prompt_ids, max_new_tokens)` is thread-safe and blocks until
    the request's sequence is complete.  `params` is the port's parameter
    tree (tensors or numpy arrays in the JAX layout); it is placed on
    `device` in the config dtype.  `device=None` means the card, and
    raises when there is none.  `ship`, `preempt` (with `swap_bytes`),
    `brownout` (True or a `PressureConfig`), `hibernate_idle_s` (with
    `state_dir` and `state_disk_bytes`) and `swap_quantize` configure the
    page-mobility planes of the module docstring; `breaker`, `tenants`,
    `tracer` and `registry` the operations plane."""

    def __init__(self, cfg, params, slots: int = 4,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 kv: str = "paged", page_size: int = 16,
                 pages: Optional[int] = None, prefill_chunk: int = 8,
                 speculate: str = "off", draft_len: int = 4,
                 drafter=None, draft_model=None, ship: bool = False,
                 preempt: bool = False, swap_bytes: int = 64 << 20,
                 brownout=None, tenants=None,
                 hibernate_idle_s: Optional[float] = None,
                 state_dir: Optional[str] = None,
                 state_disk_bytes: int = 1 << 30,
                 swap_quantize: bool = True,
                 tracer: Optional[TraceRecorder] = None,
                 registry: Optional[MetricsRegistry] = None,
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
        if ship and kv != "paged":
            raise ValueError(
                f"ship=True requires kv='paged' (got kv={kv!r}): page "
                f"shipping moves block-table pages")
        if preempt and kv != "paged":
            raise ValueError(
                f"preempt=True requires kv='paged' (got kv={kv!r}): "
                f"preemption swaps block-table pages out to the host")
        if brownout and kv != "paged":
            raise ValueError(
                f"brownout requires kv='paged' (got kv={kv!r}): the "
                f"ladder's signals are the paged pool's pressure")
        if hibernate_idle_s is not None:
            if kv != "paged":
                raise ValueError(
                    f"hibernate_idle_s requires kv='paged' (got "
                    f"kv={kv!r}): hibernation parks block-table pages "
                    f"on the tiered state store")
            if float(hibernate_idle_s) < 0:
                raise ValueError(
                    f"hibernate_idle_s must be >= 0, got "
                    f"{hibernate_idle_s}")
        if state_dir is not None and not (preempt
                                          or hibernate_idle_s is not None):
            raise ValueError(
                "state_dir names a disk tier nothing would write: it "
                "requires preempt=True or hibernate_idle_s (serve with "
                "-lm-preempt or -lm-hibernate-idle-s)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = place_params(cfg, params, self.device)
        self.n_slots = int(slots)
        self.max_queue_depth = max_queue_depth
        self.default_deadline_s = default_deadline_s
        self.breaker = breaker
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
        self.tracer = tracer
        if registry is not None:
            self.metrics.register_into(registry, plane="lm")
        self._compile_watch = compile_watcher()
        if breaker is not None:
            breaker.add_listener(self.metrics.set_breaker_state)
            self.metrics.set_breaker_state(breaker.state)
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._running = False
        self._accepting = True
        self._thread: Optional[threading.Thread] = None
        self._cache = None    # (k, v) pool tensors, built by the worker
        self._cache_stale = False   # a failed dispatch wrote into them
        self._graph_pool = None     # the programs' shared graph memory
        self._step = None     # ONE dispatch entry point (tests stub it)
        self._copy = None
        self._pool: Optional[PagePool] = None
        self._tree: Optional[RadixPrefixCache] = None
        self._pending_cow: List[Dict] = []
        # page mobility: the gather/install pair, and installs waiting
        # for the next dispatch (shipped, restored or resumed lanes)
        self.ship = bool(ship)
        self._gather = None
        self._install = None
        self._pending_install: List[Dict] = []
        self.preempt = bool(preempt)
        self.hibernate_idle_s = (float(hibernate_idle_s)
                                 if hibernate_idle_s is not None else None)
        self.hibernate = self.hibernate_idle_s is not None
        self.swap_quantize = bool(swap_quantize)
        self.state_dir = str(state_dir) if state_dir is not None else None
        # one store for both planes: process-local "swap-<n>" keys for
        # preempted lanes and content-addressed "hib-<digest>" keys for
        # hibernated prefixes, spilling to disk with a state_dir
        if self.preempt or self.hibernate:
            self._swap = TieredStateStore(
                int(swap_bytes), disk_dir=self.state_dir,
                disk_bytes=int(state_disk_bytes))
            if self.state_dir is not None:
                # a predecessor's swap keys can never restore in this
                # process; hibernated prefixes stay valid across restarts
                self._swap.gc("swap-")
        else:
            self._swap = None
        self._swap_seq = 0
        # idle-session tracking for hibernation: session_id -> the full
        # committed sequence and its last-activity stamp (LRU)
        self._hib_sessions: "collections.OrderedDict[str, Dict]" = (
            collections.OrderedDict())
        if brownout is None or brownout is False:
            self._pressure = None
        elif isinstance(brownout, PressureConfig):
            self._pressure = BrownoutLadder(brownout)
        else:
            self._pressure = BrownoutLadder()
        # None = tenancy off; a registry turns on the quota meter, WFQ
        # ordering and SLO-aware victim selection (mutated under _cond)
        self.tenants = TenantRegistry.coerce(tenants)
        # observed cadence of ladder updates (EWMA seconds): the base of
        # the Retry-After of a ladder shed and the floor of a quota 429
        # while the ladder is up
        self._pressure_tick_s = 0.05
        self._pressure_stamp: Optional[float] = None
        self._sessions: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict())
        self._session_capacity = 1024
        self._warm_req: Optional[threading.Event] = None
        self._slots = [_Slot() for _ in range(self.n_slots)]
        self._steps = 0
        self._width_dispatches: Dict[int, int] = {}
        self._span_pool = new_pool_id()

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

    def _ladder_retry_after_locked(self) -> float:
        """Retry-After of a ladder shed: `down_dwell` calm updates at the
        observed update cadence, the time the ladder needs to step
        down (the backlog estimate without a ladder)."""
        if self._pressure is None:
            return self._retry_after_locked()
        return max(0.1, self._pressure.config.down_dwell
                   * self._pressure_tick_s)

    def _build_request(self, prompt_ids, max_new_tokens: int,
                       temperature: float, seed: int,
                       deadline_s: Optional[float],
                       request_id: Optional[str] = None,
                       session_id: Optional[str] = None,
                       export: bool = False,
                       priority: Optional[str] = None,
                       tenant: Optional[str] = None) -> _LMRequest:
        """Validate and build one queue item, the shared front half of
        `generate`, `generate_stream`, `prefill_export` and
        `admit_with_pages`.  Export lanes are budgeted for their prefill
        pages only (they never decode here)."""
        if export:
            ids = validate_request(self.cfg, prompt_ids, max_new_tokens)
            if (self.kv == "paged"
                    and -(-len(ids) // self.page_size) > self.kv_pages):
                raise ValueError(
                    f"prompt needs {-(-len(ids) // self.page_size)} "
                    f"prefill pages (page_size {self.page_size}) but "
                    f"the pool holds {self.kv_pages}; raise -lm-pages "
                    f"or shorten it")
        else:
            ids = self.validate(prompt_ids, max_new_tokens)
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        seed = int(seed) & 0x7FFFFFFF
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        if request_id is None and self.tracer is not None:
            request_id = new_request_id()
        req = _LMRequest(ids, int(max_new_tokens), float(temperature), seed,
                         request_id=request_id)
        if deadline_s is not None:
            req.deadline = req.enqueued + float(deadline_s)
        req.session_id = (str(session_id) if session_id is not None
                          else None)
        req.export = bool(export)
        req.priority = normalize_priority(priority)
        req.rank = PRIORITY_RANK[req.priority]
        # None is the default tenant; without a registry any other
        # tenant is unknown by definition
        if self.tenants is not None:
            req.tenant = self.tenants.normalize(tenant)
        elif tenant is not None and str(tenant) != DEFAULT_TENANT:
            raise ValueError(
                f"unknown tenant {str(tenant)!r}: no tenant registry "
                f"is installed (serve -tenants, or "
                f"ContinuousLMServer(tenants=...))")
        return req

    def _record_tenant(self, event: str, req: _LMRequest) -> None:
        """Per-tenant accounting, kept only with a tenant registry."""
        if self.tenants is not None:
            self.metrics.record_tenant(event, req.tenant)

    def _enqueue(self, req: _LMRequest) -> None:
        """Admission under the pool lock, in this order: the tenant's
        quota (the client's budget, charged before the server's
        capacity, so a flooding tenant's refusals never take the queue
        bound), the ladder's level-4 shed of a best_effort request
        (spared for a compliant tenant while an offender exists), the
        shared gate (draining, breaker, queue bound), then worker start,
        sticky-session accounting, the WFQ stamp and the ordered
        insert."""
        with self._cond:
            if self._accepting and self.tenants is not None:
                try:
                    self.tenants.meter.charge(req.tenant, req.cost)
                except TenantQuotaError as e:
                    self.metrics.record_rejected()
                    self.metrics.record_class("rejected", req.priority)
                    self.metrics.record_tenant("rejected", req.tenant)
                    self.metrics.record_tenant("throttled", req.tenant)
                    # while the ladder is up, tokens refilling sooner
                    # than the pool recovers would invite the flood back
                    if (self._pressure is not None
                            and self._pressure.level > 0):
                        e.retry_after_s = max(
                            e.retry_after_s,
                            self._ladder_retry_after_locked())
                    raise
            if (self._accepting and self._pressure is not None
                    and self._pressure.level >= 4
                    and req.rank >= RANK_BEST_EFFORT
                    and not (self.tenants is not None
                             and self.tenants.compliant(req.tenant)
                             and self.tenants.any_offender())):
                self.metrics.record_rejected()
                self.metrics.record_class("rejected", req.priority)
                self._record_tenant("rejected", req)
                self.metrics.record_brownout_shed()
                raise ServingOverloadError(
                    "brownout level 4: best_effort admission shed "
                    "while the KV pool recovers",
                    retry_after_s=self._ladder_retry_after_locked())
            try:
                check_admission(
                    accepting=self._accepting, breaker=self.breaker,
                    queue_depth=len(self._queue),
                    max_queue_depth=self.max_queue_depth,
                    metrics=self.metrics,
                    retry_after_s=self._retry_after_locked, what="LM")
            except ServingError:
                self.metrics.record_class("rejected", req.priority)
                self._record_tenant("rejected", req)
                raise
            if not self._running:
                self._start_locked()
            if req.session_id is not None:
                self._note_session_locked(req.session_id)
            if self.tenants is not None:
                # stamped once: a preempted request re-inserts with its
                # original vft, as it keeps its enqueue stamp
                req.vft = self.tenants.wfq.stamp(req.tenant, req.cost)
            self._queue_insert_locked(req)
            self.metrics.set_queue_depth(len(self._queue))
            self._cond.notify_all()

    def _queue_insert_locked(self, req: _LMRequest) -> None:
        """Insert keeping the queue sorted by (rank, vft, enqueued): the
        head is the most important request, weighted-fairly across
        tenants within a class, oldest first on ties.  Without a
        registry every vft is 0.0, and with one tenant the vfts rise in
        arrival order, so one class of one tenant is FIFO.  A preempted
        request re-inserts with its original stamps, ahead of later
        arrivals of its class and tenant."""
        key = (req.rank, req.vft, req.enqueued)
        i = len(self._queue)
        while i > 0:
            prev = self._queue[i - 1]
            if (prev.rank, prev.vft, prev.enqueued) <= key:
                break
            i -= 1
        self._queue.insert(i, req)

    def _note_session_locked(self, session_id: str) -> None:
        """Sticky-session accounting: a session_id this pool served
        before is an affinity hit.  Bounded LRU."""
        hit = session_id in self._sessions
        if hit:
            self._sessions.move_to_end(session_id)
        else:
            self._sessions[session_id] = 1
            while len(self._sessions) > self._session_capacity:
                self._sessions.popitem(last=False)
        self.metrics.record_session(hit)

    def _cancel_request(self, req: _LMRequest, status: str) -> None:
        """Give up on an unresolved request (client timeout or stream
        disconnect).  A queued request is removed (with its swap bytes);
        one already in a slot is marked abandoned and the worker frees
        the slot at its next admit round (slot state is written by the
        worker thread only).  `status` names the trace's outcome."""
        now = time.perf_counter()
        with self._cond:
            try:
                self._queue.remove(req)
                self.metrics.set_queue_depth(len(self._queue))
                self.metrics.record_shed()
                self.metrics.record_class("shed", req.priority)
                self._record_tenant("shed", req)
                self._drop_swap_locked(req)
            except ValueError:
                req.abandoned = True
            resolved_with_error = (req.event.is_set()
                                   and req.error is not None)
        if (req.deadline is not None and now >= req.deadline
                and not resolved_with_error):
            self.metrics.record_deadline_missed()
            self.metrics.record_class("deadline_missed", req.priority)
            self._record_tenant("deadline_missed", req)
        self._trace_request(req, time.perf_counter(), status)

    def _wait(self, req: _LMRequest, timeout: Optional[float]):
        if not req.event.wait(timeout):
            self._cancel_request(req, "timeout")
            raise DeadlineExceededError(
                f"LM request timed out after {timeout}s")
        done = time.perf_counter()
        if req.error is not None:
            self._trace_request(req, done, "error")
            raise req.error
        self._trace_request(req, done, "ok")
        return req.result

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 timeout: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 session_id: Optional[str] = None,
                 priority: Optional[str] = None,
                 tenant: Optional[str] = None) -> List[int]:
        """prompt ids -> full sequence (prompt + generated), blocking.

        `timeout` bounds the client's wait; `deadline_s` (default
        `default_deadline_s`) rides the queue item so the admitter sheds
        the request once it expires.  `request_id` names the request's
        trace (``X-Request-Id``); `session_id` feeds sticky-session
        accounting and hibernation; `priority` (interactive, batch,
        best_effort; default interactive) orders admission and marks the
        lane's preemption class.  `tenant` (default "default") names the
        registered tenant charged for the request."""
        req = self._build_request(prompt_ids, max_new_tokens, temperature,
                                  seed, deadline_s, request_id,
                                  session_id=session_id,
                                  priority=priority, tenant=tenant)
        self._enqueue(req)
        return self._wait(req, timeout)

    def generate_stream(self, prompt_ids, max_new_tokens: int,
                        temperature: float = 0.0, seed: int = 0,
                        timeout: Optional[float] = None,
                        deadline_s: Optional[float] = None,
                        request_id: Optional[str] = None,
                        session_id: Optional[str] = None,
                        priority: Optional[str] = None,
                        tenant: Optional[str] = None) -> Iterator[int]:
        """Streaming `generate`: admission happens here (typed errors
        raise before the first token), then the iterator yields each
        committed token as the worker folds it, a speculative round's
        commit one token at a time.  Closing the iterator mid-stream
        abandons the request, so its slot and pages free at the next
        admit round.  The full sequence is the prompt plus every
        yielded token."""
        req = self._build_request(prompt_ids, max_new_tokens, temperature,
                                  seed, deadline_s, request_id,
                                  session_id=session_id,
                                  priority=priority, tenant=tenant)
        req.stream = _queue.SimpleQueue()
        self._enqueue(req)
        return self._stream_tokens(req, timeout)

    def _stream_tokens(self, req: _LMRequest,
                       timeout: Optional[float]) -> Iterator[int]:
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        cancelled = False
        try:
            while True:
                wait = 0.05
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        cancelled = True
                        self._cancel_request(req, "timeout")
                        raise DeadlineExceededError(
                            f"LM stream timed out after {timeout}s")
                    wait = min(wait, remaining)
                try:
                    yield int(req.stream.get(timeout=wait))
                    continue
                except _queue.Empty:
                    pass
                if req.event.is_set():
                    # tokens are pushed before the event is set (by the
                    # worker thread), so one final drain empties the
                    # queue in order
                    while True:
                        try:
                            yield int(req.stream.get_nowait())
                        except _queue.Empty:
                            break
                    if req.error is not None:
                        self._trace_request(req, time.perf_counter(),
                                            "error")
                        raise req.error
                    self._trace_request(req, time.perf_counter(), "ok")
                    return
        finally:
            if not cancelled and not req.event.is_set():
                # the consumer went away mid-stream: abandon, so the
                # slot and its pages stop decoding for nobody (the
                # timeout branch already cancelled once)
                self._cancel_request(req, "disconnect")

    # ---- disaggregation: KV page export / import --------------------------

    def _require_ship(self, what: str) -> None:
        if self.kv != "paged":
            raise ValueError(
                f"page {what} requires kv='paged': shipping moves "
                f"block-table pages (got kv={self.kv!r})")
        if not self.ship:
            raise ValueError(
                f"page {what} requested but the pool was started with "
                f"ship=False (serve with -lm-ship, or "
                f"ContinuousLMServer(ship=True))")

    def prefill_export(self, prompt_ids, max_new_tokens: int,
                       temperature: float = 0.0, seed: int = 0,
                       timeout: Optional[float] = None,
                       deadline_s: Optional[float] = None,
                       request_id: Optional[str] = None,
                       session_id: Optional[str] = None,
                       priority: Optional[str] = None,
                       tenant: Optional[str] = None) -> PageExport:
        """The prefill half of disaggregation: the prompt goes through
        normal admission (radix reuse, chunked prefill, copy-on-write),
        and the request resolves at prefill completion with the lane's
        `PageExport`: its prompt pages and the first committed token.
        The whole request contract is validated here, so a doomed
        request fails before any bytes move.  The frame carries the
        request's tenant."""
        self._require_ship("export")
        req = self._build_request(prompt_ids, max_new_tokens, temperature,
                                  seed, deadline_s, request_id,
                                  session_id=session_id, export=True,
                                  priority=priority, tenant=tenant)
        self._enqueue(req)
        self._wait(req, timeout)
        return req.export_result

    def admit_with_pages(self, export: PageExport,
                         timeout: Optional[float] = None,
                         deadline_s: Optional[float] = None,
                         request_id: Optional[str] = None) -> List[int]:
        """The decode half: check the shipment's geometry against this
        pool (`PageShipError` on any mismatch: recompute locally),
        allocate the lane's page budget, install the shipped pages in one
        call and join mid-flight like a chunked-prefill completion.  The
        frame's tenant is charged and validated as a request's.  Returns
        the full sequence."""
        self._require_ship("import")
        check_compatible(export, self.cfg, self.page_size)
        if export.quantized and not self.swap_quantize:
            raise PageShipError(
                "shipment is int8-quantized but this pool runs "
                "swap_quantize=off: refusing a lossy install on an "
                "exact-bytes pool (recompute locally instead)")
        if len(export.committed) >= export.max_new:
            # the prefill pool's first sample filled the whole budget:
            # answer without occupying a slot, still a served request in
            # every ledger
            priority = normalize_priority(export.priority)
            tenant = (self.tenants.normalize(export.tenant)
                      if self.tenants is not None else DEFAULT_TENANT)
            with self._cond:
                if export.session_id is not None:
                    self._note_session_locked(export.session_id)
            self.metrics.record_request(0.0)
            self.metrics.record_first_token(0.0)
            self.metrics.record_class("requests", priority)
            if self.tenants is not None:
                self.metrics.record_tenant("requests", tenant)
            return (list(export.prompt)
                    + list(export.committed[:export.max_new]))
        req = self._build_request(export.prompt, export.max_new,
                                  export.temperature, export.seed,
                                  deadline_s, request_id,
                                  session_id=export.session_id,
                                  priority=export.priority,
                                  tenant=export.tenant)
        req.import_pages = export
        self._enqueue(req)
        return self._wait(req, timeout)

    def _trace_request(self, req: _LMRequest, done: float,
                       status: str) -> None:
        """The request's trace: queue_wait (admission to slot install),
        then decode (install to completion), plus an ``xla_compile`` span
        for each program built inside the decode window."""
        if self.tracer is None:
            return
        spans = []
        t_in = req.t_installed if req.t_installed is not None else done
        spans.append(span("queue_wait", req.enqueued, t_in))
        if req.t_installed is not None:
            t_done = req.t_done if req.t_done is not None else done
            spans.append(span(
                "decode", req.t_installed, t_done,
                prompt_tokens=len(req.prompt),
                generated=(len(req.result) - len(req.prompt)
                           if req.result else 0),
                prefix_matched=req.prefix_matched or None,
                drafted=req.drafted or None,
                accepted=(req.accepted if req.drafted else None),
                preempted=req.preempted or None,
                swap_error=req.swap_error))
            if self._compile_watch.any_since(req.t_installed):
                for c_end, c_dur, key in (self._compile_watch
                                          .events_between(req.t_installed,
                                                          t_done)):
                    spans.append(span("xla_compile", c_end - c_dur,
                                      c_end, program_key=key))
        self.tracer.record(trace(
            req.request_id or new_request_id(), "lm", spans,
            status=status, prompt_tokens=len(req.prompt),
            error=(str(req.error) if req.error is not None else None)))

    def warmup(self, timeout: Optional[float] = 600.0) -> int:
        """Start the worker and build every program before traffic: one
        dispatch of every width, the page copy, the gather and install
        pair and the model drafter's step (on the card each captures its
        CUDA graph).  Afterwards no request builds a program.  The paged
        warm dispatches feed nothing (n_feed = 0), so they write only the
        null page; the dense one waits for an idle pool.  Returns
        `compiled_programs()`, 0 if the warm did not run within
        `timeout`."""
        with self._cond:
            if not self._running:
                self._start_locked()
            ev = self._warm_req
            if ev is None:
                ev = self._warm_req = threading.Event()
            self._cond.notify_all()
        if not ev.wait(timeout):
            return 0
        return self.compiled_programs()

    def compiled_programs(self) -> int:
        """The pool's programs, counted as the JAX package counts its
        compiled ones: the dense step alone, or the 1-wide step, the wide
        one (prefill chunk or verify) when it exists, the page copy, the
        gather and install pair of the mobility planes and the drafter's
        programs."""
        if self.kv == "dense":
            return 1
        ship = 2 if (self.ship or self.preempt or self.hibernate) else 0
        if self.speculate != "off":
            drafter = (self._drafter.compiled_programs()
                       if self._drafter is not None
                       and hasattr(self._drafter, "compiled_programs")
                       else 0)
            return 3 + drafter + ship
        return 2 + (1 if self.prefill_chunk > 1 else 0) + ship

    def _widths(self) -> List[int]:
        """The paged dispatch widths: 1, and the wide program's (the
        prefill chunk, or `spec_width` with speculation) above 1."""
        return [1] + ([self._wide] if self._wide > 1 else [])

    def _warm_programs(self) -> None:
        zi = np.zeros((self.n_slots,), np.int32)
        zf = np.zeros((self.n_slots,), np.float32)
        if self.kv == "dense":
            with compile_scope("lm:dense"):
                _, k, v = self._step(self.params, *self._cache, zi, zi, zf,
                                     zi, zi)
            self._cache = (k, v)
        else:
            table = np.zeros((self.n_slots, self.max_pages), np.int32)
            for w in self._widths():
                tok = np.zeros((self.n_slots, w), np.int32)
                with compile_scope(f"lm:paged[w{w}]"):
                    _, _, k, v = self._step(self.params, *self._cache,
                                            table, zi, zi, zi, tok, zf, zi,
                                            zi)
                self._cache = (k, v)
            with compile_scope("lm:page_copy"):
                self._cache = self._copy(*self._cache, 0, 0)
            if hasattr(self._drafter, "warmup"):
                self._drafter.warmup()
            if self._gather is not None:
                # a gather of the null page and an n = 0 install, which
                # writes only the null page
                zrow = np.zeros((self.max_pages,), np.int32)
                with compile_scope("lm:page_gather"):
                    pk, pv = self._gather(*self._cache, zrow)
                with compile_scope("lm:page_install"):
                    self._cache = self._install(*self._cache, pk[:, :1],
                                                pv[:, :1], zrow, 0)
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
            self.metrics.record_class("shed", req.priority)
            self._record_tenant("shed", req)
            req.error = ServingUnavailableError("LM server stopped")
            req.event.set()

    # ---- drain lifecycle --------------------------------------------------

    @property
    def accepting(self) -> bool:
        """False once draining — the /readyz signal."""
        with self._cond:
            return self._accepting

    def ready(self) -> bool:
        """Readiness: accepting admissions and the breaker not open."""
        if not self.accepting:
            return False
        return self.breaker is None or self.breaker.state != "open"

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
                    "ship": self.ship,
                    "paged_kernel": self.device.type == "cuda"})
            if self._sessions:
                out["sessions_tracked"] = len(self._sessions)
            out["kv"] = kv
            if self.preempt or self._pressure is not None:
                pres: Dict = {"preempt": self.preempt}
                if self._swap is not None:
                    pres["swap"] = self._swap.stats()
                if self._pressure is not None:
                    pres["brownout"] = self._pressure.stats()
                out["pressure"] = pres
            if self.hibernate and self._swap is not None:
                out["hibernation"] = {
                    "idle_s": self.hibernate_idle_s,
                    "quantize": self.swap_quantize,
                    "disk": self.state_dir,
                    "tracked_sessions": len(self._hib_sessions),
                    "store": self._swap.stats()}
            if self.tenants is not None:
                out["tenancy"] = self.tenants.stats()
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
        out["compiled_programs"] = self.compiled_programs()
        # programs built under the pool's scopes (process-wide, as the
        # JAX package's count of XLA compiles)
        out["compiles_total"] = self._compile_watch.total(prefix="lm:")
        return out

    # ---- worker side ------------------------------------------------------

    def _reset_cache(self) -> None:
        """Allocate the device cache at start; after a failed dispatch left
        its in-place contents untrusted, zero it IN PLACE: the programs
        hold the pool tensors by address, so a new allocation would have
        every program built again.  Allocated once, never per request."""
        self._cache_stale = False
        if self._cache is not None:
            for t in self._cache:
                t.zero_()
            return
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
        # installs waiting for a dispatch referenced pages of the old
        # pool: their lanes restart or fail with it
        self._pending_install = []
        for s in self._slots:
            s.table = None
            s.owned = []
            s.shared = []
            s.inserted = False
        if self._drafter is not None:
            self._drafter.reset()
        if self._swap is not None:
            # swapped lanes take the recompute-from-prompt path after a
            # reset; hibernated prefixes ("hib-") stay valid, since their
            # KV is a function of their tokens
            self._swap.clear("swap-")
        self._hib_sessions.clear()
        self.metrics.set_pages(0, self.kv_pages, self.kv_pages)

    def _start_locked(self) -> None:
        if self._step is None:
            self._graph_pool = new_pool(self.device)
            if self.kv == "dense":
                self._step = make_slot_step(self.cfg, self._graph_pool)
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
        intercept each dispatch.  The 1-wide program is the decode head;
        the wide one verifies with speculation (`spec_verify_step`) and is
        the decode head without it, as the JAX package's programs."""
        total = self.kv_pages + 1
        pool = self._graph_pool
        self._copy = make_page_copy(self.cfg, total, self.page_size, pool)
        if self.ship or self.preempt or self.hibernate:
            self._gather = make_page_gather(self.cfg, total, self.page_size,
                                            pool)
            self._install = make_page_install(self.cfg, total,
                                              self.page_size, pool)
        programs = {w: make_spec_step(
            self.cfg, total, self.page_size, w,
            verify=w > 1 and self.speculate != "off", pool=pool)
            for w in self._widths()}
        if self.speculate != "off" and self._drafter is None:
            self._drafter = make_drafter(
                self.speculate, self.cfg, self.params, self.n_slots,
                draft_model=self._draft_model, device=self.device,
                pool=pool)

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

    def _resolve_swap_locked(self, req: _LMRequest) -> None:
        """Turn a requeued victim's swap key into an installable
        shipment.  A blob that was evicted (`SwapEvictedError`) or fails
        the frame's checks (`PageShipError`) is counted and stamped on
        the request, and the lane recomputes from its prompt instead."""
        key, req.swap_key = req.swap_key, None
        try:
            blob = self._swap.take(key)
        except SwapEvictedError as e:
            self.metrics.record_swap_lost("evicted")
            req.swap_error = f"{type(e).__name__}: {e}"
            return
        try:
            ex = deserialize_export(blob)
            check_compatible(ex, self.cfg, self.page_size,
                             mid_decode=True)
            if ex.quantized and not self.swap_quantize:
                raise PageShipError(
                    "swapped frame is int8-quantized but this pool "
                    "runs swap_quantize=off: refusing a lossy restore "
                    "on an exact-bytes pool")
        except PageShipError as e:
            self.metrics.record_swap_lost("corrupt")
            req.swap_error = f"{type(e).__name__}: {e}"
            return
        req.import_pages = ex
        req.swap_restore = True

    def _alloc_locked(self, need: int) -> Optional[List[int]]:
        """`need` fresh pages, evicting cached prefixes first only when
        eviction can cover the shortfall (wiping the cache while still
        admitting nothing would destroy the hit rate for nothing)."""
        if self._pool.free < need:
            if self._pool.free + self._tree.evictable() >= need:
                self._tree.evict(need)
        return self._pool.alloc(need)

    def _plan_admission_paged(self, req: _LMRequest):
        """Radix match, then evict, then alloc for one queued request.
        Returns the install plan, or None when the pool (after eviction)
        cannot supply the fresh pages — the request stays queued.  Every
        page the plan references is already retained."""
        plen = len(req.prompt)
        if req.swap_key is not None and self._swap is not None:
            self._resolve_swap_locked(req)
        if req.import_pages is not None:
            # a shipped-in or restored lane: full prefix pages this
            # pool's radix tree holds are reused instead of installed
            # again (no plen - 1 cap: nothing is re-fed); a partial
            # match is skipped, the shipped copy is cheaper
            total_pages = self._required_pages(plen, req.max_new)
            full, partial = self._tree.match(req.prompt)
            if partial is not None:
                self._pool.release([partial[0]])
            fresh = self._alloc_locked(total_pages - len(full))
            if fresh is None:
                if full:
                    self._pool.release(full)
                return None
            return {"full": full, "partial": None, "fresh": fresh,
                    "matched": len(full) * self.page_size,
                    "total_pages": total_pages}
        # export lanes (prefill only) budget just their prompt pages
        total_pages = (-(-plen // self.page_size) if req.export
                       else self._required_pages(plen, req.max_new))
        # cap reuse at plen-1: the LAST prompt token is always re-fed —
        # its logits are what the first sampled token comes from
        full, partial = self._tree.match(req.prompt[:plen - 1])
        resume = None
        if self.hibernate and self._swap is not None:
            # a hibernated session's prefix may cover more pages than the
            # tree still holds
            resume = self._probe_hibernated_locked(req, len(full))
        if resume is not None and partial is not None:
            # the resumed frame covers the divergence page exactly
            self._pool.release([partial[0]])
            partial = None
        fresh = self._alloc_locked(total_pages - len(full))
        if fresh is None:
            if full:
                self._pool.release(full)
            if partial is not None:
                self._pool.release([partial[0]])
            if resume is not None:
                # keep the session's state until a lane can take it
                self._swap.put(resume["key"], resume["blob"])
            return None
        if resume is not None:
            return {"full": full, "partial": None, "fresh": fresh,
                    "matched": int(resume["n_hib"]) * self.page_size,
                    "total_pages": total_pages, "resume": resume}
        matched = len(full) * self.page_size + (partial[1]
                                                if partial else 0)
        return {"full": full, "partial": partial, "fresh": fresh,
                "matched": matched, "total_pages": total_pages}

    def _probe_hibernated_locked(self, req: _LMRequest,
                                 have: int) -> Optional[Dict]:
        """The longest hibernated whole-page prompt prefix beyond the
        `have` pages the radix tree matched -> its dequantized
        `PageExport` and bookkeeping, or None.  Deepest first, by
        content digest (a miss costs a digest per depth, no I/O).  A
        stored blob that is gone or fails its checks is counted and
        stamped on the request, and the probe goes on to shallower
        prefixes."""
        plen = len(req.prompt)
        for k in range((plen - 1) // self.page_size, have, -1):
            covered = [int(t) for t in req.prompt[:k * self.page_size]]
            key = prefix_key(covered)
            if key not in self._swap:
                continue
            try:
                blob = self._swap.take(key)
            except SwapEvictedError as e:
                self.metrics.record_hibernate_lost("evicted")
                req.swap_error = f"{type(e).__name__}: {e}"
                continue
            except PageShipError as e:
                self.metrics.record_hibernate_lost("corrupt")
                req.swap_error = f"{type(e).__name__}: {e}"
                continue
            try:
                ex = deserialize_export(blob)
                check_compatible(ex, self.cfg, self.page_size,
                                 prefix=True)
                if ex.quantized and not self.swap_quantize:
                    raise PageShipError(
                        "hibernated frame is int8-quantized but this "
                        "pool runs swap_quantize=off: refusing a lossy "
                        "resume on an exact-bytes pool")
                if ex.prompt != covered:
                    raise PageShipError(
                        "hibernated frame's tokens diverge from its "
                        "digest key: refusing to install foreign KV")
            except PageShipError as e:
                self.metrics.record_hibernate_lost("corrupt")
                req.swap_error = f"{type(e).__name__}: {e}"
                continue
            return {"ex": ex.dequantized(), "n_hib": k,
                    "nbytes": ex.nbytes(), "exact_nbytes": ex.exact_nbytes(),
                    "key": key, "blob": blob}
        return None

    def _install_paged_locked(self, slot: _Slot, req: _LMRequest,
                              plan) -> None:
        """Bind one admitted request to a lane.  Caller holds
        ``self._cond``."""
        slot.req = req
        req.t_installed = time.perf_counter()
        self._record_queue_span(req)
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
        if req.import_pages is not None:
            # a shipped-in or restored lane arrives where its frame left
            # it: prompt fed, tokens committed, the next write at pos.
            # The install runs before any feed of the next dispatch;
            # radix-matched rows go to the null page, so shared pages
            # other lanes read are never rewritten
            ex = req.import_pages
            wire_nbytes = ex.nbytes()     # what moved, before dequantizing
            ex = ex.dequantized()
            slot.fed = len(req.prompt)
            slot.pos = int(ex.pos)
            slot.generated = list(ex.committed)
            irow = row.copy()
            irow[:n_full] = 0
            self._pending_install.append(
                {"pk": ex.pages_k, "pv": ex.pages_v, "row": irow,
                 "n": ex.n_pages, "nbytes": wire_nbytes,
                 "swap": req.swap_restore})
            self.metrics.record_prefix_query(plan["matched"])
            n_full_prompt = len(req.prompt) // self.page_size
            if n_full_prompt:
                slot.inserted = True
                self._tree.insert(
                    req.prompt[:n_full_prompt * self.page_size],
                    [int(p) for p in row[:n_full_prompt]])
            # the committed tokens are this lane's first: TTFT here
            # measures the shipment's queue wait (a restored lane keeps
            # the stamp of its true first token)
            if req.t_first is None:
                req.t_first = req.t_installed
                self.metrics.record_first_token(req.t_first - req.enqueued)
            return
        res = plan.get("resume")
        if res is not None:
            # a hibernated session resuming: install its pages through
            # the same plane and register them in the tree, so the next
            # turn reuses them from the device
            ex, n_hib = res["ex"], int(res["n_hib"])
            irow = row.copy()
            irow[:n_full] = 0
            irow[n_hib:] = 0
            self._pending_install.append(
                {"pk": ex.pages_k, "pv": ex.pages_v, "row": irow,
                 "n": n_hib, "nbytes": res["nbytes"],
                 "exact_nbytes": res["exact_nbytes"], "hibernate": True})
            self._tree.insert(req.prompt[:n_hib * self.page_size],
                              [int(p) for p in row[:n_hib]])
        elif plan["partial"] is not None:
            # copy-on-write: the divergence page's matched tokens are
            # valid KV; copy it into this lane's first fresh page and
            # overwrite from the divergence offset.  The source stays
            # retained until the copy lands; the dispatch releases it.
            src, _ = plan["partial"]
            self._pending_cow.append({"src": int(src),
                                      "dst": int(plan["fresh"][0])})
        self.metrics.record_prefix_query(plan["matched"])

    def _admit_locked(self) -> None:
        """Queued prompts join free slots, in (priority, arrival) order.
        Doomed work is shed first: an abandoned request's slot and pages
        are freed, and an expired or abandoned queue item never occupies
        a slot.  The ladder reads the pool, idle sessions hibernate,
        then when the head's pages cannot be supplied even after
        eviction, admission preempts the lowest-priority lane it
        outranks before it waits (head of line: smaller later requests
        never starve it)."""
        for slot in self._slots:
            if slot.active and slot.req.abandoned:
                self.metrics.record_shed()
                self.metrics.record_class("shed", slot.req.priority)
                self._record_tenant("shed", slot.req)
                self._free_slot_pages(slot)
                slot.req = None
        now = time.perf_counter()
        kept, shed = collections.deque(), 0
        for req in self._queue:
            if req.abandoned:
                shed += 1
                self.metrics.record_class("shed", req.priority)
                self._record_tenant("shed", req)
                self._drop_swap_locked(req)
            elif req.deadline is not None and now >= req.deadline:
                shed += 1
                self.metrics.record_deadline_missed()
                self.metrics.record_class("shed", req.priority)
                self.metrics.record_class("deadline_missed", req.priority)
                self._record_tenant("shed", req)
                self._record_tenant("deadline_missed", req)
                self._drop_swap_locked(req)
                req.error = DeadlineExceededError(
                    f"deadline exceeded after {now - req.enqueued:.3f}s "
                    f"in LM queue; shed before decode")
                req.event.set()
            else:
                kept.append(req)
        if shed:
            self._queue = kept
            self.metrics.record_shed(shed)
        self._update_pressure_locked()
        self._hibernate_idle_locked(now)
        for slot in self._slots:
            if not self._queue:
                break
            if slot.active:
                continue
            if self.kv == "dense":
                slot.req = self._queue.popleft()
                self._advance_wfq_locked(slot.req)
                slot.req.t_installed = time.perf_counter()
                self._record_queue_span(slot.req)
                slot.pos = 0
                slot.fed = 0
                slot.generated = []
                continue
            head = self._queue[0]
            plan = self._plan_admission_paged(head)
            while plan is None and self._preempt_one_locked(head):
                plan = self._plan_admission_paged(head)
            if plan is None:
                break              # head-of-line waits for pages
            req = self._queue.popleft()
            self._advance_wfq_locked(req)
            self._install_paged_locked(slot, req, plan)
        self.metrics.set_queue_depth(len(self._queue))
        if self._pool is not None:
            self.metrics.set_pages(self._pool.in_use, self._pool.free,
                                   self.kv_pages)

    def _record_queue_span(self, req: _LMRequest) -> None:
        record_span("serve.queue", round(req.enqueued * 1e9),
                    round(req.t_installed * 1e9),
                    counts=(self._span_pool,), tag=req.request_id)

    def _record_round(self, marks, t_launch: int, t_wait: int,
                      t_commit: int, counts: tuple) -> None:
        """The round's span and its phases, back to back: `marks` holds
        the round's start, the pool lock's acquisition and the end of
        admission."""
        t_round, t_locked, t_stage = marks
        t_end = time.perf_counter_ns()
        sid = new_span_id()
        admit = new_span_id()
        record_span("serve.lock", t_round, t_locked, 0, admit)
        record_span("serve.admit", t_round, t_stage, admit, sid)
        record_span("serve.stage", t_stage, t_launch, 0, sid)
        record_span("serve.launch", t_launch, t_wait, 0, sid)
        record_span("serve.wait", t_wait, t_commit, 0, sid)
        record_span("serve.commit", t_commit, t_end, 0, sid)
        record_span("serve.round", t_round, t_end, sid, 0,
                    (self._span_pool,) + counts)

    def _advance_wfq_locked(self, req: _LMRequest) -> None:
        """Move the WFQ virtual clock as a request takes a lane, so an
        idle tenant re-enters at the current virtual time."""
        if self.tenants is not None:
            self.tenants.wfq.advance(req.vft)

    def _gather_pages(self, table: np.ndarray, n: int):
        """The first `n` pages of a block-table row, gathered out of the
        pool into host tensors ``[L, n, ps, H, K]``."""
        with compile_scope("lm:page_gather"):
            pk, pv = self._gather(*self._cache, table)
        return pk[:, :n].cpu(), pv[:, :n].cpu()

    def _hibernate_idle_locked(self, now: float) -> None:
        """Park idle sticky sessions' cached pages on the tiered store:
        the radix-cached chain of a session idle for `hibernate_idle_s`
        is gathered, (optionally) quantized, framed and stored under its
        content digest, and the tree's hold on the pages is dropped."""
        if (not self.hibernate or self._swap is None
                or self._gather is None or self._cache is None
                or self._tree is None or not self._hib_sessions):
            return
        idle = [sid for sid, meta in self._hib_sessions.items()
                if now - meta["t"] >= self.hibernate_idle_s]
        for sid in idle:
            tokens = self._hib_sessions.pop(sid)["tokens"]
            # only positions before the final sampled token have KV
            n_full = (len(tokens) - 1) // self.page_size
            if n_full == 0:
                continue
            covered = [int(t) for t in tokens[:n_full * self.page_size]]
            full, partial = self._tree.match(covered)
            if partial is not None:
                self._pool.release([partial[0]])
            if len(full) != n_full:
                # the tree already evicted part of the chain: nothing
                # whole to park; what remains keeps serving radix hits
                if full:
                    self._pool.release(full)
                continue
            row = np.zeros((self.max_pages,), np.int32)
            row[:n_full] = full
            pk, pv = self._gather_pages(row, n_full)
            ex = PageExport(
                prompt=covered, max_new=1, temperature=0.0, seed=0,
                committed=[], pos=n_full * self.page_size,
                page_size=self.page_size, pages_k=pk, pages_v=pv,
                model=model_signature(self.cfg, self.page_size),
                session_id=sid)
            exact = ex.exact_nbytes()
            if self.swap_quantize:
                ex = quantize_export(ex)
            stored = self._swap.put(prefix_key(covered),
                                    serialize_export(ex))
            self._pool.release(full)
            if stored is None:
                # the blob alone exceeds the host cap: nothing parked,
                # the pages stay in the tree
                continue
            for lost in stored:
                # a hibernated prefix pushed off the capped tiers is
                # counted now: a resume probe sees a plain miss
                if lost.startswith("hib-"):
                    self.metrics.record_hibernate_lost("evicted")
            self.metrics.record_hibernate("out", n_full, ex.nbytes(), exact)
            self._tree.forget(covered)

    def _drop_swap_locked(self, req: _LMRequest) -> None:
        """A shed or abandoned queue item releases its host swap bytes."""
        if req.swap_key is not None and self._swap is not None:
            self._swap.discard(req.swap_key)
            req.swap_key = None

    def _update_pressure_locked(self) -> None:
        """One ladder reading per admission round (pages free, counting
        evictable cached pages, and queue depth); every transition is
        counted.  From level 3 best_effort lanes are preempted whenever
        strictly higher-class work waits."""
        if self._pressure is None or self._pool is None:
            return
        now = time.perf_counter()
        if self._pressure_stamp is not None:
            dt = now - self._pressure_stamp
            if 0.0 < dt < 5.0:
                self._pressure_tick_s = (0.8 * self._pressure_tick_s
                                         + 0.2 * dt)
        self._pressure_stamp = now
        # a warm prefix cache is reclaimable capacity, not pressure; the
        # tree walk is skipped where free pages alone clear every bound
        cfg = self._pressure.config
        avail = self._pool.free
        if (self._tree is not None
                and avail / max(1, self.kv_pages)
                <= cfg.enter_free_frac[0] + cfg.exit_free_margin):
            avail += self._tree.evictable()
        moves = self._pressure.update(avail, self.kv_pages,
                                      len(self._queue), self.n_slots)
        self.metrics.record_brownout(self._pressure.level, len(moves))
        if (self._pressure.level >= 3 and self.preempt and self._queue
                and self._queue[0].rank < RANK_BEST_EFFORT):
            head_rank = self._queue[0].rank
            victims = [s for s in self._slots
                       if (s.active and not s.req.abandoned
                           and s.req.rank >= RANK_BEST_EFFORT
                           and s.req.rank > head_rank)]
            if (self.tenants is not None
                    and any(not self.tenants.compliant(s.req.tenant)
                            for s in victims)):
                # offender first: while a non-compliant tenant holds a
                # candidate lane, only its lanes are preempted
                victims = [s for s in victims
                           if not self.tenants.compliant(s.req.tenant)]
            for slot in victims:
                self._preempt_slot_locked(slot)

    def _preempt_one_locked(self, head: _LMRequest) -> bool:
        """Preempt one lane so `head` can admit: the active lane of the
        worst rank strictly above the head's, the newest first among
        equals; with a tenant registry the worst-behaved tenant
        (`TenantRegistry.badness`) pays first, so an offender's lane goes
        before a compliant tenant's.  False when preemption is off, the
        programs are not built yet, or nothing outranked is running."""
        if not self.preempt or self._gather is None or self._cache is None:
            return False
        victims = [s for s in self._slots
                   if s.active and not s.req.abandoned
                   and s.req.rank > head.rank]
        if not victims:
            return False
        if self.tenants is not None:
            victim = max(victims,
                         key=lambda s: (self.tenants.badness(s.req.tenant),
                                        s.req.rank, s.req.enqueued))
        else:
            victim = max(victims,
                         key=lambda s: (s.req.rank, s.req.enqueued))
        self._preempt_slot_locked(victim)
        return True

    def _preempt_slot_locked(self, slot: _Slot) -> None:
        """Evict one active lane for higher-priority work.  A lane
        mid-decode swaps its pages out to the host store (a gather, then
        the shipping frame); one still in prefill, or an export lane,
        just requeues and prefills again (cached prefix pages make that
        cheap).  The request keeps its enqueue stamp."""
        req = slot.req
        mid_decode = (slot.fed >= len(req.prompt) and slot.generated
                      and not req.export)
        if (mid_decode and self._swap is not None
                and self._gather is not None and self._cache is not None):
            n = -(-slot.pos // self.page_size)
            pk, pv = self._gather_pages(slot.table, n)
            ex = PageExport(
                prompt=list(req.prompt), max_new=req.max_new,
                temperature=req.temperature, seed=req.seed,
                committed=list(slot.generated), pos=int(slot.pos),
                page_size=self.page_size, pages_k=pk, pages_v=pv,
                model=model_signature(self.cfg, self.page_size),
                session_id=req.session_id, priority=req.priority,
                tenant=req.tenant)
            if self.swap_quantize:
                ex = quantize_export(ex)
            key = f"swap-{self._swap_seq}"
            self._swap_seq += 1
            if self._swap.put(key, serialize_export(ex)) is None:
                # the blob alone exceeds the cap: recompute on re-admission
                # rather than wipe every other victim
                self.metrics.record_swap_lost("evicted")
            else:
                req.swap_key = key
                self.metrics.record_swap("out", n, ex.nbytes())
        req.preempted += 1
        self.metrics.record_preemption(req.priority)
        self._record_tenant("preempted", req)
        self._free_slot_pages(slot)
        slot.req = None
        slot.generated = []
        self._queue_insert_locked(req)
        self.metrics.set_queue_depth(len(self._queue))

    def _finish_slot(self, slot: _Slot) -> None:
        """Completion fold: resolve the client, free the lane and pages.
        With hibernation, a session's whole committed sequence enters the
        radix tree (only fully written pages: the final sample is never
        fed) and the session is stamped for the idle sweep."""
        req = slot.req
        if req.abandoned:
            # the client already got DeadlineExceededError: discarded work
            self.metrics.record_shed()
            self.metrics.record_class("shed", req.priority)
            self._record_tenant("shed", req)
        else:
            self.metrics.record_class("requests", req.priority)
            req.result = req.prompt + slot.generated
            now = time.perf_counter()
            req.t_done = now
            t_in = req.t_installed or now
            self.metrics.record_request(now - req.enqueued,
                                        queue_wait_s=t_in - req.enqueued,
                                        compute_s=now - t_in)
            if self.tenants is not None:
                # the tenant's completion ledger: served count, tokens
                # generated, and the SLO window behind its burn rate
                tn = req.tenant
                self.metrics.record_tenant("requests", tn)
                self.tenants.meter.record_out(tn, len(slot.generated))
                self.tenants.slo.record(tn, now - req.enqueued)
                self.metrics.set_tenant_burn(
                    tn, self.tenants.slo.burn_rate(tn))
            if (self.hibernate and req.session_id is not None
                    and self._tree is not None and slot.table is not None):
                n_full = (len(req.result) - 1) // self.page_size
                if n_full:
                    self._tree.insert(req.result[:n_full * self.page_size],
                                      [int(p) for p in slot.table[:n_full]])
                sid = req.session_id
                self._hib_sessions[sid] = {"tokens": list(req.result),
                                           "t": now}
                self._hib_sessions.move_to_end(sid)
                while len(self._hib_sessions) > self._session_capacity:
                    self._hib_sessions.popitem(last=False)
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
        """Fold committed tokens into a lane: the first-token stamp,
        the lane's generated list, and the request's stream, one push a
        token.  The stream cursor counts the tokens already pushed: a
        preempted lane that recomputes its early tokens (its swap was
        lost) stays below the cursor until it passes where the stream
        left off, so no token streams twice."""
        req = slot.req
        if req.t_first is None:
            req.t_first = time.perf_counter()
            self.metrics.record_first_token(req.t_first - req.enqueued)
        slot.generated.extend(int(t) for t in toks)
        if req.stream is not None and not req.abandoned:
            for t in slot.generated[req.stream_pushed:]:
                req.stream.put(int(t))
            req.stream_pushed = max(req.stream_pushed,
                                    len(slot.generated))

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
        if self._cache is None or self._cache_stale:
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
        t_round = time.perf_counter_ns()
        with self._cond:
            t_locked = time.perf_counter_ns()
            self._admit_locked()
            active = [s for s in self._slots if s.active]
            if not active:
                return False
            cow, self._pending_cow = self._pending_cow, []
            installs, self._pending_install = self._pending_install, []
            # the ladder moves only inside _admit_locked: one level a round
            level = (self._pressure.level if self._pressure is not None
                     else 0)
        marks = (t_round, t_locked, time.perf_counter_ns())
        if self.breaker is not None and not self.breaker.allow_dispatch():
            # open breaker: fail the lanes in flight fast rather than
            # spend dispatches on a failing device
            err = CircuitOpenError(
                "circuit breaker open: decode fast-failed",
                retry_after_s=self.breaker.retry_after_s())
            with self._cond:
                for item in cow:
                    # an unexecuted copy still retains its source page
                    self._pool.release([item["src"]])
                for s in self._slots:
                    if s.active:
                        self.metrics.record_shed()
                        self.metrics.record_class("shed", s.req.priority)
                        self._record_tenant("shed", s.req)
                        s.req.error = err
                        s.req.event.set()
                        self._free_slot_pages(s)
                        s.req = None
            return True
        if self.kv == "dense":
            return self._dispatch_dense(active, marks)
        return self._dispatch_paged(active, cow, installs, level, marks)

    def _dispatch_dense(self, active, marks) -> bool:
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
        t_launch = time.perf_counter_ns()
        with compile_scope("lm:dense"):
            nxt, k, v = self._step(self.params, *self._cache, pos, token,
                                   temp, seeds, counts)
        t_wait = time.perf_counter_ns()
        if self.breaker is not None:
            self.breaker.record_success()
        self._cache = (k, v)
        nxt = nxt.cpu().numpy()    # the round's one host sync
        t_commit = time.perf_counter_ns()
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
        # the dense cache has no pages; each lane's one column attends
        # over pos + 1 keys
        self._record_round(marks, t_launch, t_wait, t_commit,
                           (1, len(active), len(active), 0, 0,
                            int(pos.sum()) + len(active)))
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

    def _export_slot(self, slot: _Slot) -> None:
        """Prefill just completed on an export lane: gather its pages,
        resolve the request with the shipment and free the lane (the
        radix tree keeps the prompt pages for the next shared-prefix
        prefill)."""
        req = slot.req
        t0 = time.perf_counter()
        n = -(-slot.pos // self.page_size)
        pk, pv = self._gather_pages(slot.table, n)
        ex = PageExport(
            prompt=list(req.prompt), max_new=req.max_new,
            temperature=req.temperature, seed=req.seed,
            committed=list(slot.generated), pos=int(slot.pos),
            page_size=self.page_size, pages_k=pk, pages_v=pv,
            model=model_signature(self.cfg, self.page_size),
            session_id=req.session_id, priority=req.priority,
            tenant=req.tenant)
        self.metrics.record_ship("out", n, ex.nbytes(),
                                 time.perf_counter() - t0)
        req.export_result = ex
        self._finish_slot(slot)

    def _dispatch_paged(self, active, cow, installs, level: int,
                        marks) -> bool:
        # shipped, restored and resumed pages land first (their lanes'
        # next feed reads them), then the copy-on-write pages: a CoW
        # admitted in the same round may diverge from an installed page
        for item in installs:
            t0 = time.perf_counter()
            with compile_scope("lm:page_install"):
                self._cache = self._install(*self._cache, item["pk"],
                                            item["pv"], item["row"],
                                            item["n"])
            if item.get("swap"):
                self.metrics.record_swap("in", item["n"], item["nbytes"])
            elif item.get("hibernate"):
                self.metrics.record_hibernate("in", item["n"],
                                              item["nbytes"],
                                              item["exact_nbytes"])
            else:
                self.metrics.record_ship("in", item["n"], item["nbytes"],
                                         time.perf_counter() - t0)
        for item in cow:
            with compile_scope("lm:page_copy"):
                self._cache = self._copy(*self._cache, item["src"],
                                         item["dst"])
            self._pool.release([item["src"]])
        # the brownout ladder: level 1 turns speculation off, level 2
        # halves the prefill ride-along width
        drafts = (self._draft_proposals()
                  if self.speculate != "off" and level < 1 else {})
        chunk_eff = (max(1, self.prefill_chunk // 2) if level >= 2
                     else self.prefill_chunk)
        # the wide program dispatches only while some lane has a FULL
        # chunk of prompt left (or, with speculation, drafts to verify);
        # sub-chunk tails and pure-decode rounds ride the 1-wide program
        full_chunk = any(len(s.req.prompt) - s.fed >= chunk_eff
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
        ps = self.page_size
        kv_pages = pairs = 0
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            req = slot.req
            remaining = len(req.prompt) - slot.fed
            if remaining > 0:                  # chunked prefill
                f = min(remaining, width, chunk_eff)
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
            f, p = int(n_feed[i]), slot.pos
            kv_pages += -(-(p + f) // ps)
            pairs += f * p + f * (f + 1) // 2
        t_launch = time.perf_counter_ns()
        with compile_scope(f"lm:paged[w{width}]"):
            nxt, acc, k, v = self._step(self.params, *self._cache, table,
                                        pos, n_feed, n_draft, tokens, temp,
                                        seeds, counts)
        t_wait = time.perf_counter_ns()
        if self.breaker is not None:
            self.breaker.record_success()
        # the round's one host sync: next tokens and accepted counts
        both = torch.stack([nxt.to(torch.int32),
                            acc.to(torch.int32)]).cpu().numpy()
        t_commit = time.perf_counter_ns()
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
                if slot.req.export:
                    # this pool's job ends at prefill: ship the lane
                    self._export_slot(slot)
                    continue
            else:
                # commit the accepted drafts plus the bonus token; pos
                # moves past the committed feeds only, so a rejected
                # column's keys and values (in this lane's own pages)
                # stay masked until real writes land on them
                a = int(acc[i])
                k_drafted = int(n_draft[i])
                slot.pos += 1 + a
                slot.req.drafted += k_drafted
                slot.req.accepted += a if k_drafted else 0
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
        self._record_round(marks, t_launch, t_wait, t_commit,
                           (width, int(np.count_nonzero(n_feed)),
                            int(n_feed.sum()), kv_pages, ps, pairs))
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
                    if (self.hibernate and self._swap is not None
                            and self.state_dir is not None):
                        # a clean stop makes hibernation durable: the
                        # host tier (only "hib-" keys remain after the
                        # reset) goes to disk for the next server
                        self._swap.flush_to_disk()
                    if self._warm_req is not None:
                        self._warm_req.set()
                        self._warm_req = None
                    for r in victims:
                        self.metrics.record_shed()
                        self.metrics.record_class("shed", r.priority)
                        self._record_tenant("shed", r)
                        r.error = ServingUnavailableError(
                            "LM server stopped")
                        r.event.set()
                    return
            try:
                busy = self._drain_step()
            except Exception as e:  # noqa: BLE001 — fail in-flight, keep serving
                if self.breaker is not None:
                    self.breaker.record_failure()
                with self._cond:
                    for s in self._slots:
                        if s.active:
                            s.req.error = e
                            s.req.event.set()
                            s.req = None
                    # the failed dispatch may have written part of the
                    # pool in place: reset the host page state now and
                    # zero the device pool at the next round
                    self._reset_pool_locked()
                    self._cache_stale = True
                busy = True
            if not busy:
                with self._cond:
                    # a stop lands at the top of the loop, whose exit
                    # path resets the pool and makes hibernation durable
                    if (self._running and not self._queue
                            and self._warm_req is None):
                        self._cond.wait(0.05)
            else:
                time.sleep(0)  # yield: let submitters enqueue mid-decode


__all__ = ["ContinuousLMServer", "validate_request"]
