"""Dynamic micro-batching: coalesce concurrent requests into one dispatch
(counterpart of `deeplearning4j_tpu.serving.batcher`).

A request queue whose worker thread coalesces everything that arrives
within a short window (`max_wait_ms`, up to `max_batch` rows) into ONE
padded device dispatch, then slices the row-aligned results back per
request.  Stdlib and numpy only: the dispatch function owns the device.

Requests with different trailing shapes (e.g. different padded sequence
buckets) never share a dispatch: the worker groups the queue head with
same-shape followers and leaves the rest queued for the next cycle.

A request's rows come out of a coalesced dispatch as they would alone up
to the dense product's batch variance: neither cuBLAS nor XLA's CPU
product promises the same bits at another batch size, so replies agree
with a request's own dispatch to rounding, not bit for bit.

Resilience contract:

- admission is bounded — past `max_queue_depth` queued requests,
  `submit` raises `ServingOverloadError` (HTTP 503 + Retry-After)
  instead of queueing forever;
- deadlines are carried on queue items and already-expired work is shed
  *before* dispatch (`DeadlineExceededError`), so a timed-out client
  stops costing device time;
- a failed group dispatch is bisected (bounded depth, backoff between
  sub-dispatches) so exactly the poison request(s) fail and their
  co-batched neighbours are still answered; each isolated request is
  counted on ``serving_poison_isolated_total``;
- an optional `CircuitBreaker` fast-fails admission after N consecutive
  whole-dispatch failures and probes half-open after a cooldown;
- `begin_drain()`/`drain()` stop admission and let in-flight work finish
  within a grace window (the SIGTERM path of ``cli serve``).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.obs.compilewatch import compile_watcher
from deeplearning4j_tpu_torch.obs.trace import (
    TraceRecorder,
    new_request_id,
    span,
    trace,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    ServingError,
    ServingUnavailableError,
    check_admission,
)
from deeplearning4j_tpu_torch.serving.tenancy import (
    DEFAULT_TENANT,
    TenantQuotaError,
    TenantRegistry,
)


@dataclasses.dataclass(frozen=True)
class BisectPolicy:
    """Exponential backoff between bisection sub-dispatches: attempt k
    sleeps ``min(base_delay * multiplier**k, max_delay)`` (the fields of
    the JAX package's `RetryPolicy` that the batcher reads; no jitter)."""

    max_attempts: int = 8
    base_delay: float = 0.002
    multiplier: float = 2.0
    max_delay: float = 0.05


def backoff_delays(policy: BisectPolicy) -> Iterator[float]:
    """The ``max_attempts - 1`` sleep durations between attempts."""
    for k in range(policy.max_attempts - 1):
        yield min(policy.base_delay * policy.multiplier ** k,
                  policy.max_delay)


# Backoff between bisection sub-dispatches: short — the worker thread is
# the serving plane, so these sleeps are paid by every co-batched
# request still waiting on its slice.
_BISECT_POLICY = BisectPolicy()


def _build_serving_trace(raw):
    """Materialize one batcher trace from its hot-path tuple (the
    `TraceRecorder.record_lazy` builder — runs at /trace/recent read
    time, never on the request path)."""
    (rid, enqueued, t_start, t_end, done, status, rows, err,
     compiles, wall) = raw
    spans = [span("queue_wait", enqueued,
                  t_start if t_start is not None else done)]
    if t_start is not None:
        te = t_end if t_end is not None else done
        spans.append(span("dispatch", t_start, te, rows=rows))
        spans.append(span("respond", te, done))
        for c_end, c_dur, key in compiles or ():
            spans.append(span("xla_compile", c_end - c_dur, c_end,
                              program_key=key))
    out = trace(rid, "serving", spans, status=status, rows=rows,
                error=err)
    out["wall_time"] = wall
    return out


class _Pending:
    __slots__ = ("x", "mask", "event", "result", "error", "enqueued",
                 "deadline", "abandoned", "request_id", "t_start", "t_end",
                 "tenant")

    def __init__(self, x: np.ndarray, mask: Optional[np.ndarray],
                 deadline: Optional[float] = None,
                 request_id: Optional[str] = None):
        self.x = x
        self.mask = mask
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.enqueued = time.perf_counter()
        self.deadline = deadline   # absolute perf_counter time, or None
        self.abandoned = False     # client gave up waiting (timeout race)
        self.request_id = request_id   # X-Request-Id (tracing)
        self.t_start: Optional[float] = None  # dispatch start (worker)
        self.t_end: Optional[float] = None    # dispatch end (worker)
        self.tenant = DEFAULT_TENANT   # billing identity

    @property
    def key(self):
        """Dispatch-compatibility key: trailing shape + mask presence."""
        return (self.x.shape[1:], self.x.dtype.str,
                None if self.mask is None else self.mask.shape[1:])


class MicroBatcher:
    """Request queue + coalescing worker in front of a dispatch function.

    `dispatch(x, mask, n_real)` receives the stacked real rows (the
    callee pads to its bucket) and must return row-aligned outputs as a
    numpy array of at least `n_real` rows.  `submit()` blocks the
    calling thread until its slice of the result is ready and is safe to
    call from any number of threads.

    `max_queue_depth` bounds admission (None = unbounded); `default_deadline_s` applies a per-request deadline when
    the caller does not pass one; `breaker` (a `CircuitBreaker`) guards
    the dispatch path; `max_bisect_depth` bounds poison-isolation
    recursion (0 disables bisection).
    """

    def __init__(self, dispatch: Callable, max_batch: int = 32,
                 max_wait_ms: float = 2.0,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 max_bisect_depth: int = 6,
                 bisect_policy: BisectPolicy = _BISECT_POLICY,
                 tracer: Optional[TraceRecorder] = None,
                 tenants=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1 or None, got "
                             f"{max_queue_depth}")
        self._dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue_depth = max_queue_depth
        self.default_deadline_s = default_deadline_s
        self.breaker = breaker
        self.max_bisect_depth = int(max_bisect_depth)
        self.bisect_policy = bisect_policy
        # request tracing: None = tracing off.  The recorder is
        # bounded, and span assembly is a handful of dict builds per
        # request, made when /trace/recent is read.  The compile watcher
        # is resolved once, off the hot path.
        self.tracer = tracer
        self._compile_watch = (compile_watcher() if tracer is not None
                               else None)
        # multi-tenant admission gate: None = unmetered (the
        # historic single-tenant behavior, bit for bit)
        self.tenants = TenantRegistry.coerce(tenants)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        if breaker is not None:
            breaker.add_listener(self.metrics.set_breaker_state)
            self.metrics.set_breaker_state(breaker.state)
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._running = False
        self._accepting = True
        self._in_flight = 0
        self._thread: Optional[threading.Thread] = None

    # ---- client side ------------------------------------------------------

    def _retry_after_locked(self) -> float:
        """Retry-After hint for an admission rejection: roughly the time
        for the current backlog to clear (p50 latency per queued item,
        floored at the coalescing window)."""
        lat = self.metrics.latency.summary()
        per_item = (lat.get("p50_ms", 50.0) or 50.0) / 1e3
        return max(0.1, self.max_wait_s + per_item * len(self._queue))

    def submit(self, x: np.ndarray, mask: Optional[np.ndarray] = None,
               timeout: Optional[float] = None,
               deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               tenant: Optional[str] = None) -> np.ndarray:
        """Enqueue a [n, ...] request and block for its [n, ...] outputs.

        `timeout` bounds the *client's* wait; `deadline_s` (default
        `default_deadline_s`) is carried on the queue item so the worker
        sheds the request before dispatch once it expires — a client that
        has already given up must not cost device time.  `request_id`
        names the request's trace when a tracer is attached (one is
        minted otherwise).  `tenant` (default "default") is the billing
        identity: with a `TenantRegistry` installed the request is
        charged one quota token per row BEFORE the shared admission
        gate, so an over-quota tenant's refusal (`TenantQuotaError`,
        HTTP 429) never consumes the queue bound."""
        x = np.asarray(x)
        if x.ndim < 2 or x.shape[0] < 1:
            raise ValueError(f"request must be [n, ...] with n >= 1, got "
                             f"shape {x.shape}")
        if x.shape[0] > self.max_batch:
            raise ValueError(f"request rows ({x.shape[0]}) exceed max_batch "
                             f"({self.max_batch}); split the request")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        if request_id is None and self.tracer is not None:
            request_id = new_request_id()
        item = _Pending(x, None if mask is None else np.asarray(mask),
                        request_id=request_id)
        if self.tenants is not None:
            item.tenant = self.tenants.normalize(tenant)
        elif tenant is not None and str(tenant) != DEFAULT_TENANT:
            raise ValueError(
                f"unknown tenant {str(tenant)!r}: no tenant registry "
                f"is installed (serve -tenants, or "
                f"MicroBatcher(tenants=...))")
        if deadline_s is not None:
            item.deadline = item.enqueued + float(deadline_s)
        with self._cond:
            if self._accepting and self.tenants is not None:
                try:
                    # one quota token per example row, charged before
                    # the shared gate (the 429 is the CLIENT's budget,
                    # not the server's capacity)
                    self.tenants.meter.charge(item.tenant,
                                              int(x.shape[0]))
                except TenantQuotaError:
                    self.metrics.record_rejected()
                    self.metrics.record_tenant("rejected", item.tenant)
                    self.metrics.record_tenant("throttled", item.tenant)
                    raise
            try:
                check_admission(
                    accepting=self._accepting, breaker=self.breaker,
                    queue_depth=len(self._queue),
                    max_queue_depth=self.max_queue_depth,
                    metrics=self.metrics,
                    retry_after_s=self._retry_after_locked, what="serving")
            except ServingError:
                # the shared gate counted the rejection; the per-tenant
                # ledger rides along so the fleet reconciliation
                # (submitted == Σ tenants) keeps holding
                if self.tenants is not None:
                    self.metrics.record_tenant("rejected", item.tenant)
                raise
            if not self._running:
                self._start_locked()
            self._queue.append(item)
            self.metrics.set_queue_depth(len(self._queue))
            self._cond.notify_all()
        if not item.event.wait(timeout):
            # Cancel rather than abandon: a still-queued request is
            # removed (otherwise retry-on-timeout clients fill the queue
            # with zombie work the device still executes); one the worker
            # already took is MARKED abandoned — its rows are excluded
            # from the dispatch group if it has not formed yet (the
            # pop-vs-timeout race), and a dispatch already in flight has
            # its result discarded and counted as shed.
            now = time.perf_counter()
            with self._cond:
                try:
                    self._queue.remove(item)
                    self.metrics.set_queue_depth(len(self._queue))
                    self.metrics.record_shed()
                    if self.tenants is not None:
                        self.metrics.record_tenant("shed", item.tenant)
                except ValueError:
                    item.abandoned = True  # worker holds it: discard rows
                    # exactly-once shed accounting for the race: a result
                    # delivered before we marked is discarded and shed
                    # HERE; an error means the worker already resolved
                    # (and, for its own deadline sheds, already counted);
                    # an unset event means the worker's finally counts it
                    if item.event.is_set() and item.error is None:
                        self.metrics.record_shed()
                        if self.tenants is not None:
                            self.metrics.record_tenant("shed",
                                                       item.tenant)
                resolved_with_error = (item.event.is_set()
                                       and item.error is not None)
            if (item.deadline is not None and now >= item.deadline
                    and not resolved_with_error):
                # count a deadline miss only when the server-side
                # deadline actually EXPIRED and the worker did not
                # already resolve (and account) the item — a bare
                # client-wait timeout is client impatience, not shedding
                self.metrics.record_deadline_missed()
                if self.tenants is not None:
                    self.metrics.record_tenant("deadline_missed",
                                               item.tenant)
            self._trace_item(item, time.perf_counter(), "timeout")
            raise DeadlineExceededError(
                f"serving request timed out after {timeout}s")
        done = time.perf_counter()
        if item.error is not None:
            self._trace_item(item, done, "error")
            raise item.error
        qw = comp = None
        if item.t_start is not None:
            # the split the stats endpoint reports: time spent waiting
            # for a dispatch slot vs time inside the dispatch itself
            qw = item.t_start - item.enqueued
            comp = (item.t_end if item.t_end is not None
                    else done) - item.t_start
        self.metrics.record_request(done - item.enqueued,
                                    queue_wait_s=qw, compute_s=comp)
        if self.tenants is not None:
            # tenant completion ledger: served count, rows
            # out, and the SLO window sample behind the burn gauge
            self.metrics.record_tenant("requests", item.tenant)
            self.tenants.meter.record_out(item.tenant, int(x.shape[0]))
            self.tenants.slo.record(item.tenant, done - item.enqueued)
            self.metrics.set_tenant_burn(
                item.tenant, self.tenants.slo.burn_rate(item.tenant))
        self._trace_item(item, done, "ok")
        return item.result

    def _trace_item(self, item: _Pending, done: float,
                    status: str) -> None:
        """Record the request's lifecycle trace (queue_wait -> dispatch
        -> respond, plus an ``xla_compile`` span for each program built
        while its dispatch ran: the program this request paid for).  The
        hot path captures one raw tuple; the span dicts materialize only
        when /trace/recent is read (`record_lazy`)."""
        if self.tracer is None:
            return
        compiles = None
        if (item.t_start is not None
                and self._compile_watch.any_since(item.t_start)):
            compiles = self._compile_watch.events_between(
                item.t_start, item.t_end if item.t_end is not None
                else done)
        self.tracer.record_lazy(_build_serving_trace, (
            item.request_id or new_request_id(), item.enqueued,
            item.t_start, item.t_end, done, status,
            int(item.x.shape[0]),
            str(item.error) if item.error is not None else None,
            compiles, time.time()))

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # fail anything still queued rather than leaving clients hung
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            self.metrics.set_queue_depth(0)
        for item in leftovers:
            self.metrics.record_shed()
            if self.tenants is not None:
                self.metrics.record_tenant("shed", item.tenant)
            item.error = ServingUnavailableError("batcher stopped")
            item.event.set()

    # ---- drain lifecycle --------------------------------------------------

    def begin_drain(self) -> None:
        """Stop admission: subsequent submits raise
        `ServingUnavailableError`; queued + in-flight work still runs."""
        with self._cond:
            self._accepting = False
            self._cond.notify_all()

    def drain(self, grace_s: float = 5.0) -> bool:
        """Stop admission, wait up to `grace_s` for queued + in-flight
        work to finish, then stop the worker (anything still queued at
        that point fails with `ServingUnavailableError`).  Returns True
        when the queue fully drained within the grace window."""
        self.begin_drain()
        deadline = time.perf_counter() + max(0.0, grace_s)
        with self._cond:
            while self._queue or self._in_flight:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(min(0.05, remaining))
            drained = not self._queue and not self._in_flight
        self.stop()
        return drained

    # ---- worker side ------------------------------------------------------

    def _start_locked(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="micro-batcher")
        self._thread.start()

    def _shed_doomed_locked(self) -> None:
        """Drop already-expired items from the queue — doomed work must
        not reach the device; they fail with `DeadlineExceededError`.
        Abandoned items are swept defensively too, though in normal
        operation they cannot appear here (a still-queued item's client
        removes it itself; `abandoned` marks only popped items).  One
        rebuild pass: under an overload storm most of the queue can
        expire at once, and per-item `deque.remove` would be O(n^2)
        inside the lock every submit is waiting on."""
        now = time.perf_counter()
        kept, shed = collections.deque(), 0
        for item in self._queue:
            if item.abandoned:
                shed += 1
                if self.tenants is not None:
                    self.metrics.record_tenant("shed", item.tenant)
                item.event.set()
            elif item.deadline is not None and now >= item.deadline:
                shed += 1
                self.metrics.record_deadline_missed()
                if self.tenants is not None:
                    self.metrics.record_tenant("shed", item.tenant)
                    self.metrics.record_tenant("deadline_missed",
                                               item.tenant)
                item.error = DeadlineExceededError(
                    f"deadline exceeded after "
                    f"{now - item.enqueued:.3f}s in queue; shed before "
                    f"dispatch")
                item.event.set()
            else:
                kept.append(item)
        if shed:
            self._queue = kept
            self.metrics.record_shed(shed)
            self.metrics.set_queue_depth(len(kept))

    def _collect(self):
        """Take the queue head plus same-shape followers.

        Two regimes, which is what makes the batcher both low-latency
        and high-occupancy:

        - worker BUSY (queue non-empty when it frees up): dispatch
          immediately — the previous dispatch's duration already served
          as the coalescing window, so waiting again only adds latency
          (and on hosts with coarse timers, any timed wait costs ~1ms);
        - worker IDLE (had to block for the head): hold the head open up
          to `max_wait_ms` from its arrival so a burst's co-travellers
          can join its dispatch.
        """
        with self._cond:
            self._shed_doomed_locked()
            was_idle = not self._queue
            while self._running and not self._queue:
                self._cond.wait(0.1)
                self._shed_doomed_locked()
            if not self._running:
                return []
            head = self._queue[0]
            if was_idle and self.max_wait_s > 0:
                deadline = head.enqueued + self.max_wait_s
                while self._running:
                    rows = sum(i.x.shape[0] for i in self._queue
                               if i.key == head.key)
                    remaining = deadline - time.perf_counter()
                    if rows >= self.max_batch or remaining <= 0:
                        break
                    self._cond.wait(remaining)  # submits notify early
            # deadlines may have passed during the coalescing window —
            # shed BEFORE the dispatch group forms, then regroup from
            # whatever head remains
            self._shed_doomed_locked()
            if not self._queue:
                return []
            head = self._queue[0]
            group, rows, rest = [], 0, collections.deque()
            while self._queue:
                item = self._queue.popleft()
                if (item.key == head.key
                        and rows + item.x.shape[0] <= self.max_batch):
                    group.append(item)
                    rows += item.x.shape[0]
                else:
                    rest.append(item)
            self._queue.extend(rest)
            self._in_flight = len(group)
            self.metrics.set_queue_depth(len(self._queue))
            return group

    def _execute(self, group, depth, delays):
        """Dispatch `group` as one concatenated batch; on failure bisect
        (bounded depth, backoff between sub-dispatches) so exactly the
        poison item(s) fail and the rest still get their row slices.  Returns (n_ok, n_failed) items.  The try covers
        concat AND result scatter, not just the dispatch: a MemoryError
        building the batch or a malformed dispatch return must become
        per-request errors, never escape to kill the worker."""
        # dispatch window stamps: feed the queue-wait/compute latency
        # split and the per-request trace spans
        t0 = time.perf_counter()
        for g in group:
            g.t_start = t0
        try:
            x = (group[0].x if len(group) == 1
                 else np.concatenate([g.x for g in group], axis=0))
            mask = None
            if group[0].mask is not None:
                mask = (group[0].mask if len(group) == 1
                        else np.concatenate([g.mask for g in group],
                                            axis=0))
            out = np.asarray(self._dispatch(x, mask, x.shape[0]))
            for g in group:
                g.t_end = time.perf_counter()
            off = 0
            results = []
            for g in group:
                n = g.x.shape[0]
                results.append(out[off:off + n])
                if results[-1].shape[:1] != (n,):
                    raise ValueError(
                        f"dispatch returned {out.shape} rows; cannot "
                        f"slice {n} rows at offset {off}")
                off += n
        except BaseException as e:  # noqa: BLE001 — fail/bisect the GROUP, keep serving
            if len(group) == 1 or depth >= self.max_bisect_depth:
                for g in group:
                    g.error = e
                return 0, len(group)
            time.sleep(max(0.0, next(delays, self.bisect_policy.max_delay)))
            mid = len(group) // 2
            ok_lo, bad_lo = self._execute(group[:mid], depth + 1, delays)
            ok_hi, bad_hi = self._execute(group[mid:], depth + 1, delays)
            return ok_lo + ok_hi, bad_lo + bad_hi
        for g, res in zip(group, results):
            g.result = res
        return len(group), 0

    def _run(self) -> None:
        while True:
            group = self._collect()
            if not group:
                with self._cond:
                    if not self._running:
                        return
                continue
            try:
                # final abandoned check under the lock: a client timing
                # out concurrently with the pop marked its item, and its
                # rows must not ride the dispatch
                with self._cond:
                    live = []
                    for g in group:
                        if g.abandoned:
                            self.metrics.record_shed()
                            if self.tenants is not None:
                                self.metrics.record_tenant("shed",
                                                           g.tenant)
                            g.event.set()
                        else:
                            live.append(g)
                    group = live
                    self._in_flight = len(group)
                if not group:
                    continue
                if (self.breaker is not None
                        and not self.breaker.allow_dispatch()):
                    err = CircuitOpenError(
                        "circuit breaker open: dispatch fast-failed",
                        retry_after_s=self.breaker.retry_after_s())
                    for g in group:
                        self.metrics.record_shed()
                        if self.tenants is not None:
                            self.metrics.record_tenant("shed", g.tenant)
                        g.error = err
                    continue
                try:
                    n_ok, n_bad = self._execute(
                        group, 0, backoff_delays(self.bisect_policy))
                except Exception as e:  # noqa: BLE001 — the worker survives ANY group failure
                    # belt-and-braces: _execute's own handler should have
                    # absorbed everything, but the worker thread dying
                    # would hang every future submit, so convert strays
                    # into per-request errors here
                    n_ok, n_bad = 0, len(group)
                    for g in group:
                        if g.error is None and g.result is None:
                            g.error = e
                if self.breaker is not None:
                    # a whole-dispatch failure is one where bisection
                    # salvaged nothing; isolated poison leaves the
                    # serving plane healthy.  Deliberate tradeoff: a
                    # POISON request dispatched alone (no coalescing
                    # partner) is indistinguishable from a failing
                    # device, so a client retrying one poison payload
                    # `failure_threshold` times on an otherwise-idle
                    # server does trip the breaker — the alternative
                    # (ignoring singleton failures) would keep a truly
                    # dead device from ever opening it.
                    if n_ok:
                        self.breaker.record_success()
                    else:
                        self.breaker.record_failure()
                if n_ok and n_bad:
                    self.metrics.record_poison_isolated(n_bad)
            finally:
                with self._cond:
                    for g in group:
                        # a client that abandoned mid-dispatch is gone:
                        # its delivered result/error is discarded — count
                        # the shed on whichever side observes the race
                        # second (see submit's timeout path)
                        if g.abandoned and not g.event.is_set():
                            self.metrics.record_shed()
                            if self.tenants is not None:
                                self.metrics.record_tenant("shed",
                                                           g.tenant)
                        # never resolve a client with silent None: if
                        # neither result nor error was assigned, the
                        # cycle aborted — fail typed
                        if g.error is None and g.result is None:
                            g.error = ServingUnavailableError(
                                "dispatch cycle aborted")
                        g.event.set()
                    self._in_flight = 0
                    self._cond.notify_all()
