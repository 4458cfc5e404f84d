"""Serving metrics for the classifier engine, the LM pool and the fleet
router (counterpart of `deeplearning4j_tpu.serving.metrics`).

Throughput is bought with occupancy (real rows or lanes per dispatch);
latency is
spent in queue wait plus device compute.  The cells are `obs.registry`
metric objects, so one source feeds both ``GET /serving/stats``
(`snapshot()`, under the JAX package's key names) and the Prometheus
exposition at ``GET /metrics`` (`register_into(registry, plane=...)`,
``classifier``, ``lm`` or ``fleet``, publishes every cell under a plane label, the per-tenant cells too, as
they appear).  Each optional section of the snapshot (prefix cache,
speculation, shipping, priority classes, tenants, swap, hibernation,
brownout) appears once its plane has fired.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from deeplearning4j_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from deeplearning4j_tpu_torch.runtime.profiler import LatencyRecorder
from deeplearning4j_tpu_torch.serving.pressure import PRIORITY_CLASSES

# the per-class resilience events snapshot()/exposition break out —
# the existing deadline/shed/breaker discipline, preserved per class
_CLASS_EVENTS = ("requests", "rejected", "shed", "deadline_missed",
                 "preempted")

# the per-tenant traffic-shaping events: the per-class set
# plus `throttled` (quota 429s — a tenant-only concept; priority
# classes are never metered).  Tenant names are an OPEN vocabulary
# fixed at serve time, so unlike `class_counters` the cells are
# created lazily on first record (see `record_tenant`).
_TENANT_EVENTS = _CLASS_EVENTS + ("throttled",)

# breaker state -> gauge value (the exposition's numeric encoding;
# the string stays in /serving/stats)
_BREAKER_VALUES = {"closed": 0, "open": 1, "half_open": 2}


def _ms(summary: Dict[str, float]) -> Dict[str, float]:
    """A Histogram.summary() (seconds) as the stats-endpoint ms shape."""
    if not summary.get("count"):
        return {"count": 0}
    return {"count": summary["count"],
            "mean_ms": round(summary["mean"] * 1e3, 3),
            "p50_ms": round(summary["p50"] * 1e3, 3),
            "p95_ms": round(summary["p95"] * 1e3, 3),
            "p99_ms": round(summary["p99"] * 1e3, 3)}


class ServingMetrics:
    """Thread-safe counters shared by the micro-batcher, the LM server
    and their HTTP fronts."""

    def __init__(self, latency_window: int = 4096):
        self._lock = threading.Lock()
        self.latency = LatencyRecorder(window=latency_window)
        # ---- registry-native cells: the same objects render
        # /serving/stats and /metrics
        self.requests_total = Counter(
            "serving_requests_total", "requests served to completion")
        self.dispatches_total = Counter(
            "serving_dispatches_total", "device dispatches")
        self.rows_total = Counter(
            "serving_rows_total", "real example rows dispatched")
        self.padded_rows_total = Counter(
            "serving_padded_rows_total",
            "bucket capacity dispatched (incl. padding)")
        self.tokens_total = Counter(
            "serving_tokens_total", "LM tokens emitted")
        self.queue_depth_gauge = Gauge(
            "serving_queue_depth", "requests waiting in the queue")
        # resilience ledger: submitted == requests + rejected
        # + shed + other-errors
        self.rejected_total = Counter(
            "serving_rejected_total",
            "refused at admission (overload/breaker/draining)")
        self.shed_total = Counter(
            "serving_shed_total", "removed from a queue before dispatch")
        self.deadline_missed_total = Counter(
            "serving_deadline_missed_total",
            "failed because the deadline passed")
        # written only by the classifier batcher's poison bisection;
        # the LM plane publishes it at 0, as the JAX package's LM plane
        # does
        self.poison_isolated_total = Counter(
            "serving_poison_isolated_total",
            "requests isolated as poison by bisection")
        self.breaker_state_gauge = Gauge(
            "serving_breaker_state",
            "circuit breaker state (0 closed, 1 open, 2 half_open)")
        self.breaker_opens_total = Counter(
            "serving_breaker_opens_total", "breaker open transitions")
        # paged-KV / prefix-reuse ledger
        self.prefix_queries_total = Counter(
            "serving_prefix_queries_total", "LM admissions radix-queried")
        self.prefix_hits_total = Counter(
            "serving_prefix_hits_total", "admissions that reused pages")
        self.prefix_tokens_saved_total = Counter(
            "serving_prefix_tokens_saved_total",
            "prefill steps skipped via cached prefixes")
        self.pages_in_use_gauge = Gauge(
            "serving_kv_pages_in_use", "KV pages currently refcounted")
        self.pages_free_gauge = Gauge(
            "serving_kv_pages_free", "KV pages on the free list")
        self.pages_total_gauge = Gauge(
            "serving_kv_pages_total", "KV pool size (0 = not paged)")
        # speculative-decode ledger: tokens-per-dispatch is
        # bought with accepted drafts — E[tokens/round] = accept + 1
        self.decode_rounds_total = Counter(
            "serving_lm_decode_lane_rounds_total",
            "decode-phase lane-dispatches (each emits >= 1 token)")
        self.decode_tokens_total = Counter(
            "serving_lm_decode_tokens_total",
            "tokens emitted by decode-phase lane-dispatches")
        self.spec_rounds_total = Counter(
            "serving_spec_rounds_total",
            "lane-dispatches that verified >= 1 draft token")
        self.spec_drafted_total = Counter(
            "serving_spec_drafted_total",
            "draft tokens proposed to the verify step")
        self.spec_accepted_total = Counter(
            "serving_spec_accepted_total",
            "draft tokens the target model accepted")
        # disaggregated-serving ledger: KV page shipping in
        # and out of this pool, time-to-first-token, and sticky-session
        # affinity — the numbers that say whether the prefill/decode
        # split and the session routing are paying for themselves
        self.ships_out_total = Counter(
            "serving_kv_ships_out_total",
            "lanes exported as KV page shipments")
        self.ships_in_total = Counter(
            "serving_kv_ships_in_total",
            "lanes admitted from KV page shipments")
        self.pages_shipped_total = Counter(
            "serving_kv_pages_shipped_total",
            "KV pages moved through shipments (both directions)")
        self.ship_bytes_total = Counter(
            "serving_kv_ship_bytes_total",
            "KV page payload bytes moved through shipments")
        self.ship_hist = Histogram(
            "serving_kv_ship_seconds",
            "device-side gather/install time per shipment")
        self.ttft_hist = Histogram(
            "serving_lm_ttft_seconds",
            "admission to first committed token")
        self.session_queries_total = Counter(
            "serving_session_queries_total",
            "LM requests that carried a session_id")
        self.session_affinity_hits_total = Counter(
            "serving_session_affinity_hits_total",
            "session_id requests that landed on a pool that had "
            "already served the session")
        # overload-survival ledger: priority classes,
        # preemption with host swap-out, and the brownout ladder
        self.class_counters = {
            (event, cls): Counter(
                f"serving_lm_class_{event}_total",
                f"LM {event} by priority class")
            for event in _CLASS_EVENTS for cls in PRIORITY_CLASSES}
        self.preemptions_total = Counter(
            "serving_lm_preemptions_total",
            "lanes preempted so higher-priority work could admit")
        self.swap_out_total = Counter(
            "serving_kv_swap_out_total",
            "preempted lanes swapped out to the host store")
        self.swap_in_total = Counter(
            "serving_kv_swap_in_total",
            "preempted lanes restored from the host store")
        self.swap_pages_total = Counter(
            "serving_kv_swap_pages_total",
            "KV pages moved through host swap (both directions)")
        self.swap_bytes_total = Counter(
            "serving_kv_swap_bytes_total",
            "serialized bytes moved through host swap")
        self.swap_evicted_total = Counter(
            "serving_kv_swap_evicted_total",
            "swapped lanes whose state the byte-capped store dropped "
            "(restore recomputes from the prompt)")
        self.swap_corrupt_total = Counter(
            "serving_kv_swap_corrupt_total",
            "swapped lanes whose state failed the SHA-256 restore "
            "check (restore recomputes from the prompt)")
        # tiered-state hibernation ledger: idle sticky
        # sessions parked on the host/disk hierarchy and resumed later,
        # plus the compression ledger (at-rest vs exact bytes — the
        # quantized tiers' ~4x claim is verified against these)
        self.hibernated_total = Counter(
            "serving_kv_hibernated_total",
            "idle sessions hibernated to the tiered state store")
        self.resumed_total = Counter(
            "serving_kv_resumed_total",
            "sessions resumed from the tiered state store")
        self.hibernate_pages_total = Counter(
            "serving_kv_hibernate_pages_total",
            "KV pages moved through hibernation (both directions)")
        self.hibernate_bytes_total = Counter(
            "serving_kv_hibernate_bytes_total",
            "at-rest bytes moved through hibernation (quantized when on)")
        self.hibernate_exact_bytes_total = Counter(
            "serving_kv_hibernate_exact_bytes_total",
            "exact-dtype-equivalent bytes of hibernated pages (the "
            "compression ratio's denominator)")
        self.hibernate_evicted_total = Counter(
            "serving_kv_hibernate_evicted_total",
            "hibernated sessions whose state fell off the byte-capped "
            "tiers (resume recomputes from the prompt)")
        self.hibernate_corrupt_total = Counter(
            "serving_kv_hibernate_corrupt_total",
            "hibernated sessions whose blob failed its integrity check "
            "at resume (recompute from the prompt)")
        self.brownout_level_gauge = Gauge(
            "serving_brownout_level",
            "degradation-ladder level (0 healthy .. 4 shedding)")
        self.brownout_transitions_total = Counter(
            "serving_brownout_transitions_total",
            "degradation-ladder level changes (both directions)")
        self.brownout_shed_total = Counter(
            "serving_brownout_shed_total",
            "best_effort admissions refused by ladder level 4")
        # multi-tenant ledger: tenant names are an OPEN
        # vocabulary (fixed by the registry at serve time, unknown
        # here), so the per-tenant cells are created lazily on first
        # record and LATE-registered onto every registry this plane
        # already published into — `register_into` remembers its
        # (registry, labels) pairs for exactly that
        self.tenant_counters: Dict = {}      # (event, tenant) -> Counter
        self.tenant_burn_gauges: Dict = {}   # tenant -> Gauge
        self._tenant_registrations: list = []
        # latency: end-to-end histogram + the queue-wait vs
        # dispatch-compute split (the pool stamps both)
        self.latency_hist = Histogram(
            "serving_request_seconds", "end-to-end request latency")
        self.queue_wait_hist = Histogram(
            "serving_queue_wait_seconds",
            "admission to dispatch-start wait")
        self.compute_hist = Histogram(
            "serving_compute_seconds",
            "dispatch-start to dispatch-end (device compute + pad)")
        # ---- plain fields (cross-cell state the snapshot reads)
        self._queue_depth = 0
        self._max_occupancy = 0
        self._started: Optional[float] = None
        self._created = time.monotonic()
        self._breaker_state = "closed"

    def register_into(self, registry: MetricsRegistry,
                      **labels) -> "ServingMetrics":
        """Publish every cell on `registry` under `labels` (e.g.
        ``plane="lm"``).  Re-registering the same labels (a
        rolling swap's replacement engine) takes over the series."""
        for m in (self.requests_total, self.dispatches_total,
                  self.rows_total, self.padded_rows_total,
                  self.tokens_total, self.queue_depth_gauge,
                  self.rejected_total, self.shed_total,
                  self.deadline_missed_total, self.poison_isolated_total,
                  self.breaker_state_gauge, self.breaker_opens_total,
                  self.prefix_queries_total, self.prefix_hits_total,
                  self.prefix_tokens_saved_total, self.pages_in_use_gauge,
                  self.pages_free_gauge, self.pages_total_gauge,
                  self.decode_rounds_total, self.decode_tokens_total,
                  self.spec_rounds_total, self.spec_drafted_total,
                  self.spec_accepted_total,
                  self.ships_out_total, self.ships_in_total,
                  self.pages_shipped_total, self.ship_bytes_total,
                  self.ship_hist, self.ttft_hist,
                  self.session_queries_total,
                  self.session_affinity_hits_total,
                  self.preemptions_total, self.swap_out_total,
                  self.swap_in_total, self.swap_pages_total,
                  self.swap_bytes_total, self.swap_evicted_total,
                  self.swap_corrupt_total,
                  self.hibernated_total, self.resumed_total,
                  self.hibernate_pages_total, self.hibernate_bytes_total,
                  self.hibernate_exact_bytes_total,
                  self.hibernate_evicted_total,
                  self.hibernate_corrupt_total,
                  self.brownout_level_gauge,
                  self.brownout_transitions_total,
                  self.brownout_shed_total,
                  self.latency_hist, self.queue_wait_hist,
                  self.compute_hist):
            registry.register(m, **labels)
        for (_event, cls), m in self.class_counters.items():
            registry.register(m, priority=cls, **labels)
        with self._lock:
            self._tenant_registrations.append((registry, dict(labels)))
            tenant_cells = ([(tn, m) for (_e, tn), m
                             in self.tenant_counters.items()]
                            + list(self.tenant_burn_gauges.items()))
        for tn, m in tenant_cells:
            registry.register(m, tenant=tn, **labels)
        return self

    # ---- recording --------------------------------------------------------

    def _touch(self) -> None:
        # unlocked fast path: after the first request this is a single
        # attribute read per record call (the slow path's lock still
        # makes the one assignment race-free) — per-record lock traffic
        # is what this avoids on every record call
        if self._started is not None:  # noqa: LCK101 — DCL fast path; write is locked below
            return
        with self._lock:
            if self._started is None:
                self._started = time.perf_counter()

    def record_dispatch(self, n_real: int, n_padded: int,
                        queue_depth: Optional[int] = None) -> None:
        self._touch()
        self.dispatches_total.inc()
        self.rows_total.inc(int(n_real))
        self.padded_rows_total.inc(int(n_padded))
        with self._lock:
            if queue_depth is not None:  # None = depth owned by the queue
                self._queue_depth = int(queue_depth)
                self.queue_depth_gauge.set(queue_depth)
            self._max_occupancy = max(self._max_occupancy, int(n_real))

    def record_request(self, latency_s: float,
                       queue_wait_s: Optional[float] = None,
                       compute_s: Optional[float] = None) -> None:
        """One request served to completion.  `queue_wait_s` (admission
        to dispatch start) and `compute_s` (dispatch start to end) feed
        the split histograms when the queue owner knows them."""
        self._touch()
        self.requests_total.inc()
        self.latency.record(latency_s)
        self.latency_hist.observe(latency_s)
        if queue_wait_s is not None:
            self.queue_wait_hist.observe(max(0.0, queue_wait_s))
        if compute_s is not None:
            self.compute_hist.observe(max(0.0, compute_s))

    def record_tokens(self, n: int) -> None:
        self._touch()
        self.tokens_total.inc(int(n))

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = int(depth)
        self.queue_depth_gauge.set(depth)

    def record_rejected(self, n: int = 1) -> None:
        self._touch()
        self.rejected_total.inc(int(n))

    def record_shed(self, n: int = 1) -> None:
        self._touch()
        self.shed_total.inc(int(n))

    def record_deadline_missed(self, n: int = 1) -> None:
        self._touch()
        self.deadline_missed_total.inc(int(n))

    def record_poison_isolated(self, n: int = 1) -> None:
        self._touch()
        self.poison_isolated_total.inc(int(n))

    def record_decode_round(self, emitted: int, drafted: int = 0,
                            accepted: int = 0) -> None:
        """One decode-phase lane-dispatch: `emitted` tokens committed
        (1 + accepted with speculation; always 1 without), plus the
        round's drafted/accepted counts when a draft was verified."""
        self._touch()
        self.decode_rounds_total.inc()
        self.decode_tokens_total.inc(int(emitted))
        if drafted > 0:
            self.spec_rounds_total.inc()
            self.spec_drafted_total.inc(int(drafted))
            self.spec_accepted_total.inc(int(accepted))

    def record_ship(self, direction: str, pages: int, nbytes: int,
                    seconds: float) -> None:
        """One KV page shipment through this pool: `direction` is
        "out" (a lane exported at prefill completion) or "in" (a lane
        admitted from shipped pages); `seconds` is the device-side
        gather/install cost, the wire hop belongs to the router."""
        self._touch()
        (self.ships_out_total if direction == "out"
         else self.ships_in_total).inc()
        self.pages_shipped_total.inc(int(pages))
        self.ship_bytes_total.inc(int(nbytes))
        self.ship_hist.observe(max(0.0, float(seconds)))

    def record_class(self, event: str, priority: str,
                     n: int = 1) -> None:
        """Per-priority-class resilience accounting: `event`
        is one of requests/rejected/shed/deadline_missed.  An unknown
        class is counted as interactive rather than raised — the typed
        validation already happened at admission; accounting must
        never fail a request."""
        key = (event, priority if priority in PRIORITY_CLASSES
               else PRIORITY_CLASSES[0])
        counter = self.class_counters.get(key)
        if counter is not None:
            counter.inc(int(n))

    def record_preemption(self, priority: str) -> None:
        """One lane preempted (its class is the victim's — the
        per-class row is how an operator verifies ladder level 3
        only ever preempts best_effort)."""
        self._touch()
        self.preemptions_total.inc()
        self.record_class("preempted", priority)

    def _tenant_counter(self, event: str, tenant: str) -> Counter:
        key = (event, tenant)
        c = self.tenant_counters.get(key)  # noqa: LCK101 — DCL fast path; creation is locked below
        if c is None:
            regs = None
            with self._lock:
                c = self.tenant_counters.get(key)
                if c is None:
                    c = Counter(f"serving_lm_tenant_{event}_total",
                                f"LM {event} by tenant")
                    regs = list(self._tenant_registrations)
                    self.tenant_counters[key] = c
            if regs is not None:
                # publish outside the lock: registry.register takes the
                # registry's own lock, and this cell is already visible
                for registry, labels in regs:
                    registry.register(c, tenant=tenant, **labels)
        return c

    def record_tenant(self, event: str, tenant: str, n: int = 1) -> None:
        """Per-tenant traffic-shaping accounting: `event` is
        one of requests/rejected/shed/deadline_missed/preempted/
        throttled, mirroring `record_class` so a ledger can reconcile
        submitted == Σ tenants == Σ classes.  Cells
        materialize on first use (`serving_lm_tenant_{event}_total`,
        label ``tenant=``) and are published onto every registry this
        plane registered into — accounting must never fail a request,
        so like `record_class` this raises nothing on the record
        path."""
        self._tenant_counter(str(event), str(tenant)).inc(int(n))

    def set_tenant_burn(self, tenant: str, value: float) -> None:
        """Publish one tenant's SLO burn rate: the windowed fraction of
        its requests over its latency target, divided by its error
        budget — > 1.0 means the tenant is burning budget and is first
        in line when the brownout ladder picks victims."""
        tenant = str(tenant)
        g = self.tenant_burn_gauges.get(tenant)  # noqa: LCK101 — DCL fast path; creation is locked below
        if g is None:
            regs = None
            with self._lock:
                g = self.tenant_burn_gauges.get(tenant)
                if g is None:
                    g = Gauge("serving_lm_tenant_slo_burn_rate",
                              "per-tenant SLO burn rate (>1 = burning "
                              "error budget)")
                    regs = list(self._tenant_registrations)
                    self.tenant_burn_gauges[tenant] = g
            if regs is not None:
                for registry, labels in regs:
                    registry.register(g, tenant=tenant, **labels)
        g.set(float(value))

    def record_swap(self, direction: str, pages: int,
                    nbytes: int) -> None:
        """One lane swapped 'out' to (or restored 'in' from) the host
        store — the preemption analog of `record_ship`."""
        self._touch()
        (self.swap_out_total if direction == "out"
         else self.swap_in_total).inc()
        self.swap_pages_total.inc(int(pages))
        self.swap_bytes_total.inc(int(nbytes))

    def record_swap_lost(self, kind: str) -> None:
        """A swapped lane's state was unusable at restore: `kind` is
        'evicted' (byte-cap LRU dropped it) or 'corrupt' (SHA-256 or
        frame check failed).  Either way the lane recomputes from its
        prompt — deterministic decode keeps the output byte-identical,
        so only this ledger ever sees the loss."""
        self._touch()
        (self.swap_corrupt_total if kind == "corrupt"
         else self.swap_evicted_total).inc()

    def record_hibernate(self, direction: str, pages: int, nbytes: int,
                         exact_nbytes: int) -> None:
        """One session hibernated 'out' to (or resumed 'in' from) the
        tiered state store.  `nbytes` is the at-rest frame size
        (quantized when the knob is on), `exact_nbytes` the same pages
        at their exact dtype — the pair is the compression ledger."""
        self._touch()
        (self.hibernated_total if direction == "out"
         else self.resumed_total).inc()
        self.hibernate_pages_total.inc(int(pages))
        self.hibernate_bytes_total.inc(int(nbytes))
        self.hibernate_exact_bytes_total.inc(int(exact_nbytes))

    def record_hibernate_lost(self, kind: str) -> None:
        """A hibernated session's state was unusable at resume: `kind`
        is 'evicted' (fell off a byte-capped tier) or 'corrupt'
        (checksum/manifest/frame failure).  The session recomputes from
        its prompt — byte-identical output, ledger-only loss."""
        self._touch()
        (self.hibernate_corrupt_total if kind == "corrupt"
         else self.hibernate_evicted_total).inc()

    def record_brownout(self, level: int, transitions: int = 0) -> None:
        """Publish the current ladder level; `transitions` new level
        changes since the last call (every transition is counted)."""
        self.brownout_level_gauge.set(int(level))
        if transitions:
            self.brownout_transitions_total.inc(int(transitions))

    def record_brownout_shed(self) -> None:
        self._touch()
        self.brownout_shed_total.inc()

    def record_first_token(self, seconds: float) -> None:
        """Time-to-first-token for one request: admission to the first
        committed token."""
        self.ttft_hist.observe(max(0.0, float(seconds)))

    def record_session(self, hit: bool) -> None:
        """One session_id-carrying request; `hit` when this pool had
        already served the session (sticky affinity worked)."""
        self._touch()
        self.session_queries_total.inc()
        if hit:
            self.session_affinity_hits_total.inc()

    def record_prefix_query(self, tokens_saved: int) -> None:
        """One LM admission's radix-cache outcome: `tokens_saved` prompt
        tokens were served from cached pages (0 = miss)."""
        self._touch()
        self.prefix_queries_total.inc()
        if tokens_saved > 0:
            self.prefix_hits_total.inc()
            self.prefix_tokens_saved_total.inc(int(tokens_saved))

    def set_pages(self, in_use: int, free: int, total: int) -> None:
        self.pages_in_use_gauge.set(in_use)
        self.pages_free_gauge.set(free)
        self.pages_total_gauge.set(total)

    def set_breaker_state(self, state: str) -> None:
        with self._lock:
            if state == "open" and self._breaker_state != "open":
                self.breaker_opens_total.inc()
            self._breaker_state = str(state)
        self.breaker_state_gauge.set(_BREAKER_VALUES.get(str(state), 0))

    # ---- reading ----------------------------------------------------------

    @property
    def dispatches(self) -> int:
        return int(self.dispatches_total.value)

    @property
    def max_occupancy(self) -> int:
        """Largest real-row count observed in one dispatch."""
        with self._lock:
            return self._max_occupancy

    def snapshot(self) -> Dict:
        with self._lock:
            elapsed = (time.perf_counter() - self._started
                       if self._started is not None else 0.0)
            depth = self._queue_depth
            max_occ = self._max_occupancy
            breaker_state = self._breaker_state
            uptime = time.monotonic() - self._created
        dispatches = int(self.dispatches_total.value)
        requests = int(self.requests_total.value)
        rows = int(self.rows_total.value)
        padded = int(self.padded_rows_total.value)
        tokens = int(self.tokens_total.value)
        pq = int(self.prefix_queries_total.value)
        out = {
            "requests": requests,
            "dispatches": dispatches,
            "rows": rows,
            "queue_depth": depth,
            "rejected": int(self.rejected_total.value),
            "shed": int(self.shed_total.value),
            "deadline_missed": int(self.deadline_missed_total.value),
            "poison_isolated": int(self.poison_isolated_total.value),
            "breaker_state": breaker_state,
            "breaker_opens": int(self.breaker_opens_total.value),
            "latency": self.latency.summary(),
            # scrape-friendly timing: rates without
            # client-side clocks — uptime since construction plus the
            # monotonic clock this snapshot was cut at
            "uptime_s": round(uptime, 3),
            "snapshot_at": time.monotonic(),
        }
        qw = _ms(self.queue_wait_hist.summary())
        comp = _ms(self.compute_hist.summary())
        if qw["count"]:
            out["queue_wait"] = qw
        if comp["count"]:
            out["compute"] = comp
        dec_rounds = int(self.decode_rounds_total.value)
        if dec_rounds:
            out["decode_rounds"] = dec_rounds
            out["tokens_per_decode_round"] = round(
                int(self.decode_tokens_total.value) / dec_rounds, 3)
        drafted = int(self.spec_drafted_total.value)
        if drafted:
            out["spec_rounds"] = int(self.spec_rounds_total.value)
            out["spec_drafted"] = drafted
            out["spec_accepted"] = int(self.spec_accepted_total.value)
            out["spec_accept_rate"] = round(
                out["spec_accepted"] / drafted, 3)
        ttft = _ms(self.ttft_hist.summary())
        if ttft["count"]:
            out["ttft"] = ttft
        ships = (int(self.ships_out_total.value)
                 + int(self.ships_in_total.value))
        if ships:
            out["ship"] = {
                "out": int(self.ships_out_total.value),
                "in": int(self.ships_in_total.value),
                "pages_shipped": int(self.pages_shipped_total.value),
                "ship_bytes": int(self.ship_bytes_total.value),
                **{k: v for k, v in
                   _ms(self.ship_hist.summary()).items() if k != "count"}}
        sq = int(self.session_queries_total.value)
        if sq:
            out["session_queries"] = sq
            out["session_affinity_hits"] = int(
                self.session_affinity_hits_total.value)
        # overload-survival sections, present only once the
        # plane has actually fired so pre-existing snapshots are stable
        classes = {}
        for cls in PRIORITY_CLASSES:
            vals = {e: int(self.class_counters[(e, cls)].value)
                    for e in _CLASS_EVENTS}
            if any(vals.values()):
                classes[cls] = vals
        if classes:
            out["priority"] = classes
        # per-tenant ledger, same fire-once contract: the
        # section appears only once some tenant has recorded an event
        with self._lock:
            tenant_cells = dict(self.tenant_counters)
            burn_cells = dict(self.tenant_burn_gauges)
        tenants: Dict = {}
        for (event, tn), m in tenant_cells.items():
            v = int(m.value)
            if v:
                tenants.setdefault(tn, {})[event] = v
        for tn, g in burn_cells.items():
            if tn in tenants:
                tenants[tn]["burn_rate"] = round(float(g.value), 4)
        if tenants:
            out["tenants"] = tenants
        if int(self.preemptions_total.value):
            out["preemptions"] = int(self.preemptions_total.value)
        swaps = (int(self.swap_out_total.value)
                 + int(self.swap_in_total.value)
                 + int(self.swap_evicted_total.value)
                 + int(self.swap_corrupt_total.value))
        if swaps:
            out["swap"] = {
                "out": int(self.swap_out_total.value),
                "in": int(self.swap_in_total.value),
                "pages": int(self.swap_pages_total.value),
                "bytes": int(self.swap_bytes_total.value),
                "evicted": int(self.swap_evicted_total.value),
                "corrupt": int(self.swap_corrupt_total.value)}
        hib = (int(self.hibernated_total.value)
               + int(self.resumed_total.value)
               + int(self.hibernate_evicted_total.value)
               + int(self.hibernate_corrupt_total.value))
        if hib:
            at_rest = int(self.hibernate_bytes_total.value)
            exact = int(self.hibernate_exact_bytes_total.value)
            out["hibernate"] = {
                "out": int(self.hibernated_total.value),
                "in": int(self.resumed_total.value),
                "pages": int(self.hibernate_pages_total.value),
                "bytes": at_rest,
                "exact_bytes": exact,
                "bytes_ratio": (round(at_rest / exact, 4) if exact
                                else 1.0),
                "evicted": int(self.hibernate_evicted_total.value),
                "corrupt": int(self.hibernate_corrupt_total.value)}
        if (int(self.brownout_transitions_total.value)
                or int(self.brownout_level_gauge.value)):
            out["brownout"] = {
                "level": int(self.brownout_level_gauge.value),
                "transitions": int(
                    self.brownout_transitions_total.value),
                "shed": int(self.brownout_shed_total.value)}
        if pq:
            out["prefix_queries"] = pq
            out["prefix_hits"] = int(self.prefix_hits_total.value)
            out["prefix_tokens_saved"] = int(
                self.prefix_tokens_saved_total.value)
            out["prefix_hit_rate"] = round(out["prefix_hits"] / pq, 3)
        if int(self.pages_total_gauge.value):
            out["pages_in_use"] = int(self.pages_in_use_gauge.value)
            out["pages_free"] = int(self.pages_free_gauge.value)
            out["pages_total"] = int(self.pages_total_gauge.value)
        if dispatches:
            out["mean_batch_occupancy"] = round(rows / dispatches, 3)
            out["max_batch_occupancy"] = max_occ
            # fraction of dispatched device rows that were real examples
            out["pad_efficiency"] = round(rows / max(padded, 1), 3)
        if elapsed > 0:
            out["requests_per_sec"] = round(requests / elapsed, 1)
            if tokens:
                out["tokens_per_sec"] = round(tokens / elapsed, 1)
        if tokens:
            out["tokens"] = tokens
        return out
