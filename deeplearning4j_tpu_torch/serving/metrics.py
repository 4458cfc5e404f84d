"""Serving metrics for the LM pool (subset of
`deeplearning4j_tpu.serving.metrics`).

Throughput is bought with occupancy (real lanes per dispatch); latency is
spent in queue wait plus device compute.  `ServingMetrics` counts both
sides and snapshots them for ``GET /serving/stats`` under the JAX
package's key names: requests, tokens, dispatches and occupancy, latency
p50/p95/p99 split into queue wait and compute, time to first token, the
radix prefix-cache hit rate, the KV page gauges, the speculative
decode ledger (decode rounds, drafted and accepted tokens), and the page
mobility ledgers: page shipments, sticky sessions, requests by priority
class, preemptions and host swaps, hibernations and the brownout
ladder.  Each of those sections appears once its plane has fired.  The
Prometheus registry plane is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from deeplearning4j_tpu_torch.runtime.profiler import LatencyRecorder
from deeplearning4j_tpu_torch.serving.pressure import PRIORITY_CLASSES

# the per-priority-class events
_CLASS_EVENTS = ("requests", "rejected", "shed", "deadline_missed",
                 "preempted")


class ServingMetrics:
    """Thread-safe counters shared by the LM server and its HTTP front."""

    def __init__(self, latency_window: int = 4096):
        self._lock = threading.Lock()
        self.latency = LatencyRecorder(window=latency_window)
        self.queue_wait = LatencyRecorder(window=latency_window)
        self.compute = LatencyRecorder(window=latency_window)
        self.ttft = LatencyRecorder(window=latency_window)
        self.ship_time = LatencyRecorder(window=latency_window)
        self._c = dict.fromkeys(
            ("requests", "dispatches", "rows", "padded_rows", "tokens",
             "rejected", "shed", "deadline_missed", "prefix_queries",
             "prefix_hits", "prefix_tokens_saved", "decode_rounds",
             "decode_tokens", "spec_rounds", "spec_drafted",
             "spec_accepted", "ships_out", "ships_in", "pages_shipped",
             "ship_bytes", "session_queries", "session_affinity_hits",
             "preemptions", "swap_out", "swap_in", "swap_pages",
             "swap_bytes", "swap_evicted", "swap_corrupt", "hibernated",
             "resumed", "hibernate_pages", "hibernate_bytes",
             "hibernate_exact_bytes", "hibernate_evicted",
             "hibernate_corrupt", "brownout_transitions",
             "brownout_shed"), 0)
        self._classes = {(e, c): 0 for e in _CLASS_EVENTS
                         for c in PRIORITY_CLASSES}
        self._brownout_level = 0
        self._queue_depth = 0
        self._max_occupancy = 0
        self._pages = (0, 0, 0)           # in_use, free, total
        self._started: Optional[float] = None
        self._created = time.monotonic()

    # ---- recording --------------------------------------------------------

    def _add_locked(self, key: str, n: int) -> None:
        if self._started is None:
            self._started = time.perf_counter()
        self._c[key] += int(n)

    def _add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._add_locked(key, n)

    def record_dispatch(self, n_real: int, n_padded: int) -> None:
        with self._lock:
            self._add_locked("dispatches", 1)
            self._add_locked("rows", n_real)
            self._add_locked("padded_rows", n_padded)
            self._max_occupancy = max(self._max_occupancy, int(n_real))

    def record_request(self, latency_s: float,
                       queue_wait_s: Optional[float] = None,
                       compute_s: Optional[float] = None) -> None:
        """One request served to completion, with its queue-wait
        (admission to slot install) and compute (install to completion)
        split when known."""
        self._add("requests")
        self.latency.record(latency_s)
        if queue_wait_s is not None:
            self.queue_wait.record(max(0.0, queue_wait_s))
        if compute_s is not None:
            self.compute.record(max(0.0, compute_s))

    def record_tokens(self, n: int) -> None:
        self._add("tokens", n)

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = int(depth)

    def record_rejected(self, n: int = 1) -> None:
        self._add("rejected", n)

    def record_shed(self, n: int = 1) -> None:
        self._add("shed", n)

    def record_deadline_missed(self, n: int = 1) -> None:
        self._add("deadline_missed", n)

    def record_first_token(self, seconds: float) -> None:
        """Admission to the first committed token."""
        self.ttft.record(max(0.0, float(seconds)))

    def record_prefix_query(self, tokens_saved: int) -> None:
        """One admission's radix-cache outcome: `tokens_saved` prompt
        tokens came from cached pages (0 = miss)."""
        with self._lock:
            self._add_locked("prefix_queries", 1)
            if tokens_saved > 0:
                self._add_locked("prefix_hits", 1)
                self._add_locked("prefix_tokens_saved", tokens_saved)

    def record_decode_round(self, emitted: int, drafted: int = 0,
                            accepted: int = 0) -> None:
        """One decode-phase lane-dispatch of the paged pool: `emitted`
        tokens committed (1 + accepted with speculation, else 1), and the
        round's drafted / accepted counts when drafts were verified."""
        with self._lock:
            self._add_locked("decode_rounds", 1)
            self._add_locked("decode_tokens", emitted)
            if drafted > 0:
                self._add_locked("spec_rounds", 1)
                self._add_locked("spec_drafted", drafted)
                self._add_locked("spec_accepted", accepted)

    def set_pages(self, in_use: int, free: int, total: int) -> None:
        with self._lock:
            self._pages = (int(in_use), int(free), int(total))

    def record_ship(self, direction: str, pages: int, nbytes: int,
                    seconds: float) -> None:
        """One KV page shipment through this pool: "out" (a lane exported
        at prefill completion) or "in" (a lane admitted from shipped
        pages); `seconds` is the gather or install on this side."""
        with self._lock:
            self._add_locked("ships_out" if direction == "out"
                             else "ships_in", 1)
            self._add_locked("pages_shipped", pages)
            self._add_locked("ship_bytes", nbytes)
        self.ship_time.record(max(0.0, float(seconds)))

    def record_session(self, hit: bool) -> None:
        """One request carrying a session_id; `hit` when this pool had
        served the session before."""
        with self._lock:
            self._add_locked("session_queries", 1)
            if hit:
                self._add_locked("session_affinity_hits", 1)

    def record_class(self, event: str, priority: str, n: int = 1) -> None:
        """Per-priority-class accounting (`event` in requests, rejected,
        shed, deadline_missed, preempted); an unknown class counts as
        interactive: accounting never fails a request."""
        cls = (priority if priority in PRIORITY_CLASSES
               else PRIORITY_CLASSES[0])
        with self._lock:
            if (event, cls) in self._classes:
                self._classes[(event, cls)] += int(n)

    def record_preemption(self, priority: str) -> None:
        """One lane preempted; `priority` is the victim's class."""
        self._add("preemptions")
        self.record_class("preempted", priority)

    def record_swap(self, direction: str, pages: int, nbytes: int) -> None:
        """One lane swapped "out" to (or restored "in" from) the host
        store."""
        with self._lock:
            self._add_locked("swap_out" if direction == "out"
                             else "swap_in", 1)
            self._add_locked("swap_pages", pages)
            self._add_locked("swap_bytes", nbytes)

    def record_swap_lost(self, kind: str) -> None:
        """A swapped lane's state was unusable at restore: "evicted" or
        "corrupt"; the lane recomputes from its prompt."""
        self._add("swap_corrupt" if kind == "corrupt" else "swap_evicted")

    def record_hibernate(self, direction: str, pages: int, nbytes: int,
                         exact_nbytes: int) -> None:
        """One session hibernated "out" to (or resumed "in" from) the
        tiered store: `nbytes` at rest, `exact_nbytes` unquantized."""
        with self._lock:
            self._add_locked("hibernated" if direction == "out"
                             else "resumed", 1)
            self._add_locked("hibernate_pages", pages)
            self._add_locked("hibernate_bytes", nbytes)
            self._add_locked("hibernate_exact_bytes", exact_nbytes)

    def record_hibernate_lost(self, kind: str) -> None:
        """A hibernated session's state was unusable at resume:
        "evicted" or "corrupt"; it recomputes from its prompt."""
        self._add("hibernate_corrupt" if kind == "corrupt"
                  else "hibernate_evicted")

    def record_brownout(self, level: int, transitions: int = 0) -> None:
        """The ladder's current level and the level changes since the
        last call."""
        with self._lock:
            self._brownout_level = int(level)
            if transitions:
                self._c["brownout_transitions"] += int(transitions)

    def record_brownout_shed(self) -> None:
        self._add("brownout_shed")

    # ---- reading ----------------------------------------------------------

    def snapshot(self) -> Dict:
        with self._lock:
            c = dict(self._c)
            elapsed = (time.perf_counter() - self._started
                       if self._started is not None else 0.0)
            depth = self._queue_depth
            max_occ = self._max_occupancy
            in_use, free, total = self._pages
            uptime = time.monotonic() - self._created
            classes = dict(self._classes)
            level = self._brownout_level
        out = {
            "requests": c["requests"],
            "dispatches": c["dispatches"],
            "rows": c["rows"],
            "queue_depth": depth,
            "rejected": c["rejected"],
            "shed": c["shed"],
            "deadline_missed": c["deadline_missed"],
            "latency": self.latency.summary(),
            "uptime_s": round(uptime, 3),
            "snapshot_at": time.monotonic(),
        }
        for key, rec in (("queue_wait", self.queue_wait),
                         ("compute", self.compute), ("ttft", self.ttft)):
            summ = rec.summary()
            if summ["count"]:
                out[key] = summ
        if c["prefix_queries"]:
            out["prefix_queries"] = c["prefix_queries"]
            out["prefix_hits"] = c["prefix_hits"]
            out["prefix_tokens_saved"] = c["prefix_tokens_saved"]
            out["prefix_hit_rate"] = round(
                c["prefix_hits"] / c["prefix_queries"], 3)
        if c["decode_rounds"]:
            out["decode_rounds"] = c["decode_rounds"]
            out["tokens_per_decode_round"] = round(
                c["decode_tokens"] / c["decode_rounds"], 3)
        if c["spec_drafted"]:
            out["spec_rounds"] = c["spec_rounds"]
            out["spec_drafted"] = c["spec_drafted"]
            out["spec_accepted"] = c["spec_accepted"]
            out["spec_accept_rate"] = round(
                c["spec_accepted"] / c["spec_drafted"], 3)
        if c["ships_out"] + c["ships_in"]:
            out["ship"] = {"out": c["ships_out"], "in": c["ships_in"],
                           "pages_shipped": c["pages_shipped"],
                           "ship_bytes": c["ship_bytes"],
                           **{k: v for k, v in
                              self.ship_time.summary().items()
                              if k not in ("count", "window")}}
        if c["session_queries"]:
            out["session_queries"] = c["session_queries"]
            out["session_affinity_hits"] = c["session_affinity_hits"]
        by_class = {}
        for cls in PRIORITY_CLASSES:
            vals = {e: classes[(e, cls)] for e in _CLASS_EVENTS}
            if any(vals.values()):
                by_class[cls] = vals
        if by_class:
            out["priority"] = by_class
        if c["preemptions"]:
            out["preemptions"] = c["preemptions"]
        if (c["swap_out"] + c["swap_in"] + c["swap_evicted"]
                + c["swap_corrupt"]):
            out["swap"] = {"out": c["swap_out"], "in": c["swap_in"],
                           "pages": c["swap_pages"],
                           "bytes": c["swap_bytes"],
                           "evicted": c["swap_evicted"],
                           "corrupt": c["swap_corrupt"]}
        if (c["hibernated"] + c["resumed"] + c["hibernate_evicted"]
                + c["hibernate_corrupt"]):
            exact = c["hibernate_exact_bytes"]
            out["hibernate"] = {
                "out": c["hibernated"], "in": c["resumed"],
                "pages": c["hibernate_pages"],
                "bytes": c["hibernate_bytes"], "exact_bytes": exact,
                "bytes_ratio": (round(c["hibernate_bytes"] / exact, 4)
                                if exact else 1.0),
                "evicted": c["hibernate_evicted"],
                "corrupt": c["hibernate_corrupt"]}
        if c["brownout_transitions"] or level:
            out["brownout"] = {"level": level,
                               "transitions": c["brownout_transitions"],
                               "shed": c["brownout_shed"]}
        if total:
            out["pages_in_use"] = in_use
            out["pages_free"] = free
            out["pages_total"] = total
        if c["dispatches"]:
            out["mean_batch_occupancy"] = round(
                c["rows"] / c["dispatches"], 3)
            out["max_batch_occupancy"] = max_occ
            out["pad_efficiency"] = round(
                c["rows"] / max(c["padded_rows"], 1), 3)
        if elapsed > 0:
            out["requests_per_sec"] = round(c["requests"] / elapsed, 1)
            if c["tokens"]:
                out["tokens_per_sec"] = round(c["tokens"] / elapsed, 1)
        if c["tokens"]:
            out["tokens"] = c["tokens"]
        return out


__all__ = ["ServingMetrics"]
