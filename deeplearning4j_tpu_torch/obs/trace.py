"""Request tracing (counterpart of `deeplearning4j_tpu.obs.trace`).

Every request carries an ``X-Request-Id`` (the client's, or minted at the
front) under which the serving plane records its spans.

- `new_request_id()`: a 16-hex-character per-process prefix plus a
  counter.
- `span(name, t0, t1, **attrs)`: one completed span (perf_counter
  seconds).
- `TraceRecorder`: a bounded ring of completed traces, optionally built
  lazily at read time, served at ``GET /trace/recent``.
- `chrome_trace(traces)`: Chrome trace-event JSON (loads in Perfetto);
  one track per request id.

Stdlib only.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from typing import Dict, List, Optional

# Request ids are a random per-process prefix plus an atomic counter:
# unique across processes (64 random bits) and cheaper than uuid4(),
# since the id mint sits on the serving hot path.
_ID_PREFIX = os.urandom(8).hex()
_ID_COUNTER = itertools.count()


def new_request_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_COUNTER):08x}"


def span(name: str, t0: float, t1: float, **attrs) -> Dict:
    """One completed span: perf_counter start/duration + free attrs."""
    s = {"name": str(name), "t0_s": float(t0),
         "dur_s": max(0.0, float(t1) - float(t0))}
    if attrs:
        s["attrs"] = {k: v for k, v in attrs.items() if v is not None}
    return s


def trace(request_id: str, kind: str, spans: List[Dict],
          status: str = "ok", **attrs) -> Dict:
    """One completed trace.  ``spans`` are `span()` dicts; ``status`` is
    "ok" or an error word ("error", "timeout", "shed", ...)."""
    spans = sorted(spans, key=lambda s: s["t0_s"])
    t0 = spans[0]["t0_s"] if spans else time.perf_counter()
    t1 = max((s["t0_s"] + s["dur_s"] for s in spans), default=t0)
    out = {"request_id": str(request_id), "kind": str(kind),
           "status": str(status), "t0_s": t0,
           "dur_s": t1 - t0, "wall_time": time.time(), "spans": spans}
    if attrs:
        out["attrs"] = {k: v for k, v in attrs.items() if v is not None}
    return out


class TraceRecorder:
    """Thread-safe bounded ring of completed traces."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._traces: List[Dict] = []
        self._recorded = 0

    def record(self, tr: Dict) -> None:
        with self._lock:
            self._traces.append(tr)
            self._recorded += 1
            if len(self._traces) > self.capacity:
                del self._traces[:len(self._traces) - self.capacity]

    def record_lazy(self, builder, raw) -> None:
        """Hot-path variant: store ``(builder, raw)`` and materialize
        ``builder(raw)`` only when the ring is read, so a request's trace
        assembly (the span and trace dicts) costs the hot path one tuple
        append."""
        self.record((builder, raw))

    @staticmethod
    def _materialize(entry) -> Dict:
        if isinstance(entry, tuple):
            builder, raw = entry
            return builder(raw)
        return entry

    @property
    def recorded(self) -> int:
        """Lifetime count (the ring holds at most ``capacity``)."""
        with self._lock:
            return self._recorded

    def recent(self, n: Optional[int] = None,
               request_id: Optional[str] = None) -> List[Dict]:
        """Newest-last; optionally filtered by request id."""
        with self._lock:
            out = list(self._traces)
        out = [self._materialize(t) for t in out]
        if request_id is not None:
            out = [t for t in out if t.get("request_id") == request_id]
        if n is not None:
            out = out[-int(n):]
        return out

    def find(self, request_id: str) -> List[Dict]:
        return self.recent(request_id=request_id)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


def _tid(request_id: str) -> int:
    return zlib.crc32(request_id.encode()) & 0x7FFFFFFF


def chrome_trace(traces: List[Dict]) -> List[Dict]:
    """Chrome trace-event array: one "X" (complete) event per span, all
    requests on pid 1 with one thread per request id.  Timestamps are
    perf_counter microseconds — relative ordering within a process is
    exact, which is what the span taxonomy needs."""
    events: List[Dict] = []
    for tr in traces:
        tid = _tid(tr.get("request_id", ""))
        meta = {"request_id": tr.get("request_id"),
                "status": tr.get("status")}
        meta.update(tr.get("attrs") or {})
        events.append({
            "name": f"{tr.get('kind', 'request')}",
            "cat": tr.get("kind", "request"), "ph": "X",
            "ts": tr["t0_s"] * 1e6, "dur": tr["dur_s"] * 1e6,
            "pid": 1, "tid": tid, "args": meta})
        for s in tr.get("spans", ()):
            events.append({
                "name": s["name"], "cat": tr.get("kind", "request"),
                "ph": "X", "ts": s["t0_s"] * 1e6, "dur": s["dur_s"] * 1e6,
                "pid": 1, "tid": tid, "args": s.get("attrs", {})})
    return events
