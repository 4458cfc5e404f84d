"""Request tracing and the program's span store (counterpart of
`deeplearning4j_tpu.obs.trace`).

Every request carries an ``X-Request-Id`` (the client's, or minted at the
front) under which the serving plane records its spans.

- `new_request_id()`: a 16-hex-character per-process prefix plus a
  counter.
- `span(name, t0, t1, **attrs)`: one completed span (perf_counter
  seconds).
- `TraceRecorder`: a bounded ring of completed traces, optionally built
  lazily at read time, served at ``GET /trace/recent``.
- `chrome_trace(traces)`: Chrome trace-event JSON (loads in Perfetto);
  one track per request id, on the profiler's clock (`to_epoch_ns`).

The span store is one bounded, process-wide ring of completed spans of
the program's own work (``SPAN_CAPACITY``): the serving scheduler's
rounds and their phases (``serve.*``), each request's queue wait, and
the LM train step's parts (``train.*``).  `record_span(name, t0_ns,
t1_ns, sid, parent, counts, tag)` appends one: start and end from
``time.perf_counter_ns()``, the recording thread's native id, the span's
own id (`new_span_id()`, 0 when nothing points at it), its parent's id,
a tuple of integer counts named by `SPAN_COUNTS`, and a tag (a request
id, or a `runtime.profiler` device interval).  A record is one tuple
appended to a bounded deque: no lock beyond the interpreter's, no dict.
`spans()` reads the ring as `Span` tuples; `spans_chrome_events` writes
them as Chrome events.  The store is on by default;
`set_spans_enabled(False)` switches every recorder off.  Servers of one
process tell their spans apart by the ``pool`` count (`new_pool_id()`).

The clock anchor pairs ``perf_counter_ns`` with ``time_ns`` (at import,
and again by `reanchor()` when `runtime.profiler.trace` starts), so
`to_epoch_ns` puts the ring's times, and the request traces', on the
Unix-epoch nanoseconds the profiler stamps its events with.

Stdlib only.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
import zlib
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

# Request ids are a random per-process prefix plus an atomic counter:
# unique across processes (64 random bits) and cheaper than uuid4(),
# since the id mint sits on the serving hot path.
_ID_PREFIX = os.urandom(8).hex()
_ID_COUNTER = itertools.count()


def new_request_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_COUNTER):08x}"


# ---- the clock anchor ------------------------------------------------------

_ANCHOR = [0, 0]      # (perf_counter_ns, time_ns) taken together


def reanchor() -> None:
    """Take the clock pair again (the wall clock may have been stepped
    since the last pair)."""
    a = time.perf_counter_ns()
    e = time.time_ns()
    b = time.perf_counter_ns()
    _ANCHOR[:] = [(a + b) // 2, e]


def to_epoch_ns(perf_ns: int) -> int:
    """A ``perf_counter_ns`` time as Unix-epoch ns, the profiler's clock."""
    return int(perf_ns) - _ANCHOR[0] + _ANCHOR[1]


reanchor()


# ---- the span store --------------------------------------------------------

SPAN_CAPACITY = 1 << 16

# the names of each span's counts, in order
SPAN_COUNTS: Dict[str, Tuple[str, ...]] = {
    "serve.round": ("pool", "width", "lanes", "fed_tokens", "kv_pages",
                    "page_size", "qk_pairs"),
    "serve.queue": ("pool",),
    "train.step": ("accum",),
}
# spans that time a wait rather than a thread's work (a request's queue
# wait, recorded by the worker that installs it): attribution skips them
SPAN_WAITS = frozenset({"serve.queue"})


class Span(NamedTuple):
    name: str
    t0_ns: int          # time.perf_counter_ns()
    t1_ns: int
    tid: int            # threading.get_native_id() of the recorder
    sid: int            # this span's id (0: no child points at it)
    parent: int         # the enclosing span's id (0: none)
    counts: tuple       # integers, named by SPAN_COUNTS[name]
    tag: object         # a request id, a device interval, or None


_RING: "collections.deque[tuple]" = collections.deque(maxlen=SPAN_CAPACITY)
_ON = [True]
_LOCAL = threading.local()
new_span_id = itertools.count(1).__next__
new_pool_id = itertools.count(1).__next__


def record_span(name: str, t0_ns: int, t1_ns: int, sid: int = 0,
                parent: int = 0, counts: tuple = (), tag=None,
                _append=_RING.append, _on=_ON, _local=_LOCAL) -> None:
    """Append one completed span to the ring (a no-op while the store is
    off).  Hot path: keep it a tuple append."""
    if _on[0]:
        try:
            tid = _local.tid
        except AttributeError:
            tid = _local.tid = threading.get_native_id()
        _append((name, t0_ns, t1_ns, tid, sid, parent, counts, tag))


def set_spans_enabled(on: bool) -> None:
    """The process-wide off switch of every span recorder."""
    _ON[0] = bool(on)


def spans(names: Optional[Iterable[str]] = None) -> List[Span]:
    """The ring's spans, oldest first (in order of completion), or only
    those named in `names`."""
    raw = list(_RING)
    if names is not None:
        keep = set(names)
        raw = [r for r in raw if r[0] in keep]
    return [Span._make(r) for r in raw]


def clear_spans() -> None:
    _RING.clear()


def spans_chrome_events(items: Iterable[Span], base_ns: int) -> List[Dict]:
    """Chrome "X" events of ring spans on the profiler's clock: ``ts``
    in microseconds after `base_ns` (Unix-epoch ns), on the track of the
    recording thread, the counts as named ``args``."""
    pid = os.getpid()
    out = []
    for s in items:
        args = dict(zip(SPAN_COUNTS.get(s.name, ()), s.counts))
        if isinstance(s.tag, str):
            args["request_id"] = s.tag
        out.append({"name": s.name, "cat": "program_span", "ph": "X",
                    "ts": (to_epoch_ns(s.t0_ns) - base_ns) / 1e3,
                    "dur": (s.t1_ns - s.t0_ns) / 1e3,
                    "pid": pid, "tid": s.tid, "args": args})
    return out


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


def _epoch_us(t_s: float) -> float:
    return to_epoch_ns(round(t_s * 1e9)) / 1e3


def chrome_trace(traces: List[Dict]) -> List[Dict]:
    """Chrome trace-event array: one "X" (complete) event per span, all
    requests on pid 1 with one thread per request id.  Timestamps are
    Unix-epoch microseconds through the clock anchor: the profiler's
    clock, so the events line up with `runtime.profiler.trace`'s file
    (whose ``ts`` count from its ``baseTimeNanoseconds``)."""
    events: List[Dict] = []
    for tr in traces:
        tid = _tid(tr.get("request_id", ""))
        meta = {"request_id": tr.get("request_id"),
                "status": tr.get("status")}
        meta.update(tr.get("attrs") or {})
        events.append({
            "name": f"{tr.get('kind', 'request')}",
            "cat": tr.get("kind", "request"), "ph": "X",
            "ts": _epoch_us(tr["t0_s"]), "dur": tr["dur_s"] * 1e6,
            "pid": 1, "tid": tid, "args": meta})
        for s in tr.get("spans", ()):
            events.append({
                "name": s["name"], "cat": tr.get("kind", "request"),
                "ph": "X", "ts": _epoch_us(s["t0_s"]),
                "dur": s["dur_s"] * 1e6,
                "pid": 1, "tid": tid, "args": s.get("attrs", {})})
    return events
