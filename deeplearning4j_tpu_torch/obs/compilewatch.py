"""Program-build accounting (counterpart of
`deeplearning4j_tpu.obs.compilewatch`).

The JAX package counts XLA compiles through ``jax.monitoring``.  The
port's programs are `runtime.programs.Program`s: a serving step built
once per program key and replayed after that (a CUDA graph captured on
the card; the first eager run on the CPU).  Each build reports one event
here, and the watcher keeps what JAX's keeps:

- ``compiles_total{program_key=...}``, a counter per program key.  The
  key is whatever `compile_scope(key)` is active on the BUILDING thread
  (the serving engine scopes each dispatch and warmup with its ladder
  shape, the LM pool each program with JAX's program key), so a build on
  the request path shows up under the key of the program that paid for
  it; unscoped builds land under ``""``;
- a bounded ring of recent events ``(t_end, duration, key)``, so the
  request tracer can attach an ``xla_compile`` span to the request whose
  dispatch window a build landed in.

A program reports to the watcher directly, so `ensure_installed()` has
nothing to register; it stays for the JAX package's API.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

COMPILE_EVENT = "/deeplearning4j_tpu_torch/program/build_duration"

_scope: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_compile_scope", default="")


@contextlib.contextmanager
def compile_scope(key: str):
    """Attribute any program built by this thread inside the block to
    ``program_key=key`` (contextvars: thread and task local)."""
    token = _scope.set(str(key))
    try:
        yield
    finally:
        _scope.reset(token)


class CompileWatcher:
    """Process-wide program-build counter + recent-event ring."""

    def __init__(self, recent: int = 512):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._total_duration = 0.0
        self._events = collections.deque(maxlen=recent)  # (t_end, dur, key)

    # ---- recording --------------------------------------------------------

    def record(self, event: str, duration: float) -> None:
        """One `COMPILE_EVENT` of `duration` seconds, ending now, under the
        calling thread's `compile_scope`."""
        if event != COMPILE_EVENT:
            return
        key = _scope.get()
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._total_duration += float(duration)
            self._events.append((time.perf_counter(), float(duration), key))

    def ensure_installed(self) -> None:
        """Kept for the JAX package's API: programs feed the watcher
        directly, so there is no listener to register (idempotent)."""

    # ---- reading ----------------------------------------------------------

    def total(self, prefix: Optional[str] = None) -> int:
        """Builds observed, optionally only for keys with `prefix`."""
        with self._lock:
            if prefix is None:
                return sum(self._counts.values())
            return sum(c for k, c in self._counts.items()
                       if k.startswith(prefix))

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def any_since(self, t: float) -> bool:
        """O(1) hot-path guard: did ANY build end at/after `t`?  The tracer
        checks this before paying for `events_between`; on a warmed
        serving path it is False for every request."""
        # lock-free (this runs per request on the trace path): deque ops
        # are GIL-atomic, and reading [-1] while a bounded rotation
        # empties it is answered conservatively
        events = self._events  # noqa: LCK101 — lock-free hot-path guard, race handled
        if not events:
            return False
        try:
            return events[-1][0] >= t
        except IndexError:   # raced a rotation of the bounded deque
            return True

    def events_between(self, t0: float, t1: float
                       ) -> List[Tuple[float, float, str]]:
        """Build events whose [start, end] overlaps [t0, t1] (perf
        seconds): which request paid for a build."""
        with self._lock:
            events = list(self._events)
        return [(t_end, dur, key) for t_end, dur, key in events
                if t_end - dur <= t1 and t_end >= t0]

    def collector_samples(self) -> Iterable[Tuple]:
        """`MetricsRegistry.register_collector` source: one
        ``compiles_total`` sample per program key plus the cumulative
        build seconds."""
        with self._lock:
            counts = dict(self._counts)
            dur = self._total_duration
        for key, c in sorted(counts.items()):
            yield ("compiles_total", "counter",
                   "serving programs built (CUDA graph captures on the "
                   "card, first eager runs on the CPU)",
                   {"program_key": key}, float(c))
        yield ("compile_seconds_total", "counter",
               "cumulative program build time (warm run + capture)", {},
               dur)


_watcher: Optional[CompileWatcher] = None
_watcher_lock = threading.Lock()


def compile_watcher() -> CompileWatcher:
    """The process-wide watcher, made on first use."""
    global _watcher
    with _watcher_lock:
        if _watcher is None:
            _watcher = CompileWatcher()
    return _watcher


__all__ = ["COMPILE_EVENT", "CompileWatcher", "compile_scope",
           "compile_watcher"]
