"""Tracing and profiling (counterpart of
`deeplearning4j_tpu.runtime.profiler`).

- `trace(logdir)`: a context manager around `torch.profiler.profile`
  (host and, with a card, CUDA activities; every thread's host ops where
  the installed torch can record them) that writes a Chrome trace into
  `logdir` — the kernels' names and device times, every `annotate` span,
  and the span store's spans (`obs.trace`) of the profiled interval on
  the profiler's clock, one track a thread — and ``attribution.json``
  beside it (`attribute`).
- `attribute(events, spans, base_ns, t0_ns, t1_ns)`: a profile's device
  seconds by the program span that launched the work, and its idle gaps
  by the program span the launching thread was in.
- `annotate(name)`: a named span in that trace
  (`torch.profiler.record_function`).  The serving and training paths
  record their spans in the span store instead: a profiler range around
  launches comes back as a device-side row, which would count as device
  activity.
- `DeviceIntervals`: the stream's time between two points of the host
  code, from a reused pool of CUDA event pairs, read lazily.
- `device_memory_stats()`: live and peak allocated bytes and the total
  memory of each CUDA device, under the JAX package's keys.
- `StepTimer`: a listener of wall-clock step times (mean / p50 / p95,
  steps/s, examples/s).
- `LatencyRecorder`: the serving plane's per-request metric primitive,
  a thread-safe sliding window of samples with percentile summaries.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import math
import os
import re
import statistics
import threading
import time
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.obs.trace import (
    SPAN_WAITS,
    reanchor,
    spans as ring_spans,
    spans_chrome_events,
    to_epoch_ns,
)


def percentile(sorted_samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sample list
    (ceil-based rank, so p50 of [1..5] is 3, not a half-to-even 2)."""
    if not sorted_samples:
        raise ValueError("percentile of an empty sample set")
    idx = min(len(sorted_samples) - 1,
              max(0, math.ceil(q / 100.0 * len(sorted_samples)) - 1))
    return float(sorted_samples[idx])


class LatencyRecorder:
    """Thread-safe sliding-window latency reservoir.  The window (default
    4096 samples) bounds memory on a long-lived server while keeping p99
    meaningful at serving rates."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._samples = collections.deque(maxlen=window)
        self._count = 0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def summary(self) -> Dict[str, float]:
        """{count, window, mean_ms, p50/p95/p99_ms}: `count` is the
        lifetime total; mean and percentiles cover the sliding window."""
        with self._lock:
            samples = sorted(self._samples)
            count = self._count
        if not samples:
            return {"count": 0}
        return {
            "count": count,
            "window": len(samples),
            "mean_ms": round(sum(samples) / len(samples) * 1e3, 3),
            "p50_ms": round(percentile(samples, 50) * 1e3, 3),
            "p95_ms": round(percentile(samples, 95) * 1e3, 3),
            "p99_ms": round(percentile(samples, 99) * 1e3, 3),
        }


def _all_threads_config():
    """The profiler setting that records every thread's host ops, where
    the installed torch has it (None otherwise)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with `torch.profiler` and write its Chrome trace
    to ``<logdir>/trace-<pid>-<ns>.json``, with the span store's spans of
    the block added, and the block's `attribute` to
    ``<logdir>/attribution.json`` (a later trace into the same `logdir`
    replaces it); yields `logdir`.  The CUDA activity is traced when a
    card is present."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    config = _all_threads_config()
    kw = {} if config is None else {"experimental_config": config}
    prof = torch.profiler.profile(activities=activities, **kw)
    reanchor()
    prof.__enter__()
    t0 = time.perf_counter_ns()
    try:
        yield logdir
    finally:
        t1 = time.perf_counter_ns()
        prof.__exit__(None, None, None)
        path = os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _add_spans(path, os.path.join(logdir, "attribution.json"), t0, t1)


def _add_spans(path: str, attribution_path: str, t0: int, t1: int) -> None:
    """Add the ring's spans of ``[t0, t1]`` to the Chrome trace at
    `path` and write their attribution."""
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    # torch's file counts ``ts`` from this base (older ones from 0)
    base = int(doc.get("baseTimeNanoseconds", 0))
    inside = [s for s in ring_spans() if s.t1_ns >= t0 and s.t0_ns <= t1]
    attribution = attribute(events, inside, base, t0, t1)
    events.extend(spans_chrome_events(inside, base))
    with open(path, "w") as fh:
        json.dump(doc, fh)
    with open(attribution_path, "w") as fh:
        json.dump(attribution, fh, indent=1)


# ---- attribution -----------------------------------------------------------

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SPAN = "(no span)"
NO_OP = "(no op)"
TOP_KERNELS = 20


def _short(name: str) -> str:
    """A kernel's name without ``void``, namespaces, its template and
    its argument list."""
    name = re.sub(r"^void\s+", "", name.strip())
    name = name.replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        if cut in name:
            name = name[:name.index(cut)]
    return name.strip().split("::")[-1][:80] or "unnamed"


class _Timeline:
    """The innermost open interval at each time, for one thread: the
    one that started last (the shorter on a tie), over elementary
    segments between the intervals' ends."""

    def __init__(self, items):
        items = sorted(items)             # (start, end, label)
        points = sorted({x for a, b, _ in items for x in (a, b)})
        self.starts: List[float] = []
        self.ends: List[float] = []
        self.labels: List[Optional[str]] = []
        self.outer: List[Optional[str]] = []
        active: list = []
        k = 0
        for p, q in zip(points, points[1:]):
            active = [it for it in active if it[1] > p]
            while k < len(items) and items[k][0] <= p:
                if items[k][1] > p:
                    active.append(items[k])
                k += 1
            if not active:
                continue
            inner = max(active, key=lambda it: (it[0], -it[1]))
            outer = min(active, key=lambda it: (it[0], -it[1]))
            self.starts.append(p)
            self.ends.append(q)
            self.labels.append(inner[2])
            self.outer.append(outer[2])

    def at(self, t: float):
        """(innermost, outermost) label open at `t`, or (None, None)."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.ends[i]:
            return self.labels[i], self.outer[i]
        return None, None

    def split(self, a: float, b: float) -> Dict[Optional[str], float]:
        """The length of ``[a, b)`` under each innermost label (None:
        under none)."""
        out: Dict[Optional[str], float] = {}
        covered = 0.0
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        while i < len(self.starts) and self.starts[i] < b:
            ov = min(b, self.ends[i]) - max(a, self.starts[i])
            if ov > 0:
                out[self.labels[i]] = out.get(self.labels[i], 0.0) + ov
                covered += ov
            i += 1
        if b - a > covered:
            out[None] = out.get(None, 0.0) + (b - a - covered)
        return out


def _add(d: Dict, key, v: float) -> None:
    d[key] = d.get(key, 0.0) + v


def attribute(events: List[Dict], spans: Sequence, base_ns: int,
              t0_ns: int, t1_ns: int) -> Dict:
    """Where a profile's device time and idle time went, by program span.

    `events` are the profile's Chrome events (``ts``/``dur`` in us after
    `base_ns`, Unix-epoch ns; ``args.correlation`` ties a device row to
    the runtime call that launched it); `spans` the span store's
    `obs.trace.Span` tuples; ``[t0_ns, t1_ns]`` the profiled interval on
    ``perf_counter_ns``.

    - ``device_s_by_span``: each device row's seconds under the
      innermost program span open on its launching call's thread at the
      call's start; where that thread had none open (autograd's device
      thread runs the backward), the innermost open on another thread,
      marked so.
    - ``idle_s_by_span``: each gap in the device's activity split, by
      self time, over the innermost spans of the thread that launched
      the work ending the gap.
    - ``kernels``: the ``TOP_KERNELS`` kernels by device seconds, each
      by span and by host op (the outermost and innermost profiled op
      around its launch)."""
    def us(perf_ns: int) -> float:
        return (to_epoch_ns(perf_ns) - base_ns) / 1e3

    w0, w1 = us(t0_ns), us(t1_ns)
    by_tid: Dict[int, list] = {}
    for s in spans:
        if s.name not in SPAN_WAITS:
            by_tid.setdefault(s.tid, []).append(
                (us(s.t0_ns), us(s.t1_ns), s.name))
    span_tl = {t: _Timeline(v) for t, v in by_tid.items()}
    ops: Dict[int, list] = {}
    launches: Dict[int, tuple] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e["ts"]) + float(
                e.get("dur", 0)), e.get("name", ""), corr))
        elif cat in LAUNCH_CATS:
            if corr is not None:
                launches[corr] = (e.get("tid"), float(e["ts"]))
        elif cat == "cpu_op":
            ops.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e.get("name", "")))
    op_tl = {t: _Timeline(v) for t, v in ops.items()}

    def span_at(tid, t):
        tl = span_tl.get(tid)
        name = tl.at(t)[0] if tl is not None else None
        if name is not None:
            return name
        for other, tl in span_tl.items():
            name = tl.at(t)[0] if other != tid else None
            if name is not None:
                return name + " (another thread)"
        return NO_SPAN

    dev_by_span: Dict[str, float] = {}
    kernels: Dict[str, Dict] = {}
    unmatched = 0.0
    device.sort()
    for a, b, name, corr in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        sec = (b - a) / 1e6
        k = kernels.setdefault(_short(name), {"device_s": 0.0, "launches": 0,
                                              "by_span": {}, "by_op": {}})
        k["device_s"] += sec
        k["launches"] += 1
        src = launches.get(corr)
        if src is None:
            unmatched += sec
            continue
        tid, t = src
        label = span_at(tid, t)
        _add(dev_by_span, label, sec)
        _add(k["by_span"], label, sec)
        tl = op_tl.get(tid)
        inner, outer = tl.at(t) if tl is not None else (None, None)
        op = (NO_OP if inner is None else inner if inner == outer
              else f"{outer} > {inner}")
        _add(k["by_op"], op, sec)
    # the gaps between the union of the device rows
    busy: List[List[float]] = []
    for a, b, _, corr in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b, corr])
    def gap_parts(tid, a, b):
        """``[a, b)`` by the innermost spans of `tid`; for a thread that
        recorded none, by another thread's, marked so."""
        if tid in span_tl:
            return span_tl[tid].split(a, b)
        for tl in span_tl.values():
            parts = tl.split(a, b)
            if parts.get(None, 0.0) < b - a:
                return {(k and k + " (another thread)"): v
                        for k, v in parts.items()}
        return {None: b - a}

    idle: Dict[str, float] = {}
    edge = w0
    for a, b, corr in busy + [[w1, w1, None]]:
        if a > edge:
            src = launches.get(corr)
            parts = ({None: a - edge} if src is None
                     else gap_parts(src[0], edge, a))
            for label, v in parts.items():
                _add(idle, label or NO_SPAN, v / 1e6)
        edge = max(edge, b)
    top_k = sorted(kernels.items(),
                   key=lambda kv: -kv[1]["device_s"])[:TOP_KERNELS]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b, _ in busy) / 1e6,
        "unmatched_device_s": unmatched,
        "device_s_by_span": _sorted(dev_by_span),
        "idle_s_by_span": _sorted(idle),
        "kernels": [dict(kernel=n, device_s=v["device_s"],
                         launches=v["launches"],
                         by_span=_sorted(v["by_span"]),
                         by_op=_sorted(v["by_op"], 8))
                    for n, v in top_k],
    }


def _sorted(d: Dict[str, float], n: Optional[int] = None) -> Dict:
    items = sorted(d.items(), key=lambda kv: -kv[1])
    return dict(items[:n] if n else items)


class DeviceInterval:
    """The stream's time from one point of the host code to another: a
    pair of CUDA events.  `ns()` reads it, waiting for the end event if
    the stream has not passed it yet."""

    __slots__ = ("_pool", "_pair", "_ns")

    def __init__(self, pool: "DeviceIntervals", pair):
        self._pool = pool
        self._pair = pair
        self._ns: Optional[int] = None

    def _read(self) -> None:
        start, end = self._pair
        self._ns = int(start.elapsed_time(end) * 1e6)
        self._pool._free.append(self._pair)
        self._pair = None

    def ns(self) -> int:
        if self._pair is not None:
            self._pair[1].synchronize()
            self._read()
        return self._ns


class DeviceIntervals:
    """A small reused pool of CUDA timing-event pairs.  `start(device)`
    records a pair's first event on the device's current stream and
    returns its `DeviceInterval` (None off the card); `stop(interval)`
    records the second.  Each `start` first reads the stopped intervals
    whose end the stream has passed, which returns their pairs to the
    pool, so the host never waits on the device here."""

    def __init__(self):
        self._free: list = []
        self._stopped: "collections.deque[DeviceInterval]" = (
            collections.deque())

    def start(self, device) -> Optional[DeviceInterval]:
        if device.type != "cuda":
            return None
        import torch

        while self._stopped:
            iv = self._stopped[0]
            if iv._pair is not None:
                if not iv._pair[1].query():
                    break
                iv._read()
            self._stopped.popleft()
        pair = self._free.pop() if self._free else (
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
        pair[0].record(torch.cuda.current_stream(device))
        return DeviceInterval(self, pair)

    def stop(self, iv: Optional[DeviceInterval], device) -> None:
        if iv is None:
            return
        import torch

        iv._pair[1].record(torch.cuda.current_stream(device))
        self._stopped.append(iv)


def annotate(name: str):
    """A named span in the trace (use as a context manager)."""
    import torch

    return torch.profiler.record_function(name)


def device_memory_stats() -> List[Dict]:
    """One dict a CUDA device: ``bytes_in_use`` and ``peak_bytes_in_use``
    (the caching allocator's allocated bytes, current and peak) and
    ``bytes_limit`` (the device's total memory).  Without a card, one
    stats-less ``{"device": "cpu"}`` entry, as the JAX package gives for
    its CPU device."""
    import torch

    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        raw = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(i).total_memory)})
    return out


class StepTimer:
    """Iteration listener recording wall-clock step times.

    Register with `net.add_listener(StepTimer(batch_size=...))`; read
    `.summary()` (mean/p50/p95 seconds, steps/sec, examples/sec).  The
    first `skip` steps are excluded (warm-up)."""

    def __init__(self, batch_size: Optional[int] = None, skip: int = 1):
        self.batch_size = batch_size
        self.skip = skip
        self._last: Optional[float] = None
        self._times: List[float] = []
        self._seen = 0

    def __call__(self, iteration: int, score: float) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.skip:
                self._times.append(now - self._last)
        self._last = now

    def reset(self) -> None:
        self._last, self._times, self._seen = None, [], 0

    @property
    def times(self) -> List[float]:
        return list(self._times)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        ts = sorted(self._times)
        mean = statistics.fmean(ts)
        out = {
            "steps": len(ts),
            "mean_s": mean,
            "p50_s": ts[len(ts) // 2],
            "p95_s": ts[min(len(ts) - 1, int(len(ts) * 0.95))],
            "steps_per_sec": 1.0 / mean if mean else 0.0,
        }
        if self.batch_size:
            out["examples_per_sec"] = self.batch_size / mean
        return out


__all__ = ["DeviceIntervals", "LatencyRecorder", "StepTimer", "annotate",
           "attribute", "device_memory_stats", "percentile", "trace"]
