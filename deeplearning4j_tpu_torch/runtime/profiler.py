"""Tracing and profiling (counterpart of
`deeplearning4j_tpu.runtime.profiler`).

- `trace(logdir)`: a context manager around `torch.profiler.profile`
  (host and, with a card, CUDA activities) that writes a Chrome trace
  into `logdir` — the kernels' names and device times, and every
  `annotate` span.
- `annotate(name)`: a named span in that trace
  (`torch.profiler.record_function`).
- `device_memory_stats()`: live and peak allocated bytes and the total
  memory of each CUDA device, under the JAX package's keys.
- `StepTimer`: a listener of wall-clock step times (mean / p50 / p95,
  steps/s, examples/s).
- `LatencyRecorder`: the serving plane's per-request metric primitive,
  a thread-safe sliding window of samples with percentile summaries.
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import statistics
import threading
import time
from typing import Dict, List, Optional, Sequence


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


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with `torch.profiler` and write its Chrome trace
    to ``<logdir>/trace-<pid>-<ns>.json``; yields `logdir`.  The CUDA
    activity is traced when a card is present."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield logdir
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


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


__all__ = ["LatencyRecorder", "StepTimer", "annotate",
           "device_memory_stats", "percentile", "trace"]
