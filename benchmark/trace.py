"""The traced span of a ``--trace 1`` run and its reduction.

`Tracer` runs ``torch.profiler`` (host ops and device activity) over a
span that a load opens and closes, with the device synchronised at
both ends.  `reduce_events` turns the profiler's raw events into what
the per-layer metrics and the result's ``breakdown`` read:

- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets) inside the span, so overlapping streams count once;
- ``kernels``: device seconds and launches by kernel, the name cut at
  its template or argument list;
- ``device_ops``: the ten kernels that took most device time;
- ``idle_gaps``: the device's idle time inside the span by what the
  host was doing then (the host op that overlaps each gap most; gaps
  under 20 us between kernels are pooled), the ten largest.

Adapted from the port's ``chip_smoke.py`` ``device_breakdown`` (device
events only, never the host ops' own device totals).
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

SMALL_GAP_NS = 20_000
MAX_HOST_EVENT_NS = 200_000_000


def short_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces, its template and its
    argument list."""
    name = re.sub(r"^void\s+", "", name.strip())
    name = name.replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        if cut in name:
            name = name[:name.index(cut)]
    return name.strip().split("::")[-1][:80] or "unnamed"


class Tracer:
    """One traced span: `start()`, the work, `stop()` -> the reduction."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._sync()
        self.t0_ns, self.t0 = time.time_ns(), time.perf_counter()

    def stop(self) -> dict:
        self._sync()
        t1, t1_ns = time.perf_counter(), time.time_ns()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        out = reduce_events(_rows(events), self.t0_ns, t1_ns)
        out["window_s"] = t1 - self.t0
        self._prof = None
        return out


def _rows(events) -> List[Tuple[bool, str, int, int]]:
    """(on the device, name, start ns, end ns) of the profiler's events."""
    from torch.autograd import DeviceType

    rows = []
    for e in events:
        dev = e.device_type() != DeviceType.CPU
        start = int(e.start_ns())
        rows.append((dev, e.name(), start, start + int(e.duration_ns())))
    return rows


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(rows: List[Tuple[bool, str, int, int]], t0_ns: int,
                  t1_ns: int) -> dict:
    """The span's device activity from raw (device?, name, start, end)
    rows; device rows are clipped to ``[t0_ns, t1_ns]``."""
    dev = [(n, max(s, t0_ns), min(e, t1_ns)) for d, n, s, e in rows
           if d and e > t0_ns and s < t1_ns]
    kernels: Dict[str, List[float]] = {}
    for n, s, e in dev:
        k = kernels.setdefault(short_name(n), [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
    busy = _merge([(s, e) for _, s, e in dev if e > s])
    busy_s = sum(e - s for s, e in busy) / 1e9
    host = sorted((s, e, n) for d, n, s, e in rows
                  if not d and 0 < e - s <= MAX_HOST_EVENT_NS
                  and not n.startswith("ProfilerStep"))
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = ("between kernels (< 20 us)" if b - a < SMALL_GAP_NS
                 else _host_label(host, starts, a, b))
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy_s,
        "kernels": {k: (v[0], v[1]) for k, v in kernels.items()},
        "device_ops": [[k, v[0]] for k, v in top_k[:10]],
        "idle_gaps": [[k, v] for k, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


def _host_label(host, starts, a: int, b: int) -> str:
    """The innermost host event (op or CUDA call) that covers most of
    ``[a, b)`` (the one that overlaps it most where none covers half), or
    a plain label when none was traced."""
    best: Optional[Tuple[int, int, str]] = None
    lo = bisect.bisect_left(starts, a - MAX_HOST_EVENT_NS)
    hi = bisect.bisect_left(starts, b)
    for s, e, n in host[lo:hi]:
        ov = min(e, b) - max(s, a)
        if ov <= 0:
            continue
        # covering half the gap or more ranks first, then the shorter
        key = (2 * ov >= b - a, -(e - s) if 2 * ov >= b - a else ov, n)
        if best is None or key[:2] > best[:2]:
            best = key
    return ("host: " + best[2][:70] if best
            else "host: no op or CUDA call traced (Python)")
