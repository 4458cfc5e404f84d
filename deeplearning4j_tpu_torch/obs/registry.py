"""Metrics registry (counterpart of `deeplearning4j_tpu.obs.registry`).

- `Counter` / `Gauge` / `Histogram`: thread-safe metric primitives.  Each
  instance stands alone (a `ServingMetrics` owns its own set and reads
  them for ``/serving/stats``); registering one into a `MetricsRegistry`
  also publishes it on ``/metrics`` under a label set (``plane="lm"``),
  so the stats endpoint and the scrape endpoint read the same cells.
- `MetricsRegistry`: ``register`` / ``counter`` / ``gauge`` /
  ``histogram``, ``register_collector`` for sample sets computed at
  scrape time, and ``exposition()``, the Prometheus text format 0.0.4
  (# HELP / # TYPE / samples; histograms as cumulative ``_bucket``
  lines plus ``_sum`` / ``_count``).  Given the same calls, the text is
  byte-equal to the JAX package's.

Stdlib only.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default buckets for request-latency histograms (seconds).  Chosen to
# straddle the serving plane's observed range: sub-ms dispatch overhead
# up through multi-second overload tails.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Wider buckets for training-step times (seconds): steps span ~ms (tiny
# CPU nets) to minutes (flagship chunks).
STEP_TIME_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                     10.0, 30.0, 60.0, 300.0)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class Counter:
    """Monotonic counter.  ``inc()`` from any thread; ``value`` to read."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Set-to-current-value gauge.  ``fn`` makes it a callback gauge:
    the value is computed at read/scrape time (e.g. uptime)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = _check_name(name)
        self.help = help
        self._fn = fn
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: cumulative ``le``
    buckets plus ``_sum``/``_count``).  ``summary()`` additionally
    estimates percentiles by linear interpolation inside the bucket —
    coarse next to an exact reservoir, but free at any volume, which is
    what a scraped histogram is for."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS):
        self.name = _check_name(name)
        self.help = help
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(b <= 0 for b in bs if math.isfinite(b)):
            raise ValueError(f"histogram {name}: buckets must be positive")
        self.buckets = bs                      # finite upper bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)     # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        while i < len(self.buckets) and v > self.buckets[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count)] including the +Inf bucket."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for le, c in zip(self.buckets + (math.inf,), counts):
            running += c
            out.append((le, running))
        return out

    def _quantile_locked(self, counts: List[int], q: float) -> float:
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = q * total
        running = 0.0
        lo = 0.0
        for le, c in zip(self.buckets + (math.inf,), counts):
            if running + c >= rank:
                if not math.isfinite(le):
                    return lo                    # best lower bound
                frac = (rank - running) / c if c else 0.0
                return lo + (le - lo) * frac
            running += c
            lo = le
        return lo

    def summary(self) -> Dict[str, float]:
        """{count, mean, p50, p95, p99} in the observed unit (estimates
        interpolated from the bucket boundaries; empty -> {count: 0})."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        if total == 0:
            return {"count": 0}
        return {"count": total,
                "mean": s / total,
                "p50": self._quantile_locked(counts, 0.50),
                "p95": self._quantile_locked(counts, 0.95),
                "p99": self._quantile_locked(counts, 0.99)}


# One collector sample: (name, kind, help, labels, value).  Histograms
# from collectors are not supported — register the Histogram object.
Sample = Tuple[str, str, str, Dict[str, str], float]


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2 ** 53 else repr(f)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace(
            "\n", r"\n").replace('"', r'\"')
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


class MetricsRegistry:
    """A server's published metric set.

    ``register(metric, **labels)`` publishes a metric instance under a
    label set; re-registering the same (name, labels) REPLACES the old
    instance — a rolling weight swap's fresh engine takes over its
    predecessor's series instead of double-reporting.  Metrics with the
    same name but different labels render as one family (kind/help must
    agree).  ``register_collector(fn)`` adds a callable returning
    `Sample` tuples evaluated at scrape time.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (name, sorted-label-items) -> (metric, labels)
        self._metrics: Dict[Tuple, Tuple[object, Dict[str, str]]] = {}
        self._collectors: List[Callable[[], Iterable[Sample]]] = []
        self._created = time.monotonic()

    # ---- registration -----------------------------------------------------

    def register(self, metric, **labels):
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        labels = {k: str(v) for k, v in labels.items()}
        key = (metric.name, tuple(sorted(labels.items())))
        with self._lock:
            for (name, _), (m, _l) in self._metrics.items():
                if name == metric.name and m.kind != metric.kind:
                    raise ValueError(
                        f"metric {name} already registered as {m.kind}, "
                        f"cannot re-register as {metric.kind}")
            self._metrics[key] = (metric, labels)
        return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self.register(Counter(name, help), **labels)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None, **labels) -> Gauge:
        return self.register(Gauge(name, help, fn=fn), **labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = LATENCY_BUCKETS,
                  **labels) -> Histogram:
        return self.register(Histogram(name, help, buckets=buckets),
                             **labels)

    def register_collector(self,
                           fn: Callable[[], Iterable[Sample]]) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    @property
    def uptime_s(self) -> float:
        return time.monotonic() - self._created

    # ---- rendering --------------------------------------------------------

    def _families(self):
        """name -> {kind, help, entries: [(labels, metric_or_value)]},
        static registrations first, then collector samples."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        fams: Dict[str, Dict] = {}
        for metric, labels in metrics:
            fam = fams.setdefault(metric.name, {
                "kind": metric.kind, "help": metric.help, "entries": []})
            fam["entries"].append((labels, metric))
        for fn in collectors:
            for name, kind, help, labels, value in fn():
                fam = fams.setdefault(name, {
                    "kind": kind, "help": help, "entries": []})
                fam["entries"].append((dict(labels), float(value)))
        return fams

    def collect(self) -> Dict[str, Dict]:
        """Snapshot view for tests/JSON: name -> {kind, help, samples:
        [(labels, value)]} (histograms sample their count)."""
        out = {}
        for name, fam in self._families().items():
            samples = []
            for labels, entry in fam["entries"]:
                v = entry if isinstance(entry, float) else (
                    entry.count if isinstance(entry, Histogram)
                    else entry.value)
                samples.append((labels, v))
            out[name] = {"kind": fam["kind"], "help": fam["help"],
                         "samples": samples}
        return out

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        fams = self._families()
        for name in sorted(fams):
            fam = fams[name]
            if fam["help"]:
                esc = fam["help"].replace("\\", r"\\").replace("\n", r"\n")
                lines.append(f"# HELP {name} {esc}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for labels, entry in fam["entries"]:
                if isinstance(entry, Histogram):
                    for le, c in entry.cumulative():
                        ll = dict(labels)
                        ll["le"] = _fmt_value(le)
                        lines.append(
                            f"{name}_bucket{_fmt_labels(ll)} {c}")
                    lines.append(f"{name}_sum{_fmt_labels(labels)} "
                                 f"{_fmt_value(entry.sum)}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} "
                                 f"{entry.count}")
                else:
                    v = entry if isinstance(entry, float) else entry.value
                    lines.append(
                        f"{name}{_fmt_labels(labels)} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"


EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
