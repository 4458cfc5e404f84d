"""The observability plane (counterpart of `deeplearning4j_tpu.obs`).

- `registry`: Counter / Gauge / Histogram and `MetricsRegistry` with its
  Prometheus text exposition (``GET /metrics`` of the LM front and of
  `MetricsServer`);
- `trace`: request ids, spans, the bounded `TraceRecorder` ring behind
  ``GET /trace/recent`` and Chrome trace-event export;
- `telemetry`: `TrainingTelemetry`, the training listener behind
  ``train -metrics-port``;
- `http`: `MetricsServer`, the standalone training endpoint.

The JAX package's compile watcher listens to JAX's compile events and has
no counterpart here (ROADMAP.md, A0).
"""

from deeplearning4j_tpu_torch.obs.http import MetricsServer
from deeplearning4j_tpu_torch.obs.registry import (
    EXPOSITION_CONTENT_TYPE,
    LATENCY_BUCKETS,
    STEP_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from deeplearning4j_tpu_torch.obs.telemetry import TrainingTelemetry
from deeplearning4j_tpu_torch.obs.trace import (
    TraceRecorder,
    chrome_trace,
    new_request_id,
    span,
    trace,
)

__all__ = [
    "Counter",
    "EXPOSITION_CONTENT_TYPE",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
    "MetricsServer",
    "STEP_TIME_BUCKETS",
    "TraceRecorder",
    "TrainingTelemetry",
    "chrome_trace",
    "new_request_id",
    "span",
    "trace",
]
