"""The observability plane (counterpart of `deeplearning4j_tpu.obs`).

- `registry`: Counter / Gauge / Histogram and `MetricsRegistry` with its
  Prometheus text exposition (``GET /metrics`` of the LM front and of
  `MetricsServer`);
- `trace`: request ids, spans, the bounded `TraceRecorder` ring behind
  ``GET /trace/recent`` and Chrome trace-event export on the profiler's
  clock, and the span store of the serving round and the LM train step
  (`obs.trace.spans`, read by the benchmark and `runtime.profiler`);
- `telemetry`: `TrainingTelemetry`, the training listener behind
  ``train -metrics-port``;
- `http`: `MetricsServer`, the standalone training endpoint;
- `compilewatch`: ``compiles_total{program_key=...}``, fed by the
  serving programs (`runtime.programs.Program`: a CUDA graph captured on
  the card), and the recent-event ring behind the request traces'
  ``xla_compile`` spans.
"""

from deeplearning4j_tpu_torch.obs.compilewatch import (
    COMPILE_EVENT,
    CompileWatcher,
    compile_scope,
    compile_watcher,
)
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
    "COMPILE_EVENT",
    "CompileWatcher",
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
    "compile_scope",
    "compile_watcher",
    "new_request_id",
    "span",
    "trace",
]
