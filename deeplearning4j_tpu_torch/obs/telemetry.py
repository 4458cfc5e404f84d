"""Training telemetry, the training plane's feed into the registry
(counterpart of `deeplearning4j_tpu.obs.telemetry`).

`TrainingTelemetry` takes the listener slot (``net.add_listener``) with a
``sync_interval`` (off-interval steps never read the loss back from the
device) and ``score_only = False`` (under chunked fit it fires at chunk
boundaries only, where the model holds the iteration's state).  It
feeds ``train_steps_total``, ``train_loss``, ``train_step_seconds``,
``train_examples_per_sec``, ``train_grad_norm``, the loss-scale gauge
and its grow / backoff counters (from ``model.scaler_stats()``), and the
intervention counters (`record_intervention`; nothing in the port calls
it until the training supervisor is ported).  `snapshot()` returns the
set as a plain dict.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from deeplearning4j_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    STEP_TIME_BUCKETS,
)

# The intervention vocabulary (supervisor -> counter):
INTERVENTIONS = ("rollback", "poison_skip", "preemption", "checkpoint")


class TrainingTelemetry:
    """Iteration listener feeding training metrics into the registry.

    ``sync_interval`` gates host syncs exactly like
    `ScoreIterationListener`; ``batch_size`` (when known) turns step
    times into examples/sec.  Thread-safe: the listener fires on the
    training thread, `record_intervention` on whatever thread the
    supervisor runs on, and ``/metrics`` scrapes concurrently.
    """

    score_only = False      # chunk-aware: fire at chunk boundaries only

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 sync_interval: int = 10,
                 batch_size: Optional[int] = None, job: str = "train"):
        self.sync_interval = max(1, int(sync_interval))
        self.batch_size = batch_size
        self.job = str(job)
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None
        # iteration baseline 0: attach the listener BEFORE training so
        # the first firing (iteration k under chunking) counts its
        # whole k-step delta
        self._last_it = 0
        self._last_scale: Optional[float] = None
        self._last_overflows = 0
        self.steps_total = Counter(
            "train_steps_total", "optimizer steps observed")
        self.loss = Gauge("train_loss", "last listener-synced loss")
        self.step_time = Histogram(
            "train_step_seconds", "wall-clock per optimizer step",
            buckets=STEP_TIME_BUCKETS)
        self.examples_per_sec = Gauge(
            "train_examples_per_sec", "examples/sec over the last "
            "listener window")
        self.grad_norm = Gauge(
            "train_grad_norm", "last listener-synced gradient norm")
        self.loss_scale = Gauge(
            "train_loss_scale", "dynamic loss scale (precision plane)")
        self.loss_scale_grow = Counter(
            "train_loss_scale_grow_total", "loss-scale grow transitions")
        self.loss_scale_backoff = Counter(
            "train_loss_scale_backoff_total",
            "loss-scale backoff transitions (overflow steps skipped)")
        self.interventions = {
            kind: Counter(f"train_{kind}s_total",
                          f"supervisor {kind} interventions")
            for kind in INTERVENTIONS}
        if registry is not None:
            self.register_into(registry)

    def register_into(self, registry: MetricsRegistry,
                      **labels) -> "TrainingTelemetry":
        labels.setdefault("job", self.job)
        for m in (self.steps_total, self.loss, self.step_time,
                  self.examples_per_sec, self.grad_norm, self.loss_scale,
                  self.loss_scale_grow, self.loss_scale_backoff,
                  *self.interventions.values()):
            registry.register(m, **labels)
        return self

    # ---- the listener slot ------------------------------------------------

    def iteration_done(self, model, iteration: int, score: float) -> None:
        now = time.perf_counter()
        with self._lock:
            last_t, last_it = self._last_t, self._last_it
            self._last_t, self._last_it = now, int(iteration)
        steps = (int(iteration) - last_it if iteration > last_it
                 else self.sync_interval)   # rollback replay: count anew
        self.steps_total.inc(steps)
        self.loss.set(float(score))
        if last_t is not None and steps > 0:
            per_step = max(1e-9, (now - last_t) / steps)
            self.step_time.observe(per_step)
            if self.batch_size:
                self.examples_per_sec.set(self.batch_size / per_step)
        gn = getattr(model, "last_grad_norm", None)
        if gn is not None:
            # already host-synced by the listener machinery's due gate
            self.grad_norm.set(float(gn))
        stats = None
        get_stats = getattr(model, "scaler_stats", None)
        if callable(get_stats):
            stats = get_stats()
        if stats:
            self.observe_scaler(stats)

    def observe_scaler(self, stats: Dict) -> None:
        """Fold one ``scaler_stats()`` reading into the grow/backoff
        event counters (a scale increase is a grow; each new overflow
        step is a backoff)."""
        scale = float(stats.get("scale", 0.0))
        overflows = int(stats.get("overflow_count", 0))
        with self._lock:
            last_scale = self._last_scale
            last_overflows = self._last_overflows
            self._last_scale = scale
            self._last_overflows = max(overflows, last_overflows)
        self.loss_scale.set(scale)
        if last_scale is not None and scale > last_scale:
            self.loss_scale_grow.inc()
        if overflows > last_overflows:
            self.loss_scale_backoff.inc(overflows - last_overflows)

    # ---- supervisor hook --------------------------------------------------

    def record_intervention(self, kind: str) -> None:
        if kind not in self.interventions:
            raise ValueError(f"unknown intervention {kind!r} "
                             f"(one of {INTERVENTIONS})")
        self.interventions[kind].inc()

    # ---- snapshot (checkpoint manifests, tests) ---------------------------

    def snapshot(self) -> Dict:
        st = self.step_time.summary()
        out = {
            "steps": int(self.steps_total.value),
            "loss": self.loss.value,
            "examples_per_sec": round(self.examples_per_sec.value, 1),
            "grad_norm": self.grad_norm.value,
            "step_time_mean_s": round(st.get("mean", 0.0), 6),
            "interventions": {k: int(c.value)
                              for k, c in self.interventions.items()
                              if c.value},
        }
        if self.loss_scale.value:
            out["loss_scale"] = self.loss_scale.value
            out["loss_scale_grows"] = int(self.loss_scale_grow.value)
            out["loss_scale_backoffs"] = int(self.loss_scale_backoff.value)
        return out
