"""ServingEngine: a MultiLayerNetwork behind the micro-batcher and the
bucket ladder (counterpart of `deeplearning4j_tpu.serving.engine`).

The request path every endpoint shares:

    client threads -> MicroBatcher (coalesce within max_wait_ms)
                   -> BucketLadder (pad batch/length up the ladder)
                   -> MultiLayerNetwork.output_bucketed (one input
                      signature per ladder shape)
                   -> slice rows back per request

plus an explicit `warmup()` that runs every ladder shape before traffic,
and a signature guard: a dispatch shape outside the ladder's bound raises
instead of running an unbounded set of input shapes on the request path.
The JAX package counts XLA programs there; eager PyTorch compiles
nothing, so the port counts dispatch signatures (shape and dtype), as
`MultiLayerNetwork.forward_program_count` does.

On the card, a recurrent net whose LSTM layers take the fused scan runs
the LSTM kernel once a layer and dispatch, but only for fixed-length
requests: a ladder with length buckets pads with a mask, and a masked
dispatch takes the step loop (`uses_fused_scan`), as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry
from deeplearning4j_tpu_torch.obs.trace import TraceRecorder
from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
from deeplearning4j_tpu_torch.serving.bucketing import BucketLadder
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker,
    UnservableShapeError,
)


class ServingEngine:
    """Thread-safe batched inference over one model.

    `predict_proba(x)` / `predict(x)` accept a [n, ...] request (n up to
    `max_batch`) from any thread; rows ride whatever dispatch the
    batcher forms.  Sequence inputs ([n, T, ...]) are padded up the
    length ladder with per-example masks, so padding never changes
    results.  The net stays on its own device (the card unless it was
    built with ``device="cpu"``).
    """

    def __init__(self, net, ladder: Optional[BucketLadder] = None,
                 max_batch: Optional[int] = None, max_wait_ms: float = 2.0,
                 metrics: Optional[ServingMetrics] = None,
                 max_programs: Optional[int] = None,
                 input_dtype=np.float32,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 breaker_threshold: Optional[int] = 5,
                 breaker_cooldown_s: float = 1.0,
                 quantize: Optional[str] = None,
                 tracer: Optional[TraceRecorder] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tenants=None):
        self.net = net
        self.ladder = ladder if ladder is not None else BucketLadder()
        # `quantize="int8"` serves per-channel symmetric int8 weights.
        # The quantized view is built once — at warmup() normally, or
        # lazily before the first dispatch — so every request ever
        # served sees the SAME weights.
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize={quantize!r} "
                             f"(None or 'int8')")
        self.quantize = quantize
        self._qnet = None
        self._qlock = threading.Lock()
        # every request is cast to ONE dtype (the one warmup() runs) so
        # client-side dtype drift (float64 lists, int features) never
        # adds signatures or trips the guard; input_dtype=None keeps
        # integral inputs, and the guard then keys each dtype seen
        self.input_dtype = (None if input_dtype is None
                            else np.dtype(input_dtype))
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.tracer = tracer
        if registry is not None:
            self.metrics.register_into(registry, plane="classifier")
        self.max_programs = (max_programs if max_programs is not None
                             else self.ladder.program_bound)
        self._shape_lock = threading.Lock()
        self._seen_shapes = {}   # dtype str -> set of dispatch shapes
        self.breaker = (CircuitBreaker(
            failure_threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s,
            on_transition=self.metrics.set_breaker_state)
            if breaker_threshold else None)
        self.batcher = MicroBatcher(
            self._dispatch,
            max_batch=(max_batch if max_batch is not None
                       else self.ladder.max_batch),
            max_wait_ms=max_wait_ms, metrics=self.metrics,
            max_queue_depth=max_queue_depth,
            default_deadline_s=default_deadline_s,
            breaker=self.breaker, tracer=tracer, tenants=tenants)
        if self.batcher.max_batch > self.ladder.max_batch:
            raise ValueError(
                f"max_batch ({self.batcher.max_batch}) exceeds the "
                f"ladder's top bucket ({self.ladder.max_batch})")

    # ---- dispatch side ----------------------------------------------------

    def _model(self):
        """The dispatch target: the quantized view when quantize is set
        (built on first use, under a lock so concurrent first requests
        cannot quantize twice), else the float net."""
        if self.quantize is None:
            return self.net
        # double-checked: one unlocked read per dispatch after the first
        # request; the build happens exactly once, under the lock
        if self._qnet is None:  # noqa: LCK101 — DCL fast path, locked recheck below
            from deeplearning4j_tpu_torch.precision import QuantizedNet

            with self._qlock:
                if self._qnet is None:
                    self._qnet = QuantizedNet(self.net, dtype=self.quantize)
        return self._qnet  # noqa: LCK101 — set-once under _qlock, never cleared

    def _guard_shape(self, shape, dtype: str) -> None:
        """Signature guard: a dispatch shape beyond the ladder bound
        means bucketing failed — refuse it.  The bound is PER dtype: with
        the default `input_dtype` coercion only one dtype ever occurs,
        and with `input_dtype=None` each client dtype owns its own
        ladder-sized signature set."""
        with self._shape_lock:
            seen = self._seen_shapes.setdefault(dtype, set())
            if shape in seen:
                return
            if len(seen) >= self.max_programs:
                raise UnservableShapeError(
                    f"compile-count guard: dispatch shape {shape} "
                    f"({dtype}) would exceed the {self.max_programs}-"
                    f"program bound (seen: {sorted(seen)}; the port "
                    f"counts dispatch signatures, not compiles); the "
                    f"bucket ladder is not covering the traffic")
            seen.add(shape)

    def _dispatch(self, x: np.ndarray, mask: Optional[np.ndarray],
                  n_real: int) -> np.ndarray:
        bucket = self.ladder.batch_bucket(n_real)
        shape = (bucket,) + tuple(x.shape[1:])
        self._guard_shape(shape, x.dtype.str)
        out = self._model().output_bucketed(x, mask=mask,
                                            ladder=self.ladder)
        self.metrics.record_dispatch(n_real, bucket)
        return np.asarray(out)

    # ---- client side ------------------------------------------------------

    def _prepare(self, x):
        """Normalize dtype (every request serves as `input_dtype`, the
        dtype warmup() ran), then length-bucket sequence inputs (mask the
        padding).  Returns (x, mask, original_T)."""
        x = np.asarray(x)
        if self.input_dtype is not None and x.dtype != self.input_dtype:
            x = x.astype(self.input_dtype)
        if x.ndim >= 3 and self.ladder.length_buckets is not None:
            t = int(x.shape[1])
            x, mask = self.ladder.pad_length(x)
            return x, mask, t
        return x, None, None

    def predict_proba(self, x, timeout: Optional[float] = None,
                      deadline_s: Optional[float] = None,
                      request_id: Optional[str] = None,
                      tenant: Optional[str] = None) -> np.ndarray:
        """[n, ...] features -> [n, classes] output activations (or
        [n, T, classes] for sequence-tagging outputs, sliced back to the
        request's own T).  `deadline_s` rides the queue item so expired
        work is shed before dispatch; `request_id` names the request's
        trace (``X-Request-Id``); `tenant` is the billing identity the
        batcher's quota gate charges."""
        x, mask, t = self._prepare(x)
        out = self.batcher.submit(x, mask, timeout=timeout,
                                  deadline_s=deadline_s,
                                  request_id=request_id, tenant=tenant)
        if t is not None and out.ndim == 3 and out.shape[1] != t:
            out = out[:, :t]       # drop the length-bucket padding steps
        return out

    def predict(self, x, timeout: Optional[float] = None,
                deadline_s: Optional[float] = None,
                request_id: Optional[str] = None,
                tenant: Optional[str] = None) -> np.ndarray:
        """[n, ...] features -> [n] argmax class indices."""
        return np.argmax(self.predict_proba(x, timeout=timeout,
                                            deadline_s=deadline_s,
                                            request_id=request_id,
                                            tenant=tenant),
                         axis=-1)

    # ---- lifecycle --------------------------------------------------------

    def warmup(self, example: np.ndarray) -> int:
        """Run every ladder shape once from one example row's shape
        (`example` is [...] or [1, ...]); returns the number of shapes
        warmed.  Run this before traffic: afterwards no request adds a
        signature (the guard enforces it), and on the card the kernel
        library is built.  With `quantize` set, the weights are quantized
        HERE, so the warmed dispatches are the int8 ones."""
        model = self._model()
        example = np.asarray(example)
        row = (example[0] if example.ndim > 1 and example.shape[0] == 1
               else example)
        lengths = ([None] if row.ndim < 2 or self.ladder.length_buckets
                   is None else list(self.ladder.length_buckets))
        warmed = 0
        dt = self.input_dtype if self.input_dtype is not None else np.float32
        for b in self.ladder.batch_buckets:
            for t in lengths:
                shape = (b,) + ((t,) + row.shape[1:] if t is not None
                                else row.shape)
                x = np.zeros(shape, dt)
                mask = (np.ones((b, t), np.float32) if t is not None
                        else None)
                # straight to the model — warmup is not traffic, so it
                # registers shapes with the guard but not the metrics
                wshape = (b,) + tuple(x.shape[1:])
                self._guard_shape(wshape, x.dtype.str)
                model.output_bucketed(x, mask=mask, ladder=self.ladder)
                warmed += 1
        return warmed

    def stats(self) -> Dict:
        """The classifier section of ``/serving/stats``: the metrics
        snapshot, the ladder, the signatures dispatched
        (``compiled_programs``, the JAX package's key) against their
        bound, and the quantization report.  ``compiles_total`` is the
        JAX package's count of XLA compiles in this engine's dispatches;
        an eager forward compiles no program, so the port's is 0."""
        out = self.metrics.snapshot()
        out["bucket_ladder"] = {
            "batch": list(self.ladder.batch_buckets),
            "length": (list(self.ladder.length_buckets)
                       if self.ladder.length_buckets else None)}
        with self._shape_lock:
            out["compiled_programs"] = sum(
                len(s) for s in self._seen_shapes.values())
        out["program_bound"] = self.max_programs
        out["compiles_total"] = 0
        out["accepting"] = self.accepting
        out["quantize"] = self.quantize
        # read WITHOUT _qlock: _model() holds it for the whole first
        # build, and a stats scrape must not stall behind it; the
        # reference is published once, after the view is built
        qnet = self._qnet  # noqa: LCK101 — set-once publish; locking would stall scrapes on the first build
        if qnet is not None:
            out["quantization"] = qnet.quantization_report()
        return out

    @property
    def accepting(self) -> bool:
        """False once draining/stopped — the /readyz signal."""
        return self.batcher._accepting

    def ready(self) -> bool:
        """Readiness for traffic: accepting admissions and the circuit
        breaker is not open."""
        if not self.accepting:
            return False
        return self.breaker is None or self.breaker.state != "open"

    def begin_drain(self) -> None:
        """Stop admission; queued + in-flight requests still complete."""
        self.batcher.begin_drain()

    def drain(self, grace_s: float = 5.0) -> bool:
        """Graceful shutdown: stop admission, let in-flight work finish
        within `grace_s`, then stop the worker.  Returns True when the
        queue fully drained."""
        return self.batcher.drain(grace_s)

    def stop(self) -> None:
        self.batcher.stop()
