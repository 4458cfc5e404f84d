"""TrainingSupervisor: fault-tolerant driver around a step runner
(counterpart of `deeplearning4j_tpu.resilience.supervisor`).

Wraps an object exposing ``fit_batch(x, y, mask)`` + ``restore_train_state``
(`MultiLayerNetwork`, `DataParallelTrainer`) and provides the recovery
policies the bare training loops deliberately do not have:

- poison-batch skipping: host-side finiteness check on each incoming batch
  BEFORE the step runs (a NaN input would poison the parameters — the
  update applies before the loss ever reaches the host), up to a budget;
- health monitoring on the (already listener-synced) loss and grad norm:
  non-finite or sustainedly divergent steps roll the run back to the last
  good checkpoint with the learning rate scaled down;
- a checkpoint policy: every-N-steps, keep-last-K, best-score retention
  (layered on `runtime.checkpoint`'s atomic COMMIT-marked checkpoints);
- preemption handling: SIGTERM (opt-in handler) or a chaos-injected
  `SimulatedPreemption` flushes an emergency checkpoint at the next step
  boundary and stops the run resumably;
- a step watchdog bounding the wall-clock of each device step.

The supervisor owns WHEN to checkpoint/rollback; `runtime.checkpoint`
owns HOW (atomicity, manifest, retention).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pathlib
import signal
import threading
import time
from typing import Any, Iterable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.resilience.faults import (
    FETCH_ERROR,
    NAN_BATCH,
    NONFINITE_LOSS,
    PREEMPTION,
    FaultReport,
    PreemptedError,
    SimulatedPreemption,
    StepTimeoutError,
    SupervisorAbort,
)
from deeplearning4j_tpu_torch.resilience.health import HealthAction, HealthMonitor
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, backoff_delays
from deeplearning4j_tpu_torch.resilience.watchdog import StepWatchdog
from deeplearning4j_tpu_torch.tree import map_tree

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for one supervised run.  Defaults are production-shaped;
    tests shrink the windows/budgets."""

    checkpoint_dir: os.PathLike = "dl4j-ckpts"
    checkpoint_every: int = 50          # steps between periodic checkpoints
    keep: int = 3                       # keep-last-K retention
    keep_best: bool = True              # never GC the best-scoring ckpt
    save_updater: bool = True
    # fused multi-step dispatch: buffer this many (finiteness-checked)
    # batches and run them as ONE fused chunk (runner.fit_chunk_async),
    # syncing the per-step loss/grad-norm vectors to the host once per
    # chunk instead of once per step.  Divergence/NaN handling keeps
    # per-step granularity: a fault inside a chunk restores the pre-chunk
    # snapshot and replays that chunk at chunk_size=1.  1 = per-step
    # supervision (the legacy path).
    chunk_size: int = 1
    # poison batches
    check_batches: bool = True          # host-side isfinite() on x/y
    skip_budget: int = 5                # max poison batches skipped per run
    # divergence / rollback
    divergence_factor: float = 10.0     # loss > K x rolling median
    divergence_patience: int = 3        # consecutive suspect steps
    divergence_floor: float = 0.0       # absolute floor under the median
                                        # (set to the loss scale below
                                        # which fluctuations don't matter)
    health_window: int = 32
    min_history: int = 5
    lr_backoff: float = 0.5             # lr_scale *= this on each rollback
    max_rollbacks: int = 3
    # watchdog
    step_timeout: Optional[float] = None  # seconds; None disables
    # data fetch
    fetch_retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(max_attempts=3, base_delay=0.2,
                                            max_delay=5.0))


@dataclasses.dataclass
class RunReport:
    """What a supervised run did — returned by :meth:`TrainingSupervisor.run`."""

    steps: int = 0                      # total successful steps (cumulative)
    batches_seen: int = 0               # batches consumed this run() call
    skipped: int = 0                    # poison batches skipped (cumulative)
    rollbacks: int = 0                  # cumulative
    preempted: bool = False
    final_loss: Optional[float] = None
    lr_scale: float = 1.0
    faults: List[FaultReport] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        state = "preempted" if self.preempted else "completed"
        return (f"{state}: {self.steps} steps, {self.skipped} skipped, "
                f"{self.rollbacks} rollbacks, lr_scale {self.lr_scale:g}, "
                f"final loss {self.final_loss}")


class TrainingSupervisor:
    """Drives a runner's ``fit_batch`` under the resilience policies.

    The runner must expose ``fit_batch(x, y, mask=None) -> float`` and
    ``restore_train_state(step, params, updater_state)``; the underlying
    net (``runner.net`` when present, else the runner itself) supplies
    params/updater state for checkpointing and the ``lr_scale`` hook.
    """

    def __init__(self, runner, config: ResilienceConfig, telemetry=None):
        self.runner = runner
        self.config = config
        # an optional `obs.TrainingTelemetry` receives every supervisor intervention
        # (rollback / poison_skip / preemption / checkpoint) as a
        # counter, and its snapshot is embedded in each checkpoint
        # manifest so a resumed run can see its predecessor's telemetry
        self.telemetry = telemetry
        self.net = getattr(runner, "net", runner)
        if self.net.params is None:
            self.net.init()
        self.health = HealthMonitor(
            divergence_factor=config.divergence_factor,
            patience=config.divergence_patience,
            window=config.health_window,
            min_history=config.min_history,
            median_floor=config.divergence_floor)
        self.watchdog = (StepWatchdog(config.step_timeout)
                         if config.step_timeout else None)
        self.faults: List[FaultReport] = []
        self.skipped = 0
        self.rollbacks = 0
        # Cumulative batches fetched across runs/resumes — can exceed
        # `step` (skipped poison batches consume a batch but no update);
        # persisted in checkpoints so resume can fast-forward the stream.
        self.batches_consumed = 0
        self.step = int(getattr(runner, "_iteration", 0))
        self.last_loss: Optional[float] = None
        self._preempt = threading.Event()
        self._prev_sigterm = None
        self._dir = pathlib.Path(config.checkpoint_dir)

    # ---- preemption --------------------------------------------------------

    def install_signal_handlers(self) -> None:
        """Route SIGTERM (the cloud preemption notice) to a resumable stop:
        the handler only sets a flag; the emergency checkpoint is written
        on the training thread at the next step boundary (writing from a
        signal handler mid-step would race the in-place update).
        Main-thread only (CPython restricts signal.signal)."""
        self._prev_sigterm = signal.signal(
            signal.SIGTERM, lambda signum, frame: self.request_preemption())

    def uninstall_signal_handlers(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    def request_preemption(self) -> None:
        """Async-signal-safe: flag the run to stop at the next boundary."""
        self._preempt.set()

    @property
    def preemption_requested(self) -> bool:
        return self._preempt.is_set()

    # ---- checkpointing -----------------------------------------------------

    def _published_updater_state(self):
        from deeplearning4j_tpu_torch.runtime.checkpoint import (
            published_updater_state,
        )

        return (published_updater_state(self.net)
                if self.config.save_updater else None)

    def checkpoint(self, score: Optional[float] = None,
                   extra: Optional[dict] = None) -> None:
        from deeplearning4j_tpu_torch.runtime.checkpoint import save_checkpoint

        # runners that carry training state outside the net (local-SGD
        # replicas, sharded optimizer moments) publish a current snapshot
        # first: net.params alone can be stale mid-sync-window
        publish = getattr(self.runner, "publish_train_state", None)
        if callable(publish):
            publish()
        merged = {"lr_scale": float(self.net._lr_scale),
                  "batches_consumed": int(self.batches_consumed),
                  **(extra or {})}
        if self.telemetry is not None:
            self.telemetry.record_intervention("checkpoint")
            # snapshot the training telemetry into the manifest: step
            # rate, loss-scale events and the intervention ledger
            # survive the pod with the checkpoint
            merged["telemetry"] = self.telemetry.snapshot()
        # a runner that knows its replica layout
        # (DataParallelTrainer.checkpoint_partition) gets sharded
        # snapshots: one shard file a replica and the partition spec in
        # the manifest, so a restore lands on any replica count
        spec = shards = None
        part = getattr(self.runner, "checkpoint_partition", None)
        if callable(part):
            info = part()
            spec, shards = info.get("spec"), info.get("shards")
        save_checkpoint(
            self._dir, self.step, self.net.params,
            updater_state=self._published_updater_state(),
            net_state=getattr(self.net, "state", None),
            extra=merged,
            keep=self.config.keep, score=score,
            keep_best=self.config.keep_best,
            spec=spec, shards=shards)

    def resume(self, directory: Optional[os.PathLike] = None) -> bool:
        """Restore the newest GOOD committed checkpoint (params, updater
        state, step counter, lr_scale) into the runner — the crash-safe
        resume entry point.  Shard checksums are verified; a corrupt
        newest step (flipped byte, truncated shard) is rejected with a
        logged reason and the previous good step restores instead
        (`load_checkpoint`'s fallback ladder); when EVERY committed step
        is corrupt the typed `CheckpointCorruptError` propagates —
        silently starting fresh would retrain the run.  The restored
        topology need not match this runner's replica count: the
        full-tree restore re-adopts into whatever mesh the runner holds
        (elastic N→M restart).  `directory` overrides the configured
        checkpoint dir (e.g. resuming a dead fleet member's snapshots).
        Returns False when the directory has no committed checkpoint
        yet."""
        from deeplearning4j_tpu_torch.runtime.checkpoint import (
            resume_train_state,
        )

        ckpt_dir = pathlib.Path(directory) if directory is not None \
            else self._dir
        restored = resume_train_state(ckpt_dir, self.runner,
                                      with_extra=True)
        if restored is None:
            return False
        step, extra = restored
        self.net.set_lr_scale(extra.get("lr_scale", 1.0))
        self.step = step
        self.batches_consumed = int(extra.get("batches_consumed", step))
        self.health.reset()
        log.info("resumed from checkpoint step %d (lr_scale %g)",
                 step, self.net._lr_scale)
        return True

    def _moments_or_fresh(self, upd, params):
        """Updater state to restore: the checkpointed moments, or — when
        the checkpoint carried none (save_updater=False) — a FRESH init.
        Keeping the live moments instead would re-poison clean restored
        params the moment a NaN step's momentum is applied.  (Checkpoint
        restores go through `runtime.checkpoint.resume_train_state`,
        which applies the same policy; this copy serves the IN-MEMORY
        chunk-replay snapshot, which never touches disk.)"""
        return upd if upd is not None else self.net._updater.init(params)

    def _rollback(self, report: FaultReport) -> None:
        from deeplearning4j_tpu_torch.runtime.checkpoint import (
            resume_train_state,
        )

        self.rollbacks += 1
        report.action = "rollback"
        self.faults.append(report)
        if self.telemetry is not None:
            self.telemetry.record_intervention("rollback")
        if self.rollbacks > self.config.max_rollbacks:
            report.action = "abort"
            raise SupervisorAbort(
                f"rollback budget exhausted "
                f"({self.config.max_rollbacks}): {report}", report=report)
        step = resume_train_state(self._dir, self.runner)
        if step is None:
            # run() writes a step-0 checkpoint before the first step, so
            # this only happens when step() is driven by hand pre-ckpt.
            raise SupervisorAbort(
                f"cannot roll back: no committed checkpoint under "
                f"{self._dir}", report=report)
        new_scale = self.net._lr_scale * self.config.lr_backoff
        self.net.set_lr_scale(new_scale)
        self.step = step
        self.health.reset()
        log.warning("rolled back to step %d with lr_scale %g after %s",
                    step, new_scale, report)

    def _emergency_checkpoint(self, report: FaultReport) -> None:
        report.action = "checkpoint_and_exit"
        self.faults.append(report)
        if self.telemetry is not None:
            self.telemetry.record_intervention("preemption")
        # Written even mid-suspect-streak: losing everything since the
        # last periodic checkpoint is worse than a possibly-diverged but
        # flagged snapshot — the flag lets operators (and a future resume)
        # see the state was not confirmed healthy.
        self.checkpoint(score=self.last_loss,
                        extra={"preempt": True,
                               "suspect": self.health.suspect})
        log.warning("preemption: emergency checkpoint at step %d flushed",
                    self.step)

    # ---- the supervised step ----------------------------------------------

    def _batch_is_finite(self, x, y, mask=None) -> bool:
        for arr in (x, y, mask):
            if arr is None:
                continue
            if isinstance(arr, torch.Tensor):
                if arr.is_floating_point() and not bool(
                        torch.isfinite(arr).all()):
                    return False
                continue
            arr = np.asarray(arr)
            if (np.issubdtype(arr.dtype, np.floating)
                    and not np.isfinite(arr).all()):
                return False
        return True

    def supervised_step(self, x, y, mask=None) -> Optional[float]:
        """One guarded step.  Returns the loss, or None when the batch was
        skipped or the step was rolled back.  Raises PreemptedError after
        flushing an emergency checkpoint when preemption was requested."""
        report = self._maybe_preempt()
        if report is not None:
            # raised BEFORE counting the batch: it was fetched but never
            # trained, so resume's stream fast-forward must replay it
            raise PreemptedError(str(report), report=report,
                                 checkpoint_step=self.step)
        self.batches_consumed += 1
        if (self.config.check_batches
                and not self._batch_is_finite(x, y, mask)):
            self._poison_skip()
            return None
        return self._execute_step(x, y, mask)

    def _poison_skip(self) -> None:
        """Bookkeeping for one skipped poison batch (shared by the
        per-step and chunked loops); raises on budget exhaustion."""
        self.skipped += 1
        if self.telemetry is not None:
            self.telemetry.record_intervention("poison_skip")
        report = FaultReport(
            kind=NAN_BATCH, step=self.step, action="skip",
            detail=f"non-finite values in input batch "
                   f"({self.skipped}/{self.config.skip_budget} skips)")
        self.faults.append(report)
        if self.skipped > self.config.skip_budget:
            report.action = "abort"
            raise SupervisorAbort(
                f"poison-batch skip budget exhausted "
                f"({self.config.skip_budget}): {report}", report=report)
        log.warning("skipping poison batch: %s", report)

    def _execute_step(self, x, y, mask=None) -> Optional[float]:
        """The guarded train+health part of one step: no preemption or
        finiteness checks, no batch accounting — the chunk replay path
        re-enters here for batches that were already consumed/checked."""
        from deeplearning4j_tpu_torch.optimize.api import InvalidScoreError

        try:
            if self.watchdog is not None:
                loss = self.watchdog.run(self.runner.fit_batch, x, y, mask,
                                         step=self.step)
            else:
                loss = self.runner.fit_batch(x, y, mask)
            loss = float(loss)
        except InvalidScoreError as e:
            # A NanGuardListener (or any typed score guard) fired inside
            # the step — same recovery as observing the non-finite loss.
            self._rollback(FaultReport(
                kind=NONFINITE_LOSS, step=self.step, score=e.score,
                detail="typed score guard fired inside the step",
                exception=repr(e)))
            return None
        except StepTimeoutError as e:
            if e.report is not None:
                self.faults.append(e.report)
            raise
        grad_norm = self._grad_norm()
        action, report = self.health.observe(self.step, loss, grad_norm)
        if action is HealthAction.ROLLBACK:
            self._rollback(report)
            return None
        self.step = int(getattr(self.runner, "_iteration", self.step + 1))
        self.last_loss = loss
        if (self.step % max(1, self.config.checkpoint_every) == 0
                and not self.health.suspect):
            # never snapshot mid-suspect-streak: a rollback would restore
            # the possibly-diverged params as the "last good" state
            self.checkpoint(score=loss)
        return loss

    def _grad_norm(self) -> Optional[float]:
        g = getattr(self.net, "last_grad_norm", None)
        return None if g is None else float(g)

    # ---- fused-chunk supervision -------------------------------------------

    def _supports_chunks(self) -> bool:
        """A runner takes the fused-chunk path only when its
        `fit_chunk_async` works: `DataParallelTrainer` has the method in
        every mode but refuses it for local SGD."""
        return (hasattr(self.runner, "fit_chunk_async")
                and getattr(self.runner, "sync_every", 1) == 1)

    def _snapshot_train_state(self):
        """In-memory COPIES of (params, updater_state, layer state) — the
        pre-chunk rollback anchor, cloned on their device.  Copies are
        required, not references: the chunk's steps update the tensors
        in place."""
        publish = getattr(self.runner, "publish_train_state", None)
        if callable(publish):
            publish()

        def copy(tree):
            return (None if tree is None else map_tree(
                lambda a: (a.detach().clone()
                           if isinstance(a, torch.Tensor) else a), tree))

        return (copy(self.net.params), copy(self.net.updater_state),
                copy(getattr(self.net, "state", None)))

    def _restore_snapshot(self, step: int, snapshot) -> None:
        params, upd, net_state = snapshot
        self.runner.restore_train_state(
            step, params, self._moments_or_fresh(upd, params), net_state)
        self.step = step

    def _supervise_chunk(self, batches) -> None:
        """Dispatch `batches` (already finiteness-checked) as ONE fused
        chunk, then feed the per-step loss/grad-norm vectors — one host
        sync total — through the health monitor at per-step granularity.
        Any flagged step restores the pre-chunk snapshot and replays the
        whole chunk at chunk_size=1 through `_execute_step`, where the
        normal rollback/backoff machinery handles the faulty step."""
        import copy as copy_mod

        from deeplearning4j_tpu_torch.optimize.api import InvalidScoreError
        from deeplearning4j_tpu_torch.runtime.fused import stack_batches

        if len(batches) == 1:
            self._execute_step(*batches[0])
            return
        snap_step = self.step
        snapshot = self._snapshot_train_state()
        health0 = copy_mod.deepcopy(self.health)
        chunk = stack_batches(batches)
        fault: Optional[FaultReport] = None

        def dispatch_and_sync():
            # The host sync happens INSIDE the (optional) watchdog
            # window: the queued launches return at once even when the
            # device is wedged — it is the read of the loss vector that
            # would hang.
            ls, gs = self.runner.fit_chunk_async(
                chunk.xs, chunk.ys, chunk.masks, chunk.weights)
            return (ls.float().cpu().numpy(), gs.float().cpu().numpy())

        try:
            if self.watchdog is not None:
                # one watchdog window bounds the whole chunk: K steps of
                # budget, since the fused dispatch IS K steps
                wd = StepWatchdog(self.config.step_timeout * len(batches))
                losses, gnorms = wd.run(dispatch_and_sync, step=self.step)
            else:
                losses, gnorms = dispatch_and_sync()
        except InvalidScoreError as e:
            fault = FaultReport(
                kind=NONFINITE_LOSS, step=self.step, score=e.score,
                detail="typed score guard fired inside a fused chunk",
                exception=repr(e))
        except StepTimeoutError as e:
            if e.report is not None:
                self.faults.append(e.report)
            raise
        if fault is None:
            for i in range(len(batches)):
                action, report = self.health.observe(
                    snap_step + i, float(losses[i]), float(gnorms[i]))
                if action is HealthAction.ROLLBACK:
                    fault = report
                    break
            else:
                self.step = int(getattr(self.runner, "_iteration",
                                        snap_step + len(batches)))
                self.last_loss = float(losses[-1])
                every = max(1, self.config.checkpoint_every)
                if (self.step // every > snap_step // every
                        and not self.health.suspect):
                    self.checkpoint(score=self.last_loss)
                return
        # A step inside the chunk misbehaved: rewind state AND health to
        # the chunk boundary (its observations are discarded with it),
        # then replay per-batch so rollback granularity stays one step.
        self.faults.append(FaultReport(
            kind=fault.kind, step=fault.step, action="replay",
            detail=f"fused chunk of {len(batches)} replayed at "
                   f"chunk_size=1 after {fault.kind} at step {fault.step}"))
        self.health = health0
        self._restore_snapshot(snap_step, snapshot)
        for x, y, mask in batches:
            self._execute_step(x, y, mask)

    def _run_chunked(self, data, chunk_size: int,
                     max_steps: Optional[int]) -> RunReport:
        """The chunked supervised loop: fetch (with retry) and
        finiteness-check batches one at a time, buffer the good ones, and
        flush every `chunk_size` as one fused dispatch.  Preemption is
        honored at chunk boundaries — already-fetched batches are trained
        before the emergency checkpoint so `batches_consumed` stays equal
        to trained + skipped and resume's fast-forward replays nothing
        and loses nothing."""
        if not self._has_checkpoint():
            self.checkpoint(score=None)  # rollback anchor before step 1
        it = iter(data)
        batches_seen = 0
        preempted = False
        pending: list = []
        pending_key = None

        def flush():
            if pending:
                self._supervise_chunk(pending)
                pending.clear()

        def batch_key(x, y, mask):
            # same grouping rule as fused.assemble_chunks: stacked
            # batches must agree on feature/label shapes and mask
            # presence (a buffer mixing them would mis-stack or silently
            # drop masks)
            return (np.shape(x)[1:], np.shape(y)[1:],
                    None if mask is None else np.shape(mask)[1:])

        while max_steps is None or self.step < max_steps:
            if self._preempt.is_set():
                flush()
                self._maybe_preempt()   # emergency checkpoint + report
                preempted = True
                break
            try:
                item = self._fetch(it)
            except StopIteration:
                break
            except SimulatedPreemption:
                self.request_preemption()
                continue
            batches_seen += 1
            x, y, mask = _normalize(item)
            self.batches_consumed += 1
            if (self.config.check_batches
                    and not self._batch_is_finite(x, y, mask)):
                self._poison_skip()
                continue
            key = batch_key(x, y, mask)
            if pending and key != pending_key:
                flush()   # shape/mask-presence change: new chunk group
            pending_key = key
            pending.append((x, y, mask))
            cap = (chunk_size if max_steps is None
                   else min(chunk_size, max_steps - self.step))
            if len(pending) >= cap:
                flush()
        if not preempted:
            flush()
        if (not preempted and self.last_loss is not None
                and not self.health.suspect):
            self.checkpoint(score=self.last_loss)
        return RunReport(
            steps=self.step, batches_seen=batches_seen,
            skipped=self.skipped, rollbacks=self.rollbacks,
            preempted=preempted, final_loss=self.last_loss,
            lr_scale=float(self.net._lr_scale), faults=list(self.faults))

    # ---- the supervised loop ----------------------------------------------

    def run(self, data: Iterable, *, max_steps: Optional[int] = None,
            chunk_size: Optional[int] = None) -> RunReport:
        """Drive the runner over ``data`` (an iterable of (x, y[, mask])
        tuples or DataSet-like objects) under the full policy set.

        Batch fetches retry with backoff per ``config.fetch_retry`` —
        ``data`` should be a restartable iterator (e.g. `ChaosDataSource`,
        a prefetcher), not a bare generator, for retries to help (a
        generator dies on the exception it raises).  StopIteration ends
        the run; `SimulatedPreemption` from the source is handled like
        SIGTERM.  Returns a `RunReport`; a preempted run returns (rather
        than raises) with ``preempted=True`` so callers can checkpoint
        logs and exit cleanly.

        ``chunk_size`` (default ``config.chunk_size``) > 1 dispatches the
        run in fused multi-step chunks — one host sync per chunk, health
        checks on the per-step loss/grad-norm vectors, faults replayed at
        per-step granularity (see ``_run_chunked``); requires a runner
        with ``fit_chunk_async`` (`MultiLayerNetwork`, plain-sync
        `DataParallelTrainer`).
        """
        k = chunk_size if chunk_size is not None else self.config.chunk_size
        if k > 1 and self._supports_chunks():
            return self._run_chunked(data, int(k), max_steps)
        if k > 1:
            log.warning(
                "chunk_size=%s requested but %s has no fused chunk path "
                "(local-SGD trainers carry per-replica state); "
                "supervising per-step", k,
                type(self.runner).__name__)
        if not self._has_checkpoint():
            self.checkpoint(score=None)  # rollback anchor before step 1
        it = iter(data)
        batches_seen = 0
        preempted = False
        while max_steps is None or self.step < max_steps:
            if self._maybe_preempt():
                preempted = True
                break
            try:
                item = self._fetch(it)
            except StopIteration:
                break
            except SimulatedPreemption:
                self.request_preemption()
                continue
            batches_seen += 1
            x, y, mask = _normalize(item)
            try:
                self.supervised_step(x, y, mask)
            except PreemptedError:
                preempted = True
                break
        if (not preempted and self.last_loss is not None
                and not self.health.suspect):
            # Final checkpoint so a completed run is always resumable —
            # unless a divergence-suspect streak is live: then the last
            # healthy periodic checkpoint stays the newest anchor rather
            # than possibly-diverged end-of-stream params.
            self.checkpoint(score=self.last_loss)
        return RunReport(
            steps=self.step, batches_seen=batches_seen,
            skipped=self.skipped, rollbacks=self.rollbacks,
            preempted=preempted, final_loss=self.last_loss,
            lr_scale=float(self.net._lr_scale), faults=list(self.faults))

    def _maybe_preempt(self) -> Optional[FaultReport]:
        """Flush the emergency checkpoint when preemption was requested;
        a non-None report means the caller should stop the run."""
        if not self._preempt.is_set():
            return None
        report = FaultReport(kind=PREEMPTION, step=self.step,
                             detail="preemption requested")
        self._emergency_checkpoint(report)
        return report

    def _has_checkpoint(self) -> bool:
        from deeplearning4j_tpu_torch.runtime.checkpoint import latest_checkpoint

        return latest_checkpoint(self._dir) is not None

    def _fetch(self, it):
        """next(it) under the fetch retry policy.  StopIteration and
        SimulatedPreemption propagate (not retryable); retryable failures
        that survive the budget are recorded and re-raised.

        Guard against generator-backed sources: a generator that raised
        is CLOSED, so retrying next() yields StopIteration — which must
        surface the original fetch error, not masquerade as a clean
        end-of-data (the run would 'complete' half-trained)."""
        # Hand-rolled rather than retry.retry_call: the closed-generator
        # guard must distinguish a StopIteration on the FIRST attempt
        # (clean end of data) from one on a RETRY (the source died on the
        # previous error) — retry_call's interface cannot express that.
        policy = self.config.fetch_retry
        delays = backoff_delays(policy)
        last_err: Optional[Exception] = None
        for attempt in range(1, policy.max_attempts + 1):
            try:
                return next(it)
            except StopIteration:
                if last_err is not None:
                    self._record_fetch_abort(last_err, note="source died "
                                             "on the previous error")
                    raise last_err
                raise
            except policy.retryable as e:
                last_err = e
                if attempt == policy.max_attempts:
                    self._record_fetch_abort(e)
                    raise
                delay = next(delays)
                self._on_fetch_retry(attempt, e, delay)
                time.sleep(delay)
        raise AssertionError("unreachable: fetch retry loop fell through")

    def _record_fetch_abort(self, e: Exception, note: str = "") -> None:
        self.faults.append(FaultReport(
            kind=FETCH_ERROR, step=self.step, action="abort",
            detail=("batch fetch failed after "
                    f"{self.config.fetch_retry.max_attempts} attempts"
                    + (f" ({note})" if note else "")),
            exception=repr(e)))

    def _on_fetch_retry(self, attempt: int, e: Exception,
                        delay: float) -> None:
        self.faults.append(FaultReport(
            kind=FETCH_ERROR, step=self.step, action="retry",
            detail=f"fetch attempt {attempt} failed; retrying in "
                   f"{delay:.2f}s", exception=repr(e)))
        log.warning("batch fetch failed (attempt %d): %r — retrying in "
                    "%.2fs", attempt, e, delay)


def _normalize(item) -> Tuple[Any, Any, Any]:
    """One batch item -> (x, y, mask).  Accepts (x, y) / (x, y, mask)
    tuples and DataSet-like objects (.features/.labels/.mask)."""
    if isinstance(item, tuple):
        if len(item) not in (2, 3):
            raise ValueError(f"batch tuple must be (x, y[, mask]), "
                             f"got length {len(item)}")
        return (item + (None,))[:3]
    return (item.features, item.labels, getattr(item, "mask", None))
