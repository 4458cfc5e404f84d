"""Master/worker runtime + in-process simulator (counterpart of
`deeplearning4j_tpu.scaleout.runner`; a copy: the standard library only).

Parity: reference Akka runtime — `MasterActor.java` (poll loop :107-138
routes work and clears finished jobs; stale-worker reaper :141-160),
`WorkerActor.java` (1 s heartbeat :168-175; pick up job → perform → save
update), `BatchActor` (feeds the JobIterator), `ModelSavingActor` (periodic
checkpoints), and the two routing policies `IterativeReduceWorkRouter.java`
(barrier + aggregate) / `HogWildWorkRouter.java` (continuous routing, no
barrier). `DistributedRunner.simulate` is the in-process cluster — the
reference's `BaseTestDistributed`/`IRUnitDriver.simulateRun():232` test
backends — with threads for workers and either a local or TCP tracker.

This layer schedules COARSE work (rounds of training over host-resident
data, embedding corpus shards) and supervises liveness; what a job runs
on the card is the performer's business (`performers.py`).  Worker
threads of one process share the card and its default stream.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Callable, List, Optional

from deeplearning4j_tpu_torch.scaleout.api import (
    Job,
    JobAggregator,
    JobIterator,
    WorkerPerformer,
    WorkRouter,
)
from deeplearning4j_tpu_torch.scaleout.statetracker import StateTracker

MODEL_KEY = "model"


class IterativeReduceWorkRouter(WorkRouter):
    """One job per live worker per round; the master barriers on all of them
    before aggregating (IterativeReduceWorkRouter.java:34)."""

    barrier = True

    def route(self, tracker, iterator: JobIterator,
              workers: List[str]) -> List[Job]:
        routed = []
        for _ in workers:
            if not iterator.has_next():
                break
            job = iterator.next_job()
            tracker.enqueue_job(job)
            routed.append(job)
        return routed


class HogwildWorkRouter(WorkRouter):
    """Keep the queue saturated; updates apply as they arrive with no
    barrier (HogWildWorkRouter.java:32)."""

    barrier = False

    def __init__(self, depth: int = 2):
        self.depth = depth

    def route(self, tracker, iterator: JobIterator,
              workers: List[str]) -> List[Job]:
        routed = []
        target = max(1, self.depth * max(len(workers), 1))
        while tracker.pending_jobs() < target and iterator.has_next():
            job = iterator.next_job()
            tracker.enqueue_job(job)
            routed.append(job)
        return routed


class Worker:
    """Heartbeats + perform loop (WorkerActor.java:52)."""

    def __init__(self, tracker, performer: WorkerPerformer,
                 worker_id: Optional[str] = None,
                 heartbeat_interval: float = 1.0,
                 poll_interval: float = 0.01):
        self.tracker = tracker
        self.performer = performer
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self.heartbeat_interval = heartbeat_interval
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.performed = 0

    def start(self) -> "Worker":
        self.tracker.add_worker(self.worker_id)
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
        work = threading.Thread(target=self._work_loop, daemon=True)
        self._threads = [hb, work]
        for t in self._threads:
            t.start()
        return self

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set() and not self.tracker.is_done():
            self.tracker.heartbeat(self.worker_id)
            self._stop.wait(self.heartbeat_interval)

    def _work_loop(self) -> None:
        while not self._stop.is_set() and not self.tracker.is_done():
            job = self.tracker.request_job(self.worker_id)
            if job is None:
                self._stop.wait(self.poll_interval)
                continue
            self.performer.update(self.tracker.get_global(MODEL_KEY))
            self.performer.perform(job)
            self.tracker.add_update(self.worker_id, job.result)
            self.tracker.clear_job(self.worker_id)
            self.performed += 1

    def request_stop(self) -> None:
        """Signal the loops without blocking (stop() = request + drain)."""
        self._stop.set()

    def stop(self, timeout: float = 5.0) -> None:
        """Graceful shutdown: drain the work thread FIRST (an in-flight
        perform must finish and clear its job — deregistering mid-perform
        would re-queue the job while its update still posts, double-
        counting it), then deregister so a reused tracker doesn't carry
        dead workers into the next run. If the drain times out the
        registration is LEFT for the reaper (deregistering a live worker
        would reintroduce the double-count). Contrast kill(), which never
        deregisters."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        if any(t.is_alive() for t in self._threads):
            return  # still mid-perform: the reaper owns cleanup
        try:
            self.tracker.remove_worker(self.worker_id)
        except Exception:  # noqa: BLE001 - tracker may already be gone
            pass

    def kill(self) -> None:
        """Simulate failure: stop heartbeating AND working without
        deregistering — the master's reaper must notice."""
        self._stop.set()

    def join(self, timeout: float = 5.0) -> None:
        for t in self._threads:
            t.join(timeout)


class Master:
    """Routing / aggregation / reaping loop (MasterActor.java:107-160)."""

    def __init__(self, tracker: StateTracker, iterator: JobIterator,
                 aggregator: JobAggregator,
                 router: Optional[WorkRouter] = None,
                 apply_aggregate: Optional[Callable[[Any, Any], Any]] = None,
                 heartbeat_timeout: float = 120.0,
                 save_fn: Optional[Callable[[Any, int], None]] = None,
                 save_every: int = 0,
                 poll_interval: float = 0.01):
        self.tracker = tracker
        self.iterator = iterator
        self.aggregator = aggregator
        self.router = router or IterativeReduceWorkRouter()
        # How a round's aggregate becomes the new global model. Default:
        # replace (parameter averaging). Delta-style runtimes pass
        # `lambda model, agg: fold(model, agg)`.
        self.apply_aggregate = apply_aggregate or (lambda model, agg: agg)
        self.heartbeat_timeout = heartbeat_timeout
        self.save_fn = save_fn
        self.save_every = save_every
        self.poll_interval = poll_interval
        self.rounds = 0
        self.reaped: List[str] = []

    def _reap(self) -> None:
        stale = self.tracker.reap_stale(self.heartbeat_timeout)
        if stale:
            self.reaped.extend(stale)

    def _absorb_updates(self) -> None:
        updates = self.tracker.drain_updates()
        if not updates:
            return
        self.aggregator.reset()
        for _worker_id, upd in updates:
            self.aggregator.accumulate(upd)
        agg = self.aggregator.aggregate()
        model = self.apply_aggregate(self.tracker.get_global(MODEL_KEY), agg)
        self.tracker.set_global(MODEL_KEY, model)
        self.rounds += 1
        if self.save_fn and self.save_every and (
                self.rounds % self.save_every == 0):
            self.save_fn(model, self.rounds)

    def run(self, timeout: float = 300.0) -> Any:
        """Drive rounds until the iterator is exhausted and all work is
        done; returns the final global model."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._reap()
            in_flight = bool(self.tracker.current_jobs()
                             or self.tracker.pending_jobs())
            if not in_flight and not self.iterator.has_next():
                self._absorb_updates()  # final partial round
                break
            if not self.tracker.workers():
                time.sleep(self.poll_interval)
                continue
            if self.iterator.has_next():
                self.router.route(self.tracker, self.iterator,
                                  self.tracker.workers())
            if self.router.barrier:
                self._wait_round(deadline)
                self._absorb_updates()
            else:
                self._absorb_updates()
                time.sleep(self.poll_interval)
        else:
            raise TimeoutError("master did not finish before timeout")
        self.tracker.finish()
        return self.tracker.get_global(MODEL_KEY)

    def _wait_round(self, deadline: float) -> None:
        """Barrier: wait until every routed job is performed (or its worker
        is reaped and the job re-queued to a live one)."""
        while time.monotonic() < deadline:
            self._reap()
            if not self.tracker.current_jobs() and not self.tracker.pending_jobs():
                return
            if not self.tracker.workers() and self.tracker.pending_jobs():
                # every worker died: round cannot finish
                raise RuntimeError("no live workers with work pending")
            time.sleep(self.poll_interval)
        raise TimeoutError("round barrier timed out")


class DistributedRunner:
    """In-process cluster: master + N worker threads over one tracker
    (BaseTestDistributed / IRUnitDriver.simulateRun parity)."""

    def __init__(self, tracker: Optional[StateTracker] = None):
        self.tracker = tracker or StateTracker()

    def simulate(self, payloads, performer_factory: Callable[[], WorkerPerformer],
                 aggregator: JobAggregator, n_workers: int = 2,
                 initial_model: Any = None,
                 router: Optional[WorkRouter] = None,
                 apply_aggregate: Optional[Callable[[Any, Any], Any]] = None,
                 heartbeat_timeout: float = 120.0,
                 timeout: float = 300.0,
                 save_fn: Optional[Callable[[Any, int], None]] = None,
                 save_every: int = 0) -> Any:
        # Re-arm after a previous simulate(): the finished flag would make
        # freshly-started workers exit before the first job lands, and a
        # failed run's stale jobs/updates must not leak into this one.
        self.tracker.reset_run_state()
        if initial_model is not None:
            self.tracker.set_global(MODEL_KEY, initial_model)
        workers = [
            Worker(self.tracker, performer_factory(),
                   heartbeat_interval=0.05).start()
            for _ in range(n_workers)
        ]
        master = Master(self.tracker, JobIterator(payloads), aggregator,
                        router=router, apply_aggregate=apply_aggregate,
                        heartbeat_timeout=heartbeat_timeout,
                        save_fn=save_fn, save_every=save_every)
        try:
            return master.run(timeout=timeout)
        finally:
            for w in workers:
                w.request_stop()   # signal everyone before draining anyone
            for w in workers:
                w.stop()
