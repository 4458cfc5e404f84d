"""StateTracker: the coordination store (counterpart of
`deeplearning4j_tpu.scaleout.statetracker`; a copy: the standard library
only).

Parity: reference `scaleout/api/statetracker/StateTracker.java:14` (~60
methods over Hazelcast IMaps — job queue, worker registry, heartbeat map,
update store, replication flags, counters, finish/isDone) plus the
persistence pair `LocalWorkRetriever.java` / `LocalFileUpdateSaver.java`
(re-serve saved work to reconnecting workers). Hazelcast's replicated maps
are replaced by one thread-safe store served either in-process (threads =
the reference's in-JVM test cluster) or over TCP (tracker_server.py)
across hosts.  The job and update queues carry what the performers
publish: host numpy trees, never device tensors.  The persisted file
names (``job_<id>.pkl``, ``update_<worker>.pkl``) are the JAX package's,
so a ``work_dir`` is read by either package.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.scaleout.api import Job


class StateTracker:
    def __init__(self, work_dir: Optional[str] = None):
        self._lock = threading.RLock()
        self._workers: Dict[str, dict] = {}
        self._heartbeats: Dict[str, float] = {}
        self._job_queue: deque = deque()
        self._current_jobs: Dict[str, Job] = {}
        self._updates: List[tuple] = []
        self._globals: Dict[str, Any] = {}
        self._counters: Dict[str, int] = {}
        self._done = threading.Event()
        self.work_dir = work_dir
        if work_dir:
            os.makedirs(work_dir, exist_ok=True)

    # -- worker registry + heartbeats (StateTracker.addWorker/getHeartBeats)
    def add_worker(self, worker_id: str, meta: Optional[dict] = None) -> None:
        with self._lock:
            self._workers[worker_id] = meta or {}
            self._heartbeats[worker_id] = time.monotonic()

    def remove_worker(self, worker_id: str) -> None:
        with self._lock:
            self._workers.pop(worker_id, None)
            self._heartbeats.pop(worker_id, None)
            orphan = self._current_jobs.pop(worker_id, None)
            if orphan is not None and not orphan.done:
                orphan.worker_id = None
                self._job_queue.appendleft(orphan)  # re-serve orphaned work

    def workers(self) -> List[str]:
        with self._lock:
            return list(self._workers)

    def heartbeat(self, worker_id: str) -> None:
        with self._lock:
            if worker_id in self._workers:
                self._heartbeats[worker_id] = time.monotonic()

    def heartbeats(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._heartbeats)

    def reap_stale(self, timeout: float) -> List[str]:
        """Remove workers silent ≥ timeout (MasterActor.java:141-160; the
        reference uses 120 s). Their in-flight jobs re-enter the queue."""
        now = time.monotonic()
        with self._lock:
            stale = [w for w, t in self._heartbeats.items()
                     if now - t >= timeout]
            for w in stale:
                self.remove_worker(w)
            return stale

    # -- job queue (addJobToCurrent / currentJobs / clearJob) ---------------
    def enqueue_job(self, job: Job) -> None:
        with self._lock:
            self._job_queue.append(job)
            if self.work_dir:
                self._persist_job(job)

    def request_job(self, worker_id: str) -> Optional[Job]:
        with self._lock:
            if worker_id in self._current_jobs:
                return None  # AlreadyWorking (reference actor message)
            if not self._job_queue:
                return None
            job = self._job_queue.popleft()
            job.worker_id = worker_id
            self._current_jobs[worker_id] = job
            return job

    def current_jobs(self) -> List[Job]:
        with self._lock:
            return list(self._current_jobs.values())

    def pending_jobs(self) -> int:
        with self._lock:
            return len(self._job_queue)

    def clear_job(self, worker_id: str) -> None:
        with self._lock:
            job = self._current_jobs.pop(worker_id, None)
            if job is not None:
                job.done = True
                if self.work_dir:
                    self._unpersist_job(job)

    # -- update store (addUpdate/updates) -----------------------------------
    # The reference keys updates by workerId in an IMap; a queue is used here
    # so a fast worker posting twice between master polls (Hogwild mode)
    # cannot overwrite its own earlier update.
    def add_update(self, worker_id: str, update: Any) -> None:
        with self._lock:
            self._updates.append((worker_id, update))
            self.increment("updates")
            if self.work_dir:
                self._persist_update(worker_id, update)

    def updates(self) -> List[tuple]:
        with self._lock:
            return list(self._updates)

    def drain_updates(self) -> List[tuple]:
        """Atomically take-and-clear — no update can slip between a read
        and a clear."""
        with self._lock:
            out, self._updates = self._updates, []
            return out

    def clear_updates(self) -> None:
        with self._lock:
            self._updates.clear()

    # -- shared globals (the reference's replicate/global IMap) -------------
    def set_global(self, key: str, value: Any) -> None:
        with self._lock:
            self._globals[key] = value

    def get_global(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._globals.get(key, default)

    # -- counters -----------------------------------------------------------
    def increment(self, key: str, by: int = 1) -> int:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by
            return self._counters[key]

    def counter(self, key: str) -> int:
        with self._lock:
            return self._counters.get(key, 0)

    # -- lifecycle (finish/isDone) ------------------------------------------
    def finish(self) -> None:
        self._done.set()

    def reset_done(self) -> None:
        """Re-arm the done flag for another run."""
        self._done.clear()

    def reset_run_state(self) -> None:
        """Full re-arm between runs (reference: a fresh IterativeReduce
        launch starts with clean coordination state): clears the done
        flag AND any stale queued/in-flight jobs and undrained updates a
        previous (possibly failed) run left behind — without touching
        worker registrations, globals, or persisted work."""
        self._done.clear()
        with self._lock:
            if self.work_dir:
                # the cleared jobs can never reach clear_job, so their
                # persisted files must go now or saved_work() leaks them
                for job in list(self._job_queue) + list(
                        self._current_jobs.values()):
                    self._unpersist_job(job)
            self._job_queue.clear()
            self._current_jobs.clear()
            self._updates.clear()

    def is_done(self) -> bool:
        return self._done.is_set()

    # -- persistence (LocalWorkRetriever / LocalFileUpdateSaver) ------------
    def _persist_job(self, job: Job) -> None:
        with open(os.path.join(self.work_dir, f"job_{job.job_id}.pkl"),
                  "wb") as f:
            pickle.dump(job.work, f)

    def _unpersist_job(self, job: Job) -> None:
        try:
            os.remove(os.path.join(self.work_dir, f"job_{job.job_id}.pkl"))
        except OSError:
            pass

    def _persist_update(self, worker_id: str, update: Any) -> None:
        with open(os.path.join(self.work_dir, f"update_{worker_id}.pkl"),
                  "wb") as f:
            pickle.dump(update, f)

    def saved_work(self) -> List[int]:
        """Job ids persisted but not yet cleared — what a reconnecting
        worker can resume (LocalWorkRetriever semantics)."""
        if not self.work_dir:
            return []
        return sorted(int(f[4:-4]) for f in os.listdir(self.work_dir)
                      if f.startswith("job_") and f.endswith(".pkl"))

    def load_saved_work(self, job_id: int) -> Any:
        with open(os.path.join(self.work_dir, f"job_{job_id}.pkl"),
                  "rb") as f:
            return pickle.load(f)
