"""Runtime-agnostic job model (counterpart of
`deeplearning4j_tpu.scaleout.api`; a copy: the standard library only).

Parity: reference `deeplearning4j-scaleout-api` — `Job.java` (workerId +
serializable work + result), `JobIterator`, `WorkerPerformer.java`
(perform/update), `JobAggregator`, `workrouter/WorkRouter.java`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional


@dataclass
class Job:
    """A unit of work: payload in, result out (reference Job.java)."""

    work: Any
    job_id: int = 0
    worker_id: Optional[str] = None
    result: Any = None
    done: bool = False


class JobIterator:
    """Hands out jobs; `has_next`/`next_job` mirror JobIterator.java."""

    def __init__(self, payloads):
        self._it: Iterator = iter(payloads)
        self._peek: Optional[Job] = None
        self._counter = itertools.count()

    def has_next(self) -> bool:
        if self._peek is None:
            try:
                self._peek = Job(next(self._it), job_id=next(self._counter))
            except StopIteration:
                return False
        return True

    def next_job(self, worker_id: Optional[str] = None) -> Job:
        if not self.has_next():
            raise StopIteration
        job, self._peek = self._peek, None
        job.worker_id = worker_id
        return job


class WorkerPerformer:
    """perform(job) computes job.result in place; update(state) installs the
    master's aggregated state before the next round (WorkerPerformer.java)."""

    def perform(self, job: Job) -> None:
        raise NotImplementedError

    def update(self, state: Any) -> None:
        raise NotImplementedError


class JobAggregator:
    """accumulate worker results, emit the aggregate (JobAggregator.java)."""

    def accumulate(self, result: Any) -> None:
        raise NotImplementedError

    def aggregate(self) -> Any:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class WorkRouter:
    """Decides when work is sent and whether a round barriers on all workers
    (reference workrouter/WorkRouter.java + BaseWorkRouter)."""

    #: wait for every routed job before aggregating?
    barrier: bool = True

    def route(self, tracker, iterator: JobIterator,
              workers: List[str]) -> List[Job]:
        raise NotImplementedError
