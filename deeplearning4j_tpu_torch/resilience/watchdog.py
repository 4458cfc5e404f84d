"""Step watchdog: bound the wall-clock of a device step (counterpart of
`deeplearning4j_tpu.resilience.watchdog`).

A wedged device runtime (stuck collective, hung kernel, deadlocked host
callback) hangs `fit_batch` forever — the reference's failure story for
this was the heartbeat reaper in the scaleout tier.  Per-process the
equivalent is a watchdog: the step runs on a worker thread and the caller
joins with a timeout; blowing the timeout raises a structured
`StepTimeoutError` instead of wedging the job.

The abandoned step thread CANNOT be killed (Python has no thread kill,
and the hang is usually inside a C extension anyway) — it is left as a
daemon and the training state it may still mutate must be considered
lost.  Recovery is restart-from-checkpoint, which is exactly what the
supervisor does with the report.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from deeplearning4j_tpu_torch.resilience.faults import (
    HANG,
    FaultReport,
    StepTimeoutError,
)


class StepWatchdog:
    def __init__(self, timeout: float):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.timeout = float(timeout)

    def run(self, fn: Callable[..., Any], *args, step: int = 0,
            **kwargs) -> Any:
        """Run ``fn(*args, **kwargs)`` with a wall-clock bound; returns its
        result or re-raises its exception.  On timeout raises
        :class:`StepTimeoutError` carrying a `FaultReport`."""
        box: dict = {}
        done = threading.Event()

        def target():
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — re-raised on caller
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=target, daemon=True,
                             name=f"step-watchdog-{step}")
        t.start()
        if not done.wait(self.timeout):
            report = FaultReport(
                kind=HANG, step=step, action="raise",
                detail=f"step exceeded watchdog timeout {self.timeout}s; "
                       f"training state is unsafe — restart from the "
                       f"latest checkpoint")
            raise StepTimeoutError(str(report), report=report)
        if "error" in box:
            raise box["error"]
        return box["result"]
