"""Structured fault reporting and the supervisor's exception taxonomy
(counterpart of `deeplearning4j_tpu.resilience.faults`).

Every recovery path surfaces a `FaultReport` rather than a bare string —
reports accumulate on the supervisor (`TrainingSupervisor.faults`) and ride
along on the exceptions that abort a run, so postmortems see *what* failed,
*when*, and what the supervisor did about it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

# Fault kinds (the closed vocabulary tests match on):
NAN_BATCH = "nan_batch"            # non-finite values in the input batch
NONFINITE_LOSS = "nonfinite_loss"  # step produced NaN/inf loss or grad norm
DIVERGENCE = "divergence"          # loss > K x rolling median, sustained
FETCH_ERROR = "fetch_error"        # data fetch failed (after retries)
HANG = "hang"                      # step exceeded the watchdog timeout
PREEMPTION = "preemption"          # SIGTERM / simulated preemption


@dataclass
class FaultReport:
    """One observed fault and the supervisor's response to it."""

    kind: str                      # one of the module constants above
    step: int                      # supervisor step at which it was seen
    detail: str = ""
    score: Optional[float] = None  # loss at the fault, when meaningful
    action: str = ""               # "skip" | "rollback" | "retry" | "abort"
                                   # | "checkpoint_and_exit" | "raise"
    exception: Optional[str] = None
    wall_time: float = field(default_factory=time.time)

    def __str__(self) -> str:
        bits = [f"[{self.kind}] step {self.step}"]
        if self.score is not None:
            bits.append(f"score={self.score:g}")
        if self.action:
            bits.append(f"action={self.action}")
        if self.detail:
            bits.append(self.detail)
        return " ".join(bits)


class SupervisorAbort(RuntimeError):
    """The supervisor exhausted its recovery budget (skip budget, rollback
    budget) — the run cannot make progress and a human must look."""

    def __init__(self, msg: str, report: Optional[FaultReport] = None):
        super().__init__(msg)
        self.report = report


class PreemptedError(RuntimeError):
    """Raised after a preemption-triggered emergency checkpoint was
    flushed; resume from the checkpoint directory to continue."""

    def __init__(self, msg: str, report: Optional[FaultReport] = None,
                 checkpoint_step: Optional[int] = None):
        super().__init__(msg)
        self.report = report
        self.checkpoint_step = checkpoint_step


class StepTimeoutError(RuntimeError):
    """A device step exceeded the watchdog timeout.  The step's thread may
    still be running, so training state is NOT safe to reuse — restart
    from the latest checkpoint."""

    def __init__(self, msg: str, report: Optional[FaultReport] = None):
        super().__init__(msg)
        self.report = report


class SimulatedPreemption(Exception):
    """Raised by the chaos harness at a configured step to simulate the
    platform's preemption notice; the supervisor handles it exactly like
    SIGTERM (emergency checkpoint, then stop)."""
