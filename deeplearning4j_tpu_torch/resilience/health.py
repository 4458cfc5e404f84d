"""Per-step training health monitor (counterpart of
`deeplearning4j_tpu.resilience.health`).

Checks each step's loss (and, when available, gradient norm) for
finiteness and for divergence against a rolling median of recent healthy
losses.  Pure host-side bookkeeping — the supervisor feeds it floats it
already synced for listeners, so the monitor adds no device round-trips
of its own.
"""

from __future__ import annotations

import enum
import math
import statistics
from collections import deque
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.resilience.faults import (
    DIVERGENCE,
    NONFINITE_LOSS,
    FaultReport,
)


class HealthAction(enum.Enum):
    OK = "ok"
    ROLLBACK = "rollback"


class HealthMonitor:
    """Rolling-median divergence detector.

    - A non-finite loss or grad norm means the parameters themselves are
      already poisoned (the update was applied before the loss reached the
      host) → immediate ROLLBACK.
    - A finite loss above ``divergence_factor`` x the rolling median of
      the last ``window`` healthy losses is *suspect*; ``patience``
      consecutive suspect steps → ROLLBACK.  Suspect losses are NOT
      admitted into the window (they would drag the median toward the
      divergence and mask it).
    - Divergence needs history: no verdicts before ``min_history``
      healthy observations.
    """

    def __init__(self, divergence_factor: float = 10.0, patience: int = 3,
                 window: int = 32, min_history: int = 5,
                 median_floor: float = 0.0):
        if divergence_factor <= 1.0:
            raise ValueError(f"divergence_factor must be > 1, "
                             f"got {divergence_factor}")
        self.divergence_factor = float(divergence_factor)
        self.patience = max(1, int(patience))
        self.min_history = max(1, int(min_history))
        # Absolute floor under the rolling median: near convergence a
        # purely relative test turns benign fluctuations (1e-5 -> 1e-3)
        # into "divergence"; a floor at the scale below which the user
        # stops caring makes the ratio test K x max(median, floor).
        # 0.0 keeps the test purely relative.  Losses <= 0 (possible for
        # likelihood-style objectives) get no relative protection unless
        # a positive floor is set — ratios are meaningless there.
        self.median_floor = float(median_floor)
        self._losses: deque = deque(maxlen=int(window))
        self._streak = 0

    # ---- observations ------------------------------------------------------

    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None
                ) -> Tuple[HealthAction, Optional[FaultReport]]:
        """Record one step's loss; returns the recommended action."""
        loss = float(loss)
        if not math.isfinite(loss) or (
                grad_norm is not None and not math.isfinite(grad_norm)):
            what = (f"loss={loss}" if not math.isfinite(loss)
                    else f"grad_norm={grad_norm}")
            return HealthAction.ROLLBACK, FaultReport(
                kind=NONFINITE_LOSS, step=step, score=loss,
                detail=f"non-finite training signal ({what})")
        if len(self._losses) >= self.min_history:
            med = max(statistics.median(self._losses), self.median_floor)
            if med > 0.0 and loss > self.divergence_factor * med:
                self._streak += 1
                if self._streak >= self.patience:
                    self._streak = 0
                    return HealthAction.ROLLBACK, FaultReport(
                        kind=DIVERGENCE, step=step, score=loss,
                        detail=(f"loss {loss:g} > {self.divergence_factor:g}"
                                f" x median {med:g} for "
                                f"{self.patience} consecutive steps"))
                return HealthAction.OK, None  # suspect: hold out of window
        self._streak = 0
        self._losses.append(loss)
        return HealthAction.OK, None

    def reset(self) -> None:
        """Forget history — call after a rollback (the restored parameters
        belong to an older loss regime)."""
        self._losses.clear()
        self._streak = 0

    @property
    def suspect(self) -> bool:
        """True while inside a divergence-suspect streak — checkpoints
        taken now would snapshot possibly-diverged parameters."""
        return self._streak > 0

    @property
    def rolling_median(self) -> Optional[float]:
        return statistics.median(self._losses) if self._losses else None
