"""Termination conditions of the `Solver` loop (counterpart of
`deeplearning4j_tpu.optimize.terminations`).

Parity: reference `optimize/terminations/` — `EpsTermination.java`,
`Norm2Termination.java`, `ZeroDirection.java`.  ``extras`` holds the
iterate's gradient and search direction as tensors.
"""

from __future__ import annotations

import math

import torch


class TerminationCondition:
    def terminate(self, f_new: float, f_old: float, extras) -> bool:
        raise NotImplementedError


def _norm(extras, key: str):
    v = extras.get(key) if isinstance(extras, dict) else None
    return None if v is None else float(torch.linalg.vector_norm(
        torch.as_tensor(v)))


class EpsTermination(TerminationCondition):
    """Stop when the relative improvement falls below eps."""

    def __init__(self, eps: float = 1e-4, tolerance: float = 1e-10):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, f_new: float, f_old: float, extras) -> bool:
        if not math.isfinite(f_new) or not math.isfinite(f_old):
            return False
        return abs(f_old - f_new) <= self.tolerance + self.eps * abs(f_old)


class Norm2Termination(TerminationCondition):
    """Stop when the gradient's 2-norm drops below the floor."""

    def __init__(self, gradient_norm_floor: float = 1e-6):
        self.floor = gradient_norm_floor

    def terminate(self, f_new: float, f_old: float, extras) -> bool:
        n = _norm(extras, "grad")
        return n is not None and n < self.floor


class ZeroDirectionTermination(TerminationCondition):
    """Stop when the search direction is the zero vector."""

    def terminate(self, f_new: float, f_old: float, extras) -> bool:
        n = _norm(extras, "direction")
        return n is not None and n == 0.0
