"""Optimization API surface: the algorithm enum and the listener SPI
(counterpart of `deeplearning4j_tpu.optimize.api`, unchanged).

Parity: reference `nn/api/OptimizationAlgorithm.java:42` and
`optimize/api/IterationListener.java` (fired from `BaseOptimizer.java:169`
and `MultiLayerNetwork.java:1112`).
"""

from __future__ import annotations

import enum
import logging
import math
from typing import Callable, Sequence

log = logging.getLogger(__name__)


class OptimizationAlgorithm(str, enum.Enum):
    STOCHASTIC_GRADIENT_DESCENT = "sgd"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"
    HESSIAN_FREE = "hessian_free"


class IterationListener:
    """Callback fired once per optimizer iteration with the score
    (reference `iterationDone(model, iteration)`).  ``score_only = True``
    declares that the listener reads only (iteration, score), never the
    model's parameters or state."""

    score_only = False

    def iteration_done(self, model, iteration: int, score: float) -> None:
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    """Logs the score every `print_iterations` iterations (reference
    `ScoreIterationListener.java:50`); ``sync_interval`` makes the
    network read the loss back from the device only on those
    iterations."""

    score_only = True

    def __init__(self, print_iterations: int = 10,
                 out: Callable[[str], None] | None = None):
        self.print_iterations = max(1, print_iterations)
        self.sync_interval = self.print_iterations
        self._out = out or (lambda s: log.info(s))

    def iteration_done(self, model, iteration: int, score: float) -> None:
        if iteration % self.print_iterations == 0:
            self._out(f"Score at iteration {iteration} is {score}")


class InvalidScoreError(FloatingPointError):
    """A non-finite training score, carrying the step and the score."""

    def __init__(self, step: int, score: float, detail: str = ""):
        msg = (f"training score became {score} at iteration {step} "
               f"— exploding/NaN loss; lower the learning rate, clip "
               f"gradients, or inspect the input batch")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.step = int(step)
        self.score = float(score)


class NanGuardListener(IterationListener):
    """Raises `InvalidScoreError` the moment the score goes non-finite
    (reference `LinAlgExceptions.assertValidNum`,
    `MultiLayerNetwork.java:677`).  It reads the score every iteration,
    so each step waits for the device."""

    score_only = True

    def iteration_done(self, model, iteration: int, score: float) -> None:
        if not math.isfinite(score):
            raise InvalidScoreError(iteration, score)


class ComposableIterationListener(IterationListener):
    """Fans one callback out to many (reference
    `ComposableIterationListener.java`)."""

    def __init__(self, listeners: Sequence[IterationListener]):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration: int, score: float) -> None:
        for listener in self.listeners:
            listener.iteration_done(model, iteration, score)


class CallbackListener(IterationListener):
    """Adapts a plain function ``fn(model, iteration, score)``."""

    def __init__(self, fn: Callable[[object, int, float], None]):
        self.fn = fn

    def iteration_done(self, model, iteration: int, score: float) -> None:
        self.fn(model, iteration, score)
