"""Optimization: solvers, line search, listeners, terminations
(counterpart of `deeplearning4j_tpu.optimize`).

Parity target: reference `optimize/` — `Solver.java:41` dispatch on
`OptimizationAlgorithm.java:42` {LINE_GRADIENT_DESCENT, CONJUGATE_GRADIENT,
HESSIAN_FREE, LBFGS, STOCHASTIC_GRADIENT_DESCENT}, the shared loop
`BaseOptimizer.java:124-196`, `BackTrackLineSearch.java`, termination
conditions and the `IterationListener` SPI.  Each solver works on the
network's flat parameter vector; autograd replaces the reference's
hand-written R-op passes.
"""

from deeplearning4j_tpu_torch.optimize.api import (
    ComposableIterationListener,
    InvalidScoreError,
    IterationListener,
    NanGuardListener,
    OptimizationAlgorithm,
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.optimize.line_search import (
    backtrack_line_search,
)
from deeplearning4j_tpu_torch.optimize.solver import Solver
from deeplearning4j_tpu_torch.optimize.solvers import (
    conjugate_gradient,
    hessian_free,
    lbfgs,
    line_gradient_descent,
    minimize,
    stochastic_gradient_descent,
)
from deeplearning4j_tpu_torch.optimize.terminations import (
    EpsTermination,
    Norm2Termination,
    ZeroDirectionTermination,
)

__all__ = [
    "OptimizationAlgorithm", "InvalidScoreError", "IterationListener",
    "ComposableIterationListener", "NanGuardListener",
    "ScoreIterationListener", "backtrack_line_search",
    "stochastic_gradient_descent", "line_gradient_descent",
    "conjugate_gradient", "lbfgs", "hessian_free", "minimize", "Solver",
    "EpsTermination", "Norm2Termination", "ZeroDirectionTermination",
]
