"""Backtracking line search (counterpart of
`deeplearning4j_tpu.optimize.line_search`).

Parity: reference `optimize/solvers/BackTrackLineSearch.java`: Armijo
sufficient-decrease backtracking with step clamping.  The JAX package
runs it as a `lax.while_loop` inside the solver's program; here it is a
plain Python loop.  Each trial reads its objective value back from the
device, and the scalar arithmetic of the search (slope, interpolants,
clamps) is done in float32 on the host, as the JAX loop does it in
float32, so both take the same branches on the same values.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

ALF = 1e-4          # Armijo sufficient-decrease constant (ref ALF field)
STEP_MAX = 100.0    # max scaled step length (ref stpmax/scaling)

f32 = np.float32


def _host(t) -> np.float32:
    """A 0-d tensor (on any device) as a float32 host scalar."""
    return f32(float(t))


class LineSearchResult(NamedTuple):
    step: np.float32        # accepted step size along `direction` (0: none)
    x_new: torch.Tensor     # x + step * direction
    f_new: np.float32       # objective at x_new
    n_evals: int            # objective evaluations used


def backtrack_line_search(
    f: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    f0,
    g0: torch.Tensor,
    direction: torch.Tensor,
    max_iterations: int = 10,
    initial_step: float = 1.0,
    min_step: float = 1e-12,
) -> LineSearchResult:
    """Find `step` with f(x + step*d) <= f0 + ALF*step*<g0, d> (Armijo).

    Backtracks by quadratic (first trial) then cubic interpolation, as
    the reference does, clamped to [0.1, 0.5] of the last trial.  Returns
    step 0 (no move) when `direction` is not a descent direction or the
    search runs out of trials or below `min_step`."""
    f0 = f32(f0)
    slope = _host(torch.dot(g0, direction))
    dnorm = max(_host(torch.linalg.vector_norm(direction)), f32(1e-30))
    # long steps scaled down (ref: stpmax = STEP_MAX * max(norm(x), n))
    stpmax = f32(STEP_MAX) * max(_host(torch.linalg.vector_norm(x)),
                                 f32(x.numel())) / dnorm
    alam = min(f32(initial_step), stpmax)
    alam2, f2 = f32(0.0), f0
    best, fbest = f32(0.0), f0
    done, it = bool(slope >= 0), 0
    with np.errstate(all="ignore"):
        while not done and it < max_iterations:
            fval = _host(f(x + float(alam) * direction))
            ok = fval <= f0 + f32(ALF) * alam * slope
            if it == 0:
                tmplam = -slope / (f32(2.0) * (fval - f0 - slope))
            else:
                rhs1 = fval - f0 - alam * slope
                rhs2 = f2 - f0 - alam2 * slope
                denom1 = alam ** 2
                denom2 = f32(1e-30) if alam2 == 0 else alam2 ** 2
                da = f32(1e-30) if alam - alam2 == 0 else alam - alam2
                a = (rhs1 / denom1 - rhs2 / denom2) / da
                b = (-alam2 * rhs1 / denom1 + alam * rhs2 / denom2) / da
                disc = b * b - f32(3.0) * a * slope
                if abs(a) < f32(1e-30):
                    tmplam = -slope / (f32(2.0) * b)
                elif disc < 0:
                    tmplam = f32(0.5) * alam
                else:
                    tmplam = (-b + np.sqrt(max(disc, f32(0.0)))) / (
                        f32(3.0) * a)
            if not math.isfinite(tmplam):
                tmplam = f32(0.5) * alam
            new_alam = min(max(f32(tmplam), f32(0.1) * alam),
                           f32(0.5) * alam)
            done = bool(ok or new_alam < f32(min_step))
            if ok:
                best, fbest = alam, fval
            alam2, f2 = alam, fval
            if not done:
                alam = new_alam
            it += 1
    return LineSearchResult(step=best, x_new=x + float(best) * direction,
                            f_new=fbest if best > 0 else f0, n_evals=it)
