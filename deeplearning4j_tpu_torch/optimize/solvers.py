"""Solvers over flat parameter vectors (counterpart of
`deeplearning4j_tpu.optimize.solvers`).

Parity: reference `optimize/solvers/` — `StochasticGradientDescent.java`,
`LineGradientDescent.java`, `ConjugateGradient.java` (Polak-Ribiere),
`LBFGS.java` (m=4 two-loop recursion), `StochasticHessianFree.java` (CG on
curvature products, damping) — all sharing `BaseOptimizer.java:124`.

Every algorithm is ``(init, step)`` over a `SolverState`; `minimize`
drives them in a loop, `optimize.solver.Solver` from a loop that fires
listeners and checks terminations.  ``f(x, *data)`` is the objective;
`data` (a batch, layer state) is passed through to it.  The iterate and
the gradient are tensors on the objective's device; the objective's
value and the scalars that decide a branch are float32 on the host, as
the JAX package computes them in float32.  The Hessian-free solver's
curvature product is the exact Hessian-vector product, as JAX's
``jvp(grad f)``: here a double backward (`torch.autograd.grad` of
``<grad f, v>``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.line_search import (
    _host,
    backtrack_line_search,
)

f32 = np.float32


class SolverState(NamedTuple):
    x: torch.Tensor
    fval: np.float32
    grad: torch.Tensor
    it: int
    aux: Any  # algorithm-specific carried state


Algorithm = Tuple[Callable[..., SolverState], Callable[..., SolverState]]


def _value_grad(f):
    """``vg(x, *data) -> (f32 value, gradient tensor)``."""
    def vg(x, *data):
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            loss = f(xv, *data)
            (g,) = torch.autograd.grad(loss, xv)
        return _host(loss.detach()), g

    return vg


def _fallback(res, s: SolverState) -> torch.Tensor:
    """The line search's point, or (when it found none) a tiny
    safeguarded gradient step so the solver cannot stall."""
    return res.x_new if res.step > 0 else s.x - 1e-6 * s.grad


def _init_with(vg, aux_of=lambda x0, g0: ()):
    def init(x0, *data):
        f0, g0 = vg(x0, *data)
        return SolverState(x0, f0, g0, 0, aux_of(x0, g0))

    return init


# --------------------------------------------------------------------------
# Stochastic gradient descent (ref StochasticGradientDescent.java)

def stochastic_gradient_descent(f, learning_rate: float = 1e-1) -> Algorithm:
    vg = _value_grad(f)

    def step(s: SolverState, *data) -> SolverState:
        x = s.x - learning_rate * s.grad
        fval, grad = vg(x, *data)
        return SolverState(x, fval, grad, s.it + 1, ())

    return _init_with(vg), step


# --------------------------------------------------------------------------
# Line gradient descent: steepest descent + backtracking line search
# (ref LineGradientDescent.java + BackTrackLineSearch)

def line_gradient_descent(f, max_line_iters: int = 10,
                          initial_step: float = 1.0) -> Algorithm:
    vg = _value_grad(f)

    def step(s: SolverState, *data) -> SolverState:
        res = backtrack_line_search(lambda v: f(v, *data), s.x, s.fval,
                                    s.grad, -s.grad,
                                    max_iterations=max_line_iters,
                                    initial_step=initial_step)
        x = _fallback(res, s)
        fval, grad = vg(x, *data)
        return SolverState(x, fval, grad, s.it + 1, ())

    return _init_with(vg), step


# --------------------------------------------------------------------------
# Nonlinear conjugate gradient, Polak-Ribiere (ref ConjugateGradient.java:91)

class _CGAux(NamedTuple):
    direction: torch.Tensor
    g_prev: torch.Tensor


def conjugate_gradient(f, max_line_iters: int = 10) -> Algorithm:
    vg = _value_grad(f)

    def step(s: SolverState, *data) -> SolverState:
        aux: _CGAux = s.aux
        res = backtrack_line_search(lambda v: f(v, *data), s.x, s.fval,
                                    s.grad, aux.direction,
                                    max_iterations=max_line_iters)
        x = _fallback(res, s)
        fval, grad = vg(x, *data)
        # Polak-Ribiere beta, clamped at 0 (automatic restart)
        denom = torch.clamp(torch.dot(aux.g_prev, aux.g_prev), min=1e-30)
        beta = torch.clamp(torch.dot(grad, grad - aux.g_prev) / denom, min=0.0)
        direction = -grad + beta * aux.direction
        if not bool(torch.dot(grad, direction) < 0):   # not descent: restart
            direction = -grad
        return SolverState(x, fval, grad, s.it + 1,
                           _CGAux(direction=direction, g_prev=grad))

    return _init_with(vg, lambda x0, g0: _CGAux(-g0, g0)), step


# --------------------------------------------------------------------------
# L-BFGS, fixed-size two-loop recursion (ref LBFGS.java:169, m=4)

class _LbfgsAux(NamedTuple):
    S: torch.Tensor      # (m, n) parameter deltas
    Y: torch.Tensor      # (m, n) gradient deltas
    rho: torch.Tensor    # (m,) 1/<y,s>
    count: int           # pairs stored so far


def lbfgs(f, m: int = 4, max_line_iters: int = 16) -> Algorithm:
    vg = _value_grad(f)

    def aux_of(x0, g0):
        n = x0.shape[0]
        return _LbfgsAux(S=x0.new_zeros((m, n)), Y=x0.new_zeros((m, n)),
                         rho=x0.new_zeros((m,)), count=0)

    def two_loop(aux: _LbfgsAux, grad: torch.Tensor) -> torch.Tensor:
        """-H^{-1} g by the two-loop recursion over the stored pairs,
        newest to oldest, then oldest to newest."""
        k, used = aux.count, min(aux.count, m)
        q = grad
        alphas = {}
        for i in range(used):
            slot = (k - 1 - i) % m
            alphas[slot] = aux.rho[slot] * torch.dot(aux.S[slot], q)
            q = q - alphas[slot] * aux.Y[slot]
        if k > 0:   # initial Hessian scale <s,y>/<y,y> of the newest pair
            newest = (k - 1) % m
            gamma = torch.dot(aux.S[newest], aux.Y[newest]) / torch.clamp(
                torch.dot(aux.Y[newest], aux.Y[newest]), min=1e-30)
            r = gamma * q
        else:
            r = q
        for i in range(used):
            slot = (k - used + i) % m
            beta = aux.rho[slot] * torch.dot(aux.Y[slot], r)
            r = r + (alphas[slot] - beta) * aux.S[slot]
        return -r

    def step(s: SolverState, *data) -> SolverState:
        aux: _LbfgsAux = s.aux
        direction = two_loop(aux, s.grad)
        if not bool(torch.dot(s.grad, direction) < 0):
            direction = -s.grad
        res = backtrack_line_search(lambda v: f(v, *data), s.x, s.fval,
                                    s.grad, direction,
                                    max_iterations=max_line_iters)
        x = _fallback(res, s)
        fval, grad = vg(x, *data)
        s_vec, y_vec = x - s.x, grad - s.grad
        sy = torch.dot(s_vec, y_vec)
        if bool(sy > 1e-10):   # curvature condition; else skip the pair
            slot = aux.count % m
            S, Y, rho = aux.S.clone(), aux.Y.clone(), aux.rho.clone()
            S[slot], Y[slot] = s_vec, y_vec
            rho[slot] = 1.0 / torch.clamp(sy, min=1e-30)
            aux = _LbfgsAux(S, Y, rho, aux.count + 1)
        return SolverState(x, fval, grad, s.it + 1, aux)

    return _init_with(vg, aux_of), step


# --------------------------------------------------------------------------
# Hessian-free / truncated Newton (ref StochasticHessianFree.java:262):
# CG-solve (H + lam I) d = -g with Levenberg-Marquardt damping adaptation.

class _HFAux(NamedTuple):
    lam: np.float32  # LM damping (ref dampingFactor)


def hessian_free(f, cg_iters: int = 20, initial_damping: float = 1.0,
                 max_line_iters: int = 10) -> Algorithm:
    vg = _value_grad(f)

    def hvp(x, v, *data):
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(f(xv, *data), xv, create_graph=True)
            (hv,) = torch.autograd.grad(g, xv, grad_outputs=v,
                                        allow_unused=True)
        return torch.zeros_like(x) if hv is None else hv.detach()

    def cg_solve(x, g, lam, *data):
        """`cg_iters` iterations of linear CG on (H + lam I) d = -g."""
        d = torch.zeros_like(g)
        r = p = -g
        rs = torch.dot(r, r)
        for _ in range(cg_iters):
            Ap = hvp(x, p, *data) + float(lam) * p
            alpha = rs / torch.clamp(torch.dot(p, Ap), min=1e-30)
            d = d + alpha * p
            r = r - alpha * Ap
            rs_new = torch.dot(r, r)
            p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
            rs = rs_new
        return d

    def step(s: SolverState, *data) -> SolverState:
        lam = s.aux.lam
        direction = cg_solve(s.x, s.grad, lam, *data)
        if not bool(torch.dot(s.grad, direction) < 0):
            direction = -s.grad
        res = backtrack_line_search(lambda v: f(v, *data), s.x, s.fval,
                                    s.grad, direction,
                                    max_iterations=max_line_iters)
        x = _fallback(res, s)
        fval, grad = vg(x, *data)
        # damping from the reduction ratio against the local quadratic
        pred = -_host(torch.dot(s.grad, direction) + 0.5 * torch.dot(
            direction, hvp(s.x, direction, *data)))
        with np.errstate(all="ignore"):
            ratio = (s.fval - fval) / max(abs(pred), f32(1e-30))
        if ratio > 0.75:
            lam = lam * f32(2.0 / 3.0)
        elif ratio < 0.25:
            lam = lam * f32(1.5)
        lam = min(max(lam, f32(1e-8)), f32(1e8))
        return SolverState(x, fval, grad, s.it + 1, _HFAux(lam=lam))

    return (_init_with(vg, lambda x0, g0: _HFAux(f32(initial_damping))),
            step)


# --------------------------------------------------------------------------

def minimize(algorithm: Algorithm, x0: torch.Tensor, num_iterations: int,
             tol: float = 0.0, *data) -> SolverState:
    """Run up to `num_iterations` solver steps; with ``tol > 0`` stop once
    |f_prev - f| <= tol * max(1, |f_prev|) (ref EpsTermination)."""
    init, step = algorithm
    s = init(x0, *data)
    f_prev = f32(np.inf)
    while s.it < num_iterations:
        s = step(s, *data)
        stop = (tol > 0 and np.isfinite(f_prev) and abs(f_prev - s.fval)
                <= f32(tol) * max(f32(1.0), abs(f_prev)))
        f_prev = s.fval
        if stop:
            break
    return s
