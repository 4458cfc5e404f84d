"""Solver: builder and dispatch driving a solver step from a host loop
(counterpart of `deeplearning4j_tpu.optimize.solver`).

Parity: reference `optimize/Solver.java:41` (builder, `getOptimizer():56-71`
dispatch on OptimizationAlgorithm) and the shared loop
`BaseOptimizer.java:124-196` (gradient and score, direction and line
search, step, terminations; listeners fired at :169-170).  Works on any
objective ``f(flat_params, *data) -> scalar``; `Solver.for_model` adapts
a `MultiLayerNetwork` and a batch into that form over the network's flat
parameter vector (`params_flat` order: layer by layer, keys sorted).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize import solvers as solvers_mod
from deeplearning4j_tpu_torch.optimize.api import (
    IterationListener,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.optimize.terminations import (
    EpsTermination,
    TerminationCondition,
)

_FACTORIES = {
    OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
        solvers_mod.stochastic_gradient_descent,
    OptimizationAlgorithm.LINE_GRADIENT_DESCENT:
        solvers_mod.line_gradient_descent,
    OptimizationAlgorithm.CONJUGATE_GRADIENT:
        solvers_mod.conjugate_gradient,
    OptimizationAlgorithm.LBFGS: solvers_mod.lbfgs,
    OptimizationAlgorithm.HESSIAN_FREE: solvers_mod.hessian_free,
}


class Solver:
    """Builder-style solver (ref Solver.Builder) over a flat-vector
    objective."""

    def __init__(self, f: Callable[..., torch.Tensor],
                 algorithm: OptimizationAlgorithm | str =
                 OptimizationAlgorithm.LINE_GRADIENT_DESCENT,
                 num_iterations: int = 100,
                 listeners: Sequence[IterationListener] = (),
                 terminations: Sequence[TerminationCondition] = (),
                 model=None,
                 maximize: bool = False,
                 **algo_kwargs):
        self._sign = -1.0 if maximize else 1.0
        if maximize:  # reference `minimize` flag: maximize f == minimize -f
            orig = f
            f = lambda v, *data: -orig(v, *data)  # noqa: E731
        self.f = f
        self.algorithm = OptimizationAlgorithm(algorithm)
        self.num_iterations = num_iterations
        self.listeners = list(listeners)
        self.terminations = (list(terminations)
                             or [EpsTermination(eps=1e-6, tolerance=1e-12)])
        self.model = model
        self._init, self._step = _FACTORIES[self.algorithm](f, **algo_kwargs)
        self.final_state = None

    def optimize(self, x0: torch.Tensor, *data) -> torch.Tensor:
        """Minimize from `x0` (reference Solver.optimize()); `data` is
        passed through to the objective.  Returns the final iterate."""
        state = self._init(x0, *data)
        f_old = float(state.fval)
        for i in range(self.num_iterations):
            state = self._step(state, *data)
            f_new = float(state.fval)
            for listener in self.listeners:
                # the user's objective: un-negated under maximize
                listener.iteration_done(self.model, i, self._sign * f_new)
            # the search direction where the algorithm carries one (CG),
            # else steepest descent
            direction = getattr(state.aux, "direction", None)
            extras = {"grad": state.grad,
                      "direction": -state.grad if direction is None
                      else direction}
            if any(t.terminate(f_new, f_old, extras)
                   for t in self.terminations):
                break
            f_old = f_new
        self.final_state = state
        return state.x

    # -- model adapter ------------------------------------------------------
    @classmethod
    def for_model(cls, net, x, y, mask=None, **kwargs) -> "Solver":
        """Adapt a `MultiLayerNetwork` into a flat objective over its
        parameters (reference `BaseLayer.getOptimizer():244-252`).  The
        batch and the layer state are the objective's data, so
        `fit_model(x2, y2)` optimizes another batch and stateful layers
        (batch norm) see their current statistics.  Dropout draws from a
        generator seeded 0 on every evaluation, as the JAX objective's
        fixed key does, so the objective is deterministic."""
        names = [(name.split("/")[0], name.split("/")[1], tuple(p.shape))
                 for name, p in net._param_leaves()]
        n_layers = len(net.params)

        def unravel(vec: torch.Tensor):
            tree = [{} for _ in range(n_layers)]
            offset = 0
            for i, k, shape in names:
                n = int(np.prod(shape, dtype=np.int64))
                tree[int(i)][k] = vec[offset:offset + n].reshape(shape)
                offset += n
            return tree

        def f(vec, xb, yb, maskb, state):
            gen = torch.Generator(device=vec.device).manual_seed(0)
            loss, _ = net._objective(unravel(vec), state, xb, yb, gen, maskb)
            return loss

        solver = cls(f, model=net, **kwargs)
        solver._unravel = unravel
        solver._bound = (x, y, mask)
        return solver

    def fit_model(self, x=None, y=None, mask=None) -> float:
        """Run `optimize` from the model's current parameters (re-read on
        every call) over the batch given (or the one bound by
        `for_model`) and write the result back into the model; stateful
        layers' statistics advance once per solve.  Returns the final
        score."""
        from deeplearning4j_tpu_torch.models.multi_layer_network import (
            _as_tensor,
        )

        net = self.model
        if x is None:
            x, y, mask = self._bound
        x, y, mask = (_as_tensor(a, net.device) for a in (x, y, mask))
        x0 = torch.cat([p.detach().reshape(-1)
                        for _, p in net._param_leaves()])
        best = self.optimize(x0, x, y, mask, net.state)
        net.params = [{k: v.detach().clone().requires_grad_(
            v.is_floating_point()) for k, v in layer.items()}
            for layer in self._unravel(best)]
        if any(s for s in net.state):
            with torch.no_grad():
                gen = torch.Generator(device=net.device).manual_seed(0)
                net.state = net._objective(net.params, net.state, x, y, gen,
                                           mask)[1]
        return float(self._sign * self.final_state.fval)
