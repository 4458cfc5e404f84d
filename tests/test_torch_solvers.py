"""PyTorch port, slice 8: the line search and the solvers (line gradient
descent, conjugate gradient, LBFGS, Hessian-free) against the JAX
package.

Both packages get the same float32 problem: a fixed quadratic, and
`iris_mlp` on fixed numpy data with the same weights.  The solvers
branch on the line search's acceptance tests, which both packages make
in float32 on the same values, so the port's iterates follow JAX's:
the objective after every iteration matches within 1e-5 relative, and
`fit` with each ``optimization_algo`` ends at the same `params_flat`
within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.optimize import line_search as jls
from deeplearning4j_tpu.optimize import solver as jsolver
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu_torch import optimize as topt
from deeplearning4j_tpu_torch.optimize import line_search as tls
from test_torch_conv import pair
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

ALGOS = ["line_gradient_descent", "conjugate_gradient", "lbfgs",
         "hessian_free"]


def _quadratic(n=6, seed=0, spread=(0.5, 3.0), scale=1.0):
    """0.5 x'Ax - b'x + 3 with A symmetric positive definite, eigenvalues
    spread evenly over `spread`, and a start x0 ~ N(0, scale^2)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.linspace(*spread, n)) @ q.T
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n) * scale
    return (a.astype(np.float32), b.astype(np.float32),
            x0.astype(np.float32))


def _losses(solver_cls, f, x0, algo, iters, **kw):
    seen = []

    class Record:
        def iteration_done(self, model, i, score):
            seen.append(score)

    solver = solver_cls(f, algorithm=algo, num_iterations=iters,
                        listeners=[Record()], **kw)
    return seen, solver.optimize(x0)


def _port_state(js):
    """A JAX `SolverState` as the port's (tensors, float32 host scalars)."""
    def t(a):
        return torch.from_numpy(np.array(a))

    aux = js.aux
    if isinstance(aux, jsolvers._CGAux):
        aux = topt.solvers._CGAux(t(aux.direction), t(aux.g_prev))
    elif isinstance(aux, jsolvers._LbfgsAux):
        aux = topt.solvers._LbfgsAux(t(aux.S), t(aux.Y), t(aux.rho),
                                     int(aux.count))
    elif isinstance(aux, jsolvers._HFAux):
        aux = topt.solvers._HFAux(np.float32(aux.lam))
    return topt.solvers.SolverState(t(js.x), np.float32(js.fval),
                                    t(js.grad), int(js.it), aux)


def _quad_fns(seed=0, **kw):
    a, b, x0 = _quadratic(seed=seed, **kw)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    return (lambda x: 0.5 * x @ ja @ x - jb @ x + 3.0,
            lambda x: 0.5 * x @ ta @ x - tb @ x + 3.0, x0)


@pytest.mark.parametrize("algo", ALGOS)
def test_each_solver_step_matches_jax_on_a_quadratic(algo):
    """Teacher-forced: every one of 12 steps taken by the port from the
    JAX iterate gives JAX's next objective value (1e-5 relative)."""
    jf, tf, x0 = _quad_fns()
    jinit, jstep = (jax.jit(fn) for fn in getattr(jsolvers, algo)(jf))
    _, tstep = getattr(topt, algo)(tf)
    js = jinit(jnp.asarray(x0))
    for _ in range(12):
        ts = tstep(_port_state(js))
        js = jstep(js)
        assert float(ts.fval) == pytest.approx(float(js.fval), rel=1e-5)


def _trials(line_search, f, s, direction):
    """The step sizes one backtracking search tries from state `s`."""
    steps = []
    d = direction

    def rec(v):
        steps.append(float(torch.dot(v - s.x, d) / torch.dot(d, d)))
        return f(v)

    line_search(rec, s.x, s.fval, s.grad, d)
    return steps


@pytest.mark.parametrize("algo", ALGOS)
def test_solvers_follow_jax_on_a_quadratic(algo):
    """Free-running through `Solver`: the objective after every iteration
    within 1e-5 relative of JAX's, and the same final iterate."""
    jf, tf, x0 = _quad_fns()
    want, jx = _losses(jsolver.Solver, jf, jnp.asarray(x0), algo, 12)
    got, tx = _losses(topt.Solver, tf, torch.from_numpy(x0), algo, 12)
    assert want[-1] < want[0]
    assert len(got) == len(want) >= 7
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)


def test_badly_scaled_quadratic_parts_at_a_cubic_interpolant_tie():
    """Where the two packages part, and why.  On a badly scaled quadratic
    (eigenvalues 1 to 30, start ~ N(0, 4)) every search's first trial
    overshoots ~100x, and its third trial step comes from the cubic
    interpolant (-b + sqrt(b*b - 3*a*slope)) / (3*a) with b*b ~ 2.3e9
    swamping 3*a*slope: the numerator cancels to 0 or to an ulp of b,
    clamped to 0.1 or to 0.5 x the last step.  Line gradient descent
    agrees with JAX for 3 iterations at 1e-5 and parts at the 4th, on
    iterates 1 ulp apart: JAX's search takes 0.1 x, the port's 0.5 x.
    That is the tie; the reference's formula, not the port, decides it."""
    algo, flip = "line_gradient_descent", 4
    jf, tf, x0 = _quad_fns(spread=(1.0, 30.0), scale=2.0)
    want, _ = _losses(jsolver.Solver, jf, jnp.asarray(x0), algo, 12)
    got, _ = _losses(topt.Solver, tf, torch.from_numpy(x0), algo, 12)
    np.testing.assert_allclose(got[:flip - 1], want[:flip - 1], rtol=1e-5)
    assert got[flip - 1] != pytest.approx(want[flip - 1], rel=1e-5)
    # replay step `flip`'s search from each package's iterate
    jinit, jstep = (jax.jit(fn)
                    for fn in jsolvers.line_gradient_descent(jf))
    tinit, tstep = topt.line_gradient_descent(tf)
    js, ts = jinit(jnp.asarray(x0)), tinit(torch.from_numpy(x0))
    for _ in range(flip - 1):
        js, ts = jstep(js), tstep(ts)
    jport = _port_state(js)
    np.testing.assert_allclose(ts.x.numpy(), jport.x.numpy(), atol=1e-6)
    from_jax = _trials(tls.backtrack_line_search, tf, jport, -jport.grad)
    from_port = _trials(tls.backtrack_line_search, tf, ts, -ts.grad)
    assert len(from_jax) == len(from_port) == 3
    np.testing.assert_allclose(from_port[:2], from_jax[:2], rtol=1e-5)
    assert from_jax[2] == pytest.approx(0.1 * from_jax[1], rel=1e-5)
    assert from_port[2] == pytest.approx(0.5 * from_port[1], rel=1e-5)
    # and JAX's own search from its iterate takes the 0.1 x step
    res = jls.backtrack_line_search(jf, js.x, js.fval, js.grad, -js.grad)
    assert float(res.step) == pytest.approx(from_jax[2], rel=1e-5)


def test_backtrack_line_search_matches():
    a, b, x0 = _quadratic(seed=3)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    g = a @ x0 - b
    for d, step0 in ((-g, 1.0), (-g * 40, 1.0), (-g, 1e-3), (g, 1.0)):
        f0 = np.float32(0.5 * x0 @ a @ x0 - b @ x0)
        want = jls.backtrack_line_search(
            lambda x: 0.5 * x @ ja @ x - jb @ x, jnp.asarray(x0), f0,
            jnp.asarray(g), jnp.asarray(d), initial_step=step0)
        got = tls.backtrack_line_search(
            lambda x: 0.5 * x @ ta @ x - tb @ x, torch.from_numpy(x0), f0,
            torch.from_numpy(g), torch.from_numpy(d.astype(np.float32)),
            initial_step=step0)
        assert float(got.step) == pytest.approx(float(want.step), rel=1e-5)
        assert float(got.f_new) == pytest.approx(float(want.f_new),
                                                 rel=1e-5)
        assert got.n_evals == int(want.n_evals)
        np.testing.assert_allclose(got.x_new.numpy(), np.asarray(want.x_new),
                                   atol=1e-5)


def test_minimize_matches():
    a, b, x0 = _quadratic(seed=1)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = jsolvers.minimize(
        jsolvers.lbfgs(lambda x: 0.5 * x @ ja @ x - jb @ x + 3.0),
        jnp.asarray(x0), 20, 1e-6)
    got = topt.minimize(
        topt.lbfgs(lambda x: 0.5 * x @ ta @ x - tb @ x + 3.0),
        torch.from_numpy(x0), 20, 1e-6)
    assert got.it == int(want.it)
    assert float(got.fval) == pytest.approx(float(want.fval), rel=1e-5)


# ---- on a network ------------------------------------------------------------


def _iris_like(n=60, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, n)
    x = (rng.standard_normal((n, 4)) + labels[:, None] * 0.8).astype(
        np.float32)
    return x, np.eye(3, dtype=np.float32)[labels]


def _iris_conf(algo, iters=8):
    conf = jzoo.iris_mlp()
    return dataclasses.replace(conf, conf=dataclasses.replace(
        conf.conf, optimization_algo=algo, num_iterations=iters,
        max_num_line_search_iterations=10))


@pytest.mark.parametrize("algo", ALGOS)
def test_solvers_follow_jax_on_iris_mlp(algo):
    jn, tn = pair(_iris_conf(algo))
    x, y = _iris_like()
    kw = dict(algorithm=algo, num_iterations=8, max_line_iters=10)
    seen = {"jax": [], "torch": []}
    for name, solver_cls, net in (("jax", jsolver.Solver, jn),
                                  ("torch", topt.Solver, tn)):
        rec = seen[name]
        listener = type("Record", (), {"iteration_done": (
            lambda self, m, i, s, rec=rec: rec.append(s))})()
        solver = solver_cls.for_model(net, x, y, listeners=[listener], **kw)
        solver.fit_model()
    assert len(seen["torch"]) == len(seen["jax"]) >= 2
    np.testing.assert_allclose(seen["torch"], seen["jax"], rtol=1e-5)
    assert seen["jax"][-1] < seen["jax"][0]


@pytest.mark.parametrize("algo", ALGOS)
def test_fit_with_each_optimization_algo_matches(algo):
    jn, tn = pair(_iris_conf(algo, iters=4))
    x, y = _iris_like(seed=2)
    batches = [(x[:30], y[:30]), (x[30:], y[30:])]
    start = tn.score(x, y)
    jn.fit(batches, epochs=2)
    tn.fit(batches, epochs=2)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-4)
    assert tn.score(x, y) < start
    assert tn._iteration == jn._iteration == 4


def test_solver_fit_refuses_lr_multipliers_and_maximizes_on_request():
    conf = _iris_conf("lbfgs")
    conf = dataclasses.replace(conf, layers=(dataclasses.replace(
        conf.layers[0], lr_multiplier=0.5),) + conf.layers[1:])
    _, tn = pair(conf)
    with pytest.raises(ValueError, match="lr_multiplier"):
        tn.fit(_iris_like())
    a, b, x0 = _quadratic()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got, _ = _losses(topt.Solver, lambda x: -(0.5 * x @ ta @ x - tb @ x),
                     torch.from_numpy(x0), "lbfgs", 6, maximize=True)
    assert got[-1] > got[0]                       # maximized -f
