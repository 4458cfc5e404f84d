"""PyTorch port, slice 14: the training half of the resilience plane
(`resilience/{faults,retry,health,watchdog,supervisor,chaos}.py`,
`MultiLayerNetwork.restore_train_state`, `train -resilience`) against
the JAX package's, on the CPU:

- `HealthMonitor` actions, `backoff_delays` / `retry_call` and the
  `ChaosDataSource` fault schedule equal to JAX's on the same inputs;
- `TrainingSupervisor` over `iris_mlp` with the JAX net's initial
  parameters carried across, for ``chunk_size`` 1 and 4: NaN batches, a
  fetch failure and a preemption, then a fresh net resumed from the
  emergency checkpoint — equal skip / retry / preempt counts, fault kinds
  and actions, and final float32 params within 1e-5 of JAX's;
- rollback driven by deterministic triggers (the JAX package's reds with
  ``learning_rate=50`` never diverge, ROADMAP.md queue C): a one-shot
  `InvalidScoreError` from a wrapper, a NaN written into one weight, and
  divergence on a fed loss sequence — counts, ``lr_scale`` and final
  params equal to JAX's;
- `restore_train_state` replays a run's dropout masks exactly;
- the watchdog, the skip and rollback budgets, the intervention counters
  of `TrainingTelemetry`, SIGTERM as a resumable stop;
- ``cli train -resilience``: a run SIGTERM'd after its first checkpoint
  exits 0 with an emergency checkpoint, and the same command resumes
  there and trains the tail.
"""

import os
import random
import re
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import resilience as jr
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.zoo import iris_mlp as jiris
from deeplearning4j_tpu.obs import TrainingTelemetry as JTelemetry
from deeplearning4j_tpu.optimize import InvalidScoreError as JInvalid
from deeplearning4j_tpu.parallel.partition import keypath
from deeplearning4j_tpu_torch import resilience as tr
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.models.zoo import iris_mlp as tiris
from deeplearning4j_tpu_torch.obs import TrainingTelemetry as TTelemetry
from deeplearning4j_tpu_torch.optimize.api import (
    InvalidScoreError as TInvalid,
)
from deeplearning4j_tpu_torch.tree import flatten_tree
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

pytestmark = pytest.mark.chaos

TOL = 1e-5


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = rng.normal(0, 0.3, (n, 4)).astype(np.float32) + y[:, None]
    return x, np.eye(3, dtype=np.float32)[y]


def _batches(reps=4):
    x, y = _data()
    return [(x[i:i + 8], y[i:i + 8]) for i in range(0, 64, 8)] * reps


def _nets(**conf_kw):
    """A JAX net and a port net on the JAX net's initial params."""
    jn = JNet(jiris(**conf_kw)).init()
    tn = TNet(tiris(**conf_kw), device="cpu").init()
    tn.params = params_from_numpy(tn, jn.params)
    tn.updater_state = tn._updater.init(tn.params)
    return jn, tn


def _cfg(pkg, d, **overrides):
    kw = dict(checkpoint_dir=d, checkpoint_every=5, min_history=3,
              fetch_retry=pkg.RetryPolicy(max_attempts=3, base_delay=0.0,
                                          max_delay=0.0, jitter=0.0))
    kw.update(overrides)
    return pkg.ResilienceConfig(**kw)


def _flat_params(net):
    if isinstance(net, TNet):
        items = {k: v.detach().cpu().numpy()
                 for k, v in flatten_tree(net.params).items()}
    else:
        items = {keypath(p): np.asarray(v) for p, v in
                 jax.tree_util.tree_flatten_with_path(net.params)[0]}
    return np.concatenate([items[k].ravel() for k in sorted(items)])


def _summary(report):
    return {"steps": report.steps, "skipped": report.skipped,
            "rollbacks": report.rollbacks, "preempted": report.preempted,
            "lr_scale": report.lr_scale,
            "faults": [(f.kind, f.action) for f in report.faults]}


# ---------------------------------------------------------------------------
# The pure modules, against the JAX package


@pytest.mark.parametrize("losses,grad_norms", [
    ([1.0, 0.9, 0.8, 0.85, 0.9, 20.0, 25.0, 30.0, 0.7], None),
    ([1.0, 1.1, float("nan"), 0.9], None),
    ([2.0, 2.1, 1.9, 2.0, 2.2, 1.8], [1.0, 1.0, float("inf"), 1.0, 1.0,
                                      1.0]),
    ([1e-5, 1e-5, 1e-5, 1e-5, 1e-3, 1e-3, 1e-3], None)],
    ids=["divergence", "nan", "inf_grad", "floor"])
@pytest.mark.parametrize("floor", [0.0, 1e-2])
def test_health_monitor_actions_equal_jax(losses, grad_norms, floor):
    kw = dict(divergence_factor=10.0, patience=3, window=8, min_history=3,
              median_floor=floor)
    jm, tm = jr.HealthMonitor(**kw), tr.HealthMonitor(**kw)
    for i, loss in enumerate(losses):
        g = None if grad_norms is None else grad_norms[i]
        (ja, jrep), (ta, trep) = jm.observe(i, loss, g), tm.observe(i, loss, g)
        assert ta.value == ja.value
        assert (trep is None) == (jrep is None)
        if trep is not None:
            assert (trep.kind, trep.step, trep.detail) == \
                (jrep.kind, jrep.step, jrep.detail)
        assert tm.suspect == jm.suspect
        assert tm.rolling_median == jm.rolling_median
    with pytest.raises(ValueError, match="divergence_factor"):
        tr.HealthMonitor(divergence_factor=1.0)


@pytest.mark.parametrize("policy_kw", [
    dict(max_attempts=5, base_delay=0.5, multiplier=2.0, max_delay=3.0,
         jitter=0.1),
    dict(max_attempts=4, base_delay=1.0, jitter=0.0)])
def test_backoff_delays_and_retry_call_equal_jax(policy_kw):
    jp_, tp_ = jr.RetryPolicy(**policy_kw), tr.RetryPolicy(**policy_kw)
    assert list(tr.backoff_delays(tp_, random.Random(3))) == \
        list(jr.backoff_delays(jp_, random.Random(3)))

    def flaky(n):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) < n:
                raise OSError(f"flake {len(calls)}")
            return len(calls)
        return fn

    slept = {"j": [], "t": []}
    assert tr.retry_call(flaky(3), policy=tp_, sleep=slept["t"].append,
                         rng=random.Random(1)) == \
        jr.retry_call(flaky(3), policy=jp_, sleep=slept["j"].append,
                      rng=random.Random(1)) == 3
    assert slept["t"] == slept["j"]
    with pytest.raises(OSError, match="flake"):
        tr.retry_call(flaky(99), policy=tp_, sleep=lambda s: None)
    with pytest.raises(ValueError):            # not retryable: at once
        tr.retry_call(lambda: (_ for _ in ()).throw(ValueError("x")),
                      policy=tp_, sleep=lambda s: None)
    with pytest.raises(ValueError, match="max_attempts"):
        tr.RetryPolicy(max_attempts=0)


def _schedule(pkg, batches, cfg_kw):
    """Every fetch of a ChaosDataSource, retried as the supervisor does:
    ('batch', index, finite) / ('fetch_error',) / ('preempt',)."""
    src = pkg.ChaosDataSource(batches, pkg.ChaosConfig(**cfg_kw))
    out = []
    while True:
        try:
            x, _, _ = next(src)
        except StopIteration:
            return out
        except OSError:
            out.append(("fetch_error", src.index))
            continue
        except Exception as e:  # noqa: BLE001 — SimulatedPreemption of either package
            assert type(e).__name__ == "SimulatedPreemption"
            out.append(("preempt", src.index))
            continue
        out.append(("batch", src.index, bool(np.isfinite(x).all())))


@pytest.mark.parametrize("cfg_kw", [
    dict(nan_steps=(2, 5), fetch_fail_steps=(4,), preempt_at=8),
    dict(nan_steps=(0,), fetch_fail_steps=(0, 3), preempt_at=0,
         slow_fetch_steps=(1,), slow_seconds=0.0)])
def test_chaos_schedule_equals_jax(cfg_kw):
    batches = _batches(2)
    assert _schedule(tr, batches, cfg_kw) == _schedule(jr, batches, cfg_kw)


def test_watchdog_times_out_and_passes_through():
    wd = tr.StepWatchdog(0.2)
    assert wd.run(lambda a, b=1: a + b, 2, b=3) == 5
    with pytest.raises(KeyError):
        wd.run(lambda: {}["missing"])
    with pytest.raises(tr.StepTimeoutError) as e:
        wd.run(time.sleep, 1.0, step=7)
    assert e.value.report.kind == "hang" and e.value.report.step == 7
    with pytest.raises(ValueError):
        tr.StepWatchdog(0)


# ---------------------------------------------------------------------------
# The supervisor against the JAX package's, params carried across


def _chaos_run(pkg, net, d, chunk_size, telemetry=None):
    """NaN records at fetch 5 and 30 (extras in the stream), a fetch
    failure at 9 and a preemption at 21; then a fresh supervisor on a
    fresh net resumes and finishes the same source."""
    clean = _batches(4)
    stream = list(clean)
    stream.insert(5, clean[0])
    stream.insert(30, clean[0])
    src = pkg.ChaosDataSource(stream, pkg.ChaosConfig(
        nan_steps=(5, 30), fetch_fail_steps=(9,), preempt_at=21))
    sup = pkg.TrainingSupervisor(net, _cfg(pkg, d, chunk_size=chunk_size),
                                 telemetry=telemetry)
    r1 = sup.run(src)
    return src, r1


@pytest.mark.parametrize("chunk_size", [1, 4])
def test_supervised_chaos_run_and_resume_match_jax(tmp_path, chunk_size):
    jn, tn = _nets()
    jsrc, jrep1 = _chaos_run(jr, jn, tmp_path / "j", chunk_size)
    tsrc, trep1 = _chaos_run(tr, tn, tmp_path / "t", chunk_size)
    assert _summary(trep1) == _summary(jrep1)
    assert trep1.preempted and trep1.skipped == 1
    assert ("fetch_error", "retry") in _summary(trep1)["faults"]
    np.testing.assert_allclose(_flat_params(tn), _flat_params(jn),
                               rtol=TOL, atol=TOL)
    # the "process restart": fresh nets resume from the emergency
    # checkpoint (each package its own) and finish the same source
    jn2, tn2 = _nets(seed=11)
    jsup = jr.TrainingSupervisor(jn2, _cfg(jr, tmp_path / "j",
                                           chunk_size=chunk_size))
    tsup = tr.TrainingSupervisor(tn2, _cfg(tr, tmp_path / "t",
                                           chunk_size=chunk_size))
    assert jsup.resume() and tsup.resume()
    assert tsup.step == jsup.step == trep1.steps
    assert tsup.batches_consumed == jsup.batches_consumed
    jrep2, trep2 = jsup.run(jsrc), tsup.run(tsrc)
    assert _summary(trep2) == _summary(jrep2)
    assert not trep2.preempted and trep2.steps == 32
    assert trep1.skipped + trep2.skipped == 2  # counts are per supervisor
    np.testing.assert_allclose(_flat_params(tn2), _flat_params(jn2),
                               rtol=TOL, atol=TOL)
    assert abs(trep2.final_loss - jrep2.final_loss) < TOL


def test_resume_crosses_packages(tmp_path):
    """A port run preempted; the JAX supervisor resumes from the port's
    emergency checkpoint (and the other way round) and both finish
    alike."""
    jn, tn = _nets()
    _, trep1 = _chaos_run(tr, tn, tmp_path / "t", 1)
    _, jrep1 = _chaos_run(jr, jn, tmp_path / "j", 1)
    jn2, tn2 = _nets(seed=11)
    jsup = jr.TrainingSupervisor(jn2, _cfg(jr, tmp_path / "t"))
    tsup = tr.TrainingSupervisor(tn2, _cfg(tr, tmp_path / "j"))
    assert jsup.resume() and tsup.resume()
    assert jsup.step == trep1.steps and tsup.step == jrep1.steps
    np.testing.assert_allclose(_flat_params(jn2), _flat_params(tn),
                               rtol=0, atol=0)
    np.testing.assert_allclose(_flat_params(tn2), _flat_params(jn),
                               rtol=0, atol=0)


def _guarded(pkg_invalid, net, at: int):
    class GuardRaiser:
        """Raises the typed score error once, inside step `at`."""

        def __init__(self):
            self.net = net
            self._fired = False

        def __getattr__(self, name):
            return getattr(self.net, name)

        def fit_batch(self, bx, by, mask=None):
            if not self._fired and self.net._iteration == at:
                self._fired = True
                raise pkg_invalid(at, float("nan"))
            return self.net.fit_batch(bx, by, mask)

    return GuardRaiser()


def test_one_shot_invalid_score_rolls_back_like_jax(tmp_path):
    jn, tn = _nets()
    reps = {}
    for pkg, net, invalid, name in ((jr, jn, JInvalid, "j"),
                                    (tr, tn, TInvalid, "t")):
        sup = pkg.TrainingSupervisor(_guarded(invalid, net, 7),
                                     _cfg(pkg, tmp_path / name))
        reps[name] = sup.run(pkg.ChaosDataSource(_batches(2),
                                                 pkg.ChaosConfig()))
    t, j = reps["t"], reps["j"]
    assert _summary(t) == _summary(j)
    assert t.rollbacks == 1 and t.lr_scale == 0.5
    assert np.isfinite(t.final_loss)
    assert any(f.exception and "InvalidScoreError" in f.exception
               for f in t.faults)
    np.testing.assert_allclose(_flat_params(tn), _flat_params(jn),
                               rtol=TOL, atol=TOL)


class _NanWeight:
    """Writes NaN into one weight just before step `at` (once; with
    fused chunks, before the chunk whose steps cover `at`): the loss is
    NaN from there, and the health monitor rolls back."""

    def __init__(self, net, at):
        self.net, self.at, self.fired = net, at, False

    def __getattr__(self, name):
        return getattr(self.net, name)

    def _poison(self, steps: int) -> None:
        it = self.net._iteration
        if self.fired or not it <= self.at < it + steps:
            return
        self.fired = True
        if isinstance(self.net, TNet):
            with torch.no_grad():
                self.net.params[0]["W"][0, 0] = float("nan")
        else:
            w = self.net.params[0]["W"]
            self.net.params[0]["W"] = w.at[0, 0].set(float("nan"))

    def fit_batch(self, bx, by, mask=None):
        self._poison(1)
        return self.net.fit_batch(bx, by, mask)

    def fit_chunk_async(self, xs, ys, masks=None, weights=None):
        self._poison(int(np.shape(xs)[0]))
        return self.net.fit_chunk_async(xs, ys, masks, weights)


@pytest.mark.parametrize("save_updater", [True, False])
def test_nan_weight_rolls_back_like_jax(tmp_path, save_updater):
    jn, tn = _nets()
    reps = {}
    for pkg, net, name in ((jr, jn, "j"), (tr, tn, "t")):
        sup = pkg.TrainingSupervisor(
            _NanWeight(net, 6), _cfg(pkg, tmp_path / name,
                                     save_updater=save_updater))
        reps[name] = sup.run(pkg.ChaosDataSource(_batches(2),
                                                 pkg.ChaosConfig()))
    t, j = reps["t"], reps["j"]
    assert _summary(t) == _summary(j)
    assert t.rollbacks == 1 and ("nonfinite_loss", "rollback") in \
        _summary(t)["faults"]
    assert np.isfinite(_flat_params(tn)).all()
    for leaf in flatten_tree(tn.updater_state).values():
        assert torch.isfinite(leaf.float()).all()
    np.testing.assert_allclose(_flat_params(tn), _flat_params(jn),
                               rtol=TOL, atol=TOL)


def test_nan_weight_inside_a_chunk_replays_and_rolls_back(tmp_path):
    """chunk_size 4: the NaN weight inside a fused chunk restores the
    pre-chunk snapshot and replays the chunk at chunk 1 — as in the JAX
    package."""
    jn, tn = _nets()
    reps = {}
    for pkg, net, name in ((jr, jn, "j"), (tr, tn, "t")):
        sup = pkg.TrainingSupervisor(_NanWeight(net, 6),
                                     _cfg(pkg, tmp_path / name,
                                          chunk_size=4))
        reps[name] = sup.run(pkg.ChaosDataSource(_batches(2),
                                                 pkg.ChaosConfig()))
    t, j = reps["t"], reps["j"]
    assert _summary(t) == _summary(j)
    kinds = _summary(t)["faults"]
    assert ("nonfinite_loss", "replay") in kinds
    np.testing.assert_allclose(_flat_params(tn), _flat_params(jn),
                               rtol=TOL, atol=TOL)


def test_divergence_on_a_fed_loss_sequence_rolls_back(tmp_path):
    """A runner whose losses are fed: healthy, then 3 steps at 100x the
    median — the rollback fires on the third, in both packages."""
    losses = [1.0, 0.9, 0.95, 0.9, 0.85, 0.8, 95.0, 96.0, 97.0] + [0.7] * 8

    def fed(pkg, net):
        class Fed:
            def __init__(self):
                self.net = net
                self.k = 0

            def __getattr__(self, name):
                return getattr(self.net, name)

            def fit_batch(self, bx, by, mask=None):
                self.net.fit_batch(bx, by, mask)
                loss = losses[min(self.k, len(losses) - 1)]
                self.k += 1
                return loss
        return Fed()

    jn, tn = _nets()
    reps = {}
    for pkg, net, name in ((jr, jn, "j"), (tr, tn, "t")):
        sup = pkg.TrainingSupervisor(fed(pkg, net),
                                     _cfg(pkg, tmp_path / name,
                                          checkpoint_every=4))
        reps[name] = sup.run(pkg.ChaosDataSource(_batches(2),
                                                 pkg.ChaosConfig()))
    assert _summary(reps["t"]) == _summary(reps["j"])
    assert ("divergence", "rollback") in _summary(reps["t"])["faults"]
    np.testing.assert_allclose(_flat_params(tn), _flat_params(jn),
                               rtol=TOL, atol=TOL)


def test_rollback_and_skip_budgets_abort(tmp_path):
    tn = TNet(tiris(), device="cpu").init()
    sup = tr.TrainingSupervisor(tn, _cfg(tr, tmp_path / "a", skip_budget=1))
    with pytest.raises(tr.SupervisorAbort, match="skip budget"):
        sup.run(tr.ChaosDataSource(_batches(1), tr.ChaosConfig(
            nan_steps=(1, 2))))

    class AlwaysInvalid:
        def __init__(self, net):
            self.net = net

        def __getattr__(self, name):
            return getattr(self.net, name)

        def fit_batch(self, bx, by, mask=None):
            raise TInvalid(self.net._iteration, float("nan"))

    sup = tr.TrainingSupervisor(AlwaysInvalid(tn),
                                _cfg(tr, tmp_path / "b", max_rollbacks=2))
    with pytest.raises(tr.SupervisorAbort, match="rollback budget"):
        sup.run(tr.ChaosDataSource(_batches(1), tr.ChaosConfig()))
    assert sup.rollbacks == 3


def test_hung_step_raises_step_timeout(tmp_path):
    tn = TNet(tiris(), device="cpu").init()
    runner = tr.chaos_runner(tn, tr.ChaosConfig(hang_steps=(2,),
                                                hang_seconds=1.0))
    sup = tr.TrainingSupervisor(runner, _cfg(tr, tmp_path,
                                             step_timeout=0.3))
    with pytest.raises(tr.StepTimeoutError):
        sup.run(tr.ChaosDataSource(_batches(1), tr.ChaosConfig()))
    assert sup.faults[-1].kind == "hang"


def test_interventions_feed_the_telemetry_like_jax(tmp_path):
    jn, tn = _nets()
    jt, tt = JTelemetry(), TTelemetry()
    _chaos_run(jr, jn, tmp_path / "j", 1, telemetry=jt)
    _chaos_run(tr, tn, tmp_path / "t", 1, telemetry=tt)
    assert tt.snapshot()["interventions"] == jt.snapshot()["interventions"]
    assert tt.snapshot()["interventions"]["poison_skip"] == 1
    assert tt.snapshot()["interventions"]["preemption"] == 1
    from deeplearning4j_tpu_torch.runtime.checkpoint import (
        latest_checkpoint,
    )
    import json

    meta = json.loads((latest_checkpoint(tmp_path / "t")
                       / "meta.json").read_text())
    assert meta["extra"]["preempt"] is True
    assert "interventions" in meta["extra"]["telemetry"]


def test_sigterm_is_a_resumable_stop(tmp_path):
    tn = TNet(tiris(), device="cpu").init()
    sup = tr.TrainingSupervisor(tn, _cfg(tr, tmp_path))

    class Term:
        def __init__(self):
            self.i = 0

        def __iter__(self):
            return self

        def __next__(self):
            self.i += 1
            if self.i == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            if self.i > 20:
                raise StopIteration
            return _batches(1)[0]

    sup.install_signal_handlers()
    try:
        report = sup.run(Term())
    finally:
        sup.uninstall_signal_handlers()
    assert report.preempted and report.steps == 3
    assert report.faults[-1].kind == "preemption"
    tn2 = TNet(tiris(), device="cpu").init(seed=9)
    sup2 = tr.TrainingSupervisor(tn2, _cfg(tr, tmp_path))
    assert sup2.resume() and sup2.step == 3
    np.testing.assert_array_equal(_flat_params(tn2), _flat_params(tn))


# ---------------------------------------------------------------------------
# restore_train_state


def test_restore_train_state_replays_dropout_exactly():
    """The per-step generator is seeded from the iteration, so a net
    restored at step k replays steps k.. with the same dropout masks."""
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayerConf,
        MultiLayerConfiguration,
        NeuralNetConfiguration,
        OutputLayerConf,
    )

    conf = MultiLayerConfiguration(
        conf=NeuralNetConfiguration(seed=5, learning_rate=0.05,
                                    updater="adam"),
        layers=(DenseLayerConf(n_in=4, n_out=32, activation="relu",
                               dropout=0.5),
                OutputLayerConf(n_in=32, n_out=3)))
    batches = _batches(1)
    a = TNet(conf, device="cpu").init()
    for bx, by in batches[:3]:
        a.fit_batch(bx, by)
    b = TNet(conf, device="cpu").init(seed=77)
    b.restore_train_state(3, _clone(a.params), _clone(a.updater_state),
                          _clone(a.state))
    assert b._iteration == 3
    assert all(v.requires_grad for v in flatten_tree(b.params).values())
    assert b.updater_state["step"].device.type == "cpu"
    for bx, by in batches[3:]:
        la, lb = a.fit_batch(bx, by), b.fit_batch(bx, by)
        assert la == lb
    np.testing.assert_array_equal(_flat_params(a), _flat_params(b))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# cli train -resilience


def _iris_csv(path, n=150):
    rng = np.random.default_rng(0)
    labels = np.arange(n) % 3
    x = rng.standard_normal((n, 4)) * 0.3 + labels[:, None] * 2.0
    np.savetxt(path, np.column_stack([x, labels]), delimiter=",", fmt="%.5f")


def test_cli_train_resilience_sigterm_then_resume(tmp_path):
    csv = tmp_path / "iris.csv"
    _iris_csv(csv)
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "train",
           "-input", str(csv), "-model", "zoo:iris-mlp", "-device", "cpu",
           "-output", str(out), "-epochs", "400", "-resilience",
           "-ckpt-every", "5"]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        deadline = time.monotonic() + 120
        while not (out / "ckpts" / "ckpt-5").exists():
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, text
    m = re.search(r"preempted — emergency checkpoint at step (\d+)", text)
    assert m, text
    stopped = int(m.group(1))
    assert 5 <= stopped < 2000
    assert (out / "ckpts" / f"ckpt-{stopped}").exists()
    again = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300)
    assert again.returncode == 0, again.stdout + again.stderr
    assert f"resumed from checkpoint step {stopped}" in again.stdout
    assert "resilience: completed: 2000 steps" in again.stdout
    assert (out / "ckpts" / "ckpt-2000").exists()
