"""PyTorch port, slice 9: the precision plane (`deeplearning4j_tpu_torch.
precision` and `MultiLayerNetwork`'s policy, loss-scaled step and
checkpoint precision) against the JAX package on the same numpy inputs,
weights carried over with `params_from_numpy`, dropout 0, on the CPU.

Tolerances.  Policies, the scaler automaton's trace and the byte model
are exact.  Training under a policy with 16-bit compute: the first
step's loss 1e-6 relative (same masters, the same casts), then per-step
losses and the first step's update (SGD, so update = -lr * gradient) in
relative L2 norm: bfloat16 ("mixed") 5e-3 / 2e-2, float16 1e-4 / 1e-3.
Readings (CPU, three seeds of Iris at batch 32 and LeNet-5 at batch 8,
SGD lr 0.1): mixed losses at most 1.7e-3 and first updates at most
9.7e-3 (one bf16 rounding of a gradient element flips between the
frameworks); float16 losses at most 2.7e-5 and updates at most 3.1e-4.
An overflowed step is held bitwise: the masters, Adam's moments and step
count stay at their pre-step values.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import precision as jprec
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu_torch import precision as tprec
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.ops import updaters as tupd
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


def _pair(jc):
    jn = JNet(jc).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(jc.to_json()),
              device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


def _iris_data(rng, n=32):
    y = rng.integers(0, 3, n)
    x = rng.normal(0, 0.25, (n, 4)).astype(np.float32) + y[:, None]
    return x.astype(np.float32), np.eye(3, dtype=np.float32)[y]


def _lenet_data(rng, n=8):
    return (rng.random((n, 28, 28, 1), dtype=np.float32),
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)])


def _f16(pkg):
    return pkg.PrecisionPolicy("float32", "float16",
                               loss_scale=pkg.LossScaleConfig())


def _flat_state(tree):
    """Every leaf of a port tree as float64 numpy, in tree order."""
    from deeplearning4j_tpu_torch.tree import tree_leaves

    return [np.asarray(t.detach().double().cpu()) for t in
            tree_leaves(tree)]


# ---- policies --------------------------------------------------------------


@pytest.mark.parametrize("name", ["fp32", "float32", "bf16", "bfloat16",
                                  "mixed", "MIXED"])
def test_named_policies_equal_jax(name):
    j, t = jprec.PrecisionPolicy.named(name), tprec.PrecisionPolicy.named(name)
    assert (t.param_dtype, t.compute_dtype, t.output_dtype) == \
        (j.param_dtype, j.compute_dtype, j.output_dtype)
    assert (t.loss_scale is None) == (j.loss_scale is None)
    if j.loss_scale is not None:
        assert dataclasses.asdict(t.loss_scale) == \
            dataclasses.asdict(j.loss_scale)
    assert t.describe() == j.describe() and t.is_mixed == j.is_mixed
    assert str(t.input_dtype).replace("torch.", "") == str(j.input_dtype)


def test_resolve_policy_and_from_conf_match_jax():
    jc = jzoo.char_lstm(vocab_size=5, hidden=4, compute_dtype="bfloat16")
    tc = tconf.MultiLayerConfiguration.from_json(jc.to_json())
    assert tprec.resolve_policy(None, tc.conf).describe() == \
        jprec.resolve_policy(None, jc.conf).describe()
    assert tprec.resolve_policy(None) == tprec.PrecisionPolicy()
    p = tprec.PrecisionPolicy("float32", "float16")
    assert tprec.resolve_policy(p) is p
    assert tprec.resolve_policy("mixed") == tprec.PrecisionPolicy.named(
        "mixed")
    f16 = _f16(tprec)
    assert f16.describe() == _f16(jprec).describe()
    assert f16.with_loss_scale(None).loss_scale is None
    for bad, exc in ((3, TypeError), ("fp8", ValueError)):
        with pytest.raises(exc):
            tprec.resolve_policy(bad)
    with pytest.raises(ValueError, match="floating"):
        tprec.PrecisionPolicy(param_dtype="int8")
    with pytest.raises(ValueError, match="not a dtype"):
        tprec.PrecisionPolicy(compute_dtype="float17")
    assert tprec.default_dtype() == torch.float32
    assert tprec.default_dtype(tprec.PrecisionPolicy.named("bf16")) == \
        torch.bfloat16
    net = TNet(tzoo.iris_mlp(), device="cpu")
    assert tprec.default_dtype(net) == torch.float32
    assert tprec.default_dtype(net.conf) == torch.float32


def test_exports_are_jax_s_but_the_data_parallel_verdict():
    """The data-parallel verdict, left out until slice 18, is exported
    now: the namespace equals JAX's."""
    assert set(tprec.__all__) == set(jprec.__all__)
    assert all(hasattr(tprec, name) for name in tprec.__all__)


def test_cast_floating_leaves_integers_alone():
    tree = [{"W": torch.ones(2, 3), "ids": torch.arange(3)},
            {"b": np.zeros(2, np.float32)}]
    out = tprec.cast_floating(tree, "bfloat16")
    assert out[0]["W"].dtype == torch.bfloat16
    assert out[0]["ids"].dtype == torch.int64
    assert out[1]["b"].dtype == torch.bfloat16
    jout = jprec.cast_floating([{"W": np.ones((2, 3), np.float32),
                                 "ids": np.arange(3)}], "bfloat16")
    assert str(jout[0]["W"].dtype) == "bfloat16"
    assert tprec.cast_floating(tree, torch.float16)[0]["W"].dtype == \
        torch.float16


# ---- the scaler automaton ------------------------------------------------------


def test_scaler_trace_equals_jax():
    """One automaton trace over a fixed finite/overflow sequence (growth,
    backoff, both clamps): the port's state equals JAX's at every step."""
    kw = dict(init_scale=16.0, growth_factor=2.0, backoff_factor=0.5,
              growth_interval=3, min_scale=1.0, max_scale=64.0)
    js = jprec.DynamicLossScaler(jprec.LossScaleConfig(**kw))
    ts = tprec.DynamicLossScaler(tprec.LossScaleConfig(**kw), device="cpu")
    seq = [True] * 7 + [False] * 7 + [True, False] * 3 + [True] * 12
    for i, finite in enumerate(seq):
        assert ts.observe(finite) == js.observe(finite), i
        for k in ("scale", "good_steps", "overflow_count"):
            assert float(ts.state[k]) == float(js.state[k]), (i, k)
        assert ts.state["scale"].dtype == torch.float32
        assert ts.state["good_steps"].dtype == torch.int32
    assert ts.overflow_count == js.overflow_count == 10


def test_scaler_config_validation_matches_jax():
    for kw in (dict(backoff_factor=1.5), dict(growth_factor=0.5),
               dict(init_scale=0.5, min_scale=1.0), dict(init_scale=0.0),
               dict(growth_interval=0)):
        with pytest.raises(ValueError):
            jprec.LossScaleConfig(**kw)
        with pytest.raises(ValueError):
            tprec.LossScaleConfig(**kw)


def test_unscale_and_finite_checks_match_jax():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((5, 7)).astype(np.float32) * 1e3
    for dt in ("float32", "bfloat16", "float16"):
        jt = [jnp.asarray(g, dt)]
        tt = [torch.from_numpy(g).to(getattr(torch, dt))]
        want = jprec.unscale_grads(jt, jnp.asarray(1024.0, jnp.float32))
        got = tprec.unscale_grads(tt, torch.tensor(1024.0))
        assert got[0].dtype == tt[0].dtype
        np.testing.assert_array_equal(got[0].float().numpy(),
                                      np.asarray(want[0], np.float32))
        assert bool(tprec.grads_finite(tt)) == bool(jprec.grads_finite(jt))
    bad = torch.from_numpy(g).clone()
    bad[2, 3] = float("nan")
    assert not bool(tprec.grads_finite({"a": [bad]}))
    sel = tprec.where_tree(torch.tensor(False), {"x": bad},
                           {"x": torch.zeros_like(bad)})
    assert torch.equal(sel["x"], torch.zeros_like(bad))


# ---- training under a policy ------------------------------------------------------


CASES = {"iris": (lambda: jzoo.iris_mlp(updater="sgd", learning_rate=0.1),
                  _iris_data),
         "lenet": (lambda: jzoo.lenet_mnist(updater="sgd",
                                            learning_rate=0.1),
                   _lenet_data)}
TOL = {"mixed": (5e-3, 2e-2), "float16": (1e-4, 1e-3)}


@pytest.mark.parametrize("policy", ["mixed", "float16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_training_matches_jax(case, policy):
    conf, data = CASES[case]
    jn, tn = _pair(conf())
    jn.set_precision("mixed" if policy == "mixed" else _f16(jprec))
    tn.set_precision("mixed" if policy == "mixed" else _f16(tprec))
    loss_tol, step_tol = TOL[policy]
    rng = np.random.default_rng(11)
    p0 = jn.params_flat()
    for step in range(3):
        x, y = data(rng)
        lj, lt = jn.fit_batch(x, y), tn.fit_batch(x, y)
        assert lt == pytest.approx(lj, rel=1e-6 if step == 0 else loss_tol)
        if step == 0:
            dj, dt = jn.params_flat() - p0, tn.params_flat() - p0
            assert np.linalg.norm(dt - dj) <= step_tol * np.linalg.norm(dj)
    assert all(p.dtype == torch.float32 for _, p in tn._param_leaves())
    assert tn.scaler_stats() == jn.scaler_stats()
    out = tn.output(data(rng)[0])
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize("policy", ["mixed", "float16"])
def test_overflow_skips_the_update_bitwise(policy):
    """A poison batch (an inf feature) under a loss-scaled policy: the
    masters, Adam's moments and step count keep their pre-step bits, the
    scale halves, the overflow is counted and the reported loss and norm
    are non-finite, as in JAX; the next clean steps train on and follow
    JAX's."""
    jn, tn = _pair(jzoo.iris_mlp())
    jn.set_precision("mixed" if policy == "mixed" else _f16(jprec))
    tn.set_precision("mixed" if policy == "mixed" else _f16(tprec))
    rng = np.random.default_rng(5)
    x, y = _iris_data(rng)
    for net in (jn, tn):
        net.fit_batch(x, y)
    before = tn.params_flat()
    upd_before = _flat_state(tn.updater_state)
    poison = x.copy()
    poison[3, 1] = np.inf
    lt, lj = tn.fit_batch(poison, y), jn.fit_batch(poison, y)
    assert not np.isfinite(lt) and not np.isfinite(lj)
    assert not np.isfinite(float(tn.last_grad_norm))
    assert tn.params_flat().tobytes() == before.tobytes()
    for a, b in zip(_flat_state(tn.updater_state), upd_before):
        assert a.tobytes() == b.tobytes()
    assert int(tn.updater_state["step"]) == 1
    stats = tn.scaler_stats()
    assert stats == jn.scaler_stats()
    assert stats["overflow_count"] == 1
    assert stats["scale"] == tprec.LossScaleConfig().init_scale / 2
    for _ in range(2):
        x, y = _iris_data(rng)
        assert tn.fit_batch(x, y) == pytest.approx(jn.fit_batch(x, y),
                                                   rel=5e-3)
    assert int(tn.updater_state["step"]) == 3


def test_float16_range_overflow_is_a_skipped_step_as_in_jax():
    """A feature above float16's largest value (65504) overflows when the
    forward casts it: the step is skipped in both packages (no clamp)."""
    jn, tn = _pair(jzoo.iris_mlp())
    jn.set_precision(_f16(jprec))
    tn.set_precision(_f16(tprec))
    x, y = _iris_data(np.random.default_rng(6))
    x[0, 0] = 7.0e4
    before = tn.params_flat()
    lt, lj = tn.fit_batch(x, y), jn.fit_batch(x, y)
    assert not np.isfinite(lt) and not np.isfinite(lj)
    assert tn.params_flat().tobytes() == before.tobytes()
    assert tn.scaler_stats() == jn.scaler_stats()
    assert tn.scaler_stats()["overflow_count"] == 1


def test_accum_plus_loss_scale_rejected():
    tn = TNet(tzoo.iris_mlp(), device="cpu").init().set_precision("mixed")
    x, y = _iris_data(np.random.default_rng(0), 8)
    with pytest.raises(ValueError, match="accum"):
        tn.fit_batch(x, y, accum_steps=2)


def test_fit_precision_adopts_the_policy():
    jn, tn = _pair(jzoo.iris_mlp(updater="sgd", learning_rate=0.1))
    x, y = _iris_data(np.random.default_rng(1))
    jn.fit((x, y), precision="mixed")
    tn.fit((x, y), precision="mixed")
    assert tn.precision == tprec.PrecisionPolicy.named("mixed")
    assert tn.scaler_stats() == jn.scaler_stats()
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-3)


def test_set_precision_casts_masters_and_resets_moments():
    jn, tn = _pair(jzoo.iris_mlp())
    x, y = _iris_data(np.random.default_rng(2))
    jn.fit_batch(x, y)
    tn.fit_batch(x, y)
    assert float(tn.updater_state["m"][0]["W"].abs().sum()) > 0
    # a compute-only change keeps masters and moments
    m_before = tn.updater_state["m"][0]["W"].clone()
    tn.set_precision(tprec.PrecisionPolicy("float32", "bfloat16"))
    assert tn.params[0]["W"].dtype == torch.float32
    assert torch.equal(tn.updater_state["m"][0]["W"], m_before)
    # a param-dtype change casts the masters and re-initializes moments
    jn.set_precision("bf16")
    tn.set_precision("bf16")
    assert all(p.dtype == torch.bfloat16 and p.requires_grad
               for _, p in tn._param_leaves())
    assert float(tn.updater_state["m"][0]["W"].abs().sum()) == 0
    assert int(tn.updater_state["step"]) == int(jn.updater_state["step"]) \
        == 0
    np.testing.assert_array_equal(tn.params_flat(),
                                  np.asarray(jn.params_flat(), np.float32))
    assert tn.set_precision("bf16") is tn            # unchanged: a no-op


def test_train_state_bytes_equals_jax():
    jn, tn = _pair(jzoo.iris_mlp())
    x = _iris_data(np.random.default_rng(3))[0]
    for policy in ("fp32", "mixed", "bf16"):
        jn.set_precision(policy)
        tn.set_precision(policy)
        for shards in (1, 3):
            assert tn.train_state_bytes(shards=shards) == \
                jn.train_state_bytes(shards=shards), (policy, shards)
        assert tn.train_state_bytes(x) == jn.train_state_bytes(x), policy
        assert tprec.param_bytes(tn) == jprec.param_bytes(jn)
        assert tprec.activation_bytes(tn, x) == \
            jprec.activation_bytes(jn, x)
    assert tprec.tree_bytes([{"a": torch.zeros(3, dtype=torch.float16),
                              "b": np.zeros(2, np.int64)}]) == 6 + 16


def test_device_step_updater_path_matches_the_host_path(monkeypatch):
    """The card's path (the step count on the device, Adam's bias
    corrections as float32 tensors there) gives the host path's
    parameters; exercised here by taking it for a CPU count."""
    tn_host = TNet(tzoo.iris_mlp(), device="cpu").init()
    tn_dev = TNet(tzoo.iris_mlp(), device="cpu").init()
    rng = np.random.default_rng(4)
    batches = [_iris_data(rng) for _ in range(3)]
    for x, y in batches:
        tn_host.fit_batch(x, y)
    monkeypatch.setattr(tupd, "_host_step", lambda step: False)
    for x, y in batches:
        tn_dev.fit_batch(x, y)
    np.testing.assert_allclose(tn_dev.params_flat(), tn_host.params_flat(),
                               rtol=0, atol=1e-7)
    assert int(tn_dev.updater_state["step"]) == 3


# ---- checkpoints -------------------------------------------------------------


@pytest.mark.parametrize("policy", ["bf16", "mixed"])
def test_jax_saved_precision_directory_loads_in_the_port(tmp_path, policy):
    jn = JNet(jzoo.iris_mlp()).init()
    jn.set_precision(policy)
    x, y = _iris_data(np.random.default_rng(7))
    jn.fit_batch(x, y)
    jckpt.save_model(jn, tmp_path / "m")
    tn = tckpt.load_model(tmp_path / "m", device="cpu")
    assert tn.precision.param_dtype == jn.precision.param_dtype
    assert tn.precision.compute_dtype == jn.precision.compute_dtype
    np.testing.assert_array_equal(tn.params_flat(),
                                  np.asarray(jn.params_flat(), np.float32))
    np.testing.assert_allclose(tn.label_probabilities(x),
                               np.asarray(jn.output(x), np.float32),
                               atol=2e-2)


@pytest.mark.parametrize("policy", ["bf16", "mixed"])
def test_port_saved_precision_directory_loads_in_jax(tmp_path, policy):
    tn = TNet(tzoo.iris_mlp(), device="cpu").init().set_precision(policy)
    x, y = _iris_data(np.random.default_rng(8))
    tn.fit_batch(x, y)
    tckpt.save_model(tn, tmp_path / "m")
    jn = jckpt.load_model(tmp_path / "m")
    assert jn.precision.param_dtype == tn.precision.param_dtype
    assert jn.precision.compute_dtype == tn.precision.compute_dtype
    np.testing.assert_array_equal(np.asarray(jn.params_flat(), np.float32),
                                  tn.params_flat())
    back = tckpt.load_model(tmp_path / "m", device="cpu")
    assert back.precision == tn.precision.with_loss_scale(None)


def test_load_model_adopts_a_precision_the_conf_does_not_declare(tmp_path):
    jn = JNet(jzoo.iris_mlp()).init()
    jn.set_precision("bf16")
    jckpt.save_model(jn, tmp_path / "m")
    tn = tckpt.load_model(tmp_path / "m", device="cpu")
    assert tn.conf.conf.dtype == "float32"           # the conf says f32
    assert tn.precision == tprec.PrecisionPolicy.named("bf16")
    assert all(p.dtype == torch.bfloat16 for _, p in tn._param_leaves())


# ---- merge -------------------------------------------------------------------


def test_merge_averages_like_jax():
    nets = []
    for seed in (0, 1, 2):
        jn = JNet(jzoo.iris_mlp(seed=seed)).init()
        tn = TNet(tconf.MultiLayerConfiguration.from_json(jn.conf.to_json()),
                  device="cpu").init()
        tn.set_params_flat(jn.params_flat())
        nets.append((jn, tn))
    nets[0][0].merge([j for j, _ in nets[1:]])
    nets[0][1].merge([t for _, t in nets[1:]])
    np.testing.assert_allclose(nets[0][1].params_flat(),
                               nets[0][0].params_flat(), atol=1e-7)
