"""PyTorch port, slice 18: `DataParallelTrainer` against the JAX package's.

The JAX side runs on the conftest's virtual CPU devices
(``make_mesh((n,), devices=jax.devices()[:n])``), the port on a mesh of
``n`` host shards (``devices=["cpu"] * n``); the same numpy batches and
the same initial weights (`params_from_numpy`) go through both, on an
Iris-shaped MLP and a tiny char-LSTM (vocab 11, H 16, T 8: B5's plain
version runs on every shard).

Tolerances: float32 parameters and moments within 1e-5 absolute of JAX
after 3-9 steps (`tests/test_zero.py`'s own bound); bfloat16 ("mixed")
losses within 5e-3 relative (`tests/test_torch_precision.py`'s).
Inside the port, bitwise: ZeRO-1 = replicated in float32, the local-SGD
sync round (sharded = replicated average), chunk 1 = chunk K, and the
N→M restores (`tests/test_torch_partition.py`).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.ml import pipeline as jml
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.optimize import InvalidScoreError as JInvalid
from deeplearning4j_tpu.parallel import DataParallelTrainer as JDP
from deeplearning4j_tpu.parallel import make_mesh as jmesh
from deeplearning4j_tpu import resilience as jr
from deeplearning4j_tpu_torch.ml import pipeline as tml
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as tlk
from deeplearning4j_tpu_torch.optimize import InvalidScoreError as TInvalid
from deeplearning4j_tpu_torch.parallel import DataParallelTrainer as TDP
from deeplearning4j_tpu_torch.parallel import make_mesh as tmesh
from deeplearning4j_tpu_torch import resilience as tr
from deeplearning4j_tpu_torch.precision import shard_update_finite
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

TOL = 1e-5
V, H, T = 11, 16, 8


def _mlp(mod, seed=5, lr=0.02, mults=(1.0, 1.0), updater="adam", **kw):
    return mod.MultiLayerConfiguration(
        conf=mod.NeuralNetConfiguration(learning_rate=lr, updater=updater,
                                        seed=seed, **kw),
        layers=(mod.DenseLayerConf(n_in=4, n_out=16, activation="relu",
                                   lr_multiplier=mults[0]),
                mod.OutputLayerConf(n_in=16, n_out=3,
                                    lr_multiplier=mults[1])))


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = rng.normal(0, 0.3, (n, 4)).astype(np.float32) + y[:, None]
    return x, np.eye(3, dtype=np.float32)[y]


def _seq(b=8, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (b, T))
    x = rng.standard_normal((b, T, V)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    mask = np.ones((b, T), np.float32)
    mask[1, 5:] = 0
    return x, y, mask


def _pair(jc):
    """The JAX net and the port's CPU net carrying its weights."""
    jn = JNet(jc).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(jc.to_json()),
              device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


def _trainers(jn, tn, n, **kw):
    return (JDP(jn, mesh=jmesh((n,), ("data",), devices=jax.devices()[:n]),
                **kw),
            TDP(tn, mesh=tmesh((n,), ("data",), devices=["cpu"] * n), **kw))


def _tflat(tree):
    return np.concatenate([np.asarray(t.detach().float().cpu()).ravel()
                           for t in jax.tree_util.tree_leaves(tree)])


def _jflat(tree):
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _run_port(conf, steps=5, shard=True, sync_every=1, precision=None,
              n=4, batch=None):
    net = TNet(conf, device="cpu").init()
    if precision:
        net.set_precision(precision)
    t = TDP(net, mesh=tmesh((n,), ("data",), devices=["cpu"] * n),
            sync_every=sync_every, shard_update=shard)
    x, y = batch or _data()
    losses = [t.fit_batch(x, y) for _ in range(steps)]
    t.finalize()
    return net, losses


# ---- parity with JAX -------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["zero1", "replicated", "local_sgd"])
def test_update_planes_match_jax(mode, n):
    """ZeRO-1, replicated and local SGD (sync 3, 9 steps): losses,
    parameters and published moments within 1e-5 of JAX's."""
    kw = {"zero1": {}, "replicated": {"shard_update": False},
          "local_sgd": {"sync_every": 3}}[mode]
    steps = 9 if mode == "local_sgd" else 5
    jn, tn = _pair(_mlp(jconf))
    jt, tt = _trainers(jn, tn, n, **kw)
    x, y = _data()
    jl = [jt.fit_batch(x, y) for _ in range(steps)]
    tl = [tt.fit_batch(x, y) for _ in range(steps)]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    if mode == "zero1":
        # the live moment slices, before any publish, against JAX's
        k0 = tn.num_params()
        assert tt._flat_k == jt._flat_k
        for slot in ("m", "v"):
            ours = torch.cat([s[slot]["p"] for s in tt._opt_shard])
            np.testing.assert_allclose(
                ours.numpy(), np.asarray(jt._opt_shard[slot]["p"]),
                rtol=0, atol=TOL)
            assert torch.all(ours[k0:] == 0)  # the padding lanes
    jt.finalize()
    tt.finalize()
    np.testing.assert_allclose(_tflat(tn.params), _jflat(jn.params),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(_tflat(tn.updater_state),
                               _jflat(jn.updater_state), rtol=0, atol=TOL)


@pytest.mark.parametrize("n,masked", [(2, False), (4, False), (2, True)])
def test_char_lstm_matches_jax_and_runs_b5_per_shard(n, masked):
    """The char-LSTM through ZeRO-1: each shard's forward runs the fused
    LSTM scan once on its 1/n of the batch (its plain version here, B5
    on the card; a sequence mask takes the step-by-step scan instead),
    and 3 steps land within 1e-5 of JAX's."""
    jn, tn = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    jt, tt = _trainers(jn, tn, n)
    x, y, mask = _seq()
    mask = mask if masked else None
    calls = []
    plain = tlk.fused_lstm_forward_plain

    def counted(xz, *a, **k):
        calls.append(xz.shape[1])  # xz is [T, B, 4H]
        return plain(xz, *a, **k)

    tlk.fused_lstm_forward_plain = counted
    try:
        tl = [tt.fit_batch(x, y, mask) for _ in range(3)]
    finally:
        tlk.fused_lstm_forward_plain = plain
    jl = [jt.fit_batch(x, y, mask) for _ in range(3)]
    assert calls == ([] if masked else [8 // n] * (3 * n))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    jt.finalize()
    tt.finalize()
    np.testing.assert_allclose(_tflat(tn.params), _jflat(jn.params),
                               rtol=0, atol=TOL)


def _unit_norm(pkg_conf):
    orig = pkg_conf.NeuralNetConfiguration.updater_config

    def patched(self):
        return dataclasses.replace(orig(self), unit_norm=True)
    return orig, patched


@pytest.mark.parametrize("case", ["l1_l2", "clip_norm", "unit_norm",
                                  "lr_multipliers", "clip_value"])
def test_pre_apply_transforms_match_jax(case):
    """The ZeRO-1 plane re-applies the updater's pre-apply transforms on
    the flat slices (global norms from shard partials, unit_norm by leaf
    segments); 2 shards against JAX's, 3-5 steps within 1e-5."""
    kw = {"l1_l2": dict(l1=1e-3, l2=1e-3), "clip_norm": dict(clip_norm=0.5),
          "unit_norm": dict(updater="sgd"), "lr_multipliers":
          dict(mults=(0.5, 2.0)), "clip_value": dict(clip_value=0.05)}[case]
    patches = []
    if case == "unit_norm":
        for mod in (jconf, tconf):
            orig, patched = _unit_norm(mod)
            mod.NeuralNetConfiguration.updater_config = patched
            patches.append((mod, orig))
    try:
        jn, tn = _pair(_mlp(jconf, **kw))
        jt, tt = _trainers(jn, tn, 2)
        x, y = _data()
        for _ in range(3 if case == "unit_norm" else 5):
            jt.fit_batch(x, y)
            tt.fit_batch(x, y)
        jt.finalize()
        tt.finalize()
    finally:
        for mod, orig in patches:
            mod.NeuralNetConfiguration.updater_config = orig
    np.testing.assert_allclose(_tflat(tn.params), _jflat(jn.params),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("shard", [True, False])
def test_mixed_precision_matches_jax_and_skips_in_lockstep(shard):
    """Under "mixed" each shard scales its loss; a batch that is infinite
    on one shard's rows only skips the step on every shard: parameters
    and moments bitwise unchanged, the scale halved, one overflow — in
    both packages."""
    jn, tn = _pair(_mlp(jconf))
    jn.set_precision("mixed")
    tn.set_precision("mixed")
    jt, tt = _trainers(jn, tn, 2, shard_update=shard)
    x, y = _data()
    jl = [jt.fit_batch(x, y) for _ in range(3)]
    tl = [tt.fit_batch(x, y) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    tt.publish_train_state()
    p0, u0 = _tflat(tn.params), _tflat(tn.updater_state)
    scale0 = tn.scaler_stats()["scale"]
    bad = x.copy()
    bad[3, 1] = np.inf  # row 3 lies in shard 0 of 2
    jt.fit_batch(bad, y)
    tt.fit_batch(bad, y)
    tt.publish_train_state()
    assert np.array_equal(_tflat(tn.params), p0)
    assert np.array_equal(_tflat(tn.updater_state), u0)
    ts, js = tn.scaler_stats(), jn.scaler_stats()
    assert ts == js
    assert ts["overflow_count"] == 1 and ts["scale"] == scale0 / 2
    assert np.isfinite(tt.fit_batch(x, y))


@pytest.mark.parametrize("shard", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_inf_in_one_gradient_slice_skips_every_shard(n, shard):
    """The loss stays finite and one inf lands in the last shard's slice
    of the reduced gradient: only the count over the slices sees it, and
    every shard skips (parameters and moments bitwise, the scale halved,
    one overflow)."""
    net = TNet(_mlp(tconf), device="cpu").init()
    net.set_precision("mixed")
    t = TDP(net, mesh=tmesh(devices=["cpu"] * n), shard_update=shard)
    x, y = _data()
    t.fit_batch(x, y)
    t.publish_train_state()
    p0, u0 = _tflat(net.params), _tflat(net.updater_state)
    s0 = net.scaler_stats()
    plain = t._shard_grads

    def planted(*args, **kwargs):
        pieces = plain(*args, **kwargs)
        grads = pieces[0][2]
        grads[-1] = grads[-1].clone()
        grads[-1].view(-1)[-1] = float("inf")  # flat lane k0 - 1
        return pieces

    t._shard_grads = planted
    assert np.isfinite(t.fit_batch(x, y))
    del t._shard_grads
    t.publish_train_state()
    assert np.array_equal(_tflat(net.params), p0)
    assert np.array_equal(_tflat(net.updater_state), u0)
    s1 = net.scaler_stats()
    assert s1["scale"] == s0["scale"] / 2
    assert s1["overflow_count"] == s0["overflow_count"] + 1
    assert np.isfinite(t.fit_batch(x, y))


def test_shard_update_finite_is_one_verdict():
    g = [torch.ones(4), torch.ones(4)]
    assert bool(shard_update_finite(g, torch.tensor(1.0)))
    g[1][2] = float("nan")
    assert not bool(shard_update_finite(g, torch.tensor(1.0)))
    assert not bool(shard_update_finite([torch.ones(4)],
                                        torch.tensor(float("inf"))))


@pytest.mark.parametrize("shard", [True, False])
def test_chunked_fit_matches_jax(shard):
    jn, tn = _pair(_mlp(jconf))
    jt, tt = _trainers(jn, tn, 4, shard_update=shard)
    x, y = _data()
    jt.fit([(x, y)] * 6 + [(x[:40], y[:40])], chunk_size=4)
    tt.fit([(x, y)] * 6 + [(x[:40], y[:40])], chunk_size=4)
    np.testing.assert_allclose(_tflat(tn.params), _jflat(jn.params),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(_tflat(tn.updater_state),
                               _jflat(jn.updater_state), rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", [dict(), dict(shard_update=False),
                                  dict(sync_every=4)],
                         ids=["zero1", "replicated", "local_sgd"])
def test_scaling_report_and_train_state_bytes_equal_jax(mode):
    jn, tn = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    jt, tt = _trainers(jn, tn, 4, **mode)
    assert tt.scaling_report() == jt.scaling_report()
    x, _, mask = _seq()
    assert tt.train_state_bytes() == jt.train_state_bytes()
    assert tt.train_state_bytes(x, mask) == jt.train_state_bytes(x, mask)
    spec = tt.train_state_partition()
    assert spec["replicas"] == 4 and spec["params"].is_replicated
    if "shard_update" not in mode and "sync_every" not in mode:
        assert spec["live_updater"]["m"]["p"].size == tt._flat_k


# ---- bitwise inside the port ---------------------------------------------

@pytest.mark.parametrize("net", ["mlp", "char_lstm"])
def test_zero1_equals_replicated_bitwise_in_f32(net):
    conf = (_mlp(tconf) if net == "mlp"
            else tconf.MultiLayerConfiguration.from_json(
                jzoo.char_lstm(vocab_size=V, hidden=H).to_json()))
    batch = None if net == "mlp" else _seq()[:2]
    a, la = _run_port(conf, shard=True, batch=batch)
    b, lb = _run_port(conf, shard=False, batch=batch)
    assert la == lb
    assert np.array_equal(_tflat(a.params), _tflat(b.params))
    assert np.array_equal(_tflat(a.updater_state), _tflat(b.updater_state))


@pytest.mark.parametrize("kw", [dict(l2=1e-3), dict(mults=(0.5, 2.0))],
                         ids=["l2", "lr_multipliers"])
def test_elementwise_transforms_stay_bitwise(kw):
    a, _ = _run_port(_mlp(tconf, **kw), shard=True)
    b, _ = _run_port(_mlp(tconf, **kw), shard=False)
    assert np.array_equal(_tflat(a.params), _tflat(b.params))


def test_sync_round_average_is_bitwise_and_replicas_restart_equal():
    a, _ = _run_port(_mlp(tconf), steps=9, sync_every=3, shard=True)
    b, _ = _run_port(_mlp(tconf), steps=9, sync_every=3, shard=False)
    assert np.array_equal(_tflat(a.params), _tflat(b.params))
    net = TNet(_mlp(tconf), device="cpu").init()
    t = TDP(net, mesh=tmesh((4,), ("data",), devices=["cpu"] * 4),
            sync_every=3)
    x, y = _data()
    for step in range(1, 7):
        t.fit_batch(x, y)
        reps = [_tflat(r[0]) + 0 for r in t._rep]
        if step % 3:
            assert not np.array_equal(reps[0], reps[1])  # drift
        else:
            assert all(np.array_equal(reps[0], r) for r in reps[1:])
            assert np.array_equal(reps[0], _tflat(net.params))


@pytest.mark.parametrize("shard", [True, False])
def test_chunk_one_equals_chunk_k_bitwise(shard):
    def run(chunk):
        net = TNet(_mlp(tconf), device="cpu").init()
        t = TDP(net, mesh=tmesh((4,), ("data",), devices=["cpu"] * 4),
                shard_update=shard)
        x, y = _data()
        t.fit([(x, y)] * 8, chunk_size=chunk)
        return net

    a, b = run(1), run(4)
    assert np.array_equal(_tflat(a.params), _tflat(b.params))
    assert np.array_equal(_tflat(a.updater_state), _tflat(b.updater_state))


def test_guards_and_policy_change():
    net = TNet(_mlp(tconf), device="cpu").init()
    net.set_precision("mixed")
    with pytest.raises(ValueError, match="synchronous DP path"):
        TDP(net, mesh=tmesh(devices=["cpu"] * 2), sync_every=2)
    net = TNet(_mlp(tconf), device="cpu").init()
    t = TDP(net, mesh=tmesh(devices=["cpu"] * 4), sync_every=2)
    with pytest.raises(NotImplementedError, match="local-SGD"):
        t.fit_chunk_async(np.zeros((1, 4, 4), np.float32),
                          np.zeros((1, 4, 3), np.float32))
    x, y = _data()
    with pytest.raises(ValueError, match="not divisible by 4"):
        t.fit_batch(x[:6], y[:6])
    with pytest.raises(ValueError, match="one axis"):
        TDP(net, mesh=tmesh((2, 2), ("data", "model"),
                            devices=["cpu"] * 4))
    # a precision change rebuilds the ZeRO-1 slices around the moments
    t = TDP(net, mesh=tmesh(devices=["cpu"] * 2))
    t.fit_batch(x, y)
    net.set_precision("mixed")
    assert np.isfinite(t.fit_batch(x, y))
    assert net.scaler_stats()["good_steps"] == 1


# ---- the hand-off of the optimizer state back to the net --------------------

@pytest.mark.parametrize("precision", [None, "mixed"])
def test_direct_training_after_sharded_reinits_cleanly(precision):
    """A net that an un-finalized ZeRO-1 trainer left behind trains
    directly: the registration is dropped and the moments restart."""
    x, y = _data(8, seed=2)
    net = TNet(_mlp(tconf), device="cpu").init()
    if precision:
        net.set_precision(precision)
    t = TDP(net, mesh=tmesh(devices=["cpu"] * 2))
    t.fit_batch(x, y)
    assert net.updater_state is None and net._updater_state_owner is t
    assert np.isfinite(net.fit_batch(x, y))
    assert net._updater_state_owner is None
    assert int(net.updater_state["step"]) == 1  # fresh moments, one step


@pytest.mark.parametrize("via", ["restore_train_state", "resume_train_state"])
def test_restore_onto_abandoned_trainer_s_net_saves_restored_moments(
        tmp_path, via):
    """Restored moments survive the next save: the abandoned trainer no
    longer publishes its own over them."""
    from deeplearning4j_tpu_torch.runtime.checkpoint import (
        load_model, resume_train_state, save_checkpoint, save_model)

    x, y = _data()
    src = TNet(_mlp(tconf, seed=9), device="cpu").init()
    for _ in range(3):
        src.fit_batch(x, y)
    net = TNet(_mlp(tconf), device="cpu").init()
    TDP(net, mesh=tmesh(devices=["cpu"] * 2)).fit_batch(x, y)
    if via == "restore_train_state":
        net.restore_train_state(3, src.params, src.updater_state, src.state)
    else:
        save_checkpoint(tmp_path / "ck", 3, src.params, src.updater_state,
                        net_state=src.state)
        assert resume_train_state(tmp_path / "ck", net) == 3
    save_model(net, tmp_path / "m", save_updater=True)
    got = load_model(tmp_path / "m", device="cpu")
    assert np.array_equal(_tflat(got.updater_state),
                          _tflat(src.updater_state))
    assert np.array_equal(_tflat(got.params), _tflat(src.params))
