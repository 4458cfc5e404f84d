"""PyTorch port, slice 3: `MultiLayerNetwork` against the JAX package.

The two packages share the conf JSON and the weights: each test builds
the JAX net, carries its parameters into the port's net
(`params_from_numpy`) and holds outputs, losses and trained parameters
against it on the same numpy inputs.  The port runs on the CPU
(``device="cpu"``), where the fused LSTM is its plain version.

Tolerances (float32): outputs atol 1e-5; three Adam steps atol 1e-5 on
the flat parameters (lr 0.01, random non-one-hot inputs so that no
gradient element is near zero, where Adam's first step turns rounding
noise into a ±lr move).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import evaluation as jev
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu_torch import evaluation as tev
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as tlk
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import initializers as tinit
from deeplearning4j_tpu_torch.ops import losses as tloss
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

V, H, B, T = 11, 16, 4, 7


def _pair(jc, seed_override=None):
    """The JAX net (initialised from its seed) and the port's net on the
    CPU carrying the same weights."""
    jn = JNet(jc).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(jc.to_json()),
              device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


def _seq_data(seed=0, one_hot=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, T))
    x = (np.eye(V, dtype=np.float32)[ids] if one_hot
         else rng.standard_normal((B, T, V)).astype(np.float32))
    y = np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    mask = np.ones((B, T), np.float32)
    mask[1, 5:] = 0
    mask[3, 2:] = 0
    return x, y, mask


def _with_lstm(jc, **kw):
    return dataclasses.replace(jc, layers=tuple(
        dataclasses.replace(lc, **kw) if hasattr(lc, "fused") else lc
        for lc in jc.layers))


def _np(a):
    return np.asarray(a.detach().float().cpu() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


# ---- configuration JSON ---------------------------------------------------

ZOO_NAMES = sorted(jzoo.ZOO)


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_zoo_conf_json_round_trips_between_the_packages(name):
    jc = jzoo.get_model(name)
    tc = tzoo.get_model(name)
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    assert tconf.MultiLayerConfiguration.from_json(jc.to_json()) == tc
    assert jconf.MultiLayerConfiguration.from_json(tc.to_json()) == jc


def test_every_layer_field_survives_the_round_trip():
    layers = (
        jconf.EmbeddingLayerConf(n_in=20, n_out=8),
        jconf.GravesLSTMConf(n_in=8, n_out=6, fused=True, dropout=0.1,
                             l2=1e-3, lr_multiplier=0.5, name="enc"),
        jconf.LSTMConf(n_in=6, n_out=6, fused=False, return_sequences=True),
        jconf.GRUConf(n_in=6, n_out=5, return_sequences=False),
        jconf.BatchNormConf(n_in=5, n_out=5, momentum=0.8),
        jconf.DenseLayerConf(n_in=5, n_out=4, activation="relu",
                             use_dropconnect=True, dropout=0.2,
                             weight_init="distribution",
                             distribution={"type": "uniform", "lower": -1,
                                           "upper": 1}),
        jconf.OutputLayerConf(n_in=4, n_out=3, loss="mse", l1=1e-4))
    jc = jconf.MultiLayerConfiguration(
        conf=jconf.NeuralNetConfiguration(
            compute_dtype="bfloat16", output_dtype="bfloat16", seed=7,
            updater="nesterovs", clip_norm=1.0),
        layers=layers, input_preprocessors={"3": {"type": "rnn_last_step"}})
    tc = tconf.MultiLayerConfiguration.from_json(jc.to_json())
    assert tc.to_dict() == jc.to_dict()
    assert tc.layers[1].fused is True and tc.layers[2].fused is False
    assert jconf.MultiLayerConfiguration.from_json(tc.to_json()) == jc
    assert tc.conf.updater_config().updater == "nesterovs"


# ---- ops -------------------------------------------------------------------


@pytest.mark.parametrize("name", jact.available_activations())
def test_activations_match(name):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    if name in ("sqrt", "log"):
        x = np.abs(x) + 0.1
    want = np.asarray(jact.get_activation(name)(jnp.asarray(x)))
    got = tact.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", jloss.available_losses())
def test_losses_match(name):
    rng = np.random.default_rng(1)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 3))]
    p = rng.uniform(0.05, 0.95, (2, 3, 4)).astype(np.float32)
    want = float(jloss.get_loss(name)(jnp.asarray(y), jnp.asarray(p)))
    got = float(tloss.get_loss(name)(torch.from_numpy(y),
                                     torch.from_numpy(p)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("scheme", [s.value for s in tinit.WeightInit])
def test_initializers_draw_the_jax_scales(scheme):
    """The generators differ, so the draws are compared by statistics."""
    g = torch.Generator().manual_seed(0)
    w = tinit.init_weights(g, (200, 300), scheme).numpy()
    assert w.shape == (200, 300) and w.dtype == np.float32
    if scheme == "zero":
        assert not w.any()
        return
    from deeplearning4j_tpu.ops.initializers import init_weights
    import jax

    want = np.asarray(init_weights(jax.random.PRNGKey(0), (200, 300),
                                   scheme))
    assert w.std() == pytest.approx(want.std(), rel=0.05)
    assert w.mean() == pytest.approx(want.mean(), abs=0.05 * want.std()
                                     + 1e-3)


# ---- forward parity ----------------------------------------------------------


@pytest.mark.parametrize("fused", [None, True, False])
def test_char_lstm_output_matches(fused):
    jc = _with_lstm(jzoo.char_lstm(vocab_size=V, hidden=H), fused=fused)
    jn, tn = _pair(jc)
    x, _, _ = _seq_data()
    out = tn.output(x)
    assert out.shape == (B, T, V) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(jn.output(x)),
                               atol=1e-5)
    np.testing.assert_array_equal(tn.predict(x), jn.predict(x))


def test_masked_sequences_match():
    jn, tn = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    x, y, mask = _seq_data()
    np.testing.assert_allclose(_np(tn.output(x, mask)),
                               np.asarray(jn.output(x, mask)), atol=1e-5)
    assert tn.score(x, y, mask) == pytest.approx(jn.score(x, y, mask),
                                                 rel=1e-5)


@pytest.mark.parametrize("layer", ["lstm", "gru", "lstm_last_step"])
def test_other_recurrent_layers_match(layer):
    if layer == "gru":
        rec = jconf.GRUConf(n_in=V, n_out=H)
    else:
        rec = jconf.LSTMConf(n_in=V, n_out=H,
                             return_sequences=layer == "lstm")
    head = (jconf.RnnOutputLayerConf(n_in=H, n_out=V)
            if layer != "lstm_last_step"
            else jconf.OutputLayerConf(n_in=H, n_out=V))
    jc = jconf.MultiLayerConfiguration(
        conf=jconf.NeuralNetConfiguration(seed=3), layers=(rec, head))
    jn, tn = _pair(jc)
    x, _, mask = _seq_data(seed=2)
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               atol=1e-5)
    if layer != "lstm_last_step":
        np.testing.assert_allclose(_np(tn.output(x, mask)),
                                   np.asarray(jn.output(x, mask)), atol=1e-5)


def test_iris_shaped_mlp_matches():
    jn, tn = _pair(jzoo.iris_mlp())
    rng = np.random.default_rng(4)
    x = rng.standard_normal((10, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               atol=1e-5)
    for a, b in zip(tn.feed_forward(x), jn.feed_forward(x)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)
    assert tn.score(x, y) == pytest.approx(jn.score(x, y), rel=1e-5)
    for _ in range(3):
        assert tn.fit_batch(x, y) == pytest.approx(jn.fit_batch(x, y),
                                                   rel=1e-5)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-5)


def test_batchnorm_embedding_net_trains_like_jax():
    """Batch norm's f32 running moments and an embedding lookup through
    two SGD steps: params and layer state."""
    jc = jconf.MultiLayerConfiguration(
        conf=jconf.NeuralNetConfiguration(seed=5, learning_rate=0.1),
        layers=(jconf.EmbeddingLayerConf(n_in=9, n_out=6),
                jconf.BatchNormConf(n_in=6, n_out=6),
                jconf.DenseLayerConf(n_in=6, n_out=5, activation="tanh"),
                jconf.OutputLayerConf(n_in=5, n_out=3)))
    jn, tn = _pair(jc)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 9, 12)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    for _ in range(2):
        assert tn.fit_batch(ids, y) == pytest.approx(jn.fit_batch(ids, y),
                                                     rel=1e-5)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(tn.state[1][k]),
                                   np.asarray(jn.state[1][k]), atol=1e-6)
    np.testing.assert_allclose(_np(tn.output(ids)), np.asarray(jn.output(ids)),
                               atol=1e-5)


# ---- training parity ----------------------------------------------------------


@pytest.mark.parametrize("accum,masked", [(1, False), (2, False), (2, True),
                                          (1, True)])
def test_three_adam_steps_match_params_flat(accum, masked):
    jn, tn = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    x, y, mask = _seq_data(seed=8)
    m = mask if masked else None
    for _ in range(3):
        lj = jn.fit_batch(x, y, m, accum_steps=accum)
        lt = tn.fit_batch(x, y, m, accum_steps=accum)
        assert lt == pytest.approx(lj, rel=1e-5)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-5)
    assert float(tn.last_grad_norm) == pytest.approx(
        float(jn.last_grad_norm), rel=1e-4)
    assert all(p.dtype == torch.float32 for _, p in tn._param_leaves())


def test_bf16_compute_trains_with_f32_masters():
    """bfloat16 compute (the char-LSTM's card recipe) keeps float32
    masters and follows the JAX net's losses loosely: the fused scan
    carries h and c in f32 where the JAX scan carries them in bf16."""
    jc = jzoo.char_lstm(vocab_size=V, hidden=H, compute_dtype="bfloat16")
    jn, tn = _pair(jc)
    x, y, _ = _seq_data(seed=9, one_hot=True)
    losses = [(tn.fit_batch(x, y), jn.fit_batch(x, y)) for _ in range(3)]
    for lt, lj in losses:
        assert lt == pytest.approx(lj, rel=2e-2)
    assert losses[-1][0] < losses[0][0]
    assert all(p.dtype == torch.float32 for _, p in tn._param_leaves())
    assert tn.output(x).dtype == torch.float32


def test_fit_over_datasets_tuples_and_listeners():
    jn, tn = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    x, y, mask = _seq_data(seed=10)
    seen = {"t": [], "j": []}
    tn.add_listener(lambda it, s: seen["t"].append((it, s)))
    jn.add_listener(lambda it, s: seen["j"].append((it, s)))
    jdata = [JDataSet(x[:2], y[:2], mask[:2]), JDataSet(x[2:], y[2:])]
    tdata = [TDataSet(x[:2], y[:2], mask[:2]), TDataSet(x[2:], y[2:])]
    jn.fit(jdata, epochs=2)
    tn.fit(tdata, epochs=2)
    jn.fit((x, y))
    tn.fit((x, y))
    assert [i for i, _ in seen["t"]] == [i for i, _ in seen["j"]] == \
        [1, 2, 3, 4, 5]
    np.testing.assert_allclose([s for _, s in seen["t"]],
                               [s for _, s in seen["j"]], rtol=1e-5)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-5)


def test_lr_scale_and_multipliers_match():
    jc = jzoo.char_lstm(vocab_size=V, hidden=H)
    jc = dataclasses.replace(jc, layers=(
        jc.layers[0], dataclasses.replace(jc.layers[1], lr_multiplier=0.5,
                                          l2=1e-2)))
    jn, tn = _pair(jc)
    jn.set_lr_scale(0.25)
    tn.set_lr_scale(0.25)
    x, y, _ = _seq_data(seed=11)
    for _ in range(2):
        assert tn.fit_batch(x, y) == pytest.approx(jn.fit_batch(x, y),
                                                   rel=1e-5)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-5)
    with pytest.raises(ValueError):
        tn.set_lr_scale(0.0)


# ---- evaluation, datasets, checkpoints, weights -----------------------------


def test_evaluate_stats_equal():
    jn, tn = _pair(jzoo.iris_mlp())
    rng = np.random.default_rng(12)
    x = rng.standard_normal((23, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 23)]
    assert tn.evaluate(x, y).stats() == jn.evaluate(x, y).stats()
    assert tn.evaluate(x, y, batch_size=5).stats() == \
        jn.evaluate(x, y, batch_size=5).stats()
    with pytest.raises(ValueError):
        tn.evaluate(x, y, batch_size=0)
    jn2, tn2 = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    xs, ys, _ = _seq_data(seed=13)
    assert tn2.evaluate(xs, ys).stats() == jn2.evaluate(xs, ys).stats()


def test_evaluation_module_matches():
    rng = np.random.default_rng(14)
    labels = rng.integers(0, 4, 50)
    preds = rng.standard_normal((50, 4))
    je, te = jev.Evaluation(), tev.Evaluation()
    je.eval(labels, preds)
    te.eval(labels, preds)
    assert te.stats() == je.stats()
    assert te.f1() == je.f1() and te.accuracy() == je.accuracy()


def test_dataset_shuffle_and_batches_match():
    rng = np.random.default_rng(15)
    x, y = rng.standard_normal((9, 3)), rng.standard_normal((9, 2))
    jd, td = JDataSet(x, y), TDataSet(x, y)
    np.testing.assert_array_equal(td.shuffle(3).features,
                                  jd.shuffle(3).features)
    assert [b.num_examples() for b in td.batch_by(4)] == \
        [b.num_examples() for b in jd.batch_by(4)] == [4, 4, 1]
    a, b = td.split_test_and_train(6, seed=1)
    c, d = jd.split_test_and_train(6, seed=1)
    np.testing.assert_array_equal(a.labels, c.labels)
    np.testing.assert_array_equal(b.features, d.features)


def test_jax_saved_model_loads_in_the_port(tmp_path):
    jn, _ = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    x, y, _ = _seq_data(seed=16)
    jn.fit_batch(x, y)
    jckpt.save_model(jn, tmp_path / "m", save_updater=True)
    tn = tckpt.load_model(tmp_path / "m", device="cpu")
    np.testing.assert_array_equal(tn.params_flat(), jn.params_flat())
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               atol=1e-5)
    # the restored Adam moments continue the JAX run
    assert tn.fit_batch(x, y) == pytest.approx(jn.fit_batch(x, y), rel=1e-5)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-5)


def test_port_saved_model_loads_in_jax(tmp_path):
    _, tn = _pair(jzoo.char_lstm(vocab_size=V, hidden=H,
                                 compute_dtype="bfloat16"))
    x, y, _ = _seq_data(seed=17)
    tn.fit_batch(x, y)
    tckpt.save_model(tn, tmp_path / "m", save_updater=True)
    jn = jckpt.load_model(tmp_path / "m")
    assert jn.conf == jzoo.char_lstm(vocab_size=V, hidden=H,
                                     compute_dtype="bfloat16")
    np.testing.assert_array_equal(jn.params_flat(), tn.params_flat())
    np.testing.assert_array_equal(
        np.asarray(jn.updater_state["m"][0]["RW"]),
        _np(tn.updater_state["m"][0]["RW"]))
    assert int(jn.updater_state["step"]) == 1
    tn2 = tckpt.load_model(tmp_path / "m", device="cpu")
    np.testing.assert_array_equal(tn2.params_flat(), tn.params_flat())


def test_params_from_numpy_takes_the_flat_vector_in_its_order():
    jn, tn = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    assert [k for k, _ in tn._param_leaves()][:6] == \
        ["0/RW", "0/W", "0/b", "0/pf", "0/pi", "0/po"]
    other = TNet(tzoo.char_lstm(vocab_size=V, hidden=H), device="cpu").init()
    other.params = params_from_numpy(other, jn.params_flat())
    np.testing.assert_array_equal(other.params_flat(), jn.params_flat())
    assert tn.num_params() == jn.num_params()
    assert tn.summary() == jn.summary()
    clone = tn.clone()
    np.testing.assert_array_equal(clone.params_flat(), tn.params_flat())
    with pytest.raises(ValueError, match="length"):
        tn.set_params_flat(np.zeros(3, np.float32))
    back = TNet.from_json(jn.conf.to_json(), jn.params_flat(), device="cpu")
    np.testing.assert_array_equal(back.params_flat(), jn.params_flat())


# ---- policy and left-out parts -----------------------------------------------


def test_the_fused_path_runs_by_default(monkeypatch):
    from deeplearning4j_tpu_torch.nn.layers import recurrent as trec

    calls = []
    real = trec.fused_lstm_scan
    monkeypatch.setattr(trec, "fused_lstm_scan",
                        lambda *a: calls.append(1) or real(*a))
    _, tn = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    x, y, mask = _seq_data(seed=18)
    tn.output(x)
    tn.fit_batch(x, y)
    assert len(calls) == 2
    tn.output(x, mask)                     # a mask takes the scan
    _, tn_off = _pair(_with_lstm(jzoo.char_lstm(vocab_size=V, hidden=H),
                                 fused=False))
    tn_off.output(x)
    assert len(calls) == 2
    before = tlk.fused_lstm_forward.launches.value
    tn.output(x)
    assert tlk.fused_lstm_forward.launches.value == before   # CPU: plain


def test_wide_graves_lstm_takes_the_scan_and_matches_jax(monkeypatch):
    """n_out 1100 is above the kernel's width: with ``fused=None`` the
    layer runs the step-by-step scan (no fused call), as JAX's
    ``fused=None`` does, and matches it at 1e-5."""
    from deeplearning4j_tpu_torch.nn.layers import recurrent as trec

    calls = []
    monkeypatch.setattr(trec, "fused_lstm_scan",
                        lambda *a: calls.append(1))
    n = tlk.MAX_HIDDEN + 76
    jc = jconf.MultiLayerConfiguration(
        conf=jconf.NeuralNetConfiguration(seed=5),
        layers=(jconf.GravesLSTMConf(n_in=V, n_out=n),
                jconf.RnnOutputLayerConf(n_in=n, n_out=V)))
    jn, tn = _pair(jc)
    x = np.random.default_rng(6).standard_normal((2, 3, V)).astype(
        np.float32)
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               atol=1e-5)
    assert calls == []


def test_network_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TNet(tzoo.char_lstm())


@pytest.mark.parametrize("name", ["lenet-mnist", "alexnet-cifar10",
                                  "lenet-digits", "dbn-mnist",
                                  "deep-autoencoder"])
def test_unported_layer_types_raise_naming_the_roadmap(name):
    """These five zoo models were refused until their layers (convolution,
    subsampling, RBM, autoencoder) were ported: each now builds, inits on
    the CPU and gives the JAX net's `output` on the same weights."""
    from test_torch_conv import pair

    jn, tn = pair(jzoo.get_model(name))
    shape = {"lenet-mnist": (2, 28, 28, 1), "lenet-digits": (2, 8, 8, 1),
             "alexnet-cifar10": (2, 32, 32, 3)}.get(name, (2, 784))
    x = np.random.default_rng(7).random(shape, dtype=np.float32)
    out = tn.output(x)
    assert out.shape == jn.output(x).shape
    np.testing.assert_allclose(_np(out), np.asarray(jn.output(x)),
                               atol=1e-5)
