"""PyTorch port, slice 8: convolution and pooling layers and the conv nets
against the JAX package.

Both packages get the same numpy inputs made from a seed; the port's
weights are the JAX net's, carried over by `set_params_flat` /
`params_from_numpy` (HWIO kernels).  Everything is float32 on the CPU.

Tolerances: layer outputs 1e-5 absolute; a net's loss and every gradient
1e-5 relative max error (max |port - jax| over max |jax|, per leaf);
parameters after three SGD steps 1e-5 absolute.

The conv nets are also held in bfloat16 compute: the loss within 1e-6
relative and all the gradients together within 1e-2 relative L2 norm
(||port - jax|| / ||jax||).  Readings over 12 seeded batches of each net
(CPU, `tools/torch_conv_bf16_readings.py`): port against JAX, both in
bf16, loss at most 2.1e-7 and gradients at most 5.2e-3; JAX's bf16
against its float32 (a computation in a lower precision), loss at least
6.6e-6 and gradients at least 1.7e-2.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


def pair(jc, device="cpu"):
    """The JAX net and the port's net with the same weights: drawn once as
    numpy arrays (by the port's initializers, from the conf's seed), set
    as the JAX net's parameters and carried into the port's by
    `params_from_numpy`.  (JAX's own `init` compiles its random draws
    for every new shape, seconds a net on the CPU.)"""
    tn = TNet(tconf.MultiLayerConfiguration.from_json(jc.to_json()),
              device=device).init()
    weights = [{k: v.detach().cpu().numpy().copy() for k, v in p.items()}
               for p in tn.params]
    jn = JNet(jc)
    jn.params = [{k: jnp.array(v) for k, v in p.items()} for p in weights]
    jn.state = [{} for _ in weights]
    jn.updater_state = jn._updater.init(jn.params)
    tn.params = params_from_numpy(tn, weights)
    return jn, tn


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


# ---- layers ----------------------------------------------------------------


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv_layer_matches(k, stride, padding):
    lc = jconf.ConvolutionLayerConf(n_in=3, n_out=4, kernel_size=(k, k),
                                    stride=(stride, stride), padding=padding,
                                    activation="identity")
    rng = np.random.default_rng(k * 10 + stride)
    params = {"W": rng.standard_normal((k, k, 3, 4)).astype(np.float32),
              "b": np.linspace(-1, 1, 4).astype(np.float32)}
    x = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    want, _ = jconv.conv_apply(lc, params, {}, jnp.asarray(x))
    tlc = tconf.layers.ConvolutionLayerConf(**dataclasses.asdict(lc))
    got, _ = tconv.conv_apply(tlc, {n: torch.from_numpy(v)
                                    for n, v in params.items()}, {},
                              torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("kernel", [(3, 3), (5, 5), (3, 2)],
                         ids=["k33", "k55", "k32"])
def test_im2col_route_matches(kernel, padding):
    """`im2col_conv`, the card's float32 route (reached here directly: on
    the CPU `conv_apply` takes `F.conv2d`), at stride (2, 1): output, and
    the gradients of the input and the kernel for one cotangent, against
    XLA's."""
    stride = (2, 1)
    lc = jconf.ConvolutionLayerConf(n_in=3, n_out=4, kernel_size=kernel,
                                    stride=stride, padding=padding,
                                    activation="identity")
    rng = np.random.default_rng(sum(kernel))
    w = rng.standard_normal(kernel + (3, 4)).astype(np.float32)
    x = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    b = np.zeros(4, np.float32)

    def jax_conv(x, w):
        return jconv.conv_apply(lc, {"W": w, "b": b}, {}, x)[0]

    want, vjp = jax.vjp(jax_conv, jnp.asarray(x), jnp.asarray(w))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want_dx, want_dw = vjp(jnp.asarray(cot))
    tlc = tconf.layers.ConvolutionLayerConf(**dataclasses.asdict(lc))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = tconv.im2col_conv(tconv._nchw_padded(tlc, xt), wt, stride)
    got.backward(torch.from_numpy(cot))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    assert _rel(xt.grad.numpy(), want_dx) <= 1e-5
    assert _rel(wt.grad.numpy(), want_dw) <= 1e-5


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("window", [(2, 2), (3, 2), (3, 1)],
                         ids=["k2s2", "k3s2", "k3s1"])
@pytest.mark.parametrize("kind", ["max", "avg", "sum", "none"])
def test_pool_layer_matches(kind, window, padding):
    k, s = window
    lc = jconf.SubsamplingLayerConf(pooling_type=kind, kernel_size=(k, k),
                                    stride=(s, s), padding=padding)
    x = np.random.default_rng(k * 10 + s).standard_normal(
        (2, 7, 6, 3)).astype(np.float32)
    want, _ = jconv.pool_apply(lc, {}, {}, jnp.asarray(x))
    tlc = tconf.layers.SubsamplingLayerConf(**dataclasses.asdict(lc))
    got, _ = tconv.pool_apply(tlc, {}, {}, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("size,k,s", [(7, 3, 2), (8, 3, 2), (9, 5, 2),
                                      (5, 1, 2), (6, 2, 2), (4, 5, 1)])
def test_same_padding_puts_the_odd_row_after(size, k, s):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    assert tconv.same_pads(size, k, s) == (total // 2, total - total // 2)
    assert jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME") == [
        tconv.same_pads(size, k, s)]


# ---- conv nets ---------------------------------------------------------------


def _narrow_alexnet():
    """`alexnet_cifar10(dropout=0.0)` with every width cut (3 -> 8 -> 16 ->
    24 -> 16 -> 16 channels, dense 256 -> 64 -> 32 -> 10), its layout
    unchanged: five SAME 3x3 convs, three 2x2 pools, the NHWC flatten."""
    conf = jzoo.alexnet_cifar10(dropout=0.0)
    widths = iter([(3, 8), (8, 16), (16, 24), (24, 16), (16, 16),
                   (256, 64), (64, 32), (32, 10)])
    layers = tuple(
        lc if isinstance(lc, jconf.SubsamplingLayerConf)
        else dataclasses.replace(lc, **dict(zip(("n_in", "n_out"),
                                                next(widths))))
        for lc in conf.layers)
    return dataclasses.replace(conf, layers=layers)


NETS = {
    "lenet_digits": (lambda: jzoo.lenet_digits(updater="sgd"), (8, 8, 8, 1)),
    "alexnet_narrow": (_narrow_alexnet, (2, 32, 32, 3)),
}


def _batch(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, shape[0])]
    return x, y


def _jax_loss_and_grads(jn, x, y):
    def loss(p):
        return jn._objective(p, jn.state, jnp.asarray(x), jnp.asarray(y),
                             None)[0]
    val, grads = jax.jit(jax.value_and_grad(loss))(jn.params)
    return float(val), grads


@pytest.mark.parametrize("name", sorted(NETS))
def test_conv_net_loss_and_gradients_match(name):
    make, shape = NETS[name]
    jn, tn = pair(make())
    x, y = _batch(shape)
    want_loss, want = _jax_loss_and_grads(jn, x, y)
    loss, _ = tn._objective(tn.params, tn.state, torch.from_numpy(x),
                            torch.from_numpy(y), None)
    got = tn._grads(loss)
    assert _rel(loss.item(), want_loss) <= 1e-5
    for i, (gl, wl) in enumerate(zip(got, want)):
        assert set(gl) == set(wl)
        for k in gl:
            assert tuple(gl[k].shape) == wl[k].shape
            assert _rel(gl[k].numpy(), wl[k]) <= 1e-5, (i, k)


def _with_compute_dtype(conf, dtype: str):
    return dataclasses.replace(conf, conf=dataclasses.replace(
        conf.conf, compute_dtype=dtype))


def _l2(got, want) -> float:
    g = np.concatenate([np.asarray(a, np.float64).ravel() for a in got])
    w = np.concatenate([np.asarray(a, np.float64).ravel() for a in want])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("name", sorted(NETS))
def test_conv_net_bf16_loss_and_gradients_match(name):
    """bfloat16 compute, float32 masters: the port's convolutions in bf16
    (F.conv2d) against XLA's on the same weights and batch."""
    make, shape = NETS[name]
    jn, tn = pair(_with_compute_dtype(make(), "bfloat16"))
    x, y = _batch(shape)
    want_loss, want = _jax_loss_and_grads(jn, x, y)
    loss, _ = tn._objective(tn.params, tn.state, torch.from_numpy(x),
                            torch.from_numpy(y), None)
    got = tn._grads(loss)
    assert _rel(loss.item(), want_loss) <= 1e-6
    keys = [(i, k) for i, wl in enumerate(want) for k in sorted(wl)]
    assert all(got[i][k].dtype == torch.float32 for i, k in keys)
    assert _l2([got[i][k].numpy() for i, k in keys],
               [np.asarray(want[i][k], np.float32) for i, k in keys]) <= 1e-2


@pytest.mark.parametrize("name", sorted(NETS))
def test_conv_net_sgd_steps_match(name):
    make, shape = NETS[name]
    jn, tn = pair(make())
    for step in range(3):
        x, y = _batch(shape, seed=step + 1)
        jl = jn.fit_batch(x, y)
        tl = tn.fit_batch(x, y)
        assert tl == pytest.approx(jl, rel=1e-5)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-5)
    np.testing.assert_allclose(tn.output(x).numpy(),
                               np.asarray(jn.output(x)), atol=1e-5)


def test_flatten_after_a_conv_is_nhwc():
    """The dense weights after `cnn_to_ffn` read the NHWC order: moving
    one input feature of the dense layer changes the same output in both
    packages."""
    jn, tn = pair(jzoo.lenet_digits())
    x, _ = _batch((3, 8, 8, 1), seed=4)
    acts = tn.feed_forward(x)
    assert tuple(acts[4].shape) == (3, 2, 2, 32)        # pool output, NHWC
    want = np.asarray(jn.feed_forward(x)[4])
    np.testing.assert_allclose(acts[4].numpy(), want, atol=1e-5)


# ---- flat order and cross-loading ----------------------------------------------


@pytest.mark.parametrize("name", ["lenet-mnist", "dbn-mnist",
                                  "deep-autoencoder"])
def test_params_flat_order_matches(name):
    """Leaf names, shapes and order as JAX's `init` makes them (traced by
    `jax.eval_shape`), and one vector through both packages."""
    jshapes = jax.eval_shape(
        lambda key: JNet(jzoo.get_model(name)).init(key).params,
        jax.random.PRNGKey(0))
    tn = TNet(tzoo.get_model(name), device="cpu").init()
    assert [(n, tuple(a.shape)) for n, a in tn._param_leaves()] == [
        (f"{i}/{k}", tuple(p[k].shape)) for i, p in enumerate(jshapes)
        for k in sorted(p)]
    jn, _ = pair(jzoo.get_model(name))
    vec = np.random.default_rng(1).standard_normal(
        tn.num_params()).astype(np.float32)
    jn.set_params_flat(vec)
    tn.set_params_flat(vec)
    np.testing.assert_array_equal(tn.params_flat(), jn.params_flat())
    for tl, jl in zip(tn.params, jn.params):
        for k in jl:
            np.testing.assert_array_equal(tl[k].detach().numpy(),
                                          np.asarray(jl[k]))
    if name == "lenet-mnist":
        assert tuple(tn.params[0]["W"].shape) == (5, 5, 1, 6)     # HWIO


@pytest.mark.parametrize("name", ["lenet-mnist", "dbn-mnist"])
def test_saved_models_load_in_either_package(name, tmp_path):
    jn, tn = pair(jzoo.get_model(name))
    shape = (4, 28, 28, 1) if name == "lenet-mnist" else (4, 784)
    x, _ = _batch(shape, seed=9)
    jckpt.save_model(jn, tmp_path / "jax")
    from_jax = tckpt.load_model(tmp_path / "jax", device="cpu")
    np.testing.assert_allclose(from_jax.output(x).numpy(),
                               np.asarray(jn.output(x)), atol=1e-5)
    tn.set_params_flat(tn.params_flat() * 0.5)
    tckpt.save_model(tn, tmp_path / "torch")
    from_torch = jckpt.load_model(tmp_path / "torch")
    np.testing.assert_allclose(np.asarray(from_torch.output(x)),
                               tn.output(x).numpy(), atol=1e-5)
    assert json.loads((tmp_path / "torch" / "conf.json").read_text()) == \
        json.loads(jn.conf.to_json())


def test_training_does_not_write_into_the_callers_vector():
    """`set_params_flat` copies: the port updates its parameters in place,
    and the vector it was given stays as it was."""
    _, tn = pair(jzoo.lenet_digits(updater="sgd"))
    vec = tn.params_flat() + 0.01
    kept = vec.copy()
    tn.set_params_flat(vec)
    tn.fit_batch(*_batch((4, 8, 8, 1)))
    np.testing.assert_array_equal(vec, kept)
    assert not np.array_equal(tn.params_flat(), kept)
