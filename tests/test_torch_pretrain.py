"""PyTorch port, slice 8: the RBM and autoencoder layers and greedy
layer-wise pretraining against the JAX package.

The deterministic parts match within 1e-6 on the same float32 numpy
inputs and weights: `rbm_apply`, `rbm_pretrain_loss`, the CD statistics
computed from the JAX chain's own means, and the denoising loss and its
gradient at corruption 0.  torch's Philox never reproduces JAX's
threefry bits, so the stochastic parts are compared by statistics: the
mean CD gradient over 4096 chains within 5 standard errors of the JAX
package's, and the corruption keep-rate within 5 standard errors of
``1 - corruption_level``.  Greedy pretraining of a small DBN and a small
deep autoencoder lowers each layer's reconstruction error in both
packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.layers import pretrain as jpre
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.layers import pretrain as tpre
from test_torch_conv import pair
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

UNITS = [("binary", "binary"), ("gaussian", "binary"),
         ("binary", "rectified"), ("softmax", "binary"),
         ("binary", "gaussian")]


def _rbm(visible="binary", hidden="binary", n_in=6, n_out=4, k=1):
    jc = jconf.RBMConf(n_in=n_in, n_out=n_out, visible_unit=visible,
                       hidden_unit=hidden, k=k)
    tc = tconf.layers.RBMConf(**dataclasses.asdict(jc))
    rng = np.random.default_rng(n_in * 7 + n_out)
    params = {"W": (rng.standard_normal((n_in, n_out)) * 0.5).astype(
                  np.float32),
              "b": (rng.standard_normal(n_out) * 0.1).astype(np.float32),
              "vb": (rng.standard_normal(n_in) * 0.1).astype(np.float32)}
    return jc, tc, params


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _data(n, n_in, seed=0, binary=True):
    rng = np.random.default_rng(seed)
    protos = rng.random((4, n_in)) < 0.5
    x = protos[rng.integers(0, 4, n)] ^ (rng.random((n, n_in)) < 0.1)
    return x.astype(np.float32) if binary else rng.random(
        (n, n_in), dtype=np.float32)


def _jax_chain(conf, params, v0, rng):
    """The JAX package's `rbm_cd_grads` chain, step for step with its keys,
    returning its means (h0, vk, hk)."""
    return jax.jit(lambda p, v, r: _chain(conf, p, v, r))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(v0), rng)


def _chain(conf, p, v0, rng):
    hz = v0 @ p["W"] + p["b"]
    h0_mean = jpre._unit_mean(conf.hidden_unit, hz)
    k_h0, k_chain = jax.random.split(rng)
    h = jpre._unit_sample(conf.hidden_unit, h0_mean, hz, k_h0)
    for key in jax.random.split(k_chain, conf.k):
        kv, kh = jax.random.split(key)
        vz = h @ p["W"].T + p["vb"]
        v_mean = jpre._unit_mean(conf.visible_unit, vz)
        v = jpre._unit_sample(conf.visible_unit, v_mean, vz, kv)
        hz = v @ p["W"] + p["b"]
        h_mean = jpre._unit_mean(conf.hidden_unit, hz)
        h = jpre._unit_sample(conf.hidden_unit, h_mean, hz, kh)
    return h0_mean, v_mean, h_mean


@pytest.mark.parametrize("visible,hidden", UNITS)
def test_rbm_apply_and_pretrain_loss_match(visible, hidden):
    jc, tc, params = _rbm(visible, hidden)
    x = _data(5, 6, binary=visible != "gaussian")
    want, _ = jpre.rbm_apply(jc, params, {}, jnp.asarray(x))
    got, _ = tpre.rbm_apply(tc, _t(params), {}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = float(jpre.rbm_pretrain_loss(jc, params, jnp.asarray(x), None))
    got = float(tpre.rbm_pretrain_loss(tc, _t(params), torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("k", [2])
@pytest.mark.parametrize("visible,hidden", UNITS[:3])
def test_cd_statistics_of_the_jax_chain_match(visible, hidden, k):
    jc, tc, params = _rbm(visible, hidden, k=k)
    v0 = _data(8, 6, seed=k)
    rng = jax.random.PRNGKey(11)
    want, want_err = jax.jit(lambda p, v, r: jpre.rbm_cd_grads(
        jc, p, v, r))(params, jnp.asarray(v0), rng)
    means = _jax_chain(jc, params, v0, rng)
    got, err = tpre.cd_statistics(torch.from_numpy(v0),
                                  *(torch.from_numpy(np.array(m))
                                    for m in means))
    for name in ("W", "b", "vb"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-6)
    assert float(err) == pytest.approx(float(want_err), rel=1e-6, abs=1e-6)


def _per_chain(v0, h0, vk, hk):
    """Each chain's contribution to the CD gradient: rows of [W | b | vb]."""
    w = -(v0[:, :, None] * h0[:, None, :] - vk[:, :, None] * hk[:, None, :])
    return np.concatenate([w.reshape(len(v0), -1), -(h0 - hk), -(v0 - vk)],
                          axis=1)


@pytest.mark.parametrize("visible,hidden", UNITS)
def test_mean_cd_gradient_over_4096_chains_matches_jax(visible, hidden):
    n = 4096
    jc, tc, params = _rbm(visible, hidden)
    v0 = _data(n, 6, seed=3)
    jm = [np.asarray(m) for m in _jax_chain(jc, params, v0,
                                            jax.random.PRNGKey(5))]
    gen = torch.Generator().manual_seed(5)
    tm = [m.numpy() for m in tpre.rbm_gibbs_chain(
        tc, _t(params), torch.from_numpy(v0), gen)]
    jrows, trows = _per_chain(v0, *jm), _per_chain(v0, *tm)
    sigma = np.sqrt(jrows.var(0) / n + trows.var(0) / n)
    diff = np.abs(jrows.mean(0) - trows.mean(0))
    assert np.all(diff <= 5 * sigma + 1e-6), (diff / (sigma + 1e-12)).max()
    # the estimator itself: the port's mean is its `rbm_cd_grads`
    grads, _ = tpre.rbm_cd_grads(tc, _t(params), torch.from_numpy(v0),
                                 torch.Generator().manual_seed(5))
    np.testing.assert_allclose(grads["W"].numpy().reshape(-1),
                               trows.mean(0)[:24], atol=1e-5)


def _ae(corruption=0.0, n_in=7, n_out=5):
    jc = jconf.AutoEncoderConf(n_in=n_in, n_out=n_out,
                               corruption_level=corruption)
    tc = tconf.layers.AutoEncoderConf(**dataclasses.asdict(jc))
    rng = np.random.default_rng(2)
    params = {"W": (rng.standard_normal((n_in, n_out)) * 0.5).astype(
                  np.float32),
              "b": (rng.standard_normal(n_out) * 0.1).astype(np.float32),
              "vb": (rng.standard_normal(n_in) * 0.1).astype(np.float32)}
    return jc, tc, params


def test_ae_pretrain_loss_and_gradient_match_at_corruption_0():
    jc, tc, params = _ae()
    x = _data(6, 7, binary=False)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda p: jpre.ae_pretrain_loss(jc, p, jnp.asarray(x),
                                        jax.random.PRNGKey(0))))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: v.requires_grad_() for k, v in _t(params).items()}
    loss = tpre.ae_pretrain_loss(tc, tp, torch.from_numpy(x), None)
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert loss.item() == pytest.approx(float(want), rel=1e-6)
    for k, g in zip(tp, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wgrads[k]),
                                   atol=1e-6)
    out, _ = tpre.ae_apply(tc, _t(params), {}, torch.from_numpy(x))
    want, _ = jpre.ae_apply(jc, params, {}, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)
    h = torch.from_numpy(np.asarray(want))
    np.testing.assert_allclose(
        tpre.ae_reconstruct(tc, _t(params), h).numpy(),
        np.asarray(jpre.ae_reconstruct(jc, params, jnp.asarray(want))),
        atol=1e-6)


def test_corruption_keeps_one_minus_the_level():
    level, n = 0.3, 200_000
    x = torch.rand(n, generator=torch.Generator().manual_seed(1)) + 1.0
    out = tpre.corrupt(x, level, torch.Generator().manual_seed(2))
    kept = out != 0
    assert torch.equal(out[kept], x[kept])
    rate, sd = kept.float().mean().item(), np.sqrt(level * (1 - level) / n)
    assert abs(rate - (1 - level)) <= 5 * sd
    # the denoising loss corrupts through it
    jc, tc, params = _ae(corruption=level)
    xb = torch.from_numpy(_data(6, 7, binary=False))
    got = tpre.ae_pretrain_loss(tc, _t(params), xb,
                                torch.Generator().manual_seed(3))
    p = _t(params)
    c = tpre.corrupt(xb, level, torch.Generator().manual_seed(3))
    h = torch.sigmoid(c @ p["W"] + p["b"])
    recon = torch.sigmoid(h @ p["W"].T + p["vb"])
    want = -torch.mean(torch.sum(
        xb * torch.log(recon.clamp(1e-7, 1 - 1e-7))
        + (1 - xb) * torch.log(1 - recon.clamp(1e-7, 1 - 1e-7)), dim=-1))
    assert got.item() == pytest.approx(want.item(), rel=1e-6)


# ---- greedy layer-wise pretraining --------------------------------------------


def _layer_errors_jax(jn, x):
    errs = []
    for i, lc in enumerate(jn.conf.layers):
        if isinstance(lc, jconf.RBMConf):
            h, _ = jn._forward(jn.params, jn.state, jnp.asarray(x),
                               train=False, upto=i)
            errs.append(float(jpre.rbm_pretrain_loss(lc, jn.params[i], h,
                                                     None)))
        elif isinstance(lc, jconf.AutoEncoderConf):   # uncorrupted
            h, _ = jn._forward(jn.params, jn.state, jnp.asarray(x),
                               train=False, upto=i)
            errs.append(float(jpre.ae_pretrain_loss(
                dataclasses.replace(lc, corruption_level=0.0),
                jn.params[i], h, None)))
    return errs


def _layer_errors_torch(tn, x):
    errs = []
    with torch.no_grad():
        for i, lc in enumerate(tn.conf.layers):
            if isinstance(lc, (tconf.layers.RBMConf,
                               tconf.layers.AutoEncoderConf)):
                h, _ = tn._forward(tn.params, tn.state, torch.from_numpy(x),
                                   train=False, upto=i)
                if isinstance(lc, tconf.layers.RBMConf):
                    err = tpre.rbm_pretrain_loss(lc, tn.params[i], h)
                else:                                  # uncorrupted
                    err = tpre.ae_pretrain_loss(dataclasses.replace(
                        lc, corruption_level=0.0), tn.params[i], h, None)
                errs.append(err.item())
    return errs


PRETRAIN_NETS = {
    "dbn": (lambda: jzoo.dbn_mnist(layer_sizes=(16, 12, 8), n_out=3,
                                   learning_rate=0.1), True),
    "deep_ae": (lambda: jzoo.deep_autoencoder(layer_sizes=(16, 12, 8),
                                              learning_rate=0.01,
                                              corruption_level=0.2), False),
}


@pytest.mark.parametrize("name", sorted(PRETRAIN_NETS))
def test_greedy_pretraining_lowers_each_layers_error_in_both(name):
    """The DBN in both packages; the deep autoencoder (whose AE step the
    gradient test above holds to JAX) in the port only."""
    make, binary = PRETRAIN_NETS[name]
    jn, tn = pair(make())
    x = _data(64, 16, seed=4, binary=binary)
    y = np.eye(3, dtype=np.float32)[np.arange(64) % 3]
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    t0 = _layer_errors_torch(tn, x)
    tn.pretrain(batches, epochs=8)
    t1 = _layer_errors_torch(tn, x)
    assert all(b < a for a, b in zip(t0, t1)), (t0, t1)
    if name == "dbn":
        j0 = _layer_errors_jax(jn, x)
        np.testing.assert_allclose(t0, j0, rtol=1e-5)    # same weights
        jn.pretrain(batches, epochs=8)
        j1 = _layer_errors_jax(jn, x)
        assert all(b < a for a, b in zip(j0, j1)), (j0, j1)
    assert sorted(tn.pretrain_errors) == [0, 1]
    for errs in tn.pretrain_errors.values():
        assert len(errs) == 8 * len(batches)
        assert np.mean(errs[-4:]) < np.mean(errs[:4])


def test_pretrain_skips_frozen_layers_and_fit_runs_it_first():
    conf = jzoo.dbn_mnist(layer_sizes=(16, 12, 8), n_out=3)
    conf = dataclasses.replace(conf, layers=(dataclasses.replace(
        conf.layers[0], lr_multiplier=0.0),) + conf.layers[1:])
    _, tn = pair(conf)
    before = [{k: v.detach().clone() for k, v in p.items()}
              for p in tn.params]
    x = _data(32, 16, seed=6)
    y = np.eye(3, dtype=np.float32)[np.arange(32) % 3]
    tn.fit((x, y))                                   # pretrain, then SGD
    assert sorted(tn.pretrain_errors) == [1]
    assert all(torch.equal(before[0][k], tn.params[0][k])
               for k in before[0])                   # frozen: no update
    assert not torch.equal(before[1]["W"], tn.params[1]["W"])
    assert not torch.equal(before[2]["W"], tn.params[2]["W"])
