"""PyTorch port: exact t-SNE (`plot/tsne.py`) against the JAX package's,
on the CPU.  `jax.random` draws cannot be matched bit for bit, so:

- `gaussian_perplexity` against JAX's on the same inputs.  Each row's
  bisection stops anywhere its entropy is within ``tol`` (1e-5) of
  log(perplexity), so two float32 searches can stop one halving apart;
  P is held to JAX's within the bound that band allows (the entropy's
  slope in beta, ``-beta Var_p(d2)``, linearized, plus the measured
  difference of the two packages' squared distances), and within 1e-5
  relative where the two searches stop together (the same rows' beta);
- one gradient step from the same layout (JAX's own draw) and the same
  P (JAX's) within 1e-5 of JAX's one-iteration fit;
- a whole fit judged by its own merits: KL(P || Q) falls from the
  initial layout, and the 5 nearest neighbours of each point are kept at
  least as well as JAX's fit keeps them, minus 0.05;
- the ``/tsne/upload`` -> ``/tsne/generate`` -> ``/tsne/coords`` round
  trip of the front.
"""

import json
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.plot import tsne as jtsne
from deeplearning4j_tpu_torch.plot import tsne as ttsne
from deeplearning4j_tpu_torch.ui.server import UiServer
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


def _blobs(n_per=20, d=10, k=3, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, d)) * 6.0
    x = np.concatenate([c + rng.standard_normal((n_per, d)) for c in centres])
    return x.astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _knn_kept(x, y, k=5):
    """Mean share of each point's k nearest neighbours in x that are
    among its k nearest in y."""
    def knn(a):
        d = ((a[:, None, :] - a[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        return np.argsort(d, axis=1)[:, :k]
    hx, hy = knn(np.asarray(x, np.float64)), knn(np.asarray(y, np.float64))
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(hx, hy)]))


def _search_band_bound(d2, rows, beta, d2_other, tol=1e-5):
    """|Δp_ij| allowed between two searches whose entropies both lie
    within `tol` of the target (plus 1e-6 of float32 rounding of h), and
    whose squared distances differ by |d2 - d2_other|: p_ij |d2_ij - μ_i|
    |Δβ_i| with |Δβ_i| <= band / (β_i Var_i(d2)), and p_ij β_i (|Δd2_ij| +
    max_j |Δd2_ij|), plus 1e-6 of the row's largest entry."""
    d2, p = np.asarray(d2, np.float64), np.asarray(rows, np.float64)
    beta = np.asarray(beta, np.float64)[:, None]
    mu = (p * d2).sum(1, keepdims=True)
    var = (p * (d2 - mu) ** 2).sum(1, keepdims=True)
    dd2 = np.abs(d2 - np.asarray(d2_other, np.float64))
    band = 2 * tol + 1e-6
    return (p * np.abs(d2 - mu) * band / (beta * var)
            + p * beta * (dd2 + dd2.max(1, keepdims=True))
            + 1e-6 * p.max(1, keepdims=True))


@pytest.mark.parametrize("seed,perplexity", [(0, 5.0), (0, 15.0),
                                             (1, 10.0)])
def test_gaussian_perplexity_matches_jax(seed, perplexity):
    import torch

    x = _blobs(seed=seed)
    n = x.shape[0]
    want = np.asarray(jtsne.gaussian_perplexity(jnp.asarray(x), perplexity))
    got = ttsne.gaussian_perplexity(x, perplexity, device="cpu").numpy()
    assert got.shape == want.shape == (n, n)
    assert got.sum() == pytest.approx(1.0, rel=1e-5)
    d2j = np.asarray(jtsne._sq_dists(jnp.asarray(x)))
    d2t = ttsne._sq_dists(torch.tensor(x))
    assert _rel(d2t.numpy(), d2j) <= 1e-6
    rows, beta = ttsne.row_search(d2t, perplexity)
    bound = _search_band_bound(d2t.numpy(), rows.numpy(), beta.numpy(), d2j)
    p_bound = (bound + bound.T) / (2 * n) + 1e-6 * np.abs(want).max()
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= p_bound).all(), float((err / p_bound).max())
    # the rows whose searches stop together (JAX's rows from the port's
    # beta are JAX's rows) agree to float32 rounding
    jrows = np.asarray(jax.vmap(
        lambda r, i: jtsne._row_affinities(r, i, perplexity))(
            jnp.asarray(d2j), jnp.arange(n)))
    same = [i for i in range(n) if np.allclose(
        rows.numpy()[i], jrows[i], rtol=0, atol=1e-5 * jrows[i].max())]
    assert len(same) >= n // 2


@pytest.mark.parametrize("it,lr", [(0, 200.0), (300, 100.0)])
def test_one_step_from_the_same_layout_matches_jax(it, lr):
    """JAX's one-iteration fit against the port's `tsne_step` from the
    same y0 (the JAX key's draw) and the same P (JAX's), at an
    exaggerated early iteration and a late one (momentum and gains from
    dy = 0, gains = 1)."""
    import torch

    x = _blobs(seed=1)
    knobs = dict(learning_rate=lr)
    if it:     # past the early exaggeration and the momentum switch
        knobs.update(stop_lying_iter=0, switch_momentum_iter=0)
    want = np.asarray(jtsne.tsne_fit(jnp.asarray(x), jax.random.PRNGKey(3),
                                     n_iter=1, perplexity=10.0, **knobs))
    y0 = torch.tensor(np.asarray(1e-4 * jax.random.normal(
        jax.random.PRNGKey(3), (60, 2), jnp.float32)))
    p = torch.tensor(np.asarray(jtsne.gaussian_perplexity(jnp.asarray(x),
                                                          10.0)))
    y, dy, gains = ttsne.tsne_step(y0, torch.zeros_like(y0),
                                   torch.ones_like(y0), p, 0, **knobs)
    assert torch.equal(gains, torch.full_like(gains, 1.2))
    # the float64 step from the same inputs, and the float32 error bound
    # of its product: grad_i = 4 (sum_j pq_ij y_i - sum_j pq_ij y_j)
    # cancels, so each package may miss it by lr * gain * 4 * gamma_2n *
    # (sum_j |pq_ij| |y_i| + sum_j |pq_ij| |y_j|); the centring's mean
    # adds gamma_n * mean_j |y_j|; and 4 ulp of y
    y64, _, _ = ttsne.tsne_step(y0.double(), torch.zeros_like(y0).double(),
                                torch.ones_like(y0).double(), p.double(), 0,
                                **knobs)
    y64 = y64.numpy()
    d2 = ttsne._sq_dists(y0.double())
    num = (1.0 / (1.0 + d2)) * (1.0 - torch.eye(60, dtype=torch.float64))
    q = num / num.sum()
    exaggeration = 1.0 if it else 4.0        # stop_lying_iter=0 when late
    pq = ((p.double() * exaggeration - q) * num).abs().numpy()
    ya = np.abs(y0.double().numpy())
    u = 2.0 ** -24
    gamma = 2 * 60 * u / (1 - 2 * 60 * u)
    bound = (lr * 1.2 * 4 * gamma * (pq.sum(1, keepdims=True) * ya
                                      + pq @ ya)
             + gamma * np.abs(y64).mean(0, keepdims=True)
             + 4 * np.spacing(np.abs(y64).astype(np.float32)))
    for name, got in (("port", y.numpy()), ("jax", want)):
        err = np.abs(got.astype(np.float64) - y64)
        assert (err <= bound).all(), (name, float((err / bound).max()))
    assert _rel(y.numpy(), want) <= 2e-5 and _rel(y.numpy(), y64) <= 1e-5


def test_a_whole_fit_lowers_kl_and_keeps_neighbours_like_jax():
    x = _blobs(n_per=25, seed=2)
    knobs = dict(perplexity=10.0, learning_rate=100.0, n_iter=300)
    jy = np.asarray(jtsne.tsne_fit(jnp.asarray(x), jax.random.PRNGKey(0),
                                   **knobs))
    ty = ttsne.tsne_fit(x, seed=0, device="cpu", **knobs)
    p = ttsne.gaussian_perplexity(x, 10.0, device="cpu")
    import torch

    y0 = 1e-4 * torch.randn((75, 2), generator=torch.Generator().manual_seed(
        0))
    kl0, kl = ttsne.kl_divergence(p, y0), ttsne.kl_divergence(p, ty)
    assert np.isfinite(ty.numpy()).all() and kl < 0.5 * kl0
    assert _knn_kept(x, ty.numpy()) >= _knn_kept(x, jy) - 0.05
    assert ttsne.kl_divergence(p, torch.tensor(jy)) < 0.5 * kl0


def test_tsne_endpoints_round_trip():
    x = _blobs(n_per=8, d=5)
    ui = UiServer(port=0, device="cpu").start()
    try:
        def post(path, body):
            req = urllib.request.Request(
                ui.url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        labels = [f"p{i}" for i in range(24)]
        assert post("/tsne/upload", {"vectors": x.tolist(),
                                     "labels": labels}) == {"count": 24}
        out = post("/tsne/generate", {"perplexity": 5, "iterations": 50})
        assert out["labels"] == labels and np.asarray(out["coords"]).shape \
            == (24, 2)
        with urllib.request.urlopen(ui.url + "/tsne/coords") as r:
            assert json.loads(r.read()) == out
    finally:
        ui.stop()


def test_entry_point_runs_on_the_card_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttsne.Tsne()
