"""PyTorch port: KMeans, the spatial trees, Barnes-Hut t-SNE, the
renderers and the plotting listeners (`clustering/`, `plot/`) against
the JAX package's, on the CPU.

- KMeans started from JAX's own initial indices (threefry's draw, carried
  across): equal assignments and `n_iter`, centres within 1e-5; the
  port's seeded draw recovers the blobs, one host read a sweep;
- the KD-, quad- and SP-trees: query results and forces equal to JAX's
  (the same numpy code);
- Barnes-Hut t-SNE: the affinities and the embedding bitwise JAX's;
- the renderer's grid equal to JAX's (a bfloat16 tensor is read as
  float32), the ``.npy`` fallback without matplotlib, and the listeners
  firing on the port's `MultiLayerNetwork`.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.clustering import kdtree as jkd
from deeplearning4j_tpu.clustering import kmeans as jkm
from deeplearning4j_tpu.clustering import quadtree as jqt
from deeplearning4j_tpu.clustering import sptree as jsp
from deeplearning4j_tpu.plot import barnes_hut_tsne as jbh
from deeplearning4j_tpu.plot import renderers as jren
from deeplearning4j_tpu_torch.clustering import kdtree as tkd
from deeplearning4j_tpu_torch.clustering import kmeans as tkm
from deeplearning4j_tpu_torch.clustering import quadtree as tqt
from deeplearning4j_tpu_torch.clustering import sptree as tsp
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayerConf,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    OutputLayerConf,
)
from deeplearning4j_tpu_torch.plot import barnes_hut_tsne as tbh
from deeplearning4j_tpu_torch.plot import listeners as tlis
from deeplearning4j_tpu_torch.plot import renderers as tren
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


def _blobs(seed=0, n_per=50, k=3, dim=2, spread=0.5, scale=10.0):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-scale, scale, size=(k, dim))
    pts = np.concatenate([rng.normal(c, spread, size=(n_per, dim))
                          for c in centres])
    return pts.astype(np.float32), np.repeat(np.arange(k), n_per)


@pytest.mark.parametrize("seed,k,dim,spread", [(0, 3, 2, 0.5),
                                               (1, 5, 8, 2.0),
                                               (2, 8, 16, 6.0)])
def test_kmeans_from_jax_initial_indices_matches_jax(seed, k, dim, spread):
    pts, _ = _blobs(seed, n_per=40, k=k, dim=dim, spread=spread)
    key = jax.random.PRNGKey(seed)
    centers, assign, n_iter = jkm.kmeans_fit(pts, k, key, max_iter=100)
    idx = np.array(jax.random.choice(key, len(pts), shape=(k,),
                                     replace=False))
    t = torch.from_numpy(pts)
    got_c, got_a, got_n, reads = tkm.kmeans_lloyd(t, t[idx], 100, 1e-4)
    assert got_n == int(n_iter) and reads == got_n
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(assign))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(centers),
                               rtol=1e-5, atol=1e-5)


def test_kmeans_stops_at_max_iter_and_keeps_empty_clusters():
    pts, _ = _blobs(3, n_per=30)
    t = torch.from_numpy(pts)
    far = torch.tensor([[1e4, 1e4]])             # draws no point
    init = torch.cat([t[:2], far])
    centers, assign, n_iter, reads = tkm.kmeans_lloyd(t, init, 2, 0.0)
    assert n_iter == reads == 2
    assert torch.equal(centers[2], far[0]) and int(assign.max()) < 2
    jc, ja, jn = jkm.kmeans_fit(pts, 3, jax.random.PRNGKey(0), max_iter=2,
                                tol=0.0)
    assert int(jn) == 2


def test_kmeans_clustering_on_the_port():
    """JAX's `TestKMeans` data on the port.  Whether a random draw of 3
    points lands in 3 different blobs is luck (about 1 in 4 draws; JAX's
    test holds one threefry draw), so the blobs are recovered from one
    point of each, and the seeded fit is held to a Lloyd fixed point."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(c, 0.5, size=(50, 2)) for c in (
        (0, 0), (10, 10), (-10, 10))]).astype(np.float32)
    labels = np.repeat(np.arange(3), 50)
    t = torch.from_numpy(pts)
    centers, assign, _, _ = tkm.kmeans_lloyd(t, t[[0, 50, 100]])
    np.testing.assert_array_equal(assign.numpy(), labels)
    assert sorted(centers.numpy().round(0).tolist()) == sorted(
        [[0, 0], [10, 10], [-10, 10]])

    km = tkm.KMeansClustering.setup(3, max_iter=50, device="cpu")
    assign = km.fit(pts)
    assert km.centers.shape == (3, 2) and km.host_reads == km.n_iter < 50
    for c in range(3):                      # each centre its points' mean
        np.testing.assert_allclose(km.centers[c], pts[assign == c].mean(0),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(km.predict(pts), assign)
    again = tkm.KMeansClustering(3, max_iter=50, device="cpu")
    np.testing.assert_array_equal(again.fit(pts), assign)   # seeded
    c, a, n = tkm.kmeans_fit(pts, 3, seed=0, device="cpu")
    assert n < 100 and c.shape == (3, 2) and a.shape == (150,)
    with pytest.raises(ValueError, match="fit"):
        tkm.KMeansClustering(2, device="cpu").predict(pts)


def test_pairwise_distances_match_jax():
    pts, _ = _blobs(4, n_per=20, k=3, dim=6)
    cen = pts[[0, 25, 50]]
    want = np.asarray(jkm._pairwise_sq_dists(pts, cen))
    got = tkm._pairwise_sq_dists(torch.from_numpy(pts),
                                 torch.from_numpy(cen)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_kdtree_queries_match_jax():
    pts = np.random.default_rng(0).random((80, 3))
    built = (tkd.KDTree.build(pts), jkd.KDTree.build(pts))
    inc = (tkd.KDTree(3), jkd.KDTree(3))
    for p in pts[:40]:
        for tree in inc:
            tree.insert(p)
    for q in np.random.default_rng(1).random((10, 3)):
        for t, j in (built, inc):
            got, want = t.knn(q, 5), j.knn(q, 5)
            assert ([(d, i) for d, _, i in got]
                    == [(d, i) for d, _, i in want])
            assert t.nn(q)[::2] == j.nn(q)[::2]
        lo, hi = q - 0.3, q + 0.3
        assert ([i for _, i in built[0].range(lo, hi)]
                == [i for _, i in built[1].range(lo, hi)])
    assert len(built[0]) == 80 and tkd.KDTree(2).nn([0, 0])[2] == -1
    with pytest.raises(ValueError):
        inc[0].insert([1.0, 2.0])


def test_quadtree_matches_jax():
    pts = np.random.default_rng(3).random((60, 2)) * 4
    pts[7] = pts[3]                                  # a duplicate
    t, j = tqt.QuadTree(pts), jqt.QuadTree(pts)
    assert len(t) == len(j) == 60
    np.testing.assert_array_equal(t.cum_center, j.cum_center)
    for i in (0, 3, 7, 59):
        for theta in (0.0, 0.5):
            got = t.compute_non_edge_forces(i, pts[i], theta)
            want = j.compute_non_edge_forces(i, pts[i], theta)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
    assert not tqt.QuadTree(pts).insert([99.0, 99.0])


def test_sptree_matches_jax():
    rng = np.random.default_rng(5)
    for d in (2, 3):
        pts = rng.random((70, d)) * 3
        t, j = tsp.SpTree(pts), jsp.SpTree(pts)
        np.testing.assert_array_equal(t.cum_center, j.cum_center)
        for i in (0, 13, 69):
            for theta in (0.0, 0.5):
                got = t.compute_non_edge_forces(i, theta)
                want = j.compute_non_edge_forces(i, theta)
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1]
    pts = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    row_p, col_p = np.asarray([0, 2, 3, 4]), np.asarray([1, 2, 0, 0])
    val_p = np.asarray([0.5, 0.5, 0.5, 0.5])
    np.testing.assert_array_equal(
        tsp.SpTree(pts).compute_edge_forces(row_p, col_p, val_p),
        jsp.SpTree(pts).compute_edge_forces(row_p, col_p, val_p))


def test_barnes_hut_tsne_is_bitwise_jax():
    x, _ = _blobs(0, n_per=20, k=3, dim=10, spread=0.3, scale=8.0)
    for a, b in zip(tbh._knn_affinities(x.astype(np.float64), 5.0, 15),
                    jbh._knn_affinities(x.astype(np.float64), 5.0, 15)):
        np.testing.assert_array_equal(a, b)
    kw = dict(perplexity=5.0, n_iter=60, stop_lying_iter=20, theta=0.5,
              seed=3)
    got = tbh.BarnesHutTsne(**kw).fit_transform(x)
    want = jbh.BarnesHutTsne(**kw).fit_transform(x)
    assert got.shape == (60, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,tile", [((16, 9), None), ((10, 7), (2, 5)),
                                        ((3, 3, 2, 5), None)])
def test_filter_grid_matches_jax(tmp_path, shape, tile):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jren._tile_filters(w, tile)
    np.testing.assert_array_equal(tren._tile_filters(w, tile), want)
    bf = torch.from_numpy(w).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tren.FilterRenderer().render(bf, str(tmp_path / "f.png"), tile),
        jren._tile_filters(bf.float().numpy(), tile))
    assert any(f.startswith("f.") for f in os.listdir(tmp_path))


def test_renderer_writes_npy_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import fails
    w = torch.randn(9, 4, dtype=torch.bfloat16)
    grid = tren.FilterRenderer().render(w, str(tmp_path / "g.png"))
    np.testing.assert_array_equal(np.load(tmp_path / "g.npy"), grid)
    assert tren.NeuralNetPlotter().plot_network_gradient(
        [{"W": w}], [{"W": w * 0.1}], str(tmp_path / "h")) == []


def test_neural_net_plotter_reads_tensors(tmp_path):
    params = [{"W": torch.randn(4, 3), "b": torch.zeros(3)}]
    grads = [{"W": torch.randn(4, 3, dtype=torch.bfloat16),
              "b": torch.zeros(3)}]
    flat = tren.NeuralNetPlotter._flatten({"layers": params})
    assert sorted(flat) == ["layers/0/W", "layers/0/b"]
    assert all(v.dtype == np.float32 for v in flat.values())
    for p in tren.NeuralNetPlotter().plot_network_gradient(
            params, grads, str(tmp_path)):
        assert os.path.exists(p)
    tren.NeuralNetPlotter().plot_activations(torch.rand(5, 4),
                                             str(tmp_path / "a.png"))


def test_listeners_fire_on_the_port_network(tmp_path):
    conf = MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=0.1),
        layers=(DenseLayerConf(n_in=4, n_out=8),
                OutputLayerConf(n_in=8, n_out=3)))
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.random((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    filters = tlis.PlotFiltersIterationListener(net, str(tmp_path / "f"),
                                                every=1)
    acts = tlis.ActivationRenderListener(net, x[:6], str(tmp_path / "a"),
                                         every=2)
    net.add_listener(filters)
    net.add_listener(acts)
    net.fit_batch(x, y)
    net.fit_batch(x, y)
    assert sorted(os.listdir(tmp_path / "f"))[:2] == [
        "filters_000001.png", "filters_000002.png"]
    assert os.listdir(tmp_path / "a") == ["activations_000002.png"]
    want = jren._tile_filters(net.params[0]["W"].detach().numpy())
    np.testing.assert_array_equal(
        tren._tile_filters(filters._first_weight()), want)
    named = tlis.PlotFiltersIterationListener(net, str(tmp_path / "n"),
                                              param_path=(1, "W"))
    assert named._first_weight() is net.params[1]["W"]
