"""PyTorch port, slice 16: the runtime tail against the JAX package on the
CPU — determinism checks, remote storage, the profiler's rest, and
registered losses (ROADMAP C2).

- Determinism: a seeded MLP trains bitwise in both packages; an injected
  perturbation of one bfloat16 leaf is caught and named, including a
  ``+0 -> -0`` flip that a compare of values rounded through float
  misses (the port compares raw 16-bit words).
- Storage: ``memory://``, ``file://`` and fsspec ``memory`` round trips
  of a checkpoint, bitwise; COMMIT uploaded last; a ``file://``
  checkpoint of the port loads in JAX and back; remote models and CSVs.
- Profiler: `trace` writes a Chrome trace holding an `annotate` span;
  `StepTimer` equals JAX's on the same listener calls (one fake clock);
  `device_memory_stats` keys.
- Losses: a custom loss registered in both packages gives the same
  `score`, `fit_batch` trajectory and chunked `fit` (1e-5, float32), on
  a feed-forward net and on a masked sequence net (per-row evaluation).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.runtime import determinism as jdet
from deeplearning4j_tpu.runtime import profiler as jprof
from deeplearning4j_tpu.runtime import storage as jstore
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.ops import losses as tlosses
from deeplearning4j_tpu_torch.runtime import determinism as tdet
from deeplearning4j_tpu_torch.runtime import profiler as tprof
from deeplearning4j_tpu_torch.runtime import storage as tstore
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

TOL = 1e-5                      # float32 trajectories across the packages


def _mlp_json(loss="mcxent", activation="softmax", seed=11, updater="adam"):
    conf = jconf.MultiLayerConfiguration(
        conf=jconf.NeuralNetConfiguration(learning_rate=0.05,
                                          updater=updater, seed=seed),
        layers=(jconf.DenseLayerConf(n_in=4, n_out=6, activation="tanh"),
                jconf.OutputLayerConf(n_in=6, n_out=3, loss=loss,
                                      activation=activation)))
    return conf.to_json()


def _pair(conf_json):
    jn = JNet(jconf.MultiLayerConfiguration.from_json(conf_json)).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(conf_json),
              device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


# ---------------------------------------------------------------------------
# determinism


def test_seeded_network_is_deterministic_in_both_packages():
    conf_json = _mlp_json()
    x, y = _data()
    jdet.check_network_determinism(
        jconf.MultiLayerConfiguration.from_json(conf_json), x, y)
    tdet.check_network_determinism(
        tconf.MultiLayerConfiguration.from_json(conf_json), x, y,
        device="cpu")


def _bf16_state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(4, 5, generator=g).bfloat16(),
            "b": torch.zeros(5, dtype=torch.bfloat16),
            "layers": [torch.randn(3, generator=g)]}


def _step_that_perturbs(change):
    """A step that applies `change` to its state on the second run only."""
    runs = {"n": 0}

    def make_state():
        runs["n"] += 1
        return _bf16_state()

    def step(s):
        s = {k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])
             for k, v in s.items()}
        s["w"] = (s["w"].float() * 0.5).bfloat16()
        if runs["n"] == 2:
            change(s)
        return s

    return make_state, step


def _flip_one_ulp(s):
    w = s["w"].view(torch.int16)
    w[1, 2] += 1


def _negate_a_zero(s):
    s["b"][3] = -0.0


@pytest.mark.parametrize("change,diff", [(_flip_one_ulp, None),
                                         (_negate_a_zero, 0.0)])
def test_checker_catches_a_perturbed_bf16_leaf(change, diff):
    make_state, step = _step_that_perturbs(change)
    with pytest.raises(tdet.NondeterminismError) as err:
        tdet.check_step_determinism(make_state, step, steps=1)
    leaf = "/b" if change is _negate_a_zero else "/w"
    assert err.value.leaf == leaf and f"({leaf})" in str(err.value)
    if diff is None:
        assert err.value.max_abs_diff > 0
    else:
        # -0 equals +0 once rounded through float: only the words differ
        assert err.value.max_abs_diff == diff
        a, b = _bf16_state()["b"], _bf16_state()["b"].clone()
        b[3] = -0.0
        assert torch.equal(a.float(), b.float())
    # with a tolerance the words are not compared: the ulp is caught by
    # value, the sign of zero is not a difference
    make_state, step = _step_that_perturbs(change)
    if diff is None:
        with pytest.raises(tdet.NondeterminismError):
            tdet.check_step_determinism(make_state, step, steps=1,
                                        atol=1e-6)
    else:
        tdet.check_step_determinism(make_state, step, steps=1, atol=1e-6)


def test_leaf_order_and_structure_checks_match_jax():
    tree = {"b": np.ones(2, np.float32), "a": [np.zeros(3, np.float32)]}
    paths = [p for p, _ in tdet._leaves(tree)]
    assert paths == ["/a/0", "/b"]
    assert len(paths) == len(jax.tree_util.tree_leaves(tree))
    shapes = iter([np.zeros(2), np.zeros(3)])
    with pytest.raises(tdet.NondeterminismError, match="shape"):
        tdet.check_step_determinism(lambda: next(shapes), lambda s: s,
                                    steps=1)


# ---------------------------------------------------------------------------
# storage


@pytest.fixture(autouse=True)
def _fresh_buckets():
    tstore.MemoryStore.reset()
    jstore.MemoryStore.reset()
    yield
    tstore.MemoryStore.reset()
    jstore.MemoryStore.reset()


def _trained_pair():
    jn, tn = _pair(_mlp_json())
    x, y = _data()
    jn.fit_batch(x, y)
    tn.fit_batch(x, y)
    return jn, tn


def _assert_tree_equal(got, want):
    ga = [t.detach().numpy() for t in _torch_leaves(got)]
    wa = [t.detach().numpy() for t in _torch_leaves(want)]
    assert len(ga) == len(wa)
    for a, b in zip(ga, wa):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _torch_leaves(tree):
    return [leaf for _, leaf in tdet._leaves(tree)]


@pytest.mark.parametrize("scheme", ["memory", "file", "fsspec"])
def test_remote_checkpoint_round_trips_bitwise(scheme, tmp_path,
                                                monkeypatch):
    if scheme == "fsspec":
        url = _fsspec_memory_url()
    elif scheme == "memory":
        url = "memory://ckpts/run42"
    else:
        url = f"file://{tmp_path}/ck"
    _, tn = _trained_pair()
    writes = []
    real_get_store = tstore.get_store

    def recording_get_store(u):
        store, base = real_get_store(u)
        write = store.write_bytes

        def logged(path, data):
            writes.append(path)
            write(path, data)
        store.write_bytes = logged
        return store, base

    monkeypatch.setattr(tstore, "get_store", recording_get_store)
    out = tstore.save_checkpoint_remote(url, 7, tn.params,
                                        updater_state=tn.updater_state,
                                        extra={"note": "r2"})
    assert out == url + "/ckpt-7"
    assert writes[-1].endswith("ckpt-7/COMMIT") and sum(
        w.endswith("COMMIT") for w in writes) == 1
    tstore.save_checkpoint_remote(url, 9, tn.params)
    assert tstore.latest_checkpoint_remote(url) == 9
    step, params, upd, extra = tstore.load_checkpoint_remote(
        url, tn.params, updater_like=tn.updater_state, step=7)
    assert step == 7 and extra == {"note": "r2"}
    _assert_tree_equal(params, tn.params)
    _assert_tree_equal(upd, tn.updater_state)


def _fsspec_memory_url() -> str:
    """A URL of a scheme only fsspec knows: its in-memory filesystem
    registered as ``dl4jmem://``, standing in for gs:// or s3://."""
    fsspec = pytest.importorskip("fsspec")
    from fsspec.implementations.memory import MemoryFileSystem

    class Dl4jMem(MemoryFileSystem):
        protocol = ("dl4jmem",)
        store = {}
        pseudo_dirs = [""]

    fsspec.register_implementation("dl4jmem", Dl4jMem, clobber=True)
    return "dl4jmem://ckpts/run"


def test_store_dispatch_and_unknown_scheme(tmp_path):
    s, p = tstore.get_store("memory://bkt/a/b")
    assert isinstance(s, tstore.MemoryStore) and p == "a/b"
    s, p = tstore.get_store(f"file://{tmp_path}/x")
    assert isinstance(s, tstore.LocalStore) and p == f"{tmp_path}/x"
    assert isinstance(tstore.get_store(str(tmp_path))[0], tstore.LocalStore)
    with pytest.raises(RuntimeError, match="zz"):
        tstore.get_store("zz://bucket/path")
    with pytest.raises(FileNotFoundError):
        tstore.load_checkpoint_remote("memory://empty/run", {})


def test_file_checkpoints_cross_the_packages(tmp_path):
    jn, tn = _trained_pair()
    url = f"file://{tmp_path}/ck"
    tstore.save_checkpoint_remote(url, 3, tn.params,
                                  updater_state=tn.updater_state)
    step, jparams, _, _ = jstore.load_checkpoint_remote(url, jn.params)
    assert step == 3
    for jl, tl in zip(jparams, tn.params):
        for k in jl:
            np.testing.assert_array_equal(np.asarray(jl[k]),
                                          tl[k].detach().numpy())
    url2 = f"file://{tmp_path}/ck2"
    jstore.save_checkpoint_remote(url2, 5, jn.params)
    step, tparams, _, _ = tstore.load_checkpoint_remote(url2, tn.params)
    assert step == 5
    for jl, tl in zip(jn.params, tparams):
        for k in jl:
            np.testing.assert_array_equal(np.asarray(jl[k]),
                                          tl[k].detach().numpy())


def test_remote_model_saver_round_trip_and_jax_reads_it(tmp_path):
    _, tn = _trained_pair()
    url = "memory://models/final"
    tstore.RemoteModelSaver(url).save(tn)
    back = tstore.load_model_remote(url, device="cpu")
    _assert_tree_equal(back.params, tn.params)
    assert back.conf.to_json() == tn.conf.to_json()
    tstore.RemoteModelSaver(f"file://{tmp_path}/m").save(tn)
    jback = jstore.load_model_remote(f"file://{tmp_path}/m")
    np.testing.assert_array_equal(jback.params_flat(), tn.params_flat())


@pytest.mark.parametrize("kind", ["csv", "svmlight"])
def test_remote_dataset_equals_jax(kind, tmp_path):
    if kind == "csv":
        body, kw = b"1.0,2.0,0\n3.0,4.0,1\n5.0,6.0,1\n", {"num_classes": 2}
    else:
        body, kw = b"0 1:0.5 3:1.5\n1 2:2.0\n", {}
    tstore.MemoryStore("data").write_bytes("d/mini.txt", body)
    jstore.MemoryStore("data").write_bytes("d/mini.txt", body)
    got = tstore.remote_dataset("memory://data/d/mini.txt", kind=kind,
                                cache=tmp_path / "t", **kw)
    want = jstore.remote_dataset("memory://data/d/mini.txt", kind=kind,
                                 cache=tmp_path / "j", **kw)
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    with pytest.raises(ValueError, match="kind"):
        tstore.remote_dataset("memory://data/d/mini.txt", kind="parquet",
                              cache=tmp_path / "t")


# ---------------------------------------------------------------------------
# profiler


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    logdir = str(tmp_path / "prof")
    with tprof.trace(logdir) as d:
        assert d == logdir
        with tprof.annotate("matmul-span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "prof" / files[0]).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "matmul-span" in names


def test_step_timer_equals_jax_on_the_same_calls(monkeypatch):
    clock = iter([0.0, 0.5, 0.75, 1.5, 1.625, 2.0, 3.0, 4.25] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timers = [tprof.StepTimer(batch_size=16, skip=1),
              jprof.StepTimer(batch_size=16, skip=1)]
    for timer in timers:
        for i in range(8):
            timer(i, 0.1)
    got, want = timers[0].summary(), timers[1].summary()
    assert got == want and got["steps"] == 6
    assert timers[0].times == timers[1].times
    timers[0].reset()
    assert timers[0].summary() == {"steps": 0}


def test_device_memory_stats_keys(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.device_memory_stats() == [{"device": "cpu"}]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 10, "allocated_bytes.all.peak": 30})

    class Props:
        total_memory = 1000

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    assert tprof.device_memory_stats() == [{
        "device": "cuda:0", "bytes_in_use": 10, "peak_bytes_in_use": 30,
        "bytes_limit": 1000}]


# ---------------------------------------------------------------------------
# registered losses (ROADMAP C2)


def _huber_jax(labels, preds):
    d = jnp.abs(labels - preds)
    per = jnp.where(d < 0.5, 0.5 * d * d, 0.5 * (d - 0.25))
    return jnp.mean(jnp.sum(per, axis=-1))


def _huber_torch(labels, preds):
    d = torch.abs(labels - preds)
    per = torch.where(d < 0.5, 0.5 * d * d, 0.5 * (d - 0.25))
    return torch.mean(torch.sum(per, dim=-1))


@pytest.fixture
def huber():
    jlosses.register_loss("test_huber", _huber_jax)
    tlosses.register_loss("test_huber", _huber_torch)
    yield "test_huber"
    jlosses._LOSSES.pop("test_huber", None)
    tlosses._LOSSES.pop("test_huber", None)


def test_register_loss_and_the_public_losses(huber):
    from deeplearning4j_tpu_torch import ops

    assert ops.register_loss is tlosses.register_loss
    assert tlosses.get_loss("TEST_HUBER") is _huber_torch
    assert tlosses.available_losses() == jlosses.available_losses()
    rng = np.random.default_rng(3)
    y = rng.random((5, 4)).astype(np.float32)
    p = rng.uniform(0.05, 0.95, (5, 4)).astype(np.float32)
    for name in jlosses.available_losses():
        want = float(jlosses.get_loss(name)(jnp.asarray(y), jnp.asarray(p)))
        got = float(tlosses.get_loss(name)(torch.from_numpy(y),
                                           torch.from_numpy(p)))
        assert got == pytest.approx(want, rel=TOL, abs=1e-6), name
        rows = tlosses.per_row_loss(name, torch.from_numpy(y),
                                    torch.from_numpy(p))
        want_rows = jax.vmap(lambda a, b: jlosses.get_loss(name)(
            a[None], b[None]))(jnp.asarray(y), jnp.asarray(p))
        np.testing.assert_allclose(rows.numpy(), np.asarray(want_rows),
                                   rtol=TOL, atol=1e-6, err_msg=name)
    public = [tlosses.mse, tlosses.rmse, tlosses.squared_loss, tlosses.xent,
              tlosses.mcxent, tlosses.negative_log_likelihood,
              tlosses.rmse_xent, tlosses.expll,
              tlosses.reconstruction_crossentropy,
              tlosses.mcxent_with_logits, tlosses.xent_with_logits,
              tlosses.cosine_proximity, tlosses.hinge, tlosses.mae]
    assert len(public) == 14
    with pytest.raises(KeyError, match="Unknown loss"):
        tlosses.get_loss("no_such_loss")


def test_registered_loss_evaluates_row_by_row(huber):
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.random((2, 3, 4)).astype(np.float32))
    p = torch.from_numpy(rng.random((2, 3, 4)).astype(np.float32))
    rows = tlosses.per_row_loss(huber, y, p)
    assert rows.shape == (2, 3)
    for i in range(2):
        for t in range(3):
            assert float(rows[i, t]) == pytest.approx(
                float(_huber_torch(y[i, t][None], p[i, t][None])))


def test_custom_loss_scores_and_fits_like_jax(huber):
    conf_json = _mlp_json(loss=huber, activation="sigmoid")
    x, y = _data(24, seed=5)
    jn, tn = _pair(conf_json)
    assert tn.score(x, y) == pytest.approx(float(jn.score(x, y)), rel=TOL)
    for _ in range(5):
        jl = float(jn.fit_batch(x[:8], y[:8]))
        tl = float(tn.fit_batch(x[:8], y[:8]))
        assert tl == pytest.approx(jl, rel=TOL)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(), atol=TOL)
    assert tn.score(x, y) == pytest.approx(float(jn.score(x, y)), rel=TOL)

    jn, tn = _pair(conf_json)
    batches = [(x[i:i + 5], y[i:i + 5]) for i in range(0, 24, 5)]
    jn.fit(batches, epochs=2, chunk_size=3, prefetch=0)
    tn.fit(batches, epochs=2, chunk_size=3, prefetch=0)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(), atol=TOL)
    assert tn.score(x, y) == pytest.approx(float(jn.score(x, y)), rel=TOL)


def test_custom_loss_on_masked_sequences_like_jax(huber):
    conf = jconf.MultiLayerConfiguration(
        conf=jconf.NeuralNetConfiguration(learning_rate=0.05,
                                          updater="adam", seed=3),
        layers=(jconf.GravesLSTMConf(n_in=5, n_out=6),
                jconf.RnnOutputLayerConf(n_in=6, n_out=5, loss=huber,
                                         activation="sigmoid")))
    jn, tn = _pair(conf.to_json())
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    y = rng.random((3, 7, 5)).astype(np.float32)
    m = np.ones((3, 7), np.float32)
    m[1, 4:] = 0
    assert tn.score(x, y, m) == pytest.approx(float(jn.score(x, y, m)),
                                              rel=TOL)
    for _ in range(3):
        jl = float(jn.fit_batch(x, y, m))
        tl = float(tn.fit_batch(x, y, m))
        assert tl == pytest.approx(jl, rel=TOL)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(), atol=TOL)
