"""PyTorch port, slice 16: the data tail against the JAX package on the
CPU — the downloader and the fetchers' resolution order, the image
vectorizer, the news corpus, `ml/` and the host utilities.

Nothing leaves the machine: every test runs with ``DL4J_NO_DOWNLOAD=1``
and a private cache directory, except the downloader's, which serve
files from a loopback ``http.server`` (as ``tests/test_fetchers.py``
does) and point the fetchers at it by their URL overrides.

Tolerances: arrays built on the host (IDX reads, curves, news TF-IDF,
utils) are equal to JAX's; the `ml` pipeline, trained from JAX's initial
weights on the same batches, gives probabilities within 1e-5 of JAX's
and the same score.
"""

import functools
import gzip
import hashlib
import http.server
import io
import pickle
import struct
import tarfile
import threading
import warnings

import numpy as np
import pytest

from deeplearning4j_tpu import ml as jml
from deeplearning4j_tpu import utils as jutils
from deeplearning4j_tpu.datasets import downloader as jdl
from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.datasets import vectorizer as jvec
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nlp import news as jnews
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu_torch import ml as tml
from deeplearning4j_tpu_torch import utils as tutils
from deeplearning4j_tpu_torch.datasets import downloader as tdl
from deeplearning4j_tpu_torch.datasets import fetchers as tf
from deeplearning4j_tpu_torch.datasets import vectorizer as tvec
from deeplearning4j_tpu_torch.ml import pipeline as tpipe
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nlp import news as tnews
from deeplearning4j_tpu_torch.nn import conf as tconf
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

PROBA_TOL = 1e-5


@pytest.fixture(autouse=True)
def _offline(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_NO_DOWNLOAD", "1")
    monkeypatch.setenv("DL4J_CACHE_DIR", str(tmp_path / "cache"))
    for var in ("MNIST_DIR", "CIFAR10_DIR", "MNIST_BASE_URL", "CIFAR10_URL",
                "TEXT8_PATH", "DL4J_NEWS_DIR"):
        monkeypatch.delenv(var, raising=False)


def _same(t, j):
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.features.dtype == j.features.dtype


# ---------------------------------------------------------------------------
# the downloader, against a loopback server


def _idx_bytes(arr: np.ndarray) -> bytes:
    header = struct.pack(">I", (0x08 << 8) | arr.ndim)
    header += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    return header + arr.astype(np.uint8).tobytes()


def _cifar_archive() -> bytes:
    rng = np.random.default_rng(4)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            body = pickle.dumps({b"data": rng.integers(0, 256, (3, 3072),
                                                       dtype=np.uint8),
                                 b"labels": list(rng.integers(0, 10, 3))})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(body)
            tar.addfile(info, io.BytesIO(body))
    return buf.getvalue()


@pytest.fixture
def site(tmp_path):
    """A loopback HTTP server over a 32-example MNIST in IDX.gz and a
    tiny CIFAR-10 archive."""
    rng = np.random.default_rng(0)
    root = tmp_path / "site"
    root.mkdir()
    for prefix, n in (("train", 32), ("t10k", 16)):
        for name, arr in (
                (f"{prefix}-images-idx3-ubyte",
                 rng.integers(0, 256, (n, 28, 28))),
                (f"{prefix}-labels-idx1-ubyte", rng.integers(0, 10, (n,)))):
            (root / (name + ".gz")).write_bytes(gzip.compress(_idx_bytes(arr)))
    (root / "cifar.tar.gz").write_bytes(_cifar_archive())

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=str(root)))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield root, f"http://127.0.0.1:{srv.server_address[1]}/"
    srv.shutdown()
    srv.server_close()


def test_download_verifies_sha256_and_reuses_a_verified_file(site,
                                                             tmp_path):
    root, url = site
    name = "train-labels-idx1-ubyte.gz"
    digest = hashlib.sha256((root / name).read_bytes()).hexdigest()
    dest = tmp_path / "dl" / name
    assert tdl.download(url + name, dest, sha256=digest) == dest
    assert dest.read_bytes() == (root / name).read_bytes()
    assert not dest.with_suffix(".gz.part").exists()
    assert tdl.download("http://127.0.0.1:9/gone", dest,
                        sha256=digest) == dest        # verified: no fetch
    with pytest.raises(ValueError, match="SHA-256"):
        tdl.download(url + name, tmp_path / "bad.gz", sha256="0" * 64)
    assert not (tmp_path / "bad.gz").exists()
    with pytest.raises(ValueError, match="SHA-256"):
        jdl.download(url + name, tmp_path / "bad_j.gz", sha256="0" * 64)


def test_fetch_mnist_downloads_into_the_cache_both_packages_read(
        site, monkeypatch):
    _, url = site
    monkeypatch.delenv("DL4J_NO_DOWNLOAD")
    monkeypatch.setenv("MNIST_BASE_URL", url)
    assert not tf.is_real_mnist_available()
    d = tdl.fetch_mnist()
    assert d == tdl.cache_dir("mnist") == jdl.cache_dir("mnist")
    assert all((d / f).exists() for f in tdl.MNIST_FILES)
    assert tf.is_real_mnist_available() and jf.is_real_mnist_available()
    for split in ("train", "test"):
        _same(tf.mnist_dataset(split), jf.mnist_dataset(split,
                                                        download=False))
    # a cached copy is read with the server gone
    monkeypatch.setenv("MNIST_BASE_URL", "http://127.0.0.1:9/")
    assert tf.mnist_dataset("test").features.shape == (16, 28, 28, 1)


def test_mnist_dataset_downloads_when_nothing_is_local(site, monkeypatch):
    _, url = site
    monkeypatch.delenv("DL4J_NO_DOWNLOAD")
    monkeypatch.setenv("MNIST_BASE_URL", url)
    ds = tf.mnist_dataset("train", flatten=True)
    assert ds.features.shape == (32, 784)
    _same(ds, jf.mnist_dataset("train", flatten=True, download=False))


def test_fetch_cifar10_from_an_override_url(site, monkeypatch):
    _, url = site
    monkeypatch.delenv("DL4J_NO_DOWNLOAD")
    monkeypatch.setenv("CIFAR10_URL", url + "cifar.tar.gz")
    with pytest.warns(UserWarning, match="sha256 verification DISABLED"):
        d = tdl.fetch_cifar10()
    assert d.name == "cifar-10-batches-py" and (d / "test_batch").exists()
    _same(tf.cifar10_dataset("train"), jf.cifar10_dataset("train",
                                                          download=False))
    assert tf.cifar10_dataset("test").features.shape == (3, 32, 32, 3)


def test_downloads_forbidden_fall_back_loudly_as_jax(monkeypatch):
    assert not tdl.downloads_allowed() and not jdl.downloads_allowed()
    for fetch in (tdl.fetch_mnist, tdl.fetch_cifar10, tdl.fetch_text8,
                  tdl.fetch_lfw):
        with pytest.raises(RuntimeError, match="DL4J_NO_DOWNLOAD"):
            fetch()
    with pytest.warns(RuntimeWarning, match="downloads disabled"):
        got = tf.mnist_dataset("test")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same(got, jf.mnist_dataset("test"))
        _same(tf.cifar10_dataset("test"), jf.cifar10_dataset("test"))
    with pytest.warns(RuntimeWarning, match="NOT comparable"):
        lfw = tf.lfw_dataset(num_classes=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same(lfw, jf.lfw_dataset(num_classes=4))
    monkeypatch.setenv("DL4J_NO_DOWNLOAD", "0")
    assert tdl.downloads_allowed()


def test_text8_path_override(tmp_path, monkeypatch):
    corpus = tmp_path / "text8"
    corpus.write_text("the quick brown fox")
    monkeypatch.setenv("TEXT8_PATH", str(corpus))
    assert tdl.fetch_text8() == jdl.fetch_text8() == corpus
    monkeypatch.setenv("TEXT8_PATH", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="TEXT8_PATH"):
        tdl.fetch_text8()


@pytest.mark.parametrize("n,size,seed", [(50, 28, 0), (7, 16, 3)])
def test_curves_equal_jax_bitwise(n, size, seed):
    got = tdl.curves_images(n, size=size, seed=seed)
    want = jdl.curves_images(n, size=size, seed=seed)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    _same(tf.curves_dataset(n, seed=seed), jf.curves_dataset(n, seed=seed))


def test_image_vectorizer_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    path = tmp_path / "img.png"
    Image.fromarray(rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)).save(
        path)
    for build in (lambda v: v, lambda v: v.binarize(60),
                  lambda v: v.normalize()):
        got = build(tvec.ImageVectorizer(path, 4, 2)).vectorize()
        want = build(jvec.ImageVectorizer(path, 4, 2)).vectorize()
        _same(got, want)
    got = tvec.ImageVectorizer(path, 4, 1, height=5, width=3).vectorize()
    assert got.features.shape == (1, 15)


# ---------------------------------------------------------------------------
# news


def _corpus(tmp_path):
    texts = {"sport": ["the team won", "fans cheered the goal",
                       "the coach smiled"],
             "tech": ["the chip is fast", "kernels fuse well"],
             "zoo": ["the lion sleeps"]}
    for label, docs in texts.items():
        (tmp_path / "news" / label).mkdir(parents=True)
        for i, t in enumerate(docs):
            (tmp_path / "news" / label / f"{i}.txt").write_text(t)
    return tmp_path / "news"


@pytest.mark.parametrize("tfidf,cap", [(True, None), (False, 3)])
def test_news_from_a_directory_equals_jax(tmp_path, tfidf, cap):
    root = _corpus(tmp_path)
    assert tnews.news_corpus(root, cap) == jnews.news_corpus(root, cap)
    _same(tnews.news_dataset(root, tfidf=tfidf, num_examples=cap),
          jnews.news_dataset(root, tfidf=tfidf, num_examples=cap))


def test_news_env_dir_fallback_and_iterator_equal_jax(tmp_path, monkeypatch):
    with pytest.warns(RuntimeWarning, match="bundled mini news corpus"):
        got = tnews.news_dataset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same(got, jnews.news_dataset())
    monkeypatch.setenv("DL4J_NEWS_DIR", str(_corpus(tmp_path)))
    _same(tnews.news_dataset(), jnews.news_dataset())
    t_it = tnews.NewsGroupsDataSetIterator(batch=2, num_examples=4)
    j_it = jnews.NewsGroupsDataSetIterator(batch=2, num_examples=4)
    for a, b in zip(t_it, j_it):
        _same(a, b)
    with pytest.raises(FileNotFoundError):
        tnews.news_corpus(tmp_path / "nope")


# ---------------------------------------------------------------------------
# ml


def _clf_json(seed=3):
    return jconf.MultiLayerConfiguration(
        conf=jconf.NeuralNetConfiguration(learning_rate=0.01,
                                          updater="adam", seed=seed),
        layers=(jconf.DenseLayerConf(n_in=4, n_out=16, activation="relu"),
                jconf.OutputLayerConf(n_in=16, n_out=3))).to_json()


@pytest.fixture
def jax_initial_weights(monkeypatch):
    """The port's networks in `ml` start from JAX's initial weights (JAX
    draws them by threefry, the port by torch's generator)."""
    class FromJax(TNet):
        def init(self, seed=None):
            super().init(seed)
            jconf_ = jconf.MultiLayerConfiguration.from_json(
                self.conf.to_json())
            jparams = JNet(jconf_).init(seed).params
            self.params = params_from_numpy(
                self, [{k: np.asarray(v) for k, v in p.items()}
                       for p in jparams])
            self.updater_state = self._updater.init(self.params)
            return self

    monkeypatch.setattr(tpipe, "MultiLayerNetwork", FromJax)


def test_pipeline_equals_jax(jax_initial_weights):
    ds = jf.iris_dataset(normalize=False)
    y = ds.labels.argmax(1)
    jp = jml.Pipeline([("scale", jml.StandardScaler()),
                       ("clf", jml.NetworkClassifier(
                           jconf.MultiLayerConfiguration.from_json(
                               _clf_json()), epochs=8, batch_size=32))])
    tp = tml.Pipeline([("scale", tml.StandardScaler()),
                       ("clf", tml.NetworkClassifier(
                           tconf.MultiLayerConfiguration.from_json(
                               _clf_json()), epochs=8, batch_size=32,
                           device="cpu"))])
    jp.fit(ds.features, y)
    tp.fit(ds.features, y)
    np.testing.assert_array_equal(tp.steps[0][1].mean_, jp.steps[0][1].mean_)
    np.testing.assert_array_equal(tp.steps[0][1].std_, jp.steps[0][1].std_)
    np.testing.assert_allclose(tp.predict_proba(ds.features),
                               jp.predict_proba(ds.features),
                               atol=PROBA_TOL)
    assert tp.score(ds.features, y) == jp.score(ds.features, y) > 0.8
    np.testing.assert_array_equal(tp.predict(ds.features),
                                  jp.predict(ds.features))


def test_estimator_params_and_refusals():
    conf = tconf.MultiLayerConfiguration.from_json(_clf_json())
    clf = tml.NetworkClassifier(conf, epochs=5, device="cpu")
    assert clf.get_params()["epochs"] == 5
    clf.set_params(epochs=2)
    assert clf.epochs == 2
    with pytest.raises(ValueError, match="unknown param"):
        clf.set_params(nope=1)
    with pytest.raises(ValueError, match="fit"):
        clf.network
    with pytest.raises(NotImplementedError, match="A7"):
        tml.NetworkClassifier(conf, distributed=True,
                              device="cpu").fit(np.zeros((4, 4)),
                                                np.zeros(4, int))
    with pytest.raises(ValueError, match="duplicate"):
        tml.Pipeline([("a", tml.StandardScaler()),
                      ("a", tml.StandardScaler())]).fit(np.zeros((2, 4)))


def test_reconstruction_transform_equals_jax(jax_initial_weights):
    conf = jconf.MultiLayerConfiguration(
        conf=jconf.NeuralNetConfiguration(learning_rate=0.05, seed=1),
        layers=(jconf.AutoEncoderConf(n_in=4, n_out=3, corruption_level=0.0),
                jconf.OutputLayerConf(n_in=3, n_out=2)))
    x = np.random.default_rng(2).random((12, 4)).astype(np.float32)
    want = jml.NetworkReconstruction(conf, epochs=1, batch_size=4,
                                     layer=1).fit_transform(x)
    got = tml.NetworkReconstruction(
        tconf.MultiLayerConfiguration.from_json(conf.to_json()), epochs=1,
        batch_size=4, layer=1, device="cpu").fit_transform(x)
    assert got.shape == want.shape == (12, 3)
    np.testing.assert_allclose(got, want, atol=PROBA_TOL)


def test_sources_equal_jax():
    assert sorted(tml.SOURCES) == sorted(jml.SOURCES)
    for name in tml.SOURCES:
        assert tml.source_schema(name) == jml.source_schema(name)
    _same(tml.load_source("iris"), jml.load_source("iris"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same(tml.load_source("newsgroups"), jml.load_source("newsgroups"))
    with pytest.raises(KeyError, match="unknown data source"):
        tml.load_source("nope")


# ---------------------------------------------------------------------------
# utils


def test_every_math_util_equals_jax():
    rng = np.random.default_rng(7)
    a, b = rng.random(9), rng.random(9)
    p = rng.random(5)
    p /= p.sum()
    for name, args in [
            ("sigmoid", (a - 0.5,)), ("log2", (a + 0.1,)), ("entropy", (p,)),
            ("information_gain", (p, [p[:2], p[2:]], [0.4, 0.6])),
            ("normalize", (a, -1.0, 2.0)), ("normalize", (np.ones(3),)),
            ("correlation", (a, b)), ("correlation", (np.ones(3), a[:3])),
            ("cosine_similarity", (a, b)),
            ("cosine_similarity", (np.zeros(3), a[:3])),
            ("euclidean_distance", (a, b)), ("manhattan_distance", (a, b)),
            ("ssq", (a,)),
            ("bernoulli_log_likelihood", ((a > 0.5) * 1.0, b))]:
        got = getattr(tutils, name)(*args)
        want = getattr(jutils, name)(*args)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tutils.uniform(np.random.default_rng(1), -2, 3) == \
        jutils.uniform(np.random.default_rng(1), -2, 3)


def test_counters_equal_jax():
    words = "a b a c b a d".split()
    t, j = tutils.Counter(words), jutils.Counter(words)
    assert dict(t.items()) == dict(j.items())
    assert (t.arg_max(), t.max_count(), t.total_count(), str(t)) == (
        j.arg_max(), j.max_count(), j.total_count(), str(j))
    assert t.sorted_keys() == j.sorted_keys()
    assert dict(t.normalize().items()) == dict(j.normalize().items())
    assert tutils.Counter().arg_max() is None
    tm, jm = tutils.CounterMap(), jutils.CounterMap()
    for m in (tm, jm):
        m.increment("x", "a", 2.0)
        m.increment("x", "b")
        m.set_count("y", "a", 5.0)
        m.normalize()
    assert tm.get_count("x", "a") == jm.get_count("x", "a")
    assert tm.total_count() == jm.total_count() and len(tm) == len(jm)
    assert "y" in tm and tm.get_count("z", "a") == 0.0


def test_moving_window_equals_jax():
    m = np.arange(20).reshape(4, 5)
    for kw in ({}, {"add_rotate": True}):
        got = tutils.MovingWindowMatrix(m, 2, 3, **kw).windows(1, 2)
        want = jutils.MovingWindowMatrix(m, 2, 3, **kw).windows(1, 2)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="larger"):
        tutils.MovingWindowMatrix(m, 5, 1)


def test_disk_queue_serialization_and_image_loader(tmp_path):
    with tutils.DiskBasedQueue() as q:
        for item in ({"a": 1}, [2, 3], "four"):
            q.add(item)
        assert len(q) == 3 and q.peek() == {"a": 1}
        assert [q.poll(), q.poll(), q.poll()] == [{"a": 1}, [2, 3], "four"]
        assert q.empty()
        with pytest.raises(IndexError):
            q.poll()
    obj = {"x": np.arange(3), "y": "z"}
    tutils.save_object(obj, tmp_path / "o.pkl")
    back = jutils.load_object(tmp_path / "o.pkl")
    np.testing.assert_array_equal(back["x"], obj["x"])
    assert tutils.load_object(tmp_path / "o.pkl")["y"] == "z"
    from PIL import Image

    Image.fromarray(np.random.default_rng(8).integers(
        0, 256, (6, 4, 3), dtype=np.uint8)).save(tmp_path / "i.png")
    for kw in ({}, {"grayscale": False}, {"height": 3, "width": 2}):
        np.testing.assert_array_equal(
            tutils.ImageLoader(**kw).as_matrix([tmp_path / "i.png"] * 2),
            jutils.ImageLoader(**kw).as_matrix([tmp_path / "i.png"] * 2))
