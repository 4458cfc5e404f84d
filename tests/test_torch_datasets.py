"""PyTorch port, slice 8: dataset fetchers, readers and iterators against
the JAX package: the same files and arrays give identical arrays and
batches.  No test downloads: MNIST and CIFAR-10 come from directories
the tests write, and the fetchers of both packages are called with
``download=False`` where nothing local exists."""

import gzip
import pickle
import struct
import warnings

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.datasets import iterators as ji
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets import fetchers as tf
from deeplearning4j_tpu_torch.datasets import iterators as ti
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


def _same(t, j):
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.features.dtype == j.features.dtype
    assert t.labels.dtype == j.labels.dtype
    if j.mask is None:
        assert t.mask is None
    else:
        np.testing.assert_array_equal(t.mask, j.mask)


def test_one_hot_and_synthetic_sets_match():
    idx = np.array([2, 0, 1, 2])
    np.testing.assert_array_equal(tf.one_hot(idx, 4), jf.one_hot(idx, 4))
    for kw in ({}, {"binarize": True}, {"flatten": True, "seed": 3}):
        _same(tf.synthetic_mnist(50, **kw), jf.synthetic_mnist(50, **kw))
    _same(tf.synthetic_cifar10(20, seed=1), jf.synthetic_cifar10(20, seed=1))


def test_sklearn_sets_match():
    pytest.importorskip("sklearn")
    _same(tf.iris_dataset(), jf.iris_dataset())
    _same(tf.iris_dataset(normalize=False), jf.iris_dataset(normalize=False))
    for split in ("train", "test"):
        _same(tf.digits_dataset(split), jf.digits_dataset(split))
    _same(tf.digits_dataset("test", flatten=True),
          jf.digits_dataset("test", flatten=True))


def _write_idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(head + arr.tobytes())


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_mnist_idx_directory_reads_the_same(tmp_path, monkeypatch, suffix):
    rng = np.random.default_rng(0)
    for split, n in (("train", 12), ("t10k", 5)):
        _write_idx(tmp_path / f"{split}-images-idx3-ubyte{suffix}",
                   rng.integers(0, 256, (n, 28, 28)))
        _write_idx(tmp_path / f"{split}-labels-idx1-ubyte{suffix}",
                   rng.integers(0, 10, n))
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    monkeypatch.setenv("DL4J_CACHE_DIR", str(tmp_path / "cache"))
    assert tf.is_real_mnist_available() and jf.is_real_mnist_available()
    for split in ("train", "test"):
        for kw in ({}, {"binarize": True, "flatten": True}):
            got = tf.mnist_dataset(split, **kw)
            _same(got, jf.mnist_dataset(split, download=False, **kw))
    np.testing.assert_array_equal(
        tf.read_idx(tmp_path / f"t10k-labels-idx1-ubyte{suffix}"),
        jf._read_idx(tmp_path / f"t10k-labels-idx1-ubyte{suffix}"))


def test_mnist_without_a_directory_falls_back_loudly(tmp_path, monkeypatch):
    pytest.importorskip("sklearn")
    monkeypatch.delenv("MNIST_DIR", raising=False)
    monkeypatch.setenv("DL4J_CACHE_DIR", str(tmp_path))
    assert not tf.is_real_mnist_available()
    with pytest.warns(RuntimeWarning, match="NOT comparable"):
        got = tf.mnist_dataset("test", download=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jf.mnist_dataset("test", download=False)
    _same(got, want)


def test_cifar10_directory_reads_the_same(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(tmp_path / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 4))}, f)
    monkeypatch.setenv("CIFAR10_DIR", str(tmp_path))
    for split in ("train", "test"):
        _same(tf.cifar10_dataset(split),
              jf.cifar10_dataset(split, download=False))
    assert tf.cifar10_dataset("train").features.shape == (20, 32, 32, 3)


def test_csv_reader_matches(tmp_path):
    rng = np.random.default_rng(2)
    rows = np.column_stack([rng.standard_normal((9, 3)).round(4),
                            rng.integers(0, 3, 9)])
    path = tmp_path / "d.csv"
    np.savetxt(path, rows, delimiter=",", header="a,b,c,label",
               comments="")
    _same(tf.csv_dataset(str(path), skip_header=True),
          jf.csv_dataset(str(path), skip_header=True))
    first = np.column_stack([rows[:, 3], rows[:, :3]])
    path2 = tmp_path / "first.csv"
    np.savetxt(path2, first, delimiter=";")
    _same(tf.csv_dataset(str(path2), label_col=0, num_classes=5,
                         delimiter=";"),
          jf.csv_dataset(str(path2), label_col=0, num_classes=5,
                         delimiter=";"))


def test_svmlight_reader_and_sniff_match(tmp_path):
    path = tmp_path / "d.svm"
    path.write_text("1 1:0.5 3:1.25 # comment\n"
                    "-1 qid:3 2:2.0 5:-1\n"
                    "\n"
                    "1 4:0.75\n")
    assert tf.sniff_svmlight_features(str(path)) == \
        jf.sniff_svmlight_features(str(path)) == 5
    _same(tf.svmlight_dataset(str(path), 5), jf.svmlight_dataset(str(path),
                                                                 5))
    reg = tmp_path / "r.svm"
    reg.write_text("0.5 1:1\n1.5 2:1\n")
    _same(tf.svmlight_dataset(str(reg), 3), jf.svmlight_dataset(str(reg), 3))
    idx = tmp_path / "i.svm"
    idx.write_text("0 1:1\n2 2:1\n")
    _same(tf.svmlight_dataset(str(idx), 2, num_classes=4),
          jf.svmlight_dataset(str(idx), 2, num_classes=4))
    empty = tmp_path / "e.svm"
    empty.write_text("1\n")
    with pytest.raises(ValueError, match="feature count"):
        tf.sniff_svmlight_features(str(empty))


def _arrays(n=11, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)])


def _batches(it, epochs=1):
    out = []
    for _ in range(epochs):
        out.extend(list(it))
        it.reset()
    return out


@pytest.mark.parametrize("kw", [{}, {"shuffle": False},
                                {"drop_last": True, "seed": 5}])
def test_array_iterator_batches_match(kw):
    x, y = _arrays()
    got = _batches(ti.ArrayDataSetIterator(x, y, 4, **kw), epochs=2)
    want = _batches(ji.ArrayDataSetIterator(x, y, 4, **kw), epochs=2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_wrapping_iterators_match():
    x, y = _arrays()
    pairs = [
        (ti.MultipleEpochsIterator(2, ti.ArrayDataSetIterator(x, y, 5)),
         ji.MultipleEpochsIterator(2, ji.ArrayDataSetIterator(x, y, 5))),
        (ti.SamplingDataSetIterator(TDataSet(x, y), 3, 4, seed=1),
         ji.SamplingDataSetIterator(JDataSet(x, y), 3, 4, seed=1)),
        (ti.ReconstructionDataSetIterator(ti.ArrayDataSetIterator(x, y, 4)),
         ji.ReconstructionDataSetIterator(ji.ArrayDataSetIterator(x, y, 4))),
        (ti.PrefetchDataSetIterator(ti.ArrayDataSetIterator(x, y, 3),
                                    depth=2),
         ji.PrefetchDataSetIterator(ji.ArrayDataSetIterator(x, y, 3),
                                    depth=2)),
    ]
    for t_it, j_it in pairs:
        got, want = list(t_it), list(j_it)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _same(g, w)
        assert t_it.batch_size() == j_it.batch_size()
        assert t_it.total_examples() == j_it.total_examples()


def test_prefetch_iterator_transforms_and_raises_on_the_consumer():
    x, y = _arrays()
    it = ti.PrefetchDataSetIterator(ti.ArrayDataSetIterator(x, y, 4),
                                    transform=lambda b: b.features.sum())
    want = [b.features.sum() for b in ti.ArrayDataSetIterator(x, y, 4)]
    assert list(it) == pytest.approx(want)

    def broken():
        yield TDataSet(x, y)
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(ti.PrefetchDataSetIterator(broken()))


def test_bucketed_sequence_iterator_matches():
    rng = np.random.default_rng(6)
    seqs = [rng.standard_normal((t, 2)).astype(np.float32)
            for t in (3, 9, 5, 12, 2, 7, 16, 4)]
    labels = [np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(s))]
              for s in seqs]
    for kw in ({}, {"drop_remainder": True, "boundaries": (4, 8)}):
        t_it = ti.BucketedSequenceIterator(seqs, labels, 3, seed=2, **kw)
        j_it = ji.BucketedSequenceIterator(seqs, labels, 3, seed=2, **kw)
        got, want = _batches(t_it, 2), _batches(j_it, 2)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _same(g, w)
