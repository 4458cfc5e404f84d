"""Dataset fetchers (counterpart of `deeplearning4j_tpu.datasets.fetchers`;
numpy only, no download).

Parity: reference `datasets/fetchers/*` (MNIST `MnistDataFetcher.java:39`,
Iris `IrisDataFetcher`) and the Canova record readers the CLI uses
(reference Train.java:155-165, default SVMLightInputFormat).

- `iris_dataset` and `digits_dataset` read sklearn's bundled copies;
  sklearn is imported inside them, so nothing else needs it.
- `mnist_dataset` and `cifar10_dataset` read a local directory:
  ``$MNIST_DIR`` (IDX files) / ``$CIFAR10_DIR`` (the python batches), then
  the cache directory the JAX package downloads into
  (``$DL4J_CACHE_DIR/<name>``, else ``~/.cache/deeplearning4j_tpu/<name>``).
  With neither, they fall back loudly, as the JAX package does offline:
  MNIST to sklearn's 8x8 digits upscaled (else synthetic blobs), CIFAR-10
  to synthetic blobs.  The port has no download step (ROADMAP.md A6).
- The CSV and SVMLight readers parse through the native C++ library
  (`deeplearning4j_tpu_torch.native`, built with g++ on first use) under
  the JAX package's conditions, else with its Python parsers; both give
  the same arrays.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


def one_hot(indices: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((len(indices), num_classes), np.float32)
    out[np.arange(len(indices)), indices.astype(int)] = 1.0
    return out


def cache_dir(name: str) -> Path:
    """Where the JAX package's downloader caches dataset `name`."""
    root = os.environ.get("DL4J_CACHE_DIR")
    if root:
        return Path(root) / name
    return Path.home() / ".cache" / "deeplearning4j_tpu" / name


def _warn_fallback(name: str, reason: str, substitute: str) -> None:
    warnings.warn(
        f"{name}: {reason} — substituting {substitute}. Quality numbers "
        f"from this data are NOT comparable to the real dataset.",
        RuntimeWarning, stacklevel=3)


def iris_dataset(normalize: bool = True) -> DataSet:
    """The 150-example Iris set (reference IrisDataFetcher / iris.dat)."""
    from sklearn.datasets import load_iris

    data = load_iris()
    ds = DataSet(data.data.astype(np.float32), one_hot(data.target, 3))
    return ds.normalize_zero_mean_unit_variance() if normalize else ds


def read_idx(path: Path) -> np.ndarray:
    """An IDX file (MNIST's format; ``.gz`` read through gzip)."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        ndim = struct.unpack(">I", f.read(4))[0] & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def _load_mnist_dir(d: Path, split: str, binarize: bool,
                    flatten: bool) -> Optional[DataSet]:
    prefix = "train" if split == "train" else "t10k"
    for img_name in (f"{prefix}-images-idx3-ubyte",
                     f"{prefix}-images.idx3-ubyte"):
        for suffix in ("", ".gz"):
            p = d / (img_name + suffix)
            if p.exists():
                images = read_idx(p).astype(np.float32) / 255.0
                lbl = img_name.replace("images-idx3", "labels-idx1").replace(
                    "images.idx3", "labels.idx1")
                labels = read_idx(d / (lbl + suffix))
                return _package_mnist(images, labels, binarize, flatten)
    return None


def _mnist_dirs() -> list:
    mnist_dir = os.environ.get("MNIST_DIR")
    return ([Path(mnist_dir)] if mnist_dir else []) + [cache_dir("mnist")]


def mnist_dataset(split: str = "train", binarize: bool = False,
                  flatten: bool = False) -> DataSet:
    """MNIST from ``$MNIST_DIR`` or the cache directory; else (loudly)
    sklearn's digits upscaled to 28x28, else synthetic blobs.  Features
    in [0,1], NHWC [N,28,28,1] or flat [N,784]."""
    for d in _mnist_dirs():
        ds = _load_mnist_dir(d, split, binarize, flatten)
        if ds is not None:
            return ds
    _warn_fallback("mnist_dataset", "no local MNIST (set MNIST_DIR)",
                   "sklearn 8x8 digits upscaled to 28x28")
    try:
        return _digits_as_mnist(split, binarize, flatten)
    except ImportError:
        _warn_fallback("mnist_dataset", "sklearn digits unavailable",
                       "synthetic Gaussian blobs")
        return synthetic_mnist(6000 if split == "train" else 1000,
                               binarize=binarize, flatten=flatten)


def is_real_mnist_available() -> bool:
    """True when `mnist_dataset` would return the real MNIST."""
    return any(_load_mnist_dir(d, "test", False, False) is not None
               for d in _mnist_dirs())


def digits_dataset(split: str = "train", flatten: bool = False) -> DataSet:
    """sklearn's bundled 1,797 8x8 handwritten digits: a deterministic
    shuffled 80/20 split, features in [0,1], NHWC [N,8,8,1] or flat
    [N,64]."""
    from sklearn.datasets import load_digits

    digits = load_digits()
    order = np.random.default_rng(42).permutation(len(digits.target))
    images = digits.images.astype(np.float32)[order] / 16.0
    labels = digits.target[order]
    cut = int(len(order) * 0.8)
    sl = slice(0, cut) if split == "train" else slice(cut, None)
    part = images[sl]
    x = part.reshape(len(part), -1) if flatten else part[..., None]
    return DataSet(x, one_hot(labels[sl], 10))


def _digits_as_mnist(split: str, binarize: bool, flatten: bool) -> DataSet:
    from sklearn.datasets import load_digits

    digits = load_digits()
    x8 = digits.images.astype(np.float32) / 16.0                 # [N, 8, 8]
    x28 = np.kron(x8, np.ones((1, 4, 4), np.float32))[:, 2:-2, 2:-2]
    cut = int(len(x28) * 0.8)
    if split == "train":
        images, labels = x28[:cut], digits.target[:cut]
    else:
        images, labels = x28[cut:], digits.target[cut:]
    return _package_mnist(images, labels, binarize, flatten)


def synthetic_mnist(n: int = 6000, binarize: bool = False,
                    flatten: bool = False, seed: int = 0) -> DataSet:
    """Class-dependent blobs at MNIST's shape, for throughput runs and
    smoke tests when no real data exists."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(12345).random((10, 28, 28)).astype(
        np.float32)
    labels = rng.integers(0, 10, n)
    images = (centers[labels] * 0.5
              + rng.random((n, 28, 28)).astype(np.float32) * 0.5)
    return _package_mnist(images, labels, binarize, flatten)


def _package_mnist(images: np.ndarray, labels: np.ndarray, binarize: bool,
                   flatten: bool) -> DataSet:
    if binarize:
        images = (images > 0.5).astype(np.float32)
    x = images.reshape(len(images), -1) if flatten else images[..., None]
    return DataSet(x.astype(np.float32), one_hot(labels, 10))


def _load_cifar_dir(d: Path, split: str) -> Optional[DataSet]:
    names = ([f"data_batch_{i}" for i in range(1, 6)]
             if split == "train" else ["test_batch"])
    if not all((d / n).exists() for n in names):
        return None
    xs, ys = [], []
    for n in names:
        with open(d / n, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(batch[b"data"], np.uint8))
        ys.extend(batch[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32)
    x = np.transpose(x, (0, 2, 3, 1)).astype(np.float32) / 255.0  # NHWC
    return DataSet(x, one_hot(np.asarray(ys), 10))


def cifar10_dataset(split: str = "train") -> DataSet:
    """CIFAR-10 as NHWC [N,32,32,3] float32 in [0,1] from ``$CIFAR10_DIR``
    or the cache directory (the python batches); else (loudly) synthetic
    blobs."""
    env_dir = os.environ.get("CIFAR10_DIR")
    candidates = [Path(env_dir)] if env_dir else []
    candidates.append(cache_dir("cifar10") / "cifar-10-batches-py")
    for d in candidates:
        ds = _load_cifar_dir(d, split)
        if ds is not None:
            return ds
    _warn_fallback("cifar10_dataset", "no local CIFAR-10 (set CIFAR10_DIR)",
                   "synthetic Gaussian blobs")
    return synthetic_cifar10(6000 if split == "train" else 1000)


def synthetic_cifar10(n: int, seed: int = 0) -> DataSet:
    """Class-dependent colour blobs at CIFAR-10's shape (throughput and
    smoke runs only)."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(12345).random(
        (10, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, n)
    x = centers[labels] * 0.5 + rng.random(
        (n, 32, 32, 3)).astype(np.float32) * 0.5
    return DataSet(x, one_hot(labels, 10))


def csv_dataset(path: str, label_col: int = -1,
                num_classes: Optional[int] = None,
                skip_header: bool = False, delimiter: str = ",") -> DataSet:
    """CSV -> DataSet (reference CSVDataSetIterator): one example a row,
    the class index in column `label_col`.  The native parser splits on
    comma, semicolon or whitespace, so it takes the "," and ";"
    delimiters; others, a missing compiler or a file it refuses take the
    numpy parser."""
    from deeplearning4j_tpu_torch import native

    if delimiter in (",", ";") and native.have_native():
        try:
            features, labels = native.csv_read(
                path, skip_header=skip_header, label_col=label_col)
        except ValueError:
            pass  # the numpy parser below
        else:
            labels = labels.astype(int)
            k = num_classes or int(labels.max()) + 1
            return DataSet(features.astype(np.float32), one_hot(labels, k))
    raw = np.genfromtxt(path, delimiter=delimiter,
                        skip_header=1 if skip_header else 0,
                        dtype=np.float32)
    if raw.ndim == 1:
        raw = raw[None, :]
    labels = raw[:, label_col].astype(int)
    features = np.delete(raw, label_col if label_col >= 0
                         else raw.shape[1] + label_col, axis=1)
    k = num_classes or int(labels.max()) + 1
    return DataSet(features.astype(np.float32), one_hot(labels, k))


def sniff_svmlight_features(path: str) -> int:
    """The largest feature index (1-based) in an SVMLight file: its
    feature count when none is configured.  Skips qid:/cost: tokens."""
    max_idx = 0
    with open(path) as f:
        for line in f:
            for tok in line.split("#")[0].strip().split()[1:]:
                idx = tok.split(":")[0]
                if idx.isdigit():
                    max_idx = max(max_idx, int(idx))
    if max_idx == 0:
        raise ValueError(f"could not infer feature count from {path!r}")
    return max_idx


def _svmlight_rows(path: str, num_features: int):
    """The Python parser: (rows of float32 features, float labels)."""
    rows, labels = [], []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            vec = np.zeros(num_features, np.float32)
            for tok in parts[1:]:
                i, v = tok.split(":")
                if not i.isdigit():  # qid:/cost: meta tokens
                    continue
                vec[int(i) - 1] = float(v)  # svmlight is 1-indexed
            rows.append(vec)
    return rows, labels


def svmlight_dataset(path: str, num_features: int,
                     num_classes: Optional[int] = None) -> DataSet:
    """SVMLight / libsvm format (reference CLI default input format,
    Train.java:74).  Integer labels become one-hot classes (raw values
    such as ±1 mapped to contiguous indices); other labels stay a
    regression column.  Parsed natively when the library is built."""
    from deeplearning4j_tpu_torch import native

    rows = None
    if native.have_native():
        try:
            feats, y_arr = native.svmlight_read(path, num_features)
        except ValueError:
            pass  # the Python parser below
        else:
            if feats.shape[1] < num_features:  # tail columns all zero
                feats = np.pad(feats, ((0, 0),
                                       (0, num_features - feats.shape[1])))
            rows = list(feats[:, :num_features].astype(np.float32))
            labels = list(y_arr)
    if rows is None:
        rows, labels = _svmlight_rows(path, num_features)
    y = np.asarray(labels)
    y_int = y.astype(int)
    if np.all(y == y_int):
        classes = np.unique(y_int)
        if num_classes is not None and classes.min() >= 0:
            k, idx = num_classes, y_int
        else:
            k = len(classes)
            remap = {c: i for i, c in enumerate(classes.tolist())}
            idx = np.array([remap[c] for c in y_int])
        return DataSet(np.stack(rows), one_hot(idx, k))
    return DataSet(np.stack(rows), y[:, None].astype(np.float32))
