"""Dataset downloaders with local caching (counterpart of
`deeplearning4j_tpu.datasets.downloader`).

Parity: the reference's fetch-and-cache tier — `base/MnistFetcher.java:48`
(download MNIST archives into a home-dir cache, untar, point the fetcher at
the files), `LFWLoader` (`lfw/LFWLoader.java`), and
`datasets/fetchers/CurvesDataFetcher.java` (S3-hosted curves dataset).

Stdlib urllib into ``~/.cache/deeplearning4j_tpu/<name>`` — the JAX
package's cache, so either package reads what the other fetched —,
atomic rename after optional SHA-256 verification, transient failures
retried with backoff through `resilience.retry`, and a loud warning
(never a silent substitute) when the network is unavailable.  Set
DL4J_NO_DOWNLOAD=1 to forbid network access entirely (CI / air-gapped
hosts), DL4J_CACHE_DIR to move the cache; MNIST_BASE_URL, CIFAR10_URL
and TEXT8_PATH point at a mirror or a local copy.
"""

from __future__ import annotations

import gzip
import hashlib
import http.client
import os
import shutil
import tarfile
import urllib.error
import urllib.request
import warnings
import zipfile
import zlib
from pathlib import Path
from typing import Callable, Optional, Sequence

from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, retry_call

# The download failures worth refetching: OSError (URLError/HTTPError/
# BadGzipFile are subclasses), http.client.HTTPException (IncompleteRead/
# BadStatusLine escape as-is once the response body is streaming — NOT
# OSError), EOFError (truncated gzip stream), zlib.error (corrupt deflate
# data), and ValueError (SHA-256 mismatch / structural check = corrupt
# body).  Anything else is a real bug and propagates.
TRANSIENT_DOWNLOAD_ERRORS = (OSError, http.client.HTTPException, EOFError,
                             zlib.error, ValueError)

# Shared download retry: per-mirror exponential backoff with jitter.
DOWNLOAD_RETRY = RetryPolicy(max_attempts=3, base_delay=0.5, max_delay=8.0,
                             retryable=TRANSIENT_DOWNLOAD_ERRORS)


def _warn_retry(url: str):
    def on_retry(attempt: int, e: Exception, delay: float) -> None:
        warnings.warn(
            f"download attempt {attempt} of {url} failed ({e}); "
            f"retrying in {delay:.1f}s", stacklevel=4)
    return on_retry


def cache_dir(name: str) -> Path:
    root = os.environ.get("DL4J_CACHE_DIR")
    if root:
        return Path(root) / name
    return Path.home() / ".cache" / "deeplearning4j_tpu" / name


def downloads_allowed() -> bool:
    return os.environ.get("DL4J_NO_DOWNLOAD", "").lower() not in (
        "1", "true", "yes")


def download(url: str, dest: Path, sha256: Optional[str] = None,
             timeout: float = 60.0) -> Path:
    """Fetch `url` into `dest` (atomic: .part then rename).  Raises
    URLError/ValueError on failure; existing verified files are reused."""
    if dest.exists():
        if sha256 is None or _sha256(dest) == sha256:
            return dest
        dest.unlink()  # corrupt cache entry
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    req = urllib.request.Request(
        url, headers={"User-Agent": "deeplearning4j-tpu-torch/0.2"})
    with urllib.request.urlopen(req, timeout=timeout) as r, \
            open(tmp, "wb") as f:
        shutil.copyfileobj(r, f)
    if sha256 is not None and _sha256(tmp) != sha256:
        tmp.unlink()
        raise ValueError(f"SHA-256 mismatch for {url}")
    tmp.replace(dest)
    return dest


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# MNIST (reference MnistFetcher.java:48)
# ---------------------------------------------------------------------------

MNIST_FILES = (
    "train-images-idx3-ubyte.gz",
    "train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte.gz",
    "t10k-labels-idx1-ubyte.gz",
)
# Primary + mirror, matching the reference's single-source fetcher but with
# a fallback host; override with MNIST_BASE_URL.
MNIST_BASE_URLS = (
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
)


def fetch_mnist(dest: Optional[Path] = None) -> Path:
    """Download-and-cache the four MNIST IDX archives; returns the directory
    holding them. Raises if the network is unreachable or forbidden."""
    dest = Path(dest) if dest else cache_dir("mnist")
    if all((dest / f).exists() for f in MNIST_FILES):
        return dest
    if not downloads_allowed():
        raise RuntimeError("MNIST download forbidden (DL4J_NO_DOWNLOAD)")
    bases: Sequence[str] = (
        (os.environ["MNIST_BASE_URL"],) if os.environ.get("MNIST_BASE_URL")
        else MNIST_BASE_URLS)
    last_err: Optional[Exception] = None
    for fname in MNIST_FILES:
        path = dest / fname
        if path.exists():
            try:
                _check_gzip(path)
                continue
            except (OSError, EOFError, zlib.error):
                path.unlink()  # corrupt cache entry from an earlier run
        for base in bases:
            url = base.rstrip("/") + "/" + fname
            try:
                # exponential backoff + jitter per mirror, then fall
                # through to the next mirror
                retry_call(
                    lambda u=url: _download_checked(u, path,
                                                    check=_check_gzip),
                    policy=DOWNLOAD_RETRY, on_retry=_warn_retry(url))
                break
            except TRANSIENT_DOWNLOAD_ERRORS as e:
                last_err = e
        else:
            raise RuntimeError(
                f"could not download {fname} from any mirror: {last_err}")
    return dest


def _download_checked(url: str, path: Path,
                      check: Optional[Callable[[Path], None]] = None,
                      sha256: Optional[str] = None) -> None:
    """One download attempt + optional post-check; a corrupt body
    (captive portal, error page, truncated stream) must not poison the
    cache, so the file is unlinked before the failure propagates to the
    retry loop."""
    try:
        download(url, path, sha256=sha256)
        if check is not None:
            check(path)
    except TRANSIENT_DOWNLOAD_ERRORS:
        path.unlink(missing_ok=True)
        raise


def _check_gzip(path: Path) -> None:
    with gzip.open(path, "rb") as f:
        f.read(4)


CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
CIFAR10_SHA256 = ("6d958be074577803d12ecdefd02955f3"
                  "9262c83c16fe9348329d7fe0b5c001ce")


def fetch_cifar10(dest: Optional[Path] = None) -> Path:
    """Download-and-cache CIFAR-10 (python pickle batches); returns the
    extracted `cifar-10-batches-py` directory. Raises when offline."""
    root = Path(dest) if dest else cache_dir("cifar10")
    extracted = root / "cifar-10-batches-py"
    if extracted.is_dir():
        return extracted
    if not downloads_allowed():
        raise RuntimeError("CIFAR-10 download forbidden (DL4J_NO_DOWNLOAD)")
    archive = root / "cifar-10-python.tar.gz"
    url = os.environ.get("CIFAR10_URL", CIFAR10_URL)
    # The sha256 pin applies to the canonical archive; only a genuinely
    # different mirror skips it, and loudly — never silently.
    sha = CIFAR10_SHA256 if url == CIFAR10_URL else None
    if sha is None:
        warnings.warn(
            f"CIFAR10_URL override ({url}): sha256 verification DISABLED "
            "for this download", stacklevel=2)
    retry_call(lambda: _download_checked(url, archive, sha256=sha),
               policy=DOWNLOAD_RETRY, on_retry=_warn_retry(url))
    tmp = root / ".extract.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    try:
        with tarfile.open(archive) as tf:
            tf.extractall(tmp, filter="data")
        (tmp / "cifar-10-batches-py").rename(extracted)
    except (OSError, tarfile.TarError):
        # A corrupt body (captive portal, error page — possible whenever
        # CIFAR10_URL bypasses the sha256 pin) must not poison the cache;
        # anything else (KeyboardInterrupt, real bugs) propagates with
        # the archive intact.
        archive.unlink(missing_ok=True)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return extracted


# ---------------------------------------------------------------------------
# text8 (the reference's Word2Vec tests train on real bundled corpora —
# `Word2VecTests.java`; text8 is the standard public stand-in at scale)
# ---------------------------------------------------------------------------

TEXT8_URLS = (
    "https://mattmahoney.net/dc/text8.zip",
    "https://data.deepai.org/text8.zip",
)


def fetch_text8(dest: Optional[Path] = None) -> Path:
    """Download-and-cache text8 (~31 MB zip, 100 MB of lowercase
    space-separated English).  Returns the path of the extracted file.
    `TEXT8_PATH` points at a pre-downloaded copy (air-gapped hosts);
    raises when offline.  No published SHA-256 exists for the canonical
    host, so the body is validated structurally instead (exact 1e8-byte
    length, a-z/space alphabet)."""
    override = os.environ.get("TEXT8_PATH")
    if override:
        p = Path(override)
        if not p.is_file():
            raise FileNotFoundError(f"TEXT8_PATH={override} does not exist")
        return p
    root = Path(dest) if dest else cache_dir("text8")
    extracted = root / "text8"
    if extracted.is_file():
        return extracted
    if not downloads_allowed():
        raise RuntimeError("text8 download forbidden (DL4J_NO_DOWNLOAD)")
    archive = root / "text8.zip"
    last_err: Exception = RuntimeError("no text8 URL configured")
    for url in TEXT8_URLS:
        try:
            retry_call(lambda u=url: _download_checked(u, archive),
                       policy=DOWNLOAD_RETRY, on_retry=_warn_retry(url))
            break
        except TRANSIENT_DOWNLOAD_ERRORS as e:
            last_err = e
    else:
        raise RuntimeError(f"text8 unreachable: {last_err}")
    try:
        with zipfile.ZipFile(archive) as zf:
            with zf.open("text8") as f:
                head = f.read(4096)
            if not head or not set(head) <= set(b"abcdefghijklmnopqrstuvwxyz "):
                raise ValueError("text8 body failed structural check")
            zf.extract("text8", root)
    except (OSError, EOFError, zlib.error, ValueError, zipfile.BadZipFile):
        archive.unlink(missing_ok=True)
        extracted.unlink(missing_ok=True)
        raise
    if extracted.stat().st_size != 100_000_000:
        size = extracted.stat().st_size
        extracted.unlink()
        raise ValueError(f"text8 wrong size: {size}")
    return extracted


# ---------------------------------------------------------------------------
# LFW (reference LFWDataSetIterator / LFWLoader)
# ---------------------------------------------------------------------------

def fetch_lfw(min_faces_per_person: int = 20, resize: float = 0.4):
    """Labeled Faces in the Wild via sklearn's fetcher (downloads and caches
    under the same cache root). Returns (images [N,H,W,1] float32 in [0,1],
    labels int64, target_names)."""
    if not downloads_allowed():
        raise RuntimeError("LFW download forbidden (DL4J_NO_DOWNLOAD)")
    from sklearn.datasets import fetch_lfw_people

    data = fetch_lfw_people(data_home=str(cache_dir("lfw")),
                            min_faces_per_person=min_faces_per_person,
                            resize=resize)
    imgs = (data.images / 255.0).astype("float32")[..., None]
    return imgs, data.target, data.target_names


# ---------------------------------------------------------------------------
# Curves (reference CurvesDataFetcher.java — S3-hosted synthetic curves)
# ---------------------------------------------------------------------------

def curves_images(n: int = 20000, size: int = 28, seed: int = 0):
    """The 'curves' deep-autoencoder benchmark: images of random smooth
    curves.  The reference downloads a serialized copy from S3; the dataset
    itself is procedurally generated, so here it is generated directly
    (same distribution family: random quadratic Bezier strokes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, 64, dtype=np.float32)[:, None]  # [T,1]
    pts = rng.random((n, 3, 2)).astype(np.float32) * (size - 1)
    # quadratic Bezier: (1-t)^2 P0 + 2t(1-t) P1 + t^2 P2   -> [n, T, 2]
    curve = ((1 - t) ** 2)[None] * pts[:, None, 0] \
        + (2 * t * (1 - t))[None] * pts[:, None, 1] \
        + (t ** 2)[None] * pts[:, None, 2]
    imgs = np.zeros((n, size, size), np.float32)
    xi = np.clip(curve[..., 0].round().astype(int), 0, size - 1)
    yi = np.clip(curve[..., 1].round().astype(int), 0, size - 1)
    ni = np.repeat(np.arange(n), t.shape[0])
    imgs[ni, yi.ravel(), xi.ravel()] = 1.0
    return imgs


def warn_fallback(name: str, reason: str, substitute: str) -> None:
    warnings.warn(
        f"{name}: {reason} — substituting {substitute}. Quality numbers "
        f"from this data are NOT comparable to the real dataset.",
        RuntimeWarning, stacklevel=3)


__all__ = ["CIFAR10_SHA256", "CIFAR10_URL", "DOWNLOAD_RETRY",
           "MNIST_BASE_URLS", "MNIST_FILES", "TEXT8_URLS",
           "TRANSIENT_DOWNLOAD_ERRORS", "cache_dir", "curves_images",
           "download", "downloads_allowed", "fetch_cifar10", "fetch_lfw",
           "fetch_mnist", "fetch_text8", "warn_fallback"]
