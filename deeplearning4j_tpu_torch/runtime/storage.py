"""Remote storage tier (counterpart of `deeplearning4j_tpu.runtime.storage`):
URL-addressed object stores for checkpoints, models and datasets.

Parity: the reference's remote-IO stack — HDFS utilities
(`deeplearning4j-hadoop/.../hadoop/util/HdfsUtils.java:467`), the S3
dataset/model tier (`deeplearning4j-aws/.../aws/s3/uploader/S3Uploader.java`,
`S3ModelSaver`, `BaseS3DataSetIterator`).  A small scheme-dispatched
object-store SPI:

- `file://` (or bare paths)  — local disk
- `memory://`                — in-process fake bucket (tests)
- `gs:// s3:// hdfs:// ...`  — any scheme fsspec resolves, when fsspec
                               is importable (gated, not required)

Every store exposes bytes-level ops plus dir sync; the checkpoint and
model helpers sit on the port's `runtime/checkpoint.py`, and the dataset
helper on its `datasets/fetchers.py`, so a training job points a
checkpoint at `gs://bucket/run42` as it would at a local path.  In a
job of several processes every process uploads its own per-host shard
files, a barrier waits for all of them, and only then does process 0
upload ``COMMIT``, as the JAX package orders it.
"""

from __future__ import annotations

import os
import pathlib
import posixpath
import shutil
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple
from urllib.parse import urlsplit


class Store:
    """Object-store SPI (reference HdfsUtils/S3Uploader surface)."""

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        """Immediate children names (files and 'dirs')."""
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    # -- derived helpers ----------------------------------------------------

    def upload_file(self, local: os.PathLike, path: str) -> None:
        self.write_bytes(path, pathlib.Path(local).read_bytes())

    def download_file(self, path: str, local: os.PathLike) -> None:
        local = pathlib.Path(local)
        local.parent.mkdir(parents=True, exist_ok=True)
        local.write_bytes(self.read_bytes(path))

    def upload_dir(self, local: os.PathLike, path: str) -> int:
        """Recursively mirror a local directory; returns files copied."""
        local = pathlib.Path(local)
        n = 0
        for f in sorted(local.rglob("*")):
            if f.is_file():
                rel = f.relative_to(local).as_posix()
                self.upload_file(f, posixpath.join(path, rel))
                n += 1
        return n

    def download_dir(self, path: str, local: os.PathLike) -> int:
        local = pathlib.Path(local)
        n = 0
        for rel in self._walk(path):
            self.download_file(posixpath.join(path, rel), local / rel)
            n += 1
        return n

    def _walk(self, path: str, prefix: str = "") -> Iterator[str]:
        for name in self.listdir(path):
            child = posixpath.join(path, name)
            rel = posixpath.join(prefix, name) if prefix else name
            if self._is_file(child):
                yield rel
            else:
                yield from self._walk(child, rel)

    def _is_file(self, path: str) -> bool:
        raise NotImplementedError


class LocalStore(Store):
    def _p(self, path: str) -> pathlib.Path:
        return pathlib.Path(path)

    def read_bytes(self, path: str) -> bytes:
        return self._p(path).read_bytes()

    def write_bytes(self, path: str, data: bytes) -> None:
        p = self._p(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=p.parent)
        try:
            os.write(fd, data)
            os.close(fd)
            os.replace(tmp, p)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def exists(self, path: str) -> bool:
        return self._p(path).exists()

    def listdir(self, path: str) -> List[str]:
        p = self._p(path)
        return sorted(c.name for c in p.iterdir()) if p.is_dir() else []

    def delete(self, path: str) -> None:
        p = self._p(path)
        if p.is_dir():
            shutil.rmtree(p)
        elif p.exists():
            p.unlink()

    def _is_file(self, path: str) -> bool:
        return self._p(path).is_file()


class MemoryStore(Store):
    """In-process fake bucket — the test double for the remote tier (plays
    the role MiniDFSCluster/localstack play for the reference's HDFS/S3)."""

    _buckets: Dict[str, Dict[str, bytes]] = {}

    def __init__(self, bucket: str = "default"):
        self.blobs = self._buckets.setdefault(bucket, {})

    def read_bytes(self, path: str) -> bytes:
        if path not in self.blobs:
            raise FileNotFoundError(path)
        return self.blobs[path]

    def write_bytes(self, path: str, data: bytes) -> None:
        self.blobs[path] = bytes(data)

    def exists(self, path: str) -> bool:
        prefix = path.rstrip("/") + "/"
        return path in self.blobs or any(
            k.startswith(prefix) for k in self.blobs)

    def listdir(self, path: str) -> List[str]:
        prefix = path.rstrip("/") + "/" if path else ""
        names = set()
        for k in self.blobs:
            if k.startswith(prefix):
                names.add(k[len(prefix):].split("/")[0])
        return sorted(names)

    def delete(self, path: str) -> None:
        prefix = path.rstrip("/") + "/"
        for k in [k for k in self.blobs
                  if k == path or k.startswith(prefix)]:
            del self.blobs[k]

    def _is_file(self, path: str) -> bool:
        return path in self.blobs

    @classmethod
    def reset(cls) -> None:
        cls._buckets.clear()


class FsspecStore(Store):
    """gs:// s3:// hdfs:// ... via fsspec when the optional dependency is
    present (gcsfs/s3fs provide the protocol implementations on a real
    deployment; this image does not ship them)."""

    def __init__(self, scheme: str):
        try:
            import fsspec
            self.fs = fsspec.filesystem(scheme)
        except ImportError as e:
            raise RuntimeError(
                f"scheme {scheme!r} needs the optional fsspec package plus "
                f"its protocol driver (gcsfs/s3fs) on the deployment image"
            ) from e
        except ValueError as e:
            raise RuntimeError(
                f"no fsspec driver for scheme {scheme!r}: {e}") from e
        self.scheme = scheme

    def _full(self, path: str) -> str:
        return f"{self.scheme}://{path}"

    def read_bytes(self, path: str) -> bytes:
        with self.fs.open(self._full(path), "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        with self.fs.open(self._full(path), "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return self.fs.exists(self._full(path))

    def listdir(self, path: str) -> List[str]:
        return sorted(posixpath.basename(p.rstrip("/"))
                      for p in self.fs.ls(self._full(path), detail=False))

    def delete(self, path: str) -> None:
        self.fs.rm(self._full(path), recursive=True)

    def _is_file(self, path: str) -> bool:
        return self.fs.isfile(self._full(path))


def get_store(url: str) -> Tuple[Store, str]:
    """Resolve a URL to (store, path-within-store). Bare paths and
    file:// map to LocalStore; memory://bucket/... to the fake bucket."""
    parts = urlsplit(url)
    if parts.scheme in ("", "file"):
        path = parts.path if parts.scheme else url
        return LocalStore(), path
    if parts.scheme == "memory":
        return MemoryStore(parts.netloc or "default"), parts.path.lstrip("/")
    store = FsspecStore(parts.scheme)
    return store, (parts.netloc + parts.path)


# ---------------------------------------------------------------------------
# checkpoint / model / dataset integration
# ---------------------------------------------------------------------------

def save_checkpoint_remote(url: str, step: int, params, updater_state=None,
                           extra: Optional[dict] = None) -> str:
    """save_checkpoint into a temp dir, then mirror to `url/ckpt-{step}`.
    The COMMIT marker would go up in upload_dir's sorted walk among the
    shards (uppercase sorts first), so it is held back and uploaded
    last: a reader never sees a committed, half-written checkpoint.  In
    a job of several processes each process's temp dir holds its own
    shard files (COMMIT and meta.json only on process 0): every process
    uploads, a barrier waits for all, then process 0 uploads COMMIT, and
    a second barrier returns them together."""
    from deeplearning4j_tpu_torch.parallel.mesh import sync_processes
    from deeplearning4j_tpu_torch.runtime import checkpoint as ckpt_lib

    store, base = get_store(url)
    with tempfile.TemporaryDirectory() as tmp:
        local = ckpt_lib.save_checkpoint(tmp, step, params,
                                         updater_state=updater_state,
                                         extra=extra, keep=0)
        commit = local / "COMMIT"
        commit_data = commit.read_bytes() if commit.exists() else None
        if commit_data is not None:
            commit.unlink()
        dest = posixpath.join(base, f"ckpt-{step}")
        store.upload_dir(local, dest)
        # every process's shards are up before the marker goes up
        sync_processes(f"remote-ckpt-{step}-uploaded")
        if commit_data is not None:
            store.write_bytes(posixpath.join(dest, "COMMIT"), commit_data)
        sync_processes(f"remote-ckpt-{step}-committed")
    return posixpath.join(url.rstrip("/"), f"ckpt-{step}")


def latest_checkpoint_remote(url: str) -> Optional[int]:
    import re

    store, base = get_store(url)
    best = None
    for name in store.listdir(base):
        m = re.fullmatch(r"ckpt-(\d+)", name)
        if m and store.exists(posixpath.join(base, name, "COMMIT")):
            step = int(m.group(1))
            best = step if best is None else max(best, step)
    return best


def load_checkpoint_remote(url: str, params_like, updater_like=None,
                           step: Optional[int] = None):
    """Returns (step, params, updater_state, extra) — download to a temp
    dir, then reuse the local loader."""
    from deeplearning4j_tpu_torch.runtime import checkpoint as ckpt_lib

    store, base = get_store(url)
    if step is None:
        step = latest_checkpoint_remote(url)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {url}")
    with tempfile.TemporaryDirectory() as tmp:
        dest = pathlib.Path(tmp) / f"ckpt-{step}"
        store.download_dir(posixpath.join(base, f"ckpt-{step}"), dest)
        return ckpt_lib.load_checkpoint(tmp, params_like,
                                        updater_like=updater_like, step=step)


class RemoteModelSaver:
    """ModelSaver writing to any store URL (reference S3ModelSaver)."""

    def __init__(self, url: str):
        self.url = url

    def save(self, net) -> None:
        from deeplearning4j_tpu_torch.runtime import checkpoint as ckpt_lib

        store, base = get_store(self.url)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt_lib.save_model(net, tmp)
            store.upload_dir(tmp, base)


def load_model_remote(url: str, device=None):
    """A `MultiLayerNetwork` on `device` (the card unless the caller asks
    for the CPU) from a model directory under `url`."""
    from deeplearning4j_tpu_torch.runtime import checkpoint as ckpt_lib

    store, base = get_store(url)
    with tempfile.TemporaryDirectory() as tmp:
        store.download_dir(base, tmp)
        return ckpt_lib.load_model(tmp, device=device)


def open_remote(url: str, cache: Optional[os.PathLike] = None,
                refresh: bool = False) -> pathlib.Path:
    """Materialize a remote file locally and return its path — the bridge
    that lets csv_dataset/svmlight_dataset read from any store (reference
    BaseS3DataSetIterator pattern).  Downloads land in a download-through
    cache keyed by a hash of the FULL URL (distinct remote paths never
    collide; one copy per URL, reused across calls — repeated training
    loops don't re-fetch or leak temp dirs).  Pass refresh=True to force
    a re-download when the remote object may have changed."""
    import hashlib

    store, path = get_store(url)
    if isinstance(store, LocalStore):
        return pathlib.Path(path)
    cache = pathlib.Path(cache) if cache else pathlib.Path(
        tempfile.gettempdir()) / "dl4j_tpu_remote"
    key = hashlib.sha256(url.encode()).hexdigest()[:16]
    dest = cache / f"{key}-{posixpath.basename(path)}"
    if refresh or not dest.exists():
        store.download_file(path, dest)
    return dest


def remote_dataset(url: str, kind: str = "csv",
                   cache: Optional[os.PathLike] = None,
                   refresh: bool = False, **kwargs):
    """DataSet from a remote CSV/SVMLight file."""
    from deeplearning4j_tpu_torch.datasets import fetchers

    local = open_remote(url, cache=cache, refresh=refresh)
    if kind == "csv":
        return fetchers.csv_dataset(str(local), **kwargs)
    if kind == "svmlight":
        num_features = kwargs.pop("num_features", None) or \
            fetchers.sniff_svmlight_features(str(local))
        return fetchers.svmlight_dataset(str(local), num_features, **kwargs)
    raise ValueError(f"unknown dataset kind {kind!r}")


__all__ = ["FsspecStore", "LocalStore", "MemoryStore", "RemoteModelSaver",
           "Store", "get_store", "latest_checkpoint_remote",
           "load_checkpoint_remote", "load_model_remote", "open_remote",
           "remote_dataset", "save_checkpoint_remote"]
