"""ctypes bindings for the native data-IO library, ``dataio.cpp``
(counterpart of `deeplearning4j_tpu.native`; the port keeps its own copy
of the C++ source).

On first use ``g++`` builds the library into ``_kernels_build/`` beside
the CUDA kernels (listed in ``.gitignore``), named by a digest of the
source and the flags as `_build` names the kernel libraries, so an
edited source is never served by a stale library; nothing is built next
to the source.  With no compiler, `have_native()` is False,
`BUILD_ERROR` says why, and `datasets.fetchers` reads CSV and SVMLight
with its Python parsers (the JAX package's rule: this is host parsing
whose results equal the numpy readers').  `READS` counts the calls that
parsed a file natively, by reader.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "dataio.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

BUILD_ERROR: Optional[str] = None
READS: collections.Counter = collections.Counter()
_lib = None
_lock = threading.Lock()


class _Table(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_double)),
        ("labels", ctypes.POINTER(ctypes.c_double)),
        ("rows", ctypes.c_int64),
        ("cols", ctypes.c_int64),
        ("ok", ctypes.c_int32),
        ("err", ctypes.c_char * 256),
    ]


def library_path() -> pathlib.Path:
    """Where the built library lives: keyed by the source and flags."""
    from deeplearning4j_tpu_torch._build import BUILD_DIR

    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdataio-{digest[:16]}.so"


def _build(path: pathlib.Path) -> Optional[str]:
    """Compile the library to `path` (a temporary file, then an atomic
    rename); an error string on failure."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found"
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return f"g++ failed: {proc.stderr[-500:]}"
        os.replace(tmp, path)
        return None
    except (OSError, subprocess.SubprocessError) as e:
        return f"build error: {e}"
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, BUILD_ERROR
    with _lock:
        if _lib is not None or BUILD_ERROR is not None:
            return _lib
        path = library_path()
        if not path.is_file():
            BUILD_ERROR = _build(path)
            if BUILD_ERROR:
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            BUILD_ERROR = f"dlopen failed: {e}"
            return None
        lib.csv_read.restype = ctypes.POINTER(_Table)
        lib.csv_read.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                 ctypes.c_int32]
        lib.svmlight_read.restype = ctypes.POINTER(_Table)
        lib.svmlight_read.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.idx_read.restype = ctypes.POINTER(_Table)
        lib.idx_read.argtypes = [ctypes.c_char_p]
        lib.table_free.restype = None
        lib.table_free.argtypes = [ctypes.POINTER(_Table)]
        _lib = lib
        return lib


def have_native() -> bool:
    """True when the library is built (building it on first call)."""
    return _load() is not None


def _take(tbl) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    t = tbl.contents
    if not t.ok:
        err = t.err.decode(errors="replace")
        _lib.table_free(tbl)
        raise ValueError(f"native parse failed: {err}")
    rows, cols = int(t.rows), int(t.cols)
    data = np.ctypeslib.as_array(t.data, shape=(rows, cols)).copy()
    labels = None
    if t.labels:
        labels = np.ctypeslib.as_array(t.labels, shape=(rows,)).copy()
    _lib.table_free(tbl)
    return data, labels


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native unavailable: {BUILD_ERROR}")
    return lib


def csv_read(path: str, skip_header: bool = False,
             label_col: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """(features [n, d], labels [n]), float64, the label column taken
    out."""
    out = _take(_require().csv_read(os.fsencode(path), int(skip_header),
                                    int(label_col)))
    READS["csv_read"] += 1
    return out


def svmlight_read(path: str, num_features: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(dense features [n, d], labels [n]), float64; 0 features = infer
    the count."""
    out = _take(_require().svmlight_read(os.fsencode(path),
                                         int(num_features)))
    READS["svmlight_read"] += 1
    return out


def idx_read(path: str) -> np.ndarray:
    """An IDX (MNIST) unsigned-byte tensor as [n, prod(dims)] float64."""
    data, _ = _take(_require().idx_read(os.fsencode(path)))
    READS["idx_read"] += 1
    return data


__all__ = ["BUILD_ERROR", "READS", "csv_read", "have_native", "idx_read",
           "library_path", "svmlight_read"]
