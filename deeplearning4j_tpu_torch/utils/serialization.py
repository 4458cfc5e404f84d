"""Object serialization helpers (counterpart of
`deeplearning4j_tpu.utils.serialization`; a copy: numpy and the standard
library only).

Parity: reference `util/SerializationUtils.java` (Java serialization to
file/stream). Model/parameter persistence has its own typed format in
runtime/checkpoint.py; this is the generic object spillway.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any


def save_object(obj: Any, path: os.PathLike) -> None:
    """Atomic pickle write (temp file + rename)."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:  # noqa: BLE001 — cleanup, re-raised
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_object(path: os.PathLike) -> Any:
    with open(os.fspath(path), "rb") as f:
        return pickle.load(f)
