"""Disk-backed FIFO queue (counterpart of
`deeplearning4j_tpu.utils.disk_queue`; a copy: numpy and the standard
library only).

Parity: reference `util/DiskBasedQueue.java` (205 LoC — spills queued items
to disk so unbounded work queues don't exhaust heap; used by the scaleout
runtimes to buffer pending jobs).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import uuid
from collections import deque
from typing import Any, Optional


class DiskBasedQueue:
    def __init__(self, directory: Optional[str] = None):
        self._own_dir = directory is None
        self.dir = directory or tempfile.mkdtemp(prefix="dl4j-queue-")
        os.makedirs(self.dir, exist_ok=True)
        self._order: deque = deque()
        self._lock = threading.Lock()

    def add(self, item: Any) -> None:
        name = f"{len(self._order):012d}-{uuid.uuid4().hex}.pkl"
        path = os.path.join(self.dir, name)
        with open(path, "wb") as f:
            pickle.dump(item, f, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._order.append(path)

    put = add

    def poll(self) -> Any:
        """Remove and return the head; raises IndexError when empty."""
        with self._lock:
            path = self._order.popleft()
        with open(path, "rb") as f:
            item = pickle.load(f)
        os.remove(path)
        return item

    def peek(self) -> Any:
        with self._lock:
            path = self._order[0]
        with open(path, "rb") as f:
            return pickle.load(f)

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)

    def empty(self) -> bool:
        return len(self) == 0

    def close(self) -> None:
        if self._own_dir:
            shutil.rmtree(self.dir, ignore_errors=True)
        self._order.clear()

    def __enter__(self) -> "DiskBasedQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
