"""StateTracker served over TCP for multi-host jobs (counterpart of
`deeplearning4j_tpu.scaleout.tracker_server`; the standard library and
numpy only).

Parity: the reference's Hazelcast instance embedded in the master JVM
(`BaseHazelCastStateTracker.java:520` — master embeds, workers connect) and
its Dropwizard REST monitor. Here the coordinator host runs
`StateTrackerServer` wrapping a local `StateTracker`; worker hosts talk to
it through `RemoteStateTracker`, which proxies the same method surface, so
`Master`/`Worker` run unchanged in-process (threads) or across hosts.
Parameter trees cross this socket as host numpy arrays (a performer
publishes host copies; torch tensors are not on the allowlist).

Framing, byte for byte the JAX package's: 4-byte big-endian length +
[HMAC-SHA256 tag when a shared secret is configured] + restricted pickle,
so a client of either package can drive a server of the other with control
calls.  Deserialization is NOT arbitrary: frames are decoded with an
allowlisting Unpickler (builtin containers, numpy arrays, and this
package's job/value classes only), so a reachable port does not hand out
code execution; a `Job` of the other package is refused, as a foreign
global.  Set a shared secret (`secret=` or the DL4J_TRACKER_SECRET env
var, identically on master and workers) to also reject unauthenticated
frames outright.  DL4J_TRACKER_MAX_FRAME caps a frame's length.
"""

from __future__ import annotations

import hashlib
import hmac
import io
import os
import pickle
import socket
import socketserver
import struct
import threading
from typing import Any, Optional, Tuple

from deeplearning4j_tpu_torch.scaleout.statetracker import StateTracker

_ALLOWED = {
    "add_worker", "remove_worker", "workers", "heartbeat", "heartbeats",
    "reap_stale", "enqueue_job", "request_job", "current_jobs",
    "pending_jobs", "clear_job", "add_update", "updates", "drain_updates",
    "clear_updates",
    "set_global", "get_global", "increment", "counter", "finish", "is_done",
    "reset_done", "reset_run_state",
    "saved_work", "load_saved_work",
}

# What may legitimately cross the wire: control tuples, job payloads
# (numpy batches), param trees (containers of numpy arrays), Job records.
# The allowlist is EXACT (module, name) pairs — prefix allowlists would let
# protocol-4 dotted-name lookups reach arbitrary attributes (e.g. a class
# method that writes files) through an allowed module.
_SAFE_GLOBALS = {
    ("builtins", n) for n in (
        "bytearray", "bytes", "complex", "dict", "frozenset", "list",
        "range", "set", "slice", "str", "tuple", "bool", "int", "float")
} | {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    ("collections", "OrderedDict"),
    ("deeplearning4j_tpu_torch.scaleout.api", "Job"),
    ("deeplearning4j_tpu_torch.datasets.dataset", "DataSet"),
}
_TAG_LEN = hashlib.sha256().digest_size
# Frames are buffered in full before the HMAC check, so the length prefix
# must be capped or an unauthenticated peer could claim 4 GiB and exhaust
# memory.  1 GiB default clears any real param tree / job batch; override
# with DL4J_TRACKER_MAX_FRAME.
_MAX_FRAME = int(os.environ.get("DL4J_TRACKER_MAX_FRAME", 1 << 30))


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if "." not in name and (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"tracker frame references disallowed global {module}.{name}")


def _secret_bytes(secret: Optional[str]) -> Optional[bytes]:
    if secret is None:
        secret = os.environ.get("DL4J_TRACKER_SECRET")
    return secret.encode() if secret else None


def _send_frame(sock: socket.socket, obj: Any,
                secret: Optional[bytes] = None) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if secret:
        data = hmac.new(secret, data, hashlib.sha256).digest() + data
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_frame(sock: socket.socket, secret: Optional[bytes] = None) -> Any:
    header = _recv_exact(sock, 4)
    (length,) = struct.unpack(">I", header)
    if length > _MAX_FRAME:
        raise ConnectionError(
            f"tracker frame length {length} exceeds cap {_MAX_FRAME}")
    data = _recv_exact(sock, length)
    if secret:
        if length < _TAG_LEN:
            raise ConnectionError("tracker frame too short for HMAC tag")
        tag, data = data[:_TAG_LEN], data[_TAG_LEN:]
        if not hmac.compare_digest(
                tag, hmac.new(secret, data, hashlib.sha256).digest()):
            raise ConnectionError("tracker frame failed HMAC check")
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("tracker connection closed")
        buf += chunk
    return buf


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        tracker: StateTracker = self.server.tracker  # type: ignore[attr-defined]
        secret: Optional[bytes] = self.server.secret  # type: ignore[attr-defined]
        while True:
            try:
                method, args, kwargs = _recv_frame(self.request, secret)
            except (ConnectionError, EOFError, pickle.UnpicklingError):
                return
            try:
                if method not in _ALLOWED:
                    raise AttributeError(f"no tracker method {method!r}")
                result = getattr(tracker, method)(*args, **kwargs)
                _send_frame(self.request, ("ok", result), secret)
            except Exception as e:  # noqa: BLE001 — proxy the error across
                _send_frame(self.request, ("err", repr(e)), secret)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class StateTrackerServer:
    """Embed a tracker and serve it (master side)."""

    def __init__(self, tracker: Optional[StateTracker] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[str] = None):
        self.tracker = tracker or StateTracker()
        self._server = _Server((host, port), _Handler)
        self._server.tracker = self.tracker  # type: ignore[attr-defined]
        self._server.secret = _secret_bytes(secret)  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address  # type: ignore[return-value]

    def start(self) -> "StateTrackerServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class RemoteStateTracker:
    """Client proxy with the StateTracker method surface (worker side)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 secret: Optional[str] = None):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._lock = threading.Lock()
        self._secret = _secret_bytes(secret)

    def _call(self, method: str, *args, **kwargs) -> Any:
        with self._lock:
            _send_frame(self._sock, (method, args, kwargs), self._secret)
            status, payload = _recv_frame(self._sock, self._secret)
        if status == "err":
            raise RuntimeError(f"tracker error: {payload}")
        return payload

    def close(self) -> None:
        self._sock.close()

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in _ALLOWED:
            raise AttributeError(f"no tracker method {name!r}")

        def proxy(*args, **kwargs):
            return self._call(name, *args, **kwargs)

        return proxy
