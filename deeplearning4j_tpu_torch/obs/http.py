"""Standalone metrics endpoint for the training plane (counterpart of
`deeplearning4j_tpu.obs.http`).

A training run has no server, so ``train -metrics-port N`` starts this
one: ``GET /metrics`` (the run's registry as Prometheus text),
``GET /healthz`` and, with a recorder attached, ``GET /trace/recent``.
``port=0`` picks a free port.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deeplearning4j_tpu_torch.obs.registry import (
    EXPOSITION_CONTENT_TYPE,
    MetricsRegistry,
)
from deeplearning4j_tpu_torch.obs.trace import TraceRecorder, chrome_trace


class _MetricsHTTPServer(ThreadingHTTPServer):
    allow_reuse_address = True
    daemon_threads = True


class _MetricsHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # silence stderr
        pass

    def _send(self, code: int, ctype: str, data: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802
        registry = self.server.obs_registry  # type: ignore[attr-defined]
        tracer = self.server.obs_tracer      # type: ignore[attr-defined]
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            self._send(200, EXPOSITION_CONTENT_TYPE,
                       registry.exposition().encode())
        elif path == "/healthz":
            self._send(200, "application/json", b'{"ok": true}')
        elif path == "/trace/recent" and tracer is not None:
            traces = tracer.recent()
            if "format=chrome" in query:
                body = json.dumps(chrome_trace(traces)).encode()
            else:
                body = json.dumps({"traces": traces}).encode()
            self._send(200, "application/json", body)
        else:
            self._send(404, "application/json",
                       json.dumps({"error": f"unknown path {path}"})
                       .encode())


class MetricsServer:
    """``MetricsServer(registry, port=0).start()``; ``.url``; ``.stop()``."""

    def __init__(self, registry: MetricsRegistry,
                 host: str = "127.0.0.1", port: int = 0,
                 tracer: Optional[TraceRecorder] = None):
        self._server = _MetricsHTTPServer((host, port), _MetricsHandler)
        self._server.obs_registry = registry  # type: ignore[attr-defined]
        self._server.obs_tracer = tracer      # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="obs-metrics")

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
