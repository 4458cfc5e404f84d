"""HTTP serving front for the LM pool (subset of
`deeplearning4j_tpu.ui.server`).

Endpoints:

- ``POST /lm/generate``  ``{"prompt_ids": [...], "max_new_tokens": N,
  "temperature": t, "seed": s, "deadline_ms": ms, "top_k": k, "top_p": p,
  "beam_size": n, "speculate": bool}`` -> ``{"ids": [...]}`` (the ids
  include the prompt).  Greedy and temperature-only requests share the
  continuous pool; ``beam_size > 1`` runs `beam_search` and answers
  ``{"ids", "score"}``; ``top_k > 0`` or ``top_p < 1`` runs the
  whole-sequence `generate`, seeded from ``seed``.  ``speculate: true``
  is a 400 unless the pool speculates.
- ``GET /serving/stats``  the pool's metrics snapshot.
- ``GET /healthz``        liveness: 200 while the process serves HTTP.
- ``GET /readyz``         readiness: 200 only while the pool admits.

Payload errors are 400; a full queue or a draining server is 503 with
``Retry-After``; a missed deadline is 504.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from deeplearning4j_tpu_torch.parallel.generation import (
    beam_search,
    generate,
)
from deeplearning4j_tpu_torch.serving.lm import (
    ContinuousLMServer,
    validate_request,
)
from deeplearning4j_tpu_torch.serving.resilience import (
    DeadlineExceededError,
    ServingOverloadError,
    ServingUnavailableError,
)


class _UiHTTPServer(ThreadingHTTPServer):
    """SO_REUSEADDR, so a stopped server's port can be re-bound at once,
    and daemon handler threads, so a wedged client cannot hold the
    process open."""

    allow_reuse_address = True
    daemon_threads = True


class _UiState:
    def __init__(self):
        self.lock = threading.Lock()
        self.lm_server: Optional[ContinuousLMServer] = None
        self.draining = False
        self.created = time.monotonic()

    def serving_stats(self) -> dict:
        with self.lock:
            lm_server = self.lm_server
        return {"lm": lm_server.stats() if lm_server else None,
                "uptime_s": round(time.monotonic() - self.created, 3),
                "snapshot_at": time.monotonic()}


class _Handler(BaseHTTPRequestHandler):

    def log_message(self, fmt, *args):  # silence per-request stderr lines
        pass

    @property
    def state(self) -> _UiState:
        return self.server.ui_state  # type: ignore[attr-defined]

    def _json(self, code: int, payload, headers: Optional[dict] = None):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802
        s = self.state
        path = self.path.partition("?")[0]
        if path == "/serving/stats":
            self._json(200, s.serving_stats())
        elif path == "/healthz":
            self._json(200, {"ok": True})
        elif path == "/readyz":
            with s.lock:
                lm_server, draining = s.lm_server, s.draining
            reasons = []
            if draining:
                reasons.append("draining")
            if lm_server is not None and not lm_server.ready():
                reasons.append("lm server not ready")
            if reasons:
                self._json(503, {"ready": False, "reasons": reasons},
                           headers={"Retry-After": 1})
            else:
                self._json(200, {"ready": True})
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/lm/generate":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length)) if length else {}
        except ValueError as e:
            self._json(400, {"error": f"malformed JSON body: {e}"})
            return
        try:
            self._lm_generate(body)
        except DeadlineExceededError as e:
            self._json(504, {"error": str(e)})
        except (ServingOverloadError, ServingUnavailableError) as e:
            retry = max(1, math.ceil(getattr(e, "retry_after_s", 1.0)))
            self._json(503, {"error": str(e), "retry_after_s": retry},
                       headers={"Retry-After": retry})
        except (ValueError, TypeError) as e:
            self._json(400, {"error": str(e)})

    def _lm_generate(self, body: Any) -> None:
        s = self.state
        with s.lock:
            lm_server, draining = s.lm_server, s.draining
        if lm_server is None:
            if draining:
                raise ServingUnavailableError(
                    "server stopped: LM unregistered")
            raise ValueError("no LM registered: call "
                             "UiServer.serve_lm(cfg, params)")
        if not isinstance(body, dict):
            raise ValueError("the request body must be a JSON object")
        prompt = body.get("prompt_ids")
        if not prompt:
            raise ValueError("prompt_ids required")
        max_new = int(body.get("max_new_tokens", 32))
        temperature = float(body.get("temperature", 0.0))
        seed = int(body.get("seed", 0)) & 0x7FFFFFFF
        beams = int(body.get("beam_size", 0))
        top_k = int(body.get("top_k", 0))
        top_p = float(body.get("top_p", 1.0))
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if bool(body.get("speculate", False)):
            # a client asking for speculation on a pool that cannot give
            # it gets a 400 naming why, not a different plan in silence;
            # a sampled request on a speculating pool is not an error
            if lm_server.kv != "paged":
                raise ValueError(
                    "speculate requested but the pool serves kv='dense': "
                    "speculative rollback requires the paged KV plane "
                    "(serve with -lm-kv paged)")
            if lm_server.speculate == "off":
                raise ValueError(
                    "speculate requested but the pool was started with "
                    "speculation off (serve with -lm-speculate "
                    "ngram|model)")
        deadline_s = None
        if body.get("deadline_ms") is not None:
            ms = float(body["deadline_ms"])
            if not math.isfinite(ms) or ms <= 0:
                raise ValueError(f"deadline_ms must be a positive finite "
                                 f"number, got {body['deadline_ms']!r}")
            deadline_s = ms / 1e3
        try:
            ids = validate_request(lm_server.cfg, prompt, max_new)
        except ValueError as e:
            payload = {"error": str(e)}
            if "max_len" in str(e):
                payload["max_len"] = lm_server.cfg.max_len
            self._json(400, payload)
            return
        cfg, params, dev = lm_server.cfg, lm_server.params, lm_server.device
        if beams > 1:
            toks, scores = beam_search(cfg, params, [ids], max_new,
                                       beam_size=beams, device=dev)
            self._json(200, {"ids": toks[0].tolist(),
                             "score": float(scores[0])})
        elif top_k > 0 or top_p < 1.0:
            toks = generate(cfg, params, [ids], max_new,
                            temperature=temperature, seed=seed, top_k=top_k,
                            top_p=top_p, device=dev)
            self._json(200, {"ids": toks[0].tolist()})
        else:
            # the continuous pool: the request shares its dispatches with
            # whatever else is decoding
            out = lm_server.generate(ids, max_new, temperature=temperature,
                                     seed=seed, deadline_s=deadline_s)
            self._json(200, {"ids": out})


class UiServer:
    """`UiServer(port=0).serve_lm(cfg, params).start()`; `.url` for
    clients; `.stop()` to halt."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8080):
        self._server = _UiHTTPServer((host, port), _Handler)
        self._server.ui_state = _UiState()  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def state(self) -> _UiState:
        return self._server.ui_state  # type: ignore[attr-defined]

    def serve_lm(self, cfg, params, slots: int = 4,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 kv: str = "paged", page_size: int = 16,
                 pages: Optional[int] = None, prefill_chunk: int = 8,
                 speculate: str = "off", draft_len: int = 4,
                 device=None) -> "UiServer":
        """Register a transformer LM for ``POST /lm/generate``, decoded by
        a `slots`-lane continuous pool over a paged or dense KV cache on
        `device` (None = the card), speculating when `speculate` is
        "ngram" or "model"."""
        lm_server = ContinuousLMServer(
            cfg, params, slots=slots, max_queue_depth=max_queue_depth,
            default_deadline_s=default_deadline_s, kv=kv,
            page_size=page_size, pages=pages, prefill_chunk=prefill_chunk,
            speculate=speculate, draft_len=draft_len, device=device)
        with self.state.lock:
            old = self.state.lm_server
            self.state.lm_server = lm_server
        if old is not None:
            old.stop()
        return self

    def start(self) -> "UiServer":
        self._thread.start()
        return self

    def serving_stats(self) -> dict:
        return self.state.serving_stats()

    def begin_drain(self) -> None:
        """Stop admission: new requests get 503 and /readyz flips, while
        queued and in-flight work keeps running."""
        with self.state.lock:
            self.state.draining = True
            lm_server = self.state.lm_server
        if lm_server is not None:
            lm_server.begin_drain()

    def drain(self, grace_s: float = 5.0) -> bool:
        """Graceful drain; True when the pool fully drained in time."""
        self.begin_drain()
        with self.state.lock:
            lm_server = self.state.lm_server
        return lm_server.drain(grace_s) if lm_server is not None else True

    def stop(self) -> None:
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()
        with self.state.lock:
            self.state.draining = True
            lm_server, self.state.lm_server = self.state.lm_server, None
        if lm_server is not None:
            lm_server.stop()


__all__ = ["UiServer"]
