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
  is a 400 unless the pool speculates.  ``priority`` (interactive,
  batch, best_effort) and ``session_id`` ride the pool's request.
  ``tenant`` (the JSON field, else the ``X-Tenant`` header) is checked
  before any decode leg runs: with no tenant registry (A4.6) only
  "default" is served, anything else is a 400.  ``stream: true`` is a
  400 (SSE streaming is A4.9), as it is with beams, top-k or top-p.
- ``POST /lm/prefill``  the same body -> the lane's KV page shipment
  (binary, `serving/transfer.py` frame) at prefill completion; 422 with
  ``"kind": "page_ship"`` when the pool does not ship.
- ``POST /lm/admit_pages``  a shipment in (binary) -> ``{"ids": [...]}``;
  a frame that fails its integrity or geometry checks is a 422 with
  ``"kind": "page_ship"`` (recompute locally).
- ``GET /serving/stats``  the pool's metrics snapshot.
- ``GET /healthz``        liveness: 200 while the process serves HTTP.
- ``GET /readyz``         readiness: 200 only while the pool admits.

Payload errors are 400; a full queue, a brownout shed or a draining
server is 503 with ``Retry-After``; a missed deadline is 504.
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
    check_tenant,
    validate_request,
)
from deeplearning4j_tpu_torch.serving.pressure import normalize_priority
from deeplearning4j_tpu_torch.serving.resilience import (
    DeadlineExceededError,
    ServingOverloadError,
    ServingUnavailableError,
)
from deeplearning4j_tpu_torch.serving.transfer import (
    PageShipError,
    deserialize_export,
    serialize_export,
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

    def _send(self, code: int, ctype: str, data: bytes,
              headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, code: int, payload, headers: Optional[dict] = None):
        self._send(code, "application/json", json.dumps(payload).encode(),
                   headers)

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
        routes = {"/lm/generate": self._lm_generate,
                  "/lm/prefill": self._lm_prefill,
                  "/lm/admit_pages": self._lm_admit_pages}
        route = routes.get(self.path)
        if route is None:
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length) if length else b""
            # a page shipment is binary; the other bodies are JSON
            body = (data if self.path == "/lm/admit_pages"
                    else json.loads(data) if data else {})
        except ValueError as e:
            self._json(400, {"error": f"malformed JSON body: {e}"})
            return
        try:
            route(body)
        except PageShipError as e:
            self._json(422, {"error": str(e), "kind": "page_ship"})
        except DeadlineExceededError as e:
            self._json(504, {"error": str(e)})
        except (ServingOverloadError, ServingUnavailableError) as e:
            retry = max(1, math.ceil(getattr(e, "retry_after_s", 1.0)))
            self._json(503, {"error": str(e), "retry_after_s": retry},
                       headers={"Retry-After": retry})
        except (ValueError, TypeError) as e:
            self._json(400, {"error": str(e)})

    def _lm_server(self) -> ContinuousLMServer:
        """The registered pool; a stopped server is 503, none is 400."""
        s = self.state
        with s.lock:
            lm_server, draining = s.lm_server, s.draining
        if lm_server is None:
            if draining:
                raise ServingUnavailableError(
                    "server stopped: LM unregistered")
            raise ValueError("no LM registered: call "
                             "UiServer.serve_lm(cfg, params)")
        return lm_server

    @staticmethod
    def _session_id(body: dict) -> Optional[str]:
        """The body's ``session_id``: a string or int of 1..128
        characters, else the client's 400."""
        sid = body.get("session_id")
        if sid is None:
            return None
        if not isinstance(sid, (str, int)):
            raise ValueError(f"session_id must be a string or int, got "
                             f"{type(sid).__name__}")
        sid = str(sid)
        if not 0 < len(sid) <= 128:
            raise ValueError("session_id must be 1..128 characters")
        return sid

    def _tenant(self, body: dict) -> Optional[str]:
        """The request's tenant: the JSON ``tenant`` field, else the
        ``X-Tenant`` header; None when neither names one.  A string or int
        of 1..128 characters, else the client's 400."""
        tn = body.get("tenant")
        if tn is None:
            tn = self.headers.get("X-Tenant")
        if tn is None:
            return None
        if not isinstance(tn, (str, int)):
            raise ValueError(
                f"tenant must be a string, got {type(tn).__name__}")
        tn = str(tn)
        if not 0 < len(tn) <= 128:
            raise ValueError("tenant must be 1..128 characters")
        return tn

    @staticmethod
    def _deadline_s(body: dict) -> Optional[float]:
        if body.get("deadline_ms") is None:
            return None
        ms = float(body["deadline_ms"])
        if not math.isfinite(ms) or ms <= 0:
            raise ValueError(f"deadline_ms must be a positive finite "
                             f"number, got {body['deadline_ms']!r}")
        return ms / 1e3

    def _lm_prefill(self, body: Any) -> None:
        """The prefill half of disaggregation: normal admission and
        chunked prefill, answered with the lane's page shipment."""
        lm_server = self._lm_server()
        if not isinstance(body, dict):
            raise ValueError("the request body must be a JSON object")
        prompt = body.get("prompt_ids")
        if not prompt:
            raise ValueError("prompt_ids required")
        if lm_server.kv != "paged" or not lm_server.ship:
            # "this pool cannot ship" is told apart from "this request
            # is bad everywhere" by the kind, not by the error text
            self._json(422, {"error": "this worker does not ship KV "
                                      "pages (started without -lm-ship "
                                      "or with dense KV)",
                             "kind": "page_ship"})
            return
        export = lm_server.prefill_export(
            prompt, int(body.get("max_new_tokens", 32)),
            temperature=float(body.get("temperature", 0.0)),
            seed=int(body.get("seed", 0)) & 0x7FFFFFFF,
            deadline_s=self._deadline_s(body),
            session_id=self._session_id(body),
            priority=body.get("priority"), tenant=self._tenant(body))
        self._send(200, "application/octet-stream",
                   serialize_export(export))

    def _lm_admit_pages(self, data: bytes) -> None:
        """The decode half: a binary page shipment in, ``{"ids"}`` out."""
        lm_server = self._lm_server()
        ids = lm_server.admit_with_pages(deserialize_export(data))
        self._json(200, {"ids": ids})

    def _lm_generate(self, body: Any) -> None:
        lm_server = self._lm_server()
        if not isinstance(body, dict):
            raise ValueError("the request body must be a JSON object")
        prompt = body.get("prompt_ids")
        if not prompt:
            raise ValueError("prompt_ids required")
        # validated here, so an unknown class or a bad session is a 400
        # on every decode path
        priority = normalize_priority(body.get("priority"))
        session_id = self._session_id(body)
        # checked before any leg runs, so the whole-sequence legs refuse
        # an unknown tenant as the pool does
        tenant = self._tenant(body)
        check_tenant(tenant)
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
        if bool(body.get("stream", False)):
            if beams > 1 or top_k > 0 or top_p < 1.0:
                raise ValueError(
                    "stream requires the continuous greedy/temperature "
                    "path: top-k/top-p/beam decode whole-sequence and "
                    "cannot stream")
            # a client asking for a stream gets a 400 naming why, not a
            # buffered answer in another content type
            raise ValueError(
                "stream requested but SSE streaming is not ported yet "
                "(ROADMAP item A4.9); send stream: false for one JSON "
                "answer")
        deadline_s = self._deadline_s(body)
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
                                     seed=seed, deadline_s=deadline_s,
                                     session_id=session_id,
                                     priority=priority, tenant=tenant)
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
                 ship: bool = False, preempt: bool = False,
                 swap_bytes: int = 64 << 20, brownout=None,
                 hibernate_idle_s: Optional[float] = None,
                 state_dir: Optional[str] = None,
                 state_disk_bytes: int = 1 << 30,
                 swap_quantize: bool = True,
                 device=None) -> "UiServer":
        """Register a transformer LM for ``POST /lm/generate``, decoded by
        a `slots`-lane continuous pool over a paged or dense KV cache on
        `device` (None = the card), speculating when `speculate` is
        "ngram" or "model".  `ship` answers ``/lm/prefill`` and
        ``/lm/admit_pages``; `preempt`/`swap_bytes`, `brownout`,
        `hibernate_idle_s`/`state_dir`/`state_disk_bytes` and
        `swap_quantize` are the pool's page-mobility planes
        (`ContinuousLMServer`)."""
        lm_server = ContinuousLMServer(
            cfg, params, slots=slots, max_queue_depth=max_queue_depth,
            default_deadline_s=default_deadline_s, kv=kv,
            page_size=page_size, pages=pages, prefill_chunk=prefill_chunk,
            speculate=speculate, draft_len=draft_len, ship=ship,
            preempt=preempt, swap_bytes=swap_bytes, brownout=brownout,
            hibernate_idle_s=hibernate_idle_s, state_dir=state_dir,
            state_disk_bytes=state_disk_bytes, swap_quantize=swap_quantize,
            device=device)
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
