"""The UI and serving HTTP front (counterpart of
`deeplearning4j_tpu.ui.server`).

Dashboard and visualization endpoints (the reference's `UiServer.run()`
resources, as JSON):

- ``GET /``                   the dashboard page (the JAX package's bytes)
- ``POST|GET /api/coords``    upload / fetch 2-D coords
- ``POST /tsne/upload``       high-dim vectors + labels;
  ``POST /tsne/generate`` runs exact t-SNE on the device
  (`plot.Tsne`); ``GET /tsne/coords`` fetches the result
- ``POST /nearestneighbors/upload`` labelled vectors;
  ``POST /nearestneighbors`` ``{"word"|"vector", "k"}`` -> knn by VPTree
- ``POST|GET /weights``       the training listener's posts
  (`HistogramIterationListener`); GET answers the count, the last 200
  scores and the last post (1000 kept)
- ``POST|GET /activations``   an activation grid

Classifier serving (`UiServer.serve_model(net)`):

- ``POST /model/predict``  ``{"features": [[...]], "deadline_ms": ms,
  "tenant": t}`` -> ``{"predictions", "outputs"}``; concurrent requests
  coalesce in the `ServingEngine`'s micro-batcher.  No model is a 400,
  a draining or stopped server a 503 ("server stopped: model
  unregistered"), a full queue or open breaker a 503 with
  ``Retry-After``, a tenant over quota a 429, a missed deadline a 504,
  an off-ladder shape a 400.  An untyped failure of these JSON routes is
  a 400 carrying the exception's repr, as on the JAX front.

LM serving (`UiServer.serve_lm(cfg, params)`):

- ``POST /lm/generate``  ``{"prompt_ids": [...], "max_new_tokens": N,
  "temperature": t, "seed": s, "deadline_ms": ms, "top_k": k, "top_p": p,
  "beam_size": n, "speculate": bool, "stream": bool}`` -> ``{"ids": [...]}``
  (the ids include the prompt).  Greedy and temperature-only requests
  share the continuous pool; ``beam_size > 1`` runs `beam_search` and
  answers ``{"ids", "score"}``; ``top_k > 0`` or ``top_p < 1`` runs the
  whole-sequence `generate`, seeded from ``seed``.  ``speculate: true``
  is a 400 unless the pool speculates.  ``priority`` (interactive,
  batch, best_effort) and ``session_id`` ride the pool's request.
  ``tenant`` (the JSON field, else the ``X-Tenant`` header) is checked
  against the pool's tenant registry before any decode leg runs (without
  one only "default" is served); an unknown tenant is a 400 naming the
  vocabulary, a tenant over its quota a 429 with ``Retry-After``.
  ``stream: true`` answers ``text/event-stream``: one ``data:
  {"token", "index"}`` event per committed token, then ``event: done``
  with the full ids (``event: error`` if the decode fails mid-stream); a
  client that disconnects abandons the request.  Streams need the
  continuous greedy/temperature path (beams, top-k, top-p are a 400).
- ``POST /lm/prefill``  the same body -> the lane's KV page shipment
  (binary, `serving/transfer.py` frame) at prefill completion; 422 with
  ``"kind": "page_ship"`` when the pool does not ship.
- ``POST /lm/admit_pages``  a shipment in (binary) -> ``{"ids": [...]}``;
  a frame that fails its integrity or geometry checks is a 422 with
  ``"kind": "page_ship"`` (recompute locally).

Both planes:

- ``GET /serving/stats``  ``{"classifier", "lm", "uptime_s",
  "snapshot_at"}``: each registered plane's metrics snapshot (None when
  absent).
- ``GET /metrics``        Prometheus text of the server's registry (the
  ``plane="classifier"`` and ``plane="lm"`` cells, the per-tenant cells,
  uptime).
- ``GET /trace/recent``   recent request traces (``queue_wait``,
  ``dispatch`` / ``decode`` spans); ``?format=chrome`` gives Chrome
  trace-event JSON.  A request may carry ``X-Request-Id`` (echoed on the
  response, the SSE leg included; minted when absent).
- ``GET /healthz``        liveness: 200 while the process serves HTTP.
- ``GET /readyz``         readiness: 200 only while every registered
  plane admits and no breaker is open.

Failures go through `ServingHTTPMixin.respond_typed_failure`: a full
queue, an open breaker, a brownout shed or a draining server is 503 with
``Retry-After``, a tenant over quota 429 with ``Retry-After``, a missed
deadline 504; payload errors are 400.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.obs.compilewatch import compile_watcher
from deeplearning4j_tpu_torch.obs.registry import (
    EXPOSITION_CONTENT_TYPE,
    MetricsRegistry,
)
from deeplearning4j_tpu_torch.obs.trace import TraceRecorder, chrome_trace
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.parallel.generation import (
    beam_search,
    generate,
    place_params,
)
from deeplearning4j_tpu_torch.serving.lm import (
    ContinuousLMServer,
    validate_request,
)
from deeplearning4j_tpu_torch.serving.pressure import normalize_priority
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker,
    ServingHTTPMixin,
    ServingHTTPServer,
    ServingUnavailableError,
)
from deeplearning4j_tpu_torch.serving.transfer import (
    PageShipError,
    deserialize_export,
    serialize_export,
)


_DASHBOARD = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>deeplearning4j_tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.5rem;background:#fafafa}
 h1{font-size:1.2rem} h2{font-size:1rem;margin:1.2rem 0 .3rem}
 .card{background:#fff;border:1px solid #ddd;border-radius:6px;
       padding:.8rem;margin-bottom:1rem;max-width:720px}
 svg{width:100%;height:220px;background:#fcfcfc;border:1px solid #eee}
 .muted{color:#777;font-size:.85rem}
</style></head><body>
<h1>deeplearning4j_tpu — training dashboard</h1>
<div class="card"><h2>Training score (from /weights posts)</h2>
 <svg id="score" viewBox="0 0 600 220" preserveAspectRatio="none"></svg>
 <div class="muted" id="scoreinfo">waiting for HistogramIterationListener
 posts…</div></div>
<div class="card"><h2>Latest weight histogram</h2>
 <svg id="hist" viewBox="0 0 600 220" preserveAspectRatio="none"></svg>
 <div class="muted" id="histinfo"></div></div>
<div class="card"><h2>t-SNE coords (from /tsne/generate)</h2>
 <svg id="tsne" viewBox="0 0 600 220"></svg></div>
<script>
function poly(el, pts, color){
  el.innerHTML = pts.length >= 2
    ? '<polyline fill="none" stroke="'+color+'" stroke-width="2" points="'
      + pts.map(p=>p.join(',')).join(' ') + '"/>' : '';
}
function scale(vals, lo, hi){
  const mn=Math.min(...vals), mx=Math.max(...vals), r=(mx-mn)||1;
  return vals.map(v=> lo + (v-mn)/r*(hi-lo));
}
async function tick(){
  try{
    const w = await (await fetch('/weights')).json();
    if(w.count){
      document.getElementById('scoreinfo').textContent =
        w.count+' posts; last iteration '+(w.last.iteration??'?')
        +', score '+(w.last.score??'?');
      const scores=(w.history||[]).map(h=>h.score);
      if(scores.length){
        const ys=scale(scores.map(v=>-v),10,210);
        const xs=scale(scores.map((_,i)=>i),10,590);
        poly(document.getElementById('score'), xs.map((x,i)=>[x,ys[i]]),
             '#1669c1');
      }
      try{
        const h = w.last.histograms && Object.entries(w.last.histograms)[0];
        const bins = h && (Array.isArray(h[1].counts)?h[1].counts
                          :(Array.isArray(h[1])?h[1]:null));
        if(bins && bins.length){
          document.getElementById('histinfo').textContent=h[0];
          const bw=580/bins.length, mx=Math.max(...bins)||1;
          document.getElementById('hist').innerHTML = bins.map((c,i)=>
            '<rect x="'+(10+i*bw)+'" y="'+(210-200*c/mx)+'" width="'
            +(bw-1)+'" height="'+(200*c/mx)+'" fill="#52a447"/>').join('');
        }
      }catch(e){/* malformed histogram post must not block t-SNE */}
    }
    const t = await (await fetch('/tsne/coords')).json();
    if(t.coords && t.coords.length){
      const xs=scale(t.coords.map(c=>c[0]),10,590);
      const ys=scale(t.coords.map(c=>c[1]),10,210);
      document.getElementById('tsne').innerHTML = xs.map((x,i)=>
        '<circle cx="'+x+'" cy="'+ys[i]+'" r="3" fill="#c14a16"/>'
      ).join('');
    }
  }catch(e){/* server may not have data yet */}
  setTimeout(tick, 2000);
}
tick();
</script></body></html>
"""


class _UiState:
    def __init__(self, device=None):
        self.lock = threading.Lock()
        # the serving planes publish their cells here (GET /metrics) and
        # record their request traces here (GET /trace/recent)
        self.registry = MetricsRegistry()
        self.tracer = TraceRecorder()
        self.registry.gauge(
            "server_uptime_seconds", "seconds since server construction",
            fn=lambda: self.registry.uptime_s)
        self.registry.register_collector(
            compile_watcher().collector_samples)
        self.device = device           # of /tsne/generate (None = card)
        self.coords: List[List[float]] = []
        self.tsne_vectors: Optional[np.ndarray] = None
        self.tsne_labels: List[str] = []
        self.tsne_coords: List[List[float]] = []
        self.nn_vectors: Optional[np.ndarray] = None
        self.nn_labels: List[str] = []
        self.nn_tree = None
        self.weights_history: List[dict] = []
        self.activations: Optional[List] = None
        self.engine = None             # serving.ServingEngine (serve_model)
        # (cfg, params, device) of serve_lm; the pool is None when
        # continuous=False
        self.lm: Optional[tuple] = None
        self.lm_server: Optional[ContinuousLMServer] = None
        self.draining = False

    def serving_stats(self) -> dict:
        """THE /serving/stats payload, one builder for the HTTP endpoint
        and the drain snapshot."""
        with self.lock:
            engine, lm_server = self.engine, self.lm_server
        return {"classifier": engine.stats() if engine else None,
                "lm": lm_server.stats() if lm_server else None,
                "uptime_s": round(self.registry.uptime_s, 3),
                "snapshot_at": time.monotonic()}


class _Handler(ServingHTTPMixin, BaseHTTPRequestHandler):
    # _send/_json/_deadline_s/_tenant/request_id and the typed-failure ->
    # status mapping come from ServingHTTPMixin

    @property
    def state(self) -> _UiState:
        return self.server.ui_state  # type: ignore[attr-defined]

    def do_GET(self) -> None:  # noqa: N802
        s = self.state
        path, _, query = self.path.partition("?")
        if path in ("/", "/index.html"):
            self._send(200, "text/html; charset=utf-8", _DASHBOARD.encode())
        elif path == "/metrics":
            self._send(200, EXPOSITION_CONTENT_TYPE,
                       s.registry.exposition().encode())
        elif path == "/trace/recent":
            traces = s.tracer.recent()
            if "format=chrome" in query:
                self._json(200, chrome_trace(traces))
            else:
                self._json(200, {"traces": traces,
                                 "recorded": s.tracer.recorded})
        elif path == "/serving/stats":
            self._json(200, s.serving_stats())
        elif path == "/healthz":
            self._json(200, {"ok": True})
        elif path == "/readyz":
            with s.lock:
                engine, lm_server = s.engine, s.lm_server
                draining = s.draining
            reasons = []
            if draining:
                reasons.append("draining")
            if engine is not None and not engine.ready():
                reasons.append("classifier engine not ready")
            if lm_server is not None and not lm_server.ready():
                reasons.append("lm server not ready")
            if reasons:
                self._json(503, {"ready": False, "reasons": reasons},
                           headers={"Retry-After": 1})
            else:
                self._json(200, {"ready": True})
        else:
            self._get_dashboard_state()

    def _get_dashboard_state(self) -> None:
        """The dashboard's JSON GETs (exact paths, as the JAX front
        matches them)."""
        s = self.state
        with s.lock:
            if self.path == "/api/coords":
                self._json(200, {"coords": s.coords})
            elif self.path == "/tsne/coords":
                self._json(200, {"coords": s.tsne_coords,
                                 "labels": s.tsne_labels})
            elif self.path == "/weights":
                hist = [{"iteration": h.get("iteration"),
                         "score": h.get("score")}
                        for h in s.weights_history[-200:]
                        if isinstance(h, dict) and h.get("score") is not None]
                self._json(200, {
                    "count": len(s.weights_history),
                    "history": hist,
                    "last": s.weights_history[-1] if s.weights_history
                    else None})
            elif self.path == "/activations":
                self._json(200, {"activations": s.activations})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        routes = {"/lm/generate": self._lm_generate,
                  "/lm/prefill": self._lm_prefill,
                  "/lm/admit_pages": self._lm_admit_pages}
        route = routes.get(self.path)
        if route is None:
            self._json_post()
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
        except Exception as e:  # noqa: BLE001 — answer the client, keep serving
            if self.respond_typed_failure(e):
                return
            if isinstance(e, (ValueError, TypeError)):
                self._json(400, {"error": str(e)})
            elif self.path == "/lm/admit_pages":
                self._json(500, {"error": repr(e)})
            else:
                # the JAX front's policy: an untyped failure of the
                # decode (a failed dispatch) is a 400, and the server
                # keeps serving
                self._json(400, {"error": repr(e)})

    def _json_post(self) -> None:
        """The classifier and dashboard POSTs, with the JAX front's
        structure: a malformed body is a 400 naming the parse error; a
        typed serving failure maps to its status; any other failure is a
        400 carrying its repr, and the server keeps serving."""
        try:
            body = self._body()
        except ValueError as e:           # JSONDecodeError is a ValueError
            self._json(400, {"error": str(e)})
            return
        try:
            self._route_post(body)
        except Exception as e:  # noqa: BLE001 — surface as 400, keep serving
            if not self.respond_typed_failure(e):
                self._json(400, {"error": repr(e)})

    def _route_post(self, body: Any) -> None:
        s = self.state
        if self.path == "/api/coords":
            with s.lock:
                s.coords = body["coords"]
            self._json(200, {"count": len(s.coords)})
        elif self.path == "/tsne/upload":
            with s.lock:
                s.tsne_vectors = np.asarray(body["vectors"], np.float32)
                s.tsne_labels = body.get("labels",
                                         [str(i) for i in
                                          range(len(s.tsne_vectors))])
            self._json(200, {"count": len(s.tsne_vectors)})
        elif self.path == "/tsne/generate":
            from deeplearning4j_tpu_torch.plot import Tsne

            with s.lock:
                vectors = s.tsne_vectors
            if vectors is None:
                self._json(400, {"error": "upload vectors first"})
                return
            tsne = Tsne(
                perplexity=float(body.get("perplexity", 30.0)),
                n_iter=int(body.get("iterations", 300)),
                learning_rate=float(body.get("learning_rate", 100.0)),
                device=s.device)
            coords = tsne.calculate(vectors).tolist()
            with s.lock:
                s.tsne_coords = coords
            self._json(200, {"coords": coords, "labels": s.tsne_labels})
        elif self.path == "/nearestneighbors/upload":
            from deeplearning4j_tpu_torch.clustering import VPTree

            with s.lock:
                s.nn_vectors = np.asarray(body["vectors"], np.float32)
                s.nn_labels = body.get(
                    "labels", [str(i) for i in range(len(s.nn_vectors))])
                s.nn_tree = VPTree(s.nn_vectors, labels=s.nn_labels,
                                   distance=body.get("distance", "euclidean"))
            self._json(200, {"count": len(s.nn_vectors)})
        elif self.path == "/nearestneighbors":
            with s.lock:
                tree, labels, vectors = s.nn_tree, s.nn_labels, s.nn_vectors
            if tree is None:
                self._json(400, {"error": "upload vectors first"})
                return
            k = int(body.get("k", 5))
            if "word" in body:
                if body["word"] not in labels:
                    self._json(404, {"error": f"unknown word {body['word']}"})
                    return
                query = vectors[labels.index(body["word"])]
            else:
                query = np.asarray(body["vector"], np.float32)
            hits = tree.knn(query, k)
            self._json(200, {"neighbors": [
                {"label": lbl, "distance": float(d)} for d, lbl in hits]})
        elif self.path == "/weights":
            with s.lock:
                s.weights_history.append(body)
                if len(s.weights_history) > 1000:
                    s.weights_history = s.weights_history[-1000:]
            self._json(200, {"count": len(s.weights_history)})
        elif self.path == "/activations":
            with s.lock:
                s.activations = body["activations"]
            self._json(200, {"ok": True})
        elif self.path == "/model/predict":
            self._model_predict(body)
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _model_predict(self, body: Any) -> None:
        """Batched classifier inference: the request's rows ride whatever
        coalesced dispatch the micro-batcher forms."""
        s = self.state
        with s.lock:
            engine, stopping = s.engine, s.draining
        if engine is None:
            if stopping:
                # the model WAS here: a draining or stopping server is a
                # 503 (a fleet router fails over), never the payload's 400
                raise ServingUnavailableError(
                    "server stopped: model unregistered")
            self._json(400, {"error": "no model registered: call "
                                      "UiServer.serve_model(net)"})
            return
        feats = body.get("features")
        if not feats:
            self._json(400, {"error": "features required"})
            return
        try:
            deadline_s = self._deadline_s(body)
            tenant = self._tenant(body)
            x = np.asarray(feats, np.float32)
            # an unknown tenant is a ValueError (400 here); a tenant over
            # quota a TenantQuotaError (the typed 429 in _json_post)
            probs = engine.predict_proba(x, deadline_s=deadline_s,
                                         request_id=self.request_id(),
                                         tenant=tenant)
        except (ValueError, TypeError) as e:
            self._json(400, {"error": str(e)})
            return
        self._json(200, {
            "predictions": np.argmax(probs, axis=-1).tolist(),
            "outputs": np.asarray(probs).tolist()})

    def _lm(self):
        """((cfg, params, device), the pool or None) of the registered
        LM; a stopped server is 503, none is 400."""
        s = self.state
        with s.lock:
            lm, lm_server, draining = s.lm, s.lm_server, s.draining
        if lm is None:
            if draining:
                raise ServingUnavailableError(
                    "server stopped: LM unregistered")
            raise ValueError("no LM registered: call "
                             "UiServer.serve_lm(cfg, params)")
        return lm, lm_server

    def _lm_server(self, missing: str) -> ContinuousLMServer:
        """The registered pool; `missing` is the 400's text when the LM
        was registered with continuous=False."""
        lm_server = self._lm()[1]
        if lm_server is None:
            raise ValueError(missing)
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

    def _lm_prefill(self, body: Any) -> None:
        """The prefill half of disaggregation: normal admission and
        chunked prefill, answered with the lane's page shipment."""
        lm_server = self._lm_server("no continuous LM pool registered: "
                                    "call UiServer.serve_lm(cfg, params)")
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
            request_id=self.request_id(),
            session_id=self._session_id(body),
            priority=body.get("priority"), tenant=self._tenant(body))
        self._send(200, "application/octet-stream",
                   serialize_export(export))

    def _lm_admit_pages(self, data: bytes) -> None:
        """The decode half: a binary page shipment in, ``{"ids"}`` out."""
        lm_server = self._lm_server("no continuous LM pool registered")
        ids = lm_server.admit_with_pages(
            deserialize_export(data), deadline_s=self._deadline_s({}),
            request_id=self.request_id())
        self._json(200, {"ids": ids})

    def _lm_generate(self, body: Any) -> None:
        (cfg, params, dev), lm_server = self._lm()
        if not isinstance(body, dict):
            raise ValueError("the request body must be a JSON object")
        prompt = body.get("prompt_ids")
        if not prompt:
            raise ValueError("prompt_ids required")
        # validated here, so an unknown class, a bad session or an
        # unknown tenant is a 400 on every decode path
        priority = normalize_priority(body.get("priority"))
        session_id = self._session_id(body)
        tenant = self._tenant(body)
        if tenant is not None:
            if lm_server is not None and lm_server.tenants is not None:
                tenant = lm_server.tenants.normalize(tenant)
            elif tenant != "default":
                raise ValueError(
                    f"unknown tenant {tenant!r}: no tenant registry is "
                    f"installed (serve -tenants)")
        max_new = int(body.get("max_new_tokens", 32))
        temperature = float(body.get("temperature", 0.0))
        seed = int(body.get("seed", 0)) & 0x7FFFFFFF
        beams = int(body.get("beam_size", 0))
        top_k = int(body.get("top_k", 0))
        top_p = float(body.get("top_p", 1.0))
        stream = bool(body.get("stream", False))
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
            if lm_server is None:
                raise ValueError(
                    "speculate requested but no continuous LM pool is "
                    "registered (continuous=False)")
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
        if stream and lm_server is None:
            raise ValueError(
                "stream requested but no continuous LM pool is "
                "registered (continuous=False)")
        if stream and (beams > 1 or top_k > 0 or top_p < 1.0):
            # the whole-sequence legs have nothing to stream
            raise ValueError(
                "stream requires the continuous greedy/temperature "
                "path: top-k/top-p/beam decode whole-sequence and "
                "cannot stream")
        deadline_s = self._deadline_s(body)
        try:
            ids = validate_request(cfg, prompt, max_new)
        except ValueError as e:
            payload = {"error": str(e)}
            if "max_len" in str(e):
                payload["max_len"] = cfg.max_len
            self._json(400, payload)
            return
        if beams > 1:
            toks, scores = beam_search(cfg, params, [ids], max_new,
                                       beam_size=beams, device=dev)
            self._json(200, {"ids": toks[0].tolist(),
                             "score": float(scores[0])})
        elif stream:
            # admission (and its typed failures) happens here, before any
            # response byte is committed
            gen = lm_server.generate_stream(
                ids, max_new, temperature=temperature, seed=seed,
                deadline_s=deadline_s, request_id=self.request_id(),
                session_id=session_id, priority=priority, tenant=tenant)
            self._sse_stream(gen, ids)
        elif lm_server is None or top_k > 0 or top_p < 1.0:
            toks = generate(cfg, params, [ids], max_new,
                            temperature=temperature, seed=seed, top_k=top_k,
                            top_p=top_p, device=dev)
            self._json(200, {"ids": toks[0].tolist()})
        else:
            # the continuous pool: the request shares its dispatches with
            # whatever else is decoding
            out = lm_server.generate(ids, max_new, temperature=temperature,
                                     seed=seed, deadline_s=deadline_s,
                                     request_id=self.request_id(),
                                     session_id=session_id,
                                     priority=priority, tenant=tenant)
            self._json(200, {"ids": out})

    def _sse_stream(self, gen, prompt_ids: List[int]) -> None:
        """Relay one token stream as Server-Sent Events: one ``data:``
        event per committed token, a final ``done`` event with the full
        ids, an ``error`` event if the decode fails mid-stream.  The
        response is close-delimited (no Content-Length).  A client that
        disconnects raises on the write; closing the generator abandons
        the request so its slot and pages free at the next admit
        round."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        rid = getattr(self, "_request_id", None)
        if rid is not None:
            self.send_header("X-Request-Id", rid)
        self.end_headers()
        toks: List[int] = []
        try:
            try:
                for tok in gen:
                    toks.append(int(tok))
                    self.wfile.write(
                        b"data: " + json.dumps(
                            {"token": int(tok),
                             "index": len(toks) - 1}).encode() + b"\n\n")
                    self.wfile.flush()
                self.wfile.write(
                    b"event: done\ndata: " + json.dumps(
                        {"ids": list(prompt_ids) + toks}).encode()
                    + b"\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                # a mid-stream disconnect: nothing to answer; the finally
                # below closes the generator, which abandons the request
                pass
            except Exception as e:  # noqa: BLE001 — headers are sent; the error rides the stream
                try:
                    self.wfile.write(
                        b"event: error\ndata: " + json.dumps(
                            {"error": str(e)}).encode() + b"\n\n")
                    self.wfile.flush()
                except OSError:
                    pass
        finally:
            gen.close()


class UiServer:
    """`UiServer(port=0).serve_lm(cfg, params).start()` (or
    `.serve_model(net)`); `.url` for clients; `.stop()` to halt.
    `device` is where ``/tsne/generate`` runs (None = the card); the
    served models stay on their own devices."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 device=None):
        self._server = ServingHTTPServer((host, port), _Handler)
        self._server.ui_state = _UiState(  # type: ignore[attr-defined]
            device)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def state(self) -> _UiState:
        return self._server.ui_state  # type: ignore[attr-defined]

    @property
    def registry(self) -> MetricsRegistry:
        """The server's metrics registry (rendered at GET /metrics)."""
        return self.state.registry

    @property
    def tracer(self) -> TraceRecorder:
        """The server's trace ring (served at GET /trace/recent)."""
        return self.state.tracer

    def serve_lm(self, cfg, params, slots: int = 4,
                 continuous: bool = True,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 breaker_threshold: Optional[int] = 5,
                 breaker_cooldown_s: float = 1.0,
                 kv: str = "paged", page_size: int = 16,
                 pages: Optional[int] = None, prefill_chunk: int = 8,
                 speculate: str = "off", draft_len: int = 4,
                 ship: bool = False, preempt: bool = False,
                 swap_bytes: int = 64 << 20, brownout=None, tenants=None,
                 hibernate_idle_s: Optional[float] = None,
                 state_dir: Optional[str] = None,
                 state_disk_bytes: int = 1 << 30,
                 swap_quantize: bool = True,
                 device=None) -> "UiServer":
        """Register a transformer LM for ``POST /lm/generate``, decoded by
        a `slots`-lane continuous pool over a paged or dense KV cache on
        `device` (None = the card), speculating when `speculate` is
        "ngram" or "model".  ``continuous=False`` builds no pool: every
        request runs the whole-sequence `generate` / `beam_search`, and
        the requests only a pool can serve (speculate, stream,
        ``/lm/prefill``, ``/lm/admit_pages``) are 400s.
        `max_queue_depth`, `default_deadline_s` and the breaker knobs
        (`breaker_threshold` consecutive failed
        dispatches open it for `breaker_cooldown_s`; None or 0 = no
        breaker) configure admission; `tenants` (a `TenantRegistry`, a
        spec mapping or the ``-tenants`` JSON) installs tenancy.  `ship`
        answers ``/lm/prefill`` and ``/lm/admit_pages``;
        `preempt`/`swap_bytes`, `brownout`,
        `hibernate_idle_s`/`state_dir`/`state_disk_bytes` and
        `swap_quantize` are the pool's page-mobility planes
        (`ContinuousLMServer`).  The pool publishes on this server's
        registry and traces into its recorder."""
        lm_server = None
        if continuous:
            breaker = (CircuitBreaker(failure_threshold=breaker_threshold,
                                      cooldown_s=breaker_cooldown_s)
                       if breaker_threshold else None)
            lm_server = ContinuousLMServer(
                cfg, params, slots=slots, max_queue_depth=max_queue_depth,
                default_deadline_s=default_deadline_s, breaker=breaker,
                kv=kv, page_size=page_size, pages=pages,
                prefill_chunk=prefill_chunk, speculate=speculate,
                draft_len=draft_len, ship=ship, preempt=preempt,
                swap_bytes=swap_bytes, brownout=brownout, tenants=tenants,
                hibernate_idle_s=hibernate_idle_s, state_dir=state_dir,
                state_disk_bytes=state_disk_bytes,
                swap_quantize=swap_quantize, tracer=self.state.tracer,
                registry=self.state.registry, device=device)
            lm = (cfg, lm_server.params, lm_server.device)
        else:
            dev = resolve_device(device)
            lm = (cfg, place_params(cfg, params, dev), dev)
        with self.state.lock:
            old = self.state.lm_server
            self.state.lm = lm
            self.state.lm_server = lm_server
        if old is not None:
            old.stop()
        return self

    def serve_model(self, net, max_batch: int = 32,
                    max_wait_ms: float = 2.0, ladder=None,
                    warmup_example=None,
                    max_queue_depth: Optional[int] = None,
                    default_deadline_s: Optional[float] = None,
                    breaker_threshold: Optional[int] = 5,
                    breaker_cooldown_s: float = 1.0,
                    quantize: Optional[str] = None,
                    tenants=None) -> "UiServer":
        """Register a `MultiLayerNetwork` (on its own device) behind the
        micro-batcher for ``POST /model/predict``.  `warmup_example` (one
        example row) runs every bucket-ladder shape before traffic.
        `max_queue_depth`, `default_deadline_s` and the breaker knobs
        configure admission; `quantize="int8"` serves per-channel int8
        weights; `tenants` installs the per-tenant quota gate.  The
        engine publishes on this server's registry (``plane=
        "classifier"``) and traces into its recorder."""
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine

        engine = ServingEngine(net, ladder=ladder, max_batch=max_batch,
                               max_wait_ms=max_wait_ms,
                               max_queue_depth=max_queue_depth,
                               default_deadline_s=default_deadline_s,
                               breaker_threshold=breaker_threshold,
                               breaker_cooldown_s=breaker_cooldown_s,
                               quantize=quantize,
                               tracer=self.state.tracer,
                               registry=self.state.registry,
                               tenants=tenants)
        if warmup_example is not None:
            engine.warmup(warmup_example)
        with self.state.lock:
            old = self.state.engine
            self.state.engine = engine
        if old is not None:
            old.stop()
        return self

    def start(self) -> "UiServer":
        self._thread.start()
        return self

    def serving_stats(self) -> dict:
        return self.state.serving_stats()

    def begin_drain(self) -> None:
        """Stop admission on every plane: new requests get 503 and
        /readyz flips, while queued and in-flight work keeps running."""
        with self.state.lock:
            self.state.draining = True
            engine, lm_server = self.state.engine, self.state.lm_server
        if engine is not None:
            engine.begin_drain()
        if lm_server is not None:
            lm_server.begin_drain()

    def drain(self, grace_s: float = 5.0) -> bool:
        """Graceful drain: stop admission, then give in-flight work up to
        `grace_s` (total); True when every plane fully drained in time."""
        self.begin_drain()
        with self.state.lock:
            engine, lm_server = self.state.engine, self.state.lm_server
        deadline = time.perf_counter() + max(0.0, grace_s)
        drained = True
        if engine is not None:
            drained &= engine.drain(max(0.0, deadline - time.perf_counter()))
        if lm_server is not None:
            drained &= lm_server.drain(
                max(0.0, deadline - time.perf_counter()))
        return drained

    def stop(self) -> None:
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()
        with self.state.lock:
            # handler threads that got in before the close read the
            # nulled planes as `draining`: 503, not 400
            self.state.draining = True
            engine, self.state.engine = self.state.engine, None
            lm_server, self.state.lm_server = self.state.lm_server, None
            self.state.lm = None
        if engine is not None:
            engine.stop()
        if lm_server is not None:
            lm_server.stop()


__all__ = ["UiServer"]
