"""PyTorch port: the front's classifier and dashboard half against the
JAX package's front, both `UiServer.serve_model` over iris-mlp on the
same weights, every request of one script sent to both over HTTP:

- ``POST /model/predict``: a good request (outputs within 1e-6, the
  same predictions), empty features, no model, a draining server, a
  stopped server's unregistered model, a tenant over its quota (the
  meter's clock driven by hand: the same ``Retry-After``), an expired
  deadline, a malformed body — the same status codes, bodies and headers;
- ``GET /`` (the same dashboard bytes), ``/api/coords``, ``/weights``
  (1000 posts kept, the last 200 scores), ``/activations``, ``/readyz``
  and ``/metrics`` (the same families; one isolated poison reads 1 on
  ``serving_poison_isolated_total`` on both);
- the training listener's posted body, and VPTree neighbours over
  ``/nearestneighbors`` equal to JAX's;
- ``cli serve -model`` in a child process: ``-quantize int8 -buckets
  -warmup``, an answer, the stats snapshot of its SIGTERM drain.
"""

import functools
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.resilience import chaos as jchaos
from deeplearning4j_tpu.serving import BucketLadder as JLadder
from deeplearning4j_tpu.ui import listeners as jlisteners
from deeplearning4j_tpu.ui.server import UiServer as JaxUiServer
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.resilience import chaos as tchaos
from deeplearning4j_tpu_torch.serving import BucketLadder as TLadder
from deeplearning4j_tpu_torch.ui import listeners as tlisteners
from deeplearning4j_tpu_torch.ui.server import UiServer
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

TENANTS = {"metered": {"rate": 1.0, "burst": 4.0}}
SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$")


def _post(url, payload, headers=(), raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json", **dict(headers)})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _charge_at(charge, clock, tenant, cost, now=None):
    return charge(tenant, cost, now=clock[0])


def _nets():
    jn = JNet(jzoo.iris_mlp()).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(
        jzoo.iris_mlp().to_json()), device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


@pytest.fixture(scope="module")
def fronts():
    clock = [1000.0]
    jn, tn = _nets()
    knobs = dict(max_batch=8, tenants=TENANTS,
                 warmup_example=np.zeros(4, np.float32))
    jax_ui = JaxUiServer(port=0).serve_model(
        jn, ladder=JLadder((1, 8)), **knobs).start()
    port_ui = UiServer(port=0, device="cpu").serve_model(
        tn, ladder=TLadder((1, 8)), **knobs).start()
    for ui in (jax_ui, port_ui):
        meter = ui.state.engine.batcher.tenants.meter
        meter.charge = functools.partial(_charge_at, meter.charge, clock)
    yield jax_ui, port_ui, clock
    port_ui.stop()
    jax_ui.stop()


def _both(fronts, path, payload, headers=(), raw=None):
    return [_post(ui.url + path, payload, headers, raw)
            for ui in fronts[:2]]


def _rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)


def test_predict_matches_jax(fronts):
    x = _rows(5)
    (jc, _, jb), (c, h, b) = _both(fronts, "/model/predict",
                                   {"features": x.tolist()},
                                   headers={"X-Request-Id": "p-1"})
    assert jc == c == 200 and h["X-Request-Id"] == "p-1"
    assert b["predictions"] == jb["predictions"]
    got, want = np.asarray(b["outputs"]), np.asarray(jb["outputs"])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("payload,raw", [
    ({"features": []}, None), ({}, None), (None, b"{not json"),
    ({"features": [[1.0, 2.0, 3.0]]}, None),
    ({"features": _rows(9).tolist()}, None),
    ({"features": [[1.0] * 4], "deadline_ms": -1}, None),
    ({"features": [[1.0] * 4], "tenant": "nobody"}, None)])
def test_client_errors_are_the_same_400(fronts, payload, raw):
    (jc, _, jb), (c, _, b) = _both(fronts, "/model/predict", payload,
                                   raw=raw)
    assert jc == c == 400
    if raw is None and payload.get("features") != [[1.0, 2.0, 3.0]]:
        assert b == jb
    else:     # the same failure, named in each package's own words
        assert set(b) == set(jb) == {"error"}


def test_over_quota_is_the_same_429_and_retry_after(fronts):
    payload = {"features": _rows(4).tolist(), "tenant": "metered"}
    first = _both(fronts, "/model/predict", payload)
    assert [r[0] for r in first] == [200, 200]
    (jc, jh, jb), (c, h, b) = _both(fronts, "/model/predict", payload)
    assert jc == c == 429
    assert h["Retry-After"] == jh["Retry-After"] == "4"
    assert b == jb and b["retry_after_s"] == 4
    fronts[2][0] += 4.0
    assert [r[0] for r in _both(fronts, "/model/predict", payload)] \
        == [200, 200]


class _Gate:
    def __init__(self, batcher):
        self.batcher, self.inner = batcher, batcher._dispatch
        self.event, self.entered = threading.Event(), threading.Event()
        batcher._dispatch = self

    def __call__(self, x, mask, n):
        self.entered.set()
        assert self.event.wait(60)
        return self.inner(x, mask, n)

    def close(self):
        self.event.set()
        self.batcher._dispatch = self.inner


def test_expired_deadline_is_the_same_504(fronts):
    for ui in fronts[:2]:
        batcher = ui.state.engine.batcher
        gate = _Gate(batcher)
        first = threading.Thread(target=_post, args=(
            ui.url + "/model/predict", {"features": _rows(1).tolist()}))
        first.start()
        assert gate.entered.wait(60)
        box = []
        t = threading.Thread(target=lambda: box.append(_post(
            ui.url + "/model/predict",
            {"features": _rows(1, 1).tolist(), "deadline_ms": 5})))
        t.start()
        t0 = time.perf_counter()
        while not batcher._queue and time.perf_counter() - t0 < 60:
            time.sleep(0.005)
        time.sleep(0.05)               # its 5 ms expire while it queues
        gate.close()
        first.join(60)
        t.join(60)
        code, _, body = box[0]
        assert code == 504
        assert body["error"].startswith("deadline exceeded after")
        assert body["error"].endswith("s in queue; shed before dispatch")


def test_poison_isolated_reads_one_on_both_metrics(fronts):
    reqs = [_rows(1, 30 + i).tolist() for i in range(3)]
    reqs[1] = [[9.0] * 4]
    for ui, ch in zip(fronts[:2], (jchaos, tchaos)):
        batcher = ui.state.engine.batcher
        plain = batcher._dispatch
        batcher._dispatch = ch.chaos_dispatch(
            plain, ch.ServingChaosConfig(poison_value=9.0))
        gate = _Gate(batcher)
        out = [None] * 3

        def client(i, ui=ui):
            out[i] = _post(ui.url + "/model/predict", {"features": reqs[i]})

        threads = [threading.Thread(target=client, args=(0,))]
        threads[0].start()
        assert gate.entered.wait(60)
        threads += [threading.Thread(target=client, args=(i,))
                    for i in (1, 2)]
        for t in threads[1:]:
            t.start()
        while len(batcher._queue) < 2:
            time.sleep(0.005)
        gate.close()
        for t in threads:
            t.join(60)
        batcher._dispatch = plain
        # the lone first dispatch, then the coalesced pair bisected
        assert [o[0] for o in out] == [200, 400, 200]
        assert "poison row" in out[1][2]["error"]
        _, text = _get(ui.url + "/metrics")
        assert 'serving_poison_isolated_total{plane="classifier"} 1' in \
            text.decode()


def test_dashboard_and_json_gets_match(fronts):
    (jc, jpage), (c, page) = [_get(ui.url + "/") for ui in fronts[:2]]
    assert jc == c == 200 and page == jpage and b"<html>" in page
    coords = {"coords": [[0.5, 1.5], [2.0, -1.0]]}
    assert _both(fronts, "/api/coords", coords)[0][2] == {"count": 2}
    for path in ("/api/coords", "/activations", "/tsne/coords",
                 "/nowhere"):
        (jc, jb), (c, b) = [_get(ui.url + path) for ui in fronts[:2]]
        assert jc == c and json.loads(b) == json.loads(jb)
    grid = {"activations": [[0.0, 1.0], [0.25, 0.5]]}
    assert [r[2] for r in _both(fronts, "/activations", grid)] == \
        [{"ok": True}] * 2
    (_, jb), (_, b) = [_get(ui.url + "/activations") for ui in fronts[:2]]
    assert json.loads(b) == json.loads(jb) == grid


def test_weights_history_is_bounded_like_jax(fronts):
    for i in range(1003):
        body = {"iteration": i, "score": 1.0 / (i + 1)} if i % 7 else \
            {"iteration": i}
        for ui in fronts[:2]:
            with ui.state.lock:     # the POST path's list, filled fast
                ui.state.weights_history.append(body)
    post = _both(fronts, "/weights", {"iteration": 1003, "score": 0.5})
    assert post[0][2] == post[1][2]
    (jc, jb), (c, b) = [_get(ui.url + "/weights") for ui in fronts[:2]]
    got, want = json.loads(b), json.loads(jb)
    assert jc == c == 200 and got == want
    assert got["count"] == 1000 and len(got["history"]) <= 200
    assert got["last"] == {"iteration": 1003, "score": 0.5}


def test_listener_posts_jax_s_body(fronts):
    jn, tn = _nets()
    jbody = jlisteners.HistogramIterationListener(jn, fronts[0].url)
    tbody = tlisteners.HistogramIterationListener(tn, fronts[1].url)
    want = {"iteration": 3, "score": 0.25,
            "weights": jlisteners._summaries(jn.params)}
    got = tbody.payload(3, 0.25)
    assert sorted(got["weights"]) == sorted(want["weights"])
    for key, cell in want["weights"].items():
        ours = got["weights"][key]
        assert ours["hist"] == cell["hist"]
        for stat in ("mean", "std", "min", "max"):
            assert ours[stat] == pytest.approx(cell[stat], rel=1e-6,
                                               abs=1e-7)
        np.testing.assert_allclose(ours["edges"], cell["edges"], rtol=1e-6,
                                   atol=1e-7)
    tbody(3, 0.25)
    jbody(3, 0.25)
    assert tbody.failures == jbody.failures == 0
    (_, jb), (_, b) = [_get(ui.url + "/weights") for ui in fronts[:2]]
    assert json.loads(b)["last"]["iteration"] == 3
    assert json.loads(jb)["last"]["iteration"] == 3


def test_nearest_neighbours_match_jax(fronts):
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((40, 6)).astype(np.float32)
    labels = [f"w{i}" for i in range(40)]
    for dist in ("euclidean", "cosine"):
        up = _both(fronts, "/nearestneighbors/upload",
                   {"vectors": vecs.tolist(), "labels": labels,
                    "distance": dist})
        assert [r[2] for r in up] == [{"count": 40}] * 2
        for query in ({"word": "w3", "k": 5},
                      {"vector": rng.standard_normal(6).tolist(), "k": 4},
                      {"word": "zzz"}):
            (jc, _, jb), (c, _, b) = _both(fronts, "/nearestneighbors",
                                           query)
            assert jc == c and b == jb


def test_readyz_metrics_and_stopped_model(fronts):
    codes = [_get(ui.url + "/readyz")[0] for ui in fronts[:2]]
    assert codes == [200, 200]
    (_, jtext), (_, text) = [_get(ui.url + "/metrics") for ui in fronts[:2]]
    jtext, text = jtext.decode(), text.decode()

    def fams(t):
        return {ln.split()[2] for ln in t.splitlines()
                if ln.startswith("# TYPE ")}
    assert fams(text) == fams(jtext)
    assert 'serving_requests_total{plane="classifier"}' in text
    for line in text.splitlines():
        assert line.startswith("#") or SAMPLE.match(line), line
    (_, js), (_, s) = [_get(ui.url + "/serving/stats") for ui in fronts[:2]]
    js, s = json.loads(js), json.loads(s)
    assert sorted(s) == sorted(js) and s["lm"] is js["lm"] is None
    assert sorted(s["classifier"]) == sorted(js["classifier"])


def test_draining_then_stopped_model_is_a_503(fronts):
    """Last in the module: it drains both fronts."""
    for ui in fronts[:2]:
        ui.begin_drain()
    (jc, jh, jb), (c, h, b) = _both(fronts, "/model/predict",
                                    {"features": _rows(1).tolist()})
    assert jc == c == 503 and b == jb
    assert h["Retry-After"] == jh["Retry-After"]
    ready = [(_get(ui.url + "/readyz")) for ui in fronts[:2]]
    assert [r[0] for r in ready] == [503, 503]
    assert json.loads(ready[0][1]) == json.loads(ready[1][1]) == {
        "ready": False, "reasons": ["draining",
                                    "classifier engine not ready"]}
    for ui in fronts[:2]:          # stop() nulls the engine mid-request
        with ui.state.lock:
            ui.state.engine = None
    (jc, _, jb), (c, _, b) = _both(fronts, "/model/predict",
                                   {"features": _rows(1).tolist()})
    assert jc == c == 503 and b == jb
    assert b["error"] == "server stopped: model unregistered"


def test_no_model_is_the_same_400():
    uis = [JaxUiServer(port=0).start(), UiServer(port=0).start()]
    try:
        (jc, _, jb), (c, _, b) = [_post(ui.url + "/model/predict",
                                        {"features": [[1.0]]})
                                  for ui in uis]
        assert jc == c == 400 and b == jb
        assert "UiServer.serve_model(net)" in b["error"]
    finally:
        for ui in uis:
            ui.stop()


def test_cli_serve_model_int8_answers_and_drains(tmp_path):
    stats = tmp_path / "drain.json"
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
         "-model", "zoo:iris-mlp", "-quantize", "int8", "-buckets", "1,8",
         "-warmup", "-port", "0", "-device", "cpu", "-drain-grace-s", "3",
         "-drain-stats", str(stats)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    try:
        url = None
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"Serving on (http://\S+)", line)
            if m:
                url = m.group(1)
                break
        assert url, "".join(lines)
        code, _, body = _post(url + "/model/predict",
                              {"features": _rows(3).tolist()})
        assert code == 200 and len(body["predictions"]) == 3
        assert _get(url + "/readyz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines)
    assert proc.returncode == 0, text
    assert "serve: int8 weights — 3/3 layers quantized" in text
    assert "serve: ran 2 bucket shapes before traffic" in text
    snap = json.loads(stats.read_text())
    assert snap["classifier"]["requests"] == 1
    assert snap["classifier"]["quantize"] == "int8"
    assert snap["classifier"]["accepting"] is False
