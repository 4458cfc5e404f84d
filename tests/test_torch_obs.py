"""PyTorch port: the observability plane (`deeplearning4j_tpu_torch.obs`)
against the JAX package's `obs`.

- The metrics registry: the same calls on both registries give byte-equal
  Prometheus text (label escaping, callback gauges, collectors,
  histograms), and the serving plane's `ServingMetrics` cells published
  with ``register_into(registry, plane="lm")`` (the per-tenant cells
  registered late) give byte-equal text too.  Histogram summaries are
  equal floats.
- The trace ring (capacity, lazy entries, filters) and `chrome_trace`
  on the same spans.
- `MetricsServer` scraped over HTTP.
- `TrainingTelemetry` on a seeded chunked fit of both packages' nets
  (steps counted at chunk boundaries only, the same loss) and on the
  same loss-scaler readings (grow and backoff events).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import obs as jobs
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.runtime import fused as jfused
from deeplearning4j_tpu.serving.metrics import ServingMetrics as JMetrics
from deeplearning4j_tpu_torch import obs as tobs
from deeplearning4j_tpu_torch.obs.trace import to_epoch_ns
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.runtime import fused as tfused
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


def _drive_registry(mod, seed):
    """One seeded sequence of registry calls."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("req_total", "requests\nserved \\ total", plane="lm",
                    tenant='we"ird\\name\nx')
    g = reg.gauge("depth", "queue depth", plane="lm")
    fixed = reg.gauge("answer", "callback gauge", fn=lambda: 42.5)
    h = reg.histogram("lat_seconds", "latency", plane="lm")
    h2 = mod.Histogram("step_seconds", "", buckets=mod.STEP_TIME_BUCKETS)
    reg.register(h2, job="train")
    c2 = mod.Counter("req_total", "requests\nserved \\ total")
    reg.register(c2, plane="classifier")
    reg.register_collector(lambda: [
        ("fleet_up", "gauge", "replicas up", {"replica": "r0"}, 1.0),
        ("fleet_up", "gauge", "replicas up", {"replica": "r1"}, 0.0)])
    for _ in range(40):
        c.inc(float(rng.integers(0, 3)))
        c2.inc()
        g.set(float(rng.normal()))
        h.observe(float(rng.exponential(0.2)))
        h2.observe(float(rng.exponential(3.0)))
    g.inc(1e20)
    h.observe(float("inf"))
    assert fixed.value == 42.5
    return reg, (h, h2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_is_byte_equal(seed):
    ours, ours_h = _drive_registry(tobs, seed)
    theirs, theirs_h = _drive_registry(jobs, seed)
    assert ours.exposition() == theirs.exposition()
    assert ours.collect() == theirs.collect()
    for a, b in zip(ours_h, theirs_h):
        assert a.summary() == b.summary()
        assert a.cumulative() == b.cumulative()
    text = ours.exposition()
    assert 'tenant="we\\"ird\\\\name\\nx"' in text
    assert "# HELP req_total requests\\nserved \\\\ total" in text


def test_registry_refuses_what_jax_refuses():
    for mod in (tobs, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total")
        with pytest.raises(ValueError, match="invalid label"):
            reg.counter("y_total", **{"bad-label": "v"})
        with pytest.raises(ValueError, match="invalid metric name"):
            mod.Counter("9bad")
        with pytest.raises(ValueError, match="cannot decrease"):
            mod.Counter("z_total").inc(-1)
        with pytest.raises(ValueError, match="positive"):
            mod.Histogram("h", buckets=(0.0, 1.0))


def _drive_serving(cls, seed):
    """The pool's record calls, the tenant cells appearing after
    registration (the late-registration path)."""
    rng = np.random.default_rng(seed)
    m = cls()
    reg = (tobs if cls is ServingMetrics else jobs).MetricsRegistry()
    m.register_into(reg, plane="lm")
    for i in range(30):
        m.record_dispatch(int(rng.integers(1, 8)), 8)
        m.record_request(float(rng.exponential(0.1)),
                         queue_wait_s=float(rng.exponential(0.01)),
                         compute_s=float(rng.exponential(0.05)))
        m.record_tokens(int(rng.integers(1, 5)))
        m.record_first_token(float(rng.exponential(0.02)))
        m.record_decode_round(2, drafted=3, accepted=1)
        m.record_prefix_query(int(rng.integers(0, 2)) * 16)
        m.record_class("requests", ["interactive", "batch",
                                    "best_effort"][i % 3])
        m.record_tenant("requests", ["default", "team-a"][i % 2])
        if i % 5 == 0:
            m.record_tenant("throttled", "team-b")
            m.record_rejected()
        m.set_tenant_burn("team-a", float(rng.random()))
    m.set_pages(3, 5, 8)
    m.set_queue_depth(2)
    for state in ("open", "half_open", "closed", "open"):
        m.set_breaker_state(state)
    m.record_ship("out", 2, 4096, 0.001)
    m.record_swap("in", 1, 2048)
    m.record_brownout(2, transitions=2)
    return m, reg


@pytest.mark.parametrize("seed", [0, 1])
def test_serving_plane_exposition_is_byte_equal(seed):
    ours, oreg = _drive_serving(ServingMetrics, seed)
    theirs, jreg = _drive_serving(JMetrics, seed)
    assert oreg.exposition() == jreg.exposition()
    a, b = ours.snapshot(), theirs.snapshot()
    for key in ("uptime_s", "snapshot_at", "requests_per_sec",
                "tokens_per_sec", "latency"):
        a.pop(key, None)
        b.pop(key, None)
    assert a == b
    assert ours.dispatches == theirs.dispatches == 30
    assert ours.max_occupancy == theirs.max_occupancy
    assert a["breaker_state"] == "open" and a["breaker_opens"] == 2
    text = oreg.exposition()
    for fam in ("serving_lm_tenant_requests_total",
                "serving_lm_tenant_throttled_total",
                "serving_lm_tenant_slo_burn_rate",
                "serving_breaker_state", "serving_lm_ttft_seconds_bucket"):
        assert fam in text


def _spans(mod, seed):
    rng = np.random.default_rng(seed)
    t = 100.0
    out = []
    for i in range(5):
        t0 = t + float(rng.random())
        spans = [mod.span("queue_wait", t0, t0 + 0.01),
                 mod.span("decode", t0 + 0.01, t0 + 0.05,
                          prompt_tokens=4, drafted=None)]
        out.append(mod.trace(f"req{i}", "lm", spans, status="ok",
                             prompt_tokens=4, error=None))
    return out


def test_trace_ring_and_chrome_trace_match():
    ours, theirs = _spans(tobs, 0), _spans(jobs, 0)
    for a, b in zip(ours, theirs):
        a, b = dict(a), dict(b)
        assert abs(a.pop("wall_time") - b.pop("wall_time")) < 60
        assert a == b
    # the port's events sit on the profiler's clock: the JAX package's
    # perf_counter microseconds moved by the clock anchor's offset
    shift_us = to_epoch_ns(0) / 1e3
    got, want = tobs.chrome_trace(ours), jobs.chrome_trace(theirs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        assert g.pop("ts") == pytest.approx(w.pop("ts") + shift_us, abs=1)
        assert g == w
    rings = [mod.TraceRecorder(capacity=3) for mod in (tobs, jobs)]
    for ring, traces in zip(rings, (ours, theirs)):
        for tr in traces[:4]:
            ring.record(tr)
        ring.record_lazy(lambda raw: raw, traces[4])
        assert ring.recorded == 5
        assert [t["request_id"] for t in ring.recent()] == \
            ["req2", "req3", "req4"]
        assert ring.find("req4")[0]["spans"][1]["attrs"] == \
            {"prompt_tokens": 4}
        assert [t["request_id"] for t in ring.recent(n=1)] == ["req4"]
    rid = tobs.new_request_id()
    assert len(rid) == 24 and int(rid, 16) >= 0
    assert tobs.new_request_id() != rid
    with pytest.raises(ValueError, match="capacity"):
        tobs.TraceRecorder(capacity=0)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_metrics_server_scrape():
    reg, _ = _drive_registry(tobs, 0)
    tracer = tobs.TraceRecorder()
    for tr in _spans(tobs, 1):
        tracer.record(tr)
    srv = tobs.MetricsServer(reg, port=0, tracer=tracer).start()
    try:
        code, ctype, body = _get(srv.url + "/metrics")
        assert code == 200 and ctype == tobs.EXPOSITION_CONTENT_TYPE
        assert body.decode() == reg.exposition()
        assert _get(srv.url + "/healthz")[0] == 200
        code, _, body = _get(srv.url + "/trace/recent")
        assert [t["request_id"] for t in json.loads(body)["traces"]] == \
            [f"req{i}" for i in range(5)]
        code, _, body = _get(srv.url + "/trace/recent?format=chrome")
        assert json.loads(body) == tobs.chrome_trace(tracer.recent())
        assert _get(srv.url + "/nope")[0] == 404
    finally:
        srv.stop()


def _pair():
    jc = jzoo.iris_mlp()
    jn = JNet(jc).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(jc.to_json()),
              device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


def _iris_batches(n_batches, seed=0, batch=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        y = rng.integers(0, 3, batch)
        x = rng.normal(0, 0.3, (batch, 4)).astype(np.float32) + y[:, None]
        out.append((x, np.eye(3, dtype=np.float32)[y]))
    return out


@pytest.mark.parametrize("chunk", [1, 4])
def test_training_telemetry_on_a_chunked_fit_matches(chunk):
    """12 steps in chunks of `chunk` with a sync interval of 2: the
    telemetry fires at chunk boundaries only (or every second step
    unchunked) and counts every step, in both packages."""
    jn, tn = _pair()
    tel = [mod.TrainingTelemetry(registry=mod.MetricsRegistry(),
                                 sync_interval=2, batch_size=8)
           for mod in (tobs, jobs)]
    tn.add_listener(tel[0])
    jn.add_listener(tel[1])
    batches = _iris_batches(12)
    tfused.FusedTrainingDriver(tn, chunk_size=chunk).fit(iter(batches))
    jfused.FusedTrainingDriver(jn, chunk_size=chunk).fit(iter(batches))
    snaps = [t.snapshot() for t in tel]
    assert snaps[0]["steps"] == snaps[1]["steps"] == 12
    assert snaps[0]["loss"] == pytest.approx(snaps[1]["loss"], rel=1e-5)
    assert snaps[0]["grad_norm"] == pytest.approx(snaps[1]["grad_norm"],
                                                  rel=1e-4)
    assert tel[0].step_time.count == tel[1].step_time.count
    firings = 6 if chunk == 1 else 3      # every 2nd step / chunk end
    assert tel[0].step_time.count == firings - 1


def test_training_telemetry_loss_scale_events_match():
    """A loss-scaled fit with a poison batch (one backoff) and enough
    clean steps for a growth, read by both telemetries."""
    jn, tn = _pair()
    from deeplearning4j_tpu import precision as jprec
    from deeplearning4j_tpu_torch import precision as tprec

    for net, prec in ((tn, tprec), (jn, jprec)):
        net.set_precision(prec.PrecisionPolicy(
            "float32", "float16",
            loss_scale=prec.LossScaleConfig(growth_interval=3)))
    tel = [mod.TrainingTelemetry(sync_interval=1) for mod in (tobs, jobs)]
    tn.add_listener(tel[0])
    jn.add_listener(tel[1])
    batches = _iris_batches(9, seed=2)
    poison = batches[1][0].copy()
    poison[0, 0] = np.inf
    batches[1] = (poison, batches[1][1])
    for x, y in batches:
        tn.fit_batch(x, y)
        jn.fit_batch(x, y)
    snaps = [t.snapshot() for t in tel]
    for key in ("loss_scale", "loss_scale_grows", "loss_scale_backoffs",
                "steps"):
        assert snaps[0][key] == snaps[1][key], key
    assert snaps[0]["loss_scale_backoffs"] == 1
    assert snaps[0]["loss_scale_grows"] >= 1
    # the same readings fed straight in give the same counters
    readings = [{"scale": s, "overflow_count": o} for s, o in
                ((1024.0, 0), (2048.0, 0), (1024.0, 1), (1024.0, 3),
                 (4096.0, 3))]
    tel = [mod.TrainingTelemetry() for mod in (tobs, jobs)]
    for r in readings:
        for t in tel:
            t.observe_scaler(r)
    assert [(t.loss_scale_grow.value, t.loss_scale_backoff.value)
            for t in tel] == [(2.0, 3.0)] * 2
    with pytest.raises(ValueError, match="unknown intervention"):
        tel[0].record_intervention("reboot")
