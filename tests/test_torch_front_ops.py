"""PyTorch port: the LM front's operations plane against the JAX
package's front, both `UiServer.serve_lm` on one tiny float32 config
with the same tenant registry and breaker, every case over HTTP to both:

- status codes, bodies and ``Retry-After`` headers for an unknown
  tenant (400), a tenant over its quota (429), an open breaker (503) and
  an expired deadline (504).  The quota and breaker clocks are driven by
  hand on both sides (the meter's ``now=``, the breaker's clock), so the
  header values are compared exactly;
- the ``X-Request-Id`` round trip (echoed when sent, minted when not);
- ``/trace/recent``: one trace per request id with the same span names
  (both pools warmed, so no ``xla_compile`` span on either);
- ``/metrics``: the same family names, the compile watcher's
  ``compiles_total`` / ``compile_seconds_total`` included, and every
  line Prometheus text;
- the CLI: ``serve -tenants -breaker-threshold -deadline-ms -max-queue
  -warmup -drain-stats`` boots a tiny LM in a child process, answers,
  and writes its stats on SIGTERM; ``train -metrics-port`` serves the
  run's telemetry.
"""

import dataclasses
import functools
import json
import os
import re
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.ui.server import UiServer as JaxUiServer
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.runtime.checkpoint import tree_to_npz
from deeplearning4j_tpu_torch.ui.server import UiServer
from test_torch_cli_train import csv_file  # noqa: F401 — fixture
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

JCFG = jt.TransformerConfig(vocab_size=64, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=32,
                            attn_bias=True, tie_embeddings=True)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))
PROMPT = [3, 1, 4, 1, 5]
TENANTS = {"gold": {"weight": 4, "slo_ms": 250},
           "metered": {"rate": 1.0, "burst": 10.0}}
SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$")


def _post(url, payload, headers=()):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **dict(headers)})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(CFG, seed=0)


def _charge_at(charge, clock, tenant, cost, now=None):
    return charge(tenant, cost, now=clock[0])


@pytest.fixture(scope="module")
def fronts():
    clock = [1000.0]
    knobs = dict(slots=2, page_size=4, prefill_chunk=4, tenants=TENANTS,
                 breaker_threshold=2, breaker_cooldown_s=30.0)
    jax_ui = JaxUiServer(port=0)
    jax_ui.serve_lm(JCFG, jax.tree_util.tree_map(jnp.asarray, _tree()),
                    **knobs)
    jax_ui.start()
    port_ui = UiServer(port=0).serve_lm(
        CFG, tt.params_from_numpy(_tree(), device="cpu"), device="cpu",
        **knobs).start()
    for ui in (jax_ui, port_ui):
        srv = ui.state.lm_server
        srv.breaker._clock = lambda: clock[0]
        # the meter reads the hand-driven clock (each package's own
        # charge, bound per meter)
        meter = srv.tenants.meter
        meter.charge = functools.partial(_charge_at, meter.charge, clock)
        srv.warmup()
    yield jax_ui, port_ui, clock
    port_ui.stop()
    jax_ui.stop()


def _both(fronts, path, payload, headers=()):
    return [_post(ui.url + path, payload, headers) for ui in fronts[:2]]


def test_unknown_tenant_is_the_same_400(fronts):
    (jc, _, jb), (c, _, b) = _both(
        fronts, "/lm/generate", {"prompt_ids": PROMPT, "max_new_tokens": 2,
                                 "tenant": "nobody"})
    assert jc == c == 400 and b == jb
    assert "registered" in b["error"] and "gold" in b["error"]
    (jc, _, jb), (c, _, b) = _both(
        fronts, "/lm/generate", {"prompt_ids": PROMPT, "max_new_tokens": 2,
                                 "stream": True},
        headers={"X-Tenant": "nobody"})
    assert jc == c == 400 and b == jb


def test_over_quota_is_the_same_429_and_retry_after(fronts):
    payload = {"prompt_ids": PROMPT, "max_new_tokens": 5,
               "tenant": "metered"}                       # cost 10
    first = _both(fronts, "/lm/generate", payload)
    assert [r[0] for r in first] == [200, 200]
    assert first[0][2]["ids"] == first[1][2]["ids"]
    (jc, jh, jb), (c, h, b) = _both(fronts, "/lm/generate", payload)
    assert jc == c == 429, (jb, b)
    assert h["Retry-After"] == jh["Retry-After"] == "10"
    assert b == jb and b["retry_after_s"] == 10
    # the SSE leg is charged the same way
    (jc, jh, _), (c, h, _) = _both(fronts, "/lm/generate",
                                   {**payload, "stream": True})
    assert jc == c == 429 and h["Retry-After"] == jh["Retry-After"]
    # backing off as told finds the tokens
    fronts[2][0] += 10.0
    ok = _both(fronts, "/lm/generate", payload)
    assert [r[0] for r in ok] == [200, 200]


def test_expired_deadline_is_the_same_504(fronts):
    (jc, _, jb), (c, _, b) = _both(
        fronts, "/lm/generate", {"prompt_ids": PROMPT, "max_new_tokens": 2,
                                 "deadline_ms": 0.001})
    assert jc == c == 504
    assert b["error"].startswith("deadline exceeded after")
    (jc, _, _), (c, _, b) = _both(
        fronts, "/lm/generate", {"prompt_ids": PROMPT, "deadline_ms": -1})
    assert jc == c == 400 and "deadline_ms" in b["error"]


def test_request_id_round_trip_and_traces(fronts):
    rids = []
    for i, payload in enumerate((
            {"prompt_ids": PROMPT, "max_new_tokens": 3},
            {"prompt_ids": PROMPT, "max_new_tokens": 3, "tenant": "gold"})):
        (jc, jh, jb), (c, h, b) = _both(fronts, "/lm/generate", payload,
                                        headers={"X-Request-Id": f"r{i}"})
        assert jc == c == 200 and b == jb
        assert h["X-Request-Id"] == jh["X-Request-Id"] == f"r{i}"
        rids.append(f"r{i}")
    (_, jh, _), (_, h, _) = _both(fronts, "/lm/generate",
                                  {"prompt_ids": PROMPT,
                                   "max_new_tokens": 2})
    assert len(h["X-Request-Id"]) == len(jh["X-Request-Id"]) == 24
    rids.append(h["X-Request-Id"])
    jtr = json.loads(_get(fronts[0].url + "/trace/recent"))
    tr = json.loads(_get(fronts[1].url + "/trace/recent"))
    assert tr["recorded"] >= len(rids)
    by_id = {t["request_id"]: t for t in tr["traces"]}
    jby_id = {t["request_id"]: t for t in jtr["traces"]}
    for rid in rids:
        ours = [t for t in tr["traces"] if t["request_id"] == rid]
        assert len(ours) == 1
        names = [s["name"] for s in by_id[rid]["spans"]]
        if rid in jby_id:
            jnames = [s["name"] for s in jby_id[rid]["spans"]]
            assert names == jnames
        assert names == ["queue_wait", "decode"]
        spans = by_id[rid]["spans"]
        assert all(s["dur_s"] >= 0 for s in spans)
        assert spans[0]["t0_s"] + spans[0]["dur_s"] <= spans[1]["t0_s"] \
            + 1e-9
    chrome = json.loads(_get(fronts[1].url + "/trace/recent?format=chrome"))
    assert {e["name"] for e in chrome} >= {"lm", "queue_wait", "decode"}


def test_open_breaker_is_the_same_503_and_retry_after(fronts):
    clock = fronts[2]
    for ui in fronts[:2]:
        br = ui.state.lm_server.breaker
        br.record_failure()
        br.record_failure()
        assert br.state == "open"
    (jc, jh, jb), (c, h, b) = _both(
        fronts, "/lm/generate", {"prompt_ids": PROMPT, "max_new_tokens": 2})
    assert jc == c == 503
    assert h["Retry-After"] == jh["Retry-After"] == "30"
    assert b == jb and "circuit breaker open" in b["error"]
    ready = []
    for ui in fronts[:2]:
        try:
            _get(ui.url + "/readyz")
        except urllib.error.HTTPError as e:
            ready.append(e.code)
    assert ready == [503, 503]
    scrapes = [_get(ui.url + "/metrics").decode() for ui in fronts[:2]]
    for text in scrapes:
        assert 'serving_breaker_state{plane="lm"} 1' in text
    clock[0] += 30.0                       # the cooldown elapses
    ok = _both(fronts, "/lm/generate", {"prompt_ids": PROMPT,
                                        "max_new_tokens": 2})
    assert [r[0] for r in ok] == [200, 200]
    for ui in fronts[:2]:
        assert ui.state.lm_server.breaker.state == "closed"
        assert 'serving_breaker_state{plane="lm"} 0' in \
            _get(ui.url + "/metrics").decode()


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_families_and_text(fronts):
    _both(fronts, "/lm/generate", {"prompt_ids": PROMPT,
                                   "max_new_tokens": 2, "tenant": "gold"})
    jtext, text = [_get(ui.url + "/metrics").decode() for ui in fronts[:2]]
    assert _families(text) == _families(jtext)
    for line in text.splitlines():
        assert line.startswith("# HELP ") or line.startswith("# TYPE ") \
            or SAMPLE.match(line), line
    for fam in ("serving_requests_total", "serving_lm_tenant_requests_total",
                "serving_lm_tenant_slo_burn_rate", "server_uptime_seconds"):
        assert fam in _families(text)
    assert re.search(r'serving_lm_tenant_requests_total\{plane="lm",'
                     r'tenant="gold"\} \d+', text)


# ---------------------------------------------------------------------------
# the CLI


def _save_lm(tmp_path):
    out = tmp_path / "lm"
    out.mkdir()
    (out / "lm_config.json").write_text(json.dumps(dataclasses.asdict(CFG)))
    tree_to_npz(out / "lm_params.npz", _tree())
    return out


def test_cli_serve_ops_flags_boot_answer_and_drain(tmp_path):
    lm = _save_lm(tmp_path)
    stats = tmp_path / "drain.json"
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
         "-lm", str(lm), "-port", "0", "-device", "cpu", "-lm-slots", "2",
         "-page-size", "4", "-prefill-chunk", "4",
         "-tenants", json.dumps(TENANTS), "-breaker-threshold", "3",
         "-deadline-ms", "5000", "-max-queue", "8", "-warmup",
         "-drain-stats", str(stats)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
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
        code, hdrs, body = _post(url + "/lm/generate",
                                 {"prompt_ids": PROMPT,
                                  "max_new_tokens": 3, "tenant": "gold"},
                                 headers={"X-Request-Id": "cli-1"})
        assert code == 200 and hdrs["X-Request-Id"] == "cli-1"
        assert len(body["ids"]) == 8
        assert "serving_lm_tenant_requests_total" in \
            _get(url + "/metrics").decode()
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines)
    assert proc.returncode == 0, text
    assert "programs warm" in text
    assert ("serve: resilience max_queue=8 deadline_ms=5000.0 "
            "breaker_threshold=3 drain_grace_s=5.0") in text
    assert "serve: tenancy on — WFQ + token quotas for [default, gold, " \
        "metered]" in text
    assert "stats snapshot -> " + str(stats) in text
    snap = json.loads(stats.read_text())
    assert snap["lm"]["tenants"]["gold"]["requests"] == 1
    assert snap["lm"]["breaker_state"] == "closed"


@pytest.mark.parametrize("bad", ['{"a": {"weight": 0}}', "[1]",
                                 '{"a": {"wieght": 1}}'])
def test_cli_serve_refuses_a_bad_tenants_flag(tmp_path, bad):
    with pytest.raises(SystemExit, match="-tenants"):
        cli.main(["serve", "-lm", str(tmp_path), "-tenants", bad,
                  "-device", "cpu"])


def test_cli_train_metrics_port_serves_the_step_count(csv_file, tmp_path,
                                                      monkeypatch):
    """The telemetry endpoint is scraped once, just before the run stops
    it: its step counter equals the steps taken."""
    from deeplearning4j_tpu_torch.obs import http as obs_http

    scraped = {}
    real_stop = obs_http.MetricsServer.stop

    def stop(self):
        scraped["text"] = _get(self.url + "/metrics").decode()
        real_stop(self)

    monkeypatch.setattr(obs_http.MetricsServer, "stop", stop)
    rc = cli.main(["train", "-input", str(csv_file), "-model",
                   "zoo:iris-mlp", "-output", str(tmp_path / "out"),
                   "-epochs", "2", "-batch", "10", "-device", "cpu",
                   "-metrics-port", "0", "-metrics-interval", "1"])
    assert rc == 0
    n = int(re.search(r'train_steps_total\{job="train"\} (\d+)',
                      scraped["text"]).group(1))
    rows = sum(1 for _ in open(csv_file))
    assert n == 2 * -(-rows // 10)
    assert 'train_loss{job="train"}' in scraped["text"]
