"""PyTorch port: the thread-hosted serving fleet (`serving/fleet.py`)
against the JAX package's, over iris-mlp replicas on the CPU:

- routing: least-loaded with name ties, the excluded set, and rendezvous
  affinity pick the same replicas as JAX's router for the same names and
  keys;
- failover: a storm with one replica killed mid-storm by `chaos_fleet`
  completes with zero failed requests, the failovers counted and the
  corpse ejected by health polls;
- health: a flapping ``/readyz`` ejects a replica and the half-open probe
  re-admits it;
- a rolling swap under live traffic with zero 5xx, every answer after the
  flip from the new weights; `check_fleet_ledger` balanced across a swap
  (the retired replicas folded in); autoscale up and down through drain;
- `FleetServer`: the same status codes and bodies as JAX's front on one
  script (predict, client errors, stats, metrics families, drain);
- the ``serve-fleet`` CLI: its refusals (``-processes`` names A5 part 2)
  and a child-process boot, answer and SIGTERM drain.
"""

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
from deeplearning4j_tpu.serving import BucketLadder as JLadder
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.resilience import (
    FleetChaosConfig,
    chaos_fleet,
)
from deeplearning4j_tpu_torch.serving import BucketLadder as TLadder
from deeplearning4j_tpu_torch.serving import fleet as tfleet
from deeplearning4j_tpu_torch.serving.resilience import (
    BREAKER_CLOSED,
    ServingUnavailableError,
)
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

WARM = np.zeros((4,), np.float32)
COMPILE_FAMILIES = {"compiles_total", "compile_seconds_total"}


def _nets(seed=0):
    import jax

    jn = JNet(jzoo.iris_mlp()).init(jax.random.PRNGKey(seed))
    tn = TNet(tconf.MultiLayerConfiguration.from_json(
        jzoo.iris_mlp().to_json()), device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


def _tfactory(net):
    def factory(name):
        return tfleet.spawn_local_replica(
            name, net, ladder=TLadder((1, 8)), max_wait_ms=1.0,
            warmup_example=WARM, device="cpu")
    return factory


def _jfactory(net):
    def factory(name):
        return jfleet.spawn_local_replica(
            name, net, ladder=JLadder((1, 8)), max_wait_ms=1.0,
            warmup_example=WARM)
    return factory


def _post(url, payload, headers=()):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **dict(headers)})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def nets():
    return _nets(0), _nets(1)


def test_picks_match_jax_router():
    routers = []
    for mod in (jfleet, tfleet):
        r = mod.FleetRouter()
        for n in ("a", "b", "c", "d"):
            r.attach(mod.Replica(n, f"http://127.0.0.1:1/{n}"))
        routers.append(r)
    for r in routers:
        assert r._pick().name == "a"
        assert r._pick(frozenset({"a", "b"})).name == "c"
        assert r._pick(frozenset({"a", "b", "c", "d"})) is None
    keys = [f"prefix-{i}" for i in range(32)] + ["session:s1", "1,2,3"]
    jpicks = [routers[0]._pick(key=k).name for k in keys]
    picks = [routers[1]._pick(key=k).name for k in keys]
    assert picks == jpicks and len(set(picks)) > 1
    for r in routers:
        r.replicas()[0].in_flight, r.replicas()[1].in_flight = 2, 1
    assert [r._pick().name for r in routers] == ["c", "c"]
    for r in routers:       # a backed-up preferred replica spills
        pref = r._pick(key="prefix-1")
        pref.in_flight = r.affinity_spill_depth + 3
        assert r._pick(key="prefix-1").name != pref.name
    with pytest.raises(ServingUnavailableError, match="no routable"):
        tfleet.FleetRouter().predict_proba(np.zeros((1, 4), np.float32))


def test_mid_storm_kill_fails_over_with_zero_failed(nets):
    (_, tn), _ = nets
    conc, total = 16, 48
    router = tfleet.FleetRouter(_tfactory(tn), replicas=3,
                                request_timeout_s=60.0)
    chaos = chaos_fleet(router, FleetChaosConfig(kill_at_attempt=12))
    reqs = np.random.default_rng(0).random((total, 1, 4)).astype(np.float32)
    results, errors = [None] * total, []
    barrier = threading.Barrier(conc)

    def client(cid):
        try:
            barrier.wait()
            for i in range(cid, total, conc):
                results[i] = router.predict_proba(reqs[i], timeout=60)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(conc)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        chaos.uninstall()
        dead = next(r for r in router.replicas()
                    if r.name == chaos.killed[0])
        for _ in range(10):
            if not dead.routable():
                break
            router.poll_health_once()
        stats = router.fleet_stats()
    finally:
        router.stop()
    assert not errors and len(chaos.killed) == 1
    assert router.failovers >= 1 and not dead.routable()
    assert stats["fleet"]["requests"] == total
    assert stats["fleet"]["replicas_routable"] == 2
    ledger = tfleet.check_fleet_ledger(stats, submitted=total)
    assert ledger["client_balanced"] is True
    want = tn.output(reqs[5]).numpy()
    np.testing.assert_allclose(results[5], want, rtol=1e-6, atol=1e-7)


def test_flaky_readyz_ejects_then_readmits(nets):
    (_, tn), _ = nets
    router = tfleet.FleetRouter(_tfactory(tn), replicas=2,
                                replica_breaker_threshold=2,
                                replica_breaker_cooldown_s=0.3)
    chaos = chaos_fleet(router, FleetChaosConfig(
        flaky_readyz_polls=(0, 1), flaky_replica="replica-0"))
    try:
        victim = router.replicas()[0]
        assert router.poll_health_once()["replica-0"] is False
        assert victim.routable()
        assert router.poll_health_once()["replica-0"] is False
        assert not victim.routable() and victim.ejections == 1
        assert "replica-0" not in router.poll_health_once()
        time.sleep(0.35)
        assert router.poll_health_once()["replica-0"] is True
        assert victim.routable() and victim.readmissions == 1
        assert victim.breaker.state == BREAKER_CLOSED
        summary = router.fleet_stats()["replicas"][0]
        assert (summary["ejections"], summary["readmissions"]) == (1, 1)
    finally:
        chaos.uninstall()
        router.stop()


def test_rolling_swap_under_traffic_zero_5xx(nets):
    (_, old), (_, new) = nets
    x = np.linspace(0, 1, 4, dtype=np.float32).reshape(1, 4)
    old_out, new_out = old.output(x).numpy(), new.output(x).numpy()
    assert not np.allclose(old_out, new_out)
    router = tfleet.FleetRouter(_tfactory(old), replicas=2)
    stop, errors, seen = threading.Event(), [], []

    def live():
        while not stop.is_set():
            try:
                out = router.predict_proba(x, timeout=30)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)
                return
            seen.append(out)
            if not (np.allclose(out, old_out, rtol=1e-6)
                    or np.allclose(out, new_out, rtol=1e-6)):
                errors.append(AssertionError(f"mixed weights {out}"))
                return

    clients = [threading.Thread(target=live) for _ in range(4)]
    try:
        for t in clients:
            t.start()
        steps = router.rolling_swap(_tfactory(new), grace_s=10.0)
    finally:
        stop.set()
        for t in clients:
            t.join(30)
    try:
        assert not errors and seen
        assert len(steps) == 2 and all(s["drained"] for s in steps)
        assert {r.name for r in router.replicas()} == {"replica-2",
                                                       "replica-3"}
        assert all(r.version == 1 for r in router.replicas())
        np.testing.assert_allclose(router.predict_proba(x), new_out,
                                   rtol=1e-6)
    finally:
        router.stop()


def test_ledger_balances_across_a_rolling_swap(nets):
    """The retired replicas' final counts fold into the `retired`
    aggregate, so the ledger still balances after a swap (without live
    traffic: a replica whose stats cannot be fetched in time as it
    retires is counted lost, by the JAX package's rule)."""
    (_, tn), _ = nets
    x = np.zeros((1, 4), np.float32)
    router = tfleet.FleetRouter(_tfactory(tn), replicas=2)
    try:
        for _ in range(6):
            router.predict_proba(x, timeout=30)
        router.rolling_swap(_tfactory(tn))
        for _ in range(4):
            router.predict_proba(x, timeout=30)
        stats = router.fleet_stats()
        assert stats["retired"]["aggregate"]["requests"] == 6
        assert stats["retired"]["lost"] == 0
        assert stats["ledger"]["balanced"] is True
        assert stats["ledger"]["fleet_requests"] == 10
        assert tfleet.check_fleet_ledger(
            stats, submitted=10)["client_balanced"] is True
    finally:
        router.stop()


def test_autoscale_up_then_down(nets):
    (_, tn), _ = nets
    router = tfleet.FleetRouter(_tfactory(tn), replicas=1, min_replicas=1,
                                max_replicas=2, scale_up_depth=2.0,
                                scale_down_depth=0.5)
    try:
        first = router.replicas()[0]
        first.in_flight = 5
        assert router.autoscale_tick() == 1 and len(router.replicas()) == 2
        assert router.autoscale_tick() == 0
        first.in_flight = 0
        assert router.autoscale_tick(grace_s=5.0) == -1
        assert (router.scale_ups, router.scale_downs) == (1, 1)
        assert len(router.replicas()) == 1
        assert router.queue_depth_by_role() == {"both": 0}
    finally:
        router.stop()


def _script(front_url, x):
    """One request script; every answer as (status, body) with the
    payload-dependent numbers taken out for separate comparison."""
    out = []
    out.append(("healthz",) + _get(front_url + "/healthz"))
    out.append(("readyz",) + _get(front_url + "/readyz"))
    code, _, body = _post(front_url + "/model/predict",
                          {"features": x.tolist()},
                          headers={"X-Request-Id": "fleet-1"})
    out.append(("predict", code, body))
    for bad in ({"features": []}, {"features": [[0.0] * 4],
                                   "deadline_ms": -5},
                {"prompt_ids": []}):
        path = "/lm/generate" if "prompt_ids" in bad else "/model/predict"
        code, _, body = _post(front_url + path, bad)
        out.append(("bad", code, body))
    out.append(("404",) + _post(front_url + "/nowhere", {})[::2])
    return out


def test_fleet_server_answers_like_jax(nets):
    (jn, tn), _ = nets
    jrouter = jfleet.FleetRouter(_jfactory(jn), replicas=2)
    router = tfleet.FleetRouter(_tfactory(tn), replicas=2)
    jfront = jfleet.FleetServer(jrouter, port=0).start()
    front = tfleet.FleetServer(router, port=0).start()
    x = np.eye(4, dtype=np.float32)[:3]
    try:
        jans, ans = _script(jfront.url, x), _script(front.url, x)
        for (jname, jcode, jbody), (name, code, body) in zip(jans, ans):
            assert (name, code) == (jname, jcode)
            if name == "predict":
                assert body["predictions"] == jbody["predictions"]
                np.testing.assert_allclose(body["outputs"],
                                           jbody["outputs"], rtol=1e-6)
            else:
                assert body == jbody, name
        jstats = json.loads(_get(jfront.url + "/fleet/stats")[1])
        stats = json.loads(_get(front.url + "/fleet/stats")[1])
        assert sorted(stats) == sorted(jstats)
        assert sorted(stats["fleet"]) == sorted(jstats["fleet"])
        assert sorted(stats["ledger"]) == sorted(jstats["ledger"])
        assert stats["ledger"]["balanced"] is True
        assert stats["fleet"]["requests"] == jstats["fleet"]["requests"]
        for e, je in zip(stats["replicas"], jstats["replicas"]):
            assert sorted(e) == sorted(je)
            assert sorted(e["stats"]) == sorted(je["stats"])
        cheap = json.loads(_get(front.url + "/serving/stats")[1])
        assert "ledger" not in cheap and "stats" not in cheap["replicas"][0]

        def fams(t):
            return {ln.split()[2] for ln in t.splitlines()
                    if ln.startswith("# TYPE ")}
        jtext = _get(jfront.url + "/metrics")[1].decode()
        text = _get(front.url + "/metrics")[1].decode()
        assert fams(text) == fams(jtext) - COMPILE_FAMILIES
        assert 'fleet_replica_dispatches_total{replica="replica-0"}' in text
        # fleet-wide drain: 503 with the same body, /readyz flips
        assert front.drain(5.0) is True and jfront.drain(5.0) is True
        (jc, jh, jb), (c, h, b) = [_post(u + "/model/predict",
                                         {"features": x.tolist()})
                                   for u in (jfront.url, front.url)]
        assert jc == c == 503 and b == jb
        assert h["Retry-After"] == jh["Retry-After"]
        (jc, jb), (c, b) = [_get(u + "/readyz")
                            for u in (jfront.url, front.url)]
        assert jc == c == 503 and json.loads(b) == json.loads(jb)
    finally:
        front.stop()
        jfront.stop()


@pytest.mark.parametrize("argv,message", [
    ([], "serve-fleet needs -model and/or -lm"),
    (["-model", "zoo:iris-mlp", "-replicas", "0"],
     "-replicas must be >= 1, got 0"),
    (["-model", "zoo:iris-mlp", "-prefill-workers", "1",
      "-decode-workers", "1"],
     "serve-fleet: -prefill-workers/-decode-workers need -lm"),
    (["-model", "zoo:iris-mlp", "-lm", "x", "-prefill-workers", "1"],
     "serve-fleet: a disaggregated fleet needs BOTH -prefill-workers >= 1 "
     "and -decode-workers >= 1 (got 1/0)"),
    (["-model", "zoo:iris-mlp", "-processes"], "ROADMAP.md, A5 part 2")])
def test_cli_serve_fleet_refusals(argv, message):
    with pytest.raises(SystemExit) as info:
        cli.main(["serve-fleet", "-device", "cpu"] + argv)
    assert message in str(info.value)


def test_cli_serve_fleet_boots_answers_and_drains(tmp_path):
    stats = tmp_path / "fleet.json"
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli",
         "serve-fleet", "-model", "zoo:iris-mlp", "-replicas", "2",
         "-buckets", "1,8", "-warmup", "-port", "0", "-device", "cpu",
         "-health-interval-s", "0.2", "-drain-stats", str(stats)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    try:
        url = None
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"Serving fleet on (http://\S+)", line)
            if m:
                url = m.group(1)
                break
        assert url, "".join(lines)
        code, _, body = _post(url + "/model/predict",
                              {"features": [[0.1, 0.2, 0.3, 0.4]] * 2})
        assert code == 200 and len(body["predictions"]) == 2
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines)
    assert proc.returncode == 0, text
    assert "serve-fleet: 2 warm replicas in rotation (replica-0, " \
        "replica-1)" in text
    snap = json.loads(stats.read_text())
    assert snap["fleet"]["requests"] == 1 and snap["ledger"]["balanced"]
