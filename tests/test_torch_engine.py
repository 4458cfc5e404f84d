"""PyTorch port: the classifier `ServingEngine` and its `MicroBatcher`
against the JAX package's, on the same weights (`params_from_numpy`) and
the same seeded requests, on the CPU:

- iris-mlp and a char-LSTM of hidden 16 (with and without length
  buckets): replies within 1e-6 relative of JAX's;
- coalescing: a dispatch gate holds the first dispatch while the other
  requests queue, so both packages dispatch twice for 8 requests; each
  coalesced reply within 1e-6 of the same rows dispatched alone (not
  byte-equal: the dense product is not batch-invariant);
- the signature guard's `UnservableShapeError` at the same shape, with
  the same bound;
- admission 503 with the same ``retry_after_s``, the deadline shed,
  poison bisection (one isolated poison counted on both), the tenant 429,
  drain;
- int8 serving's top-1 agreement with the float net equal to JAX's;
- ``stats()`` keys equal.
"""

import re
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.resilience import chaos as jchaos
from deeplearning4j_tpu.serving import BucketLadder as JLadder
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu.serving import resilience as jres
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.resilience import chaos as tchaos
from deeplearning4j_tpu_torch.serving import BucketLadder as TLadder
from deeplearning4j_tpu_torch.serving import ServingEngine as TEngine
from deeplearning4j_tpu_torch.serving import resilience as tres
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

RTOL = 1e-6
PACKAGES = ("jax", "port")


def _pair(jc):
    jn = JNet(jc).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(jc.to_json()),
              device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return {"jax": jn, "port": tn}


def _engines(nets, ladder, **kw):
    lad = {"jax": JLadder, "port": TLadder}
    eng = {"jax": JEngine, "port": TEngine}
    return {p: eng[p](nets[p], ladder=lad[p](**ladder), **kw)
            for p in PACKAGES}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.fixture(scope="module")
def iris():
    return _pair(jzoo.iris_mlp())


def _rows(n, feats=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, feats)).astype(np.float32)


class _Gate:
    """Holds the first dispatch until `release()`: every request sent
    meanwhile queues, and the next dispatch takes them all."""

    def __init__(self, engine):
        self.engine = engine
        self.inner = engine.batcher._dispatch
        self.event = threading.Event()
        self.entered = threading.Event()
        self.calls = 0
        engine.batcher._dispatch = self

    def __call__(self, x, mask, n_real):
        self.calls += 1
        if self.calls == 1:
            self.entered.set()
            assert self.event.wait(60)
        return self.inner(x, mask, n_real)

    def release(self):
        self.event.set()


def _storm(engine, reqs, queued_before_release=None, **submit):
    """Submit `reqs` from one thread each with the first dispatch gated;
    returns (replies or exceptions, gate)."""
    gate = _Gate(engine)
    out = [None] * len(reqs)

    def client(i):
        try:
            out[i] = engine.predict_proba(reqs[i], **submit)
        except Exception as e:  # noqa: BLE001 — the test compares them
            out[i] = e

    threads = [threading.Thread(target=client, args=(0,))]
    threads[0].start()
    assert gate.entered.wait(60)
    for i in range(1, len(reqs)):
        threads.append(threading.Thread(target=client, args=(i,)))
        threads[-1].start()
    want = len(reqs) - 1 if queued_before_release is None \
        else queued_before_release
    t0 = time.perf_counter()
    while len(engine.batcher._queue) < want:
        assert time.perf_counter() - t0 < 60
        time.sleep(0.005)
    gate.release()
    for t in threads:
        t.join(60)
    return out, gate


def test_iris_replies_match_jax(iris):
    engines = _engines(iris, dict(batch_buckets=(1, 8)), max_batch=8)
    try:
        for n in (1, 3, 8):
            x = _rows(n, seed=n)
            _close(engines["port"].predict_proba(x),
                   engines["jax"].predict_proba(x))
            assert np.array_equal(engines["port"].predict(x),
                                  engines["jax"].predict(x))
    finally:
        for e in engines.values():
            e.stop()


def test_concurrent_requests_coalesce_like_jax(iris):
    reqs = [_rows(1 + i % 2, seed=10 + i) for i in range(8)]
    for pkg in PACKAGES:
        eng = _engines(iris, dict(batch_buckets=(1, 8, 16)),
                       max_batch=16)[pkg]
        try:
            eng.warmup(np.zeros(4, np.float32))
            out, gate = _storm(eng, reqs)
            stats = eng.stats()
            assert gate.calls == 2 == stats["dispatches"] < len(reqs)
            for x, got in zip(reqs, out):
                _close(got, eng.predict_proba(x))      # alone, sequential
        finally:
            eng.stop()


def test_guard_refuses_the_same_shape_with_the_same_bound(iris):
    msgs = {}
    for pkg in PACKAGES:
        eng = _engines(iris, dict(batch_buckets=(1, 8)), max_batch=8,
                       input_dtype=None)[pkg]
        try:
            assert eng.warmup(np.zeros(4, np.float32)) == 2
            err = (jres if pkg == "jax" else tres).UnservableShapeError
            with pytest.raises(err) as info:
                eng.predict_proba(np.zeros((1, 5), np.float32))
            msgs[pkg] = str(info.value)
            assert eng.stats()["compiled_programs"] == 2
        finally:
            eng.stop()
    prefix = ("compile-count guard: dispatch shape (1, 5) (<f4) would "
              "exceed the 2-program bound (seen: [(1, 4), (8, 4)]")
    assert msgs["jax"].startswith(prefix) and msgs["port"].startswith(prefix)
    # both name the builds their watcher observed, in the same words
    observed = re.compile(r"; compiles_total observed: \d+\); the bucket "
                          r"ladder is not covering the traffic$")
    assert observed.search(msgs["jax"]) and observed.search(msgs["port"])


def test_admission_503_carries_the_same_retry_after(iris):
    got = {}
    for pkg in PACKAGES:
        eng = _engines(iris, dict(batch_buckets=(1, 8)), max_batch=8,
                       max_queue_depth=1)[pkg]
        try:
            reqs = [_rows(1, seed=i) for i in range(3)]
            gate = _Gate(eng)
            threads = [threading.Thread(target=eng.predict_proba,
                                        args=(reqs[i],)) for i in range(2)]
            threads[0].start()
            assert gate.entered.wait(60)
            threads[1].start()
            while len(eng.batcher._queue) < 1:
                time.sleep(0.005)
            err = (jres if pkg == "jax" else tres).ServingOverloadError
            with pytest.raises(err) as info:
                eng.predict_proba(reqs[2])
            got[pkg] = info.value.retry_after_s
            gate.release()
            for t in threads:
                t.join(60)
            assert eng.stats()["rejected"] == 1
        finally:
            eng.stop()
    assert got["port"] == pytest.approx(got["jax"]) and got["port"] >= 0.1


def test_expired_deadline_is_shed_before_dispatch(iris):
    for pkg in PACKAGES:
        eng = _engines(iris, dict(batch_buckets=(1, 8)), max_batch=8)[pkg]
        try:
            gate = _Gate(eng)
            first = threading.Thread(target=eng.predict_proba,
                                     args=(_rows(1),))
            first.start()
            assert gate.entered.wait(60)
            box = []

            def doomed():
                try:
                    eng.predict_proba(_rows(1, seed=1), deadline_s=0.01)
                except Exception as e:  # noqa: BLE001 — inspected below
                    box.append(e)

            t = threading.Thread(target=doomed)
            t.start()
            t0 = time.perf_counter()
            while not eng.batcher._queue and time.perf_counter() - t0 < 60:
                time.sleep(0.005)
            time.sleep(0.05)           # its 10 ms expire while it queues
            gate.release()
            first.join(60)
            t.join(60)
            err = (jres if pkg == "jax" else tres).DeadlineExceededError
            assert len(box) == 1 and isinstance(box[0], err)
            assert "shed before dispatch" in str(box[0])
            s = eng.stats()
            assert (s["shed"], s["deadline_missed"], gate.calls) == (1, 1, 1)
        finally:
            eng.stop()


def test_poison_is_bisected_out_and_counted(iris):
    reqs = [_rows(1, seed=20 + i) for i in range(4)]
    reqs[2] = np.full((1, 4), 7.0, np.float32)
    seen = {}
    for pkg in PACKAGES:
        eng = _engines(iris, dict(batch_buckets=(1, 8)), max_batch=8)[pkg]
        ch = jchaos if pkg == "jax" else tchaos
        try:
            eng.batcher._dispatch = ch.chaos_dispatch(
                eng.batcher._dispatch, ch.ServingChaosConfig(
                    poison_value=7.0))
            out, _ = _storm(eng, reqs)
            assert isinstance(out[2], ch.InjectedDispatchFault)
            for i in (0, 1, 3):
                assert isinstance(out[i], np.ndarray)
                _close(out[i], eng.predict_proba(reqs[i]))
            seen[pkg] = (eng.stats()["poison_isolated"],
                         eng.stats()["breaker_state"])
        finally:
            eng.stop()
    assert seen["jax"] == seen["port"] == (1, "closed")


def test_tenant_over_quota_is_a_typed_429(iris):
    tenants = {"metered": {"rate": 0.001, "burst": 2.0}}
    for pkg in PACKAGES:
        eng = _engines(iris, dict(batch_buckets=(1, 8)), max_batch=8,
                       tenants=tenants)[pkg]
        res = jres if pkg == "jax" else tres
        try:
            eng.predict_proba(_rows(2), tenant="metered")
            with pytest.raises(res.TenantQuotaError) as info:
                eng.predict_proba(_rows(1), tenant="metered")
            assert info.value.retry_after_s > 0
            with pytest.raises(ValueError, match="metered"):
                eng.predict_proba(_rows(1), tenant="nobody")
            eng.predict_proba(_rows(3))            # the default tenant
            t = eng.stats()["tenants"]
            assert t["metered"]["throttled"] == 1
            assert t["metered"]["requests"] == t["default"]["requests"] == 1
        finally:
            eng.stop()


def test_drain_stops_admission_and_finishes_work(iris):
    for pkg in PACKAGES:
        eng = _engines(iris, dict(batch_buckets=(1, 8)), max_batch=8)[pkg]
        res = jres if pkg == "jax" else tres
        eng.predict_proba(_rows(1))
        assert eng.ready()
        eng.begin_drain()
        assert not eng.ready() and not eng.accepting
        with pytest.raises(res.ServingUnavailableError):
            eng.predict_proba(_rows(1))
        assert eng.drain(1.0) is True


@pytest.mark.parametrize("length_buckets", [None, (8, 16)])
def test_char_lstm_replies_match_jax(length_buckets):
    nets = _pair(jzoo.char_lstm(vocab_size=12, hidden=16))
    ladder = dict(batch_buckets=(1, 4), length_buckets=length_buckets)
    engines = _engines(nets, ladder, max_batch=4)
    rng = np.random.default_rng(3)
    try:
        # without length buckets every request has the ladder's one T
        lengths = (5, 5, 5) if length_buckets is None else (5, 8, 13)
        for n, t in zip((1, 3, 4), lengths):
            x = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (n, t))]
            got = engines["port"].predict_proba(x)
            assert got.shape == (n, t, 12)
            _close(got, engines["jax"].predict_proba(x))
        warmed = {p: e.warmup(np.zeros((5, 12), np.float32))
                  for p, e in engines.items()}
        assert warmed["jax"] == warmed["port"] == (
            2 if length_buckets is None else 4)
    finally:
        for e in engines.values():
            e.stop()


def test_int8_agreement_equals_jax(iris):
    x = _rows(256, seed=5) * 2.0
    agree = {}
    for pkg in PACKAGES:
        eng = _engines(iris, dict(batch_buckets=(1, 8, 32)), max_batch=32,
                       quantize="int8")[pkg]
        try:
            eng.warmup(np.zeros(4, np.float32))
            q = np.concatenate([eng.predict(x[i:i + 32])
                                for i in range(0, 256, 32)])
            f = np.asarray(iris[pkg].output(x)).argmax(-1)
            agree[pkg] = (float(np.mean(q == f)), q)
            assert eng.stats()["quantization"]["quantized_layers"] == 3
        finally:
            eng.stop()
    assert agree["port"][0] == agree["jax"][0] >= 0.95
    assert np.array_equal(agree["port"][1], agree["jax"][1])


def test_stats_keys_equal_jax(iris):
    keys = {}
    for pkg in PACKAGES:
        eng = _engines(iris, dict(batch_buckets=(1, 8)), max_batch=8,
                       quantize="int8")[pkg]
        try:
            eng.warmup(np.zeros(4, np.float32))
            eng.predict_proba(_rows(2))
            s = eng.stats()
            keys[pkg] = (sorted(s), sorted(s["quantization"]))
            assert s["requests"] == s["dispatches"] == 1
            assert s["compiled_programs"] == s["program_bound"] == 2
        finally:
            eng.stop()
    assert keys["port"] == keys["jax"]
