"""PyTorch port: the circuit breaker (`serving/resilience.py`
`CircuitBreaker`, `check_admission(breaker=)`) and the LM pool's use of
it, against the JAX package's.

- The breaker's lifecycle under a fake clock: the same scripts of
  failures, successes, dispatch gates, probe abandons and clock moves
  give the same states, gate answers, ``retry_after_s`` floats, open
  counts and listener transitions on both packages' breakers.
- The LM pool (2 layers, float32, both packages side by side): a
  dispatch that raises on request opens the breaker after the threshold,
  admission then fails fast with `CircuitOpenError` (the dispatch is not
  called), ``/readyz``'s `ready()` is false, the breaker gauge follows,
  and after the cooldown (a fake clock) a probe closes it and the ids
  equal the JAX package's `generate`.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.serving import lm as jlm
from deeplearning4j_tpu.serving import resilience as jres
from deeplearning4j_tpu.serving.metrics import ServingMetrics as JMetrics
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import lm as tlm
from deeplearning4j_tpu_torch.serving import resilience as tres
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

JCFG = jt.TransformerConfig(vocab_size=50, d_model=16, n_heads=2,
                            n_layers=2, d_ff=32, max_len=32)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))


# ---------------------------------------------------------------------------
# the breaker alone


SCRIPTS = {
    # N failures open it; the cooldown elapsing is half-open; a probe's
    # success closes it
    "open_probe_close": ["fail", "fail", "gate", "fail", "state", "gate",
                         "retry", "tick:4", "retry", "state", "tick:7",
                         "state", "gate", "gate", "ok", "state", "gate"],
    # a failed probe re-opens with a fresh cooldown
    "probe_fails": ["fail", "fail", "fail", "tick:11", "gate", "fail",
                    "state", "retry", "tick:5", "gate", "tick:6", "gate",
                    "ok", "state"],
    # a success resets the consecutive count
    "success_resets": ["fail", "fail", "ok", "fail", "fail", "state",
                       "fail", "state", "rejecting"],
    # a claimed probe that never dispatched is given back
    "abandon": ["fail", "fail", "fail", "tick:10", "gate", "gate",
                "abandon", "gate", "ok", "state"],
    # gates while closed never claim anything
    "closed_gates": ["gate", "gate", "ok", "state", "retry", "rejecting"],
}


def _run_script(mod, script):
    now = [0.0]
    seen = []
    br = mod.CircuitBreaker(failure_threshold=3, cooldown_s=10.0,
                            clock=lambda: now[0],
                            on_transition=seen.append)
    extra = []
    br.add_listener(extra.append)
    br.add_listener(extra.append)         # idempotent per callable
    out = []
    for step in script:
        if step == "fail":
            br.record_failure()
        elif step == "ok":
            br.record_success()
        elif step == "gate":
            out.append(("gate", br.allow_dispatch()))
        elif step == "abandon":
            br.abandon_probe()
        elif step == "state":
            out.append(("state", br.state))
        elif step == "retry":
            out.append(("retry", br.retry_after_s()))
        elif step == "rejecting":
            out.append(("rejecting", br.rejecting()))
        else:
            now[0] += float(step.split(":")[1])
    return out, seen, extra, br.opens


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_lifecycle_matches(name):
    ours = _run_script(tres, SCRIPTS[name])
    theirs = _run_script(jres, SCRIPTS[name])
    assert ours == theirs
    assert ours[1] == ours[2]


def test_breaker_lifecycle_reads_as_documented():
    out, seen, _, opens = _run_script(tres, SCRIPTS["open_probe_close"])
    assert out[0] == ("gate", True)                 # closed: flows
    assert out[1] == ("state", "open")
    assert out[2] == ("gate", False)                # inside the cooldown
    assert out[3] == ("retry", 10.0)
    assert out[4] == ("retry", 6.0)
    assert out[6] == ("state", "half_open")          # cooldown elapsed
    assert out[7:9] == [("gate", True), ("gate", False)]  # one probe
    assert out[9] == ("state", "closed")
    assert seen == ["open", "half_open", "closed"] and opens == 1


@pytest.mark.parametrize("kw,match", [
    ({"failure_threshold": 0}, "failure_threshold"),
    ({"cooldown_s": -1.0}, "cooldown_s")])
def test_breaker_validation_matches(kw, match):
    for mod in (tres, jres):
        with pytest.raises(ValueError, match=match):
            mod.CircuitBreaker(**kw)


def test_check_admission_with_an_open_breaker_matches():
    got = []
    for mod, metrics in ((tres, ServingMetrics()), (jres, JMetrics())):
        now = [0.0]
        br = mod.CircuitBreaker(failure_threshold=1, cooldown_s=2.5,
                                clock=lambda: now[0])
        br.record_failure()
        with pytest.raises(mod.CircuitOpenError) as err:
            mod.check_admission(accepting=True, breaker=br, queue_depth=0,
                                max_queue_depth=4, metrics=metrics,
                                retry_after_s=lambda: 9.0, what="LM")
        got.append((str(err.value), err.value.retry_after_s,
                    metrics.snapshot()["rejected"]))
        now[0] = 3.0                         # cooldown over: admits
        mod.check_admission(accepting=True, breaker=br, queue_depth=0,
                            max_queue_depth=4, metrics=metrics,
                            retry_after_s=lambda: 9.0, what="LM")
        assert issubclass(mod.CircuitOpenError, mod.ServingOverloadError)
    assert got[0] == got[1] == (got[0][0], 2.5, 1)


# ---------------------------------------------------------------------------
# the LM pool's breaker


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(CFG, seed=1)


@functools.lru_cache(maxsize=8)
def _want(prompt: tuple, new: int) -> list:
    out = jgen.generate(JCFG, jax.tree_util.tree_map(jnp.asarray, _tree()),
                        np.asarray([prompt], np.int32), new)
    return np.asarray(out)[0].tolist()


class InjectedDispatchFault(RuntimeError):
    pass


class _FailingDispatch:
    """Wraps the pool's dispatch entry: raises while `fail` is above 0
    (counting down), else dispatches; counts every call."""

    def __init__(self, srv):
        self.fail = 0
        self.calls = 0
        real = srv._step

        def step(*args):
            self.calls += 1
            if self.fail > 0:
                self.fail -= 1
                raise InjectedDispatchFault("chaos: injected decode fault")
            return real(*args)

        srv._step = step


def test_lm_breaker_opens_fast_fails_and_recovers():
    states = {}
    for name, mod, make in (
            ("port", tres, lambda br: tlm.ContinuousLMServer(
                CFG, _tree(), slots=2, page_size=4, breaker=br,
                device="cpu")),
            ("jax", jres, lambda br: jlm.ContinuousLMServer(
                JCFG, jax.tree_util.tree_map(jnp.asarray, _tree()),
                slots=2, page_size=4, breaker=br))):
        now = [0.0]
        br = mod.CircuitBreaker(failure_threshold=2, cooldown_s=5.0,
                                clock=lambda: now[0])
        srv = make(br)
        seen = []
        try:
            srv.warmup()
            assert srv.generate([1, 2], 2, timeout=120) == _want((1, 2), 2)
            chaos = _FailingDispatch(srv)
            chaos.fail = 2
            for _ in range(2):
                with pytest.raises(InjectedDispatchFault):
                    srv.generate([3, 4], 2, timeout=120)
                seen.append(srv.stats()["breaker_state"])
            assert not srv.ready()
            calls = chaos.calls
            with pytest.raises(mod.CircuitOpenError) as err:
                srv.generate([5, 6], 2, timeout=120)
            assert err.value.retry_after_s == 5.0
            assert chaos.calls == calls          # refused before dispatch
            now[0] = 5.0                          # the cooldown elapses
            seen.append(br.state)
            out = srv.generate([1, 2, 3], 3, timeout=120)   # the probe
            assert out == _want((1, 2, 3), 3)
            snap = srv.stats()
            seen += [snap["breaker_state"], snap["breaker_opens"],
                     snap["rejected"], snap["requests"], srv.ready()]
        finally:
            srv.stop()
        states[name] = seen
    assert states["port"] == states["jax"]
    assert states["port"] == ["closed", "open", "half_open", "closed", 1,
                              1, 2, True]


def test_open_breaker_fails_the_lanes_in_flight():
    """A request admitted once the cooldown has passed, while another
    caller holds the half-open probe, meets a closed dispatch gate: it
    fails with `CircuitOpenError`, its pages return to the pool and the
    ledger counts it as shed.  Once the probe is given back
    (`abandon_probe`), the next dispatch is the probe and closes the
    breaker."""
    now = [0.0]
    br = tres.CircuitBreaker(failure_threshold=1, cooldown_s=5.0,
                             clock=lambda: now[0])
    srv = tlm.ContinuousLMServer(CFG, _tree(), slots=2, page_size=4,
                                 breaker=br, device="cpu")
    try:
        srv.warmup()
        br.record_failure()
        assert br.state == "open"
        now[0] = 5.0
        assert br.allow_dispatch()       # someone else holds the probe
        with pytest.raises(tres.CircuitOpenError):
            srv.generate([7, 8], 2, timeout=120)
        assert srv.page_ledger()["balanced"]
        assert srv.stats()["shed"] == 1
        br.abandon_probe()
        assert srv.generate([1, 2], 2, timeout=120) == _want((1, 2), 2)
        assert br.state == "closed" and srv.ready()
    finally:
        srv.stop()
