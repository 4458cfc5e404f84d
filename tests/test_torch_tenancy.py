"""PyTorch port: multi-tenant traffic shaping (`serving/tenancy.py` and the
`ContinuousLMServer(tenants=)` plane) against the JAX package's.

Every unit runs the JAX module and the port's copy side by side on the
same seeded inputs, with the clock driven through ``now=``: spec
validation messages, the registry's JSON and coerce contract, the token
bucket's ledgers and its ``Retry-After`` (equal floats), the WFQ
virtual finish times, the SLO burn rate and victim ordering.  The pool
cases build both packages' pools on one float32 config and compare
queue orders, quota refusals, the L4 shed and preemption victims.  The
live cases hold the first lane at a gate on the pool's dispatch entry
(`test_torch_pressure._Gate`), so the queue's order is decided before
anything decodes: no case depends on thread timing.
"""

import dataclasses
import functools
import json
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.serving import lm as jlm
from deeplearning4j_tpu.serving import tenancy as jten
from deeplearning4j_tpu.serving.resilience import (
    ServingOverloadError as JServingOverloadError,
)
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import lm as tlm
from deeplearning4j_tpu_torch.serving import tenancy as tten
from deeplearning4j_tpu_torch.serving.resilience import (
    ServingOverloadError,
)
from test_torch_pressure import _Gate, _mid_decode, _wait_queued
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

JCFG = jt.TransformerConfig(vocab_size=50, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=32)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(CFG, seed=0)


@functools.lru_cache(maxsize=32)
def _want(prompt: tuple, new: int) -> list:
    out = jgen.generate(JCFG, jax.tree_util.tree_map(jnp.asarray, _tree()),
                        np.asarray([prompt], np.int32), new)
    return np.asarray(out)[0].tolist()


def _pools(**kw):
    """The port's pool on the CPU and the JAX package's, same knobs."""
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", 4)
    port = tlm.ContinuousLMServer(CFG, _tree(), device="cpu", **kw)
    ref = jlm.ContinuousLMServer(
        JCFG, jax.tree_util.tree_map(jnp.asarray, _tree()), **kw)
    return port, ref


def _outcome(fn, *args, **kw):
    """(kind, payload): the value, or the exception's type name, message
    and retry hint."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, str(e),
                getattr(e, "retry_after_s", None))


# ---------------------------------------------------------------------------
# units: the same calls on both modules


SPECS = {
    "empty_name": {"name": ""},
    "blank_name": {"name": "  "},
    "weight": {"name": "a", "weight": 0},
    "rate": {"name": "a", "rate": -1},
    "burst": {"name": "a", "burst": -2},
    "slo_ms": {"name": "a", "slo_ms": -5},
    "budget_zero": {"name": "a", "slo_budget": 0},
    "budget_over": {"name": "a", "slo_budget": 1.5},
    "ok_unmetered": {"name": "a"},
    "ok_metered": {"name": "b", "rate": 10.0},
    "ok_burst": {"name": "c", "rate": 10.0, "burst": 15.0},
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_spec_validation_and_capacity_match(case):
    kw = SPECS[case]
    ours = _outcome(tten.TenantSpec, **kw)
    theirs = _outcome(jten.TenantSpec, **kw)
    if theirs[0] == "ok":
        assert ours[0] == "ok"
        assert (ours[1].capacity, ours[1].metered) == \
            (theirs[1].capacity, theirs[1].metered)
        assert dataclasses.asdict(ours[1]) == dataclasses.asdict(theirs[1])
    else:
        assert ours == theirs


REGISTRIES = {
    "weights": '{"a": {"weight": 4, "rate": 100}, "b": {"slo_ms": 250}}',
    "empty": "{}",
    "not_json": "{nope",
    "not_object": '["a"]',
    "entry_not_object": '{"a": 3}',
    "bad_field": '{"a": {"wieght": 2}}',
    "bad_value": '{"a": {"rate": -1}}',
}


@pytest.mark.parametrize("case", sorted(REGISTRIES))
def test_registry_json_contract_matches(case):
    text = REGISTRIES[case]
    ours = _outcome(tten.TenantRegistry.from_json, text)
    theirs = _outcome(jten.TenantRegistry.from_json, text)
    if theirs[0] != "ok":
        assert ours == theirs
        return
    assert ours[0] == "ok"
    assert ours[1].names() == theirs[1].names()
    assert ours[1].stats() == theirs[1].stats()


@pytest.mark.parametrize("tenant", [None, "default", "a", "nobody", 7])
def test_normalize_and_coerce_match(tenant):
    spec = {"a": {"weight": 2}, "b": {"rate": 5}}
    regs = [mod.TenantRegistry.coerce(spec) for mod in (tten, jten)]
    assert [_outcome(r.normalize, tenant) for r in regs][0] == \
        [_outcome(r.normalize, tenant) for r in regs][1]
    for mod in (tten, jten):
        assert mod.TenantRegistry.coerce(None) is None
        reg = mod.TenantRegistry.coerce('{"c": {}}')
        assert mod.TenantRegistry.coerce(reg) is reg and "c" in reg
        assert mod.TenantRegistry.coerce(
            [mod.TenantSpec("d")]).names() == ("default", "d")


def _meter_script(seed: int):
    """A seeded sequence of (tenant, cost, now) charges and token outs."""
    rng = np.random.default_rng(seed)
    now, out = 0.0, []
    for _ in range(60):
        now += float(rng.exponential(0.05))
        out.append((str(rng.choice(["b", "c", "default"])),
                    int(rng.integers(1, 30)), now,
                    int(rng.integers(0, 20))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_meter_ledger_and_retry_after_match(seed):
    spec = {"b": {"rate": 40.0, "burst": 50.0}, "c": {"rate": 100.0}}
    regs = [mod.TenantRegistry.coerce(spec) for mod in (tten, jten)]
    refusals = 0
    for tenant, cost, now, n_out in _meter_script(seed):
        got = [_outcome(r.meter.charge, tenant, cost, now=now)
               for r in regs]
        assert got[0] == got[1]
        if got[0][0] != "ok":
            refusals += 1
            # the retry is the bucket's own refill time for the deficit
            assert got[0][2] > 0
        for r in regs:
            r.meter.record_out(tenant, n_out)
        over = [r.meter.over_quota(tenant, now=now + 0.5) for r in regs]
        assert over[0] == over[1]
    assert refusals > 0
    for t in ("b", "c", "default"):
        assert regs[0].meter.ledger(t) == regs[1].meter.ledger(t)


def test_backing_off_as_told_finds_the_tokens():
    for mod in (tten, jten):
        m = mod.TenantRegistry([mod.TenantSpec("b", rate=10.0,
                                               burst=20.0)]).meter
        m.charge("b", 20, now=0.0)
        with pytest.raises(mod.TenantQuotaError) as err:
            m.charge("b", 15, now=0.0)
        assert err.value.retry_after_s == pytest.approx(1.5)
        m.charge("b", 15, now=1.5)


def test_wfq_share_and_reentry_match():
    regs = [mod.TenantRegistry([mod.TenantSpec("heavy", weight=4.0),
                                mod.TenantSpec("light", weight=1.0)])
            for mod in (tten, jten)]
    rng = np.random.default_rng(3)
    stamps = [[], []]
    for i in range(40):
        tenant = "heavy" if i % 2 else "light"
        cost = int(rng.integers(1, 9))
        for k, r in enumerate(regs):
            stamps[k].append((tenant, r.wfq.stamp(tenant, cost), i))
        if i % 7 == 6:
            for r in regs:
                r.wfq.advance(stamps[0][-3][1])
    assert stamps[0] == stamps[1]
    order = sorted(stamps[0][:16], key=lambda s: (s[1], s[2]))
    first5 = [name for name, _, _ in order[:5]]
    assert first5.count("heavy") >= 3
    for r in regs:
        v1 = r.wfq.stamp("light", 4)
        r.wfq.advance(1000.0)
        assert v1 < 1000.0 < r.wfq.stamp("heavy", 4)


def test_slo_burn_badness_and_stats_match():
    regs = [mod.TenantRegistry.coerce(
        {"hot": {"slo_ms": 100.0, "slo_budget": 0.1},
         "greedy": {"rate": 10.0, "burst": 10.0},
         "calm": {"slo_ms": 500.0}}) for mod in (tten, jten)]
    rng = np.random.default_rng(5)
    lat = rng.exponential(0.08, size=40)
    for r in regs:
        for v in lat:
            r.slo.record("hot", float(v))
            r.slo.record("calm", float(v) / 10)
        r.meter.charge("greedy", 10, now=0.0)
        with pytest.raises(Exception):
            r.meter.charge("greedy", 10, now=0.0)
    for now in (0.1, 4.9, 30.0):
        for t in ("hot", "greedy", "calm", "default"):
            assert regs[0].badness(t, now=now) == regs[1].badness(t, now=now)
            assert regs[0].compliant(t, now=now) == \
                regs[1].compliant(t, now=now)
        assert regs[0].any_offender(now=now) == \
            regs[1].any_offender(now=now)
    assert regs[0].slo.burn_rate("hot") > 1.0
    assert regs[0].badness("greedy", now=0.1) > \
        regs[0].badness("hot", now=0.1)
    assert regs[0].stats() == regs[1].stats()


# ---------------------------------------------------------------------------
# the pool: queue composition, quota, shed, victims


def _queue_order(srv, reqs):
    with srv._cond:
        for r in reqs:
            srv._queue_insert_locked(r)
        order = [(r.priority, r.tenant, int(r.enqueued))
                 for r in srv._queue]
        srv._queue.clear()
    return order


def _build(srv, prompt, priority, tenant, enqueued, vft=None):
    r = srv._build_request(prompt, 2, 0.0, 0, None, None,
                           priority=priority, tenant=tenant)
    r.enqueued = float(enqueued)
    r.vft = (srv.tenants.wfq.stamp(tenant, r.cost) if vft is None
             else vft)
    return r


QUEUES = {
    # one class of one tenant is the FIFO
    "one_tenant_fifo": ({"only": {}}, [("batch", "only", i)
                                       for i in range(5)]),
    # rank dominates a tiny vft
    "rank_dominates": ({"a": {}, "b": {"weight": 100.0}},
                       [("best_effort", "b", 0), ("interactive", "a", 1),
                        ("batch", "b", 2)]),
    # weights interleave within a class
    "weighted": ({"h": {"weight": 4.0}, "l": {}},
                 [("batch", "l", 0), ("batch", "l", 1), ("batch", "h", 2),
                  ("batch", "h", 3), ("batch", "h", 4)]),
}


@pytest.mark.parametrize("case", sorted(QUEUES))
def test_queue_composition_matches(case):
    tenants, items = QUEUES[case]
    port, ref = _pools(slots=1, tenants=tenants)
    try:
        orders = [_queue_order(s, [_build(s, [1 + k], p, t, e)
                                   for k, (p, t, e) in enumerate(items)])
                  for s in (port, ref)]
        assert orders[0] == orders[1]
        if case == "one_tenant_fifo":
            assert [e for _, _, e in orders[0]] == [0, 1, 2, 3, 4]
        if case == "rank_dominates":
            assert orders[0][0][0] == "interactive"
    finally:
        port.stop()
        ref.stop()


def test_a_preempted_request_keeps_its_original_vft():
    port, ref = _pools(slots=1, tenants={"t": {}})
    try:
        for srv in (port, ref):
            old = _build(srv, [1], "batch", "t", 0)
            late = _build(srv, [2], "batch", "t", 5)
            # the preempted request re-inserts after the later arrival
            assert [e for _, _, e in _queue_order(srv, [late, old])] == \
                [0, 5]
    finally:
        port.stop()
        ref.stop()


def test_pool_quota_refusal_and_ledgers_match():
    port, ref = _pools(tenants={"b": {"rate": 10.0, "burst": 10.0}})
    try:
        for srv in (port, ref):
            srv.warmup()
            assert srv.generate([1, 2], 4, tenant="b", timeout=600) == \
                _want((1, 2), 4)                           # cost 6
        got = [_outcome(s.generate, [1, 2, 3, 4], 8, tenant="b")
               for s in (port, ref)]                       # cost 12
        assert got[0][0] == got[1][0] == "TenantQuotaError"
        # both buckets refilled for their own elapsed time; the message
        # and retry differ only by it, so check the derived floor
        assert got[0][2] > 0 and got[1][2] > 0
        stats = [s.stats() for s in (port, ref)]
        for key in ("tenants", "tenancy"):
            for t in ("b",):
                ours, theirs = stats[0][key][t], stats[1][key][t]
                ours = {k: v for k, v in ours.items() if k != "burn_rate"}
                theirs = {k: v for k, v in theirs.items()
                          if k != "burn_rate"}
                assert ours == theirs
        assert stats[0]["tenants"]["b"]["throttled"] == 1
        assert stats[0]["tenancy"]["b"]["tokens_in"] == 6
        assert stats[0]["tenancy"]["b"]["tokens_out"] == 4
    finally:
        port.stop()
        ref.stop()


def test_429_retry_is_floored_at_the_ladder_exit_while_up():
    port, ref = _pools(preempt=True, brownout=True,
                       tenants={"b": {"rate": 1000.0, "burst": 6.0}})
    try:
        got = []
        for srv in (port, ref):
            srv.tenants.meter.charge("b", 6)    # drain the burst now
            with srv._cond:
                srv._pressure.level = 1
                srv._pressure_tick_s = 2.0     # dwell = 3 x 2 s
            got.append(_outcome(srv.generate, [1, 2], 2, tenant="b"))
        assert got[0][0] == got[1][0] == "TenantQuotaError"
        assert got[0][2] == got[1][2] == pytest.approx(6.0)
    finally:
        port.stop()
        ref.stop()


def test_l4_shed_spares_compliant_tenants():
    port, ref = _pools(preempt=True, brownout=True,
                       tenants={"good": {"weight": 1.0},
                                "bad": {"slo_ms": 1.0,
                                        "slo_budget": 0.01}})
    errors = (ServingOverloadError, JServingOverloadError)
    try:
        for srv in (port, ref):
            srv.warmup()
            for _ in range(4):
                srv.tenants.slo.record("bad", 1.0)   # 1 s >> 1 ms
            assert not srv.tenants.compliant("bad")
            with srv._cond:
                srv._pressure.level = 4
            with pytest.raises(errors) as err:
                srv.generate([1, 2], 2, priority="best_effort",
                             tenant="bad")
            assert err.value.retry_after_s >= 0.1
            r = srv._build_request([3, 4], 2, 0.0, 0, None, None,
                                   priority="best_effort", tenant="good")
            srv._enqueue(r)
            assert srv._wait(r, timeout=600) == _want((3, 4), 2)
        assert port.stats()["tenants"]["bad"]["rejected"] == \
            ref.stats()["tenants"]["bad"]["rejected"] == 1
    finally:
        port.stop()
        ref.stop()


class _FakeSlot:
    def __init__(self, req):
        self.req = req
        self.active = True


@pytest.mark.parametrize("offender", ["bad", None])
def test_preemption_takes_the_offender_first(offender):
    """`_preempt_one_locked` picks its victim among best_effort lanes
    of two tenants: while one tenant is non-compliant its lane goes
    first; without an offender the newest lane of the worst rank goes,
    as without tenancy."""
    tenants = {"good": {}, "bad": {"slo_ms": 1.0, "slo_budget": 0.01}}
    picked = []
    for srv in _pools(slots=4, preempt=True, tenants=tenants):
        try:
            if offender:
                srv.tenants.slo.record(offender, 1.0)
            lanes = [_build(srv, [1 + i], "best_effort", t, i)
                     for i, t in enumerate(["good", "bad", "good", "good"])]
            head = _build(srv, [9], "interactive", "good", 9)
            victims = []
            srv._gather = srv._cache = object()     # programs "built"
            srv._slots = [_FakeSlot(r) for r in lanes]
            srv._preempt_slot_locked = lambda s: victims.append(
                (s.req.tenant, int(s.req.enqueued)))
            with srv._cond:
                assert srv._preempt_one_locked(head)
            picked.append(victims)
        finally:
            srv._gather = srv._cache = None
            srv._slots = []
            srv.stop()
    assert picked[0] == picked[1]
    assert picked[0] == ([("bad", 1)] if offender else [("good", 3)])


def test_compliant_interactive_overtakes_flooding_best_effort():
    """The first lane is held mid-decode at the dispatch gate while the
    flooding tenant's best_effort request and then the compliant
    tenant's interactive one queue; the queue's order is fixed before
    the gate opens, so the interactive request finishes first."""
    srv = tlm.ContinuousLMServer(
        CFG, _tree(), slots=1, page_size=4, device="cpu",
        tenants={"team-a": {"weight": 4.0, "slo_ms": 500.0},
                 "team-b": {"weight": 1.0}})
    srv.warmup()
    gate = _Gate(srv, _mid_decode(srv, committed=1))
    done, lock = [], threading.Lock()

    def run(name, prompt, prio, tenant):
        out = srv.generate(prompt, 6, priority=prio, tenant=tenant,
                           timeout=120)
        with lock:
            done.append((name, out))

    try:
        threads = [threading.Thread(target=run, args=args) for args in (
            ("first", [1, 2], "batch", "team-b"),
            ("be", [3, 4], "best_effort", "team-b"),
            ("ia", [5, 6], "interactive", "team-a"))]
        threads[0].start()
        assert gate.blocked.wait(60)
        threads[1].start()
        _wait_queued(srv, 1)
        threads[2].start()
        _wait_queued(srv, 2)
        with srv._cond:
            assert [r.priority for r in srv._queue] == ["interactive",
                                                        "best_effort"]
        gate.release.set()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        names = [n for n, _ in done]
        assert names.index("ia") < names.index("be")
        outs = dict(done)
        assert outs["ia"] == _want((5, 6), 6)
        assert outs["be"] == _want((3, 4), 6)
    finally:
        gate.release.set()
        srv.stop()


def test_preempted_victim_resumes_byte_identical_with_tenancy():
    srv = tlm.ContinuousLMServer(
        CFG, _tree(), slots=2, page_size=4, pages=8, prefill_chunk=4,
        preempt=True, device="cpu",
        tenants={"team-a": {"weight": 4.0}, "team-b": {"weight": 1.0}})
    srv.warmup()
    gate = _Gate(srv, _mid_decode(srv, committed=2))
    res = {}

    def victim():
        res["victim"] = srv.generate([1, 2, 3], 28, priority="best_effort",
                                     tenant="team-b", timeout=120)

    try:
        t = threading.Thread(target=victim)
        t.start()
        assert gate.blocked.wait(60)
        ia = threading.Thread(target=lambda: res.__setitem__(
            "ia", srv.generate([4, 5, 6, 7], 8, priority="interactive",
                               tenant="team-a", timeout=120)))
        ia.start()
        _wait_queued(srv, 1)
        gate.release.set()
        for th in (t, ia):
            th.join(timeout=120)
            assert not th.is_alive()
        assert res["victim"] == _want((1, 2, 3), 28)
        assert res["ia"] == _want((4, 5, 6, 7), 8)
        stats = srv.stats()
        assert stats["preemptions"] >= 1
        assert stats["tenants"]["team-b"]["preempted"] >= 1
        for ev in ("requests", "rejected", "shed", "deadline_missed"):
            part = sum(int(c.get(ev) or 0)
                       for c in stats["tenants"].values())
            assert part == int(stats.get(ev) or 0), ev
        assert srv.page_ledger()["balanced"]
        # the swap frame carried the tenant
        assert stats["tenancy"]["team-b"]["tokens_out"] == 28
    finally:
        gate.release.set()
        srv.stop()


def test_shipped_frames_carry_the_tenant():
    srv = tlm.ContinuousLMServer(CFG, _tree(), slots=2, page_size=4,
                                 ship=True, device="cpu",
                                 tenants={"acme": {}})
    try:
        ex = srv.prefill_export([1, 2, 3, 4, 5], 4, tenant="acme",
                                timeout=120)
        assert ex.tenant == "acme"
        assert srv.admit_with_pages(ex, timeout=120) == \
            _want((1, 2, 3, 4, 5), 4)
        st = srv.stats()["tenants"]["acme"]
        assert st["requests"] == 2
        with pytest.raises(ValueError, match="unknown tenant"):
            srv.generate([1, 2], 2, tenant="nobody")
        assert json.dumps(srv.stats()["tenancy"])
    finally:
        srv.stop()
