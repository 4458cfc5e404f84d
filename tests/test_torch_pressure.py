"""PyTorch port: priorities, preemption with host swap, and the brownout
ladder (`deeplearning4j_tpu_torch.serving.pressure`, the
`ContinuousLMServer` `preempt` / `brownout` planes, ``priority`` on
``POST /lm/generate``).

The oracle is the behaviour of the JAX package's `tests/test_pressure.py`
(`TestPriorityVocabulary`, `TestSwapStore`, `TestBrownoutLadder`,
`TestPriorityAdmission`, `TestPreemptionParity` without its compile
count, `TestExhaustionRegression`, `TestBrownoutWiring`,
`TestHTTPFronts`), on the same float32 weights: a preempted lane's ids
equal the JAX package's `generate` exactly.  The victim is held
mid-decode by a gate on the pool's dispatch entry (`_Gate`), released
once the interactive arrival is in the queue: no test waits on a sleep.
The fault paths use the JAX package's `chaos_swap` / `chaos_pool`
wrappers over the port's stores (they shadow `put` / `alloc`).
"""

import dataclasses
import functools
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.resilience.chaos import (
    PoolChaosConfig,
    SwapChaosConfig,
    chaos_pool,
    chaos_swap,
)
from deeplearning4j_tpu.serving import pressure as jpr
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import ContinuousLMServer
from deeplearning4j_tpu_torch.serving.pressure import (
    BROWNOUT_LEVELS,
    PRIORITY_CLASSES,
    BrownoutLadder,
    PressureConfig,
    SwapEvictedError,
    SwapStore,
    normalize_priority,
)
from deeplearning4j_tpu_torch.serving.resilience import ServingOverloadError
from deeplearning4j_tpu_torch.serving.transfer import (
    PageExport,
    deserialize_export,
    serialize_export,
)
from deeplearning4j_tpu_torch.ui.server import UiServer
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


def _srv(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", 4)
    return ContinuousLMServer(CFG, _tree(), device="cpu", **kw)


class _Gate:
    """Holds the pool's worker at the dispatch entry once `ready()` is
    true there (evaluated on the worker thread, before the dispatch):
    `blocked` is set, and the dispatch waits for `release`."""

    def __init__(self, srv, ready):
        self.blocked = threading.Event()
        self.release = threading.Event()
        real = srv._step

        def step(*args):
            if not self.blocked.is_set() and ready():
                self.blocked.set()
                self.release.wait(120)
            return real(*args)

        srv._step = step


def _mid_decode(srv, slot=0, committed=2):
    def ready():
        s = srv._slots[slot]
        return (s.active and s.fed >= len(s.req.prompt)
                and len(s.generated) >= committed)
    return ready


def _wait_queued(srv, n=1):
    with srv._cond:
        assert srv._cond.wait_for(lambda: len(srv._queue) >= n, 60)


# ---------------------------------------------------------------------------
# units


class TestPriorityVocabulary:
    def test_normalize_defaults_and_validates(self):
        assert normalize_priority(None) == "interactive"
        for c in PRIORITY_CLASSES:
            assert normalize_priority(c) == c
        with pytest.raises(ValueError, match="priority must be one of"):
            normalize_priority("urgent")
        assert PRIORITY_CLASSES == jpr.PRIORITY_CLASSES
        assert BROWNOUT_LEVELS == jpr.BROWNOUT_LEVELS

    def test_export_priority_rides_the_wire(self):
        pages = torch.zeros((1, 1, 4, 2, 8))
        ex = PageExport(prompt=[1, 2, 3, 4], max_new=4, temperature=0.0,
                        seed=0, committed=[5], pos=4, page_size=4,
                        pages_k=pages, pages_v=pages,
                        model={"n_layers": 1}, priority="best_effort")
        assert deserialize_export(serialize_export(ex)).priority == \
            "best_effort"
        plain = dataclasses.replace(ex, priority="interactive")
        blob = serialize_export(plain)
        assert b"priority" not in blob        # the default is not written
        assert deserialize_export(blob).priority == "interactive"


class TestSwapStore:
    def test_round_trip_and_counters(self):
        s = SwapStore(capacity_bytes=1000)
        assert s.put("a", b"x" * 100) == []
        assert s.take("a") == b"x" * 100
        assert s.bytes_stored == 0
        assert s.puts == 1 and s.takes == 1 and s.evicted == 0

    def test_byte_cap_evicts_lru_first(self):
        s = SwapStore(capacity_bytes=250)
        s.put("a", b"a" * 100)
        s.put("b", b"b" * 100)
        assert s.put("c", b"c" * 100) == ["a"]
        assert s.take("b") and s.take("c")
        with pytest.raises(SwapEvictedError):
            s.take("a")
        assert s.evicted == 1

    def test_oversized_blob_is_refused_not_destructive(self):
        s = SwapStore(capacity_bytes=100)
        s.put("a", b"a" * 80)
        assert s.put("big", b"x" * 101) is None
        assert s.rejected == 1
        assert s.take("a") == b"a" * 80

    def test_discard_and_peak(self):
        s = SwapStore(capacity_bytes=300)
        s.put("a", b"a" * 100)
        s.put("b", b"b" * 150)
        assert s.peak_bytes == 250
        s.discard("a")
        s.discard("missing")
        assert s.bytes_stored == 150
        assert s.stats()["entries"] == 1

    def test_capacity_validated(self):
        with pytest.raises(ValueError):
            SwapStore(0)


class TestBrownoutLadder:
    def _ladder(self, dwell=2):
        return BrownoutLadder(PressureConfig(
            enter_free_frac=(0.5, 0.25, 0.125, 0.05),
            enter_queue_ratio=(2.0, 4.0, 8.0, 16.0),
            exit_free_margin=0.1, exit_queue_factor=0.5,
            down_dwell=dwell))

    def test_enters_levels_from_either_signal(self):
        lad = self._ladder()
        assert lad.update(10, 10, 0, 4) == []
        assert lad.update(4, 10, 0, 4) == [(0, 1)]
        assert lad.update(2, 10, 0, 4) == [(1, 2)]
        assert self._ladder().update(10, 10, 20, 4) == [(0, 2)]

    def test_sudden_exhaustion_jumps_up_immediately(self):
        lad = self._ladder()
        assert lad.update(0, 10, 40, 4) == [(0, 4)]
        assert BROWNOUT_LEVELS[lad.level] == "shed"

    def test_down_needs_margin_and_dwell_one_step_at_a_time(self):
        lad = self._ladder(dwell=2)
        lad.update(1, 10, 0, 4)
        assert lad.level == 3
        for _ in range(5):
            assert lad.update(2, 10, 0, 4) == []
        assert lad.update(10, 10, 0, 4) == []
        assert lad.update(2, 10, 0, 4) == []
        assert lad.update(10, 10, 0, 4) == []
        assert lad.update(10, 10, 0, 4) == [(3, 2)]
        assert lad.level == 2 and lad.transitions_down == 1

    def test_transitions_counted_and_history_bounded(self):
        lad = self._ladder(dwell=1)
        lad.update(0, 10, 0, 4)
        for _ in range(4):
            lad.update(10, 10, 0, 4)
        st = lad.stats()
        assert st["level"] == 0 and st["transitions_up"] == 1
        assert st["transitions_down"] == 4 and lad.transitions == 5
        assert len(st["recent"]) == 5

    def test_the_ladder_moves_as_the_jax_one_does(self):
        rng = np.random.default_rng(3)
        ours, theirs = self._ladder(dwell=2), jpr.BrownoutLadder(
            jpr.PressureConfig(enter_free_frac=(0.5, 0.25, 0.125, 0.05),
                               enter_queue_ratio=(2.0, 4.0, 8.0, 16.0),
                               exit_free_margin=0.1, exit_queue_factor=0.5,
                               down_dwell=2))
        for free, queue in rng.integers(0, 11, (200, 2)):
            assert ours.update(int(free), 10, int(queue) * 4, 4) == \
                theirs.update(int(free), 10, int(queue) * 4, 4)
        assert ours.stats() == theirs.stats()

    @pytest.mark.parametrize("kw,match", [
        (dict(enter_free_frac=(0.1, 0.5), enter_queue_ratio=(2.0, 4.0)),
         "non-increasing"),
        (dict(enter_free_frac=(0.5,), enter_queue_ratio=(2.0, 4.0)),
         "same number"),
        (dict(enter_free_frac=(0.5, 0.25), enter_queue_ratio=(2.0, 4.0)),
         "exactly 4"),
        (dict(down_dwell=0), "down_dwell")])
    def test_config_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            PressureConfig(**kw)


# ---------------------------------------------------------------------------
# priority-ordered admission


class TestPriorityAdmission:
    def test_queue_is_priority_then_fifo_ordered(self):
        srv = _srv(slots=1)
        try:
            reqs = []
            for i, p in enumerate(["batch", "best_effort", "batch",
                                   "interactive", "best_effort"]):
                r = srv._build_request([1 + i], 2, 0.0, 0, None,
                                       priority=p)
                r.enqueued = float(i)
                reqs.append(r)
            with srv._cond:
                for r in reqs:
                    srv._queue_insert_locked(r)
                order = [(r.priority, int(r.enqueued)) for r in srv._queue]
            assert order == [("interactive", 3), ("batch", 0),
                             ("batch", 2), ("best_effort", 1),
                             ("best_effort", 4)]
        finally:
            srv.stop()

    def test_interactive_overtakes_queued_best_effort(self):
        srv = _srv(slots=1)
        srv.warmup()
        gate = _Gate(srv, _mid_decode(srv, committed=1))
        done, lock = [], threading.Lock()

        def run(name, prompt, prio):
            srv.generate(prompt, 6, priority=prio, timeout=120)
            with lock:
                done.append(name)

        try:
            threads = [threading.Thread(target=run,
                                        args=("first", [1, 2], "batch"))]
            threads[0].start()
            assert gate.blocked.wait(60)
            # while the slot is held: best_effort queues first, then
            # interactive; interactive must still win the slot
            threads.append(threading.Thread(
                target=run, args=("be", [3, 4], "best_effort")))
            threads[-1].start()
            _wait_queued(srv, 1)
            threads.append(threading.Thread(
                target=run, args=("ia", [5, 6], "interactive")))
            threads[-1].start()
            _wait_queued(srv, 2)
            gate.release.set()
            for t in threads:
                t.join(timeout=120)
            assert done.index("ia") < done.index("be")
        finally:
            gate.release.set()
            srv.stop()

    def test_prefill_export_carries_the_class(self):
        srv = _srv(ship=True)
        try:
            ex = srv.prefill_export([1, 2, 3, 4, 5], 4,
                                    priority="best_effort", timeout=120)
            assert ex.priority == "best_effort"
            back = deserialize_export(serialize_export(ex))
            dec = _srv(ship=True)
            try:
                assert dec.admit_with_pages(back, timeout=120) == _want(
                    (1, 2, 3, 4, 5), 4)
                assert dec.stats()["priority"]["best_effort"][
                    "requests"] == 1
            finally:
                dec.stop()
        finally:
            srv.stop()

    def test_unknown_priority_is_a_typed_value_error(self):
        srv = _srv(slots=1)
        try:
            with pytest.raises(ValueError, match="priority"):
                srv.generate([1, 2], 2, priority="urgent")
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# preemption with host swap


def _preempt_run(victim_kw=None, swap_chaos=None, speculate="off",
                 swap_quantize=True, swap_bytes=64 << 20):
    """One contended run: a best_effort victim fills the pool (8 pages of
    4) mid-decode, an interactive arrival preempts it.  Returns
    (victim ids, interactive ids, stats, ledger)."""
    srv = _srv(pages=8, prefill_chunk=4, preempt=True, speculate=speculate,
               swap_quantize=swap_quantize, swap_bytes=swap_bytes)
    res = {}
    try:
        srv.warmup()
        if swap_chaos is not None:
            with srv._cond:
                chaos_swap(srv._swap, swap_chaos)
        gate = _Gate(srv, _mid_decode(srv))
        t = threading.Thread(target=lambda: res.__setitem__(
            "victim", srv.generate([1, 2, 3], 28, priority="best_effort",
                                   timeout=120, **(victim_kw or {}))))
        t.start()
        assert gate.blocked.wait(60)
        ia = threading.Thread(target=lambda: res.__setitem__(
            "ia", srv.generate([4, 5, 6, 7], 8, priority="interactive",
                               timeout=120)))
        ia.start()
        _wait_queued(srv)
        gate.release.set()
        ia.join(timeout=120)
        t.join(timeout=120)
        stats = srv.stats()
        ledger = srv.page_ledger()
    finally:
        srv.stop()
    return res["victim"], res["ia"], stats, ledger


class TestPreemptionParity:
    @pytest.mark.parametrize("swap_quantize", [True, False])
    def test_greedy_victim_resumes_byte_identical(self, swap_quantize):
        victim, ia, stats, ledger = _preempt_run(
            swap_quantize=swap_quantize)
        assert ledger["balanced"]
        assert stats.get("preemptions", 0) >= 1
        assert stats["swap"]["out"] >= 1 and stats["swap"]["in"] >= 1
        assert victim == _want((1, 2, 3), 28)
        assert ia == _want((4, 5, 6, 7), 8)
        assert stats["priority"]["interactive"]["requests"] == 1
        assert stats["priority"]["best_effort"]["requests"] == 1
        assert stats["priority"]["best_effort"]["preempted"] >= 1
        swap = stats["pressure"]["swap"]
        assert 0 < swap["peak_bytes"] <= swap["capacity_bytes"]

    def test_seeded_sampling_victim_resumes_byte_identical(self):
        victim, _, stats, _ = _preempt_run(
            victim_kw={"seed": 7, "temperature": 0.7})
        assert stats.get("preemptions", 0) >= 1
        ref = _srv(slots=1)
        try:
            want = ref.generate([1, 2, 3], 28, seed=7, temperature=0.7,
                                timeout=120)
        finally:
            ref.stop()
        assert victim == want

    def test_speculating_victim_resumes_byte_identical(self):
        victim, ia, stats, ledger = _preempt_run(speculate="ngram")
        assert stats.get("preemptions", 0) >= 1 and ledger["balanced"]
        assert victim == _want((1, 2, 3), 28)
        assert ia == _want((4, 5, 6, 7), 8)

    def test_evicted_swap_recomputes_byte_identical(self):
        victim, _, stats, ledger = _preempt_run(
            swap_chaos=SwapChaosConfig(drop_puts=(0,)))
        assert stats.get("preemptions", 0) >= 1 and ledger["balanced"]
        assert stats["swap"]["evicted"] >= 1
        assert stats["swap"]["in"] == 0
        assert victim == _want((1, 2, 3), 28)

    def test_corrupted_swap_detected_and_recomputed(self):
        victim, ia, stats, ledger = _preempt_run(
            swap_chaos=SwapChaosConfig(corrupt_puts=(0,)))
        assert stats.get("preemptions", 0) >= 1 and ledger["balanced"]
        assert stats["swap"]["corrupt"] >= 1
        assert stats["swap"]["in"] == 0
        assert victim == _want((1, 2, 3), 28)
        assert ia == _want((4, 5, 6, 7), 8)

    def test_a_swap_larger_than_the_cap_recomputes(self):
        victim, _, stats, ledger = _preempt_run(swap_bytes=64)
        assert stats.get("preemptions", 0) >= 1 and ledger["balanced"]
        assert stats["swap"]["evicted"] >= 1 and stats["swap"]["in"] == 0
        assert victim == _want((1, 2, 3), 28)

    def test_warmup_runs_the_swap_pair(self):
        srv = _srv(preempt=True)
        try:
            # decode + chunk + copy + gather + install
            assert srv.warmup() == 5
        finally:
            srv.stop()

    def test_preempt_requires_paged(self):
        with pytest.raises(ValueError, match="preempt"):
            ContinuousLMServer(CFG, _tree(), kv="dense", preempt=True,
                               device="cpu")
        with pytest.raises(ValueError, match="brownout"):
            ContinuousLMServer(CFG, _tree(), kv="dense", brownout=True,
                               device="cpu")


# ---------------------------------------------------------------------------
# pool exhaustion without preemption


class TestExhaustionRegression:
    def test_exhaustion_storm_never_deadlocks_fifo(self):
        srv = _srv(slots=4, pages=10, prefill_chunk=4)
        try:
            srv.warmup()
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, 50, (int(n),)).tolist()
                       for n in rng.integers(2, 9, (24,))]
            news = [int(n) for n in rng.integers(4, 20, (24,))]
            results, errors = [None] * 24, []

            def client(i):
                try:
                    results[i] = srv.generate(prompts[i], news[i],
                                              timeout=120)
                except BaseException as e:  # noqa: BLE001 — asserted below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors[:3]
            assert all(r is not None for r in results)
            for i in (0, 7, 23):
                assert results[i] == _want(tuple(prompts[i]), news[i])
            assert srv.page_ledger()["balanced"]
        finally:
            srv.stop()

    def test_denied_allocs_only_delay_admission(self):
        srv = _srv(prefill_chunk=4)
        try:
            srv.warmup()
            with srv._cond:
                chaos = chaos_pool(srv._pool,
                                   PoolChaosConfig(deny_allocs=(0, 1)))
            assert srv.generate([1, 2, 3], 6, timeout=120) == _want(
                (1, 2, 3), 6)
            assert chaos.allocs >= 3
            assert srv.page_ledger()["balanced"]
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# the ladder wired into the pool


class TestBrownoutWiring:
    def test_level4_sheds_best_effort_only(self):
        srv = _srv(brownout=True)
        try:
            srv.warmup()
            with srv._cond:
                srv._pressure.level = 4
            with pytest.raises(ServingOverloadError,
                               match="brownout level 4") as err:
                srv.generate([1, 2], 2, priority="best_effort", timeout=120)
            assert err.value.retry_after_s >= 0.1
            assert srv.generate([1, 2], 2, priority="interactive",
                                timeout=120) == _want((1, 2), 2)
            st = srv.stats()
            assert st["brownout"]["shed"] == 1
            assert st["priority"]["best_effort"]["rejected"] == 1
        finally:
            srv.stop()

    def test_level_effects_speculation_off_and_narrow_prefill(self):
        """Level 1 turns speculation off, level 2 halves the prefill
        ride-along width; the ids do not change."""
        srv = _srv(slots=1, prefill_chunk=4, brownout=True,
                   speculate="ngram", draft_len=3)
        try:
            srv.warmup()
            with srv._cond:
                srv._pressure.level = 2
                srv._pressure.config = dataclasses.replace(
                    srv._pressure.config, down_dwell=10 ** 6)
            prompt = [1, 2, 3, 4, 5, 6, 7, 8] * 2
            assert srv.generate(prompt, 6, timeout=120) == _want(
                tuple(prompt), 6)
            st = srv.stats()
            assert "spec_drafted" not in st         # no drafts verified
            # 16 prompt tokens at width 2 of the 4-wide program: 8 rounds
            assert st["dispatch_widths"]["4"] == 8
        finally:
            srv.stop()

    def test_pressure_storm_counts_transitions_and_recovers(self):
        srv = _srv(slots=4, pages=10, prefill_chunk=4, preempt=True,
                   brownout=PressureConfig(
                       enter_free_frac=(0.8, 0.5, 0.3, 0.1),
                       enter_queue_ratio=(1.0, 2.0, 4.0, 100.0),
                       exit_free_margin=0.1, exit_queue_factor=0.5,
                       down_dwell=2))
        try:
            srv.warmup()
            rng = np.random.default_rng(1)
            prompts = [rng.integers(0, 50, (6,)).tolist() for _ in range(16)]
            threads = [threading.Thread(target=lambda p=p: srv.generate(
                p, 12, priority="batch", timeout=120)) for p in prompts]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            st = srv.stats()
            assert st["pressure"]["brownout"]["transitions_up"] >= 1
            assert st["brownout"]["transitions"] >= 1
            # idle admission rounds (every 50 ms) step the ladder down
            with srv._cond:
                for _ in range(600):
                    if srv._pressure.level == 0:
                        break
                    srv._cond.wait(0.05)
                assert srv._pressure.level == 0
            assert srv.stats()["pressure"]["brownout"][
                "transitions_down"] >= 1
            assert srv.page_ledger()["balanced"]
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# the HTTP front


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


class TestHTTPFronts:
    def test_priority_on_lm_generate_and_stats(self):
        srv = UiServer(port=0)
        srv.serve_lm(CFG, _tree(), slots=2, preempt=True, brownout=True,
                     device="cpu")
        srv.start()
        try:
            status, out = _post(srv.url + "/lm/generate",
                                {"prompt_ids": [1, 2, 3],
                                 "max_new_tokens": 4, "priority": "batch"})
            assert status == 200 and out["ids"] == _want((1, 2, 3), 4)
            stats = json.loads(urllib.request.urlopen(
                srv.url + "/serving/stats", timeout=30).read())
            assert stats["lm"]["priority"]["batch"]["requests"] == 1
            assert stats["lm"]["pressure"]["preempt"] is True
            assert stats["lm"]["pressure"]["brownout"]["level"] == 0
        finally:
            srv.stop()

    def test_unknown_priority_is_400_on_the_front(self):
        srv = UiServer(port=0)
        srv.serve_lm(CFG, _tree(), slots=2, device="cpu")
        srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(srv.url + "/lm/generate",
                      {"prompt_ids": [1, 2], "max_new_tokens": 2,
                       "priority": "urgent"})
            assert err.value.code == 400
            assert "priority" in json.loads(err.value.read())["error"]
        finally:
            srv.stop()

    def test_brownout_shed_is_503_with_retry_after(self):
        srv = UiServer(port=0)
        srv.serve_lm(CFG, _tree(), slots=2, brownout=True, device="cpu")
        srv.start()
        lm = srv.state.lm_server
        try:
            lm.warmup()
            with lm._cond:
                lm._pressure.level = 4
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(srv.url + "/lm/generate",
                      {"prompt_ids": [1, 2], "max_new_tokens": 2,
                       "priority": "best_effort"})
            assert err.value.code == 503
            assert int(err.value.headers["Retry-After"]) >= 1
        finally:
            srv.stop()
