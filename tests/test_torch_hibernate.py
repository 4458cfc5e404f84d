"""PyTorch port: the tiered KV state store and session hibernation
(`deeplearning4j_tpu_torch.serving.hibernate`, the `ContinuousLMServer`
``hibernate_idle_s`` / ``state_dir`` / ``swap_quantize`` planes).

The oracle is the behaviour of every class of the JAX package's
`tests/test_hibernate.py`, on the same float32 weights: a resumed
session's ids equal the JAX package's `generate`.  A hibernation
builds no program (the compile watcher's total does not move across
hibernate and resume), and a streamed resume after a corrupt blob
yields every token once.  The disk faults use the JAX package's
`chaos_disk` over the port's store.  Cross-package: a hibernated
session written to disk by the JAX package's server is resumed by the
port's, and the other way round; prefix keys and the manifest are the
same.  The sweep itself is held to JAX's: it drops only the hibernated
chain from the radix tree (a prompt cached beside it saves as many
prefix tokens on a repeat as on JAX's server), a request decoding on
the other lane while it runs returns JAX's tokens, and no test lets the
pool reset while the worker runs (every reset is counted: the start and
the stop are the only ones allowed).  Waits on the idle sweep are
events on the pool's hibernation counter, not sleeps.
"""

import dataclasses
import functools
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.resilience.chaos import DiskChaosConfig, chaos_disk
from deeplearning4j_tpu.serving import ContinuousLMServer as JServer
from deeplearning4j_tpu.serving import hibernate as jhib
from deeplearning4j_tpu_torch.obs import compilewatch as tcw
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import ContinuousLMServer
from deeplearning4j_tpu_torch.serving.hibernate import (
    MANIFEST_NAME,
    DiskTier,
    TieredStateStore,
    prefix_key,
)
from deeplearning4j_tpu_torch.serving.pressure import SwapEvictedError
from deeplearning4j_tpu_torch.serving.transfer import (
    PageExport,
    PageShipError,
    deserialize_export,
    quantize_export,
    serialize_export,
)
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

PS = 4
JCFG = jt.TransformerConfig(vocab_size=50, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=64)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(CFG, seed=0)


def _jparams():
    return jax.tree_util.tree_map(jnp.asarray, _tree())


@functools.lru_cache(maxsize=32)
def _want(prompt: tuple, new: int) -> list:
    out = jgen.generate(JCFG, _jparams(), np.asarray([prompt], np.int32),
                        new)
    return np.asarray(out)[0].tolist()


def _srv(tmp=None, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", PS)
    kw.setdefault("pages", 32)
    if tmp is not None:
        kw.setdefault("state_dir", str(tmp))
    return ContinuousLMServer(CFG, _tree(), device="cpu", **kw)


def _hibernations(srv, n=1):
    """An event set once the pool's idle sweep has hibernated `n`
    sessions (it wraps the pool's hibernation counter)."""
    ev, seen = threading.Event(), [0]
    real = srv.metrics.record_hibernate

    def record(direction, *args):
        real(direction, *args)
        if direction == "out":
            seen[0] += 1
            if seen[0] >= n:
                ev.set()

    srv.metrics.record_hibernate = record
    return ev


@pytest.fixture(autouse=True)
def _no_reset_while_running(monkeypatch):
    """Every pool reset of a port server is counted: one that runs while
    the worker is up is the catch-all's, after a failed dispatch.  Only
    the start and the stop (worker not running) may reset."""
    real = ContinuousLMServer._reset_pool_locked
    running = []

    def counted(self):
        running.append(bool(self._running))
        return real(self)

    monkeypatch.setattr(ContinuousLMServer, "_reset_pool_locked", counted)
    yield running
    assert not any(running), "the pool was reset while the worker ran"


def _frame(prompt, pos, n_layers=1, heads=2, dim=8):
    n_pages = -(-pos // PS)
    gen = torch.Generator().manual_seed(0)
    shape = (n_layers, n_pages, PS, heads, dim)
    return PageExport(prompt=list(prompt), max_new=4, temperature=0.0,
                      seed=0, committed=[7], pos=pos, page_size=PS,
                      pages_k=torch.randn(shape, generator=gen),
                      pages_v=torch.randn(shape, generator=gen),
                      model={"n_layers": n_layers})


# ---------------------------------------------------------------------------
# keys, the disk tier, the tiered store


class TestPrefixKey:
    def test_content_addressed_and_stable(self):
        a = prefix_key([1, 2, 3, 4])
        assert a == prefix_key([1, 2, 3, 4])
        assert a != prefix_key([1, 2, 3, 5])
        assert a.startswith("hib-")
        assert a == prefix_key(np.asarray([1, 2, 3, 4], np.int32))
        # the JAX package's key for the same tokens
        assert a == jhib.prefix_key([1, 2, 3, 4])


class TestDiskTier:
    def test_roundtrip_reopen_and_shared_manifest(self, tmp_path):
        d = DiskTier(str(tmp_path), 1 << 20)
        d.put("hib-aa", b"x" * 100)
        d.put("hib-bb", b"y" * 50)
        d2 = DiskTier(str(tmp_path), 1 << 20)
        assert "hib-aa" in d2 and "hib-bb" in d2
        assert d2.take("hib-aa") == b"x" * 100
        assert d2.bytes_stored == 50
        with pytest.raises(SwapEvictedError):
            d2.take("hib-aa")
        # the JAX package's tier reads the port's manifest and blobs
        j = jhib.DiskTier(str(tmp_path), 1 << 20)
        assert j.take("hib-bb") == b"y" * 50

    def test_lru_eviction_by_bytes(self, tmp_path):
        d = DiskTier(str(tmp_path), 120)
        assert d.put("hib-a", b"a" * 50) == []
        assert d.put("hib-b", b"b" * 50) == []
        assert d.put("hib-c", b"c" * 50) == ["hib-a"]
        assert d.evicted == 1 and len(d) == 2
        files = [f for f in os.listdir(str(tmp_path))
                 if f.endswith(".kvblob")]
        assert len(files) == 2
        assert d.put("hib-huge", b"z" * 200) is None
        assert "hib-huge" not in d

    def test_orphan_and_stale_gc_counted(self, tmp_path):
        d = DiskTier(str(tmp_path), 1 << 20)
        d.put("hib-keep", b"k" * 10)
        d.put("swap-0", b"s" * 10)
        (tmp_path / ".tmp-hib-dead.kvblob").write_bytes(b"torn")
        (tmp_path / "hib-stray.kvblob").write_bytes(b"stray")
        d2 = DiskTier(str(tmp_path), 1 << 20)
        assert d2.gc_orphans == 2
        assert not (tmp_path / ".tmp-hib-dead.kvblob").exists()
        assert not (tmp_path / "hib-stray.kvblob").exists()
        assert d2.gc("swap-") == 1
        assert d2.gc_stale == 1
        assert "swap-0" not in d2 and "hib-keep" in d2

    def test_corrupt_blob_typed_and_counted(self, tmp_path):
        d = DiskTier(str(tmp_path), 1 << 20)
        d.put("hib-x", b"q" * 64)
        p = tmp_path / d._index["hib-x"]["file"]
        raw = bytearray(p.read_bytes())
        raw[10] ^= 0xFF
        p.write_bytes(bytes(raw))
        with pytest.raises(PageShipError, match="integrity"):
            d.take("hib-x")
        assert d.corrupt == 1 and "hib-x" not in d
        d.put("hib-y", b"r" * 64)
        os.unlink(str(tmp_path / d._index["hib-y"]["file"]))
        with pytest.raises(PageShipError, match="unreadable"):
            d.take("hib-y")
        assert d.corrupt == 2
        with pytest.raises(SwapEvictedError):
            d.take("hib-missing")


class TestTieredStore:
    def test_host_spills_to_disk_not_void(self, tmp_path):
        s = TieredStateStore(120, disk_dir=str(tmp_path))
        assert s.put("hib-a", b"a" * 80) == []
        assert s.put("hib-b", b"b" * 80) == []
        assert s.spills == 1
        assert "hib-a" in s and "hib-b" in s
        assert "hib-a" in s.disk
        assert s.take("hib-b") == b"b" * 80
        assert s.take("hib-a") == b"a" * 80
        st = s.stats()
        assert st["spills"] == 1 and st["disk"]["takes"] == 1

    def test_without_disk_degrades_to_swapstore(self):
        s = TieredStateStore(120)
        s.put("swap-0", b"a" * 80)
        assert s.put("swap-1", b"b" * 80) == ["swap-0"]
        assert s.evicted == 1
        assert s.put("swap-big", b"z" * 200) is None
        assert s.rejected == 1

    def test_clear_prefix_spares_the_durable_tier(self, tmp_path):
        s = TieredStateStore(1 << 20, disk_dir=str(tmp_path))
        s.put("swap-0", b"s" * 10)
        s.put("hib-a", b"h" * 10)
        s.flush_to_disk()
        s.put("swap-1", b"t" * 10)
        s.clear("swap-")
        assert "swap-0" not in s and "swap-1" not in s
        assert "hib-a" in s.disk
        s.clear()
        assert "hib-a" in s.disk


# ---------------------------------------------------------------------------
# the quantized wire frame


class TestQuantizedWire:
    def test_quantize_ratio_and_roundtrip(self):
        ex = _frame(list(range(1, 9)), pos=8)
        q = quantize_export(ex)
        assert q.quantized and not ex.quantized
        assert q.nbytes() <= 0.3 * q.exact_nbytes()
        back = deserialize_export(serialize_export(q))
        assert back.quantized
        assert torch.equal(back.pages_k, q.pages_k)
        assert torch.equal(back.scales_k, q.scales_k)
        deq = back.dequantized()
        assert not deq.quantized
        err = (deq.pages_k - ex.pages_k).abs().max()
        assert err <= ex.pages_k.abs().max() / 100
        assert quantize_export(q) is q

    def test_v1_exact_frames_still_parse(self):
        ex = _frame(list(range(1, 9)), pos=8)
        blob = serialize_export(ex)
        assert b'"version": 1' in blob
        back = deserialize_export(blob)
        assert not back.quantized
        assert torch.equal(back.pages_k, ex.pages_k)
        assert back.prompt == ex.prompt and back.pos == ex.pos

    def test_quantized_ship_rejected_on_exact_pool(self):
        pre = _srv(ship=True)
        dec = _srv(ship=True, swap_quantize=False)
        try:
            ex = pre.prefill_export([1, 2, 3, 4, 5], 4, timeout=120)
            with pytest.raises(PageShipError, match="quantized"):
                dec.admit_with_pages(quantize_export(ex), timeout=120)
        finally:
            pre.stop()
            dec.stop()

    def test_quantized_ship_accepted_on_quantizing_pool(self):
        pre, dec = _srv(ship=True), _srv(ship=True)
        try:
            prompt = [1, 2, 3, 4, 5]
            ex = pre.prefill_export(prompt, 4, timeout=120)
            got = dec.admit_with_pages(quantize_export(ex), timeout=120)
            assert got == _want(tuple(prompt), 4)
        finally:
            pre.stop()
            dec.stop()


# ---------------------------------------------------------------------------
# hibernate -> resume


def _two_turns(tmp_path, gen_kw=None, srv_kw=None, between=None):
    """Turn 1 on a sticky session, idle past `hibernate_idle_s` (the sweep
    hibernates it), then turn 2 whose prompt extends turn 1's sequence.
    Returns (turn-2 ids, turn-2 prompt, stats, ledger)."""
    gen_kw = dict(gen_kw or {})
    srv = _srv(tmp_path, hibernate_idle_s=0.15, **(srv_kw or {}))
    hib = _hibernations(srv)
    try:
        srv.warmup()
        out1 = srv.generate(list(range(1, 9)), 8, timeout=120,
                            session_id="s1", **gen_kw)
        assert hib.wait(30), "the idle sweep never fired"
        if between is not None:
            between(srv)
        p2 = out1 + [3, 4]
        out2 = srv.generate(p2, 6, timeout=120, session_id="s1", **gen_kw)
        stats = srv.stats()
        ledger = srv.page_ledger()
    finally:
        srv.stop()
    return out2, p2, stats, ledger


def _reference(p2, gen_kw=None):
    ref = _srv()
    try:
        return ref.generate(p2, 6, timeout=120, **(gen_kw or {}))
    finally:
        ref.stop()


class TestHibernateResume:
    def test_greedy_resume_byte_identical(self, tmp_path):
        out2, p2, stats, ledger = _two_turns(tmp_path)
        assert ledger["balanced"]
        assert stats["hibernate"]["out"] == 1
        assert stats["hibernate"]["in"] == 1
        assert stats["hibernate"]["bytes_ratio"] <= 0.3
        # turn 2 prefilled only past the hibernated whole pages
        assert stats["prefix_tokens_saved"] == (len(p2) - 2 - 1) // PS * PS
        assert out2 == _reference(p2)
        assert out2 == _want(tuple(p2), 6)

    def test_seeded_resume_byte_identical(self, tmp_path):
        kw = {"temperature": 0.8, "seed": 11}
        out2, p2, stats, _ = _two_turns(tmp_path, gen_kw=kw)
        assert stats["hibernate"]["in"] == 1
        assert out2 == _reference(p2, gen_kw=kw)

    def test_resume_composes_with_speculation_and_chunks(self, tmp_path):
        out2, p2, stats, _ = _two_turns(
            tmp_path, srv_kw={"speculate": "ngram", "prefill_chunk": 4})
        assert stats["hibernate"]["in"] == 1
        assert out2 == _want(tuple(p2), 6)

    def test_exact_mode_resume(self, tmp_path):
        out2, p2, stats, _ = _two_turns(
            tmp_path, srv_kw={"swap_quantize": False})
        assert stats["hibernate"]["in"] == 1
        assert stats["hibernate"]["bytes"] == stats["hibernate"][
            "exact_bytes"]
        assert out2 == _reference(p2)

    def test_resume_from_the_disk_tier(self, tmp_path):
        def flush(srv):
            with srv._cond:
                assert srv._swap.flush_to_disk() >= 1
        out2, p2, stats, _ = _two_turns(tmp_path, between=flush)
        assert stats["hibernate"]["in"] == 1
        assert stats["hibernation"]["store"]["disk"]["takes"] == 1
        assert out2 == _reference(p2)

    def test_zero_builds_across_hibernate_and_resume(self, tmp_path):
        tw = tcw.compile_watcher()
        srv = _srv(tmp_path, hibernate_idle_s=0.15)
        hib = _hibernations(srv)
        try:
            srv.warmup()
            before = tw.total()
            out1 = srv.generate(list(range(1, 9)), 8, timeout=120,
                                session_id="s1")
            assert hib.wait(30)
            p2 = out1 + [3, 4]
            out2 = srv.generate(p2, 6, timeout=120, session_id="s1")
            stats = srv.stats()
        finally:
            srv.stop()
        assert stats["hibernate"]["in"] == 1
        assert tw.total() == before, "hibernate and resume built programs"
        assert out2 == _want(tuple(p2), 6)

    def test_hibernation_stats_and_validation(self, tmp_path):
        srv = _srv(tmp_path, hibernate_idle_s=5.0)
        try:
            st = srv.stats()["hibernation"]
            assert st["idle_s"] == 5.0 and st["quantize"] is True
            assert st["disk"] == str(tmp_path)
        finally:
            srv.stop()
        with pytest.raises(ValueError, match="hibernate_idle_s"):
            ContinuousLMServer(CFG, _tree(), kv="dense",
                               hibernate_idle_s=1.0, device="cpu")
        with pytest.raises(ValueError, match=">= 0"):
            _srv(hibernate_idle_s=-1.0)
        with pytest.raises(ValueError, match="state_dir"):
            _srv(tmp_path)


def _jax_hibernated(jsrv, timeout_s=30.0):
    for _ in range(int(timeout_s / 0.05)):
        if jsrv.stats().get("hibernate", {}).get("out", 0):
            return True
        with jsrv._cond:
            jsrv._cond.wait(0.05)
    return False


class TestSweepKeepsTheTree:
    """The sweep drops the hibernated session's chain and nothing else:
    the rest of the radix tree and the lanes in flight go on serving."""

    CACHED = list(range(20, 33))        # 13 tokens: 3 whole pages + 1

    def test_a_prompt_cached_beside_the_session_still_hits(self, tmp_path):
        saved = {}
        srv = _srv(tmp_path, hibernate_idle_s=0.15)
        hib = _hibernations(srv)
        jsrv = JServer(JCFG, _jparams(), slots=2, page_size=PS, pages=32,
                       hibernate_idle_s=0.15,
                       state_dir=str(tmp_path / "jax"))
        try:
            for name, s, wait in (("port", srv, hib.wait),
                                  ("jax", jsrv, lambda t: _jax_hibernated(
                                      jsrv, t))):
                first = s.generate(self.CACHED, 2, timeout=120)
                s.generate(list(range(1, 9)), 8, timeout=120,
                           session_id="s1")
                assert wait(30), name
                before = s.stats()["prefix_tokens_saved"]
                again = s.generate(self.CACHED, 2, timeout=120)
                saved[name] = s.stats()["prefix_tokens_saved"] - before
                assert again == first == _want(tuple(self.CACHED), 2)
                assert s.stats()["hibernate"]["out"] == 1
            assert srv.page_ledger()["balanced"]
        finally:
            srv.stop()
            jsrv.stop()
        assert saved["port"] == saved["jax"] == len(self.CACHED) - 1

    def test_a_lane_decoding_through_the_sweep_keeps_its_tokens(
            self, tmp_path):
        """A long lane is held at a gate on `srv._step` (set after
        `warmup()`, which builds it) until the session's request is
        queued, so the session finishes and is swept (idle 0) while the
        long lane still decodes."""
        srv = _srv(tmp_path, hibernate_idle_s=0.0)
        busy_at_sweep = []
        real_record = srv.metrics.record_hibernate

        def record(direction, *args):
            if direction == "out":
                busy_at_sweep.append(any(s.active for s in srv._slots))
            real_record(direction, *args)

        srv.metrics.record_hibernate = record
        res = {}
        try:
            srv.warmup()
            blocked, release = threading.Event(), threading.Event()
            real_step = srv._step

            def gated(*args):
                s = srv._slots[0]
                if (not blocked.is_set() and s.active
                        and len(s.generated) >= 2):
                    blocked.set()
                    release.wait(120)
                return real_step(*args)

            srv._step = gated
            long = threading.Thread(target=lambda: res.__setitem__(
                "long", srv.generate([5, 6, 7], 56, timeout=120)))
            long.start()
            assert blocked.wait(60)
            sess = threading.Thread(target=lambda: res.__setitem__(
                "s1", srv.generate(list(range(1, 9)), 2, timeout=120,
                                   session_id="s1")))
            sess.start()
            with srv._cond:
                assert srv._cond.wait_for(lambda: srv._queue, 60)
            release.set()
            sess.join(timeout=120)
            long.join(timeout=120)
            assert not sess.is_alive() and not long.is_alive()
            stats = srv.stats()
            assert srv.page_ledger()["balanced"]
        finally:
            release.set()
            srv.stop()
        assert stats["hibernate"]["out"] == 1
        assert busy_at_sweep == [True]
        assert res["long"] == _want((5, 6, 7), 56)
        assert res["s1"] == _want(tuple(range(1, 9)), 2)


class TestRestartResume:
    def test_fresh_process_resumes_from_the_manifest(self, tmp_path):
        srv1 = _srv(tmp_path, hibernate_idle_s=0.15)
        hib = _hibernations(srv1)
        try:
            out1 = srv1.generate(list(range(1, 9)), 8, timeout=120,
                                 session_id="s1")
            assert hib.wait(30)
            with srv1._cond:
                assert srv1._swap.flush_to_disk() >= 1
        finally:
            srv1.stop()
        (tmp_path / ".tmp-hib-dead.kvblob").write_bytes(b"torn")
        (tmp_path / "hib-stray.kvblob").write_bytes(b"stray")
        assert (tmp_path / MANIFEST_NAME).exists()
        srv2 = _srv(tmp_path, hibernate_idle_s=30.0)
        try:
            p2 = out1 + [3, 4]
            out2 = srv2.generate(p2, 6, timeout=120, session_id="s1")
            stats = srv2.stats()
            assert stats["hibernate"]["in"] == 1
            assert stats["hibernation"]["store"]["disk"]["gc_orphans"] == 2
            assert not (tmp_path / "hib-stray.kvblob").exists()
        finally:
            srv2.stop()
        assert out2 == _want(tuple(p2), 6)

    def test_clean_stop_flushes_host_tier_to_disk(self, tmp_path):
        srv1 = _srv(tmp_path, hibernate_idle_s=0.15)
        hib = _hibernations(srv1)
        try:
            out1 = srv1.generate(list(range(1, 9)), 8, timeout=120,
                                 session_id="s1")
            assert hib.wait(30)
        finally:
            srv1.stop()
        srv2 = _srv(tmp_path, hibernate_idle_s=30.0)
        try:
            p2 = out1 + [3, 4]
            out2 = srv2.generate(p2, 6, timeout=120, session_id="s1")
            assert srv2.stats()["hibernate"]["in"] == 1
        finally:
            srv2.stop()
        assert out2 == _want(tuple(p2), 6)


class TestCrossPackageResume:
    @pytest.mark.parametrize("quantize", [True, False])
    def test_a_jax_hibernated_session_is_resumed_by_the_port(
            self, tmp_path, quantize):
        jsrv = JServer(JCFG, _jparams(), slots=2, page_size=PS, pages=32,
                       hibernate_idle_s=0.15, state_dir=str(tmp_path),
                       swap_quantize=quantize)
        try:
            out1 = jsrv.generate(list(range(1, 9)), 8, timeout=120,
                                 session_id="s1")
            for _ in range(600):
                if jsrv.stats().get("hibernate", {}).get("out", 0):
                    break
                with jsrv._cond:
                    jsrv._cond.wait(0.05)
            assert jsrv.stats()["hibernate"]["out"] == 1
            # the JAX server's stop flushes its host tier only when its
            # worker is at the top of its loop (ROADMAP.md, queue C):
            # flush by hand, as its own restart test does
            with jsrv._cond:
                assert jsrv._swap.flush_to_disk() == 1
        finally:
            jsrv.stop()
        srv = _srv(tmp_path, hibernate_idle_s=30.0, swap_quantize=quantize)
        try:
            p2 = out1 + [3, 4]
            out2 = srv.generate(p2, 6, timeout=120, session_id="s1")
            assert srv.stats()["hibernate"]["in"] == 1
            assert srv.page_ledger()["balanced"]
        finally:
            srv.stop()
        assert out2 == _want(tuple(p2), 6)

    def test_a_port_hibernated_session_is_resumed_by_jax(self, tmp_path):
        srv = _srv(tmp_path, hibernate_idle_s=0.15)
        hib = _hibernations(srv)
        try:
            out1 = srv.generate(list(range(1, 9)), 8, timeout=120,
                                session_id="s1")
            assert hib.wait(30)
        finally:
            srv.stop()
        jsrv = JServer(JCFG, _jparams(), slots=2, page_size=PS, pages=32,
                       hibernate_idle_s=30.0, state_dir=str(tmp_path))
        try:
            p2 = out1 + [3, 4]
            out2 = jsrv.generate(p2, 6, timeout=120, session_id="s1")
            assert jsrv.stats()["hibernate"]["in"] == 1
        finally:
            jsrv.stop()
        assert out2 == _want(tuple(p2), 6)


# ---------------------------------------------------------------------------
# disk faults: every rung recomputes, typed, balanced


def _chaos_resume(tmp_path, disk_cfg, stream=False):
    srv = _srv(tmp_path, hibernate_idle_s=0.15)
    hib = _hibernations(srv)
    try:
        srv.warmup()
        out1 = srv.generate(list(range(1, 9)), 8, timeout=120,
                            session_id="s1")
        assert hib.wait(30)
        with srv._cond:
            chaos_disk(srv._swap, disk_cfg)
            srv._swap.flush_to_disk()
        p2 = out1 + [3, 4]
        if stream:
            out2 = p2 + list(srv.generate_stream(p2, 6, timeout=120,
                                                 session_id="s1"))
        else:
            out2 = srv.generate(p2, 6, timeout=120, session_id="s1")
        stats = srv.stats()
        assert srv.page_ledger()["balanced"]
    finally:
        srv.stop()
    assert out2 == _want(tuple(p2), 6), "a fault must never change tokens"
    return stats


class TestDiskChaos:
    @pytest.mark.parametrize("cfg", [
        DiskChaosConfig(truncate_writes=(0,)),
        DiskChaosConfig(flip_writes=(0,)),
        DiskChaosConfig(unlink_writes=(0,))],
        ids=["truncated", "bitflipped", "unlinked"])
    def test_a_bad_blob_recomputes(self, tmp_path, cfg):
        stats = _chaos_resume(tmp_path, cfg)
        assert stats["hibernate"]["corrupt"] == 1
        assert stats["hibernate"]["in"] == 0

    def test_streamed_resume_never_duplicates(self, tmp_path):
        stats = _chaos_resume(tmp_path, DiskChaosConfig(flip_writes=(0,)),
                              stream=True)
        assert stats["hibernate"]["corrupt"] == 1
        assert stats["hibernate"]["in"] == 0

    def test_enospc_drops_the_entry_typed(self, tmp_path):
        stats = _chaos_resume(tmp_path, DiskChaosConfig(enospc_writes=(0,)))
        assert stats["hibernation"]["store"]["disk"]["write_failed"] == 1
        assert stats["hibernate"]["in"] == 0

    def test_kill_in_commit_window_leaves_only_debris(self, tmp_path):
        stats = _chaos_resume(tmp_path, DiskChaosConfig(kill_writes=(0,)))
        assert stats["hibernation"]["store"]["disk"]["write_failed"] == 1
        assert stats["hibernate"]["in"] == 0
        d2 = DiskTier(str(tmp_path), 1 << 20)
        assert d2.gc_orphans >= 1
        assert not [f for f in os.listdir(str(tmp_path))
                    if f.startswith(".tmp-")]


# ---------------------------------------------------------------------------
# preemption swap on the same tiers


class TestPreemptionOnTiers:
    def test_preempted_victim_resumes_through_the_store(self, tmp_path):
        srv = _srv(tmp_path, pages=8, prefill_chunk=4, preempt=True)
        res = {}
        try:
            srv.warmup()
            blocked, release = threading.Event(), threading.Event()
            real = srv._step

            def gated(*args):
                s = srv._slots[0]
                if (not blocked.is_set() and s.active
                        and s.fed >= len(s.req.prompt)
                        and len(s.generated) >= 2):
                    blocked.set()
                    release.wait(120)
                return real(*args)

            srv._step = gated
            t = threading.Thread(target=lambda: res.__setitem__(
                "v", srv.generate([1, 2, 3], 28, priority="best_effort",
                                  timeout=120)))
            t.start()
            assert blocked.wait(60)
            ia = threading.Thread(target=lambda: res.__setitem__(
                "ia", srv.generate([4, 5, 6, 7], 8, priority="interactive",
                                   timeout=120)))
            ia.start()
            with srv._cond:
                assert srv._cond.wait_for(lambda: srv._queue, 60)
            release.set()
            ia.join(timeout=120)
            t.join(timeout=120)
            stats = srv.stats()
            assert srv.page_ledger()["balanced"]
        finally:
            srv.stop()
        assert stats.get("preemptions", 0) >= 1
        assert stats["swap"]["out"] >= 1
        assert res["v"] == _want((1, 2, 3), 28)
        assert res["ia"] == _want((4, 5, 6, 7), 8)

    def test_stale_swap_keys_gcd_on_restart(self, tmp_path):
        d = DiskTier(str(tmp_path), 1 << 20)
        d.put("swap-0", b"dead lane" * 4)
        d.put("hib-live", b"hibernated" * 4)
        del d
        srv = _srv(tmp_path, preempt=True)
        try:
            with srv._cond:
                assert "swap-0" not in srv._swap
                assert "hib-live" in srv._swap
                assert srv._swap.disk.gc_stale == 1
        finally:
            srv.stop()
