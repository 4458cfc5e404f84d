"""PyTorch port: the span store (`obs.trace`) and what records into it.

- The ring: bounded at ``SPAN_CAPACITY``, parent links, the off switch a
  no-op, the clock anchor onto Unix-epoch ns, Chrome events.
- A CPU `ContinuousLMServer`'s rounds: the five phases lie back to back
  inside ``serve.round`` (the lock wait inside ``serve.admit``), and
  each request's ``serve.queue`` span is its trace's queue wait, enqueue
  to install.  ``kv_pages`` and ``qk_pairs`` against their formulas on
  a hand-built pool.
- The train step: one forward (with its cast) and one backward a
  microbatch and one update a step, all children of ``train.step``.
- `runtime.profiler.attribute` on synthetic profiler events: a kernel by
  correlation id, a gap split by the spans' self time; `trace` writes
  the spans into its Chrome file and ``attribution.json`` beside it.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.obs.trace import (
    SPAN_CAPACITY,
    SPAN_COUNTS,
    TraceRecorder,
    clear_spans,
    new_pool_id,
    new_span_id,
    reanchor,
    record_span,
    set_spans_enabled,
    spans,
    spans_chrome_events,
    to_epoch_ns,
)
from deeplearning4j_tpu_torch.parallel import hybrid as th
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.runtime import profiler as tprof
from deeplearning4j_tpu_torch.serving import ContinuousLMServer
from deeplearning4j_tpu_torch.serving.lm import _LMRequest
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

CFG = tt.TransformerConfig(vocab_size=128, d_model=32, n_heads=4,
                           n_layers=2, d_ff=64, max_len=48,
                           attn_bias=True, tie_embeddings=True)
PHASES = ["serve.admit", "serve.stage", "serve.launch", "serve.wait",
          "serve.commit"]
ROUND = SPAN_COUNTS["serve.round"]


def _params():
    return tt.params_from_numpy(tt.numpy_params(CFG, seed=0), device="cpu")


# ---------------------------------------------------------------------------
# the ring


def test_ring_is_bounded_and_keeps_the_newest():
    for i in range(SPAN_CAPACITY + 5):
        record_span("test.cap", i, i + 1)
    got = spans(("test.cap",))
    assert len(got) == SPAN_CAPACITY
    assert got[0].t0_ns == 5 and got[-1].t0_ns == SPAN_CAPACITY + 4
    assert len(spans()) == SPAN_CAPACITY


def test_parent_links_thread_counts_and_tag():
    parent, child = new_span_id(), new_span_id()
    assert child > parent > 0
    record_span("test.child", 10, 20, child, parent, (3, 4), tag="rid-1")
    record_span("test.parent", 5, 30, parent, 0, (7,))
    got = {s.name: s for s in spans(("test.child", "test.parent"))
           if s.sid in (parent, child)}
    assert got["test.child"].parent == got["test.parent"].sid == parent
    assert got["test.child"].counts == (3, 4)
    assert got["test.child"].tag == "rid-1"
    assert got["test.parent"].tid == threading.get_native_id()
    seen = []
    worker = threading.Thread(target=lambda: (
        record_span("test.thread", 1, 2, new_span_id()),
        seen.append(threading.get_native_id())))
    worker.start()
    worker.join()
    assert spans(("test.thread",))[-1].tid == seen[0]


def test_off_switch_records_nothing():
    before = len(spans(("test.off",)))
    set_spans_enabled(False)
    try:
        record_span("test.off", 1, 2)
        assert len(spans(("test.off",))) == before
    finally:
        set_spans_enabled(True)
    record_span("test.off", 1, 2)
    assert len(spans(("test.off",))) == before + 1


def test_anchor_puts_the_ring_on_the_profilers_clock():
    reanchor()
    assert abs(to_epoch_ns(time.perf_counter_ns()) - time.time_ns()) < 5e6
    t = time.perf_counter_ns()
    assert to_epoch_ns(t + 1234) - to_epoch_ns(t) == 1234
    sid = new_span_id()
    record_span("serve.round", t, t + 2500, sid, 0,
                (9, 64, 3, 70, 12, 16, 999))
    (s,) = [s for s in spans(("serve.round",)) if s.sid == sid]
    base = to_epoch_ns(t) - 7000
    (ev,) = spans_chrome_events([s], base)
    assert ev["ts"] == pytest.approx(7.0) and ev["dur"] == 2.5
    assert ev["tid"] == threading.get_native_id()
    assert ev["pid"] == os.getpid()
    assert ev["args"] == dict(zip(ROUND, (9, 64, 3, 70, 12, 16, 999)))


def test_device_intervals_are_none_off_the_card():
    pool = tprof.DeviceIntervals()
    iv = pool.start(torch.device("cpu"))
    assert iv is None
    pool.stop(iv, torch.device("cpu"))


# ---------------------------------------------------------------------------
# the serving round


def _rounds(pool):
    out = [s for s in spans(("serve.round",)) if s.counts[0] == pool]
    kids = {}
    for s in spans(PHASES + ["serve.lock"]):
        kids.setdefault(s.parent, []).append(s)
    return out, kids


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_round_phases_nest_back_to_back(kv):
    tracer = TraceRecorder()
    srv = ContinuousLMServer(CFG, _params(), slots=3, kv=kv, page_size=4,
                             prefill_chunk=4 if kv == "paged" else 1,
                             tracer=tracer, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, size=n).tolist() for n in (9, 5, 13, 6)]
    try:
        threads = [threading.Thread(target=srv.generate,
                                    args=(p, 4), kwargs={
                                        "request_id": f"rid-{kv}-{i}"})
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        srv.stop()
    rounds, kids = _rounds(srv._span_pool)
    assert len(rounds) >= 4
    for r in rounds:
        phases = sorted(kids[r.sid], key=lambda s: s.t0_ns)
        assert [s.name for s in phases] == PHASES
        assert phases[0].t0_ns == r.t0_ns and phases[-1].t1_ns == r.t1_ns
        for a, b in zip(phases, phases[1:]):
            assert a.t1_ns == b.t0_ns          # back to back
        assert all(s.t1_ns >= s.t0_ns for s in phases)
        assert sum(s.t1_ns - s.t0_ns for s in phases) == r.t1_ns - r.t0_ns
        (lock,) = kids[phases[0].sid]
        assert lock.name == "serve.lock"
        assert phases[0].t0_ns <= lock.t0_ns <= lock.t1_ns <= \
            phases[0].t1_ns
        c = dict(zip(ROUND, r.counts))
        assert 1 <= c["lanes"] <= 3 and c["fed_tokens"] >= c["lanes"]
        assert c["width"] in ((1,) if kv == "dense" else (1, 4))
        assert (c["kv_pages"] > 0) == (kv == "paged")
    # one queue span a request, enqueue to install, as its trace says
    queue = {s.tag: s for s in spans(("serve.queue",))
             if s.counts == (srv._span_pool,)}
    assert sorted(queue) == sorted(f"rid-{kv}-{i}" for i in range(4))
    for rid, s in queue.items():
        (tr,) = tracer.find(rid)
        (wait,) = [x for x in tr["spans"] if x["name"] == "queue_wait"]
        assert s.t0_ns / 1e9 == pytest.approx(wait["t0_s"], abs=1e-6)
        assert (s.t1_ns - s.t0_ns) / 1e9 == pytest.approx(wait["dur_s"],
                                                          abs=1e-6)


def test_kv_pages_and_pairs_follow_their_formulas_on_a_hand_built_pool():
    srv = ContinuousLMServer(CFG, _params(), slots=3, page_size=4,
                             prefill_chunk=4, device="cpu")
    srv._reset_pool_locked()
    srv._cache = (torch.zeros(1), torch.zeros(1))
    seen = {}

    def step(params, k, v, table, pos, n_feed, *rest):
        seen["pos"], seen["n_feed"] = pos.copy(), n_feed.copy()
        zeros = torch.zeros(3, dtype=torch.int32)
        return zeros, zeros, k, v

    srv._step = step
    # lane 0 mid-prefill (16 prompt tokens left, 4 fed at 4), lane 1
    # decoding at 9, lane 2 free
    prefill, decode = srv._slots[0], srv._slots[1]
    prefill.req = _LMRequest(list(range(1, 21)), 4, 0.0, 0)
    prefill.fed = prefill.pos = 4
    decode.req = _LMRequest([1, 2, 3, 4, 5], 8, 0.0, 0)
    decode.fed, decode.pos, decode.generated = 5, 9, [7, 7, 7, 7, 7]
    for s in (prefill, decode):
        s.table = np.zeros((srv.max_pages,), np.int32)
    t = time.perf_counter_ns()
    srv._dispatch_paged([prefill, decode], [], [], 0, (t, t, t))
    (r,) = [s for s in spans(("serve.round",))
            if s.counts[0] == srv._span_pool]
    c = dict(zip(ROUND, r.counts))
    pos, n_feed = seen["pos"], seen["n_feed"]
    fed = [i for i in range(3) if n_feed[i]]
    assert fed == [0, 1] and list(n_feed[:2]) == [4, 1]
    assert c["kv_pages"] == sum(-(-(int(pos[i]) + int(n_feed[i])) // 4)
                                for i in fed) == 2 + 3
    assert c["qk_pairs"] == (4 * 4 + 10) + (9 + 1)
    assert (c["width"], c["lanes"], c["fed_tokens"], c["page_size"]) == \
        (4, 2, 5, 4)


# ---------------------------------------------------------------------------
# the train step


def test_train_step_records_its_parts_under_the_step():
    cfg = dataclasses.replace(CFG, max_len=16)
    step, init = th.make_accum_train_step(cfg, lr=1e-2, accum=2,
                                          updater="adam")
    params = th._master_f32(tt.params_from_numpy(
        tt.numpy_params(cfg, seed=0), device="cpu"))
    state = init(params)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, 128, (4, 8)).astype(np.int64))
    before = spans(("train.step",))
    last = before[-1].sid if before else 0
    for _ in range(2):
        params, state, _ = step(params, state, tok, tok)
    steps = [s for s in spans(("train.step",)) if s.sid > last]
    assert len(steps) == 2 and all(s.counts == (2,) for s in steps)
    parts = spans(("train.forward", "train.backward", "train.update",
                   "train.cast"))
    for st in steps:
        kids = [s for s in parts if s.parent == st.sid]
        names = [s.name for s in sorted(kids, key=lambda s: s.t0_ns)]
        assert names == ["train.forward", "train.backward"] * 2 + \
            ["train.update"]
        for s in kids:
            assert st.t0_ns <= s.t0_ns <= s.t1_ns <= st.t1_ns
        for fwd in (s for s in kids if s.name == "train.forward"):
            (cast,) = [s for s in parts if s.parent == fwd.sid]
            assert cast.name == "train.cast"
            assert fwd.t0_ns <= cast.t0_ns <= cast.t1_ns <= fwd.t1_ns
        (upd,) = [s for s in kids if s.name == "train.update"]
        assert upd.tag is None               # no device interval on a CPU


# ---------------------------------------------------------------------------
# attribution


def _span(name, a_us, b_us, tid, sid=0, parent=0):
    from deeplearning4j_tpu_torch.obs.trace import Span

    return Span(name, int(a_us * 1e3), int(b_us * 1e3), tid, sid, parent,
                (), None)


def test_attribution_by_correlation_id_and_gap_self_time():
    base = to_epoch_ns(0)          # the events' us are the spans' perf us
    ring = [_span("serve.round", 1000, 2000, 7, 1),
            _span("serve.stage", 1000, 1400, 7, 0, 1),
            _span("serve.launch", 1400, 1500, 7, 0, 1),
            _span("serve.wait", 1500, 1900, 7, 0, 1),
            _span("serve.commit", 1900, 2000, 7, 0, 1),
            _span("serve.queue", 900, 1950, 7)]         # a wait: skipped

    def x(cat, name, ts, dur, tid=7, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
              "tid": tid, "pid": 1}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    events = [
        x("cpu_op", "aten::copy_", 1440, 30),
        x("cuda_runtime", "cudaGraphLaunch", 1450, 10, corr=11),
        x("kernel", "void paged_attention_mma_kernel<4>(Args)", 1460, 300,
          tid=0, corr=11),
        x("cuda_runtime", "cudaLaunchKernel", 1950, 5, corr=12),
        x("kernel", "reduce_kernel", 1980, 10, tid=0, corr=12),
        x("cuda_runtime", "cudaLaunchKernel", 1985, 2, tid=9, corr=13),
        x("kernel", "autograd_kernel", 1990, 10, tid=0, corr=13),
        # thread 9 (no spans of its own) ends the gap [2000, 2030)
        x("cuda_runtime", "cudaLaunchKernel", 1995, 2, tid=9, corr=14),
        x("kernel", "late_kernel", 2030, 10, tid=0, corr=14),
        x("kernel", "orphan_kernel", 1100, 0.5, tid=0, corr=99),
        {"ph": "i", "name": "marker", "ts": 1500},
    ]
    ring.append(_span("serve.commit", 2000, 2040, 7, 0, 1))
    out = tprof.attribute(events, ring, base, 1_400_000, 2_040_000)
    us = 1e-6
    dev = out["device_s_by_span"]
    assert dev["serve.launch"] == pytest.approx(300 * us)
    assert dev["serve.commit"] == pytest.approx(10 * us)
    # thread 9 had no span open: the innermost open elsewhere, marked
    assert dev["serve.commit (another thread)"] == pytest.approx(20 * us)
    assert out["unmatched_device_s"] == 0       # the orphan is outside
    idle = out["idle_s_by_span"]
    # [1400, 1460) before the first kernel, in serve.launch; the gap
    # [1760, 1980) ended by the commit's kernel, split by self time; the
    # gap [2000, 2030) ended by thread 9's kernel, by thread 7's spans
    assert idle == pytest.approx({"serve.launch": 60 * us,
                                  "serve.wait": 140 * us,
                                  "serve.commit": 80 * us,
                                  "serve.commit (another thread)": 30 * us})
    assert out["busy_s"] == pytest.approx(330 * us)
    top = out["kernels"][0]
    assert top["kernel"] == "paged_attention_mma_kernel"
    assert top["launches"] == 1
    assert top["by_op"] == {"aten::copy_": pytest.approx(300 * us)}
    assert top["by_span"] == {"serve.launch": pytest.approx(300 * us)}


def test_trace_writes_the_spans_and_their_attribution(tmp_path):
    logdir = str(tmp_path / "prof")
    with tprof.trace(logdir):
        t0 = time.perf_counter_ns()
        sid = new_span_id()
        torch.ones(16, 16) @ torch.ones(16, 16)
        record_span("train.step", t0, time.perf_counter_ns(), sid, 0, (1,))
    names = sorted(os.listdir(logdir))
    assert names[0] == "attribution.json"
    doc = json.loads((tmp_path / "prof" / names[1]).read_text())
    mine = [e for e in doc["traceEvents"]
            if e.get("cat") == "program_span" and e["name"] == "train.step"]
    assert len(mine) == 1 and mine[0]["args"] == {"accum": 1}
    assert mine[0]["tid"] == threading.get_native_id()
    # on the profiler's clock: inside the profiled ops' extent
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops and min(e["ts"] for e in ops) - 1e4 <= mine[0]["ts"] <= \
        max(e["ts"] for e in ops) + 1e4
    att = json.loads((tmp_path / "prof" / names[0]).read_text())
    assert set(att) >= {"device_s_by_span", "idle_s_by_span", "kernels",
                        "busy_s", "window_s"}


def test_pool_ids_differ():
    assert new_pool_id() != new_pool_id()


def test_clear_spans_empties_the_ring():
    record_span("test.clear", 1, 2)
    clear_spans()
    assert spans() == []
