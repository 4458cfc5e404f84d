"""PyTorch port, slice 22: the compile watcher and the serving programs it
counts, against the JAX package's on seeded numpy inputs.

- the watcher's API: thread-local scopes, `total(prefix)`, `counts()`,
  `any_since`, `events_between` and the `collector_samples` names, types,
  labels and values, fed the same events on both sides;
- the LM pools (paged with chunk 4, n-gram and model speculation,
  shipping, dense): `warmup()` and ``stats()["compiled_programs"]`` equal
  JAX's, the program keys the warmup built equal the ``lm:`` keys JAX
  compiled, each built once; `tests/test_paged.py`'s 24-request
  mixed-length storm (prefix hits) and a copy-on-write admission build
  nothing, their ids equal to JAX's `generate` (f32, greedy);
- an unwarmed request carries ``xla_compile`` spans with the same program
  keys as JAX's (the LM pool and the classifier engine);
- the engine: ``compiles_total >= compiled_programs > 0``, and its guard
  names the observed count in JAX's words;
- the split sampler (host noise, device draw) picks the ids the per-lane
  eager sampler did, and no program reads back to the host.
"""

import dataclasses
import functools
import re
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.obs import compilewatch as jcw
from deeplearning4j_tpu.obs.trace import TraceRecorder as JTraceRecorder
from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.serving import BucketLadder as JLadder
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu.serving.lm import ContinuousLMServer as JServer
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import char_lstm, params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.obs import compilewatch as tcw
from deeplearning4j_tpu_torch.obs.trace import TraceRecorder
from deeplearning4j_tpu_torch.parallel import generation as tgen
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import BucketLadder, ServingEngine
from deeplearning4j_tpu_torch.serving import ContinuousLMServer
from deeplearning4j_tpu_torch.serving.resilience import (
    UnservableShapeError,
)
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

# tests/test_paged.py's storm model: `_lm(max_len=32)`'s shapes
JCFG = jt.TransformerConfig(vocab_size=50, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=32)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))
POOLS = {
    "paged": dict(kv="paged", page_size=8, prefill_chunk=4),
    "ngram": dict(kv="paged", page_size=8, prefill_chunk=4,
                  speculate="ngram", draft_len=3),
    "model": dict(kv="paged", page_size=8, prefill_chunk=4,
                  speculate="model", draft_len=3),
    "ship": dict(kv="paged", page_size=8, prefill_chunk=4, ship=True),
    "dense": dict(kv="dense"),
}
NEW = 5


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(CFG, seed=0)


def _jparams():
    return jax.tree_util.tree_map(jnp.asarray, _tree())


def _tparams():
    return tt.params_from_numpy(_tree(), device="cpu")


def _storm_prompts():
    """`tests/test_paged.py`'s storm: every third prompt shares a 10-token
    system prefix (prefix hits)."""
    rng = np.random.default_rng(2)
    system = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    out = []
    for i in range(24):
        if i % 3 == 0:
            out.append(system + [int(t) for t in rng.integers(1, 49, 3)])
        else:
            out.append([int(t) for t in
                        rng.integers(1, 49, rng.integers(1, 14))])
    return out


@functools.lru_cache(maxsize=64)
def _jax_generate(prompt):
    out = jgen.generate(JCFG, _jparams(), np.asarray([prompt], np.int32),
                        NEW)
    return [int(t) for t in np.asarray(out)[0]]


def _delta(after, before):
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


# ---------------------------------------------------------------------------
# the watcher's API, fed the same events on both sides


def _feed(watcher, record):
    """Three scoped events on this thread, two on another thread (whose
    scope is its own), one unscoped; returns the perf-clock window."""
    t0 = time.perf_counter()
    with watcher_scope(watcher)("lm:paged[w1]"):
        record(watcher, 0.25)

        def other():
            with watcher_scope(watcher)("classifier:(8, 4)"):
                record(watcher, 0.5)
                record(watcher, 0.125)

        th = threading.Thread(target=other)
        th.start()
        th.join()
        record(watcher, 1.0)
    record(watcher, 2.0)
    return t0, time.perf_counter()


def watcher_scope(watcher):
    return (jcw.compile_scope if isinstance(watcher, jcw.CompileWatcher)
            else tcw.compile_scope)


def _record_jax(watcher, seconds):
    watcher._listener(jcw.COMPILE_EVENT, seconds)


def _record_port(watcher, seconds):
    watcher.record(tcw.COMPILE_EVENT, seconds)


def test_watcher_scopes_counts_and_windows_equal_jax():
    jw, tw = jcw.CompileWatcher(), tcw.CompileWatcher()
    jt0, jt1 = _feed(jw, _record_jax)
    t0, t1 = _feed(tw, _record_port)
    want = {"lm:paged[w1]": 2, "classifier:(8, 4)": 2, "": 1}
    assert jw.counts() == tw.counts() == want
    for prefix in (None, "lm:", "classifier:", "nothing:"):
        assert tw.total(prefix) == jw.total(prefix)
    assert tw.any_since(t0) and jw.any_since(jt0)
    assert not tw.any_since(t1) and not jw.any_since(jt1)
    assert not tcw.CompileWatcher().any_since(0.0)
    got = [k for _, _, k in tw.events_between(t0, t1)]
    assert got == [k for _, _, k in jw.events_between(jt0, jt1)]
    assert got == ["lm:paged[w1]", "classifier:(8, 4)",
                   "classifier:(8, 4)", "lm:paged[w1]", ""]
    # an event overlaps a window by [t_end - duration, t_end]: the 2 s
    # event reaches back before the feed, the others do not
    assert [k for _, _, k in tw.events_between(t0 - 1.5, t0 - 1.2)] == \
        [k for _, _, k in jw.events_between(jt0 - 1.5, jt0 - 1.2)] == [""]
    assert tw.events_between(t1 + 1, t1 + 2) == [] == \
        jw.events_between(jt1 + 1, jt1 + 2)
    tw.record("some other event", 9.0)
    jw._listener("some other event", 9.0)
    assert tw.counts() == jw.counts() == want


def test_collector_samples_equal_jax_but_for_help_text():
    jw, tw = jcw.CompileWatcher(), tcw.CompileWatcher()
    jw.ensure_installed = lambda: None    # no listener for a throwaway
    _feed(jw, _record_jax)
    _feed(tw, _record_port)
    jrows = [(n, kind, labels, value)
             for n, kind, _, labels, value in jw.collector_samples()]
    rows = [(n, kind, labels, value)
            for n, kind, _, labels, value in tw.collector_samples()]
    assert rows == jrows
    assert [r[0] for r in rows] == ["compiles_total"] * 3 + [
        "compile_seconds_total"]
    assert rows[-1][-1] == pytest.approx(3.875)
    assert tcw.compile_watcher() is tcw.compile_watcher()
    tcw.compile_watcher().ensure_installed()       # nothing to install


# ---------------------------------------------------------------------------
# the LM pools: warmup, program keys, the zero-build storm


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_pool_warmup_builds_jax_programs_once_each(kind):
    """`warmup()` and ``compiled_programs`` equal JAX's, and the keys the
    port's warmup built, once each, are the ``lm:`` keys JAX compiled
    (JAX's caches cleared first, so it compiles every program)."""
    knobs = POOLS[kind]
    jax.clear_caches()
    jw = jcw.compile_watcher()
    jsrv = JServer(JCFG, _jparams(), slots=3, **knobs)
    jbefore = jw.counts()
    try:
        jwarm = jsrv.warmup()
        jstats = jsrv.stats()
    finally:
        jsrv.stop()
    jkeys = {k for k in _delta(jw.counts(), jbefore) if k.startswith("lm:")}
    tw = tcw.compile_watcher()
    srv = ContinuousLMServer(CFG, _tparams(), slots=3, device="cpu",
                             **knobs)
    before = tw.counts()
    try:
        warm = srv.warmup()
        built = _delta(tw.counts(), before)
        stats = srv.stats()
    finally:
        srv.stop()
    assert warm == jwarm > 0
    assert stats["compiled_programs"] == jstats["compiled_programs"] == warm
    assert set(built) == jkeys
    assert set(built.values()) == {1}
    assert stats["compiles_total"] >= warm


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_storm_after_warmup_builds_nothing_and_decodes_like_jax(kind):
    """`tests/test_paged.py`'s storm on a warmed pool: 24 concurrent
    requests of mixed lengths and prefix hits build no program (the
    watcher's total does not move), and every request's ids equal JAX's
    `generate` (f32, greedy)."""
    prompts = _storm_prompts()
    want = [_jax_generate(tuple(p)) for p in prompts]
    tw = tcw.compile_watcher()
    srv = ContinuousLMServer(CFG, _tparams(), slots=3, device="cpu",
                             **POOLS[kind])
    results = [None] * len(prompts)
    try:
        srv.warmup()
        before = tw.total()

        def client(i):
            results[i] = srv.generate(prompts[i], NEW, timeout=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(180)
        stats = srv.stats()
        ledger = srv.page_ledger()
    finally:
        srv.stop()
    assert tw.total() == before
    assert stats["requests"] == 24
    assert results == want
    assert ledger["balanced"]
    if kind != "dense":
        assert stats["prefix_hits"] > 0


@pytest.mark.parametrize("kind", ["paged", "ngram", "ship"])
def test_copy_on_write_after_warmup_replays_the_page_copy(kind):
    """A prompt that diverges inside a cached page takes copy-on-write:
    the warm page-copy program runs (its replay count moves) and nothing
    is built; ids equal JAX's `generate`."""
    first = [7, 3, 9, 1, 4, 4, 2, 8, 6, 5, 1, 2, 3, 5, 8, 13, 2, 1, 9, 9]
    second = first[:12] + [30, 31, 32, 33, 34, 35]
    tw = tcw.compile_watcher()
    srv = ContinuousLMServer(CFG, _tparams(), slots=3, device="cpu",
                             **POOLS[kind])
    try:
        srv.warmup()
        before = tw.total()
        got = [srv.generate(p, NEW, timeout=120) for p in (first, second)]
        copies = srv._copy.programs[0].replays
    finally:
        srv.stop()
    assert copies == 1 and tw.total() == before
    assert got == [_jax_generate(tuple(p)) for p in (first, second)]


# ---------------------------------------------------------------------------
# unwarmed requests carry xla_compile spans


def _compile_keys(trace):
    return {s["attrs"]["program_key"] for s in trace["spans"]
            if s["name"] == "xla_compile"}


def test_an_unwarmed_lm_request_carries_its_program_keys():
    prompt = [3, 1, 4, 1, 5, 9]              # one chunk of 4, then decode
    jax.clear_caches()
    jtracer = JTraceRecorder()
    jsrv = JServer(JCFG, _jparams(), slots=2, page_size=8, prefill_chunk=4,
                   tracer=jtracer)
    try:
        jsrv.generate(prompt, 3, timeout=120, request_id="rid-cold")
    finally:
        jsrv.stop()
    tracer = TraceRecorder()
    srv = ContinuousLMServer(CFG, _tparams(), slots=2, page_size=8,
                             prefill_chunk=4, tracer=tracer, device="cpu")
    try:
        srv.generate(prompt, 3, timeout=120, request_id="rid-cold")
        srv.generate(prompt, 3, timeout=120, request_id="rid-warm")
    finally:
        srv.stop()
    (jtr,) = jtracer.find("rid-cold")
    (tr,) = tracer.find("rid-cold")
    keys = _compile_keys(tr)
    assert keys == {k for k in _compile_keys(jtr) if k.startswith("lm:")}
    assert keys == {"lm:paged[w1]", "lm:paged[w4]"}
    (warm,) = tracer.find("rid-warm")
    assert [s["name"] for s in warm["spans"]] == ["queue_wait", "decode"]
    for s in tr["spans"]:
        if s["name"] == "xla_compile":
            assert s["dur_s"] > 0


def _iris_pair(seed):
    jn = JNet(jzoo.iris_mlp()).init(jax.random.PRNGKey(seed))
    tn = TNet(tconf.MultiLayerConfiguration.from_json(
        jzoo.iris_mlp().to_json()), device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


def test_an_unwarmed_engine_request_carries_its_classifier_key():
    """The JAX package's `test_unwarmed_request_carries_xla_compile_span`
    on both engines: the request that built its ladder shape's program
    carries an ``xla_compile`` span under ``classifier:(4, 4)``."""
    jn, tn = _iris_pair(3)
    jax.clear_caches()
    spans = []
    for engine_cls, ladder_cls, net, tracer in (
            (JEngine, JLadder, jn, JTraceRecorder()),
            (ServingEngine, BucketLadder, tn, TraceRecorder())):
        engine = engine_cls(net, ladder=ladder_cls((1, 4)), max_wait_ms=1.0,
                            tracer=tracer)
        try:
            out = engine.predict_proba(np.zeros((2, 4), np.float32),
                                       timeout=60, request_id="rid-cold")
        finally:
            engine.stop()
        (tr,) = tracer.find("rid-cold")
        spans.append(_compile_keys(tr))
        assert out.shape == (2, 3)
    assert "classifier:(4, 4)" in spans[0]
    assert spans[1] == {"classifier:(4, 4)"}


# ---------------------------------------------------------------------------
# the engine's accounting and guard


def test_engine_compiles_total_and_guard_message_name_the_count():
    jn, tn = _iris_pair(0)
    stats, messages = [], []
    for engine_cls, ladder_cls, net, watcher in (
            (JEngine, JLadder, jn, jcw.compile_watcher()),
            (ServingEngine, BucketLadder, tn, tcw.compile_watcher())):
        engine = engine_cls(net, ladder=ladder_cls((1, 8)), max_wait_ms=1.0)
        try:
            assert engine.warmup(np.zeros((4,), np.float32)) == 2
            stats.append(engine.stats())
            guard = engine_cls(net, ladder=ladder_cls((1, 8)),
                               max_programs=1, max_wait_ms=1.0)
            try:
                guard.predict_proba(np.zeros((1, 4), np.float32),
                                    timeout=60)
                with pytest.raises(RuntimeError,
                                   match="compile-count guard") as err:
                    guard.predict_proba(np.zeros((2, 4), np.float32),
                                        timeout=60)
                messages.append((str(err.value),
                                 watcher.total(prefix="classifier:")))
            finally:
                guard.stop()
        finally:
            engine.stop()
    for s in stats:
        assert s["compiles_total"] >= s["compiled_programs"] == 2
    (jmsg, _), (msg, observed) = messages
    assert f"compiles_total observed: {observed}); the bucket" in msg
    assert re.sub(r"\d+", "N", msg) == re.sub(r"\d+", "N", jmsg)


def test_guard_refusal_is_a_typed_400():
    _, tn = _iris_pair(1)
    engine = ServingEngine(tn, ladder=BucketLadder((1, 8)),
                           max_programs=1, max_wait_ms=1.0)
    try:
        engine.predict_proba(np.zeros((1, 4), np.float32), timeout=60)
        with pytest.raises(UnservableShapeError):
            engine.predict_proba(np.zeros((2, 4), np.float32), timeout=60)
    finally:
        engine.stop()


# ---------------------------------------------------------------------------
# the split sampler and the programs' host-free bodies


def _per_lane_sampler(logits, temperature, seeds, counts):
    """The eager sampler the split one replaced: argmax, then each
    sampling lane drawn on its own from its host Gumbel noise."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    lanes = np.nonzero(np.asarray(temperature) > 0)[0]
    if lanes.size:
        vocab = logits.shape[-1]
        noise = np.stack([tgen.gumbel_noise(int(seeds[i]), int(counts[i]),
                                            vocab) for i in lanes])
        idx = torch.as_tensor(lanes)
        temp = torch.as_tensor(np.maximum(np.asarray(temperature)[lanes],
                                          1e-6), dtype=torch.float32)
        scores = logits[idx] / temp[:, None] + torch.from_numpy(noise)
        out[idx] = scores.argmax(dim=-1)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_sampler_picks_the_per_lane_samplers_ids(dtype):
    rng = np.random.default_rng(5)
    for trial in range(20):
        b, v = 6, 97
        logits = torch.from_numpy(
            rng.normal(size=(b, v)).astype(np.float32) * 3).to(dtype)
        temp = np.where(rng.random(b) < 0.5, 0.0,
                        rng.uniform(0.05, 2.0, b)).astype(np.float32)
        temp[trial % b] = 1e-9 if trial % 2 else 0.0
        seeds = rng.integers(0, 2 ** 31 - 1, b).astype(np.int32)
        counts = rng.integers(0, 500, b).astype(np.int32)
        want = _per_lane_sampler(logits, temp, seeds, counts)
        got = tgen.sample_tokens(logits, temp, seeds, counts)
        assert got.tolist() == want.tolist()
        noise = tgen.sampling_noise(temp, seeds, counts, v)
        if not (temp > 0).any():
            assert noise is None
            continue
        staged = tgen.sample_from_noise(
            logits, torch.from_numpy(temp), torch.from_numpy(noise))
        assert staged.tolist() == want.tolist()


class _HostRead(AssertionError):
    pass


def _refuse(name):
    def method(self, *a, **kw):
        raise _HostRead(f"a program read a tensor back ({name})")
    return method


def _run_refusing_host_reads(programs):
    """Each program's body with the tensor methods that move a value to
    the host refused: a body that called one could not be captured into a
    CUDA graph on the card."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                     "__float__"):
            mp.setattr(torch.Tensor, name, _refuse(name))
        for program in programs:
            program.fn()


def _paged_inputs(b, mp, w, seed):
    rng = np.random.default_rng(seed)
    table = (1 + np.arange(b * mp, dtype=np.int32)).reshape(b, mp)
    pos = rng.integers(0, CFG.max_len - w, b).astype(np.int32)
    n_draft = np.array([0, 0, min(2, w - 1)], np.int32)
    n_feed = (n_draft + 1).astype(np.int32)
    tokens = rng.integers(0, CFG.vocab_size, (b, w)).astype(np.int32)
    temp = np.array([0.0, 0.9, 0.0], np.float32)
    return (table, pos, n_feed, n_draft, tokens, temp,
            np.array([1, 2, 3], np.int32), np.array([4, 5, 6], np.int32))


@pytest.mark.parametrize("key", ["paged_w1", "paged_w4_verify",
                                 "paged_w4_decode", "dense", "page_copy",
                                 "page_gather", "page_install"])
def test_program_bodies_read_nothing_back(key):
    """Every LM program's step body on the CPU, with the host reads
    refused: its inputs come from the host before it runs, its outputs
    are read after it (the same holds on the card, where the body is
    captured)."""
    params = _tparams()
    b, ps = 3, 8
    mp = tgen.pages_per_seq(CFG, ps)
    pages = 1 + b * mp
    cache = tgen.init_paged_cache(CFG, pages, ps, device="cpu")
    k, v = cache["k"], cache["v"]
    if key.startswith("paged"):
        w = 1 if key == "paged_w1" else 4
        step = tgen.make_spec_step(CFG, pages, ps, w,
                                   verify=key.endswith("verify"))
        args = (params, k, v, *_paged_inputs(b, mp, w, 0))
    elif key == "dense":
        step = tgen.make_slot_step(CFG)
        slot = tgen.init_slot_cache(CFG, b, device="cpu")
        args = (params, slot["k"], slot["v"], np.array([0, 5, 9], np.int32),
                np.array([1, 2, 3], np.int32),
                np.array([0, 0.5, 0], np.float32), np.arange(3), np.ones(3))
    elif key == "page_copy":
        step, args = tgen.make_page_copy(CFG, pages, ps), (k, v, 1, 2)
    elif key == "page_gather":
        step = tgen.make_page_gather(CFG, pages, ps)
        args = (k, v, np.arange(mp, dtype=np.int32))
    else:
        step = tgen.make_page_install(CFG, pages, ps)
        pk = torch.ones((CFG.n_layers, 2, ps, CFG.n_heads, CFG.head_dim))
        args = (k, v, pk, pk, np.arange(1, mp + 1, dtype=np.int32), 2)
    ref = step.eager(*[a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args])
    out = step(*args)
    for a, e in zip(out, ref):
        assert torch.equal(a, e)
    (program,) = step.programs
    assert program.key.startswith("lm:") and program.built
    _run_refusing_host_reads([program])


def test_bucket_program_body_reads_nothing_back():
    """The classifier programs' body (the char-LSTM's bucketed forward,
    masked for a length ladder and not): no host read."""
    net = TNet(char_lstm(vocab_size=11, hidden=16), device="cpu").init()
    ladder = BucketLadder((4,))
    eye = np.eye(11, dtype=np.float32)
    x = eye[np.random.default_rng(0).integers(0, 11, (3, 6))]
    for mask in (None, np.ones((3, 6), np.float32)):
        want = net.output(ladder.pad_rows(x)[0], None if mask is None
                          else ladder.pad_rows(mask)[0]).float().numpy()
        got = net.output_bucketed(x, mask=mask, ladder=ladder)
        np.testing.assert_array_equal(got, want[:3])
    programs = [e[1] for e in net._bucket_programs._programs.values()]
    assert len(programs) == 2 == net.forward_program_count()
    _run_refusing_host_reads(programs)
