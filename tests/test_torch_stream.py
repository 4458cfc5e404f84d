"""PyTorch port: streaming (`ContinuousLMServer.generate_stream` and the
front's SSE leg) against the JAX package's.

- f32 greedy: the streamed ids equal `generate`'s, the JAX package's
  `generate_stream`'s and its `generate`, with and without n-gram
  speculation (a speculative round's multi-token commit is yielded one
  token at a time).
- Admission errors raise when the stream is opened, before any token.
- Closing the iterator abandons the request: its slot and pages free.
- A stream that times out is a typed `DeadlineExceededError`.
- A preempted streaming lane resumes without yielding a token twice,
  whether its swap restores or was lost (recompute from the prompt).
- Over HTTP both fronts answer the same SSE bytes, with the request's
  ``X-Request-Id`` echoed.

The victim of the preemption case is held at a gate on the pool's
dispatch entry (`test_torch_pressure._Gate`) until the interactive
arrival is queued.
"""

import dataclasses
import functools
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.serving import lm as jlm
from deeplearning4j_tpu.ui.server import UiServer as JaxUiServer
from deeplearning4j_tpu_torch.obs.trace import TraceRecorder
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import lm as tlm
from deeplearning4j_tpu_torch.serving.resilience import (
    DeadlineExceededError,
    ServingUnavailableError,
)
from deeplearning4j_tpu_torch.ui.server import UiServer
from test_torch_pressure import _Gate, _mid_decode, _wait_queued
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

JCFG = jt.TransformerConfig(vocab_size=50, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=48)
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


def _prompt(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 50, (n,)).tolist()


def _wait_idle(srv, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        with srv._cond:
            if not any(s.active for s in srv._slots) and not srv._queue:
                return True
        time.sleep(0.005)
    return False


@pytest.mark.parametrize("speculate", ["off", "ngram"])
def test_streamed_ids_equal_generate_and_jax(speculate):
    kw = dict(slots=2, page_size=4, prefill_chunk=4)
    if speculate != "off":
        kw.update(speculate=speculate, draft_len=3)
    port = tlm.ContinuousLMServer(CFG, _tree(), device="cpu", **kw)
    ref = jlm.ContinuousLMServer(JCFG, _jparams(), **kw)
    try:
        for seed, n, new in ((20, 4, 10), (21, 9, 7), (22, 1, 5)):
            prompt = _prompt(seed, n) * (3 if speculate != "off" else 1)
            toks = list(port.generate_stream(prompt, new, timeout=120))
            jtoks = list(ref.generate_stream(prompt, new, timeout=120))
            assert len(toks) == new
            assert toks == jtoks
            assert prompt + toks == _want(tuple(prompt), new)
            assert port.generate(prompt, new, timeout=120) == prompt + toks
        if speculate != "off":
            # several tokens committed in one round, each yielded alone
            assert port.stats()["spec_accepted"] > 0
    finally:
        port.stop()
        ref.stop()


def test_admission_errors_raise_before_the_first_token():
    srv = tlm.ContinuousLMServer(CFG, _tree(), slots=1, page_size=4,
                                 device="cpu", tenants={"a": {}})
    try:
        with pytest.raises(ValueError, match="unknown tenant"):
            srv.generate_stream([1, 2], 2, tenant="nobody")
        with pytest.raises(ValueError, match="max_len"):
            srv.generate_stream([1] * 40, 20)
        assert srv._thread is None           # nothing reached the worker
        srv.begin_drain()
        with pytest.raises(ServingUnavailableError):
            srv.generate_stream([1, 2], 2)
    finally:
        srv.stop()


def test_closing_the_stream_frees_its_slot_and_pages():
    srv = tlm.ContinuousLMServer(CFG, _tree(), slots=2, page_size=4,
                                 device="cpu")
    try:
        gen = srv.generate_stream(_prompt(21, 9), 30, timeout=120)
        assert isinstance(next(gen), int)
        gen.close()                          # the client goes away
        assert _wait_idle(srv)
        ledger = srv.page_ledger()
        assert ledger["balanced"]
        assert srv.stats()["shed"] == 1
        # the pool serves on
        p = _prompt(22, 5)
        assert srv.generate(p, 4, timeout=120) == _want(tuple(p), 4)
    finally:
        srv.stop()


def test_a_stream_timeout_is_typed_and_traced():
    tracer = TraceRecorder()
    srv = tlm.ContinuousLMServer(CFG, _tree(), slots=1, page_size=4,
                                 device="cpu", tracer=tracer)
    srv.warmup()
    gate = _Gate(srv, lambda: True)          # hold the first dispatch
    try:
        gen = srv.generate_stream([1, 2, 3], 4, timeout=0.2,
                                  request_id="slow-1")
        with pytest.raises(DeadlineExceededError):
            list(gen)
        gate.release.set()
        assert _wait_idle(srv)
        assert srv.page_ledger()["balanced"]
        (tr,) = tracer.find("slow-1")
        assert tr["status"] == "timeout"
        assert tr["spans"][0]["name"] == "queue_wait"
    finally:
        gate.release.set()
        srv.stop()


@pytest.mark.parametrize("swap_bytes", [64 << 20, 1])
def test_a_preempted_stream_resumes_without_repeats(swap_bytes):
    """The best_effort victim streams; an interactive arrival on a dry
    pool preempts it mid-decode (swap restored, or lost and recomputed
    from the prompt); the stream yields every token exactly once."""
    srv = tlm.ContinuousLMServer(CFG, _tree(), slots=2, page_size=4,
                                 pages=8, prefill_chunk=4, preempt=True,
                                 swap_bytes=swap_bytes, device="cpu")
    srv.warmup()
    gate = _Gate(srv, _mid_decode(srv, committed=2))
    got = {}
    try:
        gen = srv.generate_stream([1, 2, 3], 28, priority="best_effort",
                                  timeout=120)
        t = threading.Thread(target=lambda: got.__setitem__(
            "victim", list(gen)))
        t.start()
        assert gate.blocked.wait(60)
        ia = threading.Thread(target=lambda: got.__setitem__(
            "ia", srv.generate([4, 5, 6, 7], 8, priority="interactive",
                               timeout=120)))
        ia.start()
        _wait_queued(srv, 1)
        gate.release.set()
        for th in (t, ia):
            th.join(timeout=120)
            assert not th.is_alive()
        assert [1, 2, 3] + got["victim"] == _want((1, 2, 3), 28)
        assert got["ia"] == _want((4, 5, 6, 7), 8)
        st = srv.stats()
        assert st["preemptions"] >= 1
        if swap_bytes == 1:
            assert st["swap"]["evicted"] >= 1
        assert srv.page_ledger()["balanced"]
    finally:
        gate.release.set()
        srv.stop()


@pytest.fixture(scope="module")
def fronts():
    knobs = dict(slots=2, page_size=4, prefill_chunk=4, speculate="ngram",
                 draft_len=3)
    jax_ui = JaxUiServer(port=0)
    jax_ui.serve_lm(JCFG, _jparams(), **knobs)
    jax_ui.start()
    port_ui = UiServer(port=0).serve_lm(
        CFG, tt.params_from_numpy(_tree(), device="cpu"), device="cpu",
        **knobs).start()
    yield jax_ui, port_ui
    port_ui.stop()
    jax_ui.stop()


def _sse(url, payload, rid):
    req = urllib.request.Request(
        url + "/lm/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    with urllib.request.urlopen(req, timeout=120) as r:
        return (r.status, r.headers["Content-Type"],
                r.headers["X-Request-Id"], r.read())


@pytest.mark.parametrize("seed", [30, 31])
def test_sse_bytes_are_equal_on_both_fronts(fronts, seed):
    prompt = _prompt(seed, 6) * 2
    payload = {"prompt_ids": prompt, "max_new_tokens": 9, "stream": True,
               "session_id": "s1"}
    (jcode, jtype, jrid, jbody), (code, ctype, rid, body) = [
        _sse(ui.url, payload, f"rid-{seed}") for ui in fronts]
    assert jcode == code == 200 and jtype == ctype == "text/event-stream"
    assert jrid == rid == f"rid-{seed}"
    assert body == jbody
    events = [e for e in body.decode().split("\n\n") if e]
    toks = [json.loads(e[len("data: "):]) for e in events[:-1]]
    assert [t["index"] for t in toks] == list(range(9))
    done = json.loads(events[-1].split("data: ", 1)[1])["ids"]
    assert done == prompt + [t["token"] for t in toks]
    assert done == _want(tuple(prompt), 9)
    (tr,) = fronts[1].tracer.find(f"rid-{seed}")
    assert tr["status"] == "ok"
