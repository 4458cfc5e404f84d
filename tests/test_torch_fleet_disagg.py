"""PyTorch port: the disaggregated LM fleet (prefill / decode roles,
page shipping, the recompute ladder, SSE relay) against the JAX
package's, on one 2-layer, d_model-64 float32 LM whose weights reach both
packages as numpy arrays:

- long prompts prefill on the prefill worker and ship their pages to a
  decode worker, short ones decode directly; greedy ids equal to JAX's
  `generate` and to the JAX fleet's ids for the same script;
- mixed fleets: a port prefill worker ships to a JAX decode worker and a
  JAX prefill worker to a port decode worker — the frame leaves one
  package and is admitted by the other byte for byte (no fallback);
- the failure ladder: a prefill worker killed mid-storm costs
  resubmissions, never a failed request; a frame corrupted on the wire
  is refused (422) and recomputed; page ledgers balanced;
- the `FleetServer` SSE relay: the same bytes as JAX's front.
"""

import dataclasses
import functools
import json
import threading
import urllib.request
from concurrent import futures

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import fleet as tfleet
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

JCFG = jt.TransformerConfig(vocab_size=64, d_model=64, n_heads=4,
                            n_layers=2, d_ff=128, max_len=64)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))
PS, CHUNK, SLOTS, MIN_PROMPT = 8, 4, 2, 16


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(CFG, seed=0)


@functools.lru_cache(maxsize=1)
def _lms():
    return ((JCFG, jax.tree_util.tree_map(jnp.asarray, _tree())),
            (CFG, tt.params_from_numpy(_tree(), device="cpu")))


@functools.lru_cache(maxsize=64)
def _want(prompt: tuple, new: int) -> list:
    out = jgen.generate(JCFG, _lms()[0][1], np.asarray([prompt], np.int32),
                        new)
    return np.asarray(out)[0].tolist()


def _replica(pkg, name, role):
    knobs = dict(lm_slots=SLOTS, lm_page_size=PS, lm_prefill_chunk=CHUNK,
                 role=role)
    if pkg == "jax":
        return jfleet.spawn_local_replica(name, lm=_lms()[0], **knobs)
    return tfleet.spawn_local_replica(name, lm=_lms()[1], device="cpu",
                                      **knobs)


def _as_port_replica(replica):
    """A JAX-hosted replica under the port's router (the router talks
    HTTP; only the URL, the server handle and the role cross)."""
    return tfleet.Replica(replica.name, replica.url, server=replica.server,
                          role=replica.role)


def _router(mod, members):
    router = mod.FleetRouter(disagg_min_prompt=MIN_PROMPT,
                             request_timeout_s=120)
    for r in members:
        router.attach(r)
    return router


def _prompts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (int(rng.integers(lo, hi)),)).tolist()
            for _ in range(n)]


def _balanced(router):
    for r in router.replicas():
        lm = r.server.state.lm_server
        if lm is not None and r.state == "active":
            assert lm.page_ledger()["balanced"], r.name


def test_ships_long_prompts_and_matches_jax_fleet():
    script = _prompts(1, 4, 18, 30) + _prompts(2, 2, 3, 8)
    answers, ledgers = {}, {}
    for pkg, mod in (("jax", jfleet), ("port", tfleet)):
        router = _router(mod, [_replica(pkg, "prefill-0", "prefill"),
                               _replica(pkg, "decode-0", "decode"),
                               _replica(pkg, "decode-1", "decode")])
        try:
            answers[pkg] = [router.generate(p, 8, timeout=120)
                            for p in script]
            assert router.ships == 4 and router.ship_fallbacks == 0
            assert router._role_requests["decode"] == 6
            stats = router.fleet_stats()
            assert stats["fleet"]["disagg"]["ships"] == 4
            # a shipped request is counted by its prefill worker and by
            # its decode worker: the ledger reads the same in both
            ledgers[pkg] = stats["ledger"]["aggregate"]
            if pkg == "port":
                _balanced(router)
        finally:
            router.stop()
    assert answers["port"] == answers["jax"]
    assert answers["port"] == [_want(tuple(p), 8) for p in script]
    assert ledgers["port"] == ledgers["jax"]
    assert ledgers["port"]["requests"] == 10


@pytest.mark.parametrize("prefill_pkg,decode_pkg", [("port", "jax"),
                                                    ("jax", "port")])
def test_frames_cross_packages_byte_for_byte(prefill_pkg, decode_pkg):
    pre = _replica(prefill_pkg, "prefill-0", "prefill")
    dec = _replica(decode_pkg, "decode-0", "decode")
    members = [_as_port_replica(r) if isinstance(r, jfleet.Replica) else r
               for r in (pre, dec)]
    router = _router(tfleet, members)
    sent, got = [], []
    real_http = router._http

    def recording(method, url, body=None, timeout=None, **kw):
        if url.endswith("/lm/admit_pages"):
            got.append(kw.get("raw_body"))
        status, payload = real_http(method, url, body=body,
                                    timeout=timeout, **kw)
        if url.endswith("/lm/prefill"):
            sent.append(payload)
        return status, payload

    router._http = recording
    try:
        for p in _prompts(3, 3, 18, 28):
            assert router.generate(p, 6, timeout=120) == _want(tuple(p), 6)
        assert router.ships == 3 and router.ship_fallbacks == 0
        assert len(sent) == len(got) == 3
        assert all(isinstance(b, bytes) and b == g
                   for b, g in zip(sent, got))
        ship = dec.server.state.lm_server.stats()["ship"]
        assert ship["in"] == 3
    finally:
        router.stop()


def test_dead_prefill_worker_and_corrupt_frame_never_fail():
    members = [_replica("port", "prefill-0", "prefill"),
               _replica("port", "prefill-1", "prefill"),
               _replica("port", "decode-0", "decode"),
               _replica("port", "decode-1", "decode")]
    router = _router(tfleet, members)
    prompts = _prompts(4, 10, 17, 26)
    failed, done = [], []
    lock = threading.Lock()

    def one(p):
        try:
            out = router.generate(p, 6, timeout=120)
        except Exception as e:  # noqa: BLE001 — the storm counts failures
            with lock:
                failed.append(repr(e))
            return
        with lock:
            done.append(out == _want(tuple(p), 6))
            kill = len(done) == 3
        if kill:
            members[0].kill()          # a prefill worker dies mid-storm

    try:
        with futures.ThreadPoolExecutor(4) as pool:
            list(pool.map(one, prompts))
        assert failed == [] and len(done) == len(prompts) and all(done)
        # a frame corrupted on the wire: refused typed, recomputed
        real_http = router._http

        def corrupting(method, url, body=None, timeout=None, **kw):
            status, payload = real_http(method, url, body=body,
                                        timeout=timeout, **kw)
            if url.endswith("/lm/prefill") and isinstance(payload, bytes):
                blob = bytearray(payload)
                blob[-7] ^= 0x10
                payload = bytes(blob)
            return status, payload

        router._http = corrupting
        fb0 = router.ship_fallbacks
        p = _prompts(5, 1, 20, 21)[0]
        assert router.generate(p, 6, timeout=120) == _want(tuple(p), 6)
        assert router.ship_fallbacks == fb0 + 1
        router._http = real_http
        _balanced(router)
    finally:
        router.stop()


def _sse(url, body):
    req = urllib.request.Request(
        url + "/lm/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "X-Request-Id": "sse-1"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        return r.read()


def test_fleet_front_relays_the_same_sse_bytes():
    prompt = _prompts(6, 1, 8, 9)[0]
    body = {"prompt_ids": prompt, "max_new_tokens": 6, "stream": True}
    raw = {}
    for pkg, mod in (("jax", jfleet), ("port", tfleet)):
        router = _router(mod, [_replica(pkg, "both-0", "both")])
        front = mod.FleetServer(router, port=0).start()
        try:
            raw[pkg] = _sse(front.url, body)
            # the non-streamed answer through the front: the same ids
            req = urllib.request.Request(
                front.url + "/lm/generate",
                data=json.dumps({**body, "stream": False}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert json.loads(r.read())["ids"] == _want(tuple(prompt),
                                                            6)
        finally:
            front.stop()
    assert raw["port"] == raw["jax"]
    done = next(e for e in raw["port"].decode().split("\n\n")
                if e.startswith("event: done"))
    assert json.loads(done.split("data: ", 1)[1])["ids"] == \
        _want(tuple(prompt), 6)
