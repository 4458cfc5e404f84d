"""PyTorch port: the continuous paged-KV LM server and its HTTP front
(`deeplearning4j_tpu_torch.serving`, `deeplearning4j_tpu_torch.ui.server`).

The port's `ContinuousLMServer(device="cpu")` is held against the JAX
package's `generate()`: greedy ids must match for mid-flight joins,
shared-prefix reuse with copy-on-write, chunk widths 1 and 4 and page
sizes 4 and 5.  A divergence is accepted only at a near-tie, where the
JAX checker's top-2 logit gap at the diverging position is < 1e-4.
The same weights reach both packages as numpy arrays.
"""

import dataclasses
import functools
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.serving import paged as jpaged
from deeplearning4j_tpu_torch.parallel import generation as tgen
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import (
    ContinuousLMServer,
    DeadlineExceededError,
    PageLeakError,
    PagePool,
    RadixPrefixCache,
    ServingMetrics,
    ServingOverloadError,
    ServingUnavailableError,
    check_admission,
)
from deeplearning4j_tpu_torch.ui.server import UiServer
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

NEAR_TIE = 1e-4

JCFG = jt.TransformerConfig(vocab_size=256, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_len=40,
                            attn_bias=True, tie_embeddings=True)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(CFG, seed=0)


@functools.lru_cache(maxsize=1)
def _jax_params():
    import jax

    return jax.tree_util.tree_map(jnp.asarray, _tree())


def _params():
    return tt.params_from_numpy(_tree(), device="cpu")


@functools.lru_cache(maxsize=64)
def _jax_generate(prompt: tuple, max_new: int) -> list:
    out = jgen.generate(JCFG, _jax_params(), np.asarray([prompt], np.int32),
                        max_new)
    return np.asarray(out)[0].tolist()


def _assert_greedy_match(got, prompt, max_new):
    want = _jax_generate(tuple(prompt), max_new)
    if got == want:
        return
    p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    assert p >= len(prompt), "the prompt was not echoed"
    logits = np.asarray(jt.apply(JCFG, _jax_params(),
                                 jnp.asarray([want[:p]], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    gap = float(top2[1] - top2[0])
    assert gap < NEAR_TIE, (f"greedy ids diverge from JAX generate() at "
                            f"position {p} with top-2 gap {gap}")


def _prompts():
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, 256, 12).tolist()
    other = rng.integers(0, 256, 10).tolist()
    return [prefix + other[:1],            # 13: shares 12 tokens
            prefix + other[1:6],           # 17
            rng.integers(0, 256, 3).tolist(),   # short: below one page
            prefix[:9] + other[6:10],      # diverges mid-page: CoW
            prefix + other,                # 22
            prefix + other[:1]]            # identical to the first


def _serve_all(srv, prompts, max_new, stagger=0.01, **kw):
    out = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            out[i] = srv.generate(prompts[i], max_new, timeout=120, **kw)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
        time.sleep(stagger)
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("page_size,chunk", [(4, 1), (4, 4), (5, 1),
                                             (5, 4)])
def test_greedy_ids_match_jax_generate(page_size, chunk):
    """Mid-flight joins (6 requests on 3 slots), shared prefixes reused
    through the radix cache, a mid-page divergence served copy-on-write,
    an identical prompt, and a prompt shorter than a page."""
    srv = ContinuousLMServer(CFG, _params(), slots=3, page_size=page_size,
                             prefill_chunk=chunk, device="cpu")
    try:
        prompts = _prompts()
        outs = _serve_all(srv, prompts, 8)
        stats = srv.stats()
    finally:
        srv.stop()
    for prompt, got in zip(prompts, outs):
        _assert_greedy_match(got, prompt, 8)
    assert stats["prefix_hits"] >= 1
    assert stats["requests"] == len(prompts)
    assert srv.page_ledger()["balanced"]


def test_sampled_lane_is_independent_of_co_travellers():
    prompt = _prompts()[1]
    srv = ContinuousLMServer(CFG, _params(), slots=4, page_size=4,
                             prefill_chunk=4, device="cpu")
    try:
        alone = srv.generate(prompt, 10, temperature=0.9, seed=7)
        others = _prompts()[:3] + [prompt]
        together = _serve_all(srv, others, 10, stagger=0.0,
                              temperature=0.9, seed=7)[-1]
        mixed = []
        t = threading.Thread(target=lambda: mixed.append(
            srv.generate(_prompts()[4], 10, temperature=0.0)))
        t.start()
        again = srv.generate(prompt, 10, temperature=0.9, seed=7)
        t.join(timeout=60)
        other_seed = srv.generate(prompt, 10, temperature=0.9, seed=8)
    finally:
        srv.stop()
    assert alone == together == again
    assert other_seed != alone
    assert all(0 <= tok < 256 for tok in alone)


def test_gumbel_noise_is_keyed_on_seed_and_count():
    a = tgen.gumbel_noise(3, 5, 64)
    np.testing.assert_array_equal(a, tgen.gumbel_noise(3, 5, 64))
    assert not np.array_equal(a, tgen.gumbel_noise(3, 6, 64))
    assert not np.array_equal(a, tgen.gumbel_noise(4, 5, 64))
    logits = torch.zeros(2, 64)
    logits[:, 9] = 50.0
    out = tgen.sample_tokens(logits, np.array([0.0, 1.0], np.float32),
                             np.array([0, 1], np.int32),
                             np.array([0, 0], np.int32))
    assert out.tolist() == [9, 9]      # a dominant logit wins either way


# ---------------------------------------------------------------------------
# pages: the allocator and the radix cache


def _pool_alloc_all_or_nothing():
    pool = PagePool(5, 4)
    assert pool.usable == 4 and pool.free == 4
    assert pool.alloc(5) is None and pool.free == 4
    got = pool.alloc(3)
    assert len(got) == 3 and 0 not in got and pool.in_use == 3


def _pool_refcounts_return_pages():
    pool = PagePool(4, 2)
    pages = pool.alloc(2)
    pool.retain(pages[:1])
    pool.release(pages)
    assert pool.free == 2 and pool.refcount(pages[0]) == 1
    pool.release(pages[:1])
    assert pool.free == 3 and pool.check_ledger()["balanced"]


def _pool_double_release_raises():
    pool = PagePool(3, 2)
    (p,) = pool.alloc(1)
    pool.release([p])
    with pytest.raises(PageLeakError):
        pool.release([p])
    with pytest.raises(PageLeakError):
        pool.retain([0])               # the null page is outside the economy


def _pool_rejects_bad_sizes():
    with pytest.raises(ValueError):
        PagePool(1, 4)
    with pytest.raises(ValueError):
        PagePool(4, 0)


def _radix_full_and_partial_match():
    pool = PagePool(8, 2)
    tree = RadixPrefixCache(pool)
    pages = pool.alloc(3)
    assert tree.insert([1, 2, 3, 4, 5, 6], pages) == 3
    full, partial = tree.match([1, 2, 3, 4, 5, 9, 7])
    assert full == pages[:2] and partial == (pages[2], 1)
    assert pool.refcount(pages[0]) == 3   # lane + tree + this match


def _radix_evicts_lru_leaves_only_when_unshared():
    pool = PagePool(4, 2)
    tree = RadixPrefixCache(pool)
    a = pool.alloc(1)
    tree.insert([1, 2], a)
    b = pool.alloc(1)
    tree.insert([3, 4], b)
    pool.release(a + b)                   # lanes done: tree-only pages
    held = tree.match([3, 4, 5])[0]       # a lane pins page b again
    assert held == b and tree.evictable() == 1
    assert tree.evict(pool.free + 2) == 1 and pool.free == 2
    assert tree.nodes == 1
    pool.release(held)
    assert tree.clear() == 1 and pool.free == 3


def _radix_insert_takes_full_pages_only():
    pool = PagePool(4, 3)
    tree = RadixPrefixCache(pool)
    with pytest.raises(ValueError):
        tree.insert([1, 2], pool.alloc(1))


PAGE_UNITS = {f.__name__.lstrip("_"): f for f in (
    _pool_alloc_all_or_nothing, _pool_refcounts_return_pages,
    _pool_double_release_raises, _pool_rejects_bad_sizes,
    _radix_full_and_partial_match,
    _radix_evicts_lru_leaves_only_when_unshared,
    _radix_insert_takes_full_pages_only)}


@pytest.mark.parametrize("name", sorted(PAGE_UNITS))
def test_page_units(name):
    PAGE_UNITS[name]()


@pytest.mark.parametrize("seed", range(4))
def test_pages_behave_like_the_jax_package_copy(seed):
    """The same random sequence of allocator / radix operations through
    the port's copy and the JAX package's module gives the same answers
    and the same ledger at every step."""
    rng = np.random.default_rng(seed)
    pools = [PagePool(12, 3), jpaged.PagePool(12, 3)]
    trees = [RadixPrefixCache(pools[0]), jpaged.RadixPrefixCache(pools[1])]
    held = [[], []]
    vocab = [1, 2, 3]
    for _ in range(60):
        op = rng.integers(0, 4)
        toks = rng.choice(vocab, int(rng.integers(1, 10))).tolist()
        n = int(rng.integers(0, 4))
        outs = []
        for i in range(2):
            if op == 0:
                got = pools[i].alloc(n)
                if got:
                    held[i].append(got)
                outs.append(got)
            elif op == 1 and held[i]:
                pools[i].release(held[i].pop(0))
                outs.append("released")
            elif op == 2:
                full, part = trees[i].match(toks)
                held[i].append(full + ([part[0]] if part else []))
                outs.append((full, part))
            elif op == 3:
                outs.append(trees[i].evict(int(rng.integers(0, 12))))
            outs.append((pools[i].free, trees[i].nodes,
                         pools[i].check_ledger()))
        assert outs[:len(outs) // 2] == outs[len(outs) // 2:]


def test_page_ledger_balances_after_a_storm():
    """24 requests with shared prefixes on a tight pool (16 pages),
    some abandoned by a client timeout and some shed by their deadline:
    afterwards every page is either free or held by the radix tree."""
    srv = ContinuousLMServer(CFG, _params(), slots=3, page_size=4,
                             pages=16, prefill_chunk=4, device="cpu")
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 256, 8).tolist()
    outcomes = []

    def client(i):
        prompt = prefix[:int(rng.integers(1, 9))] + rng.integers(
            0, 256, int(rng.integers(1, 9))).tolist()
        kw = {}
        if i % 6 == 1:
            kw["timeout"] = 0.001
        elif i % 6 == 2:
            kw["deadline_s"] = 0.001
        try:
            srv.generate(prompt, int(rng.integers(1, 12)), **kw)
            outcomes.append("ok")
        except DeadlineExceededError:
            outcomes.append("deadline")

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = srv.stats()
            if st["active_slots"] == 0 and st["queue_depth"] == 0:
                break
            time.sleep(0.01)
        ledger = srv.page_ledger()
        stats = srv.stats()
    finally:
        srv.stop()
    assert len(outcomes) == 24 and "ok" in outcomes
    assert ledger["balanced"], ledger
    assert ledger["in_use"] == ledger["radix_nodes"], ledger
    assert stats["requests"] == outcomes.count("ok")
    assert srv.page_ledger()["balanced"]


def test_failed_dispatch_fails_in_flight_and_the_pool_recovers():
    """A dispatch that raises fails the requests it carried; the worker
    survives, the page state and the pool are rebuilt, and the next
    request decodes exactly as before."""
    srv = ContinuousLMServer(CFG, _params(), slots=2, page_size=4,
                             prefill_chunk=4, device="cpu")
    prompt = _prompts()[0]
    try:
        want = srv.generate(prompt, 5)
        real = srv._step
        calls = {"n": 0}

        def flaky(*args):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected dispatch fault")
            return real(*args)

        srv._step = flaky
        with pytest.raises(RuntimeError, match="injected"):
            srv.generate(prompt, 5)
        ledger = srv.page_ledger()
        assert ledger["balanced"] and ledger["in_use"] == 0
        assert srv.generate(prompt, 5) == want
    finally:
        srv.stop()


def test_pool_holds_slots_times_pages_per_seq_plus_the_null_page():
    srv = ContinuousLMServer(CFG, _params(), slots=3, page_size=5,
                             device="cpu")
    try:
        assert srv.kv_pages == 3 * tgen.pages_per_seq(CFG, 5) == 24
        srv.generate([1, 2, 3], 2)
        assert srv._pool.pages == srv.kv_pages + 1
        assert srv._cache[0].shape[1] == srv.kv_pages + 1
    finally:
        srv.stop()


def test_wide_program_runs_only_for_a_full_chunk_of_prompt():
    srv = ContinuousLMServer(CFG, _params(), slots=2, page_size=4,
                             prefill_chunk=4, device="cpu")
    try:
        srv.generate([5, 6, 7], 3)                 # 3 < chunk: narrow only
        assert set(srv.stats()["dispatch_widths"]) == {"1"}
        srv.generate(list(range(20, 29)), 2)       # 9 tokens: 4 + 4 + 1
        widths = srv.stats()["dispatch_widths"]
    finally:
        srv.stop()
    assert widths["4"] == 2


# ---------------------------------------------------------------------------
# request validation and admission

BAD_REQUESTS = {
    "oversize": ([1] * 35, 10, "max_len"),
    "empty_prompt": ([], 4, "at least one token"),
    "out_of_vocab": ([1, 256], 4, "outside vocab"),
    "no_budget": ([1, 2], 0, "max_new_tokens"),
}


@pytest.mark.parametrize("name", sorted(BAD_REQUESTS))
def test_bad_requests_raise_value_error(name):
    prompt, max_new, match = BAD_REQUESTS[name]
    srv = ContinuousLMServer(CFG, _params(), slots=1, device="cpu")
    with pytest.raises(ValueError, match=match):
        srv.generate(prompt, max_new)
    assert srv._thread is None          # refused before any worker started


def test_request_larger_than_the_pool_is_a_value_error():
    srv = ContinuousLMServer(CFG, _params(), slots=1, page_size=4, pages=3,
                             device="cpu")
    with pytest.raises(ValueError, match="KV pages"):
        srv.generate([1] * 10, 5)


ADMISSION = {
    "draining": (False, 0, None, ServingUnavailableError),
    "queue_full": (True, 2, 2, ServingOverloadError),
    "admitted": (True, 1, 2, None),
}


@pytest.mark.parametrize("name", sorted(ADMISSION))
def test_check_admission(name):
    accepting, depth, bound, exc = ADMISSION[name]
    metrics = ServingMetrics()
    kw = dict(accepting=accepting, queue_depth=depth,
              max_queue_depth=bound, metrics=metrics,
              retry_after_s=lambda: 2.5)
    if exc is None:
        check_admission(**kw)
        assert metrics.snapshot()["rejected"] == 0
    else:
        with pytest.raises(exc) as info:
            check_admission(**kw)
        assert metrics.snapshot()["rejected"] == 1
        if exc is ServingOverloadError:
            assert info.value.retry_after_s == 2.5


def test_drain_stops_admission_and_finishes_work():
    srv = ContinuousLMServer(CFG, _params(), slots=2, device="cpu")
    out = srv.generate([1, 2, 3], 2)
    assert len(out) == 5 and srv.ready()
    assert srv.drain(grace_s=5.0)
    assert not srv.ready()
    with pytest.raises(ServingUnavailableError):
        srv.generate([1, 2, 3], 2)


# ---------------------------------------------------------------------------
# the HTTP front


def _post(url, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def ui():
    srv = UiServer(port=0).serve_lm(CFG, _params(), slots=2, page_size=4,
                                    prefill_chunk=4, device="cpu").start()
    yield srv
    srv.stop()


def test_http_generate_matches_in_process_generate(ui):
    prompt = _prompts()[1]
    code, body = _post(ui.url + "/lm/generate",
                       {"prompt_ids": prompt, "max_new_tokens": 6})
    assert code == 200
    assert body["ids"] == ui.state.lm_server.generate(prompt, 6)
    _assert_greedy_match(body["ids"], prompt, 6)
    code, body = _post(ui.url + "/lm/generate",
                       {"prompt_ids": prompt, "max_new_tokens": 6,
                        "temperature": 0.7, "seed": 3})
    assert code == 200 and body["ids"][:len(prompt)] == prompt
    code, stats = _get(ui.url + "/serving/stats")
    assert code == 200 and stats["lm"]["requests"] == 3
    assert stats["lm"]["kv"]["mode"] == "paged"


HTTP_400 = {
    "oversize": ({"prompt_ids": [1] * 35, "max_new_tokens": 10}, "max_len"),
    "top_k_negative": ({"prompt_ids": [1, 2], "top_k": -1},
                       "top_k must be >= 0"),
    "top_p_zero": ({"prompt_ids": [1, 2], "top_p": 0}, "top_p must be in"),
    "top_p_above_one": ({"prompt_ids": [1, 2], "top_p": 1.5},
                        "top_p must be in"),
    "speculate_not_speculating": ({"prompt_ids": [1, 2],
                                   "speculate": True}, "speculation off"),
    "beam_oversize": ({"prompt_ids": [1] * 35, "max_new_tokens": 10,
                       "beam_size": 2}, "max_len"),
    "no_prompt": ({"max_new_tokens": 3}, "prompt_ids"),
    "bad_deadline": ({"prompt_ids": [1], "deadline_ms": -5}, "deadline"),
}


@pytest.mark.parametrize("name", sorted(HTTP_400))
def test_http_bad_requests_are_400(ui, name):
    payload, match = HTTP_400[name]
    code, body = _post(ui.url + "/lm/generate", payload)
    assert code == 400 and match in body["error"]
    if name == "oversize":
        assert body["max_len"] == CFG.max_len


# the three requests the first slice refused ("not yet ported"), now
# served by the whole-sequence functions
HTTP_WHOLE_SEQUENCE = {
    "top_k": {"top_k": 5, "temperature": 0.9, "seed": 3},
    "top_p": {"top_p": 0.9, "temperature": 0.7, "seed": 4},
    "beam": {"beam_size": 3},
}


@pytest.mark.parametrize("name", sorted(HTTP_WHOLE_SEQUENCE))
def test_http_whole_sequence_requests(ui, name):
    knobs = HTTP_WHOLE_SEQUENCE[name]
    prompt = _prompts()[1]
    code, body = _post(ui.url + "/lm/generate",
                       {"prompt_ids": prompt, "max_new_tokens": 6, **knobs})
    assert code == 200, body
    if name == "beam":
        toks, score = tgen.beam_search(CFG, _params(), [prompt], 6,
                                       beam_size=3, device="cpu")
        assert body["score"] == pytest.approx(float(score[0]), abs=1e-6)
    else:
        toks = tgen.generate(CFG, _params(), [prompt], 6,
                             temperature=knobs["temperature"],
                             seed=knobs["seed"], top_k=knobs.get("top_k", 0),
                             top_p=knobs.get("top_p", 1.0), device="cpu")
        assert "score" not in body
    assert body["ids"] == toks[0].tolist()
    assert body["ids"][:len(prompt)] == prompt
    # the pool served none of them
    assert ui.state.lm_server.stats()["requests"] == 0


def test_http_speculate_on_a_dense_pool_is_400_and_on_a_speculating_pool_200():
    dense = UiServer(port=0).serve_lm(CFG, _params(), slots=1, kv="dense",
                                      device="cpu").start()
    spec = UiServer(port=0).serve_lm(CFG, _params(), slots=1, page_size=4,
                                     prefill_chunk=4, speculate="ngram",
                                     draft_len=3, device="cpu").start()
    try:
        payload = {"prompt_ids": [1, 2, 1, 2, 1], "max_new_tokens": 8,
                   "speculate": True}
        code, body = _post(dense.url + "/lm/generate", payload)
        assert code == 400 and "dense" in body["error"]
        code, body = _post(spec.url + "/lm/generate", payload)
        assert code == 200
        _assert_greedy_match(body["ids"], payload["prompt_ids"], 8)
        code, stats = _get(spec.url + "/serving/stats")
        assert stats["lm"]["speculate"]["mode"] == "ngram"
        code, stats = _get(dense.url + "/serving/stats")
        assert stats["lm"]["kv"] == {"mode": "dense"}
    finally:
        dense.stop()
        spec.stop()


# ---------------------------------------------------------------------------
# the CLI: lm -generate / -beam over a model trained in the test, and the
# serve flags of the dense and speculating pools


@pytest.fixture(scope="module")
def trained_lm(tmp_path_factory):
    from deeplearning4j_tpu_torch import cli as tcli

    out = tmp_path_factory.mktemp("lm")
    corpus = out / "corpus.txt"
    corpus.write_bytes(b"the port serves the kernel. " * 40)
    rc = tcli.main(["lm", "-input", str(corpus), "-output", str(out / "m"),
                    "-seq", "32", "-batch", "4", "-d-model", "32",
                    "-layers", "2", "-heads", "4", "-device", "cpu"])
    assert rc == 0
    return out / "m"


LM_GENERATE = {
    "greedy": (["-temperature", "0"], None),
    "sampled": (["-temperature", "0.9", "-top-k", "5", "-top-p", "0.9",
                 "-gen-seed", "7"], None),
    "beam": (["-beam", "2"], "beam[2] log-prob"),
}


@pytest.mark.parametrize("name", sorted(LM_GENERATE))
def test_cli_lm_generate_and_beam(trained_lm, capsys, name):
    from deeplearning4j_tpu_torch import cli as tcli

    flags, stderr = LM_GENERATE[name]
    rc = tcli.main(["lm", "-output", str(trained_lm), "-generate", "the ",
                    "-max-new", "12", *flags, "-device", "cpu"])
    assert rc == 0
    out = capsys.readouterr()
    text = out.out.splitlines()[-1]
    cfg, params = tcli.load_saved_lm(trained_lm, device="cpu")
    prompt = np.frombuffer(b"the ", np.uint8)[None, :]
    if name == "beam":
        toks, score = tgen.beam_search(cfg, params, prompt, 12, beam_size=2,
                                       device="cpu")
        assert f"{float(score[0]):.3f}" in out.err and stderr in out.err
    else:
        kw = ({} if name == "greedy" else
              dict(temperature=0.9, seed=7, top_k=5, top_p=0.9))
        toks = tgen.generate(cfg, params, prompt, 12, device="cpu", **kw)
    assert text == bytes(toks[0].numpy().astype(np.uint8)).decode(
        errors="replace")


def test_cli_lm_generate_refuses_a_prompt_past_the_context(trained_lm):
    from deeplearning4j_tpu_torch import cli as tcli

    with pytest.raises(SystemExit, match="exceeds the model's context"):
        tcli.main(["lm", "-output", str(trained_lm), "-generate", "x" * 30,
                   "-max-new", "8", "-device", "cpu"])


@pytest.mark.parametrize("flags,note", [
    (["-lm-kv", "dense"], "dense KV: 2 x 32 positions"),
    (["-lm-speculate", "ngram", "-lm-draft-len", "3"],
     "speculate ngram (draft_len 3)"),
    (["-lm-speculate", "model"], "speculate model (draft_len 4)"),
])
def test_cli_serve_pool_flags(trained_lm, capsys, flags, note):
    from deeplearning4j_tpu_torch import cli as tcli

    rc = tcli.main(["serve", "-lm", str(trained_lm), "-port", "0",
                    "-lm-slots", "2", "-serve-seconds", "0.01", *flags,
                    "-device", "cpu"])
    assert rc == 0 and note in capsys.readouterr().out


def test_cli_serve_refuses_speculation_on_the_dense_pool(trained_lm):
    from deeplearning4j_tpu_torch import cli as tcli

    with pytest.raises(SystemExit, match="requires -lm-kv paged"):
        tcli.main(["serve", "-lm", str(trained_lm), "-lm-kv", "dense",
                   "-lm-speculate", "ngram", "-device", "cpu"])


def test_http_health_readiness_and_drain(ui):
    assert _get(ui.url + "/healthz") == (200, {"ok": True})
    assert _get(ui.url + "/readyz")[0] == 200
    assert _get(ui.url + "/nope")[0] == 404
    assert _post(ui.url + "/lm/generate", None, raw=b"{bad")[0] == 400
    ui.begin_drain()
    code, body = _get(ui.url + "/readyz")
    assert code == 503 and "draining" in body["reasons"]
    code, body = _post(ui.url + "/lm/generate", {"prompt_ids": [1, 2]})
    assert code == 503 and body["retry_after_s"] >= 1
