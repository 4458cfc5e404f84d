"""PyTorch port: whole-sequence decoding and the dense slot pool
(`deeplearning4j_tpu_torch.parallel.generation`: `init_cache`,
`decode_step`, `_prefill`, `_filter_top_k`, `_filter_top_p`, `generate`,
`beam_search`, `slot_decode_step`, `make_slot_step`; and
`ContinuousLMServer(kv="dense")`).

The same numpy weights go through the JAX package and the port on the
CPU in float32.  Tolerances: logits within 1e-5 of the largest JAX logit
(relative); filters exact; greedy and beam ids exact (a greedy divergence
is accepted only at a near-tie, a JAX top-2 logit gap below 1e-4); beam
scores within 1e-4 absolute.  Sampled decoding cannot match threefry bit
for bit, so it is held by rule: top_k = 1 and a tiny top_p equal greedy,
every token lies in the filtered support, a seed repeats its ids, and the
first-token frequencies over 4000 independent rows stay within 5 standard
deviations of the filtered softmax.
"""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu_torch.parallel import generation as tgen
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import ContinuousLMServer
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

NEAR_TIE = 1e-4
JCFGS = {
    "tied_bias": jt.TransformerConfig(
        vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        max_len=64, attn_bias=True, tie_embeddings=True),
    "untied": jt.TransformerConfig(
        vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        max_len=64),
}
JCFG = JCFGS["tied_bias"]


def _cfg(name="tied_bias"):
    return tt.TransformerConfig(**dataclasses.asdict(JCFGS[name]))


CFG = _cfg()


@functools.lru_cache(maxsize=4)
def _tree(name="tied_bias"):
    return tt.numpy_params(_cfg(name), seed=0)


@functools.lru_cache(maxsize=4)
def _jparams(name="tied_bias"):
    return jax.tree_util.tree_map(jnp.asarray, _tree(name))


def _params(name="tied_bias"):
    return tt.params_from_numpy(_tree(name), device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=64)
def _jax_generate(prompt: tuple, max_new: int) -> list:
    out = jgen.generate(JCFG, _jparams(), np.asarray(prompt, np.int32),
                        max_new)
    return np.asarray(out).tolist()


def _assert_greedy_rows(got, prompt, max_new):
    """Each row exactly JAX's, or diverging first at a near-tie."""
    want = _jax_generate(tuple(map(tuple, prompt)), max_new)
    for row, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        p = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        assert p >= len(prompt[row]), "the prompt was not echoed"
        logits = np.asarray(jt.apply(JCFG, _jparams(),
                                     jnp.asarray([w[:p]], jnp.int32)))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (
            f"row {row} diverges from JAX generate() at {p} with top-2 "
            f"gap {top2[1] - top2[0]}")


# ---------------------------------------------------------------------------
# the dense cache steps


@pytest.mark.parametrize("name", sorted(JCFGS))
def test_decode_step_matches_jax(name):
    cfg, jcfg = _cfg(name), JCFGS[name]
    tokens = np.random.default_rng(0).integers(0, 64, (3, 9)).astype(
        np.int32)
    jcache = jgen.init_cache(jcfg, 3)
    cache = tgen.init_cache(cfg, 3, device="cpu")
    params = _params(name)
    for t in range(tokens.shape[1]):
        jl, jcache = jgen.decode_step(jcfg, _jparams(name), jcache,
                                      tokens[:, t])
        tl, cache = tgen.decode_step(cfg, params, cache,
                                     torch.from_numpy(tokens[:, t]))
        assert _rel(tl, jl) <= 1e-5
    assert cache["pos"] == 9
    assert _rel(cache["k"][:, :, :9], np.asarray(jcache["k"])[:, :, :9]) \
        <= 1e-5


def test_decode_step_matches_the_full_recompute():
    tokens = np.random.default_rng(1).integers(0, 64, (2, 10))
    params = _params()
    full = tt._forward(CFG, params, torch.from_numpy(tokens), tt.attention)
    cache = tgen.init_cache(CFG, 2, device="cpu")
    for t in range(10):
        logits, cache = tgen.decode_step(CFG, params, cache,
                                         torch.from_numpy(tokens[:, t]))
        torch.testing.assert_close(logits, full[:, t], atol=2e-5, rtol=0)


@pytest.mark.parametrize("plen", [1, 6, 17])
def test_prefill_is_one_forward_equal_to_stepwise_decode(plen):
    """`_prefill` writes rows [0, P) of every layer and returns the
    logits at P - 1: the JAX prefill's P single-token steps."""
    prompt = torch.from_numpy(
        np.random.default_rng(plen).integers(0, 64, (2, plen)))
    params = _params()
    cache, last = tgen._prefill(CFG, params, prompt)
    ref = tgen.init_cache(CFG, 2, device="cpu")
    for t in range(plen):
        ref_last, ref = tgen.decode_step(CFG, params, ref, prompt[:, t])
    assert cache["pos"] == ref["pos"] == plen
    torch.testing.assert_close(last, ref_last, atol=2e-5, rtol=0)
    for key in ("k", "v"):
        torch.testing.assert_close(cache[key], ref[key], atol=2e-5, rtol=0)


def _slot_inputs(seed):
    rng = np.random.default_rng(seed)
    pos0 = np.array([0, 3, 11, 5], np.int32)
    return pos0, rng.integers(0, 64, (6, 4)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_decode_step_matches_jax(seed):
    """Rows at their own positions, each writing and masking its own
    history, over six steps."""
    pos0, tokens = _slot_inputs(seed)
    jcache = jgen.init_slot_cache(JCFG, 4)
    jcache["pos"] = jnp.asarray(pos0)
    cache = tgen.init_slot_cache(CFG, 4, device="cpu")
    cache["pos"] = torch.from_numpy(pos0)
    params = _params()
    for t in range(tokens.shape[0]):
        jl, jcache = jgen.slot_decode_step(JCFG, _jparams(), jcache,
                                           tokens[t])
        tl, cache = tgen.slot_decode_step(CFG, params, cache,
                                          torch.from_numpy(tokens[t]))
        assert _rel(tl, jl) <= 1e-5
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert _rel(cache["v"], jcache["v"]) <= 1e-5


def test_make_slot_step_is_slot_decode_step_with_per_slot_sampling():
    """The pool's entry reads only the first max(pos) + 1 positions; its
    greedy lanes take the argmax of `slot_decode_step`'s logits and its
    sampled lane follows `sample_tokens`."""
    pos0, tokens = _slot_inputs(2)
    params = _params()
    cache = tgen.init_slot_cache(CFG, 4, device="cpu")
    cache["pos"] = torch.from_numpy(pos0)
    step = tgen.make_slot_step(CFG)
    k, v = cache["k"].clone(), cache["v"].clone()
    temp = np.array([0.0, 0.0, 0.7, 0.0], np.float32)
    seeds = np.array([0, 0, 5, 0], np.int32)
    for t in range(tokens.shape[0]):
        pos = pos0 + t
        counts = np.full(4, t, np.int32)
        nxt, k, v = step(params, k, v, pos, tokens[t], temp, seeds, counts)
        logits, cache = tgen.slot_decode_step(CFG, params, cache,
                                              torch.from_numpy(tokens[t]))
        want = tgen.sample_tokens(logits, temp, seeds, counts)
        assert nxt.tolist() == want.tolist()
    assert _rel(k, cache["k"]) <= 1e-5


# ---------------------------------------------------------------------------
# the sampling filters: exactly JAX's, ties included


def _filter_logits():
    rng = np.random.default_rng(3)
    lg = rng.standard_normal((6, 64)).astype(np.float32)
    lg[0, :7] = 1.5                       # a run of ties at the cut
    lg[1] = np.round(lg[1], 1)            # many ties everywhere
    lg[2] = 0.0                           # all equal
    lg[3, 9] = 40.0                       # one dominant logit
    return lg


@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 40, 63])
def test_filter_top_k_matches_jax_exactly(k):
    lg = _filter_logits()
    want = np.asarray(jgen._filter_top_k(jnp.asarray(lg), k))
    got = tgen._filter_top_k(torch.from_numpy(lg), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [1e-6, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_filter_top_p_matches_jax_exactly(p):
    lg = _filter_logits()
    want = np.asarray(jgen._filter_top_p(jnp.asarray(lg), p))
    got = tgen._filter_top_p(torch.from_numpy(lg), p).numpy()
    np.testing.assert_array_equal(got, want)
    # the argmax always survives
    assert (got.argmax(-1) == lg.argmax(-1)).all()


# ---------------------------------------------------------------------------
# generate


@pytest.mark.parametrize("plen", [1, 5, 17])
@pytest.mark.parametrize("batch", [1, 3])
def test_greedy_generate_matches_jax(batch, plen):
    prompt = np.random.default_rng(10 * batch + plen).integers(
        0, 64, (batch, plen)).astype(np.int32)
    out = tgen.generate(CFG, _params(), prompt, 12, device="cpu")
    assert out.dtype == torch.int32 and out.shape == (batch, plen + 12)
    _assert_greedy_rows(out.tolist(), prompt.tolist(), 12)


def test_greedy_generate_matches_the_argmax_recompute():
    prompt = np.array([[3, 1, 4, 1]])
    out = tgen.generate(CFG, _params(), prompt, 6, device="cpu")
    ids = prompt[0].tolist()
    for _ in range(6):
        logits = tt._forward(CFG, _params(), torch.tensor([ids]),
                             tt.attention)
        ids.append(int(logits[0, -1].argmax()))
    assert out[0].tolist() == ids


GEN_ERRORS = {
    "top_k": (dict(temperature=1.0, seed=0, top_k=-1), "top_k must be"),
    "top_p_zero": (dict(temperature=1.0, seed=0, top_p=0.0),
                   r"top_p must be in \(0, 1\]"),
    "top_p_above_one": (dict(temperature=1.0, seed=0, top_p=1.5),
                        r"top_p must be in \(0, 1\]"),
    "no_seed": (dict(temperature=0.5), "requires a seed"),
    "max_len": (dict(prompt_len=60), r"prompt\(60\) \+ new\(8\) exceeds "
                r"max_len\(64\)"),
    "empty_prompt": (dict(prompt_len=0), "at least one token"),
    "out_of_vocab": (dict(bad_id=64), "outside vocab"),
}


@pytest.mark.parametrize("name", sorted(GEN_ERRORS))
def test_generate_validation_messages(name):
    kw, match = GEN_ERRORS[name]
    kw = dict(kw)
    plen = kw.pop("prompt_len", 3)
    prompt = np.ones((1, plen), np.int64) * kw.pop("bad_id", 1)
    with pytest.raises(ValueError, match=match):
        tgen.generate(CFG, _params(), prompt, 8, device="cpu", **kw)
    if name in ("top_k", "top_p_zero", "max_len", "empty_prompt"):
        # the JAX package refuses the same request with the same words
        jkw = {k: v for k, v in kw.items() if k != "seed"}
        if "temperature" in jkw:
            jkw["rng"] = jax.random.PRNGKey(0)
        with pytest.raises(ValueError, match=match.split()[0]):
            jgen.generate(JCFG, _jparams(), np.asarray(prompt, np.int32), 8,
                          **jkw)


def test_top_k_one_and_tiny_top_p_equal_greedy():
    prompt = np.array([[3, 1, 4], [9, 9, 2]])
    greedy = tgen.generate(CFG, _params(), prompt, 8, device="cpu")
    k1 = tgen.generate(CFG, _params(), prompt, 8, temperature=5.0, seed=9,
                       top_k=1, device="cpu")
    p_tiny = tgen.generate(CFG, _params(), prompt, 8, temperature=5.0,
                           seed=9, top_p=1e-6, device="cpu")
    assert k1.tolist() == greedy.tolist() == p_tiny.tolist()


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (8, 0.9)])
def test_sampled_tokens_lie_in_the_filtered_support(top_k, top_p):
    """Replaying the decode teacher-forced on the sampled ids through the
    same steps, every sampled token has a kept (> -1e30) filtered logit;
    the same seed repeats the ids, another seed changes them, and a row's
    ids do not depend on the batch it rides in."""
    prompt = np.array([[5, 6, 7], [1, 2, 3], [5, 6, 7]])
    kw = dict(temperature=0.9, top_k=top_k, top_p=top_p, device="cpu")
    out = tgen.generate(CFG, _params(), prompt, 10, seed=4, **kw)
    assert out.tolist() == tgen.generate(CFG, _params(), prompt, 10,
                                         seed=4, **kw).tolist()
    assert out.tolist() != tgen.generate(CFG, _params(), prompt, 10,
                                         seed=5, **kw).tolist()
    alone = tgen.generate(CFG, _params(), prompt[:1], 10, seed=4, **kw)
    assert alone[0].tolist() == out[0].tolist()
    params = _params()
    with torch.no_grad():
        cache, logits = tgen._prefill(CFG, params, torch.from_numpy(prompt))
        for t in range(10):
            kept = tgen.filtered_logits(logits, 0.9, top_k, top_p)
            tok = out[:, 3 + t].long()
            assert (kept.gather(1, tok[:, None]) > -1e29).all()
            if top_k:
                assert ((kept > -1e29).sum(-1) <= top_k).all()
            logits, cache = tgen.decode_step(CFG, params, cache, tok)


def test_first_token_frequencies_follow_the_filtered_softmax():
    """4000 rows of one prompt draw 4000 independent first tokens (row b
    takes the b-th slice of the step's noise).  Bound: every token's
    frequency within 5 standard deviations of its probability under the
    filtered softmax (plus 1/N), and none outside the support.  The
    filtered distribution itself equals JAX's within 1e-5."""
    n, temp, top_k, top_p = 4000, 1.3, 12, 0.9
    prompt = np.tile(np.array([[7, 3, 9, 1]]), (n, 1))
    out = tgen.generate(CFG, _params(), prompt, 1, temperature=temp,
                        seed=123, top_k=top_k, top_p=top_p, device="cpu")
    counts = np.bincount(out[:, -1].numpy(), minlength=64) / n
    with torch.no_grad():
        _, logits = tgen._prefill(CFG, _params(),
                                  torch.from_numpy(prompt[:1]))
    probs = torch.softmax(tgen.filtered_logits(logits, temp, top_k, top_p),
                          -1)[0].numpy()
    jl = jt.apply(JCFG, _jparams(), jnp.asarray(prompt[:1], jnp.int32))
    jl = jl[:, -1].astype(jnp.float32) / temp
    jl = jgen._filter_top_p(jgen._filter_top_k(jl, top_k), top_p)
    np.testing.assert_allclose(probs, np.asarray(jax.nn.softmax(jl))[0],
                               atol=1e-5)
    assert (counts[probs == 0] == 0).all()
    bound = 5 * np.sqrt(probs * (1 - probs) / n) + 1.0 / n
    assert (np.abs(counts - probs) <= bound).all(), (counts, probs)
    assert (probs > 0).sum() >= 2          # the test drew from a real set


# ---------------------------------------------------------------------------
# beam search


@pytest.mark.parametrize("beams", [1, 2, 4])
def test_beam_search_matches_jax(beams):
    prompt = np.random.default_rng(beams).integers(0, 64, (2, 5)).astype(
        np.int32)
    jtok, jscore = jgen.beam_search(JCFG, _jparams(), prompt, 7,
                                    beam_size=beams)
    tok, score = tgen.beam_search(CFG, _params(), prompt, 7,
                                  beam_size=beams, device="cpu")
    assert tok.tolist() == np.asarray(jtok).tolist()
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=1e-4,
                               rtol=0)


def test_beam_one_equals_greedy():
    prompt = np.array([[2, 7], [1, 3]])
    greedy = tgen.generate(CFG, _params(), prompt, 6, device="cpu")
    beam, _ = tgen.beam_search(CFG, _params(), prompt, 6, beam_size=1,
                               device="cpu")
    assert beam.tolist() == greedy.tolist()


def test_winning_score_is_the_teacher_forced_log_prob():
    prompt = np.array([[4, 0, 9]])
    toks, score = tgen.beam_search(CFG, _params(), prompt, 5, beam_size=4,
                                   device="cpu")
    assert toks.shape == (1, 8)
    logp = torch.log_softmax(tt._forward(CFG, _params(), toks.long(),
                                         tt.attention), dim=-1)
    total = sum(float(logp[0, t - 1, toks[0, t]]) for t in range(3, 8))
    assert abs(total - float(score[0])) < 1e-4


@pytest.mark.parametrize("case", ["beam_size", "max_len"])
def test_beam_validation(case):
    if case == "beam_size":
        args, match = (np.zeros((1, 2), np.int64), 2, 0), "beam_size"
    else:
        args, match = (np.zeros((1, 60), np.int64), 8, 4), "max_len"
    prompt, new, beams = args
    with pytest.raises(ValueError, match=match):
        tgen.beam_search(CFG, _params(), prompt, new, beam_size=beams,
                         device="cpu")


@pytest.mark.parametrize("entry", ["generate", "beam_search", "init_cache",
                                   "dense_pool"])
def test_entry_points_need_the_card_unless_asked_for_the_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    calls = {
        "generate": lambda: tgen.generate(CFG, _params(), [[1, 2]], 2),
        "beam_search": lambda: tgen.beam_search(CFG, _params(), [[1, 2]],
                                                2),
        "init_cache": lambda: tgen.init_cache(CFG, 1),
        "dense_pool": lambda: ContinuousLMServer(CFG, _params(),
                                                 kv="dense"),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


# ---------------------------------------------------------------------------
# the dense slot pool


def _serve_all(srv, prompts, max_new, **kw):
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
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


DENSE_PROMPTS = [[1, 2, 3, 4, 5, 1, 2, 3], [7, 8, 9, 10, 11, 12, 7, 8, 9],
                 [3, 3, 3, 3], list(range(1, 12)), [60], [5, 9] * 7]


@pytest.mark.parametrize("slots", [1, 3])
def test_dense_pool_greedy_matches_jax_generate(slots):
    """Six requests on `slots` lanes: mid-flight joins, each prompt
    teacher-forced one token per dispatch."""
    srv = ContinuousLMServer(CFG, _params(), slots=slots, kv="dense",
                             device="cpu")
    try:
        assert srv.warmup() == 1
        outs = _serve_all(srv, DENSE_PROMPTS, 10)
        stats = srv.stats()
    finally:
        srv.stop()
    for prompt, got in zip(DENSE_PROMPTS, outs):
        _assert_greedy_rows([got], [prompt], 10)
    assert stats["kv"] == {"mode": "dense"}
    assert stats["requests"] == len(DENSE_PROMPTS)
    assert set(stats["dispatch_widths"]) == {"1"}
    assert stats["kv_bytes"]["provisioned"] == (
        slots * CFG.max_len * stats["kv_bytes"]["per_token"])
    assert srv._cache[0].shape == (2, slots, 64, 4, 8)


def test_dense_pool_samples_like_the_paged_pool():
    """Both pools draw a sampled lane's tokens by the same per-slot rule,
    so one seeded request gives the same ids on either."""
    prompt = DENSE_PROMPTS[1]
    out = []
    for kv in ("dense", "paged"):
        srv = ContinuousLMServer(CFG, _params(), slots=2, kv=kv,
                                 page_size=4, prefill_chunk=4, device="cpu")
        try:
            out.append(srv.generate(prompt, 12, temperature=0.8, seed=11,
                                    timeout=120))
        finally:
            srv.stop()
    assert out[0] == out[1]


def test_dense_pool_recovers_from_a_failed_dispatch():
    srv = ContinuousLMServer(CFG, _params(), slots=2, kv="dense",
                             device="cpu")
    prompt = DENSE_PROMPTS[0]
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
        assert srv.generate(prompt, 5) == want
    finally:
        srv.stop()
