"""PyTorch port: speculative decoding (`deeplearning4j_tpu_torch.serving.draft`,
`parallel.generation.spec_verify_step` / `make_spec_step`, and
`ContinuousLMServer(speculate=...)`).

The cases of the JAX package's ``tests/test_spec.py`` that need no fleet,
tracing, ``/metrics`` or compile watcher, run on the port on the CPU in
float32, plus side-by-side checks with the JAX package on the same numpy
weights: the n-gram drafter proposes exactly what JAX's proposes; one
verify dispatch gives JAX's bonus logits within 1e-5 (relative to the
largest) and exactly its accepted counts; and the speculating pool's
greedy ids equal JAX ``generate()``, whatever the drafter proposes.
"""

import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.serving import draft as jdraft
from deeplearning4j_tpu_torch.parallel import generation as tgen
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import ContinuousLMServer
from deeplearning4j_tpu_torch.serving.draft import (
    ModelDrafter,
    NgramDrafter,
    make_drafter,
)
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

JCFG = jt.TransformerConfig(vocab_size=50, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_len=48,
                            attn_bias=True, tie_embeddings=True)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(CFG, seed=0)


@functools.lru_cache(maxsize=1)
def _jparams():
    return jax.tree_util.tree_map(jnp.asarray, _tree())


def _params():
    return tt.params_from_numpy(_tree(), device="cpu")


@functools.lru_cache(maxsize=128)
def _want_t(prompt: tuple, new: int) -> tuple:
    out = jgen.generate(JCFG, _jparams(), np.asarray([prompt], np.int32),
                        new)
    return tuple(np.asarray(out)[0].tolist())


def _want(prompt, new):
    return list(_want_t(tuple(prompt), new))


def _pool(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("prefill_chunk", 4)
    return ContinuousLMServer(CFG, _params(), device="cpu", **kw)


def _wait_idle(srv, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        with srv._cond:
            if not any(s.active for s in srv._slots) and not srv._queue:
                return True
        time.sleep(0.01)
    return False


# ---------------------------------------------------------------------------
# the n-gram drafter


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafter_proposes_what_the_jax_drafter_proposes(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = NgramDrafter(max_ngram=4), jdraft.NgramDrafter(max_ngram=4)
    for _ in range(100):
        lanes = int(rng.integers(1, 5))
        hist = [None if rng.random() < 0.15 else
                [int(t) for t in rng.integers(0, int(rng.integers(2, 8)),
                                              int(rng.integers(0, 40)))]
                for _ in range(lanes)]
        budgets = [int(b) for b in rng.integers(0, 6, lanes)]
        assert ours.propose(hist, budgets) == theirs.propose(hist, budgets)


def _is_continuation(hist, prop, max_ngram):
    """A proposal continues some prior occurrence of a history suffix."""
    for n in range(1, min(max_ngram, len(hist) - 1) + 1):
        suffix = hist[-n:]
        for i in range(len(hist) - n):
            if (hist[i:i + n] == suffix
                    and prop == hist[i + n:i + n + len(prop)]):
                return True
    return False


def test_ngram_random_streams_propose_historical_continuations():
    rng = np.random.default_rng(42)
    drafter = NgramDrafter(max_ngram=4)
    checked = 0
    for _ in range(200):
        hist = [int(t) for t in rng.integers(0, int(rng.integers(2, 8)),
                                             int(rng.integers(2, 40)))]
        budget = int(rng.integers(1, 6))
        (prop,) = drafter.propose([hist], [budget])
        assert len(prop) <= budget
        if prop:
            assert _is_continuation(hist, prop, 4), (hist, prop)
            checked += 1
    assert checked > 50


NGRAM_CASES = {
    "empty_history": ([[]], [4], [[]]),
    "no_prior": ([[7]], [4], [[]]),
    "masked_lane": ([None], [4], [[]]),
    "no_budget": ([[1, 2, 3]], [0], [[]]),
    "all_distinct": ([list(range(20))], [4], [[]]),
    "repetition": ([[1, 2, 3, 4, 1, 2, 3, 4, 1, 2]], [4], [[3, 4, 1, 2]]),
    "most_recent_wins": ([[5, 1, 1, 5, 2, 9, 5]], [2], [[2, 9]]),
    "longer_ngram_wins": ([[1, 2, 3, 7, 3, 8, 2, 3]], [1], [[7]]),
    "lanes_independent": ([[1, 2, 1], None, [4, 4, 4, 4]], [3, 3, 2],
                          [[2, 1], [], [4]]),
}


@pytest.mark.parametrize("name", sorted(NGRAM_CASES))
def test_ngram_drafter_cases(name):
    hist, budgets, want = NGRAM_CASES[name]
    assert NgramDrafter().propose(hist, budgets) == want


def test_ngram_drafter_validates_its_range():
    with pytest.raises(ValueError, match="min_ngram"):
        NgramDrafter(max_ngram=1, min_ngram=2)


# ---------------------------------------------------------------------------
# the model drafter (self-speculation: the target drafts for itself)


def test_self_draft_proposes_the_models_own_greedy_continuation():
    drafter = ModelDrafter(CFG, _params(), slots=2, device="cpu")
    (prop, empty) = drafter.propose([[1, 2, 3], None], [4, 4])
    assert prop == _want([1, 2, 3], 4)[3:]
    assert empty == []


def test_rejected_drafts_rewind_and_history_extends():
    drafter = ModelDrafter(CFG, _params(), slots=1, device="cpu")
    (p1,) = drafter.propose([[1, 2, 3]], [3])
    (p2,) = drafter.propose([[1, 2, 3, 9]], [3])
    assert p1 == _want([1, 2, 3], 3)[3:]
    assert p2 == _want([1, 2, 3, 9], 3)[4:]


def test_slot_reuse_resets_cleanly():
    drafter = ModelDrafter(CFG, _params(), slots=1, device="cpu")
    drafter.propose([[5, 6, 7, 8]], [2])
    (prop,) = drafter.propose([[2, 4]], [3])
    assert prop == _want([2, 4], 3)[2:]


DRAFTER_REFUSALS = {
    "vocab": (dict(target_vocab=100), "vocab"),
    "max_len": (dict(target_max_len=64), "max_len"),
    "slots": (dict(slots=0), "slots"),
}


@pytest.mark.parametrize("name", sorted(DRAFTER_REFUSALS))
def test_model_drafter_refusals_are_typed(name):
    kw, match = DRAFTER_REFUSALS[name]
    kw = dict(slots=1, **kw) if "slots" not in kw else kw
    with pytest.raises(ValueError, match=match):
        ModelDrafter(CFG, _params(), device="cpu", **kw)


def test_short_draft_cache_never_corrupts():
    cfg = dataclasses.replace(CFG, max_len=8)
    params = _params()
    params["pos"] = params["pos"][:8]
    drafter = ModelDrafter(cfg, params, slots=1, device="cpu")
    assert drafter.propose([list(range(1, 13))], [3]) == [[]]
    (prop,) = drafter.propose([[2, 4]], [3])
    assert prop == _want([2, 4], 3)[2:]


def test_make_drafter_modes():
    assert make_drafter("off", CFG, _params(), 2) is None
    assert make_drafter("ngram", CFG, _params(), 2).name == "ngram"
    assert make_drafter("model", CFG, _params(), 2,
                        device="cpu").name == "model"
    with pytest.raises(ValueError, match="speculate"):
        make_drafter("wat", CFG, _params(), 2)


# ---------------------------------------------------------------------------
# the verify step against the JAX package


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_verify_step_matches_jax(seed):
    """Two dispatches of the wide program over one paged pool (page 4,
    width 6): a teacher-forced prefill chunk, then a verify round with a
    fully right draft, a draft wrong at its second token, a wrong first
    draft, a plain decode lane and an inactive lane."""
    rng = np.random.default_rng(seed)
    ps, w, b = 4, 6, 5
    mp = tgen.pages_per_seq(CFG, ps)
    pages = 1 + b * mp
    table = np.zeros((b, mp), np.int32)
    perm = rng.permutation(np.arange(1, pages)).astype(np.int32)
    for i in range(b - 1):
        table[i] = perm[i * mp:(i + 1) * mp]
    prompts = [rng.integers(0, 50, 5).tolist() for _ in range(b)]
    cont = [_want(p, 5)[5:] for p in prompts]
    # dispatch 1: prefill the first 4 prompt tokens of every live lane
    tok1 = np.zeros((b, w), np.int32)
    tok1[:b - 1, :4] = np.array(prompts)[:b - 1, :4]
    nf1 = np.array([4, 4, 4, 4, 0], np.int32)
    pos1 = np.zeros(b, np.int32)
    # dispatch 2: [last prompt token, drafts...]
    drafts = [cont[0][:4], [cont[1][0], (cont[1][1] + 1) % 50, cont[1][2]],
              [(cont[2][0] + 1) % 50, cont[2][1]], [], []]
    tok2 = np.zeros((b, w), np.int32)
    for i in range(b - 1):
        tok2[i, 0] = prompts[i][4]
        tok2[i, 1:1 + len(drafts[i])] = drafts[i]
    nd2 = np.array([len(d) for d in drafts], np.int32)
    nf2 = np.array([1 + len(d) for d in drafts[:b - 1]] + [0], np.int32)
    pos2 = np.array([4, 4, 4, 4, 0], np.int32)
    jcache = jgen.init_paged_cache(JCFG, pages, ps)
    cache = tgen.init_paged_cache(CFG, pages, ps, device="cpu")
    params = _params()
    for tok, pos, nf, nd in ((tok1, pos1, nf1, np.zeros(b, np.int32)),
                             (tok2, pos2, nf2, nd2)):
        jb, jacc, jcache = jgen.spec_verify_step(
            JCFG, _jparams(), jcache, jnp.asarray(table), jnp.asarray(pos),
            jnp.asarray(nf), jnp.asarray(nd), jnp.asarray(tok))
        tb, tacc, cache = tgen.spec_verify_step(
            CFG, params, cache, *(torch.from_numpy(a) for a in (
                table, pos, nf, nd, tok)))
        live = nf > 0
        jb = np.asarray(jb)[live]
        assert np.abs(tb.numpy()[live] - jb).max() <= 1e-5 * np.abs(jb).max()
        assert tacc.dtype == torch.int32
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert tacc.tolist() == [4, 1, 0, 0, 0]
    # the bonus logits are the target's next token after the accepted run
    assert int(tb[0].argmax()) == _want(prompts[0], 5)[9]
    assert int(tb[1].argmax()) == cont[1][1]


@pytest.mark.parametrize("drafting_lane", [False, True])
def test_make_spec_step_samples_at_the_bonus_column_like_the_1_wide_step(
        drafting_lane):
    """A teacher-forced lane (n_draft = 0) on the verify program gives the
    token the 1-wide program gives, greedy or sampled: on a dispatch
    without drafts (the head at the last fed column only) and beside a
    lane verifying a draft (the head over every column)."""
    ps, w, b = 4, 5, 3
    mp = tgen.pages_per_seq(CFG, ps)
    pages = 1 + b * mp
    table = np.arange(1, pages, dtype=np.int32).reshape(b, mp)
    spec = tgen.make_spec_step(CFG, pages, ps, w, verify=drafting_lane)
    one = tgen.make_paged_step(CFG, pages, ps, 1)
    params = _params()
    temp = np.array([0.0, 0.9, 0.0], np.float32)
    seeds = np.array([0, 17, 0], np.int32)
    counts = np.array([0, 3, 0], np.int32)
    n_draft = np.array([0, 0, int(drafting_lane)], np.int32)
    outs = []
    for wide in (True, False):
        c = tgen.init_paged_cache(CFG, pages, ps, device="cpu")
        k, v = c["k"], c["v"]
        for t, tok in enumerate([7, 3, 9, 1]):
            pos = np.full(b, t, np.int32)
            if wide:
                toks = np.zeros((b, w), np.int32)
                toks[:, 0] = tok
                toks[2, 1] = 5                      # lane 2's draft
                nxt, acc, k, v = spec(params, k, v, table, pos,
                                      1 + n_draft, n_draft, toks, temp,
                                      seeds, counts)
                assert acc.tolist()[:2] == [0, 0]
            else:
                nxt, k, v = one(params, k, v, table, pos,
                                np.ones(b, np.int32),
                                np.full((b, 1), tok, np.int32), temp, seeds,
                                counts)
        outs.append(nxt.tolist()[:2])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# greedy parity of the speculating pool with JAX generate()

PARITY_PROMPTS = [[1, 2, 3, 4, 5, 1, 2, 3], [7, 8, 9, 10, 11, 12, 7, 8, 9],
                  [3, 3, 3, 3], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]]


@pytest.mark.parametrize("page_size,chunk,draft_len", [
    (4, 4, 3), (8, 1, 4), (6, 4, 2)])
@pytest.mark.parametrize("mode", ["ngram", "model"])
def test_speculating_pool_greedy_matches_jax_generate(mode, page_size,
                                                      chunk, draft_len):
    srv = _pool(slots=4, page_size=page_size, prefill_chunk=chunk,
                speculate=mode, draft_len=draft_len)
    try:
        srv.warmup()
        results = {}

        def run(i, p):
            results[i] = srv.generate(p, 12, timeout=120)

        threads = [threading.Thread(target=run, args=(i, p))
                   for i, p in enumerate(PARITY_PROMPTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = srv.stats()
    finally:
        srv.stop()
    for i, p in enumerate(PARITY_PROMPTS):
        assert results[i] == _want(p, 12), (mode, i)
    assert stats["speculate"]["verify_width"] == max(chunk, draft_len + 1)
    assert stats["spec_drafted"] >= stats["spec_accepted"] > 0


def test_self_draft_accepts_everything():
    """The drafter is the target, so every greedy draft is accepted and
    12 tokens take at most 5 decode rounds."""
    srv = _pool(slots=1, speculate="model", draft_len=3)
    try:
        srv.warmup()
        p = [1, 2, 3, 4, 5]
        assert srv.generate(p, 12, timeout=120) == _want(p, 12)
        st = srv.stats()
    finally:
        srv.stop()
    assert st["spec_accept_rate"] == 1.0
    assert st["speculate"]["accept_rate"] == 1.0
    assert st["decode_rounds"] <= 5
    assert st["tokens_per_decode_round"] > 2.0


def test_midflight_join_keeps_parity():
    srv = _pool(speculate="ngram", draft_len=3)
    try:
        srv.warmup()
        long_p = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]
        results = {}
        t = threading.Thread(target=lambda: results.__setitem__(
            "a", srv.generate(long_p, 16, timeout=120)))
        t.start()
        time.sleep(0.05)               # join mid-decode of the first
        results["b"] = srv.generate([9, 8, 9, 8, 9], 10, timeout=120)
        t.join(timeout=120)
    finally:
        srv.stop()
    assert results["a"] == _want(long_p, 16)
    assert results["b"] == _want([9, 8, 9, 8, 9], 10)


class _WrongDrafter:
    """Proposes the last vocab id for every budgeted lane: every round is
    rolled back (or, where it happens to match, merely accepted)."""

    name = "wrong"

    def propose(self, histories, budgets):
        return [[CFG.vocab_size - 1] * int(b) if h is not None else []
                for h, b in zip(histories, budgets)]

    def reset(self):
        pass


class _RudeDrafter(_WrongDrafter):
    """Over budget and out of vocab mid-proposal."""

    name = "rude"

    def propose(self, histories, budgets):
        return [[1, 2, CFG.vocab_size + 7, 3] * 4 if h is not None else []
                for h in histories]


@pytest.mark.parametrize("drafter", [_WrongDrafter, _RudeDrafter])
def test_adversarial_drafters_cannot_corrupt_output(drafter):
    srv = _pool(draft_len=3, drafter=drafter())
    try:
        srv.warmup()
        for p in ([1, 2, 3, 4, 5], [6, 5, 4, 3, 2, 1]):
            assert srv.generate(p, 10, timeout=120) == _want(p, 10)
        assert srv.stats()["speculate"]["mode"] == "custom"
    finally:
        srv.stop()


def test_rollbacks_keep_the_page_ledger_balanced():
    """An all-wrong drafter makes every round write and abandon draft
    columns in the lane's own pages: no page moves, and after 16
    requests (some shed at the admitter, some abandoned mid-decode) the
    ledger balances and only the radix tree holds pages."""
    srv = _pool(slots=3, pages=24, draft_len=3, drafter=_WrongDrafter())
    rng = np.random.default_rng(0)
    threads = []

    def one(i, p, n):
        try:
            if i % 5 == 3:
                srv.generate(p, n, deadline_s=0.0, timeout=60)
            elif i % 7 == 2:
                srv.generate(p, n, timeout=0.001)
            else:
                assert srv.generate(p, n, timeout=120) == _want(p, n)
        except TimeoutError:
            pass

    try:
        srv.warmup()
        for i in range(16):
            p = [int(t) for t in rng.integers(1, 49, rng.integers(2, 10))]
            t = threading.Thread(target=one,
                                 args=(i, p, int(rng.integers(2, 10))))
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert _wait_idle(srv)
        ledger = srv.page_ledger()
        stats = srv.stats()
    finally:
        srv.stop()
    assert ledger["balanced"], ledger
    assert ledger["in_use"] == ledger["radix_nodes"], ledger
    assert stats["spec_drafted"] > stats["spec_accepted"]


def test_sampled_lane_falls_back_and_matches_the_non_speculating_pool():
    """A sampled lane is never drafted for: it rides the verify dispatches
    as a 1-token lane and gives the seeded ids of a plain pool."""
    spec = _pool(speculate="ngram", draft_len=3)
    base = _pool()
    try:
        spec.warmup()
        base.warmup()
        p = [1, 2, 1, 2, 1]
        results = {}

        def greedy():
            results["g"] = spec.generate([4, 5, 4, 5, 4, 5], 12,
                                         timeout=120)

        t = threading.Thread(target=greedy)
        t.start()
        got = spec.generate(p, 10, temperature=0.8, seed=11, timeout=120)
        t.join(timeout=120)
        assert got == base.generate(p, 10, temperature=0.8, seed=11,
                                    timeout=120)
        assert results["g"] == _want([4, 5, 4, 5, 4, 5], 12)
        assert spec.stats()["dispatch_widths"].get("4", 0) > 0
    finally:
        spec.stop()
        base.stop()


CONSTRUCTION_ERRORS = {
    "dense_kv": (dict(kv="dense", speculate="ngram"), "paged"),
    "bad_mode": (dict(speculate="warp"), "speculate"),
    "bad_draft_len": (dict(speculate="ngram", draft_len=0), "draft_len"),
    "bad_kv": (dict(kv="ring"), "kv must be"),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTION_ERRORS))
def test_bad_configurations_are_typed_at_construction(name):
    kw, match = CONSTRUCTION_ERRORS[name]
    with pytest.raises(ValueError, match=match):
        _pool(**kw)


def test_stats_carry_the_spec_ledger():
    srv = _pool(speculate="model", draft_len=3)
    try:
        srv.warmup()
        srv.generate([1, 2, 3, 4, 5], 10, timeout=120)
        st = srv.stats()
    finally:
        srv.stop()
    assert st["spec_drafted"] >= st["spec_accepted"] > 0
    assert st["spec_rounds"] > 0
    assert st["speculate"]["mode"] == "model"
    assert st["speculate"]["draft_len"] == 3
    assert st["speculate"]["verify_width"] == 4
    assert 0 < st["speculate"]["accept_rate"] <= 1.0
    assert st["speculate"]["tokens_per_decode_round"] > 1.0


def test_server_without_speculation_reports_no_section():
    srv = _pool(slots=1)
    try:
        srv.generate([1, 2, 3], 4, timeout=120)
        st = srv.stats()
    finally:
        srv.stop()
    assert "speculate" not in st and "spec_drafted" not in st
    assert st["tokens_per_decode_round"] == 1.0


def test_failed_dispatch_resets_the_drafter_with_the_pool():
    srv = _pool(slots=1, speculate="model", draft_len=3)
    try:
        srv.warmup()
        p = [1, 2, 3, 4, 5, 6]
        want = _want(p, 8)
        assert srv.generate(p, 8, timeout=120) == want
        real_step = srv._step
        srv._step = lambda *a, **kw: (_ for _ in ()).throw(
            RuntimeError("boom"))
        with pytest.raises(RuntimeError, match="boom"):
            srv.generate(p, 8, timeout=120)
        srv._step = real_step
        assert srv._drafter._fed == [[]]   # lane state died with the pool
        assert srv.generate(p, 8, timeout=120) == want
        assert srv.page_ledger()["balanced"]
    finally:
        srv.stop()
