"""PyTorch port on an NVIDIA card: the hand-written CUDA kernels (paged
attention with its page split, head dims up to 512; the flash-attention
forward and its two backward kernels on the tensor cores, the FMA pipes
and the D-chunked route up to head dim 512; the fused LSTM scan on its
cluster and wide routes, any batch) and the serving (``prefill_chunk`` up
to 128 and beyond; the speculating pool, whose verify round runs on the
paged kernel; the dense pool; whole-sequence `generate` and
`beam_search`, prefilled through the flash forward), LM-training and
`MultiLayerNetwork` paths that launch them; and the conv nets and the
training command line, which run no hand kernel (f32 gradients and SAME
stride-2 convolution and pooling against the CPU).  Every kernel is
held against its plain version in float16 too, and the precision plane
runs here: loss-scaled char-LSTM steps (mixed and float16) with their
overflow skip, and the chunked fit's chunk-size invariance.  The
word-embedding family has no hand kernel: its HS, NEG and GloVe steps
(gathers and ``index_add_``) are held against the CPU, and a Word2Vec
fit on the card must separate two topics.  The operations plane runs
here too: an SSE stream over HTTP, the circuit breaker opening on
injected dispatch faults and closing on a probe, and a throttled
tenant's ledger.  So does classifier serving: the `ServingEngine` over a
char-LSTM launching the LSTM kernel once a dispatch, and a 2-replica LM
fleet launching the paged kernel n_layers times a dispatch by width.
The sentiment models and clustering run no hand kernel: the Viterbi
decode, the tagger and parser, RNTN and autoencoder gradients and fits
and KMeans (TF32 off) are held against the CPU, and the plotting
listeners run on a bfloat16 LeNet.  The host-only tail: a GPT-2 stand-in
under HF's names imported onto the card and served through the paged
kernel, the flash backward kernels bitwise across two calls, a remote
checkpoint of a card network bitwise, and `device_memory_stats`.  The
scaleout plane: a `NetworkPerformer` on the card publishes host numpy
copies and launches the LSTM kernel once a job.  Data parallelism: a
4-shard mesh over card 0 (ZeRO-1 = replicated bitwise, the LSTM kernel
once a layer, shard and step, an overflow on one shard skipped on all)
and the CLI's ``-replicas`` check against the cards present.  The LM
mesh trainers: ring attention over 4 sequence shards of card 0 against
the one-device flash kernels (10 / 16 block pairs), and one step of the
hybrid and the pipeline trainer against the one-device step with their
launch counts.  Training across processes: 2 gloo processes of 2 shards
of card 0 against one process of 4 shards, bitwise, and an NCCL group of
one process running the mesh collectives.

Every test carries the ``cuda`` marker and decides inside the test
whether a card is present, skipping with a reason when not (the kernels
are CUDA C++ with no CPU mode).  This file imports no
JAX, so on a machine with a card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.parallel import hybrid as th
from deeplearning4j_tpu_torch.parallel import kernels as tk
from deeplearning4j_tpu_torch.parallel import paged_kernel as tpk
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import ContinuousLMServer

pytestmark = pytest.mark.cuda

# (b, c, h, kd, ps, mp, pos, n_feed, null lanes)
CASES = {
    "decode_ps4": (4, 1, 2, 8, 4, 8, [0, 5, 3, 23], [1, 1, 1, 1], ()),
    "decode_ps5_null": (4, 1, 2, 8, 5, 6, [0, 7, 14, 0], [1, 1, 1, 0], (3,)),
    "chunk4_ps5_ragged": (4, 4, 2, 8, 5, 6, [9, 1, 14, 0], [4, 2, 1, 3], ()),
    "chunk16_ps16_served": (3, 16, 12, 64, 16, 8, [0, 40, 100],
                            [16, 5, 16], ()),
    "chunk3_ps33_k80": (2, 3, 3, 80, 33, 3, [31, 60], [3, 2], ()),
    # prefill_chunk=128 at GPT-2 head width, and a 64-wide chunk at K 128
    "chunk128_ps16_k64": (2, 128, 2, 64, 16, 10, [0, 20], [128, 100], ()),
    "chunk64_ps16_k128": (3, 64, 2, 128, 16, 8, [0, 33, 60], [64, 17, 64],
                          ()),
    # head dims above the tensor-core route's 256: decode and a chunk
    "decode_ps16_k384": (3, 1, 2, 384, 16, 6, [0, 40, 90], [1, 1, 1], ()),
    "chunk16_ps16_k512": (2, 16, 2, 512, 16, 6, [0, 50], [16, 9], ()),
    "decode_ps16_k512_null": (3, 1, 1, 512, 16, 4, [7, 0, 60], [1, 0, 1],
                              (1,)),
    "chunk5_ps16_k384": (2, 5, 2, 384, 16, 4, [20, 3], [5, 5], ()),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ with "
                    "no CPU mode")


def _state(case, dtype, seed=0):
    b, c, h, kd, ps, mp, pos, nf, null = case
    rng = np.random.default_rng(seed)
    pages = 1 + b * mp
    perm = rng.permutation(np.arange(1, pages)).astype(np.int32)
    table = np.zeros((b, mp), np.int32)
    for i in range(b):
        if i not in null:
            need = min(mp, (pos[i] + c - 1) // ps + 1)
            table[i, :need] = perm[i * mp:i * mp + need]
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    return (rand(b, c, h, kd), rand(pages, ps, h, kd),
            rand(pages, ps, h, kd), torch.from_numpy(table).to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev),
            torch.tensor(nf, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(name, dtype):
    _need_card()
    dt = getattr(torch, dtype)
    q, kp, vp, table, pos, nf = _state(CASES[name], dt)
    before = tpk.paged_flash_attention.launches.value
    got = tpk.paged_flash_attention(q, kp, vp, table, pos, nf)
    torch.cuda.synchronize()
    assert tpk.paged_flash_attention.launches.value == before + 1
    assert got.dtype == dt and got.shape == q.shape
    # the reference: the plain version in float32 on the same inputs
    want = tpk.paged_flash_attention_plain(q.float(), kp.float(),
                                           vp.float(), table, pos, nf)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    lane_rtol = 1e-4 if dt == torch.float32 else 1e-2
    for i, n in enumerate(CASES[name][7]):
        if n:
            torch.testing.assert_close(got[i, :n].float(), want[i, :n],
                                       atol=tol, rtol=0)
            # each lane also within a share of its largest reference value
            scale = float(want[i, :n].abs().max())
            torch.testing.assert_close(got[i, :n].float(), want[i, :n],
                                       atol=lane_rtol * scale, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_512_column_chunk_at_head_dim_256_is_served(dtype):
    """C = 512 at K = 256, which the first design refused for its shared
    memory, is served: the feed width is tiled, so shared memory does
    not grow with C."""
    _need_card()
    case = (1, 512, 2, 256, 16, 32, [0], [512], ())
    dt = getattr(torch, dtype)
    q, kp, vp, table, pos, nf = _state(case, dt)
    before = tpk.paged_flash_attention.launches.value
    got = tpk.paged_flash_attention(q, kp, vp, table, pos, nf)
    torch.cuda.synchronize()
    assert tpk.paged_flash_attention.launches.value == before + 1
    want = tpk.paged_flash_attention_plain(q.float(), kp.float(),
                                           vp.float(), table, pos, nf)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


def test_refused_launch_raises():
    """A launch the kernel refuses (here: head dim 520, above its 512)
    raises with the entry's own head-dim code, and counts nothing."""
    _need_card()
    q, kp, vp, table, pos, nf = _state(
        (1, 4, 1, 520, 4, 2, [0], [4], ()), torch.float32)
    before = tpk.paged_flash_attention.launches.value
    with pytest.raises(RuntimeError, match="refused head dim K=520"):
        tpk.paged_flash_attention(q, kp, vp, table, pos, nf)
    assert tpk.paged_flash_attention.launches.value == before


def test_server_on_the_card_matches_the_checker():
    """Greedy serving on the card in float32 against the argmax of the
    full-recompute forward on the card (a near-tie, top-2 gap < 1e-3,
    ends the comparison), with every dispatch going through the kernel
    once per layer."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    assert resolve_device(None).type == "cuda"
    cfg = tt.TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                               n_layers=2, d_ff=256, max_len=64,
                               attn_bias=True, tie_embeddings=True)
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=0),
                                  device="cuda")
    srv = ContinuousLMServer(cfg, params, slots=3, page_size=5,
                             prefill_chunk=4, device=None)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).tolist() for n in (3, 11, 17, 26)]
    try:
        srv.warmup()
        tpk.paged_flash_attention.launches.reset()
        outs = [srv.generate(p, 12, timeout=120) for p in prompts]
        launches = tpk.paged_flash_attention.launches.value
        stats = srv.stats()
    finally:
        srv.stop()
    assert launches == cfg.n_layers * stats["dispatches"] > 0
    with torch.no_grad():
        for prompt, seq in zip(prompts, outs):
            logits = tt._forward(cfg, params,
                                 torch.tensor([seq], device="cuda"),
                                 tt.attention)[0]
            top2 = logits.topk(2, dim=-1)
            for p in range(len(prompt), len(seq)):
                gap = float(top2.values[p - 1, 0] - top2.values[p - 1, 1])
                if gap < 1e-3:
                    break
                assert int(top2.indices[p - 1, 0]) == seq[p]


def test_prefill_chunk_128_server_on_the_card_matches_the_checker():
    """``prefill_chunk=128`` at head dim 64 (refused by the first
    design): a 300-token prompt is prefilled in 128-token chunks through
    the kernel and the greedy tokens match the plain checker."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tt.TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                               n_layers=2, d_ff=256, max_len=384,
                               attn_bias=True, tie_embeddings=True)
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=2),
                                  device="cuda")
    srv = ContinuousLMServer(cfg, params, slots=2, page_size=16,
                             prefill_chunk=128, device=None)
    prompt = np.random.default_rng(3).integers(0, 512, 300).tolist()
    try:
        tpk.paged_flash_attention.launches.reset()
        seq = srv.generate(prompt, 12, timeout=300)
        launches = tpk.paged_flash_attention.launches.value
        stats = srv.stats()
    finally:
        srv.stop()
    assert stats["dispatch_widths"].get("128", 0) >= 2
    assert launches == cfg.n_layers * stats["dispatches"] > 0
    assert seq[:300] == prompt and len(seq) == 312
    with torch.no_grad():
        logits = tt._forward(cfg, params, torch.tensor([seq], device="cuda"),
                             tt.attention)[0]
    top2 = logits.topk(2, dim=-1)
    for p in range(300, 312):
        if float(top2.values[p - 1, 0] - top2.values[p - 1, 1]) < 1e-3:
            break
        assert int(top2.indices[p - 1, 0]) == seq[p]


# ---------------------------------------------------------------------------
# the other decode modes: speculation (verify on kernel B1 at the spec
# width), the dense slot pool, whole-sequence generate and beam search

# a served greedy token's fp32 logit lies within this of the position's
# largest under the plain fp32 recompute in float32; in bfloat16 within
# twice the bf16 logit error the plain bf16 recompute shows there (the
# argmax of logits within e of the fp32 ones lies within 2e of the largest)
F32_TIE = 1e-3


def _decode_cfg(dtype="float32", max_len=160):
    return tt.TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                                n_layers=2, d_ff=256, max_len=max_len,
                                attn_bias=True, tie_embeddings=True,
                                dtype=dtype)


def _decode_prompts():
    rng = np.random.default_rng(4)
    motif = rng.integers(0, 512, 9).tolist()
    return [motif * 4, rng.integers(0, 512, 23).tolist(), motif * 2 + [5],
            rng.integers(0, 512, 40).tolist()]


def _check_greedy(cfg, params, prompt, seq):
    """Teacher-forced on the served ids: every generated token's fp32
    logit within the limit above of the largest; returns the exact
    count."""
    p32 = tt.map_tree(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ids = torch.tensor([seq], device="cuda")
    p, n = len(prompt), len(seq)
    with torch.no_grad():
        rows = tt._forward(cfg32, p32, ids, tt.attention)[0, p - 1:n - 1]
        if cfg.dtype == "bfloat16":
            low = tt._forward(cfg, params, ids, tt.attention)[0, p - 1:n - 1]
            limit = 2 * (low.float() - rows).abs().amax(-1)
        else:
            limit = torch.full((n - p,), F32_TIE, device="cuda")
    gen = torch.tensor(seq[p:], device="cuda")
    deficit = rows.max(-1).values - rows.gather(1, gen[:, None])[:, 0]
    assert bool((deficit <= limit).all()), (deficit - limit).max()
    return int((deficit == 0).sum())


@pytest.mark.parametrize("dtype,chunk", [("float32", 4),
                                         ("bfloat16", 16)])
def test_speculating_server_on_the_card_matches_the_checker(dtype, chunk):
    """n-gram speculation (draft_len 4; verify width 5 on the FMA route
    in f32, 16 on `mma.sync` in bf16): greedy ids by the checker rule and
    against the same pool without speculation, and one kernel launch per
    layer and dispatch, at both widths."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _decode_cfg(dtype)
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=0),
                                  device="cuda", dtype=dtype)
    prompts = _decode_prompts()
    outs, stats = {}, {}
    for mode in ("ngram", "off"):
        srv = ContinuousLMServer(cfg, params, slots=3, page_size=8,
                                 prefill_chunk=chunk, speculate=mode,
                                 draft_len=4, device=None)
        try:
            srv.warmup()
            tpk.paged_flash_attention.launches.reset()
            outs[mode] = [srv.generate(p, 24, timeout=120) for p in prompts]
            launches = tpk.paged_flash_attention.launches.value
            by_width = tpk.paged_flash_attention.launches.by_key()
            stats[mode] = srv.stats()
            assert srv.page_ledger()["balanced"]
        finally:
            srv.stop()
        assert launches == cfg.n_layers * stats[mode]["dispatches"] > 0
        assert by_width == {int(w): cfg.n_layers * n for w, n in
                            stats[mode]["dispatch_widths"].items()}
    spec = stats["ngram"]
    assert spec["dispatch_widths"][str(max(chunk, 5))] > 0
    assert spec["spec_accepted"] > 0
    for prompt, seq in zip(prompts, outs["ngram"]):
        _check_greedy(cfg, params, prompt, seq)
    if dtype == "float32":
        assert outs["ngram"] == outs["off"]


def test_verify_dispatch_on_the_card_never_takes_the_plain_paged_path(
        monkeypatch):
    _need_card()

    def refuse(*args, **kwargs):
        raise AssertionError("the plain paged version ran for a CUDA pool")

    monkeypatch.setattr(tpk, "paged_flash_attention_plain", refuse)
    cfg = _decode_cfg("bfloat16")
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=1),
                                  device="cuda", dtype="bfloat16")
    srv = ContinuousLMServer(cfg, params, slots=2, page_size=8,
                             prefill_chunk=16, speculate="model",
                             draft_len=4, device=None)
    try:
        before = tpk.paged_flash_attention.launches.value
        out = srv.generate(_decode_prompts()[0], 16, timeout=120)
        st = srv.stats()
    finally:
        srv.stop()
    assert len(out) == 36 + 16 and st["spec_drafted"] > 0
    assert (tpk.paged_flash_attention.launches.value - before
            == cfg.n_layers * st["dispatches"])


def test_self_drafting_on_the_card_accepts_every_draft():
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _decode_cfg("float32")
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=2),
                                  device="cuda")
    srv = ContinuousLMServer(cfg, params, slots=2, page_size=8,
                             prefill_chunk=4, speculate="model",
                             draft_len=3, device=None)
    try:
        for p in _decode_prompts()[:2]:
            srv.generate(p, 20, timeout=120)
        st = srv.stats()
    finally:
        srv.stop()
    assert st["spec_accepted"] == st["spec_drafted"] > 0


def test_dense_pool_on_the_card_matches_the_checker():
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _decode_cfg("float32")
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=3),
                                  device="cuda")
    srv = ContinuousLMServer(cfg, params, slots=3, kv="dense", device=None)
    prompts = _decode_prompts()
    try:
        before = tpk.paged_flash_attention.launches.value
        outs = [srv.generate(p, 16, timeout=120) for p in prompts]
        assert tpk.paged_flash_attention.launches.value == before
        assert srv.stats()["kv"] == {"mode": "dense"}
    finally:
        srv.stop()
    for prompt, seq in zip(prompts, outs):
        _check_greedy(cfg, params, prompt, seq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_prefill_launches_the_flash_forward_once_per_layer(dtype):
    """One causal forward prefills the prompt (n_layers launches of B2);
    the decode steps launch no hand kernel; greedy ids by the checker
    rule; top-k 1 takes a largest logit at every step (replayed through
    the same steps), which is greedy up to a bf16 tie."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from deeplearning4j_tpu_torch.parallel import generation as tgen

    cfg = _decode_cfg(dtype)
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=4),
                                  device="cuda", dtype=dtype)
    prompt = np.random.default_rng(5).integers(0, 512, (3, 50))
    flash0 = tk.flash_forward.launches.value
    paged0 = tpk.paged_flash_attention.launches.value
    out = tgen.generate(cfg, params, prompt, 20, device=None)
    assert tk.flash_forward.launches.value - flash0 == cfg.n_layers
    assert tpk.paged_flash_attention.launches.value == paged0
    assert out.device.type == "cuda" and out.shape == (3, 70)
    for b in range(3):
        _check_greedy(cfg, params, prompt[b].tolist(), out[b].tolist())
    k1 = tgen.generate(cfg, params, prompt, 20, temperature=2.0, seed=3,
                       top_k=1)
    with torch.no_grad():
        cache, logits = tgen._prefill(cfg, params, torch.tensor(
            prompt, device="cuda"))
        for t in range(20):
            tok = k1[:, 50 + t].long()
            assert bool((logits.gather(1, tok[:, None])[:, 0]
                         == logits.max(-1).values).all())
            logits, cache = tgen.decode_step(cfg, params, cache, tok)
    if dtype == "float32":
        assert k1.tolist() == out.tolist()


def test_beam_search_on_the_card_scores_its_teacher_forced_log_prob():
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from deeplearning4j_tpu_torch.parallel import generation as tgen

    cfg = _decode_cfg("float32")
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=5),
                                  device="cuda")
    prompt = np.random.default_rng(6).integers(0, 512, (2, 30))
    flash0 = tk.flash_forward.launches.value
    toks, scores = tgen.beam_search(cfg, params, prompt, 10, beam_size=4)
    assert tk.flash_forward.launches.value - flash0 == cfg.n_layers
    with torch.no_grad():
        logp = torch.log_softmax(tt._forward(cfg, params, toks.long(),
                                             tt.attention), dim=-1)
    for b in range(2):
        tf = sum(float(logp[b, t - 1, toks[b, t]]) for t in range(30, 40))
        assert abs(tf - float(scores[b])) <= 1e-3 * abs(tf)
    one, _ = tgen.beam_search(cfg, params, prompt, 10, beam_size=1)
    assert one.tolist() == tgen.generate(cfg, params, prompt, 10).tolist()


# ---------------------------------------------------------------------------
# flash attention

# (B, S, H, D): ragged tails (S not a multiple of the 64-row tile, S < 64,
# S = 1), head dims that are not a multiple of 16, the largest D
FLASH_CASES = {
    "s1": (1, 1, 2, 16), "s37_d80": (2, 37, 3, 80), "s64_d64": (2, 64, 2, 64),
    "s130_d16": (1, 130, 2, 16), "s200_d128": (1, 200, 2, 128),
    "s257_d40": (2, 257, 1, 40),
    # bf16 at a head dim that is not a multiple of 8 (the FMA route), and a
    # long causal sequence (32 query tiles issued longest first)
    "s70_d20": (1, 70, 2, 20), "s2048_d64": (1, 2048, 2, 64),
    # head dims above 128: the D-chunked route (two, two, four chunks; a
    # ragged last chunk at 136 and 192)
    "s100_d136": (1, 100, 2, 136), "s64_d192": (2, 64, 1, 192),
    "s130_d256": (1, 130, 2, 256), "s70_d512": (1, 70, 1, 512),
}


def _flash_inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to("cuda", dtype) for _ in range(4)]


def _rel(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(name, dtype, causal):
    """Forward, dK/dV and dQ kernels against the plain versions in f32 on
    the same inputs (the backward pair on the kernel's own lse and
    delta): relative max error 1e-4 in f32, 2e-2 in bf16 and f16 (the
    outputs' rounding; f16 runs on the FMA routes)."""
    _need_card()
    dt = getattr(torch, dtype)
    q, k, v, g = _flash_inputs(FLASH_CASES[name], dt)
    counters = (tk.flash_forward.launches, tk.flash_bwd_dkv.launches,
                tk.flash_bwd_dq.launches)
    before = [c.value for c in counters]
    out, lse = tk.flash_forward(q, k, v, causal)
    delta = tk.row_delta(g, out)
    dq, dk, dv = tk.flash_bwd_block(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    assert [c.value - b for c, b in zip(counters, before)] == [1, 1, 1]
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dt
    f32 = [x.float() for x in (q, k, v, g)]
    want_out, want_lse = tk.flash_forward_plain(*f32[:3], causal)
    want = tk.flash_bwd_block_plain(*f32, lse, delta, causal)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert _rel(lse, want_lse) <= 1e-5
    for got, ref in zip((out, dq, dk, dv), (want_out, *want)):
        if q.shape[1] == 1 and got is not out and got is not dv:
            # one key: softmax is constant, so dq and dk are exactly 0
            # and both sides hold rounding noise
            assert float(got.float().abs().max()) <= 1e-6
        else:
            assert _rel(got, ref) <= tol


def _bwd_bf16_rounded(q, k, v, g, lse, delta, causal):
    """The plain backward as the tensor cores take it: f32 products of the
    bf16 inputs with P and dS rounded to bf16 before their products
    (dV = P^T dO, dK = dS^T Q, dQ = dS K).  Tighter than the f32 plain
    version: a misplaced or dropped tile fails it."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    p = torch.exp(sc - lse.reshape(b, h, s, 1))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - delta.reshape(b, h, s, 1))).bfloat16().float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq, dk, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(n for n, c in FLASH_CASES.items()
                                        if c[3] % 8 == 0 and c[3] <= 128))
def test_flash_backward_tensor_cores_match_the_bf16_rounding_reference(
        name, causal):
    """bf16 dq, dk, dv on the tensor-core route against the plain backward
    with P and dS rounded as the kernels round them: relative max error
    5e-3 (the outputs' bf16 rounding and the f32 sums' order)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs(FLASH_CASES[name], torch.bfloat16, seed=2)
    out, lse = tk.flash_forward(q, k, v, causal)
    delta = tk.row_delta(g, out)
    dk, dv = tk.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    dq = tk.flash_bwd_dq(q, k, v, g, lse, delta, causal)
    assert tk.flash_route("dkv", q, k, v, g, dk, dv) == "tensor_cores"
    assert tk.flash_route("dq", q, k, v, g, dq) == "tensor_cores"
    want = _bwd_bf16_rounded(q, k, v, g, lse, delta, causal)
    for got, ref in zip((dq, dk, dv), want):
        if q.shape[1] == 1 and got is not dv:
            assert float(got.float().abs().max()) <= 1e-6   # exactly 0
        else:
            assert _rel(got, ref) <= 5e-3


def _misaligned(shape, dtype):
    """A contiguous card tensor whose data starts 2 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype, device="cuda")[1:n + 1].view(
        shape)


@pytest.mark.parametrize("dtype,d,aligned,fwd,bwd", [
    ("bfloat16", 64, True, "tensor_cores", "tensor_cores"),
    ("bfloat16", 40, True, "tensor_cores", "tensor_cores"),
    ("bfloat16", 128, True, "tensor_cores", "tensor_cores"),
    ("bfloat16", 20, True, "fma", "fma"),
    ("bfloat16", 64, False, "fma", "fma"),
    ("float32", 64, True, "fma", "fma"),
    ("bfloat16", 136, True, "tensor_cores", "fma_chunks"),
    ("bfloat16", 256, True, "tensor_cores", "fma_chunks"),
    ("bfloat16", 256, False, "fma_chunks", "fma_chunks"),
    ("float32", 512, True, "fma_chunks", "fma_chunks"),
    ("float16", 64, True, "fma", "fma"),
    ("float16", 128, True, "fma", "fma"),
    ("float16", 256, True, "fma_chunks", "fma_chunks")])
def test_flash_forward_route(dtype, d, aligned, fwd, bwd):
    """bf16 at a head dim that is a multiple of 8 with 16-byte aligned
    tensors runs on the tensor cores (the forward up to D 256, the
    backward up to 128), other head dims up to 128 on the FMA pipes and
    above 128 on the D-chunked FMA route: the forward, dK/dV and dQ
    entries agree with `flash_route_rule`."""
    _need_card()
    dt = getattr(torch, dtype)
    q, k, v, g = _flash_inputs((1, 8, 2, d), dt)
    if not aligned:
        g = _misaligned(g.shape, dt)
    outs = {"fwd": (torch.empty_like(q),),
            "dkv": (g, torch.empty_like(k), torch.empty_like(v)),
            "dq": (g, torch.empty_like(q))}
    if not aligned:
        outs["fwd"] = (_misaligned(q.shape, dt),)
    for kind, rest in outs.items():
        want = fwd if kind == "fwd" else bwd
        ptrs = [t.data_ptr() for t in (q, k, v, *rest)]
        assert tk.flash_route_rule(dt, d, ptrs, kind) == want, kind
        assert tk.flash_route(kind, q, k, v, *rest) == want, kind


def _smem_formula(kind, d, route):
    """Each route's shared memory per block, from its design: route 0
    the FMA pipes, 1 the tensor cores, 2 the D-chunked FMA route (128
    columns of d a block)."""
    if route == 1:
        tile = 64 * 64 * -(-d // 64) * 2                 # bf16, D padded
        return {"fwd": 5 * tile, "dkv": 6 * tile + 2 * 2 * 64 * 4,
                "dq": 6 * tile}[kind]
    ld = (128 if route == 2 else d) + 1                  # f32, padded rows
    return 4 * {"fwd": 3 * 64 * ld + 64 * 65,
                "dkv": 4 * 64 * ld + 2 * 64 * 65 + 128,
                "dq": 4 * 64 * ld + 64 * 65 + 128}[kind]


@pytest.mark.parametrize("kind", ["fwd", "dkv", "dq"])
def test_flash_smem_bytes_follow_the_route(kind):
    """`dl4j_flash_smem_bytes` reports the bytes of the route's kernel."""
    _need_card()
    lib = tk._lib()
    for d in (8, 16, 40, 64, 80, 128):
        for route in (0, 1):
            assert lib.dl4j_flash_smem_bytes(tk._KINDS[kind], d, route) == \
                _smem_formula(kind, d, route), (d, route)
    for d in (136, 256, 512):
        got = lib.dl4j_flash_smem_bytes(tk._KINDS[kind], d, 2)
        assert got == _smem_formula(kind, d, 2) <= 232448, d
    if kind == "fwd":
        for d in (136, 192, 256):
            got = lib.dl4j_flash_smem_bytes(0, d, 1)
            assert got == _smem_formula(kind, d, 1) <= 232448, d


@pytest.mark.parametrize("kind", ["fwd", "dkv", "dq"])
def test_flash_refused_tensor_core_launch_names_its_bytes(kind):
    """A bf16 launch the tensor-core entry refuses (65536 tiles, past the
    grid's y limit) raises RuntimeError naming that route's shared memory;
    nothing falls back to the FMA route and nothing is counted."""
    _need_card()
    s = 65535 * 64 + 1
    q = torch.zeros(1, s, 1, 8, dtype=torch.bfloat16, device="cuda")
    stats = torch.zeros(1, s, device="cuda")
    fn = {"fwd": lambda: tk.flash_forward(q, q, q, False),
          "dkv": lambda: tk.flash_bwd_dkv(q, q, q, q, stats, stats, False),
          "dq": lambda: tk.flash_bwd_dq(q, q, q, q, stats, stats, False)}
    counter = {"fwd": tk.flash_forward, "dkv": tk.flash_bwd_dkv,
               "dq": tk.flash_bwd_dq}[kind].launches
    before = counter.value
    with pytest.raises(RuntimeError,
                       match=f"tensor_cores route needs "
                             f"{_smem_formula(kind, 8, 1)} bytes"):
        fn[kind]()
    assert counter.value == before


def test_flash_attention_autograd_on_the_card_matches_plain_attention():
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs((2, 100, 3, 32), torch.float32, seed=1)
    grads = []
    for fn in (tk.flash_attention, tt.attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, True)
        grads.append((out, *torch.autograd.grad(out, leaves, g)))
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-4


def test_flash_refuses_what_the_kernels_do_not_take():
    """Checked before any launch: head dim above 512, float64, a
    non-contiguous view; nothing is counted."""
    _need_card()
    before = tk.flash_forward.launches.value
    big = torch.zeros(1, 8, 1, 513, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        tk.flash_forward(big, big, big)
    wide = torch.zeros(1, 8, 1, 16, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float16"):
        tk.flash_forward(wide, wide, wide)
    x = torch.zeros(1, 2, 8, 16, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tk.flash_forward(x, x, x)
    assert tk.flash_forward.launches.value == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_at_head_dim_256_trains_like_plain_attention(dtype):
    """A `TransformerConfig` with d_model / n_heads = 256 (Gemma's head
    dim): the f32 loss and every gradient through the kernels against the
    plain-attention forward (relative 1e-3, a key bias measured against
    the query bias's scale, as its exact gradient is zero); then one bf16
    accumulated train step through the kernels, finite, f32 masters."""
    _need_card()
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.tree import flatten_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tt.TransformerConfig(vocab_size=128, d_model=512, n_heads=2,
                               n_layers=2, d_ff=256, max_len=96,
                               attn_bias=True, tie_embeddings=True,
                               remat=True, dtype=dtype)
    assert cfg.d_model // cfg.n_heads == 256
    params = th._master_f32(tt.params_from_numpy(tt.numpy_params(cfg),
                                                 device="cuda"))
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.integers(0, 128, (2, 97))).cuda()
    tok, tgt = data[:, :-1], data[:, 1:]
    counters = (tk.flash_forward.launches, tk.flash_bwd_dkv.launches,
                tk.flash_bwd_dq.launches)
    if dtype == "float32":
        flat = flatten_tree(params)
        names, leaves = list(flat), list(flat.values())
        before = [c.value for c in counters]
        loss_k = tt.lm_loss(cfg, params, tok, tgt)
        grads_k = torch.autograd.grad(loss_k, leaves)
        assert all(c.value > b for c, b in zip(counters, before))
        logits = tt._forward(cfg, params, tok, tt.attention)
        loss_p = -F.log_softmax(logits, dim=-1).gather(
            -1, tgt[..., None])[..., 0].mean()
        grads_p = torch.autograd.grad(loss_p, leaves)
        scale = dict(zip(names, (float(g.abs().max()) for g in grads_p)))
        lk_, lp_ = float(loss_k.detach()), float(loss_p.detach())
        assert abs(lk_ - lp_) <= 1e-3 * abs(lp_)
        for name, gk, gp in zip(names, grads_k, grads_p):
            denom = scale[name.replace("//bk", "//bq")]
            assert float((gk - gp).abs().max()) <= 1e-3 * denom, name
        return
    step, init = th.make_accum_train_step(cfg, lr=1e-3, accum=2,
                                          updater="adam")
    state = init(params)
    before = [c.value for c in counters]
    params, state, loss = step(params, state, tok, tgt)
    per = cfg.n_layers * 2
    assert [c.value - b for c, b in zip(counters, before)] == \
        [2 * per, per, per]
    assert math.isfinite(float(loss))
    assert all(p.dtype == torch.float32 for p in params.values()
               if isinstance(p, torch.Tensor))


def test_train_step_on_the_card_launches_the_kernels():
    """Two accumulated microbatches with remat: per layer and microbatch
    two forward launches (the recompute) and one of each backward
    kernel; the f32 masters stay f32 and the loss falls."""
    _need_card()
    cfg = tt.TransformerConfig(vocab_size=128, d_model=64, n_heads=2,
                               n_layers=2, d_ff=128, max_len=80,
                               attn_bias=True, tie_embeddings=True,
                               remat=True, dtype="bfloat16")
    params = th._master_f32(tt.params_from_numpy(tt.numpy_params(cfg),
                                                 device="cuda"))
    step, init = th.make_accum_train_step(cfg, lr=1e-3, accum=2,
                                          updater="adam")
    state = init(params)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, 128, (4, 81))).cuda()
    counters = (tk.flash_forward.launches, tk.flash_bwd_dkv.launches,
                tk.flash_bwd_dq.launches)
    before = [c.value for c in counters]
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, data[:, :-1], data[:, 1:])
        losses.append(float(loss))
    per = cfg.n_layers * 2 * 3
    assert [c.value - b for c, b in zip(counters, before)] == \
        [2 * per, per, per]
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in params.values()
               if isinstance(p, torch.Tensor))


# ---------------------------------------------------------------------------
# the fused LSTM scan (kernel B5)

# (T, B, H): every odd size of T {1, 64, 200}, B {1, 32, 33} and
# H {8, 37, 256, 1024} at least once, the char-LSTM shape included
LSTM_CASES = {
    "t1_b1_h8": (1, 1, 8), "t64_b32_h256": (64, 32, 256),
    "t200_b33_h37": (200, 33, 37), "t64_b33_h1024": (64, 33, 1024),
    "t200_b1_h256": (200, 1, 256), "t1_b32_h1024": (1, 32, 1024),
    "t64_b1_h37": (64, 1, 37), "t200_b32_h8": (200, 32, 8),
}


def _lstm_inputs(t, b, h, dtype, seed=0, batch_major=False):
    """xz ~ N(0, 1), RW at the xavier scale of [H, 4H], peepholes
    ~ N(0, 0.2), on the card in `dtype`; xz as a [T, B, 4H] tensor or
    as the transposed view of a batch-major [B, T, 4H] one."""
    rng = np.random.default_rng(seed)

    def rand(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to("cuda", dtype)

    xz = (rand((b, t, 4 * h), 1.0).transpose(0, 1) if batch_major
          else rand((t, b, 4 * h), 1.0))
    rw = rand((h, 4 * h), (2.0 / (5 * h)) ** 0.5)
    return xz, rw, rand((h,), 0.2), rand((h,), 0.2), rand((h,), 0.2)


@pytest.mark.parametrize("batch_major", [False, True])
@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name", sorted(LSTM_CASES))
def test_lstm_kernel_matches_plain(name, dtype, residuals, batch_major):
    """hs, cs and zs of one launch against the plain version on the same
    inputs: relative max error 1e-5 in f32, 2e-2 in bf16 and f16 (hs's
    rounding; f16 on bf16's routes with the f16 product)."""
    _need_card()
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    args = _lstm_inputs(*LSTM_CASES[name], dt, batch_major=batch_major)
    before = lk.fused_lstm_forward.launches.value
    hs, cs, zs = lk.fused_lstm_forward(*args, save_residuals=residuals)
    torch.cuda.synchronize()
    assert lk.fused_lstm_forward.launches.value == before + 1
    want = lk.fused_lstm_forward_plain(*args, save_residuals=residuals)
    assert hs.dtype == dt and hs.shape == want[0].shape
    tol = 1e-5 if dt == torch.float32 else 2e-2
    assert _rel(hs, want[0]) <= tol
    if residuals:
        assert cs.dtype == zs.dtype == torch.float32
        assert _rel(cs, want[1]) <= tol and _rel(zs, want[2]) <= tol
    else:
        assert cs is None and zs is None


def _lstm_check(args, residuals, dt):
    """One launch of the kernel against the plain version on `args`."""
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    before = lk.fused_lstm_forward.launches.value
    got = lk.fused_lstm_forward(*args, save_residuals=residuals)
    torch.cuda.synchronize()
    assert lk.fused_lstm_forward.launches.value == before + 1
    want = lk.fused_lstm_forward_plain(*args, save_residuals=residuals)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    for a, w in zip(got, want):
        if w is not None:
            assert _rel(a, w) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_lstm_plan_matches_the_route_rule(dtype):
    """The C entry's plan (route, cluster size, units, blocks, threads,
    bytes, batch tile, launches, staging rows, lanes a pair, k-parts)
    equals `lstm_route_rule`, its Python mirror, at the route boundaries
    and past the wide route's old batch ceiling; a cluster plan fits the
    card at least once."""
    _need_card()
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    dt = getattr(torch, dtype)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for h in (1, 8, 37, 129, 256, 384, 385, 512, 513, 1024):
        for b in (1, 32, 33, 3040, 4096):
            got = lk.launch_plan(dt, b, h)
            assert got.pop("error") == 0, (h, b, got)
            active = got.pop("active_clusters")
            want = lk.lstm_route_rule(dt, b, h, n_sm=n_sm)
            want.pop("active_clusters")
            assert got == want, (h, b)
            assert (active >= 1) == (got["route"] == "cluster"), (h, b)


@pytest.mark.parametrize("dtype,h,route", [
    ("float32", 384, "cluster"), ("float32", 385, "wide"),
    ("bfloat16", 512, "cluster"), ("bfloat16", 513, "wide"),
    ("float16", 512, "cluster"), ("float16", 513, "wide")])
def test_lstm_routes_at_the_cluster_limit_match_plain(dtype, h, route):
    """H at the cluster route's limit and one past it: each takes its
    route and matches the plain version, with and without residuals."""
    _need_card()
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    assert lk.launch_plan(dt, 33, h)["route"] == route
    args = _lstm_inputs(20, 33, h, dt, seed=h, batch_major=True)
    for residuals in (False, True):
        _lstm_check(args, residuals, dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [3040, 4096])
def test_lstm_batch_past_the_old_ceiling_matches_plain(b, dtype):
    """B = 3040 and 4096 at H = 1024 (the first design's shared memory
    held c of every row and refused B > 3039): the wide route cuts the
    batch into slices, one cooperative launch each, still one counted
    launch a call."""
    _need_card()
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    plan = lk.launch_plan(dt, b, 1024)
    assert plan["route"] == "wide" and plan["launches"] >= 2
    assert plan["batch_tile"] * plan["launches"] >= b
    _lstm_check(_lstm_inputs(8, b, 1024, dt, seed=b), True, dt)


def test_graves_lstm_output_of_4096_sequences_runs_on_the_kernel():
    """`output()` of 4096 sequences through a 1024-unit Graves LSTM: one
    launch (no residuals), against the same net with the kernel's plain
    version in its place (relative 1e-4, f32)."""
    _need_card()
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.nn.layers import recurrent

    torch.backends.cuda.matmul.allow_tf32 = False
    conf = tconf.MultiLayerConfiguration(
        conf=tconf.NeuralNetConfiguration(seed=3),
        layers=(tconf.GravesLSTMConf(n_in=11, n_out=1024),
                tconf.RnnOutputLayerConf(n_in=1024, n_out=11)))
    net = MultiLayerNetwork(conf).init()
    ids = np.random.default_rng(0).integers(0, 11, (4096, 3))
    x = torch.from_numpy(np.eye(11, dtype=np.float32)[ids]).cuda()
    launches, residual = (lk.fused_lstm_forward.launches,
                          lk.fused_lstm_forward.residual_launches)
    before = (launches.value, residual.value)
    out = net.output(x)
    torch.cuda.synchronize()
    assert (launches.value - before[0], residual.value - before[1]) == (1, 0)
    recurrent.fused_lstm_scan = lk.fused_lstm_scan_plain
    try:
        want = net.output(x)
    finally:
        recurrent.fused_lstm_scan = lk.fused_lstm_scan
    assert out.shape == (4096, 3, 11) and torch.isfinite(out).all()
    assert _rel(out, want) <= 1e-4


@pytest.mark.parametrize("peephole", [True, False])
def test_lstm_kernel_gradients_match_plain(peephole):
    """f32 gradients through the kernel's autograd Function against
    autograd through the plain steps: relative 1e-4."""
    _need_card()
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    xz, rw, pi, pf, po = _lstm_inputs(64, 33, 37, torch.float32, seed=3)
    if not peephole:
        pi, pf, po = (torch.zeros_like(p) for p in (pi, pf, po))
    g = torch.randn(64, 33, 37, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    grads = []
    for fn in (lk.fused_lstm_scan, lk.fused_lstm_scan_plain):
        leaves = [a.clone().requires_grad_() for a in (xz, rw, pi, pf, po)]
        hs = fn(*leaves)
        grads.append((hs, *torch.autograd.grad(hs, leaves, g)))
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-4


def test_lstm_refuses_what_the_kernel_does_not_take():
    """Checked before any launch: H above the limit, float64, mixed
    dtypes, a parameter on another device, wrong shapes; nothing is
    counted."""
    _need_card()
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    before = lk.fused_lstm_forward.launches.value
    big = _lstm_inputs(2, 2, lk.MAX_HIDDEN + 1, torch.float32)
    with pytest.raises(ValueError, match=str(lk.MAX_HIDDEN)):
        lk.fused_lstm_forward(*big)
    xz, rw, pi, pf, po = _lstm_inputs(3, 2, 8, torch.float32)
    with pytest.raises(TypeError, match="float16"):
        lk.fused_lstm_forward(xz.double(), rw.double(), pi.double(),
                              pf.double(), po.double())
    with pytest.raises(TypeError, match="dtype"):
        lk.fused_lstm_forward(xz, rw.bfloat16(), pi, pf, po)
    with pytest.raises(ValueError, match="cpu"):
        lk.fused_lstm_forward(xz, rw.cpu(), pi, pf, po)
    with pytest.raises(ValueError, match="shape"):
        lk.fused_lstm_forward(xz, rw[:, :16].contiguous(), pi, pf, po)
    with pytest.raises(ValueError, match="4H"):
        lk.fused_lstm_forward(xz[..., :30], rw, pi, pf, po)
    assert lk.fused_lstm_forward.launches.value == before


def test_lstm_inference_forward_launches_once_without_residuals():
    _need_card()
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    args = [a.requires_grad_() for a in _lstm_inputs(5, 3, 8,
                                                     torch.float32)]
    before = lk.fused_lstm_forward.launches.value
    with torch.no_grad():
        hs = lk.fused_lstm_scan(*args)
    assert not hs.requires_grad
    assert lk.fused_lstm_forward.launches.value == before + 1


def test_char_lstm_network_on_the_card_launches_the_kernel():
    """A small char-LSTM in bf16 compute: one launch per LSTM layer and
    microbatch, all with residuals, while training; one launch without
    residuals per inference call; f32 masters and a falling loss."""
    _need_card()
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    net = MultiLayerNetwork(char_lstm(vocab_size=11, hidden=37,
                                      compute_dtype="bfloat16")).init()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 11, (6, 9))
    x = np.eye(11, dtype=np.float32)[ids]
    y = np.eye(11, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    launches, residual = (lk.fused_lstm_forward.launches,
                          lk.fused_lstm_forward.residual_launches)
    before = (launches.value, residual.value)
    losses = [net.fit_batch(x, y) for _ in range(4)]
    losses.append(net.fit_batch(x, y, accum_steps=2))
    assert (launches.value - before[0], residual.value - before[1]) == (6, 6)
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for _, p in net._param_leaves())
    out = net.output(x)
    assert out.shape == (6, 9, 11) and out.is_cuda
    assert (launches.value - before[0], residual.value - before[1]) == (7, 6)


@pytest.mark.parametrize("policy", ["mixed", "float16"])
def test_loss_scaled_char_lstm_steps_on_the_card(policy):
    """A small char-LSTM under a loss-scaled policy (bf16 "mixed", or
    float16 compute with loss scaling): B5 once a step in the compute
    dtype, f32 masters, a falling loss, the scaler's state on the card;
    a poison batch leaves the parameters and Adam's state bitwise as
    they were, halves the scale and counts one overflow, without a host
    read in the step."""
    _need_card()
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.precision import (
        LossScaleConfig,
        PrecisionPolicy,
    )
    from deeplearning4j_tpu_torch.tree import tree_leaves

    net = MultiLayerNetwork(char_lstm(vocab_size=11, hidden=37)).init()
    net.set_precision(policy if policy == "mixed" else PrecisionPolicy(
        "float32", "float16", loss_scale=LossScaleConfig()))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 11, (6, 9))
    x = np.eye(11, dtype=np.float32)[ids]
    y = np.eye(11, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    before = lk.fused_lstm_forward.launches.value
    losses = [net.fit_batch(x, y) for _ in range(4)]
    assert lk.fused_lstm_forward.launches.value - before == 4
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for _, p in net._param_leaves())
    assert net._scaler_state["scale"].is_cuda
    assert net.updater_state["step"].is_cuda
    snap = [t.detach().clone() for t in tree_leaves(net.params)
            + tree_leaves(net.updater_state)]
    x[2, 3, 0] = np.inf
    net.fit_batch(x, y)
    after = tree_leaves(net.params) + tree_leaves(net.updater_state)
    assert all(torch.equal(a, b) for a, b in zip(after, snap))
    stats = net.scaler_stats()
    assert stats["overflow_count"] == 1 and stats["scale"] == 2.0 ** 14


def test_chunked_fit_on_the_card_is_chunk_size_invariant():
    """float32 LeNet over 9 batches (a ragged tail): `fit(chunk_size=1)`
    and `fit(chunk_size=8)` give bitwise-equal parameters on the card
    (the im2col route and cuBLAS at fixed shapes); the int8 view of the
    trained net serves bucketed rows bitwise equal to the padded
    dispatch."""
    _need_card()
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, lenet_mnist
    from deeplearning4j_tpu_torch.precision import QuantizedNet
    from deeplearning4j_tpu_torch.serving import BucketLadder

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    x = rng.random((8 * 16 + 5, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, len(x))]
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, len(x), 16)]
    nets = []
    for chunk in (1, 8):
        net = MultiLayerNetwork(lenet_mnist(updater="sgd")).init()
        net.fit(batches, chunk_size=chunk)
        nets.append(net)
    assert nets[0].params_flat().tobytes() == nets[1].params_flat().tobytes()
    q = QuantizedNet(nets[0])
    ladder = BucketLadder((1, 8))
    got = q.output_bucketed(x[:5], ladder=ladder)
    padded = np.concatenate([x[:5], np.zeros((3, 28, 28, 1), np.float32)])
    assert got.tobytes() == q.output(padded).cpu().numpy()[:5].tobytes()
    assert q.forward_program_count() == 1


def test_wide_graves_lstm_on_the_card_takes_the_step_scan():
    """n_out above the kernel's width with ``fused=None``: forward and
    gradients run through the step-by-step scan (no kernel launch);
    ``fused=True`` at that width raises the ValueError that names the
    limit."""
    _need_card()
    import dataclasses

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    n = lk.MAX_HIDDEN + 76
    conf = tconf.MultiLayerConfiguration(
        conf=tconf.NeuralNetConfiguration(seed=5),
        layers=(tconf.GravesLSTMConf(n_in=11, n_out=n),
                tconf.RnnOutputLayerConf(n_in=n, n_out=11)))
    net = MultiLayerNetwork(conf).init()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 11, (2, 3))
    x = np.eye(11, dtype=np.float32)[ids]
    y = np.eye(11, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    before = lk.fused_lstm_forward.launches.value
    losses = [net.fit_batch(x, y) for _ in range(2)]
    out = net.output(x)
    assert lk.fused_lstm_forward.launches.value == before
    assert all(np.isfinite(losses)) and out.shape == (2, 3, 11)
    assert torch.isfinite(out).all()
    fused = dataclasses.replace(conf, layers=(
        dataclasses.replace(conf.layers[0], fused=True), conf.layers[1]))
    with pytest.raises(ValueError, match=str(lk.MAX_HIDDEN)):
        MultiLayerNetwork(fused).init().output(x)
    assert lk.fused_lstm_forward.launches.value == before


# ---- MultiLayerNetwork's conv nets and the train CLI (slice 8) -------------


@pytest.fixture
def no_tf32():
    """float32 convolutions and matmuls in full float32 (cuDNN and cuBLAS
    default to TF32 for convolutions)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@pytest.mark.parametrize("name,shape", [
    ("lenet-mnist", (8, 28, 28, 1)), ("alexnet-cifar10", (8, 32, 32, 3))])
def test_conv_net_gradients_on_the_card_match_the_cpu(name, shape, no_tf32):
    """f32 loss and every gradient on the card within 1e-4 relative max
    error of the port's CPU run on the same weights (AlexNet's dropout
    at 0)."""
    _need_card()
    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        get_model,
        params_from_numpy,
    )

    conf = get_model(name, **({"dropout": 0.0} if "alexnet" in name
                              else {}))
    rng = np.random.default_rng(0)
    x = rng.random(shape, dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, shape[0])]
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    card = MultiLayerNetwork(conf).init()
    card.params = params_from_numpy(card, cpu.params_flat())
    got = {}
    for key, net in (("cpu", cpu), ("card", card)):
        loss, _ = net._objective(net.params, net.state,
                                 torch.from_numpy(x).to(net.device),
                                 torch.from_numpy(y).to(net.device), None)
        got[key] = (loss.item(), [g[k] for g in net._grads(loss)
                                  for k in sorted(g)])
    assert got["card"][0] == pytest.approx(got["cpu"][0], rel=1e-4)
    for g, w in zip(got["card"][1], got["cpu"][1]):
        assert g.is_cuda
        err = (g.cpu() - w).abs().max() / w.abs().max().clamp(min=1e-30)
        assert err <= 1e-4


def _l2(got, want) -> float:
    g = torch.cat([t.double().ravel() for t in got])
    w = torch.cat([t.double().ravel() for t in want])
    return float((g - w).norm() / w.norm())


@pytest.mark.parametrize("name,shape", [
    ("lenet-mnist", (8, 28, 28, 1)), ("alexnet-cifar10", (8, 32, 32, 3))])
def test_conv_net_bf16_on_the_card_matches_the_cpu(name, shape):
    """bfloat16 compute (cuDNN's convolutions) against the port's CPU runs
    on the same weights: the loss within 1e-3 relative of the CPU's bf16
    loss, and the gradients (relative L2 norm over every leaf) no further
    from the CPU's float32 gradients than twice the CPU's bf16 gradients
    are.  Readings on an H100 (`chip_smoke.py` mln, PERF.md), LeNet /
    AlexNet: loss 2.4e-4 / 2.4e-5; gradients 0.0256 / 0.100 from f32
    against the CPU's 0.0255 / 0.0962."""
    _need_card()
    import dataclasses

    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        get_model,
        params_from_numpy,
    )

    conf = get_model(name, compute_dtype="bfloat16",
                     **({"dropout": 0.0} if "alexnet" in name else {}))
    f32 = dataclasses.replace(conf, conf=dataclasses.replace(
        conf.conf, compute_dtype="float32"))
    rng = np.random.default_rng(0)
    x = rng.random(shape, dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, shape[0])]
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    nets = {"cpu": cpu, "card": MultiLayerNetwork(conf).init(),
            "f32": MultiLayerNetwork(f32, device="cpu").init()}
    got = {}
    for key, net in nets.items():
        net.params = params_from_numpy(net, cpu.params_flat())
        loss, _ = net._objective(net.params, net.state,
                                 torch.from_numpy(x).to(net.device),
                                 torch.from_numpy(y).to(net.device), None)
        got[key] = (loss.item(), [g[k].float().cpu() for g in
                                  net._grads(loss) for k in sorted(g)])
    assert got["card"][0] == pytest.approx(got["cpu"][0], rel=1e-3)
    assert _l2(got["card"][1], got["f32"][1]) <= 2 * _l2(got["cpu"][1],
                                                         got["f32"][1])


@pytest.mark.parametrize("kind", ["conv", "conv_bf16", "max", "avg", "sum"])
def test_same_stride_2_conv_and_pool_on_the_card_match_the_cpu(kind,
                                                               no_tf32):
    """SAME padding at stride 2 (the extra row and column after) on odd
    sizes: the card's route (float32 convolution: im2col and one matmul;
    bf16 convolution and the pooling: cuDNN) against the CPU's
    (`F.conv2d` and the pooling ops)."""
    _need_card()
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.layers import convolution as tconv

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 7, 3)).astype(
        np.float32))
    if kind.startswith("conv"):
        dtype = torch.bfloat16 if kind == "conv_bf16" else torch.float32
        lc = tconf.ConvolutionLayerConf(n_in=3, n_out=5, kernel_size=(3, 3),
                                        stride=(2, 2), padding="SAME",
                                        activation="identity")
        p = {"W": torch.from_numpy(rng.standard_normal(
                 (3, 3, 3, 5)).astype(np.float32)).to(dtype),
             "b": torch.linspace(-1, 1, 5).to(dtype)}
        x = x.to(dtype)
        want, _ = tconv.conv_apply(lc, p, {}, x)
        got, _ = tconv.conv_apply(lc, {k: v.cuda() for k, v in p.items()},
                                  {}, x.cuda())
    else:
        lc = tconf.SubsamplingLayerConf(pooling_type=kind,
                                        kernel_size=(3, 3), stride=(2, 2),
                                        padding="SAME")
        want, _ = tconv.pool_apply(lc, {}, {}, x)
        got, _ = tconv.pool_apply(lc, {}, {}, x.cuda())
    assert got.is_cuda and tuple(got.shape) == (2, 5, 4, want.shape[-1])
    if kind == "conv_bf16":      # assert_close's own bf16 tolerances
        torch.testing.assert_close(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


def test_train_test_predict_cli_on_the_card(tmp_path):
    """`train` / `test` / `predict` on the card (the default device): exit
    codes 0, the examples/sec line, training accuracy >= 0.9 on a
    separable CSV, and predictions equal to the saved model's."""
    _need_card()
    import contextlib
    import io
    import re

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.runtime.checkpoint import load_model

    rng = np.random.default_rng(0)
    labels = np.arange(150) % 3
    x = (rng.standard_normal((150, 4)) * 0.3 + labels[:, None] * 2.0).astype(
        np.float32)
    csv = tmp_path / "iris.csv"
    np.savetxt(csv, np.column_stack([x, labels]), delimiter=",", fmt="%.5f")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["train", "-input", str(csv), "-model",
                         "zoo:iris-mlp", "-output", str(tmp_path / "run"),
                         "-epochs", "20"]) == 0
        assert cli.main(["test", "-input", str(csv), "-model",
                         str(tmp_path / "run" / "model")]) == 0
        assert cli.main(["predict", "-input", str(csv), "-model",
                         str(tmp_path / "run" / "model"), "-output",
                         str(tmp_path / "preds.txt")]) == 0
    text = out.getvalue()
    assert re.search(r"Trained 20 epochs on 150 examples \([\d.]+ "
                     r"examples/sec\)", text)
    assert float(re.search(r"Accuracy:\s+([\d.]+)", text).group(1)) >= 0.9
    net = load_model(tmp_path / "run" / "model")
    assert net.device.type == "cuda"
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "preds.txt", dtype=int), net.predict(x))


@pytest.mark.parametrize("name", ["lenet-mnist", "lenet-digits",
                                  "alexnet-cifar10", "dbn-mnist",
                                  "deep-autoencoder"])
def test_conv_and_pretrain_zoo_models_train_on_the_card(name):
    """Each zoo model of slice 8 builds on the card by default and trains
    (the DBN and the deep autoencoder pretrain first): finite losses,
    parameters on the card, f32 masters."""
    _need_card()
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, get_model

    shape = {"lenet-mnist": (16, 28, 28, 1), "lenet-digits": (16, 8, 8, 1),
             "alexnet-cifar10": (16, 32, 32, 3)}.get(name, (16, 784))
    rng = np.random.default_rng(2)
    x = (rng.random(shape) > 0.5).astype(np.float32)
    y = (x if name == "deep-autoencoder"
         else np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)])
    net = MultiLayerNetwork(get_model(name)).init()
    assert net.device.type == "cuda"
    net.fit([(x[:8], y[:8]), (x[8:], y[8:])], epochs=2)
    loss = net.score(x, y)
    assert math.isfinite(loss)
    assert all(p.is_cuda and p.dtype == torch.float32
               for _, p in net._param_leaves())
    assert bool(net.pretrain_errors) == (name in ("dbn-mnist",
                                                  "deep-autoencoder"))
    assert net.output(x).shape == y.shape


# ---------------------------------------------------------------------------
# MoE layers and KV page mobility on the card


def _moe_layer(seed, d=64, f=128, e=4):
    gen = torch.Generator().manual_seed(seed)

    def t(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    return {"gate": t(d, e, scale=d ** -0.5),
            "w1": t(e, d, f, scale=d ** -0.5),
            "b1": t(e, f, scale=0.1), "w2": t(e, f, d, scale=f ** -0.5),
            "b2": t(e, d, scale=0.1)}


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_dispatch_without_drops_equals_dense_on_the_card(top_k):
    """Capacity factor E drops nothing, so dispatch (an accumulated
    scatter into the capacity buffers, atomic on the card) equals the
    dense-masked oracle; and the card's dispatch equals the CPU's."""
    _need_card()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = _moe_layer(top_k)
        x = torch.randn((2, 256, 64), generator=torch.Generator()
                        .manual_seed(9)).cuda()
        dense = tt._moe_dense(p, x, top_k)
        disp = tt._moe_dispatch(p, x, 4.0, top_k)
        assert float((disp - dense).abs().max() / dense.abs().max()) <= 1e-5
        cpu = tt._moe_dispatch({k: v.cpu() for k, v in p.items()}, x.cpu(),
                               1.25, top_k)
        got = tt._moe_dispatch(p, x, 1.25, top_k).cpu()
        assert float((got - cpu).abs().max() / cpu.abs().max()) <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_page_gather_and_install_round_trip_bitwise_on_the_card():
    _need_card()
    from deeplearning4j_tpu_torch.parallel import generation as tgen

    cfg = tt.TransformerConfig(vocab_size=64, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_len=64,
                               dtype="bfloat16")
    pages, ps = 20, 8
    mp = tgen.pages_per_seq(cfg, ps)
    src = tgen.init_paged_cache(cfg, pages, ps, device="cuda")
    src["k"].normal_()
    src["v"].normal_()
    row = np.zeros(mp, np.int32)
    row[:4] = [3, 17, 5, 11]
    pk, pv = tgen.make_page_gather(cfg, pages, ps)(src["k"], src["v"], row)
    host_k, host_v = pk[:, :4].cpu(), pv[:, :4].cpu()
    dst = tgen.init_paged_cache(cfg, pages, ps, device="cuda")
    target = np.zeros(mp, np.int32)
    target[:4] = [2, 9, 14, 19]
    k, v = tgen.make_page_install(cfg, pages, ps)(
        dst["k"], dst["v"], host_k, host_v, target, 3)
    for s, t in zip((3, 17, 5), (2, 9, 14)):
        assert torch.equal(k[:, t], src["k"][:, s])
        assert torch.equal(v[:, t], src["v"][:, s])
    assert float(k[:, 19].float().abs().max()) == 0   # row 3 went to page 0


def test_a_shipped_lane_decodes_on_the_card_like_a_local_one():
    """Prefill on one pool, ship through the wire frame, decode on
    another: the ids equal the same request decoded on the decode pool
    (float32, TF32 off), and both ledgers balance."""
    _need_card()
    from deeplearning4j_tpu_torch.serving.transfer import (
        deserialize_export,
        serialize_export,
    )

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tt.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_len=128)
    tree = tt.numpy_params(cfg, seed=0)
    kw = dict(slots=2, page_size=16, prefill_chunk=16, ship=True,
              device="cuda")
    pre = ContinuousLMServer(cfg, tree, **kw)
    dec = ContinuousLMServer(cfg, tree, **kw)
    try:
        prompt = list(np.random.default_rng(3).integers(0, 256, 40))
        ex = pre.prefill_export(prompt, 16, timeout=300)
        assert ex.pages_k.device.type == "cpu" and ex.n_pages == 3
        got = dec.admit_with_pages(deserialize_export(serialize_export(ex)),
                                   timeout=300)
        local = dec.generate(prompt, 16, timeout=300)
        assert got == local
        assert pre.page_ledger()["balanced"] and dec.page_ledger()[
            "balanced"]
    finally:
        pre.stop()
        dec.stop()
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_a_bf16_frame_from_the_card_is_raw_bf16_words():
    """A bfloat16 frame carries the pool's pages as their 2-byte words
    under the header name "bfloat16" (what the JAX package reads through
    ml_dtypes), and reads back bit for bit."""
    _need_card()
    import json
    import struct

    from deeplearning4j_tpu_torch.serving.transfer import (
        MAGIC,
        deserialize_export,
        serialize_export,
    )

    cfg = tt.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_len=128,
                               dtype="bfloat16")
    srv = ContinuousLMServer(cfg, tt.numpy_params(cfg, seed=1), slots=2,
                             page_size=16, prefill_chunk=16, ship=True,
                             device="cuda")
    try:
        ex = srv.prefill_export(list(range(1, 30)), 4, timeout=300)
    finally:
        srv.stop()
    blob = serialize_export(ex)
    (hlen,) = struct.unpack(">I", blob[len(MAGIC):len(MAGIC) + 4])
    header = json.loads(blob[len(MAGIC) + 4:len(MAGIC) + 4 + hlen])
    assert header["dtype"] == "bfloat16" and header["version"] == 1
    payload = blob[len(MAGIC) + 4 + hlen:]
    words = ex.pages_k.contiguous().view(torch.int16).numpy().tobytes()
    assert payload[:len(words)] == words
    assert len(payload) == 2 * ex.pages_k.numel() * 2
    back = deserialize_export(blob)
    assert back.pages_k.dtype == torch.bfloat16
    assert torch.equal(back.pages_v, ex.pages_v)


# ---------------------------------------------------------------------------
# the word-embedding family (no hand kernel: gathers and index_add_)

TOPICS = (["apple", "banana", "cherry", "mango", "grape"],
          ["cpu", "gpu", "ram", "disk", "cache"])


def _topic_corpus(n=600, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(TOPICS[i % 2], size=6)) for i in range(n)]


def _nlp_rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _w2v_step_inputs(negative, seed=0):
    """Tables and a batch at the bench's width (D 128, B 4096) over a
    2000-word zipf vocabulary: duplicate rows throughout, and for HS a pair
    whose dot saturates."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    rng = np.random.default_rng(seed)
    v, d, b = 2000, 128, 4096
    p = 1.0 / np.arange(1, v + 1)
    words = [f"w{i}" for i in rng.choice(v, 60_000, p=p / p.sum())]
    w = Word2Vec(vector_length=d, negative=negative, device="cpu")
    w.build_vocab([words])
    w.reset_weights()
    nv = len(w.vocab)
    syn0 = rng.standard_normal((nv, d)).astype(np.float32) * 0.1
    out = rng.standard_normal((nv if negative else nv - 1, d)).astype(
        np.float32) * 0.1
    inputs = rng.choice(nv, b, p=p[:nv] / p[:nv].sum())
    targets = rng.choice(nv, b, p=p[:nv] / p[:nv].sum())
    if not negative:
        points, _, lengths = w.vocab.hs_arrays()
        syn0[inputs[0]] = 1.0
        out[points[targets[0], :lengths[targets[0]]]] = 1.0
    valid = np.ones(b, np.float32)
    valid[-100:] = 0.0
    return w, syn0, out, inputs, targets, valid


@pytest.mark.parametrize("negative", [0, 5])
def test_w2v_step_on_the_card_matches_the_cpu(negative):
    _need_card()
    from deeplearning4j_tpu_torch.nlp import word2vec as tw

    w, syn0, out, inputs, targets, valid = _w2v_step_inputs(negative)
    gen = torch.Generator().manual_seed(0)
    negs = (w._neg_table[torch.randint(0, w._neg_table.shape[0],
                                       (len(inputs), negative),
                                       generator=gen)]
            if negative else None)
    res = {}
    for dev in ("cpu", "cuda"):
        t0 = torch.tensor(syn0, device=dev)
        t1 = torch.tensor(out, device=dev)
        i, t = (torch.tensor(a, device=dev) for a in (inputs, targets))
        v = torch.tensor(valid, device=dev)
        if negative:
            loss = tw.neg_step(t0, t1, i, t, negs.to(dev), 0.025, v)
        else:
            hs = tuple(a.to(dev) for a in w._hs)
            loss = tw.hs_step(t0, t1, hs, i, t, 0.025, v)
        res[dev] = (loss, t0, t1)
    for a, b in zip(res["cuda"], res["cpu"]):
        assert _nlp_rel(a, b) <= 1e-5


def test_glove_step_on_the_card_matches_the_cpu():
    _need_card()
    from deeplearning4j_tpu_torch.nlp.glove import glove_step

    rng = np.random.default_rng(1)
    v, d, b = 2000, 128, 4096
    params = [rng.standard_normal((v, d)).astype(np.float32) * 0.1,
              rng.standard_normal((v, d)).astype(np.float32) * 0.1,
              rng.standard_normal(v).astype(np.float32) * 0.1,
              rng.standard_normal(v).astype(np.float32) * 0.1]
    ada = [rng.random(np.shape(p)).astype(np.float32) for p in params]
    ii = rng.integers(0, 200, b)              # many duplicate rows
    jj = rng.integers(0, v, b)
    xx = rng.random(b).astype(np.float32) * 50 + 0.5
    valid = np.ones(b, np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        tp = tuple(torch.tensor(a, device=dev) for a in params)
        th = tuple(torch.tensor(a, device=dev) for a in ada)
        loss = glove_step(tp, th, torch.tensor(ii, device=dev),
                          torch.tensor(jj, device=dev),
                          torch.tensor(xx, device=dev),
                          torch.tensor(valid, device=dev), 0.05, 100.0, 0.75)
        res[dev] = (loss,) + tp + th
    for a, b in zip(res["cuda"], res["cpu"]):
        assert _nlp_rel(a, b) <= 1e-5


@pytest.mark.parametrize("negative", [0, 5])
def test_word2vec_on_the_card_separates_topics(negative):
    _need_card()
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w2v = Word2Vec(vector_length=24, window=3, epochs=5, seed=1,
                   negative=negative, batch_size=512, learning_rate=0.025)
    assert w2v.device.type == "cuda"
    w2v.fit(_topic_corpus())
    assert isinstance(w2v.syn0, np.ndarray)
    assert w2v.similarity("apple", "banana") > \
        w2v.similarity("apple", "gpu") + 0.2
    assert set(w2v.words_nearest("cpu", 4)) <= set(TOPICS[1]) - {"cpu"}


# ---- the operations plane on the card: SSE, the breaker, tenancy ------------


def _ops_pool(**kw):
    cfg = tt.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_len=128)
    tree = tt.numpy_params(cfg, seed=0)
    return cfg, ContinuousLMServer(cfg, tree, slots=4, page_size=16,
                                   prefill_chunk=16, device="cuda", **kw)


def test_sse_stream_on_the_card_equals_generate():
    """`stream: true` over HTTP on the card: the concatenated tokens
    equal the ``done`` event's ids and the non-streamed answer, and the
    paged kernel ran for both widths."""
    _need_card()
    import json
    import urllib.request

    from deeplearning4j_tpu_torch.ui.server import UiServer

    cfg = tt.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_len=128)
    ui = UiServer(port=0).serve_lm(cfg, tt.numpy_params(cfg, seed=0),
                                   slots=4, page_size=16, prefill_chunk=16,
                                   device="cuda").start()
    try:
        prompt = [int(t) for t in
                  np.random.default_rng(4).integers(0, 256, 40)]
        tpk.paged_flash_attention.launches.reset()
        req = urllib.request.Request(
            ui.url + "/lm/generate",
            data=json.dumps({"prompt_ids": prompt, "max_new_tokens": 12,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Id": "card-sse"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            assert r.headers["X-Request-Id"] == "card-sse"
            events = [e for e in r.read().decode().split("\n\n") if e]
        assert not any(e.startswith("event: error") for e in events)
        toks = [json.loads(e[len("data: "):])["token"] for e in events[:-1]]
        done = json.loads(events[-1].split("data: ", 1)[1])["ids"]
        assert done == prompt + toks and len(toks) == 12
        assert ui.state.lm_server.generate(prompt, 12, timeout=300) == done
        widths = tpk.paged_flash_attention.launches.by_key()
        assert widths.get(1, 0) > 0 and widths.get(16, 0) > 0
        (tr,) = ui.tracer.find("card-sse")
        assert [s["name"] for s in tr["spans"]] == ["queue_wait", "decode"]
    finally:
        ui.stop()


def test_breaker_on_the_card_opens_and_recovers():
    """Three failed dispatches on the card open the breaker; admission
    then fails fast without a dispatch; after the cooldown a probe on
    the card closes it, with the pool's pages balanced throughout."""
    _need_card()
    from deeplearning4j_tpu_torch.serving.resilience import (
        CircuitBreaker,
        CircuitOpenError,
    )

    now = [0.0]
    br = CircuitBreaker(failure_threshold=3, cooldown_s=1.0,
                        clock=lambda: now[0])
    cfg, srv = _ops_pool(breaker=br)
    try:
        srv.warmup()
        want = srv.generate([1, 2, 3], 6, timeout=300)
        real, fail = srv._step, [3]

        def step(*args):
            if fail[0] > 0:
                fail[0] -= 1
                raise RuntimeError("injected dispatch fault")
            return real(*args)

        srv._step = step
        for _ in range(3):
            with pytest.raises(RuntimeError, match="injected"):
                srv.generate([1, 2, 3], 6, timeout=300)
        assert br.state == "open" and not srv.ready()
        with pytest.raises(CircuitOpenError):
            srv.generate([1, 2, 3], 6, timeout=300)
        now[0] = 1.0
        assert srv.generate([1, 2, 3], 6, timeout=300) == want
        assert br.state == "closed" and srv.ready()
        assert srv.stats()["breaker_opens"] == 1
        assert srv.page_ledger()["balanced"]
    finally:
        srv.stop()


def test_tenant_ledger_on_the_card_balances():
    """Two tenants through one pool on the card, one of them throttled:
    admitted + throttled = sent, the per-tenant served counts re-add to
    the plane's, and the pages balance."""
    _need_card()
    import threading

    from deeplearning4j_tpu_torch.serving.tenancy import TenantQuotaError

    cfg, srv = _ops_pool(tenants={"a": {"weight": 4, "slo_ms": 250},
                                  "b": {"rate": 50, "burst": 100}})
    outcomes = {"a": [], "b": []}
    lock = threading.Lock()

    def run(tenant, i):
        prompt = [1 + i, 2, 3, 4]
        try:
            srv.generate(prompt, 16, tenant=tenant, timeout=300)
            kind = "ok"
        except TenantQuotaError:
            kind = "429"
        with lock:
            outcomes[tenant].append(kind)

    try:
        srv.warmup()
        threads = [threading.Thread(target=run, args=(t, i))
                   for i in range(8) for t in ("a", "b")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        st = srv.stats()
        assert outcomes["a"] == ["ok"] * 8
        led = st["tenancy"]["b"]
        assert led["admitted"] + led["throttled"] == 8
        assert led["throttled"] == outcomes["b"].count("429") >= 1
        assert sum(v.get("requests", 0) for v in st["tenants"].values()) \
            == st["requests"] == 8 + led["admitted"]
        assert srv.page_ledger()["balanced"]
    finally:
        srv.stop()


def test_engine_over_the_char_lstm_launches_b5_once_a_dispatch():
    """The `ServingEngine` over a bf16 char-LSTM on a ladder without
    length buckets: no mask, so every dispatch (and each warmup bucket)
    runs the fused scan, one kernel launch each; replies within 2e-2 of
    the f32 net on the same weights."""
    _need_card()
    import threading

    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        char_lstm,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.serving import BucketLadder, ServingEngine

    net = MultiLayerNetwork(char_lstm(vocab_size=20, hidden=64,
                                      compute_dtype="bfloat16")).init()
    ref = MultiLayerNetwork(char_lstm(vocab_size=20, hidden=64)).init()
    ref.params = params_from_numpy(ref, [
        {k: v.detach().float().cpu().numpy() for k, v in layer.items()}
        for layer in net.params])
    eye = np.eye(20, dtype=np.float32)
    rng = np.random.default_rng(2)
    reqs = [eye[rng.integers(0, 20, (int(rng.integers(1, 5)), 16))]
            for _ in range(12)]
    engine = ServingEngine(net, ladder=BucketLadder((1, 8, 16)),
                           max_batch=16)
    try:
        lk.fused_lstm_forward.launches.reset()
        assert engine.warmup(np.zeros((16, 20), np.float32)) == 3
        out = [None] * len(reqs)

        def client(i):
            out[i] = engine.predict_proba(reqs[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        torch.cuda.synchronize()
        stats = engine.stats()
        assert lk.fused_lstm_forward.launches.value == \
            stats["dispatches"] + 3
    finally:
        engine.stop()
    for x, got in zip(reqs, out):
        want = ref.output(x).float().cpu().numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-2


def test_lm_fleet_on_the_card_launches_b1_by_width():
    """Two thread-hosted replicas of one LM on the card behind a
    `FleetRouter`: concurrent greedy requests equal `generate`, and the
    paged kernel ran n_layers times a dispatch at each width, summed over
    both replicas' pools."""
    _need_card()
    import threading

    from deeplearning4j_tpu_torch.parallel.generation import generate
    from deeplearning4j_tpu_torch.serving import (
        FleetRouter,
        spawn_local_replica,
    )

    cfg = tt.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_len=128)
    params = tt.params_from_numpy(tt.numpy_params(cfg, seed=0),
                                  device="cuda")
    router = FleetRouter(lambda n: spawn_local_replica(
        n, lm=(cfg, params), lm_slots=4, lm_page_size=16,
        lm_prefill_chunk=16, device="cuda"), replicas=2)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, 256, int(n))]
               for n in rng.integers(10, 40, 6)]
    pools = [r.server.state.lm_server for r in router.replicas()]
    try:
        before = [dict(p.stats()["dispatch_widths"]) for p in pools]
        torch.cuda.synchronize()
        tpk.paged_flash_attention.launches.reset()
        out = [None] * len(prompts)

        def client(i):
            out[i] = router.generate(prompts[i], 8, timeout=300)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        torch.cuda.synchronize()
        want = {}
        for p, w0 in zip(pools, before):
            for w, n in p.stats()["dispatch_widths"].items():
                want[w] = want.get(w, 0) + cfg.n_layers * (n - w0.get(w, 0))
        got = {str(c): n for c, n in
               tpk.paged_flash_attention.launches.by_key().items()}
        assert got == {w: n for w, n in want.items() if n} and got
        for p, ids in zip(prompts, out):
            assert ids == generate(cfg, params, [p], 8,
                                   device="cuda")[0].tolist()
    finally:
        router.stop()


def test_supervised_char_lstm_resume_on_the_card_equals_uninterrupted(
        tmp_path):
    """The resilience plane on the card: a supervised char-LSTM (B5 every
    step) preempted mid-stream and resumed by a fresh net from the
    emergency checkpoint ends equal (bitwise, else within 1e-6 relative
    a leaf) to an uninterrupted supervised run on the same batches."""
    _need_card()
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.resilience import (
        ChaosConfig,
        ChaosDataSource,
        ResilienceConfig,
        TrainingSupervisor,
    )
    from deeplearning4j_tpu_torch.tree import flatten_tree

    rng = np.random.default_rng(0)
    eye = np.eye(80, dtype=np.float32)
    batches = []
    for _ in range(10):
        ids = rng.integers(0, 80, (8, 32))
        batches.append((eye[ids], eye[np.roll(ids, -1, axis=1)]))

    def net():
        return MultiLayerNetwork(char_lstm(
            hidden=128, compute_dtype="bfloat16"), device="cuda").init()

    def cfg(d):
        return ResilienceConfig(checkpoint_dir=tmp_path / d,
                                checkpoint_every=3)

    ref = net()
    TrainingSupervisor(ref, cfg("ref")).run(
        ChaosDataSource(batches, ChaosConfig()))
    src = ChaosDataSource(batches, ChaosConfig(preempt_at=6))
    lk.fused_lstm_forward.launches.reset()
    first = TrainingSupervisor(net(), cfg("run")).run(src)
    assert first.preempted and first.steps == 6
    resumed = net()
    sup = TrainingSupervisor(resumed, cfg("run"))
    assert sup.resume() and sup.step == 6
    assert sup.run(src).steps == 10
    torch.cuda.synchronize()
    assert lk.fused_lstm_forward.launches.value == 10
    got, want = flatten_tree(resumed.params), flatten_tree(ref.params)
    for k in want:
        if not torch.equal(got[k], want[k]):
            rel = float((got[k] - want[k]).abs().max()
                        / want[k].abs().max().clamp_min(1e-30))
            assert rel <= 1e-6, (k, rel)


def test_fleet_supervisor_kill_and_readmit_beside_a_card_replica():
    """Two supervised stub worker processes and one thread-hosted replica
    serving iris-mlp on the card behind one front: a SIGKILL of a worker
    mid-storm costs no request, and the worker comes back."""
    _need_card()
    import json
    import os
    import signal
    import socket
    import threading
    import time
    import urllib.request

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, iris_mlp
    from deeplearning4j_tpu_torch.serving import (
        BucketLadder,
        FleetRouter,
        FleetServer,
        spawn_local_replica,
    )
    from deeplearning4j_tpu_torch.serving.procfleet import (
        FleetSupervisor,
        RestartPolicy,
        WorkerSpec,
        stub_worker_command,
    )

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    router = FleetRouter(request_timeout_s=60.0)
    router.attach(spawn_local_replica(
        "card-0", MultiLayerNetwork(iris_mlp(), device="cuda").init(),
        ladder=BucketLadder((1, 8))))
    sup = FleetSupervisor(router, policy=RestartPolicy(
        backoff_initial_s=0.05, jitter=0.0), poll_interval_s=0.05,
        probe_timeout_s=0.5, wedge_threshold=2)
    front = FleetServer(router, port=0).start()
    failed = []
    try:
        for i in range(2):
            port = free_port()
            sup.manage(WorkerSpec(f"stub-{i}", f"http://127.0.0.1:{port}",
                                  command=stub_worker_command(port)))
        assert sup.wait_all_ready(30.0)
        sup.start()

        def client():
            for _ in range(20):
                req = urllib.request.Request(
                    front.url + "/model/predict",
                    data=json.dumps({"features": [[0.1] * 4]}).encode(),
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        assert r.status == 200
                except Exception as e:  # noqa: BLE001 — the test counts failures
                    failed.append(repr(e))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        os.kill(sup.workers["stub-0"].proc.pid, signal.SIGKILL)
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads) and failed == []
        deadline = time.monotonic() + 30
        while not (sup.counters["restarts"] == 1 and
                   sup.stats()["workers"]["stub-0"]["state"] == "ready"):
            assert time.monotonic() < deadline, sup.stats()
            time.sleep(0.05)
        assert sup.stats()["counters"]["deaths_crash"] == 1
        assert sorted(r.name for r in router.replicas()) == \
            ["card-0", "stub-0#1", "stub-1"]
    finally:
        sup.stop(grace_s=5.0)
        front.stop()


# -- slice 15: the tree models, the tagger and KMeans (no hand kernel) ---


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _rel_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("t,s", [(1, 5), (64, 45), (200, 12)])
def test_viterbi_on_the_card_matches_the_cpu(t, s):
    _need_card()
    from deeplearning4j_tpu_torch.utils import Viterbi

    rng = np.random.default_rng(t)
    emit = np.log(rng.dirichlet(np.ones(s), size=t))
    trans = np.log(rng.dirichlet(np.ones(s) * 0.5, size=s))
    init = np.log(rng.dirichlet(np.ones(s)))
    card = Viterbi(trans, init, log_space=True, device="cuda")
    assert card.log_trans.is_cuda
    got = card.decode(emit, log_space=True)
    want = Viterbi(trans, init, log_space=True, device="cpu").decode(
        emit, log_space=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert abs(got[1] - want[1]) <= 1e-5 * abs(want[1])


def test_tagger_and_parser_on_the_card_match_the_cpu():
    _need_card()
    from deeplearning4j_tpu_torch.nlp import default_tagger, sentiment_trees
    from deeplearning4j_tpu_torch.nlp.annotators import seed_corpus

    card, cpu = default_tagger("cuda"), default_tagger("cpu")
    for sent in seed_corpus():
        toks = [w for w, _ in sent]
        assert card.tag(toks) == cpu.tag(toks)

    def shape(tree):
        return (tree.label, tree.word, tuple(shape(c) for c in tree.children))
    assert ([shape(t) for t in sentiment_trees(device="cuda")]
            == [shape(t) for t in sentiment_trees(device="cpu")])


def _review_trees():
    from deeplearning4j_tpu_torch.nlp import sentiment_trees

    return sentiment_trees(device="cpu")


def test_rntn_gradients_on_the_card_match_the_cpu(no_tf32):
    _need_card()
    from deeplearning4j_tpu_torch.models import rntn
    from deeplearning4j_tpu_torch.nlp import compile_trees

    trees = _review_trees()
    model = rntn.RNTN(num_classes=2, d=16, seed=0, device="cpu")
    model._build_vocab(trees)
    params = model._init_params()
    prog = compile_trees(trees, model.vocab)
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = rntn.loss_and_grads(
            rntn.loss_fn, {k: v.to(dev) for k, v in params.items()},
            rntn.program_arrays(prog, torch.device(dev)), 1e-4)
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert _rel_max(lg.cpu(), lc) <= 1e-4
    for k in gc:
        assert gg[k].is_cuda and _rel_max(gg[k].cpu(), gc[k]) <= 1e-4, k


def test_rntn_and_rae_fits_on_the_card_match_the_cpu(no_tf32):
    _need_card()
    from deeplearning4j_tpu_torch.models import (
        RNTN,
        RecursiveAutoEncoder,
        RNTNEval,
    )

    trees = _review_trees()[::4]
    fits = {dev: RNTN(num_classes=2, d=16, lr=0.05, epochs=5,
                      device=dev).fit(trees) for dev in ("cpu", "cuda")}
    assert _rel_max(fits["cuda"].losses, fits["cpu"].losses) <= 1e-4
    evs = {}
    for dev, m in fits.items():
        evs[dev] = RNTNEval()
        evs[dev].eval(m, trees)
    assert evs["cuda"].node_total == evs["cpu"].node_total
    raes = {dev: RecursiveAutoEncoder(d=16, epochs=5, device=dev).fit(trees)
            for dev in ("cpu", "cuda")}
    assert _rel_max(raes["cuda"].losses, raes["cpu"].losses) <= 1e-4
    assert _rel_max(raes["cuda"].encode(trees),
                    raes["cpu"].encode(trees)) <= 1e-4


def test_kmeans_on_the_card_matches_the_cpu(no_tf32):
    _need_card()
    from deeplearning4j_tpu_torch.clustering import (
        KMeansClustering,
        kmeans_lloyd,
    )
    from deeplearning4j_tpu_torch.clustering.kmeans import (
        _pairwise_sq_dists,
    )

    rng = np.random.default_rng(0)
    centres = rng.normal(0, 4, size=(8, 64))
    pts = np.concatenate([rng.normal(c, 1.0, size=(500, 64))
                          for c in centres]).astype(np.float32)
    x = torch.from_numpy(pts)
    init = x[torch.randperm(len(pts), generator=torch.Generator(
        ).manual_seed(1))[:8]]
    cpu = kmeans_lloyd(x, init)
    card = kmeans_lloyd(x.cuda(), init.cuda())
    assert card[2] == cpu[2] and card[3] == card[2]
    d2 = torch.sort(_pairwise_sq_dists(x, cpu[0]), dim=1).values
    near_tie = ((d2[:, 1] - d2[:, 0]) < 1e-4 * d2[:, 1].abs()).numpy()
    differ = card[1].cpu().numpy() != cpu[1].numpy()
    assert not (differ & ~near_tie).any()
    assert _rel_max(card[0].cpu(), cpu[0]) <= 1e-4
    km = KMeansClustering(8, device="cuda")
    assign = km.fit(pts)
    np.testing.assert_array_equal(km.predict(pts), assign)
    assert km.host_reads == km.n_iter


def test_plot_listener_on_a_card_bf16_network(tmp_path):
    _need_card()
    import os

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, zoo
    from deeplearning4j_tpu_torch.plot import (
        ActivationRenderListener,
        PlotFiltersIterationListener,
    )

    conf = zoo.lenet_mnist(compute_dtype="bfloat16")
    conf = dataclasses.replace(conf, conf=dataclasses.replace(
        conf.conf, dtype="bfloat16"))
    net = MultiLayerNetwork(conf).init()
    assert net.params[0]["W"].is_cuda
    assert net.params[0]["W"].dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    x = rng.random((8, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    net.add_listener(PlotFiltersIterationListener(net, str(tmp_path / "f"),
                                                  every=1))
    net.add_listener(ActivationRenderListener(net, x[:4],
                                              str(tmp_path / "a"), every=1))
    net.fit_batch(x, y)
    assert os.listdir(tmp_path / "f") and os.listdir(tmp_path / "a")


# -- slice 16: the host-only tail (model import, determinism, storage) ---


def test_hf_named_stand_in_imports_and_serves_on_the_card():
    """`import_hf_gpt2` onto the card gives the CPU import's leaves word
    for word; the paged pool serves it (B1 = n_layers x dispatches by
    width) with greedy ids equal to `generate`."""
    _need_card()
    import threading

    import chip_smoke
    from deeplearning4j_tpu_torch.parallel.generation import generate
    from deeplearning4j_tpu_torch.runtime.model_import import import_hf_gpt2
    from deeplearning4j_tpu_torch.tree import flatten_tree

    model, _ = chip_smoke.hf_gpt2_stand_in(
        seed=0, vocab_size=256, n_positions=128, n_embd=64, n_layer=2,
        n_head=4)
    cfg, params = import_hf_gpt2(model)
    cfg_cpu, params_cpu = import_hf_gpt2(model, device="cpu")
    assert cfg == cfg_cpu and cfg.attn_bias and not cfg.tie_embeddings
    for (ka, a), (kb, b) in zip(flatten_tree(params).items(),
                                flatten_tree(params_cpu).items()):
        assert ka == kb and a.is_cuda
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 256, int(n))]
               for n in rng.integers(5, 40, 4)]
    srv = ContinuousLMServer(cfg, params, slots=4, page_size=16,
                             prefill_chunk=16, device="cuda")
    try:
        srv.warmup()
        torch.cuda.synchronize()
        tpk.paged_flash_attention.launches.reset()
        out = [None] * len(prompts)

        def client(i):
            out[i] = srv.generate(prompts[i], 8, timeout=300)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        torch.cuda.synchronize()
        want = {w: cfg.n_layers * n
                for w, n in srv.stats()["dispatch_widths"].items()}
        got = {str(c): n for c, n in
               tpk.paged_flash_attention.launches.by_key().items()}
        assert got == want and got
    finally:
        srv.stop()
    for p, ids in zip(prompts, out):
        assert ids == generate(cfg, params, [p], 8,
                               device="cuda")[0].tolist()


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 128)])
def test_flash_backward_kernels_are_bitwise_across_calls(dtype, d):
    """B3 and B4 write each dK/dV and dQ element from one thread block,
    with no atomics: two calls on the same inputs give the same words."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(2, 300, 4, d, generator=g, device="cuda",
                               dtype=dtype) for _ in range(4))
    o, lse = tk.flash_forward(q, k, v, True)
    delta = tk.row_delta(do, o)
    words = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[dtype]
    first = tk.flash_bwd_dkv(q, k, v, do, lse, delta, True) + (
        tk.flash_bwd_dq(q, k, v, do, lse, delta, True),)
    second = tk.flash_bwd_dkv(q, k, v, do, lse, delta, True) + (
        tk.flash_bwd_dq(q, k, v, do, lse, delta, True),)
    for a, b in zip(first, second):
        assert torch.equal(a.view(words), b.view(words))


def test_remote_checkpoint_of_a_card_net_is_bitwise():
    _need_card()
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.runtime import (
        RemoteModelSaver,
        load_checkpoint_remote,
        load_model_remote,
        save_checkpoint_remote,
    )
    from deeplearning4j_tpu_torch.runtime.storage import MemoryStore

    rng = np.random.default_rng(0)
    eye = np.eye(11, dtype=np.float32)
    ids = rng.integers(0, 11, (4, 9))
    x, y = eye[ids], eye[np.roll(ids, -1, axis=1)]
    net = MultiLayerNetwork(char_lstm(vocab_size=11, hidden=16,
                                      compute_dtype="bfloat16")).init()
    for _ in range(2):
        net.fit_batch(x, y)
    try:
        save_checkpoint_remote("memory://card/ck", 2, net.params,
                               updater_state=net.updater_state)
        step, params, upd, _ = load_checkpoint_remote(
            "memory://card/ck", net.params, updater_like=net.updater_state)
        assert step == 2
        for a, b in zip(net.params, params):
            for key in a:
                assert b[key].is_cuda and b[key].dtype == a[key].dtype
                assert torch.equal(a[key].view(torch.int32),
                                   b[key].view(torch.int32))
        RemoteModelSaver("memory://card/model").save(net)
        back = load_model_remote("memory://card/model")
        np.testing.assert_array_equal(back.params_flat(), net.params_flat())
        assert torch.equal(back.output(x), net.output(x))
    finally:
        MemoryStore.reset()


def test_device_memory_stats_on_the_card():
    _need_card()
    from deeplearning4j_tpu_torch.runtime.profiler import device_memory_stats

    keep = torch.ones(1 << 20, device="cuda")
    stats = device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    s = stats[0]
    assert set(s) == {"device", "bytes_in_use", "peak_bytes_in_use",
                      "bytes_limit"}
    assert s["device"] == "cuda:0"
    assert s["peak_bytes_in_use"] >= s["bytes_in_use"] >= keep.numel() * 4
    assert s["bytes_limit"] == torch.cuda.get_device_properties(
        0).total_memory


def _char_lstm_tree(net):
    """Seeded numpy parameters for `net`'s tree (its keys and shapes)."""
    rng = np.random.default_rng(5)
    return [{k: (rng.standard_normal(tuple(v.shape)) * 0.1).astype(
        np.float32) for k, v in layer.items()} for layer in net.params]


def test_network_performer_on_the_card_publishes_host_numpy():
    """`NetworkPerformer` on the card: `update` installs fresh card
    tensors (the broadcast tree stays as it was), each `perform` launches
    the LSTM kernel once (one LSTM layer) and publishes host float32
    numpy copies that the next step does not move."""
    _need_card()
    from deeplearning4j_tpu_torch.models import char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.scaleout import Job, NetworkPerformer

    conf_json = char_lstm(vocab_size=20, hidden=64,
                          compute_dtype="bfloat16").to_json()
    perf = NetworkPerformer(conf_json)
    assert perf.net.device.type == "cuda"
    tree = _char_lstm_tree(perf.net)
    before = [{k: v.copy() for k, v in p.items()} for p in tree]
    perf.update(tree)
    for layer, src in zip(perf.net.params, tree):
        for k, v in layer.items():
            assert v.is_cuda and v.dtype == torch.float32
            assert torch.equal(v.cpu(), torch.from_numpy(src[k]))
    rng = np.random.default_rng(0)
    eye = np.eye(20, dtype=np.float32)
    ids = rng.integers(0, 20, (8, 16))
    job = Job(work=(eye[ids], eye[np.roll(ids, -1, axis=1)]))
    lk.fused_lstm_forward.launches.reset()
    perf.perform(job)
    torch.cuda.synchronize()
    assert lk.fused_lstm_forward.launches.value == 1
    published = [{k: v.copy() for k, v in p.items()} for p in job.result]
    perf.perform(Job(work=job.work))
    assert lk.fused_lstm_forward.launches.value == 2
    for p, q, src in zip(job.result, published, before):
        for k in q:
            assert isinstance(p[k], np.ndarray) and p[k].dtype == np.float32
            np.testing.assert_array_equal(p[k], q[k])
            assert not np.array_equal(p[k], src[k])
    for got, want in zip(tree, before):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_scaleout_performers_refuse_to_run_without_a_card(monkeypatch):
    """With the card hidden, a performer built without a device raises,
    and one given "cpu" runs there."""
    _need_card()
    from deeplearning4j_tpu_torch.models import char_lstm
    from deeplearning4j_tpu_torch.nlp import Glove, Word2Vec
    from deeplearning4j_tpu_torch.scaleout import NetworkPerformer

    conf_json = char_lstm(vocab_size=20, hidden=16).to_json()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NetworkPerformer(conf_json)
    for cls in (Word2Vec, Glove):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(vector_length=8)
    assert NetworkPerformer(conf_json, device="cpu").net.device.type == "cpu"


# ---- data parallelism: a 4-shard mesh over card 0 ------------------------

def _dp(conf, n=4, **kw):
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (
        DataParallelTrainer,
        make_mesh,
    )

    net = MultiLayerNetwork(conf).init()
    mesh = make_mesh((n,), ("data",), devices=[torch.device("cuda", 0)] * n)
    return net, DataParallelTrainer(net, mesh=mesh, **kw)


def _char_batch(b=16, t=12, v=20, seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(v, dtype=np.float32)
    ids = rng.integers(0, v, (b, t))
    return (torch.from_numpy(eye[ids]).cuda(),
            torch.from_numpy(eye[np.roll(ids, -1, axis=1)]).cuda())


def _flat_tree(tree):
    from deeplearning4j_tpu_torch.tree import flatten_tree

    return {k: v.detach().float().cpu() for k, v in
            flatten_tree(tree).items()}


def test_dp_zero1_equals_replicated_bitwise_on_the_card(no_tf32):
    """float32 char-LSTM on 4 shards of card 0, 4 Adam steps: the ZeRO-1
    plane and ``shard_update=False`` agree on parameters and moments
    bitwise (one reduction order, elementwise updates)."""
    _need_card()
    from deeplearning4j_tpu_torch.models import char_lstm

    x, y = _char_batch()
    runs = []
    for shard in (True, False):
        net, tr = _dp(char_lstm(vocab_size=20, hidden=32),
                      shard_update=shard)
        losses = [tr.fit_batch(x, y) for _ in range(4)]
        tr.publish_train_state()
        runs.append((losses, _flat_tree(net.params),
                     _flat_tree(net.updater_state)))
    (la, pa, ua), (lb, pb, ub) = runs
    assert la == lb
    for a, b in ((pa, pb), (ua, ub)):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_dp_launches_b5_once_a_layer_shard_and_step():
    _need_card()
    from deeplearning4j_tpu_torch.models import char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    net, tr = _dp(char_lstm(vocab_size=20, hidden=32,
                            compute_dtype="bfloat16"))
    x, y = _char_batch()
    tr.fit_batch(x, y)
    lk.fused_lstm_forward.launches.reset()
    losses = [tr.fit_batch(x, y) for _ in range(3)]
    torch.cuda.synchronize()
    assert lk.fused_lstm_forward.launches.value == 1 * 4 * 3
    assert all(math.isfinite(v) for v in losses)


def test_dp_overflow_on_one_shard_skips_every_shard_on_the_card():
    """"mixed": a batch infinite in shard 0's rows only leaves parameters
    and moments bitwise, halves the scale and counts one overflow."""
    _need_card()
    from deeplearning4j_tpu_torch.models import char_lstm

    net, tr = _dp(char_lstm(vocab_size=20, hidden=32))
    net.set_precision("mixed")
    x, y = _char_batch()
    tr.fit_batch(x, y)
    tr.publish_train_state()
    p0, u0 = _flat_tree(net.params), _flat_tree(net.updater_state)
    s0 = net.scaler_stats()
    bad = x.clone()
    bad[1, 3, 0] = float("inf")   # row 1 lies in shard 0 of 4
    tr.fit_batch(bad, y)
    tr.publish_train_state()
    p1, u1 = _flat_tree(net.params), _flat_tree(net.updater_state)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(u0[k], u1[k]) for k in u0)
    s1 = net.scaler_stats()
    assert s1["scale"] == s0["scale"] / 2
    assert s1["overflow_count"] == s0["overflow_count"] + 1
    assert math.isfinite(tr.fit_batch(x, y))


def test_dp_inf_in_one_gradient_slice_skips_every_shard_on_the_card():
    """"mixed": a finite loss with one inf planted in the last shard's
    slice of the reduced gradient, which only the non-finite count over
    the slices sees: parameters and moments bitwise, the scale halved,
    one overflow."""
    _need_card()
    from deeplearning4j_tpu_torch.models import char_lstm

    net, tr = _dp(char_lstm(vocab_size=20, hidden=32))
    net.set_precision("mixed")
    x, y = _char_batch()
    tr.fit_batch(x, y)
    tr.publish_train_state()
    p0, u0 = _flat_tree(net.params), _flat_tree(net.updater_state)
    s0 = net.scaler_stats()
    plain = tr._shard_grads

    def planted(*args, **kwargs):
        pieces = plain(*args, **kwargs)
        grads = pieces[1][2]
        grads[-1] = grads[-1].clone()
        grads[-1].view(-1)[-1] = float("inf")  # flat lane k0 - 1
        return pieces

    tr._shard_grads = planted
    assert math.isfinite(tr.fit_batch(x, y))
    del tr._shard_grads
    tr.publish_train_state()
    p1, u1 = _flat_tree(net.params), _flat_tree(net.updater_state)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(u0[k], u1[k]) for k in u0)
    s1 = net.scaler_stats()
    assert s1["scale"] == s0["scale"] / 2
    assert s1["overflow_count"] == s0["overflow_count"] + 1
    assert math.isfinite(tr.fit_batch(x, y))


def test_cli_spmd_refuses_more_replicas_than_cards(tmp_path, capsys):
    """`-replicas` on cuda must lie in [1, device_count()], the check the
    JAX CLI makes against its visible devices; a mesh may repeat a card
    only when the caller lists it again."""
    _need_card()
    from deeplearning4j_tpu_torch import cli

    n = torch.cuda.device_count()
    rng = np.random.default_rng(0)
    labels = np.arange(30) % 3
    x = rng.standard_normal((30, 4)) * 0.3 + labels[:, None]
    csv = tmp_path / "iris.csv"
    np.savetxt(csv, np.column_stack([x, labels]), delimiter=",",
               fmt="%.5f")
    with pytest.raises(SystemExit, match=rf"-replicas must be in \[1, {n}\]"
                       rf" \(visible devices\), got {n + 1}"):
        cli.main(["train", "-input", str(csv), "-model", "zoo:iris-mlp",
                  "-runtime", "spmd", "-replicas", str(n + 1),
                  "-output", str(tmp_path / "out")])


# ---------------------------------------------------------------------------
# the LM mesh trainers: 4 shards on card 0

def _card_mesh(shape, names):
    from deeplearning4j_tpu_torch.parallel import make_mesh

    n = int(np.prod(shape))
    return make_mesh(shape, names, devices=[torch.device("cuda", 0)] * n)


def _flash_counters():
    return {"fwd": tk.flash_forward.launches,
            "dkv": tk.flash_bwd_dkv.launches, "dq": tk.flash_bwd_dq.launches}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_on_four_shards_of_the_card_matches_flash(dtype, tol, causal):
    """`ring_flash_attention` over 4 seq shards of card 0 against the
    one-device flash on the whole sequence: the output and dq / dk / dv
    within `tol` of the largest reference value, B2 = B3 = B4 = 10 block
    pairs causal and 16 not."""
    _need_card()
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ring_flash_attention,
    )

    rng = np.random.default_rng(1)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (2, 256, 4, 64)).astype(np.float32)).cuda().to(dtype)
        for _ in range(4))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = tk.flash_attention(*leaves, causal)
    want = (out, *torch.autograd.grad(out, leaves, g))
    counters = _flash_counters()
    for c in counters.values():
        c.reset()
    blocks = [list(t.chunk(4, dim=1)) for t in leaves]
    out = torch.cat(ring_flash_attention(*blocks, "seq", causal), dim=1)
    got = (out, *torch.autograd.grad(out, leaves, g))
    torch.cuda.synchronize()
    pairs = 10 if causal else 16
    assert {n: c.value for n, c in counters.items()} == \
        {"fwd": pairs, "dkv": pairs, "dq": pairs}
    for a, b in zip(got, want):
        a, b = a.detach().float(), b.detach().float()
        assert float((a - b).abs().max() / b.abs().max()) <= tol


def _leaf_change_err(init, got, want):
    from deeplearning4j_tpu_torch.tree import flatten_tree

    i, g, w = (flatten_tree(t) for t in (init, got, want))
    worst = 0.0
    for key in w:
        dg, dw = (np.asarray(t[key], np.float64) - i[key] for t in (g, w))
        ref = key.replace("//bk", "//bq")   # a key bias's gradient is 0
        scale = np.abs(np.asarray(w[ref], np.float64) - i[ref]).max()
        worst = max(worst, float(np.abs(dg - dw).max() / scale))
    return worst


@pytest.mark.parametrize("kind", ["hybrid", "pipeline"])
def test_mesh_step_on_the_card_matches_one_device(no_tf32, kind):
    """One float32 SGD step of each mesh trainer on 4 shards of card 0
    against the one-device step: the loss within 1e-5 relative, each
    leaf's change within 1e-3 of its largest change; the flash launches
    of a step (1 + remat) L dp tp sp (sp + 1) / 2 forward (hybrid, (1, 2,
    2)) and 2 L m (pipeline, (1, 4), m 2), half that for each backward
    kernel."""
    _need_card()
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        HybridParallelTrainer,
        PipelineParallelTrainer,
    )

    cfg = tt.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                               n_layers=4, d_ff=128, max_len=64,
                               attn_bias=True, tie_embeddings=True,
                               remat=True)
    tree = tt.numpy_params(cfg, seed=0)
    rng = np.random.default_rng(2)
    data = torch.from_numpy(rng.integers(0, 128, (4, 65))).cuda()
    tok, tgt = data[:, :-1], data[:, 1:]
    params = th._master_f32(tt.params_from_numpy(tree, device="cuda"))
    step, init = th.make_accum_train_step(cfg, lr=1.0)
    params, _, loss = step(params, init(params), tok, tgt)
    want = tt.params_to_numpy(params)
    if kind == "hybrid":
        tr = HybridParallelTrainer(
            cfg, _card_mesh((1, 2, 2), ("data", "seq", "model")), lr=1.0,
            params=tree)
        fwd = 2 * 4 * 1 * 2 * 3
    else:
        tr = PipelineParallelTrainer(
            cfg, _card_mesh((1, 4), ("data", "stage")), n_microbatches=2,
            lr=1.0, params=tree)
        fwd = 2 * 4 * 2
    counters = _flash_counters()
    for c in counters.values():
        c.reset()
    got_loss = tr.fit_batch(tok, tgt)
    assert {n: c.value for n, c in counters.items()} == \
        {"fwd": fwd, "dkv": fwd // 2, "dq": fwd // 2}
    assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
    assert _leaf_change_err(tree, tr.export_params(), want) <= 1e-3


# ---- training across processes: gloo on card 0, NCCL of one process --------

def test_two_gloo_processes_on_card_0_equal_one_process_bitwise(tmp_path,
                                                               no_tf32):
    """2 processes x 2 shards of card 0 (gloo: NCCL refuses two ranks on
    one card), 3 ZeRO-1 steps of a bf16 char-LSTM: losses, parameters and
    moments bitwise those of 1 process x 4 shards, B5 = 2 shards x 3 a
    process."""
    _need_card()
    import torch_multiproc_worker as w

    rcs = w.run_job(tmp_path / "job", ["card_dp"], {"device": "cuda:0"},
                    timeout_s=60, deadline_s=240)
    assert rcs == [0, 0], w.job_logs(tmp_path / "job")
    losses, params, upd, b5 = w.card_dp_run(
        w.host_mesh(per_process=4, device="cuda:0"))
    assert b5 == 4 * 3
    for rank in range(2):
        res, arrays = w.job_results(tmp_path / "job", rank)
        assert res["losses"] == losses and res["b5"] == 2 * 3
        for prefix, want in (("params/", params), ("updater/", upd)):
            got = {k[len(prefix):]: v for k, v in arrays.items()
                   if k.startswith(prefix)}
            assert set(got) == set(want)
            for k in want:
                assert np.array_equal(got[k], want[k]), k


def test_embedding_replicas_stay_bitwise_equal_across_processes(tmp_path):
    """Word2Vec NEG and GloVe ``mesh=`` over 2 gloo processes x 2 shards
    of card 0: each process applies the gathered scatter to its own copy
    of the tables, deterministically, so the copies end bitwise equal
    (the card's atomic ``index_add_`` rounded them apart)."""
    _need_card()
    import torch_multiproc_worker as w

    rcs = w.run_job(tmp_path / "job", ["card_embeddings"],
                    {"device": "cuda:0"}, timeout_s=60, deadline_s=240)
    assert rcs == [0, 0], w.job_logs(tmp_path / "job")
    (_, a0), (_, a1) = (w.job_results(tmp_path / "job", r)
                        for r in range(2))
    assert set(a0) == set(a1) and a0
    for k in a0:
        assert np.array_equal(a0[k], a1[k]), k


def test_nccl_group_of_one_process_runs_the_collectives(no_tf32):
    """An NCCL group of world size 1 (the card's default backend) over 4
    shards of card 0: psum, pmean, psum_scatter and all_gather through
    the process group equal their one-process forms, and a ZeRO-1 run
    over it equals the one-process mesh bitwise."""
    _need_card()
    import socket

    import torch.distributed as dist

    import torch_multiproc_worker as w
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.runtime.launcher import (
        initialize_multihost,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = initialize_multihost(f"127.0.0.1:{port}", 1, 0, timeout_s=60)
    try:
        assert dist.get_backend() == "nccl"
        assert info["process_count"] == 1 and info["process_index"] == 0
        mesh = w.host_mesh(per_process=4, device="cuda:0")
        assert mesh.distributed and not mesh._host_staged
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        xs = [torch.randn(4096, device="cuda", generator=gen)
              for _ in range(4)]
        devs = mesh.local_devices()
        assert torch.equal(mesh_lib.psum(xs, dev, mesh),
                           mesh_lib.psum(xs, dev))
        assert torch.equal(mesh_lib.pmean(xs, dev, mesh),
                           mesh_lib.pmean(xs, dev))
        assert all(torch.equal(a, b) for a, b in zip(
            mesh_lib.psum_scatter(xs, devs, mesh),
            mesh_lib.psum_scatter(xs, devs)))
        assert torch.equal(mesh_lib.all_gather(xs, dev, mesh),
                           mesh_lib.all_gather(xs, dev))
        got = w.card_dp_run(mesh)
    finally:
        dist.destroy_process_group()
    want = w.card_dp_run(w.host_mesh(per_process=4, device="cuda:0"))
    assert got[0] == want[0] and got[3] == want[3] == 12
    for a, b in ((got[1], want[1]), (got[2], want[2])):
        assert set(a) == set(b)
        assert all(np.array_equal(a[k], b[k]) for k in b)
