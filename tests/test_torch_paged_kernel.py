"""PyTorch port: paged attention (`deeplearning4j_tpu_torch.parallel.paged_kernel`).

The port's plain version is held against the JAX package's Pallas kernel
(run in interpret mode, as the JAX tests run it on the CPU) and against
the JAX gather path (`_paged_attn(paged_kernel=False)`), at every FED
column (padding columns legitimately differ), in float32 with atol 1e-5;
in float16 (both sides take float16 pools and return float16, computing
in f32) with atol 1e-3 + rtol 1e-3, one f16 rounding step (measured: at
most 2.4e-4).
Inputs come from numpy with a seed and go to both packages as numpy
arrays.  The CUDA kernel itself runs only on a card: its tests are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import kernels as jkernels
from deeplearning4j_tpu.parallel import paged_kernel as jpk
from deeplearning4j_tpu_torch import _build
from deeplearning4j_tpu_torch.parallel import generation as tgen
from deeplearning4j_tpu_torch.parallel import kernels as tkernels
from deeplearning4j_tpu_torch.parallel import paged_kernel as tpk
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

ATOL = 1e-5

# (b, c, h, kd, ps, mp, pos, n_feed, null lanes): ragged n_feed, null
# (inactive) lanes, chunks straddling page edges, page sizes 4 and 5
CASES = {
    "decode_c1_ps4": (4, 1, 2, 8, 4, 8, [0, 5, 3, 23], [1, 1, 1, 1], ()),
    "decode_c1_ps5_null": (4, 1, 2, 8, 5, 6, [0, 7, 14, 0], [1, 1, 1, 0],
                           (3,)),
    "chunk_c4_ps4_straddle": (3, 4, 2, 8, 4, 6, [2, 3, 7], [4, 4, 4], ()),
    "chunk_c4_ps5_ragged": (4, 4, 2, 8, 5, 6, [9, 1, 14, 0], [4, 2, 1, 3],
                            ()),
    "chunk_c4_ps5_null": (3, 4, 2, 8, 5, 4, [0, 6, 11], [0, 4, 2], (0,)),
}
# head dims above the tensor-core route's 256 (the card serves up to 512)
WIDE_HEAD_CASES = {
    "decode_c1_k320": (2, 1, 1, 320, 4, 3, [3, 9], [1, 1], ()),
    "chunk_c4_k512": (2, 4, 1, 512, 4, 3, [1, 6], [4, 2], ()),
}
# a prefill chunk of 128 columns (``prefill_chunk=128``), ragged n_feed
WIDE_CASES = dict(CASES, chunk_c128_ps16=(2, 128, 2, 8, 16, 10, [0, 20],
                                          [128, 100], ()))


def _state(case, seed=0):
    b, c, h, kd, ps, mp, pos, nf, null = case
    rng = np.random.default_rng(seed)
    pages = 1 + b * mp
    q = rng.standard_normal((b, c, h, kd)).astype(np.float32)
    kp = rng.standard_normal((pages, ps, h, kd)).astype(np.float32)
    vp = rng.standard_normal((pages, ps, h, kd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, pages)).astype(np.int32)
    table = np.zeros((b, mp), np.int32)
    for i in range(b):
        if i in null:
            continue
        need = min(mp, (pos[i] + c - 1) // ps + 1)
        table[i, :need] = perm[i * mp:i * mp + need]     # shuffled pages
    return (q, kp, vp, table, np.asarray(pos, np.int32),
            np.asarray(nf, np.int32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_fed(got, want, n_feed, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    for i, nf in enumerate(n_feed):
        if nf:
            np.testing.assert_allclose(got[i, :nf], want[i, :nf], atol=atol)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(WIDE_HEAD_CASES))
def test_plain_matches_jax_kernel_interpret(name):
    q, kp, vp, table, pos, nf = _state({**CASES, **WIDE_HEAD_CASES}[name])
    want = jpk.paged_flash_attention(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(table),
                                     jnp.asarray(pos), jnp.asarray(nf),
                                     interpret=True)
    got = tpk.paged_flash_attention_plain(*_t(q, kp, vp, table, pos, nf))
    assert got.dtype == torch.float32 and got.shape == q.shape
    _assert_fed(got.numpy(), want, nf)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(WIDE_HEAD_CASES))
def test_float16_plain_matches_jax_kernel_interpret(name):
    q, kp, vp, table, pos, nf = _state({**CASES, **WIDE_HEAD_CASES}[name])
    h = [jnp.asarray(x, jnp.float16) for x in (q, kp, vp)]
    want = jpk.paged_flash_attention(*h, jnp.asarray(table),
                                     jnp.asarray(pos), jnp.asarray(nf),
                                     interpret=True)
    got = tpk.paged_flash_attention_plain(
        *(x.half() for x in _t(q, kp, vp)), *_t(table, pos, nf))
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    for i, n in enumerate(nf):
        if n:
            np.testing.assert_allclose(got[i, :n].float().numpy(),
                                       np.asarray(want[i, :n], np.float32),
                                       atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_on_cpu_runs_plain_and_counts_nothing(name):
    """A CPU tensor takes the plain version because it lies on the CPU:
    no build, no launch counted."""
    args = _t(*_state(CASES[name], seed=1))
    before = tpk.paged_flash_attention.launches.value
    got = tpk.paged_flash_attention(*args)
    want = tpk.paged_flash_attention_plain(*args)
    assert torch.equal(got, want)
    assert tpk.paged_flash_attention.launches.value == before


def _attn_params(rng, d, h, kd):
    p = {w: (rng.standard_normal((d, h, kd)) / np.sqrt(d)).astype(
        np.float32) for w in ("wq", "wk", "wv")}
    p["wo"] = (rng.standard_normal((h, kd, d)) / np.sqrt(d)).astype(
        np.float32)
    for bname in ("bq", "bk", "bv"):
        p[bname] = (0.1 * rng.standard_normal((h, kd))).astype(np.float32)
    p["bo"] = (0.1 * rng.standard_normal((d,))).astype(np.float32)
    return p


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax_gather_path(name):
    """`_paged_attn` end to end (qkv projection, scatter into the pool,
    paged attention, output projection) against the JAX gather path:
    outputs at fed columns, and every non-null page of the pools."""
    b, c, h, kd = CASES[name][:4]
    d = h * kd
    q, kp, vp, table, pos, nf = _state(CASES[name], seed=2)
    rng = np.random.default_rng(3)
    p = _attn_params(rng, d, h, kd)
    x = rng.standard_normal((b, c, d)).astype(np.float32)
    jo, jk, jv = jgen._paged_attn(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(nf), paged_kernel=False)
    tk, tv = _t(kp.copy(), vp.copy())
    to = tgen._paged_attn({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), tk, tv,
                          *_t(table, pos, nf))
    _assert_fed(to.numpy(), jo, nf, atol=1e-5)
    # the scatter: identical everywhere but the null page (garbage sink)
    np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk)[1:], atol=1e-6)
    np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv)[1:], atol=1e-6)


def test_padding_columns_and_inactive_lanes_write_only_the_null_page():
    b, c, h, kd, ps, mp = 2, 4, 2, 8, 4, 4
    case = (b, c, h, kd, ps, mp, [5, 0], [2, 0], (1,))
    q, kp, vp, table, pos, nf = _state(case)
    rng = np.random.default_rng(4)
    p = {k: torch.from_numpy(v)
         for k, v in _attn_params(rng, h * kd, h, kd).items()}
    x = torch.from_numpy(rng.standard_normal((b, c, h * kd)).astype(
        np.float32))
    tk, tv = _t(kp.copy(), vp.copy())
    tgen._paged_attn(p, x, tk, tv, *_t(table, pos, nf))
    changed = {int(pg) for pg in np.nonzero(
        (tk.numpy() != kp).any(axis=(1, 2, 3)))[0]}
    # lane 0 feeds positions 5 and 6 (page table[0, 1]); its padding
    # columns and the whole inactive lane 1 go to page 0
    assert changed == {0, int(table[0, 1])}
    rows = np.nonzero((tk.numpy()[table[0, 1]] != kp[table[0, 1]]).any(
        axis=(1, 2)))[0]
    assert rows.tolist() == [1, 2]


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    args = [torch.zeros(1, 1, 1, 4, device="meta"),
            torch.zeros(2, 4, 1, 4, device="meta"),
            torch.zeros(2, 4, 1, 4, device="meta"),
            torch.zeros(1, 1, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="cuda"):
        tpk.paged_flash_attention(*args)


def _good_inputs():
    return dict(q=torch.zeros(2, 3, 2, 8), k=torch.zeros(5, 4, 2, 8),
                v=torch.zeros(5, 4, 2, 8),
                table=torch.zeros(2, 3, dtype=torch.int32),
                pos=torch.zeros(2, dtype=torch.int32),
                n_feed=torch.zeros(2, dtype=torch.int32))


BAD_INPUTS = {
    "q_float64": ("q", lambda t: t.double(), TypeError),
    "pool_dtype_mismatch": ("k", lambda t: t.bfloat16(), TypeError),
    "table_int64": ("table", lambda t: t.long(), TypeError),
    "pos_int64": ("pos", lambda t: t.long(), TypeError),
    "q_not_contiguous": ("q", lambda t: t.transpose(1, 2).contiguous()
                         .transpose(1, 2), ValueError),
    "pool_heads_mismatch": ("v", lambda t: torch.zeros(5, 4, 3, 8),
                            ValueError),
    "table_wrong_lanes": ("table",
                          lambda t: torch.zeros(3, 3, dtype=torch.int32),
                          ValueError),
    "n_feed_wrong_shape": ("n_feed",
                           lambda t: torch.zeros(3, dtype=torch.int32),
                           ValueError),
    "q_three_dims": ("q", lambda t: t[0], ValueError),
}


def test_check_accepts_good_inputs():
    a = _good_inputs()
    tpk._check_cuda_inputs(a["q"], a["k"], a["v"], a["table"], a["pos"],
                           a["n_feed"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_check_accepts_16_bit_inputs(dtype):
    """The kernel takes float16 as it takes bfloat16 (dtype code 2)."""
    a = _good_inputs()
    for key in ("q", "k", "v"):
        a[key] = a[key].to(getattr(torch, dtype))
    tpk._check_cuda_inputs(a["q"], a["k"], a["v"], a["table"], a["pos"],
                           a["n_feed"])
    assert tpk._DTYPE_CODES[getattr(torch, dtype)] == \
        {"bfloat16": 1, "float16": 2}[dtype]


@pytest.mark.parametrize("name", sorted(BAD_INPUTS))
def test_check_rejects_what_the_kernel_does_not_take(name):
    """The checks the wrapper runs before a CUDA launch (device, dtype,
    shape, contiguity), exercised on CPU tensors."""
    key, mutate, exc = BAD_INPUTS[name]
    a = _good_inputs()
    a[key] = mutate(a[key])
    with pytest.raises(exc):
        tpk._check_cuda_inputs(a["q"], a["k"], a["v"], a["table"],
                               a["pos"], a["n_feed"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_mask_value_matches_jax(dtype):
    want = float(jkernels.mask_value(jnp.dtype(dtype)))
    assert tkernels.mask_value(getattr(torch, dtype)) == want


@pytest.mark.parametrize("kernel", [True, False])
def test_paged_hbm_bytes_matches_jax(kernel):
    args = (12, 8, 157, 512, 16, 12, 64, 2, kernel)
    assert tpk.paged_hbm_bytes(*args) == jpk.paged_hbm_bytes(*args)


def test_build_targets_hopper_with_a_plain_c_library():
    cmd = _build.build_command("nvcc", _build.CSRC / "paged_attention.cu",
                               _build.BUILD_DIR / "x.so")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    for flag in ("-O3", "-shared", "-fPIC", "-std=c++17"):
        assert flag in cmd
    path = _build.library_path("paged_attention")
    assert path.parent == _build.BUILD_DIR
    assert (_build.CSRC / _build.SOURCES["paged_attention"]).is_file()
    gitignore = (_build.CSRC.parents[1] / ".gitignore").read_text()
    assert "deeplearning4j_tpu_torch/_kernels_build/" in gitignore


# ---- the kernel's split plan (flash-decoding) ------------------------------


PLAN_SHAPES = {
    # (b, c, h, kd, mp, ps, dtype, n_sm)
    "served_decode": (8, 1, 12, 64, 64, 16, torch.bfloat16, 132),
    "served_chunk": (8, 16, 12, 64, 64, 16, torch.bfloat16, 132),
    "prefill_chunk128": (8, 128, 12, 64, 64, 16, torch.bfloat16, 132),
    "f32_chunk": (8, 16, 12, 64, 64, 16, torch.float32, 132),
    "tiny_pages": (3, 4, 2, 8, 37, 4, torch.float32, 132),
    "one_lane_long": (1, 1, 1, 64, 4096, 16, torch.bfloat16, 132),
    "c512_k256": (1, 512, 1, 256, 2, 4, torch.float32, 132),
    "bf16_chunk_k384": (2, 16, 2, 384, 8, 16, torch.bfloat16, 132),
    "bf16_decode_k512": (2, 1, 2, 512, 8, 16, torch.bfloat16, 132),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_split_plan_covers_every_live_page_once(name):
    """Every live page of every lane falls in exactly one working block,
    in order, and no working block starts past its lane's frontier."""
    b, c, h, kd, mp, ps, dtype, n_sm = PLAN_SHAPES[name]
    plan = tpk.paged_split_plan(b, c, h, kd, mp, ps, dtype, n_sm)
    pps, n = plan["pages_per_split"], plan["n_splits"]
    assert 1 <= pps <= mp and n == -(-mp // pps)
    assert plan["cols"] == tpk.block_cols(c, dtype, kd)
    assert plan["c_tiles"] * plan["cols"] >= c
    assert plan["blocks"] == n * b * h * plan["c_tiles"]
    if n > 1:
        assert plan["part_ml"] == (n, b, c, h, 2)
        assert plan["part_acc"] == (n, b, c, h, kd)
    else:
        assert plan["part_ml"] is None and plan["part_acc"] is None
    rng = np.random.default_rng(7)
    for _ in range(20):
        pos = rng.integers(0, mp * ps, b)
        nf = rng.integers(0, c + 1, b)
        for p, f, ranges in zip(pos, nf, _live_split_ranges(
                plan, pos, nf, ps, mp)):
            n_lp = min((p + max(f, 1) - 1) // ps + 1, mp)
            covered = [pg for lo, hi in ranges for pg in range(lo, hi)]
            assert covered == list(range(n_lp))
            assert all(lo < n_lp and lo % pps == 0 for lo, _ in ranges)


@pytest.mark.parametrize("c,dtype,kd,cols", [
    (1, torch.bfloat16, 512, 1), (16, torch.bfloat16, 256, 16),
    (16, torch.bfloat16, 264, 4), (16, torch.bfloat16, 512, 4),
    (16, torch.float32, 512, 4), (1, torch.float32, 384, 1),
    (1, torch.float16, 64, 1), (16, torch.float16, 64, 4),
    (16, torch.float16, 512, 4)])
def test_block_cols_keeps_the_tensor_cores_up_to_head_dim_256(c, dtype, kd,
                                                               cols):
    """bf16 chunks take the 16-column tensor-core route up to K = 256 and
    the 4-column FMA route above it, as float32 chunks do; float16
    chunks take the FMA route at every K; C = 1 is one column a block at
    any K."""
    assert tpk.MAX_HEAD_DIM == 512 and tpk.MAX_MMA_HEAD_DIM == 256
    assert tpk.block_cols(c, dtype, kd) == cols


def test_split_plan_fills_the_card_at_the_served_shape():
    """Decode and the 16-column chunk at the served shape (B 8, H 12,
    K 64, page 16, 64 pages) give well over one block per SM of 132."""
    for c in (1, 16):
        plan = tpk.paged_split_plan(8, c, 12, 64, 64, 16, torch.bfloat16, 132)
        assert plan["blocks"] >= 4 * 132 and plan["n_splits"] > 1
        assert plan["pages_per_split"] * 16 >= tpk.MIN_SPLIT_KEYS


def _live_split_ranges(plan, pos, n_feed, ps, mp):
    """The kernel's rule, per lane: the page ranges ``[pg0, pg1)`` of the
    blocks that work; a block whose range starts past the lane's frontier
    ``pos + max(n_feed, 1) - 1`` exits, the last one stops at the
    frontier page."""
    pps, out = plan["pages_per_split"], []
    for p, nf in zip((int(x) for x in pos), (int(x) for x in n_feed)):
        n_lp = min((p + max(nf, 1) - 1) // ps + 1, mp)
        out.append([(s * pps, min(s * pps + pps, n_lp))
                    for s in range(plan["n_splits"]) if s * pps < n_lp])
    return out


def _split_emulation(q, kp, vp, table, pos, nf, plan):
    """The kernel's split + merge in torch: per working block the f32
    partial (m, l, acc) of its page range under the mask t <= pos + c,
    then the rescale merge of the partials, normaliser clamped at
    1e-30."""
    b, c, h, kd = q.shape
    pages, ps = kp.shape[0], kp.shape[1]
    neg = tkernels.mask_value(torch.float32)
    scale = 1.0 / np.sqrt(kd)
    out = torch.zeros(b, c, h, kd)
    ranges = _live_split_ranges(plan, pos.tolist(), nf.tolist(), ps,
                                   table.shape[1])
    for i in range(b):
        parts = []
        for lo, hi in ranges[i]:
            t = torch.arange(lo * ps, hi * ps)
            ids = table[i, t // ps].long()
            ids = torch.where((ids < 0) | (ids >= pages), 0, ids)
            k, v = kp[ids, t % ps], vp[ids, t % ps]          # [T, H, K]
            s = torch.einsum("chk,thk->cht", q[i] * scale, k)
            live = (t[None, :] <= int(pos[i]) + torch.arange(c)[:, None])
            s = torch.where(live[:, None, :], s, torch.tensor(neg))
            m = s.amax(-1)                                   # [C, H]
            p = torch.where(live[:, None, :], torch.exp(s - m[..., None]),
                            torch.tensor(0.0))
            parts.append((m, p.sum(-1), torch.einsum("cht,thk->chk", p, v)))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        big_l = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
        out[i] = acc / big_l.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("pps", [None, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_split_merge_emulation_matches_plain_and_jax(name, pps):
    """The split + merge arithmetic (the plan's own pages_per_split, and
    1, 2, 3 pages a split) against the plain version and the JAX kernel
    in interpret mode, at fed columns."""
    q, kp, vp, table, pos, nf = _state(WIDE_CASES[name])
    b, c, h, kd, ps, mp = WIDE_CASES[name][:6]
    plan = tpk.paged_split_plan(b, c, h, kd, mp, ps, torch.float32, 132)
    if pps is not None:
        plan = dict(plan, pages_per_split=pps, n_splits=-(-mp // pps))
    tq, tk_, tv, ttable, tpos, tnf = _t(q, kp, vp, table, pos, nf)
    got = _split_emulation(tq, tk_, tv, ttable, tpos, tnf, plan)
    _assert_fed(got.numpy(), tpk.paged_flash_attention_plain(
        tq, tk_, tv, ttable, tpos, tnf).numpy(), nf)
    want = jpk.paged_flash_attention(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(table),
                                     jnp.asarray(pos), jnp.asarray(nf),
                                     interpret=True)
    _assert_fed(got.numpy(), want, nf)


def test_plain_matches_jax_kernel_at_a_128_column_chunk():
    q, kp, vp, table, pos, nf = _state(WIDE_CASES["chunk_c128_ps16"])
    want = jpk.paged_flash_attention(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(table),
                                     jnp.asarray(pos), jnp.asarray(nf),
                                     interpret=True)
    got = tpk.paged_flash_attention_plain(*_t(q, kp, vp, table, pos, nf))
    _assert_fed(got.numpy(), want, nf)


def test_launch_counter_counts_by_key():
    """The paged wrapper keys its launches by query width: the total and
    the per-key counts both reset to nothing."""
    counter = tkernels.LaunchCounter()
    for key in (1, 16, 16, None):
        counter.add(key=key)
    assert counter.value == 4 and counter.by_key() == {1: 1, 16: 2}
    counter.reset()
    assert counter.value == 0 and counter.by_key() == {}
