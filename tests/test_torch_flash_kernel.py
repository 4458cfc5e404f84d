"""PyTorch port: flash attention (`deeplearning4j_tpu_torch.parallel.kernels`).

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX package's Pallas kernels run in interpret
mode (`_flash_forward`, `_bwd_block`) and against `jax.grad` of the JAX
`flash_attention`, on the same numpy inputs.  Tolerances: 2e-5 in
float32 (the two sides sum in different orders); for bfloat16 inputs
atol 0.15 / rtol 0.1 against the float32 reference, as the JAX
package's own bf16 test (`tests/test_kernels.py`) states.  float16
inputs go to both sides (the Pallas kernels take them and return
float16): each computes in f32 and rounds its outputs once to f16, so
one f16 rounding step (2^-10 relative) may flip: atol 1e-3 + rtol 1e-3
(measured: at most 9.8e-4 at values near 2).  The CUDA
kernels themselves are checked on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py --only flash`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import kernels as jk
from deeplearning4j_tpu.parallel.ring_attention import attention as jattention
from deeplearning4j_tpu_torch.parallel import kernels as tk
from test_torch_cuda import _bwd_bf16_rounded
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

ATOL = 2e-5
SHAPES = [(s, d) for s in (8, 24, 40) for d in (8, 16)]
# head dims above 128 (the card's D-chunked route), S <= 64
WIDE_SHAPES = [(24, 192), (64, 256)]


def _inputs(b, s, h, d, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", SHAPES + WIDE_SHAPES)
def test_forward_matches_the_jax_kernel(s, d, causal):
    q, k, v = _inputs(2, s, 3, d, seed=s + d, n=3)
    want_o, want_lse = jk._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal, True)
    got_o, got_lse = tk.flash_forward(*_t(q, k, v), causal)
    assert got_o.shape == (2, s, 3, d) and got_lse.shape == (6, s)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", SHAPES + WIDE_SHAPES)
def test_backward_block_matches_the_jax_kernels(s, d, causal):
    """The same EXTERNAL lse and delta go to both sides: a random delta,
    and lse shifted off the forward's, as ring attention's global row
    stats would be."""
    q, k, v, g = _inputs(2, s, 3, d, seed=100 + s + d)
    rng = np.random.default_rng(s * d)
    _, lse = jk._flash_forward(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal, True)
    lse = np.asarray(lse) + 0.1 * rng.standard_normal((6, s)).astype(
        np.float32)
    delta = rng.standard_normal((6, s)).astype(np.float32)
    want = jk._bwd_block(*(jnp.asarray(x) for x in (q, k, v, g, lse, delta)),
                         causal, True)
    args = _t(q, k, v, g, lse, delta)
    got = tk.flash_bwd_block(*args, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)
    # the per-kernel wrappers compute the same parts
    dk, dv = tk.flash_bwd_dkv(*args, causal)
    dq = tk.flash_bwd_dq(*args, causal)
    for a, b in zip((dq, dk, dv), got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


F16_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", SHAPES + WIDE_SHAPES)
def test_float16_forward_matches_the_jax_kernel(s, d, causal):
    q, k, v = _inputs(2, s, 3, d, seed=s + d, n=3)
    h = [jnp.asarray(x, jnp.float16) for x in (q, k, v)]
    want_o, want_lse = jk._flash_forward(*h, causal, True)
    got_o, got_lse = tk.flash_forward(*(x.half() for x in _t(q, k, v)),
                                      causal)
    assert got_o.dtype == torch.float16 and want_o.dtype == jnp.float16
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o, np.float32), **F16_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", SHAPES + WIDE_SHAPES)
def test_float16_backward_block_matches_the_jax_kernels(s, d, causal):
    q, k, v, g = _inputs(2, s, 3, d, seed=100 + s + d)
    rng = np.random.default_rng(s * d)
    h = [jnp.asarray(x, jnp.float16) for x in (q, k, v, g)]
    _, lse = jk._flash_forward(*h[:3], causal, True)
    lse = np.asarray(lse) + 0.1 * rng.standard_normal((6, s)).astype(
        np.float32)
    delta = rng.standard_normal((6, s)).astype(np.float32)
    want = jk._bwd_block(*h, jnp.asarray(lse), jnp.asarray(delta), causal,
                         True)
    got = tk.flash_bwd_block(*(x.half() for x in _t(q, k, v, g)),
                             *_t(lse, delta), causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float16 and b.dtype == jnp.float16, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), **F16_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [8, 24])
def test_autograd_matches_jax_grad(s, causal):
    q, k, v, w = _inputs(2, s, 2, 8, seed=7 + s)

    def jloss(q, k, v):
        return jnp.sum(jk.flash_attention(q, k, v, causal) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk_, tv = (x.requires_grad_() for x in _t(q, k, v))
    (tk.flash_attention(tq, tk_, tv, causal) * torch.from_numpy(w)).sum() \
        .backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq, tk_, tv), want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


def test_bf16_forward_and_grads_track_the_f32_reference():
    """bf16 inputs are upcast inside; out and the gradients come back
    bf16 and track the f32 dense attention of the JAX package."""
    q32, k32, v32 = _inputs(2, 32, 2, 16, seed=3, n=3)
    q, k, v = (x.to(torch.bfloat16).requires_grad_() for x in
               _t(q32, k32, v32))
    out = tk.flash_attention(q, k, v, True)
    assert out.dtype == torch.bfloat16
    want = jattention(jnp.asarray(q32), jnp.asarray(k32), jnp.asarray(v32),
                      causal=True)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want), atol=2e-2)
    (out.float() ** 2).sum().backward()
    ref = jax.grad(
        lambda q, k, v: jnp.sum(jattention(q, k, v, causal=True) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(q32), jnp.asarray(k32),
                           jnp.asarray(v32))
    for a, b in zip((q, k, v), ref):
        assert a.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(a.grad.float().numpy(), np.asarray(b),
                                   atol=0.15, rtol=0.1)


def test_lse_rows_are_batch_major_and_of_the_scaled_scores():
    """lse row b*H + h holds logsumexp over keys of (q.k)/sqrt(D) for
    batch b, head h (the layout ring attention consumes)."""
    b, s, h, d = 3, 5, 4, 8
    q, k, v = _t(*_inputs(b, s, h, d, seed=11, n=3))
    _, lse = tk.flash_forward(q, k, v, causal=False)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    torch.testing.assert_close(lse.reshape(b, h, s),
                               torch.logsumexp(scores, dim=-1),
                               atol=1e-5, rtol=0)


def test_gradient_scaling_dk_dq_scaled_dv_not():
    """dv = P^T dO with no 1/sqrt(D); dk and dq carry it."""
    b, s, h, d = 1, 6, 1, 4
    q, k, v, g = _t(*_inputs(b, s, h, d, seed=5))
    out, lse = tk.flash_forward(q, k, v, causal=True)
    delta = tk.row_delta(g, out)
    dq, dk, dv = tk.flash_bwd_block(q, k, v, g, lse, delta, causal=True)
    scale = 1 / np.sqrt(d)
    sc = (q[0, :, 0] @ k[0, :, 0].T) * scale
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(sc, dim=-1)
    torch.testing.assert_close(dv[0, :, 0], p.T @ g[0, :, 0], atol=1e-5,
                               rtol=0)
    dp = g[0, :, 0] @ v[0, :, 0].T
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    torch.testing.assert_close(dk[0, :, 0], ds.T @ q[0, :, 0] * scale,
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(dq[0, :, 0], ds @ k[0, :, 0] * scale,
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(delta[0], (g * out).sum(-1)[0, :, 0])


def test_cpu_runs_count_no_launches_and_other_devices_raise():
    q, k, v, g = _t(*_inputs(1, 4, 1, 4, seed=0))
    counters = (tk.flash_forward.launches, tk.flash_bwd_dkv.launches,
                tk.flash_bwd_dq.launches)
    before = [c.value for c in counters]
    out = tk.flash_attention(q.requires_grad_(), k, v)
    out.sum().backward()
    assert [c.value for c in counters] == before
    meta = torch.empty(1, 4, 1, 4, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        tk.flash_forward(meta, meta, meta)
    lse = torch.empty(1, 4, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        tk.flash_bwd_block(meta, meta, meta, meta, lse, lse)


def test_launch_checks_refuse_what_the_kernels_do_not_take():
    """The checks a CUDA launch runs first (device-agnostic, so they are
    exercised here on CPU tensors)."""
    x = torch.zeros(1, 8, 2, 16)
    stats = torch.zeros(2, 8)
    tk._check_cuda((("q", x), ("k", x)), (("lse", stats),))
    tk._check_cuda((("q", torch.zeros(1, 8, 2, tk.MAX_HEAD_DIM)),))
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 8, 2, 513)
        tk._check_cuda((("q", big),))
    tk._check_cuda((("q", x.half()), ("k", x.half())))   # float16: code 2
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tk._check_cuda((("q", x.double()),))
    with pytest.raises(TypeError, match="must equal"):
        tk._check_cuda((("q", x), ("k", x.bfloat16())))
    with pytest.raises(ValueError, match="contiguous"):
        tk._check_cuda((("q", x), ("k", x.transpose(1, 2)
                                   .contiguous().transpose(1, 2))))
    with pytest.raises(ValueError, match=r"B\*H=2, S=8"):
        tk._check_cuda((("q", x),), (("lse", torch.zeros(8, 2)),))
    with pytest.raises(ValueError, match="shape"):
        tk._check_cuda((("q", x), ("k", torch.zeros(1, 9, 2, 16))))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(64, 16), (64, 64), (100, 16), (100, 64)])
def test_bf16_rounding_reference_stays_inside_the_card_limit(s, d, causal):
    """The card holds the tensor-core backward at 5e-3 against the plain
    backward with P and dS rounded to bf16 (`_bwd_bf16_rounded` of the
    card tests) and at 2e-2 against the f32 plain version.  On
    bf16-representable inputs that rounding reference itself stays within
    2e-2 of the f32 plain version and of the JAX `_bwd_block`, so the two
    limits cannot contradict each other."""
    q, k, v, g = (np.asarray(torch.from_numpy(x).bfloat16().float())
                  for x in _inputs(1, s, 2, d, seed=300 + s + d))
    out, lse = tk.flash_forward(*_t(q, k, v), causal)
    delta = tk.row_delta(torch.from_numpy(g), out)
    args = (*_t(q, k, v, g), lse, delta)
    rounded = _bwd_bf16_rounded(*args, causal)
    plain = tk.flash_bwd_block_plain(*args, causal)
    jax_ref = jk._bwd_block(*(jnp.asarray(np.asarray(x)) for x in args),
                            causal, True)
    for name, r, p, j in zip(("dq", "dk", "dv"), rounded, plain, jax_ref):
        for want in (p, torch.from_numpy(np.array(j))):
            err = float((r - want).abs().max() / want.abs().max())
            assert err <= 2e-2, (name, err)


@pytest.mark.parametrize("dtype,d,offset,want", [
    (torch.bfloat16, 64, 0, "tensor_cores"),
    (torch.bfloat16, 8, 0, "tensor_cores"),
    (torch.bfloat16, 40, 0, "tensor_cores"),
    (torch.bfloat16, 128, 0, "tensor_cores"),
    (torch.bfloat16, 20, 0, "fma"),
    (torch.bfloat16, 127, 0, "fma"),
    (torch.bfloat16, 64, 2, "fma"),
    (torch.bfloat16, 64, 8, "fma"),
    (torch.float32, 64, 0, "fma"),
    (torch.float32, 128, 0, "fma"),
])
def test_route_rule_sends_aligned_bf16_at_d_multiple_of_8_to_tensor_cores(
        dtype, d, offset, want):
    """`flash_route_rule`, the Python mirror of the C entries' route rule
    (the card tests assert the entries agree): one tensor off a 16-byte
    boundary sends the launch to the FMA pipes."""
    ptrs = [4096, 8192, 12288, 16384 + offset, 20480, 24576]
    assert tk.flash_route_rule(dtype, d, ptrs) == want
    assert tk.flash_route_rule(dtype, d, ptrs[:4]) == want


@pytest.mark.parametrize("dtype,d,offset,fwd,bwd", [
    (torch.bfloat16, 128, 0, "tensor_cores", "tensor_cores"),
    (torch.bfloat16, 136, 0, "tensor_cores", "fma_chunks"),
    (torch.bfloat16, 256, 0, "tensor_cores", "fma_chunks"),
    (torch.bfloat16, 256, 2, "fma_chunks", "fma_chunks"),
    (torch.bfloat16, 130, 0, "fma_chunks", "fma_chunks"),
    (torch.bfloat16, 264, 0, "fma_chunks", "fma_chunks"),
    (torch.float32, 512, 0, "fma_chunks", "fma_chunks"),
])
def test_route_rule_above_head_dim_128(dtype, d, offset, fwd, bwd):
    """Above D = 128 the forward keeps the tensor cores up to 256 (its O
    is 128 f32 a thread there), the backward does not (dK + dV would be
    256); everything else above 128 takes the D-chunked FMA route."""
    ptrs = [4096, 8192, 12288, 16384 + offset, 20480, 24576]
    assert tk.flash_route_rule(dtype, d, ptrs[:4], "fwd") == fwd
    for kind in ("dkv", "dq"):
        assert tk.flash_route_rule(dtype, d, ptrs, kind) == bwd
