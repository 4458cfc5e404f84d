"""PyTorch port, kernel B5: the fused LSTM scan against the JAX package.

On the CPU the port's `fused_lstm_forward` runs its plain version
(`fused_lstm_forward_plain`) and its backward is `lstm_backward`, the
JAX `_bwd` in torch ops.  Both are held against the JAX module on the
same numpy inputs: the Pallas kernel in interpret mode
(`fused_lstm_scan(..., interpret=True)`, `_forward(save_residuals=True)`)
and `jax.grad` through its `custom_vjp`.

Tolerances: float32 forward atol 1e-5 and gradients atol 2e-4, as
`tests/test_lstm_kernel.py` holds the kernel against the scan.  bfloat16
inputs: the carry and the residuals are f32 in both packages, so cs and
zs keep atol 1e-5 (only the f32 dot products' summation order differs);
hs is rounded to bf16, so one rounding step (2^-8 of its magnitude) may
flip: atol 1e-2; the bf16 gradients are compared relative to their
largest element at 2e-2 (a few bf16 rounding steps).  float16 inputs
(which the JAX kernel takes as it takes bf16): both sides compute in f32
and round hs once to f16, so one f16 rounding step (2^-11 of |h| < 1)
may flip: atol 1e-3 (measured: at most 2.4e-4); the f16 gradients
relative to their largest element at 1e-3 (measured: at most 7.2e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.layers import lstm_kernel as jlk
from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as tlk
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

SIZES = {"t5_b3_h8": (5, 3, 8), "t6_b2_h13": (6, 2, 13),
         "t9_b5_h40": (9, 5, 40)}


def _inputs(t, b, h, peephole, seed=0):
    rng = np.random.default_rng(seed)
    xz = rng.standard_normal((t, b, 4 * h)).astype(np.float32)
    rw = (rng.standard_normal((h, 4 * h)) * 0.3).astype(np.float32)
    ps = [(rng.standard_normal(h) * 0.2).astype(np.float32) if peephole
          else np.zeros(h, np.float32) for _ in range(3)]
    return [xz, rw, *ps]


def _jax(arrays, dtype):
    return [jnp.asarray(a, dtype) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.detach().float().numpy()


HS_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-3}
GRAD_REL_TOL = {"bfloat16": 2e-2, "float16": 1e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("peephole", [True, False])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_plain_forward_matches_the_jax_kernel(size, peephole, dtype):
    arrays = _inputs(*SIZES[size], peephole)
    j_hs, j_cs, j_zs = jlk._forward(*_jax(arrays, dtype), True, True)
    j_hs_inf = jlk.fused_lstm_scan(*_jax(arrays, dtype), True)
    hs, cs, zs = tlk.fused_lstm_forward(*_torch(arrays, dtype),
                                        save_residuals=True)
    hs_inf, none_cs, none_zs = tlk.fused_lstm_forward(*_torch(arrays, dtype))
    assert none_cs is None and none_zs is None
    assert hs.dtype == getattr(torch, dtype)
    assert cs.dtype == zs.dtype == torch.float32
    hs_tol = HS_TOL[dtype]
    np.testing.assert_allclose(_np(hs), _np(j_hs), atol=hs_tol, rtol=0)
    np.testing.assert_allclose(_np(hs_inf), _np(j_hs_inf), atol=hs_tol,
                               rtol=0)
    np.testing.assert_allclose(_np(cs), _np(j_cs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(zs), _np(j_zs), atol=1e-5, rtol=0)


def test_plain_forward_reads_a_batch_major_view():
    """The kernel may take xz as the transposed view of a batch-major
    [B, T, 4H] tensor; the plain version gives the same result from it."""
    xz, rw, pi, pf, po = _torch(_inputs(5, 3, 8, True), "float32")
    view = xz.transpose(0, 1).contiguous().transpose(0, 1)
    assert not view.is_contiguous()
    for a, b in zip(tlk.fused_lstm_forward(xz, rw, pi, pf, po, True),
                    tlk.fused_lstm_forward(view, rw, pi, pf, po, True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("peephole", [True, False])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_gradients_match_jax_custom_vjp(size, peephole, dtype):
    arrays = _inputs(*SIZES[size], peephole, seed=1)
    w = np.random.default_rng(2).standard_normal(
        arrays[0].shape[:2] + (arrays[1].shape[0],)).astype(np.float32)

    def j_loss(*a):
        hs = jlk.fused_lstm_scan(*a, True)
        return jnp.sum(hs.astype(jnp.float32) * w)

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(*_jax(arrays, dtype))
    leaves = [a.requires_grad_() for a in _torch(arrays, dtype)]
    hs = tlk.fused_lstm_scan(*leaves)
    t_grads = torch.autograd.grad((hs.float() * torch.from_numpy(w)).sum(),
                                  leaves)
    for name, a, b in zip("xz rw pi pf po".split(), t_grads, j_grads):
        assert a.dtype == getattr(torch, dtype), name
        if dtype == "float32":
            np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=0,
                                       err_msg=f"grad wrt {name}")
        else:
            scale = max(float(np.abs(_np(b)).max()), 1e-6)
            err = float(np.abs(_np(a) - _np(b)).max()) / scale
            assert err <= GRAD_REL_TOL[dtype], (name, err)


def test_backward_uses_the_rounded_hs_for_h_prev():
    """dRW takes h_{t-1} from hs cast to f32 (the bf16-rounded output),
    not from the f32 carry: exactly the JAX `_bwd` rounding."""
    arrays = _inputs(5, 3, 8, True, seed=4)
    rng = np.random.default_rng(5)
    dhs = rng.standard_normal((5, 3, 8)).astype(np.float32)
    j_hs, j_cs, j_zs = jlk._forward(*_jax(arrays, "bfloat16"), True, True)
    j_res = (j_hs, j_cs, j_zs, *_jax(arrays[1:], "bfloat16"))
    j_out = jlk._bwd(True, j_res, jnp.asarray(dhs, jnp.bfloat16))
    hs, cs, zs = tlk.fused_lstm_forward(*_torch(arrays, "bfloat16"),
                                        save_residuals=True)
    t_out = tlk.lstm_backward(hs, cs, zs, *_torch(arrays[1:], "bfloat16"),
                              torch.from_numpy(dhs).bfloat16())
    for a, b in zip(t_out, j_out):
        assert a.dtype == torch.bfloat16
        scale = float(np.abs(_np(b)).max())
        assert float(np.abs(_np(a) - _np(b)).max()) <= 2e-2 * scale


def test_manual_backward_equals_autograd_through_the_plain_steps():
    leaves = [a.requires_grad_() for a in _torch(_inputs(6, 2, 13, True),
                                                 "float32")]
    g = torch.randn(6, 2, 13, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(tlk.fused_lstm_scan(*leaves), leaves, g)
    want = torch.autograd.grad(tlk.fused_lstm_scan_plain(*leaves), leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = tlk.fused_lstm_forward.launches.value
    tlk.fused_lstm_forward(*_torch(_inputs(2, 2, 4, True), "float32"))
    assert tlk.fused_lstm_forward.launches.value == before


def test_an_unsupported_device_is_refused():
    xz, rw, pi, pf, po = _torch(_inputs(2, 2, 4, True), "float32")
    with pytest.raises(ValueError, match="cuda"):
        tlk.fused_lstm_forward(xz.to("meta"), rw.to("meta"), pi.to("meta"),
                               pf.to("meta"), po.to("meta"))


@pytest.mark.parametrize("fused,mask,activation,want", [
    (None, False, "tanh", True), (True, False, "tanh", True),
    (False, False, "tanh", False), (None, True, "tanh", False),
    (None, False, "softsign", False)])
def test_path_policy(fused, mask, activation, want):
    """The fused scan unless fused=False, a mask or a non-tanh
    activation asks for the step-by-step scan (None means fused)."""
    from deeplearning4j_tpu_torch.nn.conf import GravesLSTMConf

    conf = GravesLSTMConf(n_in=3, n_out=4, fused=fused,
                          activation=activation)
    assert trec.uses_fused_scan(conf, torch.ones(1, 1) if mask else None) \
        is want


@pytest.mark.parametrize("fused,n_out,want", [
    (None, 1024, True), (None, 1025, False), (True, 1024, True),
    (True, 1025, True), (False, 1024, False), (False, 1025, False)])
def test_path_policy_at_the_kernel_width(fused, n_out, want):
    """``fused=None`` is the fused scan only up to the kernel's width
    (`MAX_HIDDEN`), like JAX's scan above it; an explicit ``fused=True``
    keeps the kernel, which refuses the width on the card."""
    from deeplearning4j_tpu_torch.nn.conf import GravesLSTMConf

    assert tlk.MAX_HIDDEN == 1024
    conf = GravesLSTMConf(n_in=3, n_out=n_out, fused=fused)
    assert trec.uses_fused_scan(conf, None) is want


# ---- the kernel's launch plan (csrc/lstm.cu make_plan), as pure functions

@pytest.mark.parametrize("dtype,h,route,cluster,units,threads", [
    (torch.float32, 8, "cluster", 1, 8, 32),
    (torch.float32, 37, "cluster", 8, 8, 96),
    (torch.bfloat16, 256, "cluster", 16, 16, 256),
    (torch.float32, 256, "cluster", 16, 16, 256),
    (torch.float32, 384, "cluster", 16, 24, 192),
    (torch.float32, 385, "wide", 0, 3, 256),
    (torch.bfloat16, 512, "cluster", 16, 32, 256),
    (torch.bfloat16, 513, "wide", 0, 4, 256),
    (torch.bfloat16, 1024, "wide", 0, 8, 256),
    (torch.float16, 256, "cluster", 16, 16, 256),
    (torch.float16, 512, "cluster", 16, 32, 256),
    (torch.float16, 513, "wide", 0, 4, 256)])
def test_route_rule_at_the_cluster_limit(dtype, h, route, cluster, units,
                                         threads):
    """The cluster route holds while a CTA's RW slice, h double buffer
    and k-split partials fit its 232 448 bytes: up to H = 384 in f32
    and 512 in bf16 on an H100; one cluster a 16-row batch tile, a power
    of two of CTAs up to 16."""
    plan = tlk.lstm_route_rule(dtype, 33, h)
    assert (plan["route"], plan["cluster"], plan["units"],
            plan["threads"]) == (route, cluster, units, threads)
    assert plan["smem_bytes"] <= tlk.H100_SMEM_OPTIN
    if route == "cluster":
        assert plan["batch_tile"] == 16 and plan["blocks"] == 3 * cluster
        assert plan["launches"] == 1 and cluster * units >= h
        assert plan["threads"] == 32 * (units // 8) * plan["k_parts"]
    else:
        assert plan["blocks"] * units >= h and plan["blocks"] <= 132


@pytest.mark.parametrize("b,launches,tile", [
    (32, 1, 32), (3039, 1, 3039), (3040, 3, 1014), (4096, 4, 1024),
    (100000, 90, 1112)])
def test_wide_route_slices_a_batch_whose_c_does_not_fit(b, launches, tile):
    """At H = 1024 the wide route keeps c of a launch's rows in shared
    memory: up to B = 3039 in one launch (the first design's ceiling),
    past it the fewest equal slices that fit, one cooperative launch
    each; every batch size has a plan."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        plan = tlk.lstm_route_rule(dtype, b, 1024)
        assert plan["route"] == "wide"
        assert (plan["launches"], plan["batch_tile"]) == (launches, tile)
        assert plan["batch_tile"] * plan["launches"] >= b
        assert (plan["batch_tile"] - 1) * plan["launches"] < b
        assert plan["rows"] >= 1 and plan["smem_bytes"] <= \
            tlk.H100_SMEM_OPTIN


@pytest.mark.parametrize("h", [8, 37, 256, 384, 512, 513, 1024])
def test_float16_plans_as_bfloat16(h):
    """float16 and bfloat16 are both 2-byte elements: csrc/lstm.cu plans
    them alike (make_plan takes the element size), so the rule does."""
    for b in (1, 33, 4096):
        assert tlk.lstm_route_rule(torch.float16, b, h) == \
            tlk.lstm_route_rule(torch.bfloat16, b, h)


@pytest.mark.parametrize("b", [1, 16, 17, 3040, 4096])
def test_cluster_route_takes_any_batch_in_16_row_tiles(b):
    plan = tlk.lstm_route_rule(torch.bfloat16, b, 256)
    assert plan["route"] == "cluster" and plan["launches"] == 1
    assert plan["blocks"] == 16 * -(-b // 16)
