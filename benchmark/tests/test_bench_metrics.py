"""Every per-layer metric's arithmetic on a recorded context (a fixture
client log, window counters and a reduced trace), the trace reduction on
fixture events, and the kinds' end-to-end arithmetic."""

import math

import pytest

from benchmark import peaks, spec, trace
from benchmark.kinds import p95

GPT2_SMALL = {"d": 768, "L": 12, "H": 12, "K": 64, "V": 50257, "P": 1024,
              "F": 3072, "eps": 1e-5}


def serve_ctx():
    # two requests: one entirely inside the window [10, 12), one whose
    # first token came before it
    reqs = [{"plen": 100, "t_sub": 10.0, "times": [10.05, 10.06, 10.07]},
            {"plen": 50, "t_sub": 9.0, "times": [9.5, 11.0, 12.5]}]
    counters = {"dispatches": 200, "lanes": 12000, "prefix_saved": 64,
                "prompt_tokens": 100, "requests": 1,
                "b1": {1: 12 * 150, 64: 12 * 50}}
    tr = {"busy_s": 0.5, "window_s": 2.0,
          "kernels": {}, "counters": {"dispatches": 100}}
    return {"kind": "serve", "dims": GPT2_SMALL, "dtype": "bfloat16",
            "seconds": 2.0, "t0": 10.0, "t1": 12.0, "wide_width": 64,
            "counters": counters, "requests": reqs, "trace": tr}


def train_ctx():
    shapes = {"b": 16, "s": 1024, "h": 12, "d": 64, "causal": True,
              "dtype": "bfloat16"}
    bound = peaks.flash_bound_s("flash_fwd", 16, 1024, 12, 64, True,
                                "bfloat16")
    tr = {"busy_s": 0.3, "window_s": 0.4,
          "kernels": {"flash_fwd_mma_kernel": (48 * bound * 4, 48),
                      "flash_bwd_dkv_mma_kernel": (1.0, 24)},
          "counters": {"flash_fwd": 48, "flash_bwd_dkv": 24,
                       "flash_bwd_dq": 0}}
    return {"kind": "train", "dims": GPT2_SMALL, "dtype": "bfloat16",
            "seconds": 2.0, "steps": 10, "step_flops": 2.6e13,
            "shapes": shapes, "trace": tr}


def read(name, ctx):
    return spec.metric_module(name).read(ctx)


def test_serve_counter_metrics():
    ctx = serve_ctx()
    assert read("serve.lanes_per_dispatch", ctx) == 60.0
    assert read("serve.wide_dispatch_share", ctx) == pytest.approx(25.0)
    assert read("serve.prefix_hit_share", ctx) == pytest.approx(64.0)
    assert read("serve.device_ms_per_dispatch", ctx) == pytest.approx(5.0)
    assert read("idle_share.serve", ctx) == pytest.approx(75.0)


def test_serve_tails_take_the_window_at_the_clients():
    ctx = serve_ctx()
    # the first request's 50 ms; the second was submitted before t0
    assert read("serve.ttft_p95_ms", ctx) == pytest.approx(50.0)
    # the first request's two 10 ms gaps; neither of the second's gaps
    # lies wholly inside the window
    assert read("serve.itl_p95_ms", ctx) == pytest.approx(10.0)
    ctx["requests"] = []
    assert read("serve.ttft_p95_ms", ctx) is None
    assert read("serve.itl_p95_ms", ctx) is None


def test_mfu_serve_counts_the_window_only():
    ctx = serve_ctx()
    dims = GPT2_SMALL
    want = (peaks.prefill_flops(dims, 100, 64.0)
            + peaks.decode_flops(dims, 101) + peaks.decode_flops(dims, 102)
            + peaks.decode_flops(dims, 51))
    got = read("mfu.serve", ctx)
    assert got == pytest.approx(100 * want / 2.0 / 989e12)


def test_serve_metrics_find_nothing_without_work():
    ctx = serve_ctx()
    ctx["counters"].update(dispatches=0, prompt_tokens=0, b1={})
    ctx["trace"] = None
    for name in ("serve.lanes_per_dispatch", "serve.wide_dispatch_share",
                 "serve.prefix_hit_share", "serve.device_ms_per_dispatch",
                 "idle_share.serve"):
        assert read(name, ctx) is None


def test_train_metrics():
    ctx = train_ctx()
    assert read("mfu.train", ctx) == pytest.approx(
        100 * 2.6e13 * 10 / 2.0 / 989e12)
    assert read("flash_fwd_roofline", ctx) == pytest.approx(25.0)
    dkv = peaks.flash_bound_s("flash_bwd_dkv", 16, 1024, 12, 64, True,
                              "bfloat16")
    assert read("flash_bwd_dkv_roofline", ctx) == pytest.approx(
        100 * 24 * dkv / 1.0)
    # no launches counted: the roofline finds nothing, never 0
    assert read("flash_bwd_dq_roofline", ctx) is None
    assert read("idle_share.train", ctx) == pytest.approx(25.0)


def test_flash_bound_matches_the_shape_arithmetic():
    b, s, h, d = 16, 1024, 12, 64
    ops = 2 * 2 * s * s * d * b * h // 2
    nbytes = 4 * b * s * h * d * 2 + b * h * s * 4
    assert peaks.flash_bound_s("flash_fwd", b, s, h, d, True,
                               "bfloat16") == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12))
    # at S 4096 the same launch is bound by its operations
    assert peaks.flash_bound_s("flash_fwd", 1, 4096, h, d, True,
                               "bfloat16") == pytest.approx(
        2 * 4096 * 4096 * d * h / 989e12)


def test_train_step_flops():
    dims = GPT2_SMALL
    n = peaks.block_params(dims) + peaks.head_params(dims)
    assert 123e6 < n < 125e6
    assert peaks.train_step_flops(dims, 32, 1024) == (
        6 * n * 32 * 1024 + 6 * 12 * 768 * 1024 * 1024 * 32)


def test_trace_reduction_union_and_gaps():
    ms = 1_000_000
    rows = [
        (True, "void flash_fwd_mma_kernel<__nv_bfloat16, 64>(int)", 0, 2 * ms),
        (True, "void (anonymous namespace)::flash_fwd_kernel<float>(x)",
         1 * ms, 3 * ms),                      # overlaps: counted once
        (True, "Memcpy HtoD (Pageable -> Device)", 5 * ms, 6 * ms),
        (True, "ampere_gemm", 6 * ms + 5_000, 7 * ms),   # 5 us gap
        (False, "cudaStreamSynchronize", 3 * ms, 3 * ms + 400_000),
        (False, "aten::copy_", 3 * ms, 5 * ms),
    ]
    out = trace.reduce_events(rows, 0, 10 * ms)
    assert out["busy_s"] == pytest.approx((3 + 1 + 0.995) * 1e-3)
    assert out["kernels"]["flash_fwd_mma_kernel"] == (pytest.approx(2e-3), 1)
    assert out["kernels"]["flash_fwd_kernel"][1] == 1
    gaps = dict(out["idle_gaps"])
    assert gaps["host: aten::copy_"] == pytest.approx(2e-3)
    assert gaps["between kernels (< 20 us)"] == pytest.approx(5e-6)
    assert gaps["host: no op or CUDA call traced (Python)"] == \
        pytest.approx(3e-3)
    assert out["device_ops"][0][0] == "flash_fwd_kernel" or \
        out["device_ops"][0][0] == "flash_fwd_mma_kernel"


def test_short_kernel_names():
    assert trace.short_name("void a::b::gemm_kernel<int, 3>(int*)") == \
        "gemm_kernel"
    assert trace.short_name("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD"


def test_p95_is_the_linear_percentile():
    assert p95(list(range(101))) == 95.0
    assert math.isclose(p95([1.0, 2.0]), 1.95)
