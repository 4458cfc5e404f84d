"""The benchmark's readers of the port's span store
(`benchmark/metrics/<name>.py`) on synthetic spans and a synthetic
context, each None where nothing was recorded.

The spans sit at negative ``perf_counter_ns`` times, where no real
recorder in the process can put one, and the training readers clear the
ring first, since they take the newest steps."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import peaks, spec  # noqa: E402
from deeplearning4j_tpu_torch.obs.trace import (  # noqa: E402
    clear_spans,
    new_pool_id,
    new_span_id,
    record_span,
)
from test_torch_threads import torch_two_threads  # noqa: E402,F401

GPT2_SMALL = {"d": 768, "L": 12, "H": 12, "K": 64, "V": 50257, "P": 1024,
              "F": 3072, "eps": 1e-5}
S = 1_000_000_000
MS = 1_000_000


def read(name, ctx):
    return spec.metric_module(name).read(ctx)


def _round(pool, t0, dur, wait, counts):
    sid = new_span_id()
    record_span("serve.wait", t0 + dur - wait, t0 + dur, 0, sid)
    record_span("serve.round", t0, t0 + dur, sid, 0, (pool,) + counts)


def serve_ctx(t0_s, t1_s, trace=None):
    return {"kind": "serve", "dims": GPT2_SMALL, "dtype": "bfloat16",
            "t0": t0_s, "t1": t1_s, "seconds": t1_s - t0_s,
            "trace": trace}


def test_round_host_ms_is_the_mean_round_less_its_wait():
    pool = new_pool_id()
    base = -1000 * S
    c = (64, 60, 3000, 2800, 16, 10 ** 6)
    _round(pool, base + 1 * S, 10 * MS, 6 * MS, c)
    _round(pool, base + 2 * S, 20 * MS, 8 * MS, c)
    _round(pool, base + 5 * S, 50 * MS, 1 * MS, c)      # after the window
    ctx = serve_ctx(-1000.0, -997.0)
    assert read("serve.round_host_ms", ctx) == pytest.approx(8.0)
    assert read("serve.round_host_ms", serve_ctx(-2000.0, -1999.0)) is None


def test_queue_wait_p95_takes_the_requests_enqueued_in_the_window():
    pool = new_pool_id()
    base = -900 * S
    for k in range(1, 21):
        record_span("serve.queue", base + k * MS, base + 2 * k * MS,
                    counts=(pool,), tag=f"rid-{k}")
    record_span("serve.queue", base - MS, base + 900 * MS, counts=(pool,))
    ctx = serve_ctx(-900.0, -899.0)
    want = float(np.percentile(np.arange(1, 21, dtype=np.float64), 95))
    assert read("serve.queue_wait_p95_ms", ctx) == pytest.approx(want)
    assert read("serve.queue_wait_p95_ms",
                serve_ctx(-1999.0, -1998.0)) is None


def test_paged_attn_roofline_bounds_each_launch_by_the_windows_rounds():
    pool = new_pool_id()
    base = -800 * S
    # (width, lanes, fed, kv_pages, page_size, qk_pairs)
    rounds = [(64, 60, 3000, 2800, 16, 2_000_000),
              (64, 62, 3100, 2600, 16, 2_200_000)]
    for i, c in enumerate(rounds):
        _round(pool, base + i * S, 15 * MS, 6 * MS, c)
    row = 12 * 64 * 2
    kv = (2800 + 2600) / 2 * 16 * 2 * row
    qo = (3000 + 3100) / 2 * 2 * row
    flops = (2_000_000 + 2_200_000) / 2 * 4 * 12 * 64
    bound = max((kv + qo) / peaks.HBM_BYTES_PER_S,
                flops / peaks.PEAK_OPS["bfloat16"])
    launches = 120
    trace = {"counters": {"b1": {64: 100, 1: 20}},
             "kernels": {"paged_attention_mma_kernel":
                         (launches * bound * 1.5, 100),
                         "paged_attention_merge_kernel":
                         (launches * bound * 0.5, 100),
                         "nvjet_gemm": (1.0, 10)}}
    ctx = serve_ctx(-800.0, -798.0, trace)
    assert read("paged_attn_roofline", ctx) == pytest.approx(50.0)
    assert read("paged_attn_roofline", serve_ctx(-800.0, -798.0)) is None
    empty = dict(trace, kernels={})
    assert read("paged_attn_roofline",
                serve_ctx(-800.0, -798.0, empty)) is None
    assert read("paged_attn_roofline",
                serve_ctx(-1999.0, -1998.0, trace)) is None


class _Interval:
    def __init__(self, ns):
        self._ns = ns

    def ns(self):
        return self._ns


def test_train_readers_take_the_window_steps_before_the_traced_ones():
    clear_spans()
    t = -700 * S
    # 3 set-up steps, 5 window steps, 2 traced steps
    lengths = [900, 800, 700, 100, 110, 120, 130, 140, 999, 999]
    for i, ms in enumerate(lengths):
        sid = new_span_id()
        record_span("train.update", t + (ms - 5) * MS, t + ms * MS, 0, sid,
                    (), _Interval((i + 1) * MS))
        record_span("train.step", t, t + ms * MS, sid, 0, (2,))
        t += S
    ctx = {"kind": "train", "steps": 5, "trace": {"steps": 2}}
    assert read("train.host_ms_per_step", ctx) == pytest.approx(120.0)
    # the window's updates are steps 4..8: device 4..8 ms
    assert read("train.update_device_ms", ctx) == pytest.approx(6.0)
    assert read("train.host_ms_per_step",
                {"steps": 0, "trace": {"steps": 2}}) is None
    assert read("train.update_device_ms",
                {"steps": 0, "trace": {"steps": 2}}) is None


def test_train_readers_find_nothing_in_an_empty_ring():
    clear_spans()
    ctx = {"kind": "train", "steps": 5, "trace": {"steps": 2}}
    assert read("train.host_ms_per_step", ctx) is None
    assert read("train.update_device_ms", ctx) is None
    # steps recorded on a CPU carry no device interval
    sid = new_span_id()
    record_span("train.update", 0, 1, 0, sid)
    record_span("train.step", 0, 2, sid, 0, (1,))
    ctx = {"kind": "train", "steps": 1, "trace": None}
    assert read("train.host_ms_per_step", ctx) == pytest.approx(2e-6)
    assert read("train.update_device_ms", ctx) is None


@pytest.mark.parametrize("name", ["serve.round_host_ms",
                                  "serve.queue_wait_p95_ms",
                                  "paged_attn_roofline",
                                  "train.host_ms_per_step",
                                  "train.update_device_ms"])
def test_each_reader_is_declared_under_its_layer(name):
    bench = spec.benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    mod = spec.metric_module(name)
    assert entry["layer"] == mod.LAYER and entry["unit"] == mod.UNIT
    assert entry["moves"] == mod.MOVES
    kind = "train" if name.startswith("train.") else "serve"
    assert all(w.startswith("pretrain." if kind == "train" else "rag.")
               for w in entry["workloads"])
