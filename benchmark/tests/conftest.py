"""Shared fixtures of the benchmark's tests: tiny GPT-2 configurations and
mixes that a CPU runs in seconds, and the ``cuda`` marker's skip,
decided inside a fixture."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import spec  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs the card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark runs on the card)")
    return torch.device("cuda", 0)


@pytest.fixture
def bench():
    return spec.benchmark()


def tiny_config(dtype="bfloat16", **kw):
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "gpt2-small.json")
    cfg.update(n_embd=64, n_layer=2, n_head=4, vocab_size=512,
               n_positions=128, n_ctx=128, dtype=dtype)
    cfg.update(kw)
    return cfg


def tiny_serve_mix(name="chat"):
    mix = copy.deepcopy(spec.traffic(name))
    shared = name == "chat"
    mix.update(clients=3, shared_prefixes=2 if shared else 0,
               prefix_tokens=32 if shared else 0,
               unique_tokens=[8, 24] if shared else [40, 64],
               output_tokens=[2, 4], ramp_s=0.1, settle_s=0.3,
               check_tokens=16, trace_s=0.3)
    mix["server"] = dict(mix["server"], slots=3, prefill_chunk=8)
    return mix


def tiny_train_mix():
    mix = copy.deepcopy(spec.traffic("pretrain"))
    mix.update(global_batch=4, seq_len=32, accum=2, staged_batches=4,
               reference_rows=2, trace_steps=1)
    return mix
