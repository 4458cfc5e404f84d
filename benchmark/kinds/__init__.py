"""Load kinds: one module a traffic ``kind``, each with
``run(cell, cfg, mix, seed, seconds, trace, device, t_start) -> dict``.

What a kind's ``run`` returns: ``correct``, ``attempted``, ``failed``,
``end_to_end`` (the cell's end-to-end readings), ``timing`` (seconds of
set-up, window, after it, and of the reference), ``ctx`` (what the
per-layer readers read; with a trace only), ``trace`` (the reduced
traced span or None), ``memory_peak_bytes`` and ``numbers`` (those that
decide ``correct``, before their limits).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark.weights import gpt2_dims


def port_config(cfg: dict, remat: bool = False):
    """The port's `TransformerConfig` of a GPT-2 configuration file."""
    from deeplearning4j_tpu_torch.parallel.transformer import (
        TransformerConfig,
    )

    g = gpt2_dims(cfg)
    if (cfg.get("activation_function") != "gelu_new"
            or not cfg.get("tie_word_embeddings", True) or g["eps"] != 1e-5):
        raise ValueError("the port's GPT-2 runs gelu_new, tied embeddings "
                         "and layer-norm eps 1e-5")
    return TransformerConfig(
        vocab_size=g["V"], d_model=g["d"], n_heads=g["H"],
        n_layers=g["L"], d_ff=g["F"], max_len=g["P"], dtype=cfg["dtype"],
        attn_bias=True, tie_embeddings=True, remat=bool(remat))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def p95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))
