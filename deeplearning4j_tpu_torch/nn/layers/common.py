"""Helpers shared across layer implementations (counterpart of
`deeplearning4j_tpu.nn.layers.common`).  Random masks come from the
step's `torch.Generator`, which lives on the network's device."""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import LayerConf
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.initializers import init_weights


def dense_params(conf: LayerConf, gen: torch.Generator, dtype) -> dict:
    """W:[n_in,n_out], b:[n_out] — the "W"/"b" param keys of reference
    DefaultParamInitializer.java:37."""
    return {
        "W": init_weights(gen, (conf.n_in, conf.n_out), conf.weight_init,
                          dtype, conf.distribution),
        "b": torch.zeros((conf.n_out,), dtype=dtype),
    }


def _keep_mask(shape, keep: float, rng: torch.Generator,
               device) -> torch.Tensor:
    return torch.rand(shape, generator=rng, device=device) < keep


def apply_dropout(x: torch.Tensor, rate: float, train: bool,
                  rng: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout. No-op unless training with rate>0 and an rng is
    supplied."""
    if not train or rate <= 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, rng, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def activate(conf: LayerConf, z: torch.Tensor) -> torch.Tensor:
    return get_activation(conf.activation)(z)


def effective_weights(conf: LayerConf, params: dict, train: bool,
                      rng: Optional[torch.Generator]) -> torch.Tensor:
    """W with a dropconnect mask when configured (the reference masks the
    weight matrix itself at train time, BaseLayer.java:75-79) using the
    layer's dropout rate."""
    W = params["W"]
    if (getattr(conf, "use_dropconnect", False) and train
            and rng is not None and conf.dropout > 0.0):
        keep = 1.0 - conf.dropout
        mask = _keep_mask(W.shape, keep, rng, W.device)
        W = torch.where(mask, W / keep, torch.zeros_like(W)).to(W.dtype)
    return W


def input_dropout(conf: LayerConf, x: torch.Tensor, train: bool,
                  rng: Optional[torch.Generator]) -> torch.Tensor:
    """Input dropout, skipped when the layer runs dropconnect instead
    (the rate configures the weight mask in that mode)."""
    if getattr(conf, "use_dropconnect", False):
        return x
    return apply_dropout(x, conf.dropout, train, rng)
