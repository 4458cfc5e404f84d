"""Weight initialisation schemes (counterpart of
`deeplearning4j_tpu.ops.initializers`): the same schemes and scales,
drawn from an explicit `torch.Generator` instead of a `jax.random` key.
The two generators give different numbers from one seed, so parity with
the JAX package carries the weights across (`models.params_from_numpy`)
rather than re-drawing them.  Draws happen on the CPU, so a seed gives
the same weights whatever device the network then lives on.
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Sequence

import torch


class WeightInit(str, enum.Enum):
    """Named schemes; string-valued so configs serialise cleanly to JSON."""

    DISTRIBUTION = "distribution"
    NORMALIZED = "normalized"
    SIZE = "size"
    UNIFORM = "uniform"
    VI = "vi"
    ZERO = "zero"
    XAVIER = "xavier"
    HE = "he"
    LECUN = "lecun"
    ORTHOGONAL = "orthogonal"


def _fans(shape: Sequence[int]) -> tuple[int, int]:
    """(fan_in, fan_out) for dense [in, out] and conv [h, w, in, out] kernels."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       dtype=torch.float32)


def init_weights(gen: torch.Generator, shape: Sequence[int],
                 scheme: WeightInit | str = WeightInit.XAVIER,
                 dtype: torch.dtype = torch.float32,
                 distribution: Optional[dict] = None) -> torch.Tensor:
    """Draw a weight tensor on the CPU from `gen`. `distribution` backs the
    DISTRIBUTION scheme with {"type": "normal"|"uniform"|"binomial", ...}."""
    scheme = WeightInit(scheme)
    shape = tuple(shape)
    fan_in, fan_out = _fans(shape)
    if scheme == WeightInit.ZERO:
        w = torch.zeros(shape)
    elif scheme == WeightInit.XAVIER:
        w = _normal(gen, shape) * math.sqrt(2.0 / (fan_in + fan_out))
    elif scheme == WeightInit.SIZE:
        a = math.sqrt(6.0 / (fan_in + fan_out))
        w = _uniform(gen, shape, -a, a)
    elif scheme == WeightInit.UNIFORM:
        a = 1.0 / math.sqrt(fan_in)
        w = _uniform(gen, shape, -a, a)
    elif scheme == WeightInit.NORMALIZED:
        w = (_uniform(gen, shape) - 0.5) / fan_in
    elif scheme == WeightInit.VI:
        r = math.sqrt(6.0 / (fan_in + fan_out + 1.0)) * 4.0
        w = _uniform(gen, shape, -r, r)
    elif scheme == WeightInit.HE:
        w = _normal(gen, shape) * math.sqrt(2.0 / fan_in)
    elif scheme == WeightInit.LECUN:
        w = _normal(gen, shape) * math.sqrt(1.0 / fan_in)
    elif scheme == WeightInit.ORTHOGONAL:
        w = torch.empty(shape)
        torch.nn.init.orthogonal_(w.reshape(shape[0], -1)
                                  if len(shape) > 2 else w, generator=gen)
    else:                                     # DISTRIBUTION
        dist = dict(distribution or {"type": "normal", "mean": 0.0,
                                     "std": 0.01})
        kind = dist.get("type", "normal")
        if kind == "normal":
            w = (_normal(gen, shape) * dist.get("std", 0.01)
                 + dist.get("mean", 0.0))
        elif kind == "uniform":
            w = _uniform(gen, shape, dist.get("lower", -1.0),
                         dist.get("upper", 1.0))
        elif kind == "binomial":
            probs = torch.full(shape, float(dist.get("p", 0.5)))
            w = torch.binomial(torch.full(shape, float(dist.get("n", 1))),
                               probs, generator=gen)
        else:
            raise ValueError(f"Unknown distribution type: {kind}")
    return w.to(dtype)


__all__ = ["WeightInit", "init_weights"]
