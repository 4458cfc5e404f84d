"""Named activation registry (counterpart of
`deeplearning4j_tpu.ops.activations`): the same names, each a
dtype-preserving torch function over any shape; autograd derives the
gradients.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

ActivationFn = Callable[[torch.Tensor], torch.Tensor]

_ACTIVATIONS: Dict[str, ActivationFn] = {}


def register_activation(name: str, fn: ActivationFn) -> None:
    """Register an activation under a string name (case-insensitive)."""
    _ACTIVATIONS[name.lower()] = fn


def get_activation(name: str) -> ActivationFn:
    """Resolve an activation by name; raises KeyError with known names listed."""
    key = name.lower()
    if key not in _ACTIVATIONS:
        raise KeyError(
            f"Unknown activation '{name}'. Known: {sorted(_ACTIVATIONS)}"
        )
    return _ACTIVATIONS[key]


def available_activations() -> list[str]:
    return sorted(_ACTIVATIONS)


def _hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.hard_sigmoid: relu6(x + 3) / 6
    return F.relu6(x + 3.0) / 6.0


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1 + x.abs())


register_activation("sigmoid", torch.sigmoid)
register_activation("tanh", torch.tanh)
register_activation("relu", torch.relu)
register_activation("leakyrelu", lambda x: F.leaky_relu(x, 0.01))
register_activation("softmax", lambda x: torch.softmax(x, dim=-1))
register_activation("linear", lambda x: x)
register_activation("identity", lambda x: x)
register_activation("softplus", F.softplus)
register_activation("softsign", _softsign)
register_activation("hardtanh", lambda x: torch.clamp(x, -1.0, 1.0))
register_activation("hardsigmoid", _hard_sigmoid)
register_activation("elu", F.elu)
register_activation("selu", F.selu)
register_activation("gelu", _gelu)
register_activation("swish", F.silu)
register_activation("silu", F.silu)
register_activation("exp", torch.exp)
register_activation("abs", torch.abs)
register_activation("sqrt", torch.sqrt)
register_activation("sign", torch.sign)
register_activation("cos", torch.cos)
register_activation("sin", torch.sin)
register_activation("log", torch.log)
register_activation("pow2", torch.square)
register_activation("round", torch.round)
register_activation("floor", torch.floor)
register_activation("ceil", torch.ceil)
register_activation("negative", torch.negative)
register_activation("sqr", torch.square)

__all__ = ["available_activations", "get_activation", "register_activation"]
