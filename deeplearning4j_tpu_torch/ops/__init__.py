"""Numerical building blocks of the port (counterpart of
`deeplearning4j_tpu.ops`): the named activation, loss, initializer and
updater registries.  Names map to plain functions; autograd supplies
every derivative."""

from deeplearning4j_tpu_torch.ops.activations import (
    get_activation,
    register_activation,
)
from deeplearning4j_tpu_torch.ops.initializers import WeightInit, init_weights
from deeplearning4j_tpu_torch.ops.losses import get_loss, register_loss
from deeplearning4j_tpu_torch.ops.updaters import Updater, make_updater

__all__ = [
    "get_activation", "register_activation",
    "get_loss", "register_loss",
    "init_weights", "WeightInit",
    "make_updater", "Updater",
]
