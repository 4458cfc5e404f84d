"""deeplearning4j_tpu_torch — the PyTorch / CUDA port of deeplearning4j_tpu.

The JAX package (`deeplearning4j_tpu`) is the reference; this package
re-implements its slices in PyTorch for one NVIDIA H100, module path for
module path (``deeplearning4j_tpu/serving/lm.py`` has its counterpart at
``deeplearning4j_tpu_torch/serving/lm.py``).  Every Pallas TPU kernel on a
ported path becomes a hand-written Hopper kernel under ``csrc/``, built
with ``nvcc`` on first use; its plain PyTorch version runs only for
tensors that lie on the CPU.

The package never imports ``jax`` or anything of ``deeplearning4j_tpu``.
Public entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see `device.resolve_device`).
"""

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

# Lazy top-level conveniences (PEP 562), the JAX package's table:
# `from deeplearning4j_tpu_torch import MultiLayerNetwork` without paying
# for every subpackage at import time.
_LAZY = {
    "MultiLayerNetwork": ("deeplearning4j_tpu_torch.models",
                          "MultiLayerNetwork"),
    "get_model": ("deeplearning4j_tpu_torch.models", "get_model"),
    "generate": ("deeplearning4j_tpu_torch.parallel", "generate"),
    "beam_search": ("deeplearning4j_tpu_torch.parallel", "beam_search"),
    "load_source": ("deeplearning4j_tpu_torch.ml", "load_source"),
    "Evaluation": ("deeplearning4j_tpu_torch.evaluation", "Evaluation"),
}
# the JAX table's multi-device names, not ported
_UNPORTED = {"DataParallelTrainer", "make_mesh"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if name in _UNPORTED:
        raise AttributeError(
            f"deeplearning4j_tpu_torch.{name} is multi-device work, not "
            f"ported (ROADMAP.md, queue A7, 'Multi-device')")
    raise AttributeError(f"module 'deeplearning4j_tpu_torch' has no "
                         f"attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
