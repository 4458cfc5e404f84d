"""Layer implementations: ``init``/``apply`` functions per layer type
(counterpart of `deeplearning4j_tpu.nn.layers`), keyed by the conf's
type tag:

    init(conf, gen, dtype)                  -> (params, state)
    apply(conf, params, state, x, train, rng, mask) -> (y, new_state)

``params`` is a flat dict of named tensors (gradient-bearing), ``state``
holds non-gradient buffers (batch-norm running stats), and ``gen``/``rng``
are `torch.Generator`s (``rng`` None outside training).  Backprop is
autograd over the whole network.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

from deeplearning4j_tpu_torch.nn.conf.layers import LayerConf

class LayerImpl(NamedTuple):
    init: Callable
    apply: Callable


_IMPLS: Dict[str, LayerImpl] = {}


def register_layer_impl(type_tag: str, impl: LayerImpl) -> None:
    _IMPLS[type_tag] = impl


def get_layer_impl(conf: LayerConf) -> LayerImpl:
    tag = conf.type_tag()
    if tag not in _IMPLS:
        raise KeyError(f"No implementation for layer type '{tag}'. "
                       f"Known: {sorted(_IMPLS)}")
    return _IMPLS[tag]


# Importing the implementation modules populates the registry.
from deeplearning4j_tpu_torch.nn.layers import core as _core  # noqa: E402,F401
from deeplearning4j_tpu_torch.nn.layers import convolution as _conv  # noqa: E402,F401
from deeplearning4j_tpu_torch.nn.layers import recurrent as _rec  # noqa: E402,F401
from deeplearning4j_tpu_torch.nn.layers import pretrain as _pre  # noqa: E402,F401
