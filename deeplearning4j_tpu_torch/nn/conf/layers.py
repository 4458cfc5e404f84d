"""Typed layer configurations (counterpart of
`deeplearning4j_tpu.nn.conf.layers`, field for field: the JSON written by
either package's `to_dict` is read by the other's `from_dict`).

Parity target: reference `nn/conf/layers/*` (RBM, AutoEncoder,
RecursiveAutoEncoder, DenseLayer, ConvolutionLayer, SubsamplingLayer, LSTM,
GravesLSTM, OutputLayer — SURVEY §2.1) plus the flat hyperparameter bag of
`NeuralNetConfiguration.java:66-150`. Here each layer type is a frozen
dataclass carrying exactly its own hyperparameters; a string ``type`` tag keys
serde, mirroring Jackson's @JsonTypeInfo on the reference's conf classes.

Shape/layout conventions (the JAX package's, kept so that weights carry over):
- dense activations: [batch, features]
- conv activations:  NHWC [batch, height, width, channels]
- recurrent:         [batch, time, features] (batch-major for scan-over-time)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Type

_LAYER_TYPES: Dict[str, Type["LayerConf"]] = {}


def register_layer_conf(cls: Type["LayerConf"]) -> Type["LayerConf"]:
    _LAYER_TYPES[cls.type_tag()] = cls
    return cls


@dataclass(frozen=True)
class LayerConf:
    """Fields shared by every layer (reference NeuralNetConfiguration flat bag:
    nIn/nOut :114, activationFunction :116, weightInit :93, dropOut :89,
    l1/l2 :77, dist :84)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    dropout: float = 0.0
    # dropconnect: mask the WEIGHTS (rate = dropout) instead of the input —
    # reference BaseLayer.java:75-79 / Dropout.applyDropConnect.
    use_dropconnect: bool = False
    l1: float = 0.0
    l2: float = 0.0
    # Per-layer learning-rate scale (reference overRideFields lets a layer
    # override the global lr).  Scaling the layer's updates is exactly a
    # per-layer lr for lr-linear updaters; AdaDelta (no lr term) rejects
    # it, and the line-search solvers do too.
    lr_multiplier: float = 1.0
    distribution: Optional[dict] = None
    name: Optional[str] = None

    @classmethod
    def type_tag(cls) -> str:
        return cls.__name__.removesuffix("Conf").lower()

    def to_dict(self) -> dict:
        d = {"type": self.type_tag()}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LayerConf":
        d = dict(d)
        d.pop("type", None)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                v = d[f.name]
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
        return cls(**kwargs)

    def with_overrides(self, **kw: Any) -> "LayerConf":
        """Per-layer override (reference overRideFields
        NeuralNetConfiguration.java:330, done there by reflection)."""
        return dataclasses.replace(self, **kw)


def layer_conf_from_dict(d: dict) -> LayerConf:
    tag = d.get("type")
    if tag not in _LAYER_TYPES:
        raise KeyError(f"Unknown layer type '{tag}'. Known: {sorted(_LAYER_TYPES)}")
    return _LAYER_TYPES[tag].from_dict(d)


@register_layer_conf
@dataclass(frozen=True)
class DenseLayerConf(LayerConf):
    """Fully connected layer (reference conf/layers/DenseLayer)."""


@register_layer_conf
@dataclass(frozen=True)
class OutputLayerConf(LayerConf):
    """Classifier head: dense + activation + loss (reference OutputLayer.java:57)."""

    activation: str = "softmax"
    loss: str = "mcxent"


@register_layer_conf
@dataclass(frozen=True)
class RnnOutputLayerConf(OutputLayerConf):
    """Output layer applied per-timestep over [batch, time, features]."""


@register_layer_conf
@dataclass(frozen=True)
class ConvolutionLayerConf(LayerConf):
    """2-D convolution (reference ConvolutionLayer.java:49, kernelSize/stride
    NeuralNetConfiguration.java:128-130). NHWC; n_in = input channels,
    n_out = output feature maps."""

    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: str = "VALID"  # or "SAME"
    activation: str = "relu"


@register_layer_conf
@dataclass(frozen=True)
class SubsamplingLayerConf(LayerConf):
    """Pooling (reference SubsamplingLayer.java:51; poolingType enum
    NeuralNetConfiguration.java:150: MAX/AVG/SUM/NONE)."""

    pooling_type: str = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: str = "VALID"
    activation: str = "linear"


@register_layer_conf
@dataclass(frozen=True)
class BatchNormConf(LayerConf):
    """Batch normalisation — TPU-era addition (not in the 2015 reference zoo,
    needed for AlexNet/ResNet-class baselines)."""

    momentum: float = 0.9
    epsilon: float = 1e-5
    activation: str = "linear"


@register_layer_conf
@dataclass(frozen=True)
class GravesLSTMConf(LayerConf):
    """Graves LSTM with peepholes (reference GravesLSTM.java:47; params
    RW=[nL, 4nL+3] per GravesLSTMParamInitializer.java:61, forget-bias 5.0
    init at :63-73). Runs as the fused scan (the CUDA kernel of
    ``csrc/lstm.cu`` on the card) or, with a mask, another activation or
    ``fused=False``, as a step-by-step scan with masking — the masking
    the reference stubbed out (GravesLSTM.java:100-106)."""

    activation: str = "tanh"
    forget_gate_bias_init: float = 5.0
    return_sequences: bool = True
    # The port reads None as True: the fused scan (the CUDA kernel on the
    # card) unless False pins the step-by-step scan.  The JAX package
    # reads None through its environment switch (default: the scan).
    fused: Optional[bool] = None


@register_layer_conf
@dataclass(frozen=True)
class LSTMConf(LayerConf):
    """Standard (non-peephole) LSTM (reference nn/layers/recurrent/LSTM.java:58)."""

    activation: str = "tanh"
    forget_gate_bias_init: float = 1.0
    return_sequences: bool = True
    fused: Optional[bool] = None  # see GravesLSTMConf.fused


@register_layer_conf
@dataclass(frozen=True)
class GRUConf(LayerConf):
    """GRU — TPU-era addition beyond the reference recurrent zoo."""

    activation: str = "tanh"
    return_sequences: bool = True


@register_layer_conf
@dataclass(frozen=True)
class EmbeddingLayerConf(LayerConf):
    """Token-id → vector lookup (backs the NLP stack's lookup tables,
    reference InMemoryLookupTable.java:44)."""

    activation: str = "linear"


@register_layer_conf
@dataclass(frozen=True)
class AutoEncoderConf(LayerConf):
    """Denoising autoencoder (reference autoencoder/AutoEncoder.java,
    corruption level; pretrain layer with visible bias per
    PretrainParamInitializer)."""

    corruption_level: float = 0.3
    loss: str = "reconstruction_crossentropy"


@register_layer_conf
@dataclass(frozen=True)
class RBMConf(LayerConf):
    """Restricted Boltzmann Machine (reference rbm/RBM.java:66): CD-k with
    BINARY/GAUSSIAN/RECTIFIED/SOFTMAX visible+hidden units, Gibbs sampling
    via stateless PRNG."""

    visible_unit: str = "binary"
    hidden_unit: str = "binary"
    k: int = 1  # CD-k Gibbs steps
    loss: str = "reconstruction_crossentropy"


@register_layer_conf
@dataclass(frozen=True)
class DropoutLayerConf(LayerConf):
    """Standalone dropout layer."""

    activation: str = "linear"


@register_layer_conf
@dataclass(frozen=True)
class ActivationLayerConf(LayerConf):
    """Standalone activation layer."""
