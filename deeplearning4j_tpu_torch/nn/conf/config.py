"""Network-level configuration with JSON/YAML round-trip (counterpart of
`deeplearning4j_tpu.nn.conf.config`; the JSON is the contract between the
two packages and each reads what the other writes).

Parity target: reference `NeuralNetConfiguration.java:66` (global
hyperparameter bag + Builder; JSON/YAML via Jackson at :502/:470) and
`MultiLayerConfiguration.java:43` (layer list, pretrain flag, input
preprocessors, fromJson :122). The (config-JSON, flat-param-vector) pair is
the universal model-shipping format — every distributed runtime reconstructs
the model from it (reference IterativeReduceFlatMap.java:73), and ours does
the same (parallel/ + runtime/checkpoint).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf.layers import LayerConf, layer_conf_from_dict
from deeplearning4j_tpu_torch.ops.updaters import Updater, UpdaterConfig


@dataclass(frozen=True)
class NeuralNetConfiguration:
    """Global training hyperparameters (reference NeuralNetConfiguration.java:
    lr :71, momentum :75, l1/l2 :77, updater :79, dropOut :89, weightInit :93,
    optimizationAlgo :94, lossFunction :95, seed, numIterations)."""

    learning_rate: float = 1e-1
    momentum: float = 0.9
    rho: float = 0.95
    epsilon: float = 1e-6
    beta1: float = 0.9
    beta2: float = 0.999
    l1: float = 0.0
    l2: float = 0.0
    updater: str = "sgd"
    optimization_algo: str = "stochastic_gradient_descent"
    num_iterations: int = 1
    max_num_line_search_iterations: int = 5
    seed: int = 123
    weight_init: str = "xavier"
    dropout: float = 0.0
    clip_norm: Optional[float] = None
    clip_value: Optional[float] = None
    minimize: bool = True
    step_function: str = "default"
    use_dropconnect: bool = False
    # Precision knobs (no reference analog): the persisted form of the
    # net's precision policy, so it round-trips through the conf JSON.
    # The port reads all three; its `MultiLayerNetwork` keeps masters in
    # `dtype`, computes in `compute_dtype` and returns `output_dtype`:
    dtype: str = "float32"            # parameter (master-weight) dtype
    compute_dtype: str = "float32"    # activation/matmul dtype (e.g. bfloat16)
    output_dtype: str = "float32"     # what output()/serving hand back

    def __post_init__(self):
        # No config knob may be a silent no-op. step_function variants
        # beyond the default are subsumed by the solvers' line search; a
        # value this framework would ignore must fail loudly instead.
        if self.step_function not in ("default", "negative_gradient"):
            raise ValueError(
                f"step_function={self.step_function!r} is not supported: "
                f"'default' (direction from the chosen solver's line "
                f"search) and 'negative_gradient' behave identically here; "
                f"other reference StepFunctions have no analog")
        algos = ("stochastic_gradient_descent", "line_gradient_descent",
                 "conjugate_gradient", "lbfgs", "hessian_free")
        algo = self.optimization_algo
        algo = getattr(algo, "value", algo)  # accept the str enum member
        if algo == "sgd":  # OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
            # has value 'sgd'; accept both spellings.
            algo = "stochastic_gradient_descent"
        if algo is not self.optimization_algo:
            object.__setattr__(self, "optimization_algo", algo)
        if algo not in algos:
            raise ValueError(f"optimization_algo={algo!r}; known: {algos}")

    def updater_config(self) -> UpdaterConfig:
        return UpdaterConfig(
            updater=Updater(self.updater),
            learning_rate=self.learning_rate,
            momentum=self.momentum,
            rho=self.rho,
            epsilon=self.epsilon,
            beta1=self.beta1,
            beta2=self.beta2,
            l1=self.l1,
            l2=self.l2,
            clip_norm=self.clip_norm,
            clip_value=self.clip_value,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "NeuralNetConfiguration":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class MultiLayerConfiguration:
    """The whole-network config: ordered layer confs + global conf + flags
    (reference MultiLayerConfiguration.java:43-56: pretrain :50, backprop :56,
    input/output preprocessors :54-55)."""

    conf: NeuralNetConfiguration = field(default_factory=NeuralNetConfiguration)
    layers: Tuple[LayerConf, ...] = ()
    pretrain: bool = False
    backprop: bool = True
    # preprocessor between layer i-1's output and layer i's input, keyed by i:
    # {"1": {"type": "cnn_to_ffn", ...}} — reference ConvolutionInputPreProcessor
    input_preprocessors: Dict[str, dict] = field(default_factory=dict)

    def __post_init__(self):
        # Propagate global defaults onto layers that left them at the
        # dataclass default — reference semantics, where the flat
        # NeuralNetConfiguration bag IS the per-layer config and per-layer
        # overrides win (overRideFields :330). A layer explicitly set to the
        # default value is indistinguishable from "unset" and also inherits.
        resolved = []
        for lc in self.layers:
            kw = {}
            if lc.weight_init == "xavier" and self.conf.weight_init != "xavier":
                kw["weight_init"] = self.conf.weight_init
            if lc.dropout == 0.0 and self.conf.dropout != 0.0:
                kw["dropout"] = self.conf.dropout
            # Only dense-family impls honor the weight mask
            # (dense/output/rnn-output); conv/recurrent/pretrain layers do
            # input dropout, so propagating the flag there would claim a
            # regularizer that never runs.
            from deeplearning4j_tpu_torch.nn.conf.layers import (
                DenseLayerConf as _D,
                OutputLayerConf as _O,
            )
            if (not lc.use_dropconnect and self.conf.use_dropconnect
                    and isinstance(lc, (_D, _O))):
                kw["use_dropconnect"] = True
            elif lc.use_dropconnect and not isinstance(lc, (_D, _O)):
                raise ValueError(
                    f"use_dropconnect is only implemented for dense/output "
                    f"layers, not {type(lc).__name__} (layer would silently "
                    f"fall back to input dropout)")
            resolved.append(lc.with_overrides(**kw) if kw else lc)
        object.__setattr__(self, "layers", tuple(resolved))

    # ---- serde: the model-shipping contract -------------------------------
    def to_dict(self) -> dict:
        return {
            "format_version": 1,
            "conf": self.conf.to_dict(),
            "layers": [l.to_dict() for l in self.layers],
            "pretrain": self.pretrain,
            "backprop": self.backprop,
            "input_preprocessors": dict(self.input_preprocessors),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MultiLayerConfiguration":
        return cls(
            conf=NeuralNetConfiguration.from_dict(d.get("conf", {})),
            layers=tuple(layer_conf_from_dict(ld) for ld in d.get("layers", [])),
            pretrain=d.get("pretrain", False),
            backprop=d.get("backprop", True),
            input_preprocessors=d.get("input_preprocessors", {}),
        )

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "MultiLayerConfiguration":
        return cls.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @classmethod
    def from_yaml(cls, s: str) -> "MultiLayerConfiguration":
        import yaml

        return cls.from_dict(yaml.safe_load(s))

    # ---- builder convenience (reference ListBuilder :393) -----------------
    def with_layers(self, *layers: LayerConf) -> "MultiLayerConfiguration":
        return dataclasses.replace(self, layers=tuple(layers))


class Builder:
    """Fluent builder mirroring the reference's
    ``new NeuralNetConfiguration.Builder()...list(n)...build()`` idiom, for
    users migrating from the reference API."""

    def __init__(self) -> None:
        self._conf_kwargs: Dict[str, Any] = {}
        self._layers: List[LayerConf] = []
        self._pretrain = False
        self._backprop = True

    def __getattr__(self, name: str):
        # Any NeuralNetConfiguration field is settable fluently:
        # Builder().learning_rate(0.1).updater("adam")
        if name in {f.name for f in dataclasses.fields(NeuralNetConfiguration)}:
            def setter(value):
                self._conf_kwargs[name] = value
                return self

            return setter
        raise AttributeError(name)

    def layer(self, conf: LayerConf) -> "Builder":
        self._layers.append(conf)
        return self

    def pretrain(self, flag: bool) -> "Builder":
        self._pretrain = flag
        return self

    def backprop(self, flag: bool) -> "Builder":
        self._backprop = flag
        return self

    def build(self) -> MultiLayerConfiguration:
        return MultiLayerConfiguration(
            conf=NeuralNetConfiguration(**self._conf_kwargs),
            layers=tuple(self._layers),
            pretrain=self._pretrain,
            backprop=self._backprop,
        )
