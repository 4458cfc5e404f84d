"""Precision plane: dtype policies, dynamic loss scaling, int8 serving
(counterpart of `deeplearning4j_tpu.precision`).

- :class:`PrecisionPolicy` — (param_dtype, compute_dtype, output_dtype)
  and an optional loss-scale config, threaded through
  `MultiLayerNetwork` and the fused multi-step driver.  Named policies
  ``"fp32"``, ``"bf16"``, ``"mixed"``; `fit(precision=...)`, CLI
  ``train -precision``.
- :mod:`loss_scale` — the grow/backoff automaton; overflowed steps skip
  the update instead of poisoning the master weights and show in
  `scaler_stats()`.
- :mod:`quantize` — per-channel symmetric int8 weights for inference
  (`QuantizedNet`).
- byte accounting (`param_bytes`, `train_state_bytes`,
  `activation_bytes`).
- `shard_update_finite` — the data-parallel trainer's one overflow
  verdict for every shard.
"""

from deeplearning4j_tpu_torch.precision.loss_scale import (  # noqa: F401
    DynamicLossScaler,
    LossScaleConfig,
    grads_finite,
    init_scaler_state,
    shard_update_finite,
    unscale_grads,
    update_scaler_state,
    where_tree,
)
from deeplearning4j_tpu_torch.precision.policy import (  # noqa: F401
    PrecisionPolicy,
    activation_bytes,
    cast_floating,
    default_dtype,
    param_bytes,
    resolve_policy,
    train_state_bytes,
    tree_bytes,
)
from deeplearning4j_tpu_torch.precision.quantize import (  # noqa: F401
    QuantizedNet,
    dequantize,
    int8_conv,
    int8_dense,
    quantize_net_params,
    quantize_symmetric,
)

__all__ = [
    "PrecisionPolicy", "resolve_policy", "cast_floating", "default_dtype",
    "param_bytes", "train_state_bytes", "activation_bytes", "tree_bytes",
    "LossScaleConfig", "DynamicLossScaler", "init_scaler_state",
    "grads_finite", "shard_update_finite", "unscale_grads",
    "update_scaler_state", "where_tree",
    "QuantizedNet", "quantize_symmetric", "dequantize", "int8_dense",
    "int8_conv", "quantize_net_params",
]
