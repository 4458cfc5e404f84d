"""PrecisionPolicy: the one object that owns every dtype decision
(counterpart of `deeplearning4j_tpu.precision.policy`).

    PrecisionPolicy(param_dtype, compute_dtype, output_dtype, loss_scale)

- ``param_dtype``: what the optimizer holds (the master weights);
- ``compute_dtype``: what the forward and backward run in;
- ``output_dtype``: what `output()` hands back;
- ``loss_scale``: a `LossScaleConfig` turns on the dynamic loss scaler in
  the train step (overflowed steps are skipped, the scale backs off).

Named policies: ``"fp32"`` (everything float32), ``"bf16"`` (params and
compute bfloat16) and ``"mixed"`` (float32 masters, bfloat16 compute,
dynamic loss scaling).  Any floating dtype is accepted by name, float16
included: ``PrecisionPolicy("float32", "float16",
loss_scale=LossScaleConfig())`` is the float16 recipe the scaler exists
for.  Dtypes are kept as their names (``"bfloat16"``), so a policy
compares equal to the JAX package's and round-trips through
``meta.json``; numpy has no bfloat16, so the dtype views here are torch
dtypes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.precision.loss_scale import LossScaleConfig
from deeplearning4j_tpu_torch.tree import map_tree, tree_leaves

Tree = Any


def dtype_of(name) -> torch.dtype:
    """The torch dtype of a dtype name (``"bfloat16"`` -> torch.bfloat16)
    or a torch dtype itself; ValueError when torch has no such dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None) if str(name).isidentifier() \
        else None
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"{name!r} is not a dtype")
    return dt


@dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype policy for one network (frozen, hashable)."""

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"
    loss_scale: Optional[LossScaleConfig] = None

    def __post_init__(self):
        for field in ("param_dtype", "compute_dtype", "output_dtype"):
            name = getattr(self, field)
            try:
                dt = dtype_of(name)
            except ValueError as e:
                raise ValueError(f"{field}={name!r} is not a dtype") from e
            if not dt.is_floating_point:
                raise ValueError(
                    f"{field}={name!r} must be a floating dtype "
                    f"(int8 belongs to the serving quantizer, not the "
                    f"training policy)")

    # ---- construction ------------------------------------------------------

    @classmethod
    def named(cls, name: str) -> "PrecisionPolicy":
        try:
            return dict(
                fp32=cls(),
                float32=cls(),
                bf16=cls(param_dtype="bfloat16", compute_dtype="bfloat16"),
                bfloat16=cls(param_dtype="bfloat16",
                             compute_dtype="bfloat16"),
                mixed=cls(param_dtype="float32", compute_dtype="bfloat16",
                          loss_scale=LossScaleConfig()),
            )[name.lower()]
        except KeyError:
            raise ValueError(
                f"unknown precision policy {name!r}; named policies: "
                f"fp32, bf16, mixed") from None

    @classmethod
    def from_conf(cls, conf) -> "PrecisionPolicy":
        """The policy a `NeuralNetConfiguration` declares."""
        return cls(param_dtype=conf.dtype,
                   compute_dtype=conf.compute_dtype,
                   output_dtype=getattr(conf, "output_dtype", "float32"))

    def with_loss_scale(self, cfg: Optional[LossScaleConfig]
                        ) -> "PrecisionPolicy":
        return dataclasses.replace(self, loss_scale=cfg)

    # ---- derived views -----------------------------------------------------

    @property
    def input_dtype(self) -> torch.dtype:
        """The dtype pipelines should coerce features to: the param dtype
        (float32 for fp32 and mixed; the forward casts)."""
        return dtype_of(self.param_dtype)

    @property
    def is_mixed(self) -> bool:
        return self.param_dtype != self.compute_dtype

    def describe(self) -> str:
        scale = "+loss-scale" if self.loss_scale is not None else ""
        return (f"param={self.param_dtype}/compute={self.compute_dtype}/"
                f"out={self.output_dtype}{scale}")


def resolve_policy(policy, conf=None) -> PrecisionPolicy:
    """A PrecisionPolicy, a named policy, or None (derived from `conf`
    when given, else fp32)."""
    if policy is None:
        return (PrecisionPolicy.from_conf(conf) if conf is not None
                else PrecisionPolicy())
    if isinstance(policy, PrecisionPolicy):
        return policy
    if isinstance(policy, str):
        return PrecisionPolicy.named(policy)
    raise TypeError(f"precision must be a PrecisionPolicy, a policy name "
                    f"or None, got {type(policy).__name__}")


# ---------------------------------------------------------------------------
# dtype casting + byte accounting


def cast_floating(tree: Tree, dtype) -> Tree:
    """Floating leaves of `tree` cast to `dtype` (a torch dtype or name);
    integer leaves (ids, step counters) unchanged."""
    dt = dtype_of(dtype)

    def cast(a):
        a = torch.as_tensor(a)
        return a.to(dt) if a.is_floating_point() else a

    return map_tree(cast, tree)


def _leaf_bytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    a = np.asarray(leaf)
    return int(a.size) * a.dtype.itemsize


def tree_bytes(tree: Tree) -> int:
    """Total bytes of every array leaf (tensor or numpy) of a tree."""
    return sum(_leaf_bytes(leaf) for leaf in tree_leaves(tree))


def param_bytes(net_or_tree) -> int:
    """Resident parameter bytes of a parameter tree, a network, or a
    quantized serving wrapper (which reports its int8 + scale + bias
    footprint)."""
    own = getattr(net_or_tree, "param_bytes", None)
    if callable(own) and not isinstance(net_or_tree, (list, dict, tuple)):
        return int(own())
    return tree_bytes(getattr(net_or_tree, "params", net_or_tree))


def activation_bytes(net, x, mask=None) -> int:
    """Bytes of every activation of one forward at the policy's compute
    dtype (the live-tensor term of the training-memory model)."""
    itemsize = dtype_of(net.precision.compute_dtype).itemsize
    return sum(a.numel() * itemsize for a in net.feed_forward(x, mask))


def train_state_bytes(net, x=None, mask=None, shards: int = 1) -> int:
    """The steady-state per-replica training-memory model of one step:

        master params (param_dtype) + optimizer state (as held)
        + gradients (compute_dtype, one per param)
        + activations (compute_dtype, when an example batch is given).

    ``shards > 1`` applies the ZeRO-1 cost model: params, moments and
    gradients count at their padded 1/N extent, scalar leaves (step
    counters) stay whole, activations never shard.  A model of what the
    step holds, not a measurement of an allocator."""
    from deeplearning4j_tpu_torch.parallel.partition import padded_extent

    params = net.params if net.params is not None else []
    n_params = sum(a.numel() for a in tree_leaves(params))
    shards = max(1, int(shards))

    def frac(num_bytes: int, n_elems: int) -> int:
        if shards == 1 or n_elems == 0:
            return num_bytes
        per = padded_extent(n_elems, shards) // shards
        return int(round(num_bytes * per / n_elems))

    total = frac(tree_bytes(params), n_params)
    upd = net.updater_state
    if upd is None and getattr(net, "_updater_state_owner", None):
        # a live ZeRO-1 trainer holds the moments: publish a per-layer
        # view so the accounting sees them
        net._updater_state_owner.sync_updater_state_to_net()
        upd = net.updater_state
    if upd is not None:
        for leaf in tree_leaves(upd):
            n = leaf.numel() if isinstance(leaf, torch.Tensor) \
                else int(np.size(leaf))
            b = _leaf_bytes(leaf)
            total += b if n <= 1 else frac(b, n)
    total += frac(n_params * dtype_of(net.precision.compute_dtype).itemsize,
                  n_params)
    if x is not None:
        total += activation_bytes(net, x, mask)
    return total


def default_dtype(obj=None) -> torch.dtype:
    """The dtype a pipeline stage should coerce features to: float32 with
    no argument, else the declared input dtype of a network, a
    configuration or a policy."""
    if obj is None:
        return torch.float32
    if isinstance(obj, PrecisionPolicy):
        return obj.input_dtype
    policy = getattr(obj, "precision", None)          # MultiLayerNetwork
    if isinstance(policy, PrecisionPolicy):
        return policy.input_dtype
    conf = getattr(obj, "conf", obj)                   # MultiLayerConfiguration
    conf = getattr(conf, "conf", conf)                 # nested .conf
    if hasattr(conf, "dtype"):
        return PrecisionPolicy.from_conf(conf).input_dtype
    return torch.float32


__all__ = ["PrecisionPolicy", "activation_bytes", "cast_floating",
           "default_dtype", "dtype_of", "param_bytes",
           "resolve_policy", "train_state_bytes", "tree_bytes"]
