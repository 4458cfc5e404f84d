"""Dynamic loss scaling for narrow-dtype training (counterpart of
`deeplearning4j_tpu.precision.loss_scale`).

Scaling the loss by S before differentiation multiplies every gradient
by S, lifting small backward signals out of the narrow dtype's
sub-normal floor; the train step divides the gradients by S before the
optimizer sees them, so the update is unchanged unless the scaled
backward overflowed.  The grow/backoff automaton:

- a step whose unscaled gradients (and loss) are all finite is *good*;
  after ``growth_interval`` consecutive good steps the scale multiplies
  by ``growth_factor`` (clamped to ``max_scale``);
- a step with any non-finite value is an *overflow*: the update is
  skipped (the step keeps the old parameters, optimizer state and layer
  state by `torch.where` against their pre-step values), the scale
  multiplies by ``backoff_factor`` (clamped to ``min_scale``) and the
  good-step counter resets.

The state is ``{scale, good_steps, overflow_count}``, 0-d tensors on the
training device, and every transition is `torch.where` arithmetic on
them: no step reads the state back to the host (the JAX package keeps
it inside its jitted step for the same reason).  `shard_update_finite`
is the data-parallel trainer's verdict: one answer for every shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.tree import map_tree, tree_leaves

Tree = Any


@dataclass(frozen=True)
class LossScaleConfig:
    """Grow/backoff automaton parameters (the JAX fields and checks)."""

    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 200
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def __post_init__(self):
        if self.init_scale <= 0:
            raise ValueError(f"init_scale must be > 0, got {self.init_scale}")
        if not (0.0 < self.backoff_factor < 1.0):
            raise ValueError(f"backoff_factor must be in (0, 1), got "
                             f"{self.backoff_factor}")
        if self.growth_factor <= 1.0:
            raise ValueError(f"growth_factor must be > 1, got "
                             f"{self.growth_factor}")
        if self.growth_interval < 1:
            raise ValueError(f"growth_interval must be >= 1, got "
                             f"{self.growth_interval}")
        if not (0 < self.min_scale <= self.init_scale <= self.max_scale):
            raise ValueError(
                f"need min_scale <= init_scale <= max_scale, got "
                f"{self.min_scale}/{self.init_scale}/{self.max_scale}")


def init_scaler_state(cfg: LossScaleConfig,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The automaton's state as 0-d tensors on `device` (the card unless
    the caller asks for the CPU): scale float32, counters int32."""
    dev = resolve_device(device)
    return {"scale": torch.tensor(cfg.init_scale, dtype=torch.float32,
                                  device=dev),
            "good_steps": torch.zeros((), dtype=torch.int32, device=dev),
            "overflow_count": torch.zeros((), dtype=torch.int32,
                                          device=dev)}


def grads_finite(grads: Tree) -> torch.Tensor:
    """0-d bool tensor: every element of every leaf is finite (checked in
    float32, so a 16-bit tree cannot overflow the check itself)."""
    leaves = tree_leaves(grads)
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([torch.isfinite(g.float()).all()
                        for g in leaves]).all()


def shard_update_finite(g_shards: Sequence[torch.Tensor],
                        loss: torch.Tensor, mesh=None) -> torch.Tensor:
    """The lockstep verdict of the ZeRO-1 step: each shard holds only its
    slice of the flat gradient, so a local check would let one shard skip
    while another steps.  The non-finite count of every slice (in
    float32), summed in shard order on the loss's device, must be 0, and
    the (already reduced) loss finite: one 0-d bool for all shards,
    computed on the device with no host read.  Over a `mesh` that spans
    processes `g_shards` are this process's slices and the counts cross
    the process group, so every process reaches the same verdict."""
    from deeplearning4j_tpu_torch.parallel.mesh import psum

    dev = loss.device
    bad = [torch.sum(~torch.isfinite(g.float())).to(dev) for g in g_shards]
    total = psum(bad, dev, mesh)
    return torch.logical_and(total == 0, torch.isfinite(loss))


def unscale_grads(grads: Tree, scale: torch.Tensor) -> Tree:
    """grads / scale, each leaf keeping its dtype (one float32 reciprocal,
    then a float32 multiply per leaf)."""
    inv = (1.0 / scale).float()
    return map_tree(lambda g: (g.float() * inv).to(g.dtype), grads)


def update_scaler_state(cfg: LossScaleConfig, state: Dict[str, torch.Tensor],
                        finite) -> Dict[str, torch.Tensor]:
    """One automaton transition in `torch.where` arithmetic (no host
    read).  `finite` is a 0-d bool tensor or a Python bool."""
    scale = state["scale"]
    finite = torch.as_tensor(finite, dtype=torch.bool, device=scale.device)
    good = torch.where(finite, state["good_steps"] + 1,
                       torch.zeros_like(state["good_steps"]))
    grow = good >= cfg.growth_interval
    grown = torch.where(grow, torch.clamp(scale * cfg.growth_factor,
                                          max=cfg.max_scale), scale)
    good = torch.where(grow, torch.zeros_like(good), good)
    backed = torch.clamp(scale * cfg.backoff_factor, min=cfg.min_scale)
    return {"scale": torch.where(finite, grown, backed),
            "good_steps": good,
            "overflow_count": state["overflow_count"]
            + (~finite).to(torch.int32)}


@torch.no_grad()
def where_tree(cond: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Leafwise ``torch.where(cond, a, b)``: the skip-the-update select,
    which keeps `b` (the pre-step values) where a multiply by a 0/1 mask
    would turn their NaN partner into NaN."""
    return map_tree(lambda x, y: torch.where(cond, x, y), a, b)


class DynamicLossScaler:
    """Convenience wrapper over the functional automaton, for tests and
    interactive use; the network's train step uses the functions
    directly, so the state stays on the device."""

    def __init__(self, cfg: LossScaleConfig = LossScaleConfig(),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.state = init_scaler_state(cfg, device)

    @property
    def scale(self) -> float:
        return float(self.state["scale"])

    @property
    def overflow_count(self) -> int:
        return int(self.state["overflow_count"])

    def observe(self, finite: bool) -> float:
        """Feed one step's finiteness verdict; returns the new scale."""
        self.state = update_scaler_state(self.cfg, self.state, finite)
        return self.scale

    def check_and_update(self, grads: Tree) -> Tuple[Tree, bool]:
        """Unscale `grads` and transition on their finiteness; returns
        (unscaled grads, finite)."""
        gs = unscale_grads(grads, self.state["scale"])
        finite = bool(grads_finite(gs))
        self.observe(finite)
        return gs, finite


__all__ = ["DynamicLossScaler", "LossScaleConfig", "grads_finite",
           "init_scaler_state", "shard_update_finite", "unscale_grads",
           "update_scaler_state", "where_tree"]
