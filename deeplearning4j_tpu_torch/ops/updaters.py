"""Gradient updaters (counterpart of `deeplearning4j_tpu.ops.updaters`).

The JAX module's optax-style transforms over parameter trees, here over
the port's trees of tensors (nested dicts and lists): ``init(params) ->
state`` and ``update(grads, state, params) -> (updates, state)``, where
*updates* is the step to ADD to the parameters (already scaled by -lr),
and `apply_updates` adds it.  The formulas are the JAX package's, term
for term; the scalar factors (bias corrections, schedule values) are
computed in float32 on the host, as JAX computes them in float32.

Where JAX donates buffers, this module works in place: `update` writes
the new accumulators into the state's tensors and `apply_updates` adds
into the parameters.  Everything runs under ``torch.no_grad()``.  The
state is ``{"step": int32 scalar, **accumulator trees}``; each
accumulator keeps the dtype it was created with, and every parameter
keeps its dtype across `apply_updates`.

The step count lives on the CPU, and the step's scalars are host floats.
A loss-scaled step may skip its update on the device without telling the
host (`MultiLayerNetwork` keeps the old step count by `torch.where`), so
there the network moves ``state["step"]`` to its device: on the card the
step then advances there and Adam's bias corrections are float32 0-d
tensors computed there, as JAX computes them from its traced step.  A
learning-rate schedule is a host function of the step and takes the
CPU count only.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.tree import map_tree, tree_leaves

Tree = Any


class Updater(str, enum.Enum):
    SGD = "sgd"
    ADAM = "adam"
    ADAMW = "adamw"
    ADADELTA = "adadelta"
    NESTEROVS = "nesterovs"
    ADAGRAD = "adagrad"
    RMSPROP = "rmsprop"
    LION = "lion"
    NONE = "none"


class UpdaterTransform(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Optional[Tree]], Tuple[Tree, Tree]]


@dataclass(frozen=True)
class UpdaterConfig:
    """The JAX `UpdaterConfig` fields, unchanged."""

    updater: Any = Updater.SGD
    learning_rate: float = 1e-1
    momentum: float = 0.9           # NESTEROVS
    rho: float = 0.95               # ADADELTA / RMSPROP decay
    epsilon: float = 1e-6
    beta1: float = 0.9              # ADAM
    beta2: float = 0.999
    weight_decay: float = 0.0       # ADAMW / LION decoupled decay
    l1: float = 0.0
    l2: float = 0.0
    clip_norm: Optional[float] = None      # global-norm clip
    clip_value: Optional[float] = None     # elementwise clip
    unit_norm: bool = False                # per-leaf unit norm
    lr_schedule: Optional[Callable[[int], float]] = field(
        default=None, compare=False)


def _f32(x: float) -> float:
    """A host scalar rounded to float32, as JAX's float32 scalars are."""
    return float(np.float32(x))


def global_grad_norm(tree: Tree) -> torch.Tensor:
    """Global L2 norm with float32 accumulation (a 0-dim tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def _global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def pre_apply(grads: Tree, params: Tree, cfg: UpdaterConfig) -> Tree:
    """Fold L1/L2 penalties and clipping into the raw gradient (the JAX
    `pre_apply`); returns a new tree, the inputs are not modified."""
    if cfg.l2:
        grads = map_tree(lambda g, p: g + cfg.l2 * p, grads, params)
    if cfg.l1:
        grads = map_tree(lambda g, p: g + cfg.l1 * torch.sign(p), grads,
                         params)
    if cfg.clip_value is not None:
        grads = map_tree(
            lambda g: torch.clamp(g, -cfg.clip_value, cfg.clip_value), grads)
    if cfg.clip_norm is not None:
        gnorm = _global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
        grads = map_tree(lambda g: g * scale.to(g.dtype), grads)
    if cfg.unit_norm:
        grads = map_tree(
            lambda g: g / (torch.linalg.vector_norm(g.reshape(-1)) + 1e-12),
            grads)
    return grads


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to peak_lr over warmup_steps, then cosine decay to
    final_frac * peak_lr at total_steps (held there after).  Returns
    fn(step) -> lr, computed in float32 like the JAX schedule."""
    if warmup_steps < 1 or total_steps <= warmup_steps:
        raise ValueError(
            f"need 1 <= warmup_steps ({warmup_steps}) < total_steps "
            f"({total_steps})")
    f = np.float32

    def schedule(step) -> float:
        s = f(int(step))
        if s < warmup_steps:
            return float(f(peak_lr) * s / f(warmup_steps))
        frac = np.clip((s - f(warmup_steps)) / f(total_steps - warmup_steps),
                       f(0.0), f(1.0))
        cos = f(final_frac) + f(1 - final_frac) * f(0.5) * (
            f(1) + np.cos(f(math.pi) * frac))
        return float(f(peak_lr) * cos)

    return schedule


def _lr_at(cfg: UpdaterConfig, step: int) -> float:
    if cfg.lr_schedule is not None:
        return _f32(cfg.lr_schedule(step))
    return _f32(cfg.learning_rate)


def _host_step(step: torch.Tensor) -> bool:
    """True when the step count is a CPU tensor (the host path)."""
    return step.device.type == "cpu"


def _advance(cfg: UpdaterConfig, step_t: torch.Tensor):
    """(new step tensor, lr, t): the next step count where the count
    lives, the learning rate as a host float, and the step as a float32
    for the bias corrections (a host float with a CPU count, a 0-d
    tensor on the count's device otherwise)."""
    if _host_step(step_t):
        step = int(step_t) + 1
        return (torch.tensor(step, dtype=torch.int32), _lr_at(cfg, step),
                np.float32(step))
    if cfg.lr_schedule is not None:
        raise ValueError("a learning-rate schedule needs the step count "
                         "on the host (it is a host function of the step)")
    new = step_t + 1
    return new, _f32(cfg.learning_rate), new.float()


def _bias_correction(beta: float, t):
    """1 / (1 - beta**t) in float32 (t a host float32 or a 0-d tensor)."""
    if isinstance(t, torch.Tensor):
        b = torch.tensor(beta, dtype=torch.float32, device=t.device)
        return 1.0 / (1.0 - b ** t)
    return _f32(np.float32(1.0) / (np.float32(1.0) - np.float32(beta) ** t))


def make_updater(cfg: UpdaterConfig) -> UpdaterTransform:
    """Build the named updater transform (the JAX `make_updater`)."""
    kind = Updater(cfg.updater)
    if cfg.weight_decay and kind not in (Updater.ADAMW, Updater.LION):
        raise ValueError(
            f"weight_decay={cfg.weight_decay} is ignored by updater "
            f"'{cfg.updater}' — use updater='adamw' (or 'lion'), or the "
            f"coupled cfg.l2 penalty instead")
    slots = {Updater.ADAM: ("m", "v"), Updater.ADAMW: ("m", "v"),
             Updater.NESTEROVS: ("mom",), Updater.ADAGRAD: ("acc",),
             Updater.RMSPROP: ("ms",), Updater.ADADELTA: ("acc_g", "acc_dx"),
             Updater.LION: ("m",)}.get(kind, ())

    def init(params: Tree) -> Tree:
        state = {"step": torch.zeros((), dtype=torch.int32)}
        for name in slots:
            state[name] = map_tree(
                lambda p: torch.zeros_like(p, requires_grad=False), params)
        return state

    @torch.no_grad()
    def update(grads: Tree, state: Tree, params: Optional[Tree] = None):
        grads = pre_apply(grads, params, cfg) if params is not None else grads
        new_step, lr, t = _advance(cfg, state["step"])
        new_state = dict(state)
        new_state["step"] = new_step

        def keep(old, new):
            """Write `new` into the accumulator `old` (its dtype kept)."""
            old.copy_(new)
            return old

        if kind in (Updater.SGD, Updater.NONE):
            updates = map_tree(lambda g: -lr * g, grads)

        elif kind == Updater.NESTEROVS:
            mu = cfg.momentum
            mom = map_tree(lambda v, g: keep(v, mu * v - lr * g),
                           state["mom"], grads)
            updates = map_tree(lambda v, g: mu * v - lr * g, mom, grads)

        elif kind == Updater.ADAGRAD:
            acc = map_tree(lambda a, g: keep(a, a + torch.square(g)),
                           state["acc"], grads)
            updates = map_tree(
                lambda a, g: -lr * g / (torch.sqrt(a) + cfg.epsilon),
                acc, grads)

        elif kind == Updater.RMSPROP:
            rho = cfg.rho
            ms = map_tree(
                lambda s, g: keep(s, rho * s + (1 - rho) * torch.square(g)),
                state["ms"], grads)
            updates = map_tree(
                lambda s, g: -lr * g / (torch.sqrt(s) + cfg.epsilon),
                ms, grads)

        elif kind == Updater.ADADELTA:
            rho, eps = cfg.rho, cfg.epsilon
            acc_g = map_tree(
                lambda a, g: keep(a, rho * a + (1 - rho) * torch.square(g)),
                state["acc_g"], grads)
            dx = map_tree(
                lambda ag, adx, g: -torch.sqrt(adx + eps)
                / torch.sqrt(ag + eps) * g,
                acc_g, state["acc_dx"], grads)
            map_tree(lambda a, d: keep(a, rho * a + (1 - rho)
                                       * torch.square(d)),
                     state["acc_dx"], dx)
            updates = dx

        elif kind in (Updater.ADAM, Updater.ADAMW):
            b1, b2, eps = cfg.beta1, cfg.beta2, cfg.epsilon
            m = map_tree(lambda m_, g: keep(m_, b1 * m_ + (1 - b1) * g),
                         state["m"], grads)
            v = map_tree(
                lambda v_, g: keep(v_, b2 * v_ + (1 - b2) * torch.square(g)),
                state["v"], grads)
            mhat = _bias_correction(b1, t)
            vhat = _bias_correction(b2, t)
            updates = map_tree(
                lambda m_, v_: -lr * (m_ * mhat)
                / (torch.sqrt(v_ * vhat) + eps), m, v)
            if (kind == Updater.ADAMW and cfg.weight_decay
                    and params is not None):
                wd = _f32(lr * _f32(cfg.weight_decay))
                updates = map_tree(lambda u, p: u - wd * p, updates, params)

        elif kind == Updater.LION:
            b1, b2 = cfg.beta1, cfg.beta2
            updates = map_tree(
                lambda m_, g: -lr * torch.sign(b1 * m_ + (1 - b1) * g),
                state["m"], grads)
            if cfg.weight_decay and params is not None:
                wd = _f32(lr * _f32(cfg.weight_decay))
                updates = map_tree(lambda u, p: u - wd * p, updates, params)
            map_tree(lambda m_, g: keep(m_, b2 * m_ + (1 - b2) * g),
                     state["m"], grads)

        else:
            raise ValueError(f"Unhandled updater: {kind}")
        return updates, new_state

    return UpdaterTransform(init=init, update=update)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """p + u into each parameter, in place, keeping the parameter's dtype
    (the sum is taken in the wider of the two dtypes, then stored)."""
    def add(p, u):
        if p.dtype == u.dtype:
            p.add_(u)
        else:
            p.copy_(p.to(torch.promote_types(p.dtype, u.dtype)) + u)
        return p

    return map_tree(add, params, updates)


__all__ = ["Updater", "UpdaterConfig", "UpdaterTransform", "apply_updates",
           "global_grad_norm", "make_updater", "pre_apply", "warmup_cosine"]
