"""Single-device LM training step (subset of
`deeplearning4j_tpu.parallel.hybrid`).

`make_accum_train_step` is the JAX package's GPT-2-class training path:
float32 master parameters, the compute dtype of the config (bfloat16 on
the card) reached by a cast INSIDE the loss, so the gradients land on
the f32 masters; gradient accumulation over `accum` sequential
microbatches; any updater of `ops.updaters`.  The mesh trainers of the
JAX module (dp x sp x tp, pipeline) are not ported yet (ROADMAP.md,
queue A, "Multi-device").
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.ops.updaters import (
    UpdaterConfig,
    apply_updates,
    make_updater,
)
from deeplearning4j_tpu_torch.parallel import transformer as tfm
from deeplearning4j_tpu_torch.tree import map_tree, tree_leaves


def _cast_floating(tree, dtype: torch.dtype):
    """Every floating leaf cast to `dtype` (a differentiable cast: the
    gradient of the cast copy flows back to the leaf)."""
    return map_tree(lambda a: a.to(dtype) if a.is_floating_point() else a,
                    tree)


def _master_f32(tree):
    """Float32 master copies that carry ``requires_grad``: with a bf16
    compute dtype the parameters must not live (or update) in bf16, where
    ``w - lr * g`` rounds away updates below ~0.4% of the weight.  Always
    copies, so the in-place train step never writes into the caller's
    tensors."""
    return map_tree(
        lambda a: (a.detach().to(torch.float32, copy=True)
                   .requires_grad_(True) if a.is_floating_point() else a),
        tree)


def make_accum_train_step(cfg: tfm.TransformerConfig, lr: float = 1e-3,
                          accum: int = 1, updater: str = "sgd",
                          clip_norm: Optional[float] = None,
                          weight_decay: float = 0.0,
                          lr_schedule: Optional[Callable] = None):
    """Returns (step, init_state):

      init_state(params) -> opt_state
      step(params, opt_state, tokens, targets) -> (params, opt_state,
      mean_loss)

    `params` are f32 masters (`_master_f32`); `step` updates them and the
    optimizer state in place and returns them.  tokens/targets are
    ``[accum * mb, S]``; the microbatches run one after another, so
    activation memory is that of one microbatch, and the summed
    gradients and losses are divided by `accum`.  `mean_loss` is a 0-dim
    float32 tensor on the parameters' device."""
    compute_dtype = tfm.torch_dtype(cfg.dtype)
    transform = make_updater(UpdaterConfig(
        updater=updater, learning_rate=lr, clip_norm=clip_norm,
        weight_decay=weight_decay, epsilon=1e-8, lr_schedule=lr_schedule))

    def loss_fn(p32, tok, tgt):
        p = (_cast_floating(p32, compute_dtype)
             if compute_dtype != torch.float32 else p32)
        return tfm.lm_loss(cfg, p, tok, tgt)

    def step(params, opt_state, tokens, targets):
        tokens = torch.as_tensor(tokens)
        targets = torch.as_tensor(targets)
        if tokens.shape[0] % accum:
            raise ValueError(
                f"global batch {tokens.shape[0]} must be divisible by "
                f"accum={accum}")
        dev = params["embed"].device
        leaves = [p for p in tree_leaves(params) if p.requires_grad]
        for p in leaves:
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        s = tokens.shape[1]
        tok_mb = tokens.reshape(accum, -1, s).to(dev)
        tgt_mb = targets.reshape(accum, -1, s).to(dev)
        for i in range(accum):
            l = loss_fn(params, tok_mb[i], tgt_mb[i])
            l.backward()
            loss = loss + l.detach().float()
        grads = map_tree(lambda p: p.grad / accum if accum > 1 else p.grad,
                         params)
        for p in leaves:
            p.grad = None
        updates, opt_state = transform.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, loss / accum

    return step, transform.init


__all__ = ["make_accum_train_step"]
