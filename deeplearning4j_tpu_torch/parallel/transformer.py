"""Transformer LM in PyTorch (counterpart of `deeplearning4j_tpu.parallel.transformer`).

Parameters are a plain dictionary tree with the JAX package's structure
and layouts, so a JAX-written checkpoint and this module's weights are the
same arrays: ``wq``/``wk``/``wv`` are ``[d, H, K]``, ``wo`` is
``[H, K, d]``, tied configs have no ``head`` leaf (the LM head is
``embed.T``).  The projections reshape those layouts to plain matrix
products internally.

`apply` is the full-recompute forward through the flash-attention
kernels and `lm_loss` the training loss on top of it; `_forward` takes
the attention as an argument, and with the plain `attention` it is the
kernel-free checker the paged serving path is held against.  Dense
configs only: MoE layers are not ported yet (ROADMAP.md, queue A,
"MoE transformer layers").
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.parallel.kernels import NEG_INF, flash_attention
from deeplearning4j_tpu_torch.tree import map_tree

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A config dtype string (``"bfloat16"``) or torch dtype -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


@dataclass(frozen=True)
class TransformerConfig:
    """The JAX config's fields, unchanged, so a JAX-written
    ``lm_config.json`` loads with ``TransformerConfig(**json)``."""

    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 256
    n_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    max_len: int = 512
    dtype: str = "float32"
    attn_bias: bool = False
    tie_embeddings: bool = False
    remat: bool = False

    def __post_init__(self):
        if self.n_experts and not (1 <= self.moe_top_k <= self.n_experts):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in [1, "
                f"n_experts={self.n_experts}]")

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def require_dense(cfg: TransformerConfig) -> None:
    """Refuse MoE configs: only dense MLP blocks are ported."""
    if cfg.n_experts:
        raise NotImplementedError(
            f"n_experts={cfg.n_experts}: MoE configs are not ported yet "
            f"(ROADMAP.md, queue A, 'MoE transformer layers')")


def gpt2_small(max_len: int = 1024, dtype: str = "bfloat16"
               ) -> TransformerConfig:
    """GPT-2-small width: vocab 50304, d 768, 12 heads x 64, 12 layers,
    d_ff 3072, tied embeddings, attention biases (~124M parameters)."""
    return TransformerConfig(
        vocab_size=50304, d_model=768, n_heads=12, n_layers=12,
        d_ff=3072, max_len=max_len, dtype=dtype, attn_bias=True,
        tie_embeddings=True, remat=True)


def gpt2_medium(max_len: int = 1024, dtype: str = "bfloat16"
                ) -> TransformerConfig:
    """GPT-2-medium width (~355M parameters: 1024/16/24)."""
    return TransformerConfig(
        vocab_size=50304, d_model=1024, n_heads=16, n_layers=24,
        d_ff=4096, max_len=max_len, dtype=dtype, attn_bias=True,
        tie_embeddings=True, remat=True)


def gpt2_large(max_len: int = 1024, dtype: str = "bfloat16"
               ) -> TransformerConfig:
    """GPT-2-large width (~774M parameters: 1280/20/36)."""
    return TransformerConfig(
        vocab_size=50304, d_model=1280, n_heads=20, n_layers=36,
        d_ff=5120, max_len=max_len, dtype=dtype, attn_bias=True,
        tie_embeddings=True, remat=True)


# ---------------------------------------------------------------------------
# Parameters


def _init_tree(cfg: TransformerConfig, normal: Callable, zeros: Callable,
               ones: Callable, scale: Callable) -> dict:
    """The JAX `init_params` tree structure and scaling, with the random
    source abstracted: ``normal(shape)`` draws standard normals."""
    require_dense(cfg)
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff

    def dense(shape, fan_in):
        return scale(normal(shape), 1.0 / math.sqrt(fan_in))

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": {"scale": ones((d,)), "bias": zeros((d,))},
            "ln2": {"scale": ones((d,)), "bias": zeros((d,))},
            "attn": {"wq": dense((d, h, dh), d), "wk": dense((d, h, dh), d),
                     "wv": dense((d, h, dh), d), "wo": dense((h, dh, d), d)},
            "mlp": {"w1": dense((d, f), d), "b1": zeros((f,)),
                    "w2": dense((f, d), f), "b2": zeros((d,))},
        }
        if cfg.attn_bias:
            layer["attn"].update(bq=zeros((h, dh)), bk=zeros((h, dh)),
                                 bv=zeros((h, dh)), bo=zeros((d,)))
        layers.append(layer)
    # tied configs: the embedding is also the output projection, so it
    # carries the head's 1/sqrt(d) scale
    out = {
        "embed": dense((cfg.vocab_size, d), d if cfg.tie_embeddings else 1),
        "pos": scale(dense((cfg.max_len, d), 1), 0.02),
        "ln_f": {"scale": ones((d,)), "bias": zeros((d,))},
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        out["head"] = dense((d, cfg.vocab_size), d)
    return out


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> dict:
    """Random parameters drawn from `generator` (the JAX init's shapes
    and scales; the random bits differ from ``jax.random``'s)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen_dev = generator.device if generator is not None else dev

    def normal(shape):
        return torch.randn(shape, generator=generator, device=gen_dev,
                           dtype=torch.float32)

    tree = _init_tree(
        cfg, normal,
        zeros=lambda s: torch.zeros(s, dtype=torch.float32),
        ones=lambda s: torch.ones(s, dtype=torch.float32),
        scale=lambda a, c: a * c)
    return map_tree(lambda a: a.to(device=dev, dtype=dt), tree)


def numpy_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """Random float32 parameters as a numpy tree in the JAX layout, drawn
    from ``numpy.random.default_rng(seed)`` — the form both packages
    accept, so one seed gives both the same weights."""
    rng = np.random.default_rng(seed)
    return _init_tree(
        cfg, lambda s: rng.standard_normal(s, dtype=np.float32),
        zeros=lambda s: np.zeros(s, np.float32),
        ones=lambda s: np.ones(s, np.float32),
        scale=lambda a, c: (a * np.float32(c)).astype(np.float32))


def param_shapes(cfg: TransformerConfig) -> dict:
    """The parameter tree with each leaf replaced by its shape tuple."""
    def shape(s):
        return tuple(s)

    return _init_tree(cfg, shape, zeros=shape, ones=shape,
                      scale=lambda a, c: a)


def params_from_numpy(tree: dict, device: DeviceLike = None,
                      dtype=None) -> dict:
    """The weight carry-over: a JAX parameter tree as numpy arrays (same
    keys, JAX layouts) -> this module's parameters, as tensors on
    `device`, cast to `dtype` when given."""
    if any("moe" in layer for layer in tree.get("layers", [])):
        raise NotImplementedError(
            "MoE parameter trees are not ported yet (ROADMAP.md, queue A, "
            "'MoE transformer layers')")
    dev = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None

    def leaf(a):
        # a writable contiguous copy where needed: the tensor may share
        # memory with the array, and JAX hands out read-only views
        t = torch.from_numpy(np.require(np.asarray(a, np.float32),
                                        requirements=["C", "W"]))
        return t.to(device=dev, dtype=dt if dt is not None else t.dtype)

    return map_tree(leaf, tree)


def params_to_numpy(params: dict) -> dict:
    """Inverse of `params_from_numpy`: float32 numpy arrays, JAX layout."""
    return map_tree(lambda t: t.detach().float().cpu().numpy(), params)


# ---------------------------------------------------------------------------
# Blocks


def _layer_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with the population variance and eps 1e-5 (the JAX
    `_layer_norm`)."""
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def qkv_proj(p: Dict[str, torch.Tensor], x: torch.Tensor):
    """[B, S, d] -> q, k, v [B, S, H, K], including optional biases."""
    b, s, d = x.shape
    h, kd = p["wq"].shape[1], p["wq"].shape[2]
    out = []
    for w, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        y = (x @ p[w].reshape(d, h * kd)).view(b, s, h, kd)
        if bias in p:
            y = y + p[bias]
        out.append(y)
    return tuple(out)


def out_proj(p: Dict[str, torch.Tensor], o: torch.Tensor) -> torch.Tensor:
    """[B, S, H, K] attention output -> [B, S, d], including the bias."""
    b, s, h, kd = o.shape
    out = o.reshape(b, s, h * kd) @ p["wo"].reshape(h * kd, -1)
    if "bo" in p:
        out = out + p["bo"]
    return out


def _mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """GELU MLP; ``jax.nn.gelu`` defaults to the tanh approximation."""
    hid = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return hid @ p["w2"] + p["b2"]


def lm_head(params: dict) -> torch.Tensor:
    """The [d, V] output projection: ``head``, or ``embed.T`` when tied."""
    return params["head"] if "head" in params else params["embed"].T


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Plain single-device attention over [B, S, H, D] (the JAX
    `ring_attention.attention`), with f32 scores and sums."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqhd,bkhd->bqhk", qf, kf) / math.sqrt(d)
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril()
    else:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    mask = mask[None, :, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(dim=-1)
    o = torch.einsum("bqhk,bkhd->bqhd", p, vf)
    return (o / lsum.clamp_min(1e-30)[..., None]).to(q.dtype)


def _forward(cfg: TransformerConfig, params: dict, tokens,
             attn: Callable) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, V] with `attn(q, k, v)` as the
    attention of every block.  With ``cfg.remat`` and grad enabled, each
    block is recomputed in the backward (`torch.utils.checkpoint`, the
    counterpart of ``jax.checkpoint(block)``)."""
    require_dense(cfg)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)

    def block(layer, x):
        q, k, v = qkv_proj(layer["attn"], _layer_norm(layer["ln1"], x))
        x = x + out_proj(layer["attn"], attn(q, k, v))
        return x + _mlp(layer["mlp"], _layer_norm(layer["ln2"], x))

    remat = cfg.remat and torch.is_grad_enabled()
    s = tokens.shape[1]
    x = params["embed"][tokens] + params["pos"][None, :s, :]
    for layer in params["layers"]:
        if remat:
            x = checkpoint(block, layer, x, use_reentrant=False)
        else:
            x = block(layer, x)
    x = _layer_norm(params["ln_f"], x)
    return x @ lm_head(params)


def _forward_cache(cfg: TransformerConfig, params: dict,
                   tokens: torch.Tensor, attn: Callable,
                   store: Callable) -> torch.Tensor:
    """The KV-cache prefill: `_forward` without remat and without the LM
    head, handing layer i's keys and values ``[B, S, H, K]`` to
    ``store(i, k, v)``.  Returns the final-layer-norm output ``[B, S,
    d]``."""
    require_dense(cfg)
    x = params["embed"][tokens] + params["pos"][None, :tokens.shape[1], :]
    for i, layer in enumerate(params["layers"]):
        q, k, v = qkv_proj(layer["attn"], _layer_norm(layer["ln1"], x))
        store(i, k, v)
        x = x + out_proj(layer["attn"], attn(q, k, v))
        x = x + _mlp(layer["mlp"], _layer_norm(layer["ln2"], x))
    return _layer_norm(params["ln_f"], x)


def apply(cfg: TransformerConfig, params: dict, tokens,
          causal: bool = True, train: bool = False,
          return_aux: bool = False):
    """tokens [B, S] int -> logits [B, S, V] through the flash-attention
    kernels (`kernels.flash_attention`; the plain version on CPU
    tensors), as the JAX package runs on the TPU.  `train` selects MoE
    routing in JAX and changes nothing for the dense configs ported
    here; `return_aux` also returns the (zero) MoE auxiliary loss."""
    logits = _forward(cfg, params, tokens,
                      lambda q, k, v: flash_attention(q, k, v, causal))
    if return_aux:
        return logits, torch.zeros((), dtype=logits.dtype,
                                   device=logits.device)
    return logits


def lm_loss(cfg: TransformerConfig, params: dict, tokens,
            targets) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch, with the log-softmax
    taken in the logits' dtype (the JAX `lm_loss`)."""
    logits = apply(cfg, params, tokens, train=True)
    targets = torch.as_tensor(targets, device=logits.device).long()
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


__all__ = [
    "NEG_INF",
    "TransformerConfig",
    "apply",
    "attention",
    "gpt2_large",
    "gpt2_medium",
    "gpt2_small",
    "init_params",
    "lm_head",
    "lm_loss",
    "map_tree",
    "numpy_params",
    "out_proj",
    "params_from_numpy",
    "params_to_numpy",
    "qkv_proj",
    "require_dense",
    "torch_dtype",
]
