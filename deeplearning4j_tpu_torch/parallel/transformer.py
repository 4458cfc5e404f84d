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
kernel-free checker the paged serving path is held against.

MoE configs (``n_experts > 0``) replace each block's MLP by ``moe``
experts: a softmax router picks ``moe_top_k`` experts a token (the lower
index first among equal probabilities, as ``lax.top_k`` orders them),
training routes by capacity dispatch (`_moe_dispatch`) and adds the
Switch load-balancing loss, and inference computes every expert densely
and masks (`_moe_dense`, the oracle of the dispatch).

With a `mesh` (axes `MeshAxes`: data, seq, model) `apply` and `lm_loss`
run the same model as one program over the mesh's shards: rows are cut
over ``data`` in contiguous blocks and positions over ``seq`` (position
embeddings at global positions); each ``model`` shard runs its heads and
its hidden slice (`param_specs`), and the shards' outputs are summed
across ``model`` in shard order before the replicated biases ``bo`` and
``b2`` are added once; attention is `ring_flash_attention` over ``seq``;
MoE blocks route over the global tokens in (batch, position) order, as
the JAX dispatch on the full array does, and ``model`` shard t computes
only the experts it owns.  The JAX package writes this as one GSPMD
program; here it is one SPMD program a process (`mesh.Program`): each
process computes its own shards, every shard on its own copies of the
parameters and activations it uses, and the shards meet only in the
program's exchanges, which add in global shard order forward and
backward, so the result is the same bits however the shards fall into
processes.  A ``(data, seq)`` block's loss is scored once, on its
``model`` shard 0.
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
from deeplearning4j_tpu_torch.parallel import partition as part_lib
from deeplearning4j_tpu_torch.parallel.kernels import NEG_INF, flash_attention
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, Program
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    attention,
    ring_flash_attention,
)
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


@dataclass(frozen=True)
class MeshAxes:
    """Which mesh axis carries which parallelism dimension."""

    data: str = "data"
    seq: str = "seq"
    model: str = "model"


def param_specs(cfg: TransformerConfig, model_axis: Optional[str]) -> dict:
    """The placement of every parameter over the ``model`` axis, in the
    `partition` vocabulary: wq / wk / wv split the head dim (1) and wo
    dim 0; bq / bk / bv dim 0, bo replicated; the MLP's w1 dim 1, b1 and
    w2 dim 0, b2 replicated; the MoE gate replicated and w1 / b1 / w2 /
    b2 the expert dim (expert parallelism rides the model axis).
    Everything else, and everything when `model_axis` is None, is
    replicated."""
    def split(dim):
        return (part_lib.sharded(model_axis, dim) if model_axis is not None
                else part_lib.replicated())

    rep = part_lib.replicated
    layer_spec = {
        "ln1": {"scale": rep(), "bias": rep()},
        "ln2": {"scale": rep(), "bias": rep()},
        "attn": {"wq": split(1), "wk": split(1), "wv": split(1),
                 "wo": split(0)},
    }
    if cfg.attn_bias:
        layer_spec["attn"].update(bq=split(0), bk=split(0), bv=split(0),
                                  bo=rep())
    if cfg.n_experts:
        layer_spec["moe"] = {"gate": rep(), "w1": split(0), "b1": split(0),
                             "w2": split(0), "b2": split(0)}
    else:
        layer_spec["mlp"] = {"w1": split(1), "b1": split(0), "w2": split(0),
                             "b2": rep()}
    out = {"embed": rep(), "pos": rep(),
           "ln_f": {"scale": rep(), "bias": rep()},
           "layers": [layer_spec for _ in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        out["head"] = rep()
    return out


# ---------------------------------------------------------------------------
# Parameters


def _init_tree(cfg: TransformerConfig, normal: Callable, zeros: Callable,
               ones: Callable, scale: Callable) -> dict:
    """The JAX `init_params` tree structure and scaling, with the random
    source abstracted: ``normal(shape)`` draws standard normals."""
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
        }
        if cfg.attn_bias:
            layer["attn"].update(bq=zeros((h, dh)), bk=zeros((h, dh)),
                                 bv=zeros((h, dh)), bo=zeros((d,)))
        if cfg.n_experts:
            e = cfg.n_experts
            layer["moe"] = {"gate": dense((d, e), d),
                            "w1": dense((e, d, f), d), "b1": zeros((e, f)),
                            "w2": dense((e, f, d), f), "b2": zeros((e, d))}
        else:
            layer["mlp"] = {"w1": dense((d, f), d), "b1": zeros((f,)),
                            "w2": dense((f, d), f), "b2": zeros((d,))}
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


def _router_weights(probs: torch.Tensor, top_k: int):
    """(top_idx, weights) ``[..., k]``.  k = 1: the Switch top-1 router
    probability itself; k > 1: renormalized over the chosen experts.
    Among equal probabilities the lower expert index comes first, as
    ``lax.top_k`` orders them (`torch.topk` promises no order, and a
    bfloat16 softmax over a few experts ties often): a stable descending
    sort."""
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[..., :top_k], top_idx[..., :top_k]
    if top_k > 1:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_idx, top_p


def _experts(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Every expert's tanh-GELU MLP over its own rows: x ``[E, M, d]`` ->
    ``[E, M, d]``."""
    hid = F.gelu(torch.bmm(x, p["w1"]) + p["b1"][:, None, :],
                 approximate="tanh")
    return torch.bmm(hid, p["w2"]) + p["b2"][:, None, :]


def _moe_in(p: Dict[str, torch.Tensor], x: torch.Tensor,
            capacity_factor: float, top_k: int):
    """The MoE block up to its experts: (the experts' input ``[E, M,
    d]``, ``combine(y, rows=None)``: the outputs ``[len(rows), d]`` of
    the token rows `rows` (flat indices into ``[B * S]``; None: every
    token in order) from the experts' outputs y ``[E, M, d]``).

    Capacity factor > 0: capacity dispatch (Switch routing at k = 1,
    GShard's top-2 at k = 2): the N * k assignments are scattered into
    an ``[E, C, d]`` buffer, each expert computes only its buffer, and
    the outputs gather back weighted by the router weight, summed over a
    token's k assignments; a dropped assignment contributes zero (the
    residual around the block passes its token through).  Capacity
    factor 0: the dense-masked oracle, every expert over every token,
    the pairs not routed weighted 0.  The gate logits and softmax are
    taken in x's dtype."""
    b, s, d = x.shape
    e = p["gate"].shape[1]
    xf = x.reshape(b * s, d)
    if capacity_factor > 0:
        e_flat, slot, w_flat, keep, c = _moe_route(p, xf, capacity_factor,
                                                   top_k)
        x_rep = xf.repeat_interleave(top_k, dim=0) * keep[:, None]
        # each kept assignment owns its (expert, slot) exclusively and a
        # dropped one adds exact zeros, so the accumulated scatter is
        # exact in any order, CUDA atomics included
        buf = torch.zeros((e, c, d), dtype=x.dtype,
                          device=x.device).index_put((e_flat, slot), x_rep,
                                                     accumulate=True)
        wk = w_flat * keep

        def combine(y, rows=None):
            if rows is None:
                out, n = y[e_flat, slot] * wk[:, None], b * s
            else:
                a = (rows[:, None] * top_k + torch.arange(
                    top_k, device=rows.device)).reshape(-1)
                out, n = y[e_flat[a], slot[a]] * wk[a][:, None], len(rows)
            return out.reshape(n, top_k, d).sum(dim=1)

        return buf, combine
    gate_w = torch.softmax(x @ p["gate"], dim=-1)               # [B,S,E]
    top_idx, w = _router_weights(gate_w, top_k)                # [B,S,k]
    comb = (w[..., None] * F.one_hot(top_idx, e).to(x.dtype)).sum(-2) \
        .reshape(b * s, e)

    def combine(y, rows=None):
        if rows is None:
            return torch.einsum("end,ne->nd", y, comb)
        return torch.einsum("end,ne->nd", y[:, rows], comb[rows])

    return xf.reshape(1, b * s, d).expand(e, b * s, d), combine


def _moe_dense(p: Dict[str, torch.Tensor], x: torch.Tensor,
               top_k: int = 1) -> torch.Tensor:
    """Top-k MoE with dense-masked compute: every expert sees every token
    and the combine weight zeroes the pairs not routed, so nothing is
    dropped.  The oracle of `_moe_dispatch` and the inference path."""
    xe, combine = _moe_in(p, x, 0.0, top_k)
    return combine(_experts(p, xe)).reshape(x.shape)


def _moe_route(p: Dict[str, torch.Tensor], xf: torch.Tensor,
               capacity_factor: float, top_k: int):
    """The capacity router over xf ``[N, d]`` -> (expert ``[A]``, slot
    ``[A]`` clipped to ``[0, C)``, weight ``[A]``, keep ``[A]`` in x's
    dtype, C).  An expert's buffer holds ``C = max(1, min(A, ceil(cf A /
    E)))`` of the ``A = N k`` assignments.  Assignments are token-major
    (a token's second choice ranks after its first); an assignment's
    slot is its 0-based rank among those of its expert, and one at C or
    above is dropped."""
    e = p["gate"].shape[1]
    a = xf.shape[0] * top_k
    c = max(1, min(a, int(math.ceil(capacity_factor * a / e))))
    gate_w = torch.softmax(xf @ p["gate"], dim=-1)             # [N,E]
    top_idx, top_w = _router_weights(gate_w, top_k)            # [N,k]
    e_flat = top_idx.reshape(-1)
    onehot = F.one_hot(e_flat, e)
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=1) - 1
    keep = (slot < c).to(xf.dtype)
    return e_flat, slot.clamp(0, c - 1), top_w.reshape(-1), keep, c


def _moe_dispatch(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  capacity_factor: float, top_k: int = 1) -> torch.Tensor:
    """Capacity-based top-k dispatch (`_moe_in`): each expert computes
    only its ``[C, d]`` buffer."""
    buf, combine = _moe_in(p, x, capacity_factor, top_k)
    return combine(_experts(p, buf)).reshape(x.shape)


def _moe(p: Dict[str, torch.Tensor], x: torch.Tensor,
         capacity_factor: float = 0.0, top_k: int = 1) -> torch.Tensor:
    """The MoE block: capacity dispatch when capacity_factor > 0, the
    dense-masked oracle otherwise."""
    buf, combine = _moe_in(p, x, capacity_factor, top_k)
    return combine(_experts(p, buf)).reshape(x.shape)


def _moe_aux_loss(p: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss ``E * sum_e f_e * P_e``: f is the
    fraction of tokens whose largest router logit is expert e (top-1
    whatever k is; no gradient), P the mean router probability."""
    e = p["gate"].shape[1]
    logits = x @ p["gate"]
    probs = torch.softmax(logits, dim=-1)
    f = F.one_hot(logits.argmax(dim=-1), e).to(x.dtype).mean(dim=(0, 1))
    return e * (f * probs.mean(dim=(0, 1))).sum()


def _ffn(cfg: TransformerConfig, layer: dict, h: torch.Tensor,
         capacity_factor: float = 0.0) -> torch.Tensor:
    """A block's feed-forward half on its normed input: the MLP, or the
    MoE with `cfg.moe_top_k` (dense-masked at capacity factor 0)."""
    if "moe" in layer:
        return _moe(layer["moe"], h, capacity_factor, cfg.moe_top_k)
    return _mlp(layer["mlp"], h)


def lm_head(params: dict) -> torch.Tensor:
    """The [d, V] output projection: ``head``, or ``embed.T`` when tied."""
    return params["head"] if "head" in params else params["embed"].T


def _forward(cfg: TransformerConfig, params: dict, tokens,
             attn: Callable, train: bool = False, return_aux: bool = False):
    """tokens [B, S] int -> logits [B, S, V] with `attn(q, k, v)` as the
    attention of every block.  With ``cfg.remat`` and grad enabled, each
    block is recomputed in the backward (`torch.utils.checkpoint`, the
    counterpart of ``jax.checkpoint(block)``).  MoE blocks route by
    capacity dispatch when `train` (with ``cfg.moe_capacity_factor``),
    dense-masked otherwise; `return_aux` also returns the mean over
    layers of the load-balancing loss (0 for dense configs)."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    cf = cfg.moe_capacity_factor if train else 0.0

    def block(layer, x):
        q, k, v = qkv_proj(layer["attn"], _layer_norm(layer["ln1"], x))
        x = x + out_proj(layer["attn"], attn(q, k, v))
        h = _layer_norm(layer["ln2"], x)
        x = x + _ffn(cfg, layer, h, cf)
        if not return_aux:
            return x
        aux = (_moe_aux_loss(layer["moe"], h) if "moe" in layer
               else torch.zeros((), dtype=x.dtype, device=x.device))
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    s = tokens.shape[1]
    x = params["embed"][tokens] + params["pos"][None, :s, :]
    auxs = []
    for layer in params["layers"]:
        out = (checkpoint(block, layer, x, use_reentrant=False) if remat
               else block(layer, x))
        if return_aux:
            x, aux = out
            auxs.append(aux)
        else:
            x = out
    x = _layer_norm(params["ln_f"], x)
    logits = x @ lm_head(params)
    if return_aux:
        return logits, torch.stack(auxs).mean()
    return logits


def _forward_cache(cfg: TransformerConfig, params: dict,
                   tokens: torch.Tensor, attn: Callable,
                   store: Callable) -> torch.Tensor:
    """The KV-cache prefill: `_forward` without remat and without the LM
    head, handing layer i's keys and values ``[B, S, H, K]`` to
    ``store(i, k, v)``.  Returns the final-layer-norm output ``[B, S,
    d]``.  MoE blocks are dense-masked."""
    x = params["embed"][tokens] + params["pos"][None, :tokens.shape[1], :]
    for i, layer in enumerate(params["layers"]):
        q, k, v = qkv_proj(layer["attn"], _layer_norm(layer["ln1"], x))
        store(i, k, v)
        x = x + out_proj(layer["attn"], attn(q, k, v))
        x = x + _ffn(cfg, layer, _layer_norm(layer["ln2"], x))
    return _layer_norm(params["ln_f"], x)


# ---------------------------------------------------------------------------
# The mesh program


class _Grid:
    """A mesh read as (data, seq, model) coordinates: the sizes dp, sp
    and tp (an axis the mesh does not have counts 1), and each shard's
    index, coordinates and device."""

    def __init__(self, mesh: Mesh, axes: MeshAxes):
        names = (axes.data, axes.seq, axes.model)
        extra = [a for a in mesh.axis_names if a not in names]
        if extra:
            raise ValueError(f"mesh axes {extra} are none of {names}")
        shape = mesh.shape
        self.mesh, self.axes, self._names = mesh, axes, names
        self.dp, self.sp, self.tp = (shape.get(a, 1) for a in names)

    def shard(self, d: int = 0, s: int = 0, t: int = 0) -> int:
        return self.mesh.shard(**dict(zip(self._names, (d, s, t))))

    def coords(self, shard: int):
        """(d, s, t) of a shard."""
        return tuple(self.mesh.coord(shard, a) for a in self._names)

    def device(self, d: int = 0, s: int = 0, t: int = 0) -> torch.device:
        return self.mesh.flat_devices()[self.shard(d, s, t)]

    def check(self, cfg: TransformerConfig, b: Optional[int] = None,
              s: Optional[int] = None) -> None:
        """ValueError unless the heads and experts split over ``model``
        and the batch and positions over ``data`` and ``seq``."""
        if cfg.n_heads % self.tp:
            raise ValueError(f"n_heads {cfg.n_heads} does not split over "
                             f"{self.tp} '{self.axes.model}' shards")
        if cfg.n_experts and cfg.n_experts % self.tp:
            raise ValueError(f"n_experts {cfg.n_experts} does not split "
                             f"over {self.tp} '{self.axes.model}' shards")
        if b is not None and b % self.dp:
            raise ValueError(f"batch {b} does not split over {self.dp} "
                             f"'{self.axes.data}' shards")
        if s is not None and s % self.sp:
            raise ValueError(f"sequence length {s} does not split over "
                             f"{self.sp} '{self.axes.seq}' shards")


def _on(tree, device: torch.device):
    """A tree's tensors on `device` (the tensors themselves when there)."""
    return map_tree(lambda a: a.to(device), tree)


def _shard_params(cfg: TransformerConfig, params: dict, prog: Program,
                  grid: _Grid) -> dict:
    """Each local shard's parameters, ``{shard: tree}``, through one
    `Program.broadcast`: a leaf split over ``model`` and given as the
    list of its slices (`place_params`; None where another process holds
    a slice) sends slice t to the shards of ``model`` index t; any other
    leaf goes whole to every shard, which cuts its own slice of a split
    one.  So each parameter's gradient is the sum over the shards that
    used it, in shard order, on every process that holds it."""
    values, groups = [], []
    by_t = [[s for s in prog.scope if grid.coords(s)[2] == t]
            for t in range(grid.tp)]

    def collect(spec, leaf):
        if isinstance(leaf, list):
            values.extend(leaf)
            groups.extend(by_t)
            return ("slices", len(values) - grid.tp, spec)
        values.append(leaf)
        groups.append(prog.scope)
        return ("whole", len(values) - 1, spec)

    plan = map_tree(collect, param_specs(cfg, "model"), params)
    copies = prog.broadcast(values, groups)

    def pick(s):
        t = grid.coords(s)[2]

        def leaf(entry):
            kind, i, spec = entry
            if kind == "slices":
                return copies[i + t][s]
            a = copies[i][s]
            return a if spec.is_replicated else a.chunk(grid.tp,
                                                        dim=spec.dim)[t]

        return map_tree(leaf, plan)

    return {s: pick(s) for s in prog.local}


def _seg_qkv(ln1: dict, attn: dict, x: torch.Tensor):
    return qkv_proj(attn, _layer_norm(ln1, x))


def _seg_out(wo: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    b, sl, h, kd = o.shape
    return o.reshape(b, sl, h * kd) @ wo.reshape(h * kd, -1)


def _seg_mid(x, y, bo, ln2: dict):
    """The attention's residual (with bo once), and its normed output."""
    x = x + (y if bo is None else y + bo)
    return x, _layer_norm(ln2, x)


def _seg_mlp(x, y, bo, ln2: dict, mlp: dict):
    x, h = _seg_mid(x, y, bo, ln2)
    hid = F.gelu(h @ mlp["w1"] + mlp["b1"], approximate="tanh")
    return x, hid @ mlp["w2"]


def _block_rows(grid: _Grid, shard: int, b: int, sl: int, seq: int,
                device) -> torch.Tensor:
    """The flat (batch, position) indices of a shard's ``[b, sl]`` block
    in a ``[B, S]`` batch, in the block's order."""
    d, j, _ = grid.coords(shard)
    rows = torch.arange(d * b, (d + 1) * b, device=device)
    pos = torch.arange(j * sl, (j + 1) * sl, device=device)
    return (rows[:, None] * seq + pos[None, :]).reshape(-1)


def _mesh_layer(cfg: TransformerConfig, prog: Program, grid: _Grid,
                lp: dict, xs: dict, causal: bool, cf: float, want_aux: bool,
                seq: int):
    """One block over every local shard: each shard's heads, the ring
    over ``seq``, the ``model`` sum plus bo once; then the MLP (its
    hidden slice, summed, plus b2 once) or the MoE (routing over the
    global tokens in (batch, position) order on each shard's copy, each
    ``model`` shard computing its experts).  Returns (outputs, the aux
    loss on shard 0 or None)."""
    local = prog.local
    axes = grid.axes
    qkv = {s: _seg_qkv(lp[s]["ln1"], lp[s]["attn"], xs[s]) for s in local}
    o = ring_flash_attention(*({s: t[i] for s, t in qkv.items()}
                               for i in range(3)), axes.seq, causal,
                             program=prog)
    y = prog.psum({s: _seg_out(lp[s]["attn"]["wo"], o[s]) for s in local},
                  axes.model)
    if "mlp" in lp[local[0]]:
        mid = {s: _seg_mlp(xs[s], y[s], lp[s]["attn"].get("bo"),
                           lp[s]["ln2"], lp[s]["mlp"]) for s in local}
        y2 = prog.psum({s: m[1] for s, m in mid.items()}, axes.model)
        return {s: mid[s][0] + (y2[s] + lp[s]["mlp"]["b2"])
                for s in local}, None
    mid = {s: _seg_mid(xs[s], y[s], lp[s]["attn"].get("bo"), lp[s]["ln2"])
           for s in local}
    full = prog.all_gather({s: m[1] for s, m in mid.items()}, axes.seq,
                           dim=1)
    full = prog.all_gather(full, axes.data, dim=0)         # [B, S, d]
    e_loc = cfg.n_experts // grid.tp
    combines, ys = {}, {}
    for s in local:
        t = grid.coords(s)[2]
        buf, combines[s] = _moe_in({"gate": lp[s]["moe"]["gate"]},
                                   full[s], cf, cfg.moe_top_k)
        ys[s] = _experts(lp[s]["moe"], buf[t * e_loc:(t + 1) * e_loc])
    ys = prog.all_gather(ys, axes.model, dim=0)
    out = {}
    for s in local:
        x = mid[s][0]
        b, sl, d = x.shape
        rows = _block_rows(grid, s, b, sl, seq, x.device)
        out[s] = x + combines[s](ys[s], rows).reshape(b, sl, d)
    aux = None
    if want_aux and 0 in local:
        aux = _moe_aux_loss({"gate": lp[0]["moe"]["gate"]}, full[0])
    return out, aux


class _RematLayer(torch.autograd.Function):
    """A block over every local shard that keeps only its inputs for the
    backward, the counterpart of ``jax.checkpoint(block)`` with the ring
    inside the block.  The forward runs ``run(inputs)`` without a graph;
    the backward runs it again with one, the whole block (its ring, its
    psums and all_gathers, its routing), and then that block's backward
    through ``torch.autograd.grad``.  So the recompute makes the
    block's exchanges in program order, on a program of its own, and
    each process finishes one block's recompute and backward before the
    next: the ordering token goes in and a new one comes out, as for
    `mesh.Program`'s exchanges.  ``keep[i]`` names the input whose
    saved tensor stands for input i in the recompute: itself, or an
    input known to hold the same bits (one kept tensor, a leaf each).
    The inputs' cotangents are per shard; the parameters' are summed
    over the shards by the broadcast that made the shard copies."""

    @staticmethod
    def forward(ctx, run, keep, token, *inputs):
        ctx.run, ctx.keep = run, keep
        ctx.held = sorted(set(keep))
        ctx.save_for_backward(*(inputs[i] for i in ctx.held))
        return (token.new_zeros(()), *run(list(inputs)))

    @staticmethod
    def backward(ctx, _token, *grads):
        saved = dict(zip(ctx.held, ctx.saved_tensors))
        needs = ctx.needs_input_grad[3:]
        inputs = [saved[k].detach().requires_grad_(n)
                  for k, n in zip(ctx.keep, needs)]
        with torch.enable_grad():
            outs = ctx.run(inputs)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wrt = [i for i, n in enumerate(needs) if n]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [inputs[i] for i in wrt],
                                  [g for _, g in pairs], allow_unused=True)
        out = [None] * len(inputs)
        for i, g in zip(wrt, got):
            out[i] = g
        return (None, None, None, *out)


def _remat_layer(cfg: TransformerConfig, prog: Program, grid: _Grid,
                 lp: dict, xs: dict, causal: bool, cf: float,
                 want_aux: bool, seq: int):
    """`_mesh_layer` through `_RematLayer`: the inputs are each local
    shard's ``xs`` and the distinct tensors of its parameters.  The
    ``model`` shards of one (data, seq) block hold the same bits as
    block input (every ``model`` sum hands each of them the same sum, in
    the same order), so one tensor is kept for those on one device."""
    local = prog.local
    flat, index, keep, first = [], {}, [], {}
    for s in local:
        d, j, _ = grid.coords(s)
        keep.append(first.setdefault((d, j, prog.device(s)), len(flat)))
        flat.append(xs[s])

    def slot(a):
        if not isinstance(a, torch.Tensor):
            return a
        if id(a) not in index:
            index[id(a)] = len(flat)
            keep.append(len(flat))
            flat.append(a)
        return index[id(a)]

    layout = {s: map_tree(slot, lp[s]) for s in local}
    mesh, scope = prog.mesh, prog.scope
    aux_here = want_aux and 0 in local

    def run(inputs):
        # a program of its own, holding no tensor of the step's
        sub = Program(mesh, scope)
        lps = {s: map_tree(lambda i: inputs[i] if isinstance(i, int) else i,
                           layout[s]) for s in local}
        out, aux = _mesh_layer(cfg, sub, grid, lps,
                               dict(zip(local, inputs)), causal, cf,
                               want_aux, seq)
        return [out[s] for s in local] + ([aux] if aux_here else [])

    res = _RematLayer.apply(run, keep, prog.token(), *flat)
    prog.advance(res[0])
    out = dict(zip(local, res[1:1 + len(local)]))
    return out, (res[-1] if aux_here else None)


def _mesh_forward(cfg: TransformerConfig, params: dict, tokens,
                  prog: Program, grid: _Grid, causal: bool, train: bool,
                  return_aux: bool):
    """The mesh program up to the final layer norm: (``{shard: [b,
    S_local, d]}`` over the local shards, the mean aux loss on shard 0
    (None elsewhere, and for dense configs), ``{shard: parameters}``).
    With ``cfg.remat`` and grad enabled each block keeps only its inputs
    and is recomputed whole, ring included, in the backward
    (`_RematLayer`)."""
    tokens = torch.as_tensor(tokens)
    bsz, seq = tokens.shape
    grid.check(cfg, bsz, seq)
    b, sl = bsz // grid.dp, seq // grid.sp
    sp = _shard_params(cfg, params, prog, grid)
    xs = {}
    for s in prog.local:
        d, j, _ = grid.coords(s)
        tok = tokens[d * b:(d + 1) * b, j * sl:(j + 1) * sl].to(
            prog.device(s))
        xs[s] = (sp[s]["embed"][tok]
                 + sp[s]["pos"][j * sl:(j + 1) * sl][None])
    layer = (_remat_layer if cfg.remat and torch.is_grad_enabled()
             else _mesh_layer)
    cf = cfg.moe_capacity_factor if train else 0.0
    auxs = []
    for i in range(cfg.n_layers):
        lp = {s: sp[s]["layers"][i] for s in prog.local}
        xs, aux = layer(cfg, prog, grid, lp, xs, causal, cf, return_aux,
                        seq)
        if aux is not None:
            auxs.append(aux)
    aux = torch.stack(auxs).mean() if auxs else None
    return xs, aux, sp


def _mesh_aux(cfg: TransformerConfig, prog: Program, aux, like):
    """The mean aux loss on every process (shard 0's), or 0 for dense
    configs."""
    if not cfg.n_experts:
        return torch.zeros((), dtype=like.dtype, device=prog.home)
    return prog.total({0: aux} if aux is not None else {}, [0])


def apply(cfg: TransformerConfig, params: dict, tokens,
          mesh: Optional[Mesh] = None, axes: MeshAxes = MeshAxes(),
          causal: bool = True, train: bool = False,
          return_aux: bool = False):
    """tokens [B, S] int -> logits [B, S, V] through the flash-attention
    kernels (`kernels.flash_attention`; the plain version on CPU
    tensors), as the JAX package runs on the TPU.  With `mesh` the same
    model as one SPMD program over its shards (the module docstring);
    the logits come back whole on every process, on its first shard's
    device.  `params`: the `init_params` tree, or that tree with each
    leaf split over ``model`` as the list of its slices
    (`place_params`).  `train` routes MoE blocks by capacity dispatch
    (the inference default is the exact dense-masked path);
    `return_aux` also returns the mean-over-layers load-balancing loss
    (0 for dense configs)."""
    if mesh is None:
        return _forward(cfg, params, tokens,
                        lambda q, k, v: flash_attention(q, k, v, causal),
                        train=train, return_aux=return_aux)
    grid, prog = _Grid(mesh, axes), Program(mesh)
    xs, aux, sp = _mesh_forward(cfg, params, tokens, prog, grid, causal,
                                train, return_aux)
    owners = [s for s in prog.scope if grid.coords(s)[2] == 0]
    blocks = prog.gather(
        {s: _layer_norm(sp[s]["ln_f"], xs[s]) @ lm_head(sp[s])
         for s in prog.local if s in owners}, owners)
    logits = torch.cat([torch.cat([blocks[owners.index(grid.shard(d, j))]
                                   for j in range(grid.sp)], dim=1)
                        for d in range(grid.dp)])
    if return_aux:
        return logits, _mesh_aux(cfg, prog, aux, logits)
    return logits


def lm_loss(cfg: TransformerConfig, params: dict, tokens, targets,
            mesh: Optional[Mesh] = None,
            axes: MeshAxes = MeshAxes()) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch, with the log-softmax
    taken in the logits' dtype (the JAX `lm_loss`).  MoE configs route by
    capacity dispatch and add ``moe_aux_weight`` times the load-balancing
    loss when that weight is above 0.  With `mesh` each (data, seq) block
    is scored once, on its ``model`` shard 0; the blocks' summed losses
    (float32) are added in shard order and divided by the global ``B *
    S``, on every process."""
    use_aux = bool(cfg.n_experts) and cfg.moe_aux_weight > 0
    if mesh is None:
        out = apply(cfg, params, tokens, train=True, return_aux=use_aux)
        logits, aux = out if use_aux else (out, None)
        targets = torch.as_tensor(targets, device=logits.device).long()
        logp = F.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
    else:
        grid, prog = _Grid(mesh, axes), Program(mesh)
        xs, aux, sp = _mesh_forward(cfg, params, tokens, prog, grid, True,
                                    True, use_aux)
        targets = torch.as_tensor(targets).long()
        bsz, seq = targets.shape
        b, sl = bsz // grid.dp, seq // grid.sp
        owners = [s for s in prog.scope if grid.coords(s)[2] == 0]
        sums = {}
        for s in prog.local:
            if s not in owners:
                continue
            d, j, _ = grid.coords(s)
            x = _layer_norm(sp[s]["ln_f"], xs[s])
            logp = F.log_softmax(x @ lm_head(sp[s]), dim=-1)
            tg = targets[d * b:(d + 1) * b, j * sl:(j + 1) * sl].to(
                x.device)
            sums[s] = -logp.gather(-1, tg[..., None]).float().sum()
        dtype = sp[prog.local[0]]["embed"].dtype
        loss = (prog.total(sums, owners) / (bsz * seq)).to(dtype)
        if use_aux:
            aux = _mesh_aux(cfg, prog, aux, loss)
    if use_aux:
        loss = loss + cfg.moe_aux_weight * aux.to(loss.dtype)
    return loss


__all__ = [
    "MeshAxes",
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
    "param_specs",
    "params_to_numpy",
    "qkv_proj",
    "torch_dtype",
]
