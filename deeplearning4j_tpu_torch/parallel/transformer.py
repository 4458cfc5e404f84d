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
program; here each shard's tensors live on its device, the exchanges
are `mesh.psum` and the ring's `ppermute`, and autograd over the whole
per-shard program derives the backward sums.
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
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, psum
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


def _moe_dense(p: Dict[str, torch.Tensor], x: torch.Tensor,
               top_k: int = 1,
               experts: Optional[Callable] = None) -> torch.Tensor:
    """Top-k MoE with dense-masked compute: every expert sees every token
    and the combine weight zeroes the pairs not routed, so nothing is
    dropped.  The oracle of `_moe_dispatch` and the inference path.  The
    gate logits and softmax are taken in x's dtype.  `experts` maps the
    ``[E, N, d]`` buffer to the experts' outputs (`_experts` over p by
    default; the mesh program runs each ``model`` shard's experts)."""
    b, s, d = x.shape
    e = p["gate"].shape[1]
    gate_w = torch.softmax(x @ p["gate"], dim=-1)               # [B,S,E]
    top_idx, w = _router_weights(gate_w, top_k)                # [B,S,k]
    combine = (w[..., None] * F.one_hot(top_idx, e).to(x.dtype)).sum(-2)
    xe = x.reshape(1, b * s, d).expand(e, b * s, d)
    y = experts(xe) if experts else _experts(p, xe)
    return torch.einsum("end,ne->nd", y,
                        combine.reshape(b * s, e)).reshape(b, s, d)


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
                  capacity_factor: float, top_k: int = 1,
                  experts: Optional[Callable] = None) -> torch.Tensor:
    """Capacity-based top-k dispatch (Switch routing at k = 1, GShard's
    top-2 at k = 2): the N * k assignments are scattered into an
    ``[E, C, d]`` buffer, each expert computes only its buffer, and the
    outputs gather back weighted by the router weight, summed over a
    token's k assignments.  A dropped assignment contributes zero; the
    residual around the block passes its token through.  `experts` as in
    `_moe_dense`."""
    b, s, d = x.shape
    e = p["gate"].shape[1]
    xf = x.reshape(b * s, d)
    e_flat, slot, w_flat, keep, c = _moe_route(p, xf, capacity_factor,
                                               top_k)
    x_rep = xf.repeat_interleave(top_k, dim=0) * keep[:, None]  # [A, d]
    # each kept assignment owns its (expert, slot) exclusively and a
    # dropped one adds exact zeros, so the accumulated scatter is exact
    # in any order, CUDA atomics included
    buf = torch.zeros((e, c, d), dtype=x.dtype, device=x.device).index_put(
        (e_flat, slot), x_rep, accumulate=True)
    y = experts(buf) if experts else _experts(p, buf)
    out = y[e_flat, slot] * (w_flat * keep)[:, None]           # [A, d]
    return out.reshape(b * s, top_k, d).sum(dim=1).reshape(b, s, d)


def _moe(p: Dict[str, torch.Tensor], x: torch.Tensor,
         capacity_factor: float = 0.0, top_k: int = 1,
         experts: Optional[Callable] = None) -> torch.Tensor:
    """The MoE block: capacity dispatch when capacity_factor > 0, the
    dense-masked oracle otherwise."""
    if capacity_factor > 0:
        return _moe_dispatch(p, x, capacity_factor, top_k, experts)
    return _moe_dense(p, x, top_k, experts)


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
    and tp (an axis the mesh does not have counts 1) and the device of
    each shard."""

    def __init__(self, mesh: Mesh, axes: MeshAxes):
        names = (axes.data, axes.seq, axes.model)
        extra = [a for a in mesh.axis_names if a not in names]
        if extra:
            raise ValueError(f"mesh axes {extra} are none of {names}")
        shape = mesh.shape
        self.mesh, self.axes, self._names = mesh, axes, names
        self.dp, self.sp, self.tp = (shape.get(a, 1) for a in names)

    def device(self, d: int = 0, s: int = 0, t: int = 0) -> torch.device:
        coord = dict(zip(self._names, (d, s, t)))
        return self.mesh.devices[tuple(coord[a]
                                       for a in self.mesh.axis_names)]

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


def _model_shards(cfg: TransformerConfig, params: dict, tp: int) -> dict:
    """`params` with every leaf that `param_specs` splits over ``model``
    as a list of its `tp` slices (a list already in place is kept: the
    mesh trainers hold their masters so); replicated leaves unchanged."""
    def cut(spec, leaf):
        if spec.is_replicated or isinstance(leaf, list):
            return leaf
        return list(leaf.chunk(tp, dim=spec.dim))

    return map_tree(cut, param_specs(cfg, "model"), params)


def _pick_shard(cfg: TransformerConfig, params: dict, t: int) -> dict:
    """``model`` shard t's parameters from a `_model_shards` tree."""
    return map_tree(lambda spec, a: a[t] if isinstance(a, list) else a,
                    param_specs(cfg, "model"), params)


def _cut_rows(a, grid: _Grid, b: int, sl: int) -> list:
    """``[B, S]`` -> shard (d, s)'s ``[b, S_local]`` block on its device,
    as a [dp][sp] grid."""
    return [[a[d * b:(d + 1) * b, j * sl:(j + 1) * sl].to(grid.device(d, j))
             for j in range(grid.sp)] for d in range(grid.dp)]


def _mesh_attn(shards: list, hs: list, grid: _Grid, causal: bool) -> list:
    """Each ``model`` shard's heads over each data row, the ring over
    ``seq``, summed across ``model`` in shard order, plus bo once."""
    out = []
    for d in range(grid.dp):
        parts = [[] for _ in range(grid.sp)]
        for t in range(grid.tp):
            p = shards[t]["attn"]
            qkv = []
            for j in range(grid.sp):
                dev = grid.device(d, j, t)
                qkv.append(qkv_proj(_on(p, dev), hs[d][j].to(dev)))
            os = ring_flash_attention([a[0] for a in qkv],
                                      [a[1] for a in qkv],
                                      [a[2] for a in qkv], grid.axes.seq,
                                      causal)
            for j, o in enumerate(os):
                b, sl, h, kd = o.shape
                wo = p["wo"].to(o.device)
                parts[j].append(o.reshape(b, sl, h * kd)
                                @ wo.reshape(h * kd, -1))
        row = []
        for j in range(grid.sp):
            dev = grid.device(d, j)
            y = psum(parts[j], dev)
            if "bo" in shards[0]["attn"]:
                y = y + shards[0]["attn"]["bo"].to(dev)
            row.append(y)
        out.append(row)
    return out


def _mesh_mlp(shards: list, hs: list, grid: _Grid) -> list:
    """The MLP's hidden slices over ``model``, summed, plus b2 once."""
    out = []
    for d in range(grid.dp):
        row = []
        for j in range(grid.sp):
            parts = []
            for t in range(grid.tp):
                dev = grid.device(d, j, t)
                p = _on(shards[t]["mlp"], dev)
                hid = F.gelu(hs[d][j].to(dev) @ p["w1"] + p["b1"],
                             approximate="tanh")
                parts.append(hid @ p["w2"])
            dev = grid.device(d, j)
            row.append(psum(parts, dev) + shards[0]["mlp"]["b2"].to(dev))
        out.append(row)
    return out


def _mesh_moe(cfg: TransformerConfig, shards: list, hs: list, grid: _Grid,
              capacity_factor: float, want_aux: bool):
    """Expert parallelism: `_moe` over the global tokens, so the router
    and the slot assignment run in (batch, position) order and the
    capacity is that of the whole batch, as JAX's dispatch on the full
    array; ``model`` shard t computes only its experts ``[t E / tp, (t +
    1) E / tp)`` with its slice of the expert buffer, and the outputs
    gather back.  Returns (the [dp][sp] grid of outputs, the aux loss or
    None)."""
    home = grid.device()
    full = torch.cat([torch.cat([h.to(home) for h in row], dim=1)
                      for row in hs], dim=0)                 # [B, S, d]
    bsz, seq, _ = full.shape
    gate = {"gate": shards[0]["moe"]["gate"].to(home)}
    el = gate["gate"].shape[1] // grid.tp

    def experts(buf):
        ys = []
        for t in range(grid.tp):
            dev = grid.device(t=t)
            ys.append(_experts(_on(shards[t]["moe"], dev),
                               buf[t * el:(t + 1) * el].to(dev)).to(home))
        return torch.cat(ys)

    out = _moe(gate, full, capacity_factor, cfg.moe_top_k, experts)
    grid_out = _cut_rows(out, grid, bsz // grid.dp, seq // grid.sp)
    aux = _moe_aux_loss(gate, full) if want_aux else None
    return grid_out, aux


def _mesh_forward(cfg: TransformerConfig, params: dict, tokens, mesh: Mesh,
                  axes: MeshAxes, causal: bool, train: bool,
                  return_aux: bool):
    """The mesh program up to the final layer norm: (the [dp][sp] grid of
    ``[b, S_local, d]`` outputs, the mean aux loss or None, the grid)."""
    grid = _Grid(mesh, axes)
    tokens = torch.as_tensor(tokens)
    bsz, seq = tokens.shape
    grid.check(cfg, bsz, seq)
    b, sl = bsz // grid.dp, seq // grid.sp
    params = _model_shards(cfg, params, grid.tp)
    layer_shards = [[_pick_shard(cfg, params, t)["layers"][i]
                     for t in range(grid.tp)]
                    for i in range(cfg.n_layers)]
    cf = cfg.moe_capacity_factor if train else 0.0
    toks = _cut_rows(tokens, grid, b, sl)

    def block(shards, xs):
        hs = [[_layer_norm(_on(shards[0]["ln1"], x.device), x) for x in row]
              for row in xs]
        att = _mesh_attn(shards, hs, grid, causal)
        xs = [[x + a for x, a in zip(xr, ar)] for xr, ar in zip(xs, att)]
        hs = [[_layer_norm(_on(shards[0]["ln2"], x.device), x) for x in row]
              for row in xs]
        aux = None
        if "moe" in shards[0]:
            ys, aux = _mesh_moe(cfg, shards, hs, grid, cf, return_aux)
        else:
            ys = _mesh_mlp(shards, hs, grid)
        xs = [[x + y for x, y in zip(xr, yr)] for xr, yr in zip(xs, ys)]
        if not return_aux:
            return xs
        if aux is None:
            aux = torch.zeros((), dtype=xs[0][0].dtype, device=grid.device())
        return xs, aux

    remat = cfg.remat and torch.is_grad_enabled()
    xs = []
    for d in range(grid.dp):
        row = []
        for j in range(grid.sp):
            dev = grid.device(d, j)
            pos = params["pos"].to(dev)[j * sl:(j + 1) * sl]
            row.append(params["embed"].to(dev)[toks[d][j]] + pos[None])
        xs.append(row)
    auxs = []
    for shards in layer_shards:
        out = (checkpoint(block, shards, xs, use_reentrant=False) if remat
               else block(shards, xs))
        if return_aux:
            xs, aux = out
            auxs.append(aux)
        else:
            xs = out
    xs = [[_layer_norm(_on(params["ln_f"], x.device), x) for x in row]
          for row in xs]
    aux = torch.stack(auxs).mean() if return_aux else None
    return xs, aux, grid


def apply(cfg: TransformerConfig, params: dict, tokens,
          mesh: Optional[Mesh] = None, axes: MeshAxes = MeshAxes(),
          causal: bool = True, train: bool = False,
          return_aux: bool = False):
    """tokens [B, S] int -> logits [B, S, V] through the flash-attention
    kernels (`kernels.flash_attention`; the plain version on CPU
    tensors), as the JAX package runs on the TPU.  With `mesh` the same
    model as one program over its shards (the module docstring); the
    logits come back whole, on the first shard's device.  `params`: the
    `init_params` tree, or that tree with each leaf split over ``model``
    as the list of its slices (`place_params`).  `train` routes MoE
    blocks by capacity dispatch (the inference default is the exact
    dense-masked path); `return_aux` also returns the mean-over-layers
    load-balancing loss (0 for dense configs)."""
    if mesh is None:
        return _forward(cfg, params, tokens,
                        lambda q, k, v: flash_attention(q, k, v, causal),
                        train=train, return_aux=return_aux)
    xs, aux, grid = _mesh_forward(cfg, params, tokens, mesh, axes, causal,
                                  train, return_aux)
    home = grid.device()
    head = lm_head(params)
    logits = torch.cat([torch.cat([(x @ head.to(x.device)).to(home)
                                   for x in row], dim=1) for row in xs])
    if return_aux:
        return logits, aux
    return logits


def lm_loss(cfg: TransformerConfig, params: dict, tokens, targets,
            mesh: Optional[Mesh] = None,
            axes: MeshAxes = MeshAxes()) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch, with the log-softmax
    taken in the logits' dtype (the JAX `lm_loss`).  MoE configs route by
    capacity dispatch and add ``moe_aux_weight`` times the load-balancing
    loss when that weight is above 0.  With `mesh` each (data, seq) shard
    scores its own block; the shards' summed losses (float32) are added
    in shard order and divided by the global ``B * S``."""
    use_aux = bool(cfg.n_experts) and cfg.moe_aux_weight > 0
    if mesh is None:
        out = apply(cfg, params, tokens, train=True, return_aux=use_aux)
        logits, aux = out if use_aux else (out, None)
        targets = torch.as_tensor(targets, device=logits.device).long()
        logp = F.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
    else:
        xs, aux, grid = _mesh_forward(cfg, params, tokens, mesh, axes, True,
                                      True, use_aux)
        targets = torch.as_tensor(targets)
        bsz, seq = targets.shape
        tgts = _cut_rows(targets.long(), grid, bsz // grid.dp,
                         seq // grid.sp)
        head = lm_head(params)
        home = grid.device()
        sums, dtype = [], None
        for xr, tr in zip(xs, tgts):
            for x, tg in zip(xr, tr):
                logp = F.log_softmax(x @ head.to(x.device), dim=-1)
                dtype = logp.dtype
                sums.append(-logp.gather(-1, tg[..., None]).float().sum())
        loss = (psum(sums, home) / (bsz * seq)).to(dtype)
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
