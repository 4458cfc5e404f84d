"""MultiLayerNetwork: the user-facing network (counterpart of
`deeplearning4j_tpu.models.multi_layer_network`).

Parity target: reference `nn/multilayer/MultiLayerNetwork.java:61` —
init() :327, feedForward() :542, fit() :1028, output() :1313, predict()
:1212, score() :1391, params()/pack()/unPack() :836/:883/:927.

The whole forward is a fold over the layers' ``apply`` functions; the
training objective fuses softmax + cross-entropy on the logits; one
train step is autograd over the objective plus the named updater, which
works in place on the parameter tree (a list of per-layer dicts of
tensors, the JAX package's structure and keys).  Parameters are the
master copies in the conf's ``dtype`` (float32 by default); the forward
casts them, differentiably, to ``compute_dtype``, so gradients land on
the masters.  `params_flat()` is the reference's flat-vector view, the
shipping format both packages share.

`fit` runs greedy layer-wise pretraining of the AE / RBM layers first
when ``conf.pretrain`` is set (`pretrain`, reference pretrain() :148),
and trains with the line-search solvers of `optimize/` when
``conf.optimization_algo`` names one (`_fit_with_solver`).

Precision: a `PrecisionPolicy` (`precision/`) owns the parameter,
compute and output dtypes, derived from the conf unless `set_precision`
or ``fit(precision=)`` replaces it.  Under a loss-scaled policy
("mixed", or float16 compute with a `LossScaleConfig`) each step scales
the loss, unscales the gradients, and on a non-finite gradient or loss
keeps the parameters, optimizer state and layer state at their pre-step
values by `torch.where` while the scale backs off; nothing is read back
to the host.  ``fit(chunk_size=K)`` trains through the fused driver
(`runtime/fused.py`): `fit_chunk_async` runs K steps over stacked
batches with example weights and returns their losses and gradient
norms as device vectors.  `output_bucketed` pads a batch up a
`BucketLadder`; `merge` averages parameters across networks.

The network lives on one device: `resolve_device(device)`, the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import types
import warnings
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    OutputLayerConf,
    RnnOutputLayerConf,
)
from deeplearning4j_tpu_torch.nn.conf.layers import AutoEncoderConf, RBMConf
from deeplearning4j_tpu_torch.nn.layers import get_layer_impl
from deeplearning4j_tpu_torch.nn.layers.common import (
    effective_weights,
    input_dropout,
)
from deeplearning4j_tpu_torch.nn.layers.pretrain import (
    ae_pretrain_loss,
    rbm_cd_grads,
)
from deeplearning4j_tpu_torch.ops import losses as losses_mod
from deeplearning4j_tpu_torch.ops.updaters import (
    apply_updates,
    global_grad_norm,
    make_updater,
)
from deeplearning4j_tpu_torch.precision import (
    grads_finite,
    init_scaler_state,
    resolve_policy,
    unscale_grads,
    update_scaler_state,
    where_tree,
)
from deeplearning4j_tpu_torch.precision.policy import dtype_of
from deeplearning4j_tpu_torch.runtime.programs import BucketPrograms
from deeplearning4j_tpu_torch.tree import map_tree, tree_leaves

Tree = Any

# Fused logit-space losses for stability: (activation, loss) -> fused loss name.
_FUSED = {
    ("softmax", "mcxent"): "mcxent_with_logits",
    ("softmax", "negativeloglikelihood"): "mcxent_with_logits",
    ("sigmoid", "xent"): "xent_with_logits",
}


def _masked_loss(loss_name: str, y: torch.Tensor, out: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Loss with optional [batch, time] mask weighting for sequence
    outputs: padded timesteps contribute zero to both numerator and
    denominator."""
    if out.dim() != 3 or mask is None:
        return losses_mod.get_loss(loss_name)(y, out)
    per_row = losses_mod.per_row_loss(loss_name,
                                      y.reshape(-1, y.shape[-1]),
                                      out.reshape(-1, out.shape[-1]))
    m = mask.reshape(-1).to(per_row.dtype)
    return torch.sum(per_row * m) / torch.clamp(torch.sum(m), min=1.0)


def apply_preprocessor(spec: dict, x: torch.Tensor) -> torch.Tensor:
    """Input preprocessors between layers (reference nn/conf/preprocessor:
    ConvolutionInputPreProcessor et al.); NHWC as in the JAX package."""
    kind = spec["type"]
    if kind == "ffn_to_cnn":
        h, w, c = spec["height"], spec["width"], spec["channels"]
        return x.reshape((x.shape[0], h, w, c))
    if kind == "cnn_to_ffn":
        return x.reshape((x.shape[0], -1))
    if kind == "rnn_last_step":
        return x[:, -1, :]
    if kind == "rnn_to_ffn":
        return x.reshape((-1, x.shape[-1]))
    raise ValueError(f"Unknown preprocessor type: {kind}")


def _cast_floating(tree, dtype: torch.dtype):
    """Floating leaves cast to the compute dtype, differentiably (the
    masters stay in their dtype; float32 compute casts nothing, as in the
    JAX package)."""
    if dtype == torch.float32:
        return tree
    return map_tree(lambda a: a.to(dtype) if a.is_floating_point() else a,
                    tree)


def _as_tensor(a, device: torch.device) -> Optional[torch.Tensor]:
    """A numpy array (or array-like, or tensor) on `device`; float64 to
    float32, as the JAX package's default 32-bit mode does."""
    if a is None:
        return None
    if not isinstance(a, torch.Tensor):
        arr = np.asarray(a)
        if str(arr.dtype) == "bfloat16":
            arr = arr.astype(np.float32)
        a = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if a.dtype == torch.float64:
        a = a.float()
    return a.to(device)


def _host_input(a) -> np.ndarray:
    """A serving input as the host array `_as_tensor` would move: float64
    and bfloat16 become float32."""
    arr = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    if arr.dtype == np.float64 or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(arr)


def params_from_numpy(net: "MultiLayerNetwork", src) -> List[Dict[str,
                                                                   Any]]:
    """The weight carry-over: a JAX network's parameters — its ``params``
    (a list of per-layer dicts of arrays) or its ``params_flat()``
    vector, whose order is layer by layer with keys sorted (RW, W, b, pf,
    pi, po for a Graves LSTM) — as this network's parameter tree: tensors
    on its device, in its parameter dtype, requiring grad."""
    if net.params is None:
        net.init()
    if isinstance(src, (list, tuple)):
        tree = [{k: np.asarray(v, np.float32) for k, v in layer.items()}
                for layer in src]
    else:
        vec = np.asarray(src)
        if vec.dtype.kind != "f" or str(vec.dtype) == "bfloat16":
            vec = vec.astype(np.float32)
        expected = net.num_params()
        if vec.ndim != 1 or vec.size != expected:
            raise ValueError(f"Parameter vector length {vec.size} != model "
                             f"size {expected}")
        tree, offset = [dict(p) for p in net.params], 0
        for i, p in enumerate(net.params):
            for k in sorted(p):
                n = p[k].numel()
                tree[i][k] = vec[offset:offset + n].reshape(tuple(p[k].shape))
                offset += n
    if len(tree) != len(net.params):
        raise ValueError(f"{len(tree)} layers of parameters for a "
                         f"{len(net.params)}-layer network")
    out = []
    for have, layer in zip(net.params, tree):
        if set(have) != set(layer):
            raise ValueError(f"parameter keys {sorted(layer)} do not match "
                             f"the layer's {sorted(have)}")
        new = {}
        for k, ref in have.items():
            # a copy: training updates the parameters in place, and must
            # not write into the caller's arrays
            a = np.array(layer[k], np.float32, order="C")
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"parameter {k} has shape {a.shape}, the "
                                 f"layer needs {tuple(ref.shape)}")
            new[k] = (torch.from_numpy(a)
                      .to(device=ref.device, dtype=ref.dtype)
                      .requires_grad_(ref.is_floating_point()))
        out.append(new)
    return out


class MultiLayerNetwork:
    """A layer-stack model driven entirely by `MultiLayerConfiguration`.

    Construction is cheap; `init()` draws parameters from a
    `torch.Generator` seeded with ``conf.seed``."""

    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = None):
        self.conf = conf
        self.impls = [get_layer_impl(lc) for lc in conf.layers]
        self.device = resolve_device(device)
        self.params: Optional[List[Dict[str, torch.Tensor]]] = None
        self.state: Optional[List[Dict[str, torch.Tensor]]] = None
        self.updater_state: Optional[Tree] = None
        # A live DataParallelTrainer(shard_update=True) registers itself
        # here while it owns the (sharded) optimizer state; checkpoint
        # paths pull through runtime.checkpoint.published_updater_state.
        self._updater_state_owner = None
        if (conf.conf.updater == "adadelta"
                and any(lc.lr_multiplier != 1.0 for lc in conf.layers)):
            raise ValueError(
                "lr_multiplier is not supported with AdaDelta: its update "
                "has no learning-rate term, so scaling the applied step "
                "desynchronizes the accumulated-update state")
        self._updater = make_updater(conf.conf.updater_config())
        self._precision = resolve_policy(None, conf.conf)
        self._scaler_state: Optional[Dict[str, torch.Tensor]] = None
        # input signatures the inference forward has run (see
        # forward_program_count), and output_bucketed's programs
        self._signatures: set = set()
        self._bucket_programs = None
        self._lr_scale = 1.0
        self.last_grad_norm: Optional[torch.Tensor] = None
        self._listeners: list = []  # [(fn, sync_interval, score_only)]
        self._iteration = 0
        # layer index -> per-batch reconstruction errors of `pretrain`
        self.pretrain_errors: Dict[int, List[float]] = {}

    # ---- precision policy --------------------------------------------------

    @property
    def _dtype(self) -> torch.dtype:
        return dtype_of(self._precision.param_dtype)

    @property
    def _compute_dtype(self) -> torch.dtype:
        return dtype_of(self._precision.compute_dtype)

    @property
    def _output_dtype(self) -> torch.dtype:
        return dtype_of(self._precision.output_dtype)

    @property
    def precision(self):
        """The live `PrecisionPolicy`."""
        return self._precision

    def set_precision(self, policy) -> "MultiLayerNetwork":
        """Adopt a precision policy (a PrecisionPolicy, a named policy —
        "fp32" / "bf16" / "mixed" — or None to re-derive from the conf).

        Changing the compute dtype or the loss-scaling mode starts a new
        scaler and forgets the forward's signatures; changing the param
        dtype also casts the master weights and re-initializes the
        optimizer state (moments of one dtype mean nothing in another)."""
        policy = resolve_policy(policy, self.conf.conf)
        if policy == self._precision:
            return self
        old_param_dtype = self._dtype
        self._precision = policy
        self._scaler_state = None
        self._signatures = set()
        self._bucket_programs = None
        if self.params is not None and self._dtype != old_param_dtype:
            with torch.no_grad():
                self.params = map_tree(
                    lambda a: a.detach().to(self._dtype).requires_grad_()
                    if a.is_floating_point() else a, self.params)
            self.updater_state = (self._updater.init(self.params)
                                  if self.updater_state is not None
                                  else None)
        return self

    def scaler_stats(self) -> Optional[dict]:
        """The loss scaler's state ({scale, good_steps, overflow_count})
        read to the host, or None when the policy does not scale (or no
        scaled step ran yet).  A growing overflow_count means steps were
        skipped with the masters untouched."""
        if self._scaler_state is None:
            return None
        return {"scale": float(self._scaler_state["scale"]),
                "good_steps": int(self._scaler_state["good_steps"]),
                "overflow_count":
                    int(self._scaler_state["overflow_count"])}

    def train_state_bytes(self, x=None, mask=None, shards: int = 1) -> int:
        """The per-replica training-state model under the policy
        (`precision.train_state_bytes`; ``shards`` its ZeRO-1 form)."""
        from deeplearning4j_tpu_torch.precision.policy import (
            train_state_bytes,
        )

        return train_state_bytes(self, x, mask, shards=shards)

    # ---- construction -----------------------------------------------------

    @classmethod
    def from_json(cls, s: str, params_flat: Optional[np.ndarray] = None,
                  device: DeviceLike = None) -> "MultiLayerNetwork":
        """Rebuild from the shipping format (conf-JSON [+ flat params])."""
        net = cls(MultiLayerConfiguration.from_json(s), device=device)
        net.init()
        if params_flat is not None:
            net.set_params_flat(params_flat)
        return net

    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Draw every layer's parameters (on the CPU, from one generator
        seeded with `seed` or ``conf.seed``) and move them to the device;
        reset the updater state."""
        gen = torch.Generator().manual_seed(
            self.conf.conf.seed if seed is None else seed)
        self.params, self.state = [], []
        for lc, impl in zip(self.conf.layers, self.impls):
            p, s = impl.init(lc, gen, self._dtype)
            self.params.append({k: v.to(self.device).requires_grad_(
                v.is_floating_point()) for k, v in p.items()})
            self.state.append({k: v.to(self.device) for k, v in s.items()})
        self.updater_state = self._updater.init(self.params)
        return self

    def add_listener(self, fn) -> None:
        """IterationListener parity: a plain fn(iteration, score) or an
        object with iteration_done(model, iteration, score).  A
        ``sync_interval`` attribute limits the iterations that call it
        (and so read the loss back from the device).

        ``score_only`` governs chunked fit: score-only listeners (and
        plain fns, which never see the model) get every due per-step
        score of a chunk's loss vector; listeners that read the model
        fire only at a chunk's end, where the model matches the
        iteration."""
        interval = max(1, int(getattr(fn, "sync_interval", 1)))
        score_only = bool(getattr(fn, "score_only", False))
        if hasattr(fn, "iteration_done"):
            obj = fn
            fn = lambda it, score: obj.iteration_done(self, it, score)  # noqa: E731
        else:
            score_only = True
        self._listeners.append((fn, interval, score_only))

    def _due_listeners(self, iteration: int) -> list:
        return [fn for fn, interval, _ in self._listeners
                if iteration % interval == 0]

    # ---- forward ----------------------------------------------------------

    def _step_rng(self) -> torch.Generator:
        """The step's generator, seeded from (conf.seed, iteration)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.conf.conf.seed * 1_000_003 + self._iteration)
                        % (1 << 63))
        return gen

    def _forward(self, params, state, x, *, train: bool, rng=None, mask=None,
                 upto: Optional[int] = None, collect: bool = False):
        """The forward fold. Returns (activations_or_final, new_state)."""
        params = _cast_floating(params, self._compute_dtype)
        if x.is_floating_point():
            x = x.to(self._compute_dtype)
        acts = [x]
        new_state = []
        n = len(self.conf.layers) if upto is None else upto
        for i in range(n):
            lc = self.conf.layers[i]
            if str(i) in self.conf.input_preprocessors:
                x = apply_preprocessor(self.conf.input_preprocessors[str(i)],
                                       x)
            is_rnn_layer = x.dim() == 3
            x, s = self.impls[i].apply(
                lc, params[i], state[i], x, train=train, rng=rng,
                mask=mask if is_rnn_layer else None)
            new_state.append(s)
            acts.append(x)
        new_state.extend(state[n:])
        return (acts if collect else x), new_state

    def _logits_forward(self, params, state, x, *, train, rng=None,
                        mask=None):
        """Forward through all but the final activation: the final
        layer's pre-activation (logits) for the fused losses."""
        n = len(self.conf.layers)
        x, new_state = self._forward(params, state, x, train=train, rng=rng,
                                     mask=mask, upto=n - 1)
        lc = self.conf.layers[-1]
        if str(n - 1) in self.conf.input_preprocessors:
            x = apply_preprocessor(self.conf.input_preprocessors[str(n - 1)],
                                   x)
        x = input_dropout(lc, x, train, rng)
        p = _cast_floating(params[-1], self._compute_dtype)
        return x @ effective_weights(lc, p, train, rng) + p["b"], new_state

    def _objective(self, params, state, x, y, rng, mask=None):
        """Scalar training loss (f32). Uses fused logit losses when
        applicable, plus each layer's own L1/L2 on its master params."""
        lc = self.conf.layers[-1]
        loss_name = getattr(lc, "loss", "mse")
        fused = _FUSED.get((lc.activation.lower(), loss_name.lower()))
        if isinstance(lc, (OutputLayerConf, RnnOutputLayerConf)) and fused:
            z, new_state = self._logits_forward(params, state, x, train=True,
                                                rng=rng, mask=mask)
            loss = _masked_loss(fused, y, z.float(), mask)
        else:
            out, new_state = self._forward(params, state, x, train=True,
                                           rng=rng, mask=mask)
            loss = _masked_loss(loss_name, y, out.float(), mask)
        for lc_i, p_i in zip(self.conf.layers, params):
            if lc_i.l2:
                loss = loss + 0.5 * lc_i.l2 * sum(
                    torch.sum(torch.square(v)) for v in p_i.values())
            if lc_i.l1:
                loss = loss + lc_i.l1 * sum(
                    torch.sum(torch.abs(v)) for v in p_i.values())
        return loss, new_state

    def _weighted_loss_sums(self, params, state, x, y, rng, mask, w):
        """The unnormalized pieces of the example-weighted loss: (weighted
        per-example loss sum, weight sum, new_state), no regularization.
        Sequence outputs fold the weight into the [B, T] time mask
        (all-ones when absent), so a padded row is an all-zero mask row."""
        lc = self.conf.layers[-1]
        loss_name = getattr(lc, "loss", "mse")
        fused = _FUSED.get((lc.activation.lower(), loss_name.lower()))
        if isinstance(lc, (OutputLayerConf, RnnOutputLayerConf)) and fused:
            out, new_state = self._logits_forward(params, state, x,
                                                  train=True, rng=rng,
                                                  mask=mask)
            loss_name = fused
        else:
            out, new_state = self._forward(params, state, x, train=True,
                                           rng=rng, mask=mask)
        out = out.float()
        if out.dim() == 3:
            m = (mask if mask is not None
                 else torch.ones(out.shape[:2], device=out.device))
            m = (m * w[:, None]).reshape(-1)
            per = losses_mod.per_row_loss(loss_name,
                                          y.reshape(-1, y.shape[-1]),
                                          out.reshape(-1, out.shape[-1]))
            m = m.to(per.dtype)
            return torch.sum(per * m), torch.sum(m), new_state
        per = losses_mod.per_row_loss(loss_name, y, out)
        ww = w.to(per.dtype)
        return torch.sum(per * ww), torch.sum(ww), new_state

    def _reg_loss(self, params) -> torch.Tensor:
        """The per-layer L1/L2 term of `_objective`, on its own."""
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for lc_i, p_i in zip(self.conf.layers, params):
            if lc_i.l2:
                loss = loss + 0.5 * lc_i.l2 * sum(
                    torch.sum(torch.square(v)) for v in p_i.values())
            if lc_i.l1:
                loss = loss + lc_i.l1 * sum(
                    torch.sum(torch.abs(v)) for v in p_i.values())
        return loss

    def _has_reg(self) -> bool:
        return any(lc.l1 or lc.l2 for lc in self.conf.layers)

    def _weighted_objective(self, params, state, x, y, rng, mask, w):
        """`_objective` with [batch] example weights, the chunk step's
        loss: padded tail rows (w == 0) contribute nothing, and the
        normalizer is the weight sum.  Every chunk step uses this form
        (all-ones w for full batches), so chunk sizes run identical
        steps."""
        num, den, new_state = self._weighted_loss_sums(
            params, state, x, y, rng, mask, w)
        loss = num / torch.clamp(den, min=1.0)
        if self._has_reg():
            loss = loss + self._reg_loss(params)
        return loss, new_state

    # ---- training ---------------------------------------------------------

    def _apply_lr_multipliers(self, updates):
        """Per-layer learning-rate overrides: each layer's updates scaled
        by its conf's lr_multiplier (a per-layer lr for every updater
        whose step is linear in lr; AdaDelta is refused at
        construction)."""
        if all(lc.lr_multiplier == 1.0 for lc in self.conf.layers):
            return updates
        return [map_tree(lambda u, m=lc.lr_multiplier: u * m, up)
                for lc, up in zip(self.conf.layers, updates)]

    def _grads(self, loss):
        """d loss / d params as a tree shaped like the params."""
        leaves = tree_leaves(self.params)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, got))
        return map_tree(lambda _: next(it), self.params)

    def _apply_grads(self, grads) -> torch.Tensor:
        """The optimizer step on `grads` (in place); returns their global
        norm."""
        gnorm = global_grad_norm(grads)
        updates, self.updater_state = self._updater.update(
            grads, self.updater_state, self.params)
        updates = self._apply_lr_multipliers(updates)
        if self._lr_scale != 1.0:
            updates = map_tree(lambda u: u * self._lr_scale, updates)
        apply_updates(self.params, updates)
        return gnorm

    def _loss(self, x, y, mask, rng, weights):
        """The step's loss and new layer state: `_objective`, or with
        example `weights` `_weighted_objective`."""
        if weights is None:
            return self._objective(self.params, self.state, x, y, rng, mask)
        return self._weighted_objective(self.params, self.state, x, y, rng,
                                        mask, weights)

    def _train_step(self, x, y, mask, rng, accum: int = 1, weights=None):
        """One optimizer step over a batch; returns (loss, global gradient
        norm) as device tensors.  ``accum > 1`` splits the batch into
        that many sequential microbatches whose gradients are weighted by
        their share of the batch's normalizer (valid mask tokens when a
        sequence mask is present, else uniform), so the accumulated
        update equals the full-batch one.  `weights` (the chunk step)
        takes the example-weighted loss.  A loss-scaled policy takes
        `_scaled_step`."""
        if self._precision.loss_scale is not None:
            return self._scaled_step(x, y, mask, rng, weights)
        if accum == 1:
            loss, new_state = self._loss(x, y, mask, rng, weights)
            grads = self._grads(loss)
        else:
            def micro(a):
                return a.reshape((accum, a.shape[0] // accum)
                                 + tuple(a.shape[1:]))

            xs, ys = micro(x), micro(y)
            ms = None if mask is None else micro(mask)
            grads = map_tree(torch.zeros_like, self.params)
            new_state = self.state
            loss = w_total = 0.0
            for i in range(accum):
                mi = None if ms is None else ms[i]
                li, new_state = self._objective(
                    self.params, new_state, xs[i], ys[i], rng, mi)
                gi = self._grads(li)
                wi = (torch.sum(mi) if mi is not None and ys[i].dim() == 3
                      else torch.ones((), device=x.device))
                grads = map_tree(lambda a, g: a + wi * g, grads, gi)
                loss = loss + wi * li.detach()
                w_total = w_total + wi
            w_total = torch.clamp(w_total, min=1e-8)  # all-pad batch
            grads = map_tree(lambda g: g / w_total, grads)
            loss = loss / w_total
        gnorm = self._apply_grads(grads)
        self.state = new_state
        return loss.detach(), gnorm

    def _ensure_scaler(self) -> None:
        """Under a loss-scaled policy: the scaler state, and the updater's
        step count, on the network's device (a skipped step keeps the old
        count by `torch.where`, with no host read)."""
        if self._precision.loss_scale is None:
            return
        if self._scaler_state is None:
            self._scaler_state = init_scaler_state(
                self._precision.loss_scale, self.device)
        step = self.updater_state["step"]
        if step.device != self.device:
            self.updater_state["step"] = step.to(self.device)

    def _scaled_step(self, x, y, mask, rng, weights):
        """The loss-scaled step: the loss (float32) times the scale
        before differentiation, the gradients unscaled in their dtype,
        ``finite = grads_finite(grads) and isfinite(loss)``; on overflow
        the parameters, the optimizer state (step count included) and
        the layer state keep their pre-step values, selected by
        `torch.where`, while the scale backs off."""
        scfg = self._precision.loss_scale
        sc = self._scaler_state
        scale = sc["scale"]
        loss, new_state = self._loss(x, y, mask, rng, weights)
        grads = unscale_grads(self._grads(loss * scale.to(loss.dtype)),
                              scale)
        finite = torch.logical_and(grads_finite(grads),
                                   torch.isfinite(loss))
        with torch.no_grad():
            old_params = [p.detach().clone()
                          for p in tree_leaves(self.params)]
            old_upd = map_tree(torch.clone, self.updater_state)
        gnorm = self._apply_grads(grads)
        with torch.no_grad():
            for p, old in zip(tree_leaves(self.params), old_params):
                p.copy_(torch.where(finite, p, old))
        self.updater_state = where_tree(finite, self.updater_state, old_upd)
        self.state = where_tree(finite, new_state, self.state)
        self._scaler_state = update_scaler_state(scfg, sc, finite)
        return loss.detach(), gnorm

    def _own_updater_state(self) -> None:
        """Direct training owns its optimizer state: drop any
        registration left by an abandoned (un-finalized) sharded trainer,
        so it cannot clobber the live state at a later checkpoint, and
        restart with fresh moments where that trainer took them (see
        DataParallelTrainer.finalize)."""
        self._updater_state_owner = None
        if self.updater_state is None:
            self.updater_state = self._updater.init(self.params)

    def fit_batch_async(self, x, y, mask=None,
                        accum_steps: int = 1) -> torch.Tensor:
        """One SGD step; returns the loss as a device tensor without
        synchronizing.  Listeners (which need a host float) force a sync
        only on the iterations they are due.  accum_steps > 1 splits the
        batch into that many sequential microbatches (same update for
        mean losses, activation memory of one microbatch); a loss-scaled
        policy refuses it (a microbatch sum cannot skip one overflowed
        microbatch)."""
        if self.params is None:
            self.init()
        self._own_updater_state()
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps > 1 and self._precision.loss_scale is not None:
            raise ValueError(
                "accum_steps > 1 is not supported with a loss-scaled "
                "precision policy (a microbatch scan cannot skip one "
                "overflowed microbatch); use plain batches or a policy "
                "without loss scaling")
        x = _as_tensor(x, self.device)
        y = _as_tensor(y, self.device)
        mask = _as_tensor(mask, self.device)
        if accum_steps > 1 and x.shape[0] % accum_steps:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accum_steps {accum_steps}")
        self._ensure_scaler()
        loss, self.last_grad_norm = self._train_step(
            x, y, mask, self._step_rng(), accum_steps)
        self._iteration += 1
        due = self._due_listeners(self._iteration)
        if due:
            loss_f = float(loss)
            for listener in due:
                listener(self._iteration, loss_f)
        return loss

    def fit_batch(self, x, y, mask=None, accum_steps: int = 1) -> float:
        """One SGD step on one minibatch (reference fit(INDArray,INDArray)
        :1244). Returns the loss."""
        return float(self.fit_batch_async(x, y, mask, accum_steps))

    def fit_chunk_async(self, xs, ys, masks=None, weights=None,
                        unroll: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K = xs.shape[0] optimizer steps over stacked ``[K, B, ...]``
        batches, the fused driver's primitive; `weights` ``[K, B]`` zero
        out padded tail rows.  Each step is the per-batch step with the
        example-weighted loss and the iteration's own generator, so any
        chunking of a stream trains the same.  Returns (losses,
        grad_norms) as ``[K]`` device tensors; the host reads the losses
        once, and only when a listener is due.  `unroll` is the JAX
        scan's unroll factor, accepted for its callers: the port's steps
        run one after another either way."""
        if self.params is None:
            self.init()
        self._own_updater_state()
        xs = _as_tensor(xs, self.device)
        ys = _as_tensor(ys, self.device)
        masks = _as_tensor(masks, self.device)
        k = int(xs.shape[0])
        weights = (torch.ones(xs.shape[:2], device=self.device)
                   if weights is None
                   else _as_tensor(weights, self.device).float())
        self._ensure_scaler()
        it0 = self._iteration
        losses, gnorms = [], []
        for i in range(k):
            loss, gnorm = self._train_step(
                xs[i], ys[i], None if masks is None else masks[i],
                self._step_rng(), weights=weights[i])
            self._iteration += 1
            losses.append(loss)
            gnorms.append(gnorm)
        losses, gnorms = torch.stack(losses), torch.stack(gnorms)
        self.last_grad_norm = gnorms[-1]
        self._fire_chunk_listeners(it0, k, losses)
        return losses, gnorms

    def _fire_chunk_listeners(self, it0: int, k: int, losses) -> None:
        """Fire due listeners for iterations it0+1..it0+k with at most one
        host read for the chunk (none when nothing is due).  Listeners
        that read the model fire only for the chunk's last iteration,
        where the model holds that iteration's state."""
        if not self._listeners:
            return
        due = [(it, fn)
               for it in range(it0 + 1, it0 + k + 1)
               for fn, interval, score_only in self._listeners
               if it % interval == 0 and (score_only or it == it0 + k)]
        if not due:
            return
        loss_host = losses.float().cpu().numpy()  # the one read
        for it, fn in due:
            fn(it, float(loss_host[it - it0 - 1]))

    def stage_chunk(self, chunk):
        """An assembled HostChunk with its arrays on the network's device
        (the fused driver's prefetch hook; runs on the producer
        thread)."""
        put = lambda a: _as_tensor(a, self.device)  # noqa: E731
        return chunk._replace(xs=put(chunk.xs), ys=put(chunk.ys),
                              weights=put(chunk.weights),
                              masks=put(chunk.masks))

    def set_lr_scale(self, scale: float) -> None:
        """Scale every applied update by `scale` from the next step on."""
        scale = float(scale)
        if scale <= 0.0:
            raise ValueError(f"lr_scale must be > 0, got {scale}")
        if (scale != 1.0 and self.conf.conf.updater == "adadelta"
                and self._lr_scale == 1.0):
            warnings.warn(
                "lr_scale with AdaDelta is approximate: its update has no "
                "learning-rate term, so scaling the applied step "
                "desynchronizes the accumulated-update state", stacklevel=2)
        self._lr_scale = scale

    def restore_train_state(self, step: int, params,
                            updater_state=None, net_state=None) -> None:
        """Adopt checkpointed training state (params [+ updater moments
        and layer state]) as fresh tensors on the network's device and
        rewind the iteration counter, so the per-step generator
        (`_step_rng`, seeded from the iteration) and the listener
        schedules replay exactly as an uninterrupted run — the
        supervisor's rollback and resume entry point.  `net_state`
        matters for layers with running statistics: a step that
        explodes poisons them too, so rolling back params alone would
        keep the poison.  Each updater leaf lands where a fresh
        ``init`` puts it (the step count on the CPU)."""
        def fresh(a, device):
            return torch.as_tensor(a).detach().to(device).clone()

        with torch.no_grad():
            self.params = map_tree(
                lambda a: fresh(a, self.device).requires_grad_(
                    torch.as_tensor(a).is_floating_point()), params)
            if updater_state is not None:
                self.updater_state = map_tree(
                    lambda a, ref: fresh(a, ref.device), updater_state,
                    self._updater.init(self.params))
            if net_state is not None:
                self.state = map_tree(lambda a: fresh(a, self.device),
                                      net_state)
        self._iteration = int(step)
        self._updater_state_owner = None

    def fit(self, data, epochs: int = 1, accum_steps: int = 1,
            chunk_size: Optional[int] = None, prefetch: int = 2,
            chunk_unroll: int = 1, precision=None) -> "MultiLayerNetwork":
        """Train from an iterable of (x, y[, mask]) tuples or objects with
        .features/.labels/.mask, or from one (x, y[, mask]) tuple, for
        `epochs` passes: greedy `pretrain` first when ``conf.pretrain``
        is set, then the conf's ``optimization_algo`` (stochastic
        gradient descent with accum_steps as in `fit_batch_async`, or a
        line-search solver).

        `chunk_size` routes the SGD loop through the fused driver
        (`runtime.fused.FusedTrainingDriver`): chunk_size steps a
        dispatch, tail batches padded with zero example weights, the next
        chunk staged on the device from a background thread (`prefetch`
        chunks deep, 0 for none).  `precision` adopts a policy for this
        and later training (`set_precision`)."""
        if precision is not None:
            self.set_precision(precision)
        if isinstance(data, types.GeneratorType):
            data = list(_as_batches(data))
        if self.conf.pretrain:
            self.pretrain(data, epochs=1)
        algo = self.conf.conf.optimization_algo
        if algo and algo != "stochastic_gradient_descent":
            if chunk_size is not None:
                raise ValueError(
                    "chunk_size applies to the SGD path; the line-search "
                    f"solvers ({algo}) drive their own loop")
            return self._fit_with_solver(data, epochs, algo)
        if chunk_size is not None:
            if accum_steps != 1:
                raise ValueError(
                    "chunk_size and accum_steps are mutually exclusive "
                    "(a chunk steps over batches, accumulation over "
                    "microbatches of one)")
            from deeplearning4j_tpu_torch.runtime.fused import (
                FusedTrainingDriver,
            )

            FusedTrainingDriver(self, chunk_size=chunk_size,
                                prefetch=prefetch,
                                unroll=chunk_unroll).fit(data, epochs=epochs)
            return self
        loss = None
        for _ in range(epochs):
            for x, y, mask in _as_batches(data):
                loss = self.fit_batch_async(x, y, mask, accum_steps)
            _maybe_reset(data)
        if loss is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _fit_with_solver(self, data, epochs: int,
                         algo: str) -> "MultiLayerNetwork":
        """Train with a line-search solver (reference
        Solver.getOptimizer():56-71): line GD, CG, LBFGS or Hessian-free
        over the flat-parameter objective of each batch in turn, honoring
        num_iterations, max_num_line_search_iterations and minimize.  One
        `Solver` serves every batch: it holds no per-shape state (the
        JAX package keeps one per batch shape for its compiled step)."""
        from deeplearning4j_tpu_torch.optimize.solver import Solver

        if any(lc.lr_multiplier != 1.0 for lc in self.conf.layers):
            raise ValueError(
                "per-layer lr_multiplier is not honored by the "
                "line-search solvers (they optimize one flat objective); "
                "use the SGD path or clear the multipliers")
        if self.params is None:
            self.init()
        cfg = self.conf.conf
        batches = list(_as_batches(data))
        if not batches:
            return self
        solver = Solver.for_model(
            self, *batches[0], algorithm=algo,
            num_iterations=max(1, cfg.num_iterations),
            maximize=not cfg.minimize,
            max_line_iters=cfg.max_num_line_search_iterations)
        for _ in range(epochs):
            for x, y, mask in batches:
                loss = solver.fit_model(x, y, mask)
                self._iteration += 1
                for listener in self._due_listeners(self._iteration):
                    listener(self._iteration, loss)
            _maybe_reset(data)
        return self

    # ---- greedy layer-wise pretraining ------------------------------------

    def pretrain(self, data, epochs: int = 1) -> "MultiLayerNetwork":
        """Greedy layer-wise unsupervised pretraining of the AE and RBM
        layers (reference pretrain(DataSetIterator) :148-179): each in
        turn, on the activations of the layers below it, with its own
        updater, its updates scaled by its lr_multiplier (0 freezes it),
        CD-k for an RBM and the denoising loss's gradient for an AE.
        Layer i draws from a generator seeded ``seed + 17*i`` (the JAX
        package's key, though not its bits).  Each layer's per-batch
        reconstruction errors land in ``pretrain_errors[i]``."""
        if self.params is None:
            self.init()
        if isinstance(data, types.GeneratorType):
            data = list(_as_batches(data))
        cfg = self.conf.conf.updater_config()
        self.pretrain_errors = {}
        for i, lc in enumerate(self.conf.layers):
            if not isinstance(lc, (AutoEncoderConf, RBMConf)) or \
                    lc.lr_multiplier == 0.0:
                continue
            p = self.params[i]
            updater = make_updater(cfg)
            upd_state = updater.init(p)
            gen = torch.Generator(device=self.device).manual_seed(
                self.conf.conf.seed + 17 * i)
            errs = []
            for _ in range(epochs):
                for x, *_ in _as_batches(data):
                    with torch.no_grad():
                        h, _ = self._forward(self.params, self.state,
                                             _as_tensor(x, self.device),
                                             train=False, upto=i)
                    h = h.to(p["W"].dtype)
                    if isinstance(lc, RBMConf):
                        grads, err = rbm_cd_grads(lc, p, h, gen)
                    else:
                        err = ae_pretrain_loss(lc, p, h, gen)
                        grads = dict(zip(p, torch.autograd.grad(
                            err, list(p.values()))))
                    updates, upd_state = updater.update(grads, upd_state, p)
                    if lc.lr_multiplier != 1.0:
                        updates = map_tree(lambda u: u * lc.lr_multiplier,
                                           updates)
                    apply_updates(p, updates)
                    errs.append(err.detach())
                _maybe_reset(data)
            self.pretrain_errors[i] = (torch.stack(errs).float().cpu()
                                       .tolist() if errs else [])
        return self

    # ---- inference / scoring ----------------------------------------------

    @torch.no_grad()
    def output(self, x, mask=None) -> torch.Tensor:
        """Forward pass activations of the final layer in the policy's
        output dtype, on the device (reference output() :1313)."""
        if self.params is None:
            self.init()
        x = _as_tensor(x, self.device)
        mask = _as_tensor(mask, self.device)
        self._signatures.add((tuple(x.shape), x.dtype, mask is not None))
        out, _ = self._forward(self.params, self.state, x, train=False,
                               mask=mask)
        return out.to(self._output_dtype)

    def output_bucketed(self, x, mask=None, ladder=None) -> np.ndarray:
        """`output` through a serving `BucketLadder`: the batch is padded
        up to the ladder's next bucket, run once, and the padding rows
        sliced off on the host, so a stream of mixed batch sizes runs
        one program per bucket (`runtime.programs.BucketPrograms`: a
        CUDA graph captured on the bucket's first call on the card).
        Inference rows are independent, so the real rows are those of a
        dispatch of the padded batch.  Returns a host array (float32 for
        a bfloat16 output dtype)."""
        from deeplearning4j_tpu_torch.serving.bucketing import BucketLadder

        if ladder is None:
            ladder = BucketLadder()
        if self.params is None:
            self.init()
        padded, n = ladder.pad_rows(_host_input(x))
        if mask is not None:
            mask, _ = ladder.pad_rows(_host_input(mask))
        if self._bucket_programs is None:
            self._bucket_programs = BucketPrograms(
                self.device, self._bucket_forward,
                lambda: [*tree_leaves(self.params), *tree_leaves(self.state)])
        self._signatures.add((tuple(padded.shape),
                              torch.from_numpy(padded[:0]).dtype,
                              mask is not None))
        out = self._bucket_programs(padded, mask)
        return out if n == padded.shape[0] else out[:n]

    def _bucket_forward(self, x: torch.Tensor,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
        """`output`'s forward on a bucket's static inputs (the program
        body of `output_bucketed`)."""
        out, _ = self._forward(self.params, self.state, x, train=False,
                               mask=mask)
        out = out.to(self._output_dtype)
        return out.float() if out.dtype == torch.bfloat16 else out

    def forward_program_count(self) -> int:
        """Distinct input signatures (shape, dtype, mask present) the
        inference forward (`output`, `output_bucketed`) has run since the
        last `set_precision`: the JAX package's count of the programs its
        jitted forward compiled, one per such signature.  The bucket
        ladder bounds it; `output_bucketed` builds one program for each
        of its signatures, `output` runs eagerly."""
        return len(self._signatures)

    @torch.no_grad()
    def feed_forward(self, x, mask=None) -> List[torch.Tensor]:
        """All per-layer activations (reference feedForward() :542)."""
        acts, _ = self._forward(self.params, self.state,
                                _as_tensor(x, self.device), train=False,
                                mask=_as_tensor(mask, self.device),
                                collect=True)
        return acts

    def predict(self, x, mask=None) -> np.ndarray:
        """Class indices (reference predict() :1212)."""
        return self.output(x, mask).argmax(dim=-1).cpu().numpy()

    def label_probabilities(self, x, mask=None) -> np.ndarray:
        return self.output(x, mask).float().cpu().numpy()

    @torch.no_grad()
    def score(self, x, y, mask=None) -> float:
        """Loss on a dataset (reference score() :1391)."""
        if self.params is None:
            self.init()
        return float(self._objective(
            self.params, self.state, _as_tensor(x, self.device),
            _as_tensor(y, self.device), None,
            _as_tensor(mask, self.device))[0])

    def evaluate(self, x, y, mask=None, batch_size: Optional[int] = None):
        """Classification metrics over a dataset; `batch_size` evaluates
        in chunks (the confusion counts accumulate identically)."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation

        ev = Evaluation()
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if batch_size is None:
            ev.eval(np.asarray(y), self.label_probabilities(x, mask))
            return ev
        xd = _as_tensor(x, self.device)
        md = _as_tensor(mask, self.device)
        outs = [self.output(xd[i:i + batch_size],
                            None if md is None else md[i:i + batch_size])
                for i in range(0, xd.shape[0], batch_size)]
        ev.eval(np.asarray(y), torch.cat(outs).float().cpu().numpy())
        return ev

    # ---- parameter vector view (checkpoint/shipping format) ----------------

    def _param_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        """(``"i/key"``, leaf) layer by layer, keys sorted: the flat order
        (uppercase first, so an LSTM's is RW, W, b, pf, pi, po)."""
        return [(f"{i}/{k}", p[k]) for i, p in enumerate(self.params)
                for k in sorted(p)]

    def num_params(self) -> int:
        return int(sum(a.numel() for _, a in self._param_leaves()))

    def params_flat(self, dtype=np.float32) -> np.ndarray:
        """Single flat float vector in the deterministic order (reference
        params() :836 / pack() :883).  ``dtype=None`` keeps the native
        parameter dtype where numpy has it (bfloat16 comes back as
        float32, which is exact)."""
        if not self.params:
            return np.zeros((0,), dtype if dtype is not None else np.float32)
        parts = []
        for _, a in self._param_leaves():
            a = a.detach()
            if a.dtype in (torch.bfloat16, torch.float16) and (
                    dtype is None or a.dtype == torch.bfloat16):
                a = a.float()
            parts.append(a.cpu().numpy().reshape(-1))
        flat = np.concatenate(parts)
        return flat if dtype is None else flat.astype(dtype, copy=False)

    def set_params_flat(self, vec: np.ndarray) -> None:
        """Inverse of params_flat; each chunk is cast to its leaf's dtype."""
        self.params = params_from_numpy(self, vec)

    def summary(self) -> str:
        """Human-readable layer table (layer type, shapes, parameter
        counts).  Initializes the network if needed."""
        if self.params is None:
            self.init()
        w = max([len(type(lc).__name__) for lc in self.conf.layers]
                + [len("type")])
        lines = [f"{'#':>3}  {'type':<{w}} {'in->out':<14} {'params':>10}"]
        total = 0
        for i, (lc, p) in enumerate(zip(self.conf.layers, self.params)):
            n = int(sum(a.numel() for a in p.values()))
            total += n
            shape = ("-" if lc.n_in is None
                     else f"{lc.n_in}->{lc.n_out if lc.n_out is not None else lc.n_in}")
            lines.append(f"{i:>3}  {type(lc).__name__:<{w}} {shape:<14} "
                         f"{n:>10,}")
        lines.append(f"{'':>3}  {'TOTAL':<{w}} {'':<14} {total:>10,}")
        return "\n".join(lines)

    def merge(self, others) -> None:
        """Parameter averaging across replicas (reference merge() :1499):
        this network's flat parameters become the mean of its own and
        each of `others`'."""
        stacked = [self.params_flat()] + [o.params_flat() for o in others]
        self.set_params_flat(np.mean(np.stack(stacked, 0), axis=0))

    def clone(self) -> "MultiLayerNetwork":
        net = MultiLayerNetwork(self.conf, device=self.device)
        net.init()
        net.set_params_flat(self.params_flat())
        return net


def _as_batches(data) -> Iterable[Tuple]:
    """Normalise data inputs to an iterable of (x, y, mask) tuples."""
    if isinstance(data, tuple) and len(data) in (2, 3):
        yield (data + (None,))[:3]
        return
    for item in data:
        if isinstance(item, tuple):
            yield (item + (None,))[:3]
        else:  # DataSet-like
            yield (item.features, item.labels, getattr(item, "mask", None))


def _maybe_reset(data) -> None:
    reset = getattr(data, "reset", None)
    if callable(reset):
        reset()


__all__ = ["MultiLayerNetwork", "apply_preprocessor", "params_from_numpy"]
