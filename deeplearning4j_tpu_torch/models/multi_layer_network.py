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

The network lives on one device: `resolve_device(device)`, the card
unless the caller asks for the CPU.  Left out for now, each raising
NotImplementedError that names ROADMAP.md's queue A3b: precision
policies other than the conf's (`set_precision`, ``fit(precision=)``,
the loss-scaled step), chunked fit (`fit_chunk_async`, ``chunk_size``),
`output_bucketed` and `merge`.
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
from deeplearning4j_tpu_torch.parallel.transformer import torch_dtype
from deeplearning4j_tpu_torch.tree import map_tree, tree_leaves

Tree = Any

# Fused logit-space losses for stability: (activation, loss) -> fused loss name.
_FUSED = {
    ("softmax", "mcxent"): "mcxent_with_logits",
    ("softmax", "negativeloglikelihood"): "mcxent_with_logits",
    ("sigmoid", "xent"): "xent_with_logits",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP.md, queue A3b)")


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
        if (conf.conf.updater == "adadelta"
                and any(lc.lr_multiplier != 1.0 for lc in conf.layers)):
            raise ValueError(
                "lr_multiplier is not supported with AdaDelta: its update "
                "has no learning-rate term, so scaling the applied step "
                "desynchronizes the accumulated-update state")
        self._updater = make_updater(conf.conf.updater_config())
        self._dtype = torch_dtype(conf.conf.dtype)
        self._compute_dtype = torch_dtype(conf.conf.compute_dtype)
        self._output_dtype = torch_dtype(conf.conf.output_dtype)
        self._lr_scale = 1.0
        self.last_grad_norm: Optional[torch.Tensor] = None
        self._listeners: list = []
        self._iteration = 0
        # layer index -> per-batch reconstruction errors of `pretrain`
        self.pretrain_errors: Dict[int, List[float]] = {}

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
        (and so read the loss back from the device)."""
        interval = max(1, int(getattr(fn, "sync_interval", 1)))
        if hasattr(fn, "iteration_done"):
            obj = fn
            fn = lambda it, score: obj.iteration_done(self, it, score)  # noqa: E731
        self._listeners.append((fn, interval))

    def _due_listeners(self, iteration: int) -> list:
        return [fn for fn, interval in self._listeners
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

    def _train_step(self, x, y, mask, rng, accum: int = 1):
        """One optimizer step over a batch; with ``accum > 1`` the batch
        is split into that many sequential microbatches whose gradients
        are weighted by their share of the batch's normalizer (valid mask
        tokens when a sequence mask is present, else uniform), so the
        accumulated update equals the full-batch one.  Returns (loss,
        global gradient norm) as device tensors."""
        if accum == 1:
            loss, new_state = self._objective(self.params, self.state,
                                              x, y, rng, mask)
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
        gnorm = global_grad_norm(grads)
        updates, self.updater_state = self._updater.update(
            grads, self.updater_state, self.params)
        updates = self._apply_lr_multipliers(updates)
        if self._lr_scale != 1.0:
            updates = map_tree(lambda u: u * self._lr_scale, updates)
        apply_updates(self.params, updates)
        self.state = new_state
        return loss.detach(), gnorm

    def fit_batch_async(self, x, y, mask=None,
                        accum_steps: int = 1) -> torch.Tensor:
        """One SGD step; returns the loss as a device tensor without
        synchronizing.  Listeners (which need a host float) force a sync
        only on the iterations they are due.  accum_steps > 1 splits the
        batch into that many sequential microbatches (same update for
        mean losses, activation memory of one microbatch)."""
        if self.params is None:
            self.init()
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        x = _as_tensor(x, self.device)
        y = _as_tensor(y, self.device)
        mask = _as_tensor(mask, self.device)
        if accum_steps > 1 and x.shape[0] % accum_steps:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accum_steps {accum_steps}")
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

    def fit(self, data, epochs: int = 1, accum_steps: int = 1,
            chunk_size: Optional[int] = None,
            precision=None) -> "MultiLayerNetwork":
        """Train from an iterable of (x, y[, mask]) tuples or objects with
        .features/.labels/.mask, or from one (x, y[, mask]) tuple, for
        `epochs` passes: greedy `pretrain` first when ``conf.pretrain``
        is set, then the conf's ``optimization_algo`` (stochastic
        gradient descent with accum_steps as in `fit_batch_async`, or a
        line-search solver)."""
        if precision is not None:
            raise _not_ported("fit(precision=...)")
        if chunk_size is not None:
            raise _not_ported("chunked fit (chunk_size)")
        if isinstance(data, types.GeneratorType):
            data = list(_as_batches(data))
        if self.conf.pretrain:
            self.pretrain(data, epochs=1)
        algo = self.conf.conf.optimization_algo
        if algo and algo != "stochastic_gradient_descent":
            return self._fit_with_solver(data, epochs, algo)
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

    # ---- parts not ported yet ---------------------------------------------

    def set_precision(self, policy) -> "MultiLayerNetwork":
        raise _not_ported("set_precision (precision policies)")

    def fit_chunk_async(self, *args, **kwargs):
        raise _not_ported("fit_chunk_async (the fused multi-step driver)")

    def output_bucketed(self, x, mask=None, ladder=None):
        raise _not_ported("output_bucketed (serving bucket ladders)")

    def merge(self, others):
        raise _not_ported("merge (parameter averaging)")

    # ---- inference / scoring ----------------------------------------------

    @torch.no_grad()
    def output(self, x, mask=None) -> torch.Tensor:
        """Forward pass activations of the final layer in the conf's
        output dtype, on the device (reference output() :1313)."""
        if self.params is None:
            self.init()
        out, _ = self._forward(self.params, self.state,
                               _as_tensor(x, self.device), train=False,
                               mask=_as_tensor(mask, self.device))
        return out.to(self._output_dtype)

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
