"""LM training: the single-device step and the mesh trainers
(counterpart of `deeplearning4j_tpu.parallel.hybrid`).

- `make_accum_train_step` is the JAX package's GPT-2-class training
  path: float32 master parameters, the compute dtype of the config
  (bfloat16 on the card) reached by a cast INSIDE the loss, so the
  gradients land on the f32 masters; gradient accumulation over `accum`
  sequential microbatches; any updater of `ops.updaters`.  With a 1-D
  ``data`` mesh (``lm -runtime spmd``) each microbatch is cut over the
  shards and their gradients meet in `mesh.pmean`.
- `HybridParallelTrainer`: the TransformerLM over a (data, seq, model)
  mesh — the batch over ``data``, positions over ``seq`` with ring
  attention, heads / hidden / experts over ``model`` (tp + ep), as
  `transformer.apply` runs it under a mesh.  One loss over the whole
  mesh program and one backward: autograd derives the backward sums.
- `PipelineParallelTrainer`: a (data, stage) mesh — the blocks stacked
  ``[layers_per_stage, ...]`` a stage, GPipe microbatching
  (`pipeline.gpipe_apply`); each data shard runs its pipeline and its
  backward, and the gradients meet across ``data`` in shard order.

Both keep float32 masters whatever the config's compute dtype, and both
place their optimizer state ZeRO-1 style by default (``shard_update``):
each data shard updates and keeps only its slice of the moments.  The
collectives sum in shard order, so the ZeRO-1 update equals the
replicated one bitwise.  The JAX package compiles each step as one
GSPMD / ``shard_map`` program; the port runs the shards in Python
loops, each shard's tensors on its mesh device, so a mesh may list one
card several times (``[cuda:0] * 4``: four shards on one card).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.updaters import (
    UpdaterConfig,
    apply_updates,
    make_updater,
)
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
from deeplearning4j_tpu_torch.parallel import partition as part_lib
from deeplearning4j_tpu_torch.parallel.data_parallel import _flat
from deeplearning4j_tpu_torch.parallel import transformer as tfm
from deeplearning4j_tpu_torch.parallel.kernels import flash_attention
from deeplearning4j_tpu_torch.parallel.pipeline import (
    gpipe_apply,
    zero1_flat_update,
)
from deeplearning4j_tpu_torch.tree import flatten_tree, map_tree, tree_leaves


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
                          lr_schedule: Optional[Callable] = None,
                          mesh: Optional[mesh_lib.Mesh] = None):
    """Returns (step, init_state):

      init_state(params) -> opt_state
      step(params, opt_state, tokens, targets) -> (params, opt_state,
      mean_loss)

    `params` are f32 masters (`_master_f32`); `step` updates them and the
    optimizer state in place and returns them.  tokens/targets are
    ``[accum * mb, S]``; the microbatches run one after another, so
    activation memory is that of one microbatch, and the summed
    gradients and losses are divided by `accum`.  `mean_loss` is a 0-dim
    float32 tensor on the parameters' device.

    With `mesh` (one ``data`` axis) each microbatch's rows are cut over
    the shards (contiguous blocks), each shard differentiates its own
    mean loss on its device, and the gradients and losses meet in
    `mesh.pmean` (row-weighted when a microbatch does not split evenly):
    the gradient of the microbatch's mean loss, as GSPMD computes it
    for the JAX step over a sharded batch.  A mesh that spans processes
    is refused (`mesh.refuse_spanning`)."""
    mesh_lib.refuse_spanning(mesh, "make_accum_train_step")
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
        if mesh is not None:
            grads, loss = _spmd_grads(mesh, loss_fn, params, tok_mb, tgt_mb)
        else:
            for i in range(accum):
                l = loss_fn(params, tok_mb[i], tgt_mb[i])
                l.backward()
                loss = loss + l.detach().float()
            grads = map_tree(lambda p: p.grad / accum if accum > 1
                             else p.grad, params)
            for p in leaves:
                p.grad = None
        updates, opt_state = transform.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, loss / accum

    return step, transform.init


def _spmd_grads(mesh, loss_fn, params, tok_mb, tgt_mb):
    """(gradient tree, summed loss over the microbatches) of the data-
    parallel step: each microbatch's rows cut over the mesh's shards,
    each shard's gradient of its own mean loss, met in `mesh.pmean`."""
    devices = mesh.flat_devices()
    home = tok_mb.device
    reps = mesh_lib.replicate(mesh, params, home, grad=True)
    accum = tok_mb.shape[0]
    total, loss = None, torch.zeros((), dtype=torch.float32, device=home)
    for i in range(accum):
        rows = tok_mb[i].shape[0]
        pieces = list(zip(tok_mb[i].chunk(len(devices)),
                          tgt_mb[i].chunk(len(devices))))
        gs, ls, ws = [], [], []
        for (tk, tg), p, dev in zip(pieces, reps, devices):
            leaves = [a for a in tree_leaves(p) if a.requires_grad]
            l = loss_fn(p, tk.to(dev), tg.to(dev))
            gs.append(torch.autograd.grad(l, leaves))
            ls.append(l.detach().float())
            ws.append(tk.shape[0] / rows)
        if len(set(ws)) == 1 and len(ws) == len(devices):
            g = [mesh_lib.pmean([gj[k] for gj in gs], home, mesh)
                 for k in range(len(gs[0]))]
            l = mesh_lib.pmean(ls, home, mesh)
        else:
            g = [mesh_lib.psum([gj[k] * w for gj, w in zip(gs, ws)], home,
                               mesh)
                 for k in range(len(gs[0]))]
            l = mesh_lib.psum([li * w for li, w in zip(ls, ws)], home, mesh)
        total = g if total is None else [a + b for a, b in zip(total, g)]
        loss = loss + l
    it = iter([g / accum if accum > 1 else g for g in total])
    grads = map_tree(lambda p: next(it) if p.requires_grad else None,
                     params)
    return grads, loss


# ---------------------------------------------------------------------------
# the mesh trainers

def place_params(mesh: mesh_lib.Mesh, tree, spec_tree):
    """A tree placed on the mesh by a matching tree of `partition`
    specs: a replicated leaf as one tensor on the mesh's first device; a
    leaf split on dim `dim` over axis `axis` as the list of its slices
    (a shard list), slice i on the device at coordinate i of `axis` (0
    on the other axes).  Leaves may be tensors or numpy arrays."""
    mesh_lib.refuse_spanning(mesh, "place_params")
    first = mesh.flat_devices()[0]

    def place(spec, leaf):
        t = torch.as_tensor(np.asarray(leaf) if not torch.is_tensor(leaf)
                            else leaf)
        if spec.is_replicated:
            return t.to(first)
        n = mesh.shape[spec.axis]
        if t.shape[spec.dim] % n:
            raise ValueError(f"dim {spec.dim} of a {tuple(t.shape)} leaf "
                             f"does not split over {n} '{spec.axis}' shards")
        k = mesh.axis_names.index(spec.axis)
        out = []
        for i, piece in enumerate(t.chunk(n, dim=spec.dim)):
            coord = [0] * len(mesh.axis_names)
            coord[k] = i
            out.append(piece.to(mesh.devices[tuple(coord)]))
        return out

    return map_tree(place, spec_tree, tree)


def _fresh_master(a: torch.Tensor) -> torch.Tensor:
    return a.detach().to(torch.float32, copy=True).contiguous() \
        .requires_grad_(True)


def _like(tree, values):
    """`tree`'s structure (dicts and lists) with its leaves replaced by
    `values`, in tree order."""
    it = iter(values)
    return map_tree(lambda _: next(it), tree)


def _tokens(a) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.require(np.asarray(a), requirements=["C"]))
    return a.long()


def _mesh_device(mesh: mesh_lib.Mesh, **coords) -> torch.device:
    """The device at the named coordinates (0 on the axes not named)."""
    return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]


class HybridParallelTrainer:
    """dp x sp x tp (+ ep) training of the TransformerLM over a mesh with
    the axes of `axes` (data, seq, model).

    Parameters: float32 masters placed by `param_specs` (`place_params`):
    each ``model`` shard holds only its slice of the split leaves, the
    replicated ones live on the first shard's device; the forward casts
    them to the config's dtype inside the loss.  `params` (a numpy tree
    in `init_params` layout) starts the trainer from given weights, else
    they are drawn from a generator seeded with `seed`.

    The optimizer state mirrors the parameters; with `shard_update` (the
    default, ZeRO-1) every moment leaf also splits its first free dim
    (not the ``model`` one) whose size divides by the ``data`` degree,
    and data shard j keeps and updates only slice j of it — on the
    device of shard (j, 0, t) — with its own copy of the step count; a
    leaf with no such dim stays whole with data shard 0.  The update is
    elementwise, so the result equals ``shard_update=False`` bitwise.
    `opt_state` is that state: a list over the data shards of
    `ops.updaters` states over ``{keypath: slice}`` under ZeRO-1, one
    state over the parameter tree otherwise."""

    def __init__(self, cfg: tfm.TransformerConfig, mesh: mesh_lib.Mesh,
                 lr: float = 1e-2, seed: int = 0,
                 axes: tfm.MeshAxes = tfm.MeshAxes(),
                 updater: str = "sgd", shard_update: bool = True,
                 params=None):
        mesh_lib.refuse_spanning(mesh, "HybridParallelTrainer")
        self.cfg = cfg
        self.mesh = mesh
        self.lr = lr
        self.axes = axes
        self.shard_update = bool(shard_update)
        self._grid = tfm._Grid(mesh, axes)
        self._grid.check(cfg)
        home = self._grid.device()
        if params is None:
            tree = tfm.init_params(
                cfg, generator=torch.Generator().manual_seed(seed),
                device=home)
        else:
            tree = tfm.params_from_numpy(params, device=home)
        self._pspecs = tfm.param_specs(cfg, axes.model)
        self.params = map_tree(_fresh_master,
                               place_params(mesh, tree, self._pspecs))
        self._transform = make_updater(UpdaterConfig(
            updater=updater, learning_rate=lr, epsilon=1e-8))
        self._units = self._zero1_units()
        if self.shard_update:
            flat = {k: u.detach() for k, u in self._flat().items()}
            self.opt_state = [
                self._transform.init(self._on_shard(
                    j, self._data_slice(j, flat)))
                for j in range(self._grid.dp)]
        else:
            self.opt_state = self._transform.init(self.params)

    # ---- ZeRO-1 layout ------------------------------------------------------

    def _flat(self) -> dict:
        """{keypath: master tensor}; a split leaf's slices are
        ``keypath//t``."""
        return flatten_tree(self.params)

    def _zero1_units(self) -> dict:
        """keypath -> (the ZeRO-1 dim or None, the ``model`` index)."""
        specs = flatten_tree(self._pspecs)
        dp = self._grid.dp
        units = {}
        for key, t in self._flat().items():
            if key in specs:
                spec, tidx = specs[key], 0
            else:
                parent, tidx = key.rsplit("//", 1)
                spec, tidx = specs[parent], int(tidx)
            zdim = None
            if dp > 1:
                for d, size in enumerate(t.shape):
                    if d != spec.dim and size and size % dp == 0:
                        zdim = d
                        break
            units[key] = (zdim, tidx)
        return units

    def opt_partition(self) -> dict:
        """{keypath: the `partition` spec of its moments over ``data``}."""
        return {k: (part_lib.sharded(self.axes.data, z) if z is not None
                    else part_lib.replicated())
                for k, (z, _) in self._units.items()}

    def _data_slice(self, j: int, flat: dict) -> dict:
        """Data shard j's slices of a {keypath: tensor} map: views of the
        tensors (a leaf with no ZeRO-1 dim whole, for shard 0 only)."""
        dp = self._grid.dp
        out = {}
        for key, a in flat.items():
            zdim, _ = self._units[key]
            if zdim is None:
                if j == 0:
                    out[key] = a
            else:
                n = a.shape[zdim] // dp
                out[key] = a.narrow(zdim, j * n, n)
        return out

    def _on_shard(self, j: int, flat: dict) -> dict:
        """A `_data_slice` map on data shard j's devices (the tensors
        themselves where they already are)."""
        return {k: a.to(self._grid.device(j, 0, self._units[k][1]))
                for k, a in flat.items()}

    # ---- the step -------------------------------------------------------------

    def _step(self, tokens, targets) -> torch.Tensor:
        cd = tfm.torch_dtype(self.cfg.dtype)
        pc = (self.params if cd == torch.float32
              else _cast_floating(self.params, cd))
        loss = tfm.lm_loss(self.cfg, pc, tokens, targets, self.mesh,
                           self.axes)
        flat = self._flat()
        grads = torch.autograd.grad(loss, list(flat.values()))
        if not self.shard_update:
            updates, self.opt_state = self._transform.update(
                _like(self.params, grads), self.opt_state, self.params)
            apply_updates(self.params, updates)
            return loss.detach()
        gflat = dict(zip(flat, grads))
        pflat = {k: t.detach() for k, t in flat.items()}
        with torch.no_grad():
            for j in range(self._grid.dp):
                views = self._data_slice(j, pflat)
                p_j = self._on_shard(j, views)
                up, self.opt_state[j] = self._transform.update(
                    self._on_shard(j, self._data_slice(j, gflat)),
                    self.opt_state[j], p_j)
                apply_updates(p_j, up)
                for key, new in p_j.items():
                    if new is not views[key]:
                        # another device's slice: written back home
                        views[key].copy_(new)
        return loss.detach()

    def fit_batch_async(self, tokens, targets) -> torch.Tensor:
        """One step; returns the loss as a device tensor without waiting
        for the step (sync only where a report is due)."""
        return self._step(_tokens(tokens), _tokens(targets))

    def fit_batch(self, tokens, targets) -> float:
        """`fit_batch_async` and a host read of the loss."""
        return float(self.fit_batch_async(tokens, targets))

    def export_params(self) -> dict:
        """A host copy of the parameters in the `init_params` layout (the
        ``model`` slices joined), as float32 numpy arrays."""
        host = map_tree(lambda a: a.detach().float().cpu().numpy(),
                        self.params)
        return part_lib.gather_tree(host, self._pspecs)


class PipelineParallelTrainer:
    """dp x pp training: the transformer blocks cut over the `stage_axis`
    of a (data, stage) mesh, GPipe microbatching within each data shard.

    `stage_params` holds the blocks stacked a stage: each leaf is the
    list over the stages of a ``[layers_per_stage, ...]`` tensor on the
    stage's device (shard (0, s)).  `io_params` (embed, pos, ln_f, and
    head when untied) are replicated; every stage embeds and scores only
    its own microbatches, so their gradients are summed across stages (a
    tied embedding gets its lookup's and its head's).  Each data shard's
    loss is normalised by its own ``b * s``; the step's loss and
    gradients are their means over ``data``, in shard order.

    With `shard_update` (ZeRO-1, the default) the optimizer state lives
    on flat planes: each stage's parameters raveled and padded to a
    multiple of the data degree, data shard j keeping slice j on shard
    (j, s), and the io parameters likewise on shards (j, 0); a step
    reduce-scatters each plane's gradient (`pipeline.zero1_flat_update`).
    The result equals ``shard_update=False`` bitwise.  MoE configs and a
    layer count that does not split into the stages raise ValueError."""

    def __init__(self, cfg: tfm.TransformerConfig, mesh: mesh_lib.Mesh,
                 n_microbatches: int = 4, lr: float = 1e-2, seed: int = 0,
                 data_axis: str = "data", stage_axis: str = "stage",
                 updater: str = "sgd", shard_update: bool = True,
                 params=None):
        mesh_lib.refuse_spanning(mesh, "PipelineParallelTrainer")
        if cfg.n_experts:
            raise ValueError("pipeline trainer uses dense MLP blocks; "
                             "train MoE configs on the dp/sp/tp/ep mesh")
        extra = [a for a in mesh.axis_names
                 if a not in (data_axis, stage_axis)]
        if extra:
            raise ValueError(f"mesh axes {extra} are neither "
                             f"{data_axis!r} nor {stage_axis!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.lr = lr
        self.m = n_microbatches
        self.axes = (data_axis, stage_axis)
        n_stages = mesh.shape[stage_axis]
        if cfg.n_layers % n_stages:
            raise ValueError(
                f"n_layers {cfg.n_layers} must divide into {n_stages} stages")
        self.layers_per_stage = cfg.n_layers // n_stages
        self.n_stages = n_stages
        self.n_data = mesh.shape.get(data_axis, 1)
        home = self._dev(0, 0)
        if params is None:
            full = tfm.init_params(
                cfg, generator=torch.Generator().manual_seed(seed),
                device=home)
        else:
            full = tfm.params_from_numpy(params, device=home)
        lps = self.layers_per_stage
        layers = full["layers"]
        self.stage_params = map_tree(
            lambda *ls: [_fresh_master(torch.stack(
                ls[s * lps:(s + 1) * lps]).to(self._dev(0, s)))
                for s in range(n_stages)], layers[0], *layers[1:])
        io = {"embed": full["embed"], "pos": full["pos"],
              "ln_f": full["ln_f"]}
        if not cfg.tie_embeddings:
            io["head"] = full["head"]
        self.io_params = map_tree(_fresh_master, io)
        self._transform = make_updater(UpdaterConfig(
            updater=updater, learning_rate=lr, epsilon=1e-8))
        self.shard_update = bool(shard_update)
        if self.shard_update:
            stage0 = self._stage_leaves(0)
            self._k0_stage = sum(t.numel() for t in stage0)
            self._pe_stage = part_lib.padded_extent(self._k0_stage,
                                                    self.n_data)
            self._k0_io = sum(t.numel() for t in tree_leaves(self.io_params))
            self._pe_io = part_lib.padded_extent(self._k0_io, self.n_data)
            self.stage_opt = [
                [self._flat_state(self._pe_stage, self._dev(j, s))
                 for j in range(self.n_data)] for s in range(n_stages)]
            self.io_opt = [self._flat_state(self._pe_io, self._dev(j, 0))
                           for j in range(self.n_data)]
        else:
            self.stage_opt = self._transform.init(self.stage_params)
            self.io_opt = self._transform.init(self.io_params)

    def _dev(self, d: int, s: int) -> torch.device:
        data_axis, stage_axis = self.axes
        return _mesh_device(self.mesh, **{data_axis: d, stage_axis: s})

    def _flat_state(self, pe: int, device: torch.device):
        return self._transform.init(
            {"p": torch.zeros(pe // self.n_data, device=device)})

    def _stage_view(self, tree, s: int):
        """Stage s's entry of each stage list of a `stage_params`-shaped
        tree."""
        if isinstance(tree, dict):
            return {k: self._stage_view(v, s) for k, v in tree.items()}
        return tree[s]

    def _stage_leaves(self, s: int) -> List[torch.Tensor]:
        """Stage s's parameter tensors in the flat order (keys sorted)."""
        flat = flatten_tree(self._stage_view(self.stage_params, s))
        return [flat[k] for k in sorted(flat)]

    def _stage_fn(self, params, x):
        """This stage's blocks; the activation shape is kept."""
        for i in range(self.layers_per_stage):
            layer = map_tree(lambda a: a[i], params)
            q, k, v = tfm.qkv_proj(layer["attn"],
                                   tfm._layer_norm(layer["ln1"], x))
            x = x + tfm.out_proj(layer["attn"], flash_attention(q, k, v,
                                                                True))
            x = x + tfm._mlp(layer["mlp"], tfm._layer_norm(layer["ln2"], x))
        return x

    def _data_loss(self, d: int, tokens: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
        """Data shard d's mean loss over its ``b * s`` tokens: each stage
        embeds its blocked share of the microbatches, the pipeline runs,
        and each stage scores the outputs it banked."""
        cd = tfm.torch_dtype(self.cfg.dtype)
        sp, io = self.stage_params, self.io_params
        if cd != torch.float32:
            sp, io = _cast_floating(sp, cd), _cast_floating(io, cd)
        b, s = tokens.shape
        m, n_st = self.m, self.n_stages
        k = -(-m // n_st)
        mb_b = b // m
        pad = torch.zeros((k * n_st - m, mb_b, s), dtype=tokens.dtype,
                          device=tokens.device)
        tok_mb = torch.cat([tokens.reshape(m, mb_b, s), pad])
        tgt_mb = torch.cat([targets.reshape(m, mb_b, s).to(tokens.device),
                            pad])
        devs = [self._dev(d, st) for st in range(n_st)]
        x_local = []
        for st, dev in enumerate(devs):
            my = tok_mb[st * k:(st + 1) * k].to(dev)
            x_local.append(io["embed"].to(dev)[my]
                           + io["pos"].to(dev)[:s][None, None])
        stage_p = [tfm._on(self._stage_view(sp, st), dev)
                   for st, dev in enumerate(devs)]
        ys = gpipe_apply(self._stage_fn, stage_p, x_local, self.axes[1], m)
        sums = []
        for st, dev in enumerate(devs):
            n_valid = min(max(m - st * k, 0), k)  # padding slots score 0
            if not n_valid:
                continue
            iod = tfm._on(io, dev)
            y = tfm._layer_norm(iod["ln_f"], ys[st][:n_valid])
            logp = F.log_softmax(y @ tfm.lm_head(iod), dim=-1)
            tg = tgt_mb[st * k:st * k + n_valid].to(dev)
            sums.append(-logp.gather(-1, tg[..., None]).float().sum())
        return (mesh_lib.psum(sums, devs[0]) / (b * s)).to(logp.dtype)

    def _step(self, tokens: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
        n = self.n_data
        local = tokens.shape[0] // n
        stage_leaves = tree_leaves(self.stage_params)
        io_leaves = tree_leaves(self.io_params)
        leaves = stage_leaves + io_leaves
        losses, grads = [], []
        for d in range(n):
            rows = slice(d * local, (d + 1) * local)
            loss_d = self._data_loss(d, tokens[rows], targets[rows])
            grads.append(torch.autograd.grad(loss_d, leaves))
            losses.append(loss_d.detach())
        home = self._dev(0, 0)
        loss = mesh_lib.pmean(losses, home)
        ns = len(stage_leaves)
        if self.shard_update:
            self._zero1_update([g[:ns] for g in grads],
                               [g[ns:] for g in grads])
            return loss
        mean = [mesh_lib.pmean([g[i] for g in grads], leaf.device)
                for i, leaf in enumerate(leaves)]
        up, self.stage_opt = self._transform.update(
            _like(self.stage_params, mean[:ns]), self.stage_opt,
            self.stage_params)
        apply_updates(self.stage_params, up)
        up, self.io_opt = self._transform.update(
            _like(self.io_params, mean[ns:]), self.io_opt, self.io_params)
        apply_updates(self.io_params, up)
        return loss

    def _zero1_update(self, g_stage: list, g_io: list) -> None:
        """The flat ZeRO-1 rounds: one a stage over (stage, data), one
        for the io plane over data."""
        flat = flatten_tree(self.stage_params)
        keys, leaves = list(flat), list(flat.values())
        with torch.no_grad():
            for s in range(self.n_stages):
                own = sorted((i for i, k in enumerate(keys)
                              if k.rsplit("//", 1)[1] == str(s)),
                             key=lambda i: keys[i])
                params = [leaves[i] for i in own]
                flats = [_flat([g[i] for i in own], self._pe_stage)
                         for g in g_stage]
                flat_p = _flat([p.detach() for p in params], self._pe_stage)
                new, self.stage_opt[s] = zero1_flat_update(
                    self._transform, self.stage_opt[s], flats, flat_p,
                    [self._dev(j, s) for j in range(self.n_data)],
                    self._k0_stage)
                _write_flat(params, new)
            io = tree_leaves(self.io_params)
            flats = [_flat(list(g), self._pe_io) for g in g_io]
            flat_p = _flat([p.detach() for p in io], self._pe_io)
            new, self.io_opt = zero1_flat_update(
                self._transform, self.io_opt, flats, flat_p,
                [self._dev(j, 0) for j in range(self.n_data)], self._k0_io)
            _write_flat(io, new)

    def fit_batch_async(self, tokens, targets) -> torch.Tensor:
        """One pipelined step; returns the loss as a device tensor without
        waiting for the step."""
        tokens, targets = _tokens(tokens), _tokens(targets)
        local = tokens.shape[0] // self.n_data
        if tokens.shape[0] % self.n_data or local % self.m:
            raise ValueError(
                f"global batch {tokens.shape[0]} must split into "
                f"{self.n_data} data shards x {self.m} microbatches")
        return self._step(tokens, targets)

    def fit_batch(self, tokens, targets) -> float:
        """`fit_batch_async` and a host read of the loss."""
        return float(self.fit_batch_async(tokens, targets))

    def export_params(self) -> dict:
        """A host copy in the `init_params` layout: the stage stacks
        unstacked into the list of layer trees, as float32 numpy."""
        def host(a):
            return a.detach().float().cpu().numpy()

        def joined(tree):
            if isinstance(tree, dict):
                return {k: joined(v) for k, v in tree.items()}
            return np.concatenate([host(a) for a in tree])

        stacked = joined(self.stage_params)
        io = map_tree(host, self.io_params)
        out = {k: io[k] for k in ("embed", "pos", "ln_f")}
        out["layers"] = [map_tree(lambda a, i=i: a[i], stacked)
                         for i in range(self.cfg.n_layers)]
        if "head" in io:
            out["head"] = io["head"]
        return out


def _write_flat(params: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy a flat vector back into the parameter tensors in order."""
    off = 0
    for p in params:
        p.copy_(flat[off:off + p.numel()].view(p.shape).to(p.device))
        off += p.numel()


__all__ = ["HybridParallelTrainer", "PipelineParallelTrainer",
           "make_accum_train_step", "place_params"]
