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

Across processes (a mesh that `make_mesh` built over a process group)
every process runs the same step over its own shards: it holds float32
masters of the replicated parameters and of the slices its shards use,
the optimizer moments of its own data shards, and the exchanges of
`mesh.Program` carry activations and gradients between the shards, in
global shard order, so every process ends a step with the same loss and
the same parameters, and 2 processes of 2 shards compute what 1 process
of 4 computes, bit for bit.  `export_params` gathers the slices and
stages other processes hold.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.obs.trace import new_span_id, record_span
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
from deeplearning4j_tpu_torch.runtime.profiler import DeviceIntervals
from deeplearning4j_tpu_torch.tree import flatten_tree, map_tree, tree_leaves


def _cast_floating(tree, dtype: torch.dtype):
    """Every floating leaf cast to `dtype` (a differentiable cast: the
    gradient of the cast copy flows back to the leaf); None (a slice
    another process holds) stays None."""
    return map_tree(lambda a: a.to(dtype) if a is not None
                    and a.is_floating_point() else a, tree)


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
    for the JAX step over a sharded batch.  Over a mesh that spans
    processes each process passes the same parameters and global batch
    and runs its own shards' rows; the gradients meet across processes
    in shard order, so every process applies the same update.

    Spans (the span store of `obs.trace`): each step records
    ``train.step`` (count: `accum`) and ``train.update`` inside it (the
    gradient division, the updater's transform, `apply_updates`; tagged
    with its device interval on the card, the stream's time from the
    update's first op to its last, read lazily); the single-device path
    also records, a microbatch, ``train.forward`` (with ``train.cast``,
    the compute-dtype copy, inside it) and ``train.backward``."""
    compute_dtype = tfm.torch_dtype(cfg.dtype)
    transform = make_updater(UpdaterConfig(
        updater=updater, learning_rate=lr, clip_norm=clip_norm,
        weight_decay=weight_decay, epsilon=1e-8, lr_schedule=lr_schedule))
    intervals = DeviceIntervals()

    def cast(p32):
        return (_cast_floating(p32, compute_dtype)
                if compute_dtype != torch.float32 else p32)

    def loss_fn(p32, tok, tgt):
        return tfm.lm_loss(cfg, cast(p32), tok, tgt)

    def step(params, opt_state, tokens, targets):
        t_step = time.perf_counter_ns()
        sid = new_span_id()
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
                t_fwd = time.perf_counter_ns()
                fwd = new_span_id()
                low = cast(params)
                t_cast = time.perf_counter_ns()
                l = tfm.lm_loss(cfg, low, tok_mb[i], tgt_mb[i])
                del low
                t_bwd = time.perf_counter_ns()
                record_span("train.cast", t_fwd, t_cast, 0, fwd)
                record_span("train.forward", t_fwd, t_bwd, fwd, sid)
                l.backward()
                loss = loss + l.detach().float()
                record_span("train.backward", t_bwd,
                            time.perf_counter_ns(), 0, sid)
        t_update = time.perf_counter_ns()
        interval = intervals.start(dev)
        if mesh is None:
            grads = map_tree(lambda p: p.grad / accum if accum > 1
                             else p.grad, params)
            for p in leaves:
                p.grad = None
        updates, opt_state = transform.update(grads, opt_state, params)
        apply_updates(params, updates)
        intervals.stop(interval, dev)
        t_end = time.perf_counter_ns()
        record_span("train.update", t_update, t_end, 0, sid, (), interval)
        record_span("train.step", t_step, t_end, sid, 0, (accum,))
        return params, opt_state, loss / accum

    return step, transform.init


def _spmd_grads(mesh, loss_fn, params, tok_mb, tgt_mb):
    """(gradient tree, summed loss over the microbatches) of the data-
    parallel step: each microbatch's rows cut over the mesh's shards
    (contiguous blocks; a shard past the rows gets none and adds zeros),
    each local shard's gradient of its own mean loss, met in
    `mesh.pmean` (`mesh.psum`, row-weighted, when the rows do not split
    evenly)."""
    home = tok_mb.device
    reps = mesh_lib.replicate(mesh, params, home, grad=True)
    like = [a for a in tree_leaves(params) if a.requires_grad]
    accum = tok_mb.shape[0]
    total, loss = None, torch.zeros((), dtype=torch.float32, device=home)
    for i in range(accum):
        rows = tok_mb[i].shape[0]
        pieces = list(zip(tok_mb[i].chunk(mesh.size),
                          tgt_mb[i].chunk(mesh.size)))
        gs, ls, ws = [], [], []
        for s, p, dev in zip(mesh.local_shards(), reps,
                             mesh.local_devices()):
            if s >= len(pieces):
                gs.append([torch.zeros_like(a) for a in like])
                ls.append(torch.zeros((), device=home))
                ws.append(0.0)
                continue
            tk, tg = pieces[s]
            leaves = [a for a in tree_leaves(p) if a.requires_grad]
            l = loss_fn(p, tk.to(dev), tg.to(dev))
            gs.append(torch.autograd.grad(l, leaves))
            ls.append(l.detach().float())
            ws.append(tk.shape[0] / rows)
        if rows % mesh.size == 0:
            g = [mesh_lib.pmean([gj[k] for gj in gs], home, mesh)
                 for k in range(len(like))]
            l = mesh_lib.pmean(ls, home, mesh)
        else:
            g = [mesh_lib.psum([gj[k] * w for gj, w in zip(gs, ws)], home,
                               mesh)
                 for k in range(len(like))]
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
    """A tree placed on this process's shards of the mesh by a matching
    tree of `partition` specs: a replicated leaf as one tensor on this
    process's first device; a leaf split on dim `dim` over axis `axis`
    as the list of its slices (a shard list), slice i on the device of
    this process's first shard at coordinate i of `axis`, or None when
    no shard of this process has that coordinate.  Leaves may be tensors
    or numpy arrays."""
    local = mesh.local_shards()
    devices = mesh.flat_devices()
    first = devices[local[0]]

    def place(spec, leaf):
        t = torch.as_tensor(np.asarray(leaf) if not torch.is_tensor(leaf)
                            else leaf)
        if spec.is_replicated:
            return t.to(first)
        n = mesh.shape[spec.axis]
        if t.shape[spec.dim] % n:
            raise ValueError(f"dim {spec.dim} of a {tuple(t.shape)} leaf "
                             f"does not split over {n} '{spec.axis}' shards")
        out = []
        for i, piece in enumerate(t.chunk(n, dim=spec.dim)):
            mine = [s for s in local if mesh.coord(s, spec.axis) == i]
            out.append(piece.to(devices[mine[0]]) if mine else None)
        return out

    return map_tree(place, spec_tree, tree)


def _fresh_master(a: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return a.detach().to(torch.float32, copy=True).contiguous() \
        .requires_grad_(True)


def _present(tree) -> dict:
    """``{keypath: tensor}`` of a tree's leaves, the None ones left out."""
    return {k: v for k, v in flatten_tree(tree).items() if v is not None}


def _tokens(a) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.require(np.asarray(a), requirements=["C"]))
    return a.long()


def _share(prog: mesh_lib.Program, items, value, write) -> None:
    """Owner to holders, raw: `items` are ``(key, owner shard, holder
    processes)``, the same list on every process; ``value(key)`` on the
    owner's process, ``write(key, tensor)`` on each other holder."""
    w = prog.wiring
    reps = w._processes()
    moves = [(key, owner, r) for key, owner, holders in items for r in reps
             if w._proc[r] in holders and w._proc[r] != w._proc[owner]]
    for (key, _), t in w.transfer(moves, value).items():
        write(key, t)


class HybridParallelTrainer:
    """dp x sp x tp (+ ep) training of the TransformerLM over a mesh with
    the axes of `axes` (data, seq, model).

    Parameters: float32 masters placed by `param_specs` (`place_params`):
    each ``model`` shard holds only its slice of the split leaves, the
    replicated ones live on this process's first device; the forward
    casts them to the config's dtype inside the loss.  `params` (a numpy
    tree in `init_params` layout) starts the trainer from given weights,
    else they are drawn from a generator seeded with `seed`.

    The optimizer state mirrors the parameters; with `shard_update` (the
    default, ZeRO-1) every moment leaf also splits its first free dim
    (not the ``model`` one) whose size divides by the ``data`` degree,
    and data shard j keeps and updates only slice j of it — on the
    device of shard (j, 0, t) — with its own copy of the step count; a
    leaf with no such dim stays whole with data shard 0.  The update is
    elementwise, so the result equals ``shard_update=False`` bitwise.
    `opt_state` is that state: a list over the data shards of
    `ops.updaters` states over ``{keypath: slice}`` under ZeRO-1 (None
    for a data shard whose slices all live on other processes), one
    state over ``{keypath: master}`` otherwise.

    Over a mesh that spans processes each process keeps the masters of
    the replicated leaves and of its shards' slices (a slice another
    process holds is None in `params`) and the moments of its shards
    (j, 0, t); an updated slice goes from its owner to the other
    processes that hold it."""

    def __init__(self, cfg: tfm.TransformerConfig, mesh: mesh_lib.Mesh,
                 lr: float = 1e-2, seed: int = 0,
                 axes: tfm.MeshAxes = tfm.MeshAxes(),
                 updater: str = "sgd", shard_update: bool = True,
                 params=None):
        self.cfg = cfg
        self.mesh = mesh
        self.lr = lr
        self.axes = axes
        self.shard_update = bool(shard_update)
        self._grid = tfm._Grid(mesh, axes)
        self._grid.check(cfg)
        self._prog = mesh_lib.Program(mesh)
        home = mesh.local_devices()[0]
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
            self.opt_state = []
            for j in range(self._grid.dp):
                mine = self._data_slice(j, flat)
                self.opt_state.append(self._transform.init(
                    self._on_shard(j, mine)) if mine else None)
        else:
            self.opt_state = self._transform.init(self._flat())

    # ---- ZeRO-1 layout ------------------------------------------------------

    def _flat(self) -> dict:
        """{keypath: master tensor} of this process; a split leaf's
        slices are ``keypath//t``."""
        return _present(self.params)

    def _zero1_units(self) -> dict:
        """keypath -> (the ZeRO-1 dim or None, the ``model`` index), for
        every slice of the mesh, this process's or not."""
        specs = flatten_tree(self._pspecs)
        shapes = flatten_tree(tfm.param_shapes(self.cfg))
        dp = self._grid.dp
        units = {}
        for key, spec in specs.items():
            shape = list(shapes[key])
            if spec.is_replicated:
                parts = [(key, 0)]
            else:
                n = self.mesh.shape[spec.axis]
                shape[spec.dim] //= n
                parts = [(f"{key}//{t}", t) for t in range(n)]
            zdim = None
            if dp > 1:
                for d, size in enumerate(shape):
                    if d != spec.dim and size and size % dp == 0:
                        zdim = d
                        break
            for k, t in parts:
                units[k] = (zdim, t)
        return units

    def opt_partition(self) -> dict:
        """{keypath: the `partition` spec of its moments over ``data``}."""
        return {k: (part_lib.sharded(self.axes.data, z) if z is not None
                    else part_lib.replicated())
                for k, (z, _) in self._units.items()}

    def _owner(self, key: str, j: int) -> int:
        """The shard that updates data slice j of `key`: (j, 0, t)."""
        return self._grid.shard(j, 0, self._units[key][1])

    def _data_slice(self, j: int, flat: dict) -> dict:
        """Data shard j's slices of a {keypath: tensor} map that this
        process updates: views of the tensors (a leaf with no ZeRO-1 dim
        whole, for shard 0 only)."""
        dp = self._grid.dp
        local = set(self._prog.local)
        out = {}
        for key, a in flat.items():
            zdim, _ = self._units[key]
            if self._owner(key, j) not in local or (zdim is None and j):
                continue
            if zdim is None:
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

    def _holders(self, t: Optional[int]) -> set:
        """The processes that hold a leaf: every one for a replicated
        leaf (t None), those with a shard of ``model`` index t else."""
        w = self._prog.wiring
        return {w._proc[s] for s in self._prog.scope
                if t is None or self._grid.coords(s)[2] == t}

    def _share_update(self, pflat: dict) -> None:
        """Each updated data slice from its owner to the other processes
        that hold the leaf."""
        if not self.mesh.spans_processes:
            return
        specs = flatten_tree(self._pspecs)
        items = []
        for key, (zdim, t) in self._units.items():
            split = key not in specs
            for j in range(self._grid.dp if zdim is not None else 1):
                items.append(((key, j), self._owner(key, j),
                              self._holders(t if split else None)))

        def piece(item):
            key, j = item
            zdim = self._units[key][0]
            a = pflat[key]
            if zdim is None:
                return a
            n = a.shape[zdim] // self._grid.dp
            return a.narrow(zdim, j * n, n)

        _share(self._prog, items, piece,
               lambda item, t: piece(item).copy_(t))

    # ---- the step -------------------------------------------------------------

    def _step(self, tokens, targets) -> torch.Tensor:
        cd = tfm.torch_dtype(self.cfg.dtype)
        pc = (self.params if cd == torch.float32
              else _cast_floating(self.params, cd))
        loss = tfm.lm_loss(self.cfg, pc, tokens, targets, self.mesh,
                           self.axes)
        flat = self._flat()
        grads = torch.autograd.grad(loss, list(flat.values()))
        gflat = dict(zip(flat, grads))
        if not self.shard_update:
            updates, self.opt_state = self._transform.update(
                gflat, self.opt_state, flat)
            apply_updates(flat, updates)
            return loss.detach()
        pflat = {k: t.detach() for k, t in flat.items()}
        with torch.no_grad():
            for j in range(self._grid.dp):
                if self.opt_state[j] is None:
                    continue
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
            self._share_update(pflat)
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
        ``model`` slices joined, those of other processes gathered), as
        float32 numpy arrays, the same on every process."""
        host = map_tree(lambda a: None if a is None
                        else a.detach().float().cpu().numpy(), self.params)
        if self.mesh.spans_processes:
            # every slice from the process of its first shard (0, 0, t)
            specs, flat = flatten_tree(self._pspecs), self._flat()
            items = [(k, self._grid.shard(0, 0, t), self._holders(None))
                     for k, (_, t) in self._units.items() if k not in specs]

            def write(key, t):
                parent, i = key.rsplit("//", 1)
                node = host
                for part in parent.split("//"):
                    node = node[int(part) if isinstance(node, list)
                                else part]
                node[int(i)] = t.float().cpu().numpy()

            _share(self._prog, items, lambda k: flat[k].detach(), write)
        return part_lib.gather_tree(host, self._pspecs)


class PipelineParallelTrainer:
    """dp x pp training: the transformer blocks cut over the `stage_axis`
    of a (data, stage) mesh, GPipe microbatching within each data shard.

    `stage_params` holds the blocks stacked a stage: each leaf is the
    list over the stages of a ``[layers_per_stage, ...]`` tensor on the
    stage's device (this process's first shard of the stage; None for a
    stage only other processes hold).  `io_params` (embed, pos, ln_f,
    and head when untied) are replicated, on every process; every stage
    embeds and scores only its own microbatches, on its own copy, so
    their gradients are summed across stages in stage order (a tied
    embedding gets its lookup's and its head's).  Each data shard's loss
    is normalised by its own ``b * s``; the step's loss and gradients are
    their means over ``data``, in shard order.

    With `shard_update` (ZeRO-1, the default) the optimizer state lives
    on flat planes: each stage's parameters raveled and padded to a
    multiple of the data degree, data shard j keeping slice j on shard
    (j, s) (`stage_opt[s][j]`, None on other processes), and the io
    parameters likewise on shards (j, 0) (`io_opt[j]`); a step
    reduce-scatters each plane's gradient (`pipeline.zero1_flat_update`).
    The result equals ``shard_update=False`` bitwise.  MoE configs and a
    layer count that does not split into the stages raise ValueError."""

    def __init__(self, cfg: tfm.TransformerConfig, mesh: mesh_lib.Mesh,
                 n_microbatches: int = 4, lr: float = 1e-2, seed: int = 0,
                 data_axis: str = "data", stage_axis: str = "stage",
                 updater: str = "sgd", shard_update: bool = True,
                 params=None):
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
        self._prog = mesh_lib.Program(mesh)
        local = self._prog.local
        self._local_data = sorted({self._at(s)[0] for s in local})
        home = mesh.local_devices()[0]
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
                ls[s * lps:(s + 1) * lps]).to(self._stage_home(s)))
                if self._stage_home(s) is not None else None
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
            self._k0_stage = sum(t.numel()
                                 for t in tree_leaves(layers[0])) * lps
            self._pe_stage = part_lib.padded_extent(self._k0_stage,
                                                    self.n_data)
            self._k0_io = sum(t.numel() for t in tree_leaves(self.io_params))
            self._pe_io = part_lib.padded_extent(self._k0_io, self.n_data)
            mine = set(local)
            self.stage_opt = [
                [self._flat_state(self._pe_stage, self._dev(j, s))
                 if self._shard(j, s) in mine else None
                 for j in range(self.n_data)] for s in range(n_stages)]
            self.io_opt = [self._flat_state(self._pe_io, self._dev(j, 0))
                           if self._shard(j, 0) in mine else None
                           for j in range(self.n_data)]
        else:
            self.stage_opt = self._transform.init(
                _present(self.stage_params))
            self.io_opt = self._transform.init(self.io_params)

    def _shard(self, d: int, s: int) -> int:
        data_axis, stage_axis = self.axes
        return self.mesh.shard(**{data_axis: d, stage_axis: s})

    def _at(self, shard: int):
        """(data, stage) coordinates of a shard."""
        return (self.mesh.coord(shard, self.axes[0]),
                self.mesh.coord(shard, self.axes[1]))

    def _dev(self, d: int, s: int) -> torch.device:
        return self._prog.device(self._shard(d, s))

    def _stage_home(self, s: int) -> Optional[torch.device]:
        """This process's first device of stage s (None: it holds none)."""
        mine = [sh for sh in self._prog.local if self._at(sh)[1] == s]
        return self._prog.device(mine[0]) if mine else None

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

    def _stage_keys(self, s: int) -> List[str]:
        """The `stage_params` keypaths of `_stage_leaves(s)`."""
        flat = flatten_tree(self._stage_view(self.stage_params, s))
        return [f"{k}//{s}" for k in sorted(flat)]

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
        """Data shard d's mean loss over its ``b * s`` tokens, one SPMD
        program over the shards (d, *): each stage embeds its blocked
        share of the microbatches on its copy of the io parameters, the
        pipeline runs, and each stage scores the outputs it banked."""
        cd = tfm.torch_dtype(self.cfg.dtype)
        sp, io = self.stage_params, self.io_params
        if cd != torch.float32:
            sp, io = _cast_floating(sp, cd), _cast_floating(io, cd)
        n_st = self.n_stages
        shards = [self._shard(d, st) for st in range(n_st)]
        prog = mesh_lib.Program(self.mesh, shards)
        io_leaves = tree_leaves(io)
        copies = prog.broadcast(io_leaves, [shards] * len(io_leaves))
        b, s = tokens.shape
        m = self.m
        k = -(-m // n_st)
        mb_b = b // m
        pad = torch.zeros((k * n_st - m, mb_b, s), dtype=tokens.dtype,
                          device=tokens.device)
        tok_mb = torch.cat([tokens.reshape(m, mb_b, s), pad])
        tgt_mb = torch.cat([targets.reshape(m, mb_b, s).to(tokens.device),
                            pad])
        x_local, stage_p, iods = [None] * n_st, [None] * n_st, {}
        for st, sh in enumerate(shards):
            if sh not in prog.local:
                continue
            dev = prog.device(sh)
            it = iter([c[sh] for c in copies])
            iods[st] = map_tree(lambda _: next(it), io)
            my = tok_mb[st * k:(st + 1) * k].to(dev)
            x_local[st] = (iods[st]["embed"][my]
                           + iods[st]["pos"][:s][None, None])
            stage_p[st] = tfm._on(self._stage_view(sp, st), dev)
        ys = gpipe_apply(self._stage_fn, stage_p, x_local, self.axes[1], m,
                         program=prog, shards=shards)
        sums, owners = {}, []
        for st, sh in enumerate(shards):
            n_valid = min(max(m - st * k, 0), k)  # padding slots score 0
            if not n_valid:
                continue
            owners.append(sh)
            if st not in iods:
                continue
            iod = iods[st]
            y = tfm._layer_norm(iod["ln_f"], ys[st][:n_valid])
            logp = F.log_softmax(y @ tfm.lm_head(iod), dim=-1)
            tg = tgt_mb[st * k:st * k + n_valid].to(y.device)
            sums[sh] = -logp.gather(-1, tg[..., None]).float().sum()
        return (prog.total(sums, owners) / (b * s)).to(io_leaves[0].dtype)

    def _step(self, tokens: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
        n = self.n_data
        local = self._prog.local
        rows = tokens.shape[0] // n
        io_leaves = tree_leaves(self.io_params)
        losses, g_stage, g_io = {}, {}, {}
        for d in self._local_data:
            stages = [st for st in range(self.n_stages)
                      if self._shard(d, st) in local]
            leaves = [p for st in stages for p in self._stage_leaves(st)]
            loss_d = self._data_loss(d, tokens[d * rows:(d + 1) * rows],
                                     targets[d * rows:(d + 1) * rows])
            grads = torch.autograd.grad(loss_d, leaves + io_leaves)
            losses[d] = loss_d.detach()
            at = 0
            for st in stages:
                size = len(self._stage_leaves(st))
                g_stage[d, st] = list(grads[at:at + size])
                at += size
            g_io[d] = list(grads[at:])
        prog, data_axis = self._prog, self.axes[0]
        with torch.no_grad():
            total = prog.psum({sh: losses[self._at(sh)[0]] for sh in local},
                              data_axis)
            loss = total[local[0]] / n
            if self.shard_update:
                self._zero1_update(g_stage, g_io)
                return loss
            # the means over data, each plane flat (the additions of
            # `mesh.pmean`, element by element)
            sums = prog.psum({sh: torch.cat(
                [g.reshape(-1) for g in g_stage[self._at(sh)]])
                for sh in local}, data_axis)
            gflat = {}
            for sh in local:
                st = self._at(sh)[1]
                keys = self._stage_keys(st)
                if keys[0] not in gflat:
                    gflat.update(zip(keys, _unflat(sums[sh] / n, [
                        p.shape for p in self._stage_leaves(st)])))
            pflat = _present(self.stage_params)
            up, self.stage_opt = self._transform.update(
                gflat, self.stage_opt, pflat)
            apply_updates(pflat, up)
            io_sum = prog.psum({sh: torch.cat(
                [g.reshape(-1) for g in g_io[self._at(sh)[0]]])
                for sh in local}, data_axis)[local[0]]
            up, self.io_opt = self._transform.update(
                _like(self.io_params, _unflat(io_sum / n, [
                    p.shape for p in io_leaves])),
                self.io_opt, self.io_params)
            apply_updates(self.io_params, up)
        return loss

    def _zero1_update(self, g_stage: dict, g_io: dict) -> None:
        """The flat ZeRO-1 rounds: every stage plane over (stage, data)
        at once, then the io plane over the shards (*, 0); the new io
        parameters go from shard (0, 0) to every process."""
        prog, data_axis = self._prog, self.axes[0]
        local = prog.local
        opt = {sh: self.stage_opt[self._at(sh)[1]][self._at(sh)[0]]
               for sh in local}
        new, opt = zero1_flat_update(
            self._transform, opt,
            {sh: _flat(g_stage[self._at(sh)], self._pe_stage)
             for sh in local},
            {sh: _flat([p.detach() for p in
                        self._stage_leaves(self._at(sh)[1])],
                       self._pe_stage) for sh in local},
            prog, data_axis, self._k0_stage)
        written = set()
        for sh in local:
            d, st = self._at(sh)
            self.stage_opt[st][d] = opt[sh]
            if st not in written:
                written.add(st)
                _write_flat(self._stage_leaves(st), new[sh])
        io = tree_leaves(self.io_params)
        io_prog = mesh_lib.Program(self.mesh, [self._shard(j, 0)
                                               for j in range(self.n_data)])
        mine = {}
        if io_prog.local:
            opt = {sh: self.io_opt[self._at(sh)[0]] for sh in io_prog.local}
            flat_p = _flat([p.detach() for p in io], self._pe_io)
            new, opt = zero1_flat_update(
                self._transform, opt,
                {sh: _flat(g_io[self._at(sh)[0]], self._pe_io)
                 for sh in io_prog.local},
                {sh: flat_p for sh in io_prog.local}, io_prog, data_axis,
                self._k0_io)
            for sh, st in opt.items():
                self.io_opt[self._at(sh)[0]] = st
            mine = {0: new[0]} if 0 in new else {}
        _write_flat(io, prog.gather(mine, [0])[0])

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
        (those of other processes gathered) unstacked into the list of
        layer trees, as float32 numpy, the same on every process."""
        def host(a):
            return a.detach().float().cpu().numpy()

        layer = tfm.param_shapes(self.cfg)["layers"][0]
        shapes = flatten_tree(layer)
        keys = sorted(shapes)
        owners = [self._shard(0, s) for s in range(self.n_stages)]
        mine = {sh: torch.cat([p.detach().reshape(-1) for p in
                               self._stage_leaves(self._at(sh)[1])])
                for sh in owners if sh in self._prog.local}
        flats = self._prog.gather(mine, owners)
        lps = self.layers_per_stage
        stacked = {k: [] for k in keys}
        for flat in flats:
            for key, t in zip(keys, _unflat(
                    flat, [(lps, *shapes[k]) for k in keys])):
                stacked[key].append(host(t))
        joined = {k: np.concatenate(v) for k, v in stacked.items()}
        io = map_tree(host, self.io_params)
        out = {k: io[k] for k in ("embed", "pos", "ln_f")}
        out["layers"] = [_like(layer, [joined[k][i] for k in shapes])
                         for i in range(self.cfg.n_layers)]
        if "head" in io:
            out["head"] = io["head"]
        return out


def _unflat(flat: torch.Tensor, shapes) -> list:
    """A flat vector cut into tensors of `shapes`, in order."""
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(flat[off:off + n].view(tuple(shape)))
        off += n
    return out


def _like(tree, values):
    """`tree`'s structure (dicts and lists) with its leaves replaced by
    `values`, in tree order."""
    it = iter(values)
    return map_tree(lambda _: next(it), tree)


def _write_flat(params: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy a flat vector back into the parameter tensors in order."""
    off = 0
    for p in params:
        p.copy_(flat[off:off + p.numel()].view(p.shape).to(p.device))
        off += p.numel()


__all__ = ["HybridParallelTrainer", "PipelineParallelTrainer",
           "make_accum_train_step", "place_params"]
