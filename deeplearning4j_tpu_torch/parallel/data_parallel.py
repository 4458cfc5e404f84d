"""Synchronous data-parallel training over a device mesh (counterpart of
`deeplearning4j_tpu.parallel.data_parallel`).

Parity target: the reference's "iterative reduce" parameter averaging
(Spark `SparkDl4jMultiLayer.runIteration():182-202`, the Akka
IterativeReduce router, the YARN master).  Averaging parameters every
iteration from a common start is synchronous SGD with gradient
averaging, which is what a step here does: the global batch is cut over
the mesh's data axis, each shard runs the forward and backward of its
slice on its device, and the gradients meet in the mesh collectives
(`parallel/mesh.py`).

The JAX package compiles one `shard_map` program a step; the port runs
the shards in a Python loop under one controller, with the same update
planes:

- **ZeRO-1, the default** (``shard_update=True``; Xu et al., "Automatic
  Cross-Replica Sharding of Weight Update in Data-Parallel Training",
  arXiv:2004.13336): the flat gradient — the parameters raveled layer by
  layer, keys sorted, padded to ``k = ceil(k0 / N) * N`` — is
  reduce-scattered, each shard updates its ``k / N`` slice of the
  parameters and of the optimizer state (which lives on that shard's
  device between steps), and the slices are gathered back.  The
  collectives add in shard order, so in float32 this equals the
  replicated update bitwise for every elementwise updater.
- **replicated** (``shard_update=False``): the mean gradient on the
  network's device, and the network's own updater.
- **local SGD** (``sync_every > 1``, the reference's Hogwild router):
  each replica holds its own parameters, layer state and optimizer state
  and steps on its own slice; every `sync_every` steps the parameters
  (by the flat reduce-scatter under ``shard_update``) and the floating
  state are averaged, and the replicas restart equal.

Per-shard randomness: shard ``i`` of iteration ``t`` draws from a
generator seeded from (conf seed, t, i) on its device, in the per-batch
and in the chunk path alike.  Floating layer state is averaged over the
shards after a step; integer state is shard 0's.  Under a loss-scaled
policy each shard scales its loss before its backward, the reduced
gradient is unscaled, and one finiteness verdict over every shard
(`shard_update_finite` on the ZeRO-1 plane) decides for all of them, by
`torch.where` with no host read.

Shards on the network's device use the network's parameters; shards on
another device get a copy for the step (the all-gather of the JAX
plane).  A mesh that lists one card four times therefore holds one copy
of the parameters and four slices of the ZeRO-1 moments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.updaters import (
    apply_updates,
    global_grad_norm,
    make_updater,
)
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
from deeplearning4j_tpu_torch.parallel import partition as part_lib
from deeplearning4j_tpu_torch.precision import (
    grads_finite,
    init_scaler_state,
    shard_update_finite,
    unscale_grads,
    update_scaler_state,
    where_tree,
)
from deeplearning4j_tpu_torch.tree import map_tree, tree_leaves

Tree = Any

_LOCAL_SCALED = ("a loss-scaled precision policy (e.g. 'mixed') requires a "
                 "synchronous DP path (sync_every == 1); local-SGD replicas "
                 "would need per-replica scaler automatons")


def _as_tensor(a, device):
    # imported here: the network's module imports the kernels, whose
    # package imports this module
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        _as_tensor as as_tensor,
    )

    return as_tensor(a, device)


def _flat(leaves: List[torch.Tensor], k: int) -> torch.Tensor:
    """The leaves raveled and concatenated, zero-padded to length `k`."""
    flat = torch.cat([t.reshape(-1) for t in leaves])
    if k > flat.shape[0]:
        flat = torch.cat([flat, flat.new_zeros(k - flat.shape[0])])
    return flat


def _layer_leaves(tree) -> List[torch.Tensor]:
    """A per-layer tree's leaves in the flat order: layer by layer, keys
    sorted (uppercase first), as `ravel_pytree` orders them."""
    return [layer[k] for layer in tree for k in sorted(layer)]


class DataParallelTrainer:
    """Wraps a `MultiLayerNetwork` with a data-parallel train step over
    the mesh's `axis` (by default every visible card)."""

    def __init__(self, net, mesh=None, axis: str = "data",
                 sync_every: int = 1, shard_update: bool = True):
        self.net = net
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        self.axis = axis
        self.sync_every = int(sync_every)
        self.shard_update = bool(shard_update)
        self.n_devices = self.mesh.size
        if self.mesh.shape.get(axis) != self.n_devices:
            raise ValueError(
                f"DataParallelTrainer shards over one axis: mesh "
                f"{self.mesh.shape} has other axes than {axis!r}")
        self._devices = self.mesh.flat_devices()
        if net.params is None:
            net.init()
        self._updater = make_updater(net.conf.conf.updater_config())
        if net.precision.loss_scale is not None and self.sync_every != 1:
            raise ValueError(_LOCAL_SCALED)
        self._built_policy = net.precision
        self._rep = None  # local SGD: per-replica [params, state, upd]
        self._opt_shard = None  # ZeRO-1: per-shard flat optimizer state
        self._iteration = 0
        self._build_layout()
        if self.shard_update and self.sync_every == 1:
            self._opt_shard = self._init_sharded_opt_state()

    # ---- layout -----------------------------------------------------------

    def _build_layout(self) -> None:
        """The flat layout, fixed between steps: the padded flat length
        `_flat_k` (the JAX attribute) and each shard's slice `_ksh`, the
        sharded updater core, and each shard's slice of the lr
        multipliers and of unit_norm's segment ids on its device (None
        when unused).  Built at construction and again where the layout
        can change (`_check_policy`, `restore_train_state`)."""
        n = self.n_devices
        self._flat_k = part_lib.padded_extent(self.net.num_params(), n)
        self._ksh = ksh = self._flat_k // n

        def per_shard(vec):
            return None if vec is None else [
                vec[j * ksh:(j + 1) * ksh].to(dev)
                for j, dev in enumerate(self._devices)]

        self._core = self._sharded_updater()
        self._mult_sh = per_shard(self._lr_mult_flat())
        self._ids_sh, self._n_leaves = None, 0
        if self.net.conf.conf.updater_config().unit_norm:
            ids, self._n_leaves = self._leaf_ids()
            self._ids_sh = per_shard(ids)

    def _unflat_into(self, flat: torch.Tensor, like) -> list:
        """A per-layer tree shaped like `like` of views into the first k0
        elements of `flat` (the flat order)."""
        views, off = [], 0
        for t in _layer_leaves(like):
            views.append(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        return self._unflat_list(views, like)

    def _opt_leaf_partition(self, leaf, ksh: int) -> part_lib.PartitionSpec:
        """One shard-state leaf's global placement: the flat moments shard
        on dim 0 (padded length k), scalar leaves (the step) replicate."""
        if leaf.dim() == 1 and leaf.shape[0] == ksh:
            return part_lib.zero1(self.axis, size=self._flat_k)
        return part_lib.replicated()

    def _shard_rng(self, iteration: int, shard: int,
                   device: torch.device) -> torch.Generator:
        """Shard `shard`'s generator of `iteration`, on its device."""
        seed = self.net.conf.conf.seed
        gen = torch.Generator(device=device)
        gen.manual_seed(((seed * 1_000_003 + iteration) * 1_000_003
                         + shard + 1) % (1 << 63))
        return gen

    def _replicas(self, tree, grad: bool = False) -> list:
        """`tree` (on the network's device) for every shard."""
        return mesh_lib.replicate(self.mesh, tree, self.net.device, grad)

    # ---- precision --------------------------------------------------------

    def _check_policy(self) -> None:
        """Rebuild the trainer-held state when the network's precision
        policy changed since construction (`net.set_precision`,
        ``fit(precision=...)``); same restrictions as the constructor."""
        net = self.net
        if net.precision == self._built_policy:
            return
        if net.precision.loss_scale is not None and self.sync_every != 1:
            raise ValueError(_LOCAL_SCALED)
        self._built_policy = net.precision
        self._build_layout()
        if self._rep is not None:
            # fold outstanding drift into the net (the in-place publish
            # keeps the new param dtype), then fresh moments for it
            self._average_params()
            self._rep = None
            if net.updater_state is not None:
                net.updater_state = self._updater.init(net.params)
        if self.shard_update and self.sync_every == 1:
            # publish the live flat moments in the old layout first; the
            # rebuilt flat state adopts them in the new dtype
            self.sync_updater_state_to_net()
            self._opt_shard = self._init_sharded_opt_state()

    def _scaler(self):
        """The loss-scale config and the network's scaler state (made on
        its device on first use), or (None, None)."""
        net = self.net
        scfg = net.precision.loss_scale
        if scfg is None:
            return None, None
        if net._scaler_state is None:
            net._scaler_state = init_scaler_state(scfg, net.device)
        return scfg, net._scaler_state

    # ---- the per-shard forward and backward --------------------------------

    def _shard_grads(self, params_list, state_list, xs, ys, ms, ws,
                     iteration: int, scale):
        """Every shard's (loss piece, normalizer piece, gradient leaves,
        new layer state).  ``ws is None``: the mean objective (normalizer
        1); else the example-weighted sums of the chunk step.  `scale`
        (a loss scale or None) multiplies what is differentiated."""
        net = self.net
        out = []
        for i, dev in enumerate(self._devices):
            p, st = params_list[i], state_list[i]
            rng = self._shard_rng(iteration, i, dev)
            m = None if ms is None else ms[i]
            if ws is None:
                num, st_new = net._objective(p, st, xs[i], ys[i], rng, m)
                den = None
            else:
                num, den, st_new = net._weighted_loss_sums(
                    p, st, xs[i], ys[i], rng, m, ws[i])
            target = num if scale is None else num * scale.to(
                device=dev, dtype=num.dtype)
            leaves = _layer_leaves(p)
            got = torch.autograd.grad(target, leaves, allow_unused=True)
            grads = [torch.zeros_like(q) if g is None else g
                     for q, g in zip(leaves, got)]
            out.append((num.detach(), den, grads, st_new))
        return out

    def _mean_state(self, states: list, home: torch.device):
        """Floating layer state averaged over the shards; integer state
        taken from shard 0."""
        def avg(*leaves):
            if leaves[0].is_floating_point():
                return mesh_lib.pmean([a.detach() for a in leaves], home)
            return leaves[0].detach().to(home)
        return map_tree(avg, *states)

    # ---- the synchronous step ----------------------------------------------

    def _sync_step(self, x, y, mask, weights, iteration: int):
        """One synchronous optimizer step over the global batch (cut over
        the shards); returns (loss, gradient norm) on the network's
        device."""
        net = self.net
        home = net.device
        scfg, sc = self._scaler()
        scale = None if scfg is None else sc["scale"]
        xs = mesh_lib.shard_batch(self.mesh, x, self.axis)
        ys = mesh_lib.shard_batch(self.mesh, y, self.axis)
        ms = mesh_lib.shard_batch(self.mesh, mask, self.axis)
        ws = mesh_lib.shard_batch(self.mesh, weights, self.axis)
        pieces = self._shard_grads(self._replicas(net.params, grad=True),
                                   self._replicas(net.state), xs, ys, ms,
                                   ws, iteration, scale)
        nums = [pc[0] for pc in pieces]
        new_state = self._mean_state([pc[3] for pc in pieces], home)
        if weights is None:
            loss, denom = mesh_lib.pmean(nums, home), None
        else:
            denom = torch.clamp(mesh_lib.psum([pc[1] for pc in pieces],
                                              home), min=1.0)
            loss = mesh_lib.psum(nums, home) / denom
        reg_grads = None
        if weights is not None and net._has_reg():
            # the replicated term, added once after the reduction
            leaves = _layer_leaves(net.params)
            reg = net._reg_loss(net.params)
            reg_grads = [torch.zeros_like(q) if g is None else g
                         for q, g in zip(leaves, torch.autograd.grad(
                             reg, leaves, allow_unused=True))]
            loss = loss + reg.detach()
        grad_shards = [pc[2] for pc in pieces]
        if self.shard_update:
            gnorm = self._sharded_update(grad_shards, denom, reg_grads,
                                         loss, scfg, sc, new_state)
        else:
            gnorm = self._replicated_update(grad_shards, denom, reg_grads,
                                            loss, scfg, sc, new_state)
        return loss, gnorm

    def _replicated_update(self, grad_shards, denom, reg_grads, loss, scfg,
                           sc, new_state):
        """The mean gradient on the network's device, then the network's
        own updater on the whole tree."""
        net = self.net
        home = net.device
        n_leaves = len(grad_shards[0])
        if denom is None:
            flat = [mesh_lib.pmean([g[j] for g in grad_shards], home)
                    for j in range(n_leaves)]
        else:
            flat = [mesh_lib.psum([g[j] for g in grad_shards], home) / denom
                    for j in range(n_leaves)]
        if scfg is not None:
            flat = [unscale_grads(g, sc["scale"]) for g in flat]
        if reg_grads is not None:
            flat = [g + r for g, r in zip(flat, reg_grads)]
        grads = self._unflat_list(flat, net.params)
        if net.updater_state is None:
            net.updater_state = self._updater.init(net.params)
        if scfg is None:
            gnorm = net._apply_grads(grads)
            net.state = new_state
            return gnorm
        net._ensure_scaler()
        finite = torch.logical_and(grads_finite(grads), torch.isfinite(loss))
        with torch.no_grad():
            old_params = [p.detach().clone() for p in tree_leaves(net.params)]
            old_upd = map_tree(torch.clone, net.updater_state)
        gnorm = net._apply_grads(grads)
        with torch.no_grad():
            for p, old in zip(tree_leaves(net.params), old_params):
                p.copy_(torch.where(finite, p, old))
        net.updater_state = where_tree(finite, net.updater_state, old_upd)
        net.state = where_tree(finite, new_state, net.state)
        net._scaler_state = update_scaler_state(scfg, sc, finite)
        return gnorm

    @staticmethod
    def _unflat_list(flat_leaves, like) -> list:
        """Leaves in the flat order (layer by layer, keys sorted) as a
        per-layer tree shaped like `like`."""
        out, it = [], iter(flat_leaves)
        for layer in like:
            d = {k: next(it) for k in sorted(layer)}
            out.append({k: d[k] for k in layer})
        return out

    # ---- ZeRO-1 ---------------------------------------------------------------

    def _sharded_updater(self):
        """The updater core for a flat slice: the pre-apply transforms
        (l1 / l2 / clip_value / clip_norm / unit_norm) are stripped and
        re-applied by `_shard_pre_apply`, whose norms span every shard;
        decoupled weight decay stays (it is elementwise)."""
        ucfg = self.net.conf.conf.updater_config()
        return make_updater(dataclasses.replace(
            ucfg, l1=0.0, l2=0.0, clip_value=None, clip_norm=None,
            unit_norm=False))

    def _leaf_ids(self):
        """unit_norm's segment ids over the padded flat vector: leaf i's
        elements carry i, the padding lanes a segment of their own."""
        leaves = _layer_leaves(self.net.params)
        ids = np.concatenate([np.full(t.numel(), i, np.int64)
                              for i, t in enumerate(leaves)])
        ids = np.pad(ids, (0, self._flat_k - ids.shape[0]),
                     constant_values=len(leaves))
        return torch.from_numpy(ids), len(leaves)

    def _shard_pre_apply(self, g_shards, p_shards):
        """The pre-apply transforms over the flat slices in the updater's
        order (l2 → l1 → clip_value → clip_norm → unit_norm):
        elementwise ones slice by slice, the global norm from the slices'
        partial sums of squares, unit_norm's per-leaf norms from segment
        sums of every slice."""
        ucfg = self.net.conf.conf.updater_config()
        if not (ucfg.l1 or ucfg.l2 or ucfg.clip_value is not None
                or ucfg.clip_norm is not None or ucfg.unit_norm):
            return g_shards
        gs = list(g_shards)
        if ucfg.l2:
            gs = [g + ucfg.l2 * p for g, p in zip(gs, p_shards)]
        if ucfg.l1:
            gs = [g + ucfg.l1 * torch.sign(p) for g, p in zip(gs, p_shards)]
        if ucfg.clip_value is not None:
            gs = [torch.clamp(g, -ucfg.clip_value, ucfg.clip_value)
                  for g in gs]
        home = self.net.device
        if ucfg.clip_norm is not None:
            gnorm = torch.sqrt(mesh_lib.psum(
                [torch.sum(torch.square(g)) for g in gs], home))
            factor = torch.clamp(ucfg.clip_norm / (gnorm + 1e-12), max=1.0)
            gs = [g * factor.to(device=g.device, dtype=g.dtype) for g in gs]
        if ucfg.unit_norm:
            parts = [torch.zeros(self._n_leaves + 1, dtype=g.dtype,
                                 device=g.device).index_add_(
                0, ids, torch.square(g))
                for g, ids in zip(gs, self._ids_sh)]
            norms = torch.sqrt(mesh_lib.psum(parts, home))
            gs = [g / (norms.to(g.device)[ids] + 1e-12)
                  for g, ids in zip(gs, self._ids_sh)]
        return gs

    def _lr_mult_flat(self) -> Optional[torch.Tensor]:
        """Per-layer lr multipliers as one flat vector aligned with the
        flat parameters (padding lanes 1.0); None when all are 1.0."""
        layers = self.net.conf.layers
        if all(lc.lr_multiplier == 1.0 for lc in layers):
            return None
        segs = [np.full(sum(t.numel() for t in sub.values()),
                        lc.lr_multiplier, np.float32)
                for lc, sub in zip(layers, self.net.params)]
        vec = np.concatenate([s for s in segs if s.size]
                             or [np.zeros(0, np.float32)])
        return torch.from_numpy(np.pad(vec, (0, self._flat_k - vec.shape[0]),
                                       constant_values=1.0))

    def _init_sharded_opt_state(self) -> list:
        """The optimizer state over the padded flat parameters, one slice
        a shard on the shard's device.  A per-layer state in
        ``net.updater_state`` (what `finalize` publishes and checkpoints
        save, whatever shard count wrote it) is adopted: each moment tree
        raveled into the flat layout, so a resume keeps its moments on
        any mesh size."""
        net = self.net
        k, ksh = self._flat_k, self._ksh
        flat_p = _flat([t.detach() for t in _layer_leaves(net.params)], k)
        existing = net.updater_state
        fresh = self._updater.init(net.params)
        adopt = (existing is not None and set(existing) == set(fresh)
                 and all(len(tree_leaves(existing[s]))
                         == len(tree_leaves(fresh[s]))
                         for s in fresh if s != "step"))
        scaled = net.precision.loss_scale is not None
        shards = []
        for j, dev in enumerate(self._devices):
            sl = slice(j * ksh, (j + 1) * ksh)
            st = self._core.init({"p": flat_p[sl].to(dev)})
            if adopt:
                for slot in st:
                    if slot == "step":
                        st["step"] = existing["step"].detach().clone().cpu()
                        continue
                    vec = _flat([t.detach() for t in
                                 _layer_leaves(existing[slot])], k)
                    st[slot]["p"].copy_(vec[sl])
            if scaled:
                # a skipped step keeps the old count by torch.where
                st["step"] = st["step"].to(dev)
            shards.append(st)
        return shards

    def _sharded_update(self, grad_shards, denom, reg_grads, loss, scfg,
                        sc, new_state):
        """The ZeRO-1 plane: reduce-scatter the flat gradients, each shard
        updates its slice of the parameters and its optimizer state, and
        the slices are gathered back into the network's parameters."""
        net = self.net
        home = net.device
        k, ksh = self._flat_k, self._ksh
        n = self.n_devices
        flats = [_flat(g, k) for g in grad_shards]
        g_sh = mesh_lib.psum_scatter(flats, self._devices)
        g_sh = [g / (n if denom is None else denom.to(g.device))
                for g in g_sh]
        if scfg is not None:
            g_sh = [unscale_grads(g, sc["scale"].to(g.device)) for g in g_sh]
        if reg_grads is not None:
            r = _flat(reg_grads, k)
            g_sh = [g + r[j * ksh:(j + 1) * ksh].to(g.device)
                    for j, g in enumerate(g_sh)]
        finite = None
        if scfg is not None:
            finite = shard_update_finite(g_sh, loss)
        gnorm = torch.sqrt(mesh_lib.psum(
            [torch.sum(torch.square(g.float())) for g in g_sh], home))
        flat_p = _flat([t.detach() for t in _layer_leaves(net.params)], k)
        p_sh = [flat_p[j * ksh:(j + 1) * ksh].to(dev)
                for j, dev in enumerate(self._devices)]
        g2 = self._shard_pre_apply(g_sh, p_sh)
        new_sh = []
        for j, dev in enumerate(self._devices):
            st = self._opt_shard[j]
            old_st = (None if finite is None
                      else map_tree(torch.clone, st))
            updates, st = self._core.update({"p": g2[j]}, st,
                                            {"p": p_sh[j]})
            u = updates["p"]
            if self._mult_sh is not None:
                u = u * self._mult_sh[j].to(dtype=u.dtype)
            if net._lr_scale != 1.0:
                u = u * net._lr_scale
            new = apply_updates({"p": p_sh[j].clone()}, {"p": u})["p"]
            if finite is not None:
                f = finite.to(dev)
                new = torch.where(f, new, p_sh[j])
                st = where_tree(f, st, old_st)
            self._opt_shard[j] = st
            new_sh.append(new)
        if finite is not None:
            net.state = where_tree(finite, new_state, net.state)
            net._scaler_state = update_scaler_state(scfg, sc, finite)
        else:
            net.state = new_state
        full = mesh_lib.all_gather(new_sh, home)
        with torch.no_grad():
            off = 0
            for t in _layer_leaves(net.params):
                t.copy_(full[off:off + t.numel()].view(t.shape))
                off += t.numel()
        # the trainer owns the moments while this plane runs: save paths
        # pull them through `published_updater_state`
        net.updater_state = None
        net._updater_state_owner = self
        return gnorm

    def sync_updater_state_to_net(self) -> None:
        """Publish the sharded optimizer state to ``net.updater_state`` in
        the network's per-layer form (independent of the shard count) —
        what checkpoints save.  Called by `finalize`; cheap enough for
        any checkpoint boundary."""
        if not self.shard_update or self._opt_shard is None:
            return
        net = self.net
        home = net.device
        first = self._opt_shard[0]
        out = {}
        for slot, node in first.items():
            if slot == "step":
                out["step"] = node.detach().clone()
                continue
            full = mesh_lib.all_gather([s[slot]["p"] for s in
                                        self._opt_shard], home)
            out[slot] = map_tree(torch.clone,
                                 self._unflat_into(full, net.params))
        net.updater_state = out

    # ---- local SGD --------------------------------------------------------

    def _stack(self) -> list:
        """One independent copy a replica of the network's parameters,
        layer state and optimizer state, on the replica's device."""
        net = self.net
        upd = (net.updater_state if net.updater_state is not None
               else self._updater.init(net.params))

        def copy(tree, dev, grad=False):
            return map_tree(lambda t: t.detach().to(dev).clone()
                            .requires_grad_(grad and t.is_floating_point()),
                            tree)

        return [[copy(net.params, dev, True), copy(net.state, dev),
                 map_tree(lambda t: t.detach().clone()
                          if t.device.type == "cpu" and t.dim() == 0
                          else t.detach().to(dev).clone(), upd)]
                for dev in self._devices]

    def _local_step(self, x, y, mask, iteration: int):
        """Each replica steps on its own slice with its own updater state;
        no collective but the logged mean loss and gradient norm."""
        net = self.net
        if self._rep is None:
            self._rep = self._stack()
        xs = mesh_lib.shard_batch(self.mesh, x, self.axis)
        ys = mesh_lib.shard_batch(self.mesh, y, self.axis)
        ms = mesh_lib.shard_batch(self.mesh, mask, self.axis)
        pieces = self._shard_grads([r[0] for r in self._rep],
                                   [r[1] for r in self._rep], xs, ys, ms,
                                   None, iteration, None)
        gnorms = []
        for rep, (_, _, flat, st_new) in zip(self._rep, pieces):
            params = rep[0]
            grads = self._unflat_list(flat, params)
            gnorms.append(global_grad_norm(grads))
            updates, rep[2] = self._updater.update(grads, rep[2], params)
            updates = net._apply_lr_multipliers(updates)
            if net._lr_scale != 1.0:
                updates = map_tree(lambda u: u * net._lr_scale, updates)
            apply_updates(params, updates)
            rep[1] = map_tree(lambda t: t.detach(), st_new)
        home = net.device
        return (mesh_lib.pmean([pc[0] for pc in pieces], home),
                mesh_lib.pmean(gnorms, home))

    def _averaged_rep(self) -> list:
        """The replica average of the per-replica state (floating leaves;
        integer ones stay per replica), not written into ``_rep``.  Under
        ``shard_update`` the parameter average is the sharded sync round:
        the flat parameters reduce-scattered and gathered, element for
        element the same additions as the leafwise mean."""
        home = self.net.device
        n = self.n_devices

        def avg_tree(trees):
            means = map_tree(
                lambda *leaves: mesh_lib.pmean([a.detach() for a in leaves],
                                               home)
                if leaves[0].is_floating_point() else None, *trees)
            return [map_tree(lambda t, m: t.detach().clone() if m is None
                             else m.to(t.device).clone(), tree, means)
                    for tree in trees]

        params = [r[0] for r in self._rep]
        if self.shard_update:
            flats = [_flat([t.detach() for t in _layer_leaves(p)],
                           self._flat_k)
                     for p in params]
            sh = [s / n for s in mesh_lib.psum_scatter(flats,
                                                       self._devices)]
            full = mesh_lib.all_gather(sh, home)
            avg_p = [map_tree(lambda t: t.to(dev).clone(),
                              self._unflat_into(full, self.net.params))
                     for dev in self._devices]
        else:
            avg_p = avg_tree(params)
        avg_s = avg_tree([r[1] for r in self._rep])
        avg_u = avg_tree([r[2] for r in self._rep])
        return [[map_tree(lambda t: t.requires_grad_(t.is_floating_point()),
                          p), s, u]
                for p, s, u in zip(avg_p, avg_s, avg_u)]

    def _publish_rep(self, rep) -> None:
        """Replica 0's slot of an averaged state written into the network
        (in place for the parameters, which keep their dtype)."""
        net = self.net
        p, s, u = rep[0]
        with torch.no_grad():
            for dst, src in zip(_layer_leaves(net.params),
                                _layer_leaves(p)):
                dst.copy_(src)
        net.state = map_tree(lambda t: t.detach().to(net.device).clone(), s)
        net.updater_state = map_tree(
            lambda t, ref: t.detach().to(ref.device).clone(), u,
            self._updater.init(net.params))

    def _average_params(self) -> None:
        """The sync round of local SGD: the replicas restart equal."""
        if self._rep is None:
            return
        self._rep = self._averaged_rep()
        self._publish_rep(self._rep)

    # ---- public API -------------------------------------------------------

    def fit_batch_async(self, x, y, mask=None) -> torch.Tensor:
        """One data-parallel step over the global batch (dim 0 divisible
        by the shard count); returns the loss as a device tensor without
        synchronizing.  Local SGD averages every `sync_every` steps
        (``net.params`` holds the average at those points).  Listeners
        force a host read only on the iterations they are due."""
        net = self.net
        self._check_policy()
        dev = net.device
        x, y, mask = (_as_tensor(a, dev) for a in (x, y, mask))
        if x.shape[0] % self.n_devices:
            raise ValueError(f"Global batch {x.shape[0]} not divisible by "
                             f"{self.n_devices} devices")
        if self.sync_every != 1:
            loss, net.last_grad_norm = self._local_step(x, y, mask,
                                                        self._iteration)
        else:
            loss, net.last_grad_norm = self._sync_step(x, y, mask, None,
                                                       self._iteration)
        self._iteration += 1
        if self.sync_every > 1 and self._iteration % self.sync_every == 0:
            self._average_params()
        due = net._due_listeners(self._iteration)
        if due:
            loss_f = float(loss)
            for listener in due:
                listener(self._iteration, loss_f)
        return loss

    def fit_batch(self, x, y, mask=None) -> float:
        """`fit_batch_async` and a host read of the loss."""
        return float(self.fit_batch_async(x, y, mask))

    def fit_chunk_async(self, xs, ys, masks=None, weights=None,
                        unroll: int = 1):
        """K = ``xs.shape[0]`` synchronous steps over stacked ``[K, B,
        ...]`` batches (the fused driver's primitive; the ZeRO-1 plane
        keeps its slices across them).  Each step is the example-weighted
        step with the per-iteration shard generators, so any chunking of
        a stream trains the same.  Local SGD is refused.  Returns
        (losses, grad_norms) as ``[K]`` device tensors; `unroll` is
        accepted for the JAX signature."""
        if self.sync_every != 1:
            raise NotImplementedError(
                "fit_chunk_async supports synchronous DP paths "
                "(sync_every == 1); use per-batch fit_batch_async for "
                "local-SGD")
        net = self.net
        self._check_policy()
        dev = net.device
        xs, ys, masks = (_as_tensor(a, dev) for a in (xs, ys, masks))
        k = int(xs.shape[0])
        if int(xs.shape[1]) % self.n_devices:
            raise ValueError(f"Global batch {int(xs.shape[1])} not "
                             f"divisible by {self.n_devices} devices")
        weights = (torch.ones(xs.shape[:2], device=dev) if weights is None
                   else _as_tensor(weights, dev).float())
        it0 = self._iteration
        losses, gnorms = [], []
        for i in range(k):
            loss, gnorm = self._sync_step(
                xs[i], ys[i], None if masks is None else masks[i],
                weights[i], self._iteration)
            self._iteration += 1
            losses.append(loss)
            gnorms.append(gnorm)
        losses, gnorms = torch.stack(losses), torch.stack(gnorms)
        net.last_grad_norm = gnorms[-1]
        net._fire_chunk_listeners(it0, k, losses)
        return losses, gnorms

    def stage_chunk(self, chunk):
        """The fused driver's prefetch hook: the chunk's arrays on the
        network's device (the step cuts them over the shards)."""
        put = lambda a: _as_tensor(a, self.net.device)  # noqa: E731
        return chunk._replace(xs=put(chunk.xs), ys=put(chunk.ys),
                              weights=put(chunk.weights),
                              masks=put(chunk.masks))

    def fit(self, data, epochs: int = 1, chunk_size: Optional[int] = None,
            prefetch: int = 2, chunk_unroll: int = 1
            ) -> "DataParallelTrainer":
        """Train for `epochs` passes; `chunk_size` routes the loop through
        the fused driver (`runtime/fused.py`), whose padding with zero
        example weights lets ragged tails train that the per-batch path
        refuses.  Synchronous modes only take chunks; local SGD runs the
        per-batch loop.  Publishes the trainer-held state at the end."""
        from deeplearning4j_tpu_torch.models.multi_layer_network import (
            _as_batches,
            _maybe_reset,
        )

        if chunk_size is not None and self.sync_every == 1:
            from deeplearning4j_tpu_torch.runtime.fused import (
                FusedTrainingDriver,
            )

            FusedTrainingDriver(self, chunk_size=chunk_size,
                                prefetch=prefetch,
                                unroll=chunk_unroll).fit(data, epochs=epochs)
            self.finalize()
            return self
        for _ in range(epochs):
            for x, y, mask in _as_batches(data):
                self.fit_batch(x, y, mask)
            _maybe_reset(data)
        self.finalize()
        return self

    def train_state_partition(self) -> dict:
        """Where this trainer's training state lives across the replica
        axis, in the `parallel.partition` vocabulary: the published trees
        (what checkpoints see) are replicated in every mode; under ZeRO-1
        the live flat moments are reported under ``live_updater``."""
        rep = part_lib.replicated()
        out = {"params": rep, "updater": rep,
               "replicas": self.n_devices, "axis": self.axis}
        if self.shard_update and self._opt_shard is not None:
            out["live_updater"] = map_tree(
                lambda a: self._opt_leaf_partition(a, self._ksh),
                self._opt_shard[0])
        return out

    def checkpoint_partition(self) -> dict:
        """What the resilience supervisor passes to `save_checkpoint`: the
        published trees' partition spec and the shard count (one shard
        file a replica)."""
        spec = self.train_state_partition()
        return {"shards": self.n_devices,
                "spec": {"params": spec["params"],
                         "updater": spec["updater"]}}

    def resume(self, directory) -> "int | None":
        """Restore the newest good checkpoint under `directory` into this
        trainer, whatever replica count saved it (the N→M restore);
        corrupt steps are skipped for the previous good one.  Returns the
        restored step, or None when there is no checkpoint yet."""
        from deeplearning4j_tpu_torch.runtime.checkpoint import (
            resume_train_state,
        )

        return resume_train_state(directory, self)

    def publish_train_state(self) -> None:
        """A checkpointable snapshot in ``net.params`` / ``state`` /
        ``updater_state`` without touching the schedule: local SGD writes
        the replica average but keeps its replicas; ZeRO-1 publishes its
        moments."""
        if self.sync_every > 1 and self._rep is not None:
            self._publish_rep(self._averaged_rep())
        self.sync_updater_state_to_net()

    def set_lr_scale(self, scale: float) -> None:
        """The rollback back-off hook: the network's scale, which every
        step reads."""
        self.net.set_lr_scale(scale)

    def restore_train_state(self, step: int, params, updater_state=None,
                            net_state=None) -> None:
        """Adopt checkpointed training state into the network and this
        trainer's carriers (the supervisor's rollback and resume entry):
        local SGD restacks from the restored state at its next step; the
        ZeRO-1 slices are rebuilt from the restored per-layer moments for
        this mesh's size."""
        self.net.restore_train_state(step, params, updater_state,
                                     net_state)
        self._iteration = int(step)
        self._rep = None
        self._build_layout()
        if self.shard_update and self.sync_every == 1:
            self._opt_shard = self._init_sharded_opt_state()

    def finalize(self) -> None:
        """Publish the trainer-held state to the network: average any
        outstanding local-SGD drift and convert the ZeRO-1 slices to the
        per-layer form.  Call before checkpointing or handing the network
        to another training path."""
        if self.sync_every > 1 and self._rep is not None:
            self._average_params()
        self.sync_updater_state_to_net()
        if getattr(self.net, "_updater_state_owner", None) is self:
            self.net._updater_state_owner = None

    def train_state_bytes(self, x=None, mask=None) -> int:
        """Per-replica training-state bytes under this plane: ZeRO-1
        divides the flat parameter, moment and gradient extents by the
        shard count; replicated and local SGD report the whole."""
        from deeplearning4j_tpu_torch.precision.policy import (
            train_state_bytes,
        )

        shards = (self.n_devices
                  if self.shard_update and self.sync_every == 1 else 1)
        return train_state_bytes(self.net, x, mask, shards=shards)

    def scaling_report(self) -> dict:
        if self.sync_every != 1:
            collective = f"param-average every {self.sync_every}"
            if self.shard_update:
                collective += " (sharded sync round)"
        elif self.shard_update:
            collective = "psum_scatter+all_gather (zero-1 weight update)"
        else:
            collective = "pmean"
        return {
            "devices": self.n_devices,
            "mesh": dict(self.mesh.shape),
            "collective": collective,
        }


__all__ = ["DataParallelTrainer"]
