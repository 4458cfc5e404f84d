"""Device meshes and the collectives over them (counterpart of
`deeplearning4j_tpu.parallel.mesh`).

The JAX package runs one controller over a `jax.sharding.Mesh`: a step is
a `shard_map` program whose shards exchange gradients with `lax.pmean`,
`psum_scatter` and `all_gather`.  The port keeps the one controller.  A
`Mesh` is a numpy array of `torch.device`s with axis names; a step runs
one forward and backward a shard, in a Python loop, each on its shard's
device and its slice of the batch; the collectives are plain functions
over the list of shard tensors.  That loop and `Mesh` take the place of
the JAX module's `named_sharding`, `batch_sharded` and
`shard_map_compat`, which are `jax.sharding` plumbing.

A device may repeat when the caller lists it again
(``make_mesh((4,), devices=[torch.device("cuda")] * 4)``): four shards
on one card, or on the CPU, as the JAX package reaches 8 shards on its
virtual CPU devices.  Shards that share a device share one copy of what
is replicated.

The collectives sum the shard tensors in shard order, on the device the
result lives on, so a result never depends on timing, and the mean
(`pmean`) and the reduce-scatter (`psum_scatter`, then `all_gather`)
perform the same additions element by element: the ZeRO-1 update and
the replicated one agree bitwise by construction.

Across processes.  After `runtime.launcher.initialize_multihost` has
joined the process to a `torch.distributed` group, `make_mesh` takes this
process's own devices and builds the global mesh in process-major order,
as ``jax.devices()`` orders a multi-host job: every process passes the
same count, and shard ``r * L + j`` is process r's j-th device.  Each
process runs only its own shards (`Mesh.local_shards`), and the
collectives, given the mesh, take its local shard tensors: they gather
every shard's tensor from every process (`torch.distributed.all_gather`)
and sum them in global shard order on every process, the same chain of
additions as in one process, so 2 processes of 2 shards compute what 1
process of 4 computes, bit for bit.  That moves P times the bytes of an
all-reduce; it is the price of the bitwise identity.  Over gloo the
tensors travel through host memory, copied there by the collective
itself; over NCCL they stay on the card.

The ring attention of the LM mesh trainers (`parallel/ring_attention.py`)
rotates its key and value blocks with `ppermute`, one step along the
ring as ``lax.ppermute`` does; blocks that sit on the same device are
only re-indexed.  Across processes it is refused (`refuse_spanning`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object
    array of `torch.device`s, ``axis_names`` names its axes, ``shape``
    maps each name to its size (as `jax.sharding.Mesh.shape` does).

    A mesh built over a `torch.distributed` group (``distributed``) lists
    every process's devices; ``process_of`` holds each shard's process,
    and this process runs `local_shards` on `local_devices`.  One
    process's mesh has ``process_index`` 0 of ``process_count`` 1."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_of: Optional[np.ndarray] = None,
                 process_index: int = 0, host_staged: bool = False):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axis "
                             f"names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.distributed = process_of is not None
        self.process_of = (np.zeros(devices.shape, np.int64)
                           if process_of is None else process_of)
        self.process_index = int(process_index)
        self.process_count = int(self.process_of.max()) + 1
        # gloo collectives take host tensors: chosen once, by backend
        self._host_staged = bool(host_staged)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    def flat_devices(self) -> List[torch.device]:
        """Every shard's device in shard order (row-major over the axes);
        in a mesh that spans processes, other processes' too."""
        return list(self.devices.reshape(-1))

    def local_shards(self) -> List[int]:
        """The global indices, in shard order, of this process's shards."""
        return [int(i) for i in
                np.flatnonzero(self.process_of.reshape(-1)
                               == self.process_index)]

    def local_devices(self) -> List[torch.device]:
        """The devices of `local_shards`."""
        flat = self.flat_devices()
        return [flat[i] for i in self.local_shards()]

    def __repr__(self) -> str:
        extra = (f", process {self.process_index} of {self.process_count}"
                 if self.distributed else "")
        return f"Mesh({self.shape}, devices={self.flat_devices()}{extra})"


def _dist():
    """`torch.distributed` when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    """This process's rank in the job (`jax.process_index`): 0 without a
    process group."""
    dist = _dist()
    return int(dist.get_rank()) if dist is not None else 0


def process_count() -> int:
    """Processes of the job (`jax.process_count`): the process group's
    world size, 1 without one."""
    dist = _dist()
    return int(dist.get_world_size()) if dist is not None else 1


def sync_processes(name: str) -> None:
    """A barrier over every process of the job (the counterpart of
    `multihost_utils.sync_global_devices`): returns once all reached it,
    raises `RuntimeError` naming `name` when a peer failed or the group's
    timeout passed.  A no-op in a one-process job."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except Exception as e:  # noqa: BLE001 — re-raised with the barrier's name
        raise RuntimeError(f"barrier {name!r} failed on process "
                           f"{dist.get_rank()}: {e}") from e


def refuse_spanning(mesh: Optional["Mesh"], what: str) -> None:
    """`NotImplementedError` when `mesh` spans processes: `what` needs
    autograd-aware collectives (an all-gather whose backward is a
    reduce-scatter) and point-to-point send and receive."""
    if mesh is not None and mesh.spans_processes:
        raise NotImplementedError(
            f"{what} over a mesh that spans {mesh.process_count} processes "
            f"is not ported: it needs autograd-aware collectives and "
            f"point-to-point send and receive (ROADMAP.md, A7 part 3b)")


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh over `devices` (each resolved by `resolve_device`: a named
    card must exist, and a device may be listed more than once), by
    default over every visible CUDA device — `RuntimeError` when there is
    no card.  Default shape: one data axis over all of them; for more
    axes pass e.g. ``shape=(4, 2), axis_names=("data", "model")``.

    In a job of several processes (a `torch.distributed` group is up)
    `devices` are this process's own, every process passes the same
    count, and the mesh holds them all in process-major order: `shape`
    is the global one.  Building it is then a collective: every process
    of the group must call `make_mesh`, or the callers wait for the
    others until the group's timeout."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for the default mesh; pass "
                "devices= (e.g. [torch.device('cpu')] * 4) to build one "
                "on the CPU explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    dist = _dist()
    owner = None
    if dist is not None:
        names: list = [None] * dist.get_world_size()
        dist.all_gather_object(names, [str(d) for d in devices])
        if any(len(n) != len(devices) for n in names):
            raise ValueError(f"every process must pass the same count of "
                             f"devices; got {[len(n) for n in names]}")
        devices = [torch.device(d) for n in names for d in n]
        owner = np.array([r for r, n in enumerate(names) for _ in n])
    if shape is None:
        shape = (len(devices),)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"Mesh shape {shape} needs {int(np.prod(shape))} devices, "
            f"have {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    if owner is None:
        return Mesh(arr.reshape(shape), axis_names)
    return Mesh(arr.reshape(shape), axis_names, owner.reshape(shape),
                dist.get_rank(), dist.get_backend() == "gloo")


def round_batch_to_mesh(batch_size: int, mesh: Mesh) -> int:
    """Smallest batch >= batch_size divisible into equal shards over the
    mesh's devices."""
    n = mesh.size
    return ((batch_size + n - 1) // n) * n


def shard_batch(mesh: Mesh, a, axis: str = "data"
                ) -> Optional[List[torch.Tensor]]:
    """`a` (an array or tensor, the global batch; None passes through)
    cut on dim 0 into the `axis` size's equal slices, slice i on shard
    i's device: this process's slices, in the order of its shards."""
    if a is None:
        return None
    n = mesh.shape[axis]
    if n != mesh.size:
        raise ValueError("shard_batch shards over a one-axis mesh")
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.require(np.asarray(a),
                                        requirements=["C", "W"]))
    if a.shape[0] % n:
        raise ValueError(f"Global batch {a.shape[0]} not divisible by "
                         f"{n} devices")
    pieces = a.chunk(n)
    return [pieces[i].to(dev) for i, dev in zip(mesh.local_shards(),
                                                mesh.local_devices())]


def replicate(mesh: Mesh, tree, tree_device: Optional[torch.device] = None,
              grad: bool = False) -> list:
    """One copy of `tree` (nested dicts and lists of tensors) for each of
    this process's shards, on the shard's device: shards on `tree_device`
    (the tree's own device by default) share the tree itself, and shards
    that share any other device share one copy (its floating leaves
    requiring grad with `grad`)."""
    from deeplearning4j_tpu_torch.tree import map_tree, tree_leaves

    if tree_device is None:
        leaves = tree_leaves(tree)
        tree_device = leaves[0].device if leaves else None
    copies = {tree_device: tree}
    out = []
    for dev in mesh.local_devices():
        if dev not in copies:
            copies[dev] = map_tree(
                lambda t, d=dev: t.detach().to(d).requires_grad_(
                    grad and t.is_floating_point()), tree)
        out.append(copies[dev])
    return out


# ---------------------------------------------------------------------------
# collectives: the shard tensors summed in shard order

def all_shards(shards: Sequence[torch.Tensor], device: torch.device,
               mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Every shard's tensor in global shard order.  Without a mesh built
    over a process group, `shards` itself.  With one, `shards` are this
    process's (equal shapes and dtypes on every process) and each is
    gathered from every process onto `device`, bit for bit: as bytes,
    through host memory over gloo, on the card over NCCL.

    In a job of several processes a collective without that mesh would
    sum this process's shards alone: it raises `RuntimeError` instead."""
    if mesh is None or not mesh.distributed:
        dist = _dist()
        if dist is not None and dist.get_world_size() > 1:
            raise RuntimeError(
                f"a collective over this process's shards alone in a job "
                f"of {dist.get_world_size()} processes: pass the mesh that "
                f"make_mesh built over the process group")
        return list(shards)
    import torch.distributed as dist

    local = torch.stack([s.detach().to(device) for s in shards])
    buf = local.reshape(-1).view(torch.uint8)
    if mesh._host_staged:
        buf = buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(mesh.process_count)]
    dist.all_gather(parts, buf.contiguous())
    return [t for part in parts
            for t in part.to(device).view(local.dtype)
            .reshape(local.shape).unbind(0)]


def _sum(shards: Sequence[torch.Tensor],
         device: torch.device) -> torch.Tensor:
    acc = shards[0].to(device)
    for s in shards[1:]:
        acc = acc + s.to(device)
    return acc


def psum(shards: Sequence[torch.Tensor],
         device: Optional[torch.device] = None,
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of the shard tensors in shard order, on `device` (shard
    0's by default); over every process's shards when `mesh` spans a
    process group (`all_shards`)."""
    device = shards[0].device if device is None else device
    return _sum(all_shards(shards, device, mesh), device)


def pmean(shards: Sequence[torch.Tensor],
          device: Optional[torch.device] = None,
          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`psum` divided by the shard count (`lax.pmean`'s form)."""
    device = shards[0].device if device is None else device
    full = all_shards(shards, device, mesh)
    return _sum(full, device) / len(full)


def psum_scatter(flats: Sequence[torch.Tensor],
                 devices: Sequence[torch.device],
                 mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Reduce-scatter of equal-length flat vectors: slice j of the sum
    (``k / n`` elements), on ``devices[j]``, each element summed in shard
    order exactly as `psum` sums it (`lax.psum_scatter(tiled=True)`).
    Over a mesh that spans a process group, `flats` and `devices` are
    this process's shards', and so are the slices returned."""
    full = all_shards(flats, devices[0], mesh)
    ids = mesh.local_shards() if mesh is not None else range(len(full))
    n = len(full)
    k = full[0].shape[0]
    if k % n:
        raise ValueError(f"flat length {k} does not split into {n} shards")
    ksh = k // n
    return [_sum([f[j * ksh:(j + 1) * ksh] for f in full], dev)
            for j, dev in zip(ids, devices)]


def all_gather(shards: Sequence[torch.Tensor],
               device: torch.device,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The shards concatenated on dim 0 in shard order, on `device`
    (`lax.all_gather(tiled=True)`); every process's when `mesh` spans a
    process group."""
    return torch.cat([s.to(device) for s in all_shards(shards, device,
                                                       mesh)])


def ppermute(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One step along a ring (``lax.ppermute`` with the permutation
    ``[(i, (i + 1) % n)]``): entry ``(i + 1) % n`` of the result is shard
    i, moved onto the device of the shard it replaces.  A shard whose
    destination is on its own device is only re-indexed, never copied.
    The shards are one process's: the ring's callers refuse a mesh that
    spans processes (`refuse_spanning`)."""
    n = len(shards)
    return [shards[(j - 1) % n].to(shards[j].device) for j in range(n)]


# ---------------------------------------------------------------------------
# the sparse-embedding harness (Word2Vec and GloVe ``mesh=``)

def sparse_allgather_step(mesh: Optional[Mesh], deltas_fn: Callable,
                          apply_fn: Callable, n_state: int, n_sharded: int,
                          n_scalar: int = 0) -> Callable:
    """Data-parallel harness for sparse embedding updates: builds
    ``step(*state, *scalars, *sharded) -> (*state, loss)`` where

    - ``deltas_fn(same args) -> (loss, aux)`` computes a shard's sparse
      pieces (aux: nested tuples of ``[B, ...]`` tensors — row indices,
      deltas; a state argument may itself be a tuple of tables),
    - ``apply_fn(*state, *scalars, aux) -> state tuple`` scatters them
      into the state (in place is fine).

    ``mesh=None`` applies directly.  With a mesh the trailing
    `n_sharded` args are cut over the first axis, each shard's deltas
    are computed on its device, the losses summed and the aux pieces
    gathered in shard order (O(B) rows, never a dense table), and the
    gathered scatter applied once to the state.  The state lives on one
    device; a shard on another device computes on a copy of it (a mesh
    over one device, repeated, copies nothing).  Over a mesh that spans
    processes each process computes its own shards, gathers every
    shard's pieces and applies them to its own copy of the state, under
    torch's deterministic algorithms (`_deterministic`): equal copies
    then stay equal on every process, where the card's atomic
    ``index_add_`` would round duplicate rows in its own order in each.

    The JAX harness folds the shard index into a trailing PRNG key
    (``with_key``); the port's callers draw any randomness for the whole
    batch before the step and shard it with the batch, so a mesh step
    sees the single-device step's draws."""
    def single(*args):
        lead = args[:n_state + n_scalar]
        loss, aux = deltas_fn(*args)
        return (*apply_fn(*lead, aux), loss)

    if mesh is None:
        return single
    axis = mesh.axis_names[0]
    devices = mesh.local_devices()

    def sharded(*args):
        state = args[:n_state]
        scalars = args[n_state:n_state + n_scalar]
        batch = args[n_state + n_scalar:]
        cut = [shard_batch(mesh, a, axis) for a in batch]
        home = _first_tensor(state).device
        losses, auxes = [], []
        for i, dev in enumerate(devices):
            st = state if dev == home else _to(state, dev)
            loss, aux = deltas_fn(*st, *scalars, *(c[i] for c in cut))
            losses.append(loss)
            auxes.append(aux)
        loss = psum(losses, home, mesh)
        aux = _gather_aux(auxes, home, mesh)
        with (_deterministic() if mesh.spans_processes
              else contextlib.nullcontext()):
            new = apply_fn(*state, *scalars, aux)
        return (*new, loss)

    return sharded


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms for the block, then the caller's
    setting back: on the card ``index_add_`` adds through a sorted
    ``index_put_(accumulate=True)`` instead of atomics, so the same
    inputs give the same bits in every process.  The CPU's ``index_add_``
    is sequential either way."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def _first_tensor(tree) -> torch.Tensor:
    return (_first_tensor(tree[0]) if isinstance(tree, (tuple, list))
            else tree)


def _to(tree, device: torch.device):
    """Nested tuples of tensors copied to `device`."""
    if isinstance(tree, (tuple, list)):
        return tuple(_to(t, device) for t in tree)
    return tree.to(device)


def _gather_aux(auxes: list, device: torch.device, mesh: Mesh):
    """The shards' aux trees (nested tuples of tensors) gathered leafwise
    in shard order."""
    first = auxes[0]
    if isinstance(first, (tuple, list)):
        return tuple(_gather_aux([a[i] for a in auxes], device, mesh)
                     for i in range(len(first)))
    return all_gather(auxes, device, mesh)


__all__ = ["Mesh", "all_gather", "all_shards", "make_mesh", "pmean",
           "ppermute", "process_count", "process_index", "psum",
           "psum_scatter", "refuse_spanning", "replicate",
           "round_batch_to_mesh", "shard_batch", "sparse_allgather_step",
           "sync_processes"]
