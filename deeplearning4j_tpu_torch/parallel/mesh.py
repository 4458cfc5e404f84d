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
the replicated one agree bitwise by construction.  Cross-process
collectives (`torch.distributed`) are not here.

The ring attention of the LM mesh trainers (`parallel/ring_attention.py`)
rotates its key and value blocks with `ppermute`, one step along the
ring as ``lax.ppermute`` does; blocks that sit on the same device are
only re-indexed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object
    array of `torch.device`s, ``axis_names`` names its axes, ``shape``
    maps each name to its size (as `jax.sharding.Mesh.shape` does)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axis "
                             f"names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> List[torch.device]:
        """The devices in shard order (row-major over the axes)."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.flat_devices()})"


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh over `devices` (each resolved by `resolve_device`: a named
    card must exist, and a device may be listed more than once), by
    default over every visible CUDA device — `RuntimeError` when there is
    no card.  Default shape: one data axis over all of them; for more
    axes pass e.g. ``shape=(4, 2), axis_names=("data", "model")``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for the default mesh; pass "
                "devices= (e.g. [torch.device('cpu')] * 4) to build one "
                "on the CPU explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if shape is None:
        shape = (len(devices),)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"Mesh shape {shape} needs {int(np.prod(shape))} devices, "
            f"have {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def round_batch_to_mesh(batch_size: int, mesh: Mesh) -> int:
    """Smallest batch >= batch_size divisible into equal shards over the
    mesh's devices."""
    n = mesh.size
    return ((batch_size + n - 1) // n) * n


def shard_batch(mesh: Mesh, a, axis: str = "data"
                ) -> Optional[List[torch.Tensor]]:
    """`a` (an array or tensor; None passes through) cut on dim 0 into
    the `axis` size's equal slices, slice i on shard i's device."""
    if a is None:
        return None
    devices = mesh.flat_devices()
    n = mesh.shape[axis]
    if n != len(devices):
        raise ValueError("shard_batch shards over a one-axis mesh")
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.require(np.asarray(a),
                                        requirements=["C", "W"]))
    if a.shape[0] % n:
        raise ValueError(f"Global batch {a.shape[0]} not divisible by "
                         f"{n} devices")
    return [piece.to(dev) for piece, dev in zip(a.chunk(n), devices)]


def replicate(mesh: Mesh, tree, tree_device: Optional[torch.device] = None,
              grad: bool = False) -> list:
    """One copy of `tree` (nested dicts and lists of tensors) a shard, on
    the shard's device: shards on `tree_device` (the tree's own device by
    default) share the tree itself, and shards that share any other
    device share one copy (its floating leaves requiring grad with
    `grad`)."""
    from deeplearning4j_tpu_torch.tree import map_tree, tree_leaves

    if tree_device is None:
        leaves = tree_leaves(tree)
        tree_device = leaves[0].device if leaves else None
    copies = {tree_device: tree}
    out = []
    for dev in mesh.flat_devices():
        if dev not in copies:
            copies[dev] = map_tree(
                lambda t, d=dev: t.detach().to(d).requires_grad_(
                    grad and t.is_floating_point()), tree)
        out.append(copies[dev])
    return out


# ---------------------------------------------------------------------------
# collectives: the shard tensors summed in shard order

def psum(shards: Sequence[torch.Tensor],
         device: Optional[torch.device] = None) -> torch.Tensor:
    """The sum of the shard tensors in shard order, on `device` (shard
    0's by default)."""
    device = shards[0].device if device is None else device
    acc = shards[0].to(device)
    for s in shards[1:]:
        acc = acc + s.to(device)
    return acc


def pmean(shards: Sequence[torch.Tensor],
          device: Optional[torch.device] = None) -> torch.Tensor:
    """`psum` divided by the shard count (`lax.pmean`'s form)."""
    return psum(shards, device) / len(shards)


def psum_scatter(flats: Sequence[torch.Tensor],
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Reduce-scatter of equal-length flat vectors: slice j of the sum
    (``k / n`` elements), on ``devices[j]``, each element summed in shard
    order exactly as `psum` sums it (`lax.psum_scatter(tiled=True)`)."""
    n = len(flats)
    k = flats[0].shape[0]
    if k % n:
        raise ValueError(f"flat length {k} does not split into {n} shards")
    ksh = k // n
    return [psum([f[j * ksh:(j + 1) * ksh] for f in flats], devices[j])
            for j in range(n)]


def all_gather(shards: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The shards concatenated on dim 0 in shard order, on `device`
    (`lax.all_gather(tiled=True)`)."""
    return torch.cat([s.to(device) for s in shards])


def ppermute(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One step along a ring (``lax.ppermute`` with the permutation
    ``[(i, (i + 1) % n)]``): entry ``(i + 1) % n`` of the result is shard
    i, moved onto the device of the shard it replaces.  A shard whose
    destination is on its own device is only re-indexed, never copied."""
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
    over one device, repeated, copies nothing).

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
    devices = mesh.flat_devices()

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
        loss = psum(losses, home)
        aux = _gather_aux(auxes, home)
        return (*apply_fn(*state, *scalars, aux), loss)

    return sharded


def _first_tensor(tree) -> torch.Tensor:
    return (_first_tensor(tree[0]) if isinstance(tree, (tuple, list))
            else tree)


def _to(tree, device: torch.device):
    """Nested tuples of tensors copied to `device`."""
    if isinstance(tree, (tuple, list)):
        return tuple(_to(t, device) for t in tree)
    return tree.to(device)


def _gather_aux(auxes: list, device: torch.device):
    """The shards' aux trees (nested tuples of tensors) gathered leafwise
    in shard order."""
    first = auxes[0]
    if isinstance(first, (tuple, list)):
        return tuple(_gather_aux([a[i] for a in auxes], device)
                     for i in range(len(first)))
    return all_gather(auxes, device)


__all__ = ["Mesh", "all_gather", "make_mesh", "pmean", "ppermute", "psum",
           "psum_scatter", "replicate", "round_batch_to_mesh",
           "shard_batch", "sparse_allgather_step"]
