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

The LM mesh trainers run one SPMD program over the mesh (`Program`):
every process runs the whole program, computes only its own shards, and
the shards meet in autograd-aware exchanges (`psum`, `all_gather`,
`psum_scatter` over one axis, `ppermute` along an axis ring, shard-to-
shard `move`, and the fan-out and fan-in of process-replicated values).
Each adds in global shard order in its forward and in its backward, and
a hop between processes pairs a send with a receive in one batch
(`batch_isend_irecv`), so 2 processes of 2 shards compute what 1
process of 4 computes, bit for bit, gradients included.  An ordering token threads the exchanges, so autograd runs
their backward halves in the reverse of the forward order on every
process and no two processes wait for each other.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.parallel.kernels import LaunchCounter

# bytes this process has sent to other processes through the exchanges
# of `Program` (headers included): what crosses processes a step
P2P_SENT = LaunchCounter()


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

    def coord(self, shard: int, axis: str) -> int:
        """A shard's coordinate on `axis` (0 on an axis the mesh lacks)."""
        if axis not in self.axis_names:
            return 0
        return int(np.unravel_index(shard, self.devices.shape)[
            self.axis_names.index(axis)])

    def shard(self, **coords: int) -> int:
        """The shard at the named coordinates (0 on the axes not named;
        a name the mesh lacks must be given 0)."""
        if any(c for a, c in coords.items() if a not in self.axis_names):
            raise ValueError(f"coordinates {coords} on axes the mesh "
                             f"{self.axis_names} lacks")
        return int(np.ravel_multi_index(
            tuple(coords.get(a, 0) for a in self.axis_names),
            self.devices.shape))

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


# ---------------------------------------------------------------------------
# one SPMD program over a mesh: autograd-aware exchanges between shards

_WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
                torch.int64, torch.int32, torch.int16, torch.int8,
                torch.uint8, torch.bool)


def _pack(tensors: Sequence[torch.Tensor],
          device: torch.device) -> torch.Tensor:
    """Tensors as one byte buffer on `device`: an int64 header (count,
    then dtype code, rank and shape of each) and the 8-byte-aligned raw
    bytes of each, so the receiver needs no shapes of its own.  The
    bytes are joined where the tensors live and moved in one copy."""
    head = [len(tensors)]
    chunks = []
    home = tensors[0].device
    for t in tensors:
        t = t.detach().contiguous()
        head += [_WIRE_DTYPES.index(t.dtype), t.dim(), *t.shape]
        raw = t.reshape(-1).view(torch.uint8).to(home)
        chunks.append(raw)
        if raw.numel() % 8:
            chunks.append(raw.new_zeros(-raw.numel() % 8))
    head = torch.tensor([len(head), *head], dtype=torch.int64)
    return torch.cat([head.view(torch.uint8).to(home), *chunks]).to(device)


def _unpack(buf: torch.Tensor, device: torch.device) -> List[torch.Tensor]:
    """`_pack`'s inverse: owned copies on `device`, moved in one copy."""
    n_head = int(buf[:8].view(torch.int64)[0])
    head = buf[8:8 * (n_head + 1)].view(torch.int64).tolist()
    buf = buf.to(device)
    off, i, out = 8 * (n_head + 1), 1, []
    for _ in range(head[0]):
        dtype, rank = _WIRE_DTYPES[head[i]], head[i + 1]
        shape = head[i + 2:i + 2 + rank]
        i += 2 + rank
        size = int(np.prod(shape)) * torch.empty((), dtype=dtype) \
            .element_size()
        out.append(buf[off:off + size].view(dtype).reshape(shape).clone())
        off += size + (-size % 8)
    return out


def _p2p(mesh: Mesh, sends: Dict[int, List[torch.Tensor]],
         recv_from: Sequence[int],
         device: torch.device) -> Dict[int, List[torch.Tensor]]:
    """Point-to-point exchange between processes: the list ``sends[q]``
    to process q, one list from each process of `recv_from`, onto
    `device`.  Two rounds, the byte counts and then the bytes; each
    round posts all its sends and receives as one batch
    (`torch.distributed.batch_isend_irecv`), so two processes that send
    to each other both have their receive posted: over NCCL the batch is
    one group of the communicator (a send queued ahead of its peer's
    receive on the one p2p stream would wait for it for ever), over gloo
    the separate `isend` and `irecv` it posts.  A lost peer raises at
    the group's timeout.  Over gloo the bytes travel through host
    memory.  The NCCL route is untried: no job of two cards has run it
    (NCCL refuses two ranks on one card)."""
    import torch.distributed as dist

    def exchange(out: Dict[int, torch.Tensor], into: Dict[int, torch.Tensor]):
        ops = ([dist.P2POp(dist.isend, t, q) for q, t in out.items()]
               + [dist.P2POp(dist.irecv, t, q) for q, t in into.items()])
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    stage = torch.device("cpu") if mesh._host_staged else device
    bufs = {q: _pack(ts, stage) for q, ts in sorted(sends.items())}
    P2P_SENT.add(sum(b.numel() for b in bufs.values()))
    sizes = {p: torch.zeros(1, dtype=torch.int64, device=stage)
             for p in recv_from}
    exchange({q: torch.tensor([b.numel()], dtype=torch.int64, device=stage)
              for q, b in bufs.items()}, sizes)
    incoming = {p: torch.empty(int(t[0]), dtype=torch.uint8, device=stage)
                for p, t in sizes.items()}
    exchange(bufs, incoming)
    return {p: _unpack(b, device) for p, b in incoming.items()}


def _chain_sum(xs: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    """``((x0 + x1) + x2) + ...``, in `dtype` when given."""
    acc = xs[0] if dtype is None else xs[0].to(dtype)
    for x in xs[1:]:
        acc = acc + (x if dtype is None else x.to(dtype))
    return acc


class _Exchange(torch.autograd.Function):
    """One exchange of a `Program`: ``op.forward`` over the inputs, its
    adjoint ``op.backward`` over the cotangents.  The ordering token goes
    in and a new one comes out, so each exchange's backward waits for the
    next one's: autograd runs them in the reverse of the forward order,
    the same order on every process."""

    @staticmethod
    def forward(ctx, op, token, *xs):
        ctx.op = op
        out, seen = [], set()
        for y in op.forward(list(xs)):
            if id(y) in seen:          # distinct outputs, distinct tensors
                y = y.view_as(y)       # (a view: no copy on one device)
            seen.add(id(y))
            out.append(y)
        return (token.new_zeros(()), *out)

    @staticmethod
    def backward(ctx, _token, *grads):
        return (None, None, *ctx.op.backward(list(grads)))


class _Op:
    """An exchange over `keys_in` (the inputs' keys) -> `keys_out`, raw
    in both directions: ``fwd(dict) -> dict`` and ``bwd(dict) -> dict``."""

    def __init__(self, keys_in, keys_out, fwd, bwd):
        self.keys_in, self.keys_out = list(keys_in), list(keys_out)
        self._fwd, self._bwd = fwd, bwd

    def forward(self, xs):
        out = self._fwd(dict(zip(self.keys_in, xs)))
        return [out[k] for k in self.keys_out]

    def backward(self, grads):
        out = self._bwd(dict(zip(self.keys_out, grads)))
        return [out.get(k) for k in self.keys_in]


class _Wiring:
    """The shape of a `Program` with no tensor in it: the shards, their
    devices, processes and coordinates, and the raw exchanges.  The
    autograd nodes of a program hold this, never the program, so a
    finished step's graph is freed by reference counting alone."""

    def __init__(self, mesh: Mesh, scope: Optional[Sequence[int]] = None):
        self.mesh = mesh
        self.scope = (list(range(mesh.size)) if scope is None
                      else sorted(int(s) for s in scope))
        mine = set(mesh.local_shards())
        self.local = [s for s in self.scope if s in mine]
        self._devices = mesh.flat_devices()
        self._proc = [int(p) for p in mesh.process_of.reshape(-1)]
        first = self.local or mesh.local_shards()
        self.home = self._devices[first[0]]
        self._members: dict = {}

    # ---- the mesh read by shard ---------------------------------------------

    def device(self, s: int) -> torch.device:
        return self._devices[s]

    def members(self, s: int, axis: str) -> List[int]:
        """The shards that differ from `s` only on `axis`, in axis order."""
        key = (s, axis)
        if key not in self._members:
            at = {a: self.mesh.coord(s, a) for a in self.mesh.axis_names}
            self._members[key] = [self.mesh.shard(**{**at, axis: i})
                                  for i in range(self.mesh.shape[axis])]
        return self._members[key]

    def _processes(self) -> List[int]:
        """The first shard of the scope on each of its processes."""
        first = {}
        for s in self.scope:
            first.setdefault(self._proc[s], s)
        return [first[p] for p in sorted(first)]

    # ---- the raw exchange ---------------------------------------------------

    def transfer(self, moves, value: Callable) -> dict:
        """Raw (no autograd): `moves` are ``(key, src, dst)`` over the
        program's shards, the same list on every process; ``value(key)``
        gives the tensor for a local `src`.  Returns ``{(key, dst):
        tensor on dst's device}`` for each local `dst`.  A key goes to a
        process once, however many of its shards receive it."""
        me = self.mesh.process_index
        out, sends, expect, sent, where = {}, {}, {}, set(), {}
        for key, src, dst in moves:
            ps, pd = self._proc[src], self._proc[dst]
            if ps == me and pd == me:
                out[key, dst] = value(key).to(self._devices[dst])
            elif ps == me:
                if (key, pd) not in sent:
                    sent.add((key, pd))
                    sends.setdefault(pd, []).append(value(key))
            elif pd == me and key not in where:
                expect.setdefault(ps, []).append(key)
                where[key] = (ps, len(expect[ps]) - 1)
        if sends or expect:
            got = _p2p(self.mesh, sends, sorted(expect), self.home)
            for key, src, dst in moves:
                if self._proc[dst] == me and self._proc[src] != me:
                    p, i = where[key]
                    out[key, dst] = got[p][i].to(self._devices[dst])
        return out

    # ---- raw collectives (the adjoints use them too) ------------------------

    def _psum(self, xs: dict, axis: str) -> dict:
        moves = [(m, m, s) for s in self.scope
                 for m in self.members(s, axis)]
        got = self.transfer(moves, xs.__getitem__)
        return {s: _chain_sum([got[m, s] for m in self.members(s, axis)])
                for s in self.local}

    def _all_gather(self, xs: dict, axis: str, dim: int) -> dict:
        moves = [(m, m, s) for s in self.scope
                 for m in self.members(s, axis)]
        got = self.transfer(moves, xs.__getitem__)
        return {s: torch.cat([got[m, s] for m in self.members(s, axis)],
                             dim=dim) for s in self.local}

    def _psum_scatter(self, xs: dict, axis: str, dim: int) -> dict:
        n = self.mesh.shape[axis]

        def piece(key):
            m, s = key
            k = xs[m].shape[dim] // n
            return xs[m].narrow(dim, self.mesh.coord(s, axis) * k, k)

        moves = [((m, s), m, s) for s in self.scope
                 for m in self.members(s, axis)]
        got = self.transfer(moves, piece)
        return {s: _chain_sum([got[(m, s), s]
                               for m in self.members(s, axis)])
                for s in self.local}

    def hop(self, axis: str, shift: int, *values: dict) -> List[dict]:
        """Raw `ppermute` of several dicts at once (one exchange): shard
        s receives each dict's value of the shard `shift` steps before
        it on the axis ring."""
        n = self.mesh.shape[axis]

        def src(s):
            at = (self.mesh.coord(s, axis) - shift) % n
            return self.members(s, axis)[at]

        moves = [((i, src(s)), src(s), s) for i in range(len(values))
                 for s in self.scope]
        got = self.transfer(moves, lambda key: values[key[0]][key[1]])
        return [{s: got[(i, src(s)), s] for s in self.local}
                for i in range(len(values))]


class Program:
    """One SPMD program over `mesh` as this process runs it: values are
    dicts ``{global shard index: tensor}`` over this process's shards of
    the program (`local`; `scope` is every process's), and the shards
    meet only in this object's exchanges, which every process of the
    scope calls in the same order.

    Each exchange is a `torch.autograd.Function` whose forward and
    backward add in global shard order, on the device of the shard that
    receives, so no result depends on how the shards fall into
    processes: a hop within a process is a copy (nothing, on the same
    device), a hop across processes a send paired with a receive.  The
    exchanges:

    - `psum(xs, axis)`: each shard gets the sum over the shards that
      differ from it only on `axis` (``lax.psum``); the other
      coordinates form independent groups.  Its adjoint is itself.
    - `all_gather(xs, axis, dim)` (tiled) and `psum_scatter(xs, axis,
      dim)`, each the other's adjoint.
    - `ppermute(xs, axis, shift)`: one step along the axis ring; its
      adjoint is the step back.
    - `move(pairs, xs)`: shard to shard, ``xs[i]`` from ``pairs[i][0]``
      to ``pairs[i][1]``.
    - `broadcast(values, groups)`: process-replicated tensors (equal on
      every process that holds them, e.g. parameters) to the shards of
      each group; the gradient is the sum over the group's shards, on
      every process.
    - `total(parts, owners)` and `gather(parts, owners)`: the owners'
      tensors summed, or listed, on every process; the gradient of each
      owner's tensor is its own process's cotangent.

    Over one process the same code runs with no hop between processes,
    so a mesh of 4 shards in 1 process and one of 2 shards in each of 2
    processes compute the same bits.  The shards' layout and the raw
    exchanges are the program's `wiring`, which its autograd nodes keep
    in its stead."""

    def __init__(self, mesh: Mesh, scope: Optional[Sequence[int]] = None):
        self.wiring = _Wiring(mesh, scope)
        self._token: Optional[torch.Tensor] = None

    # ---- the wiring's view of the mesh -------------------------------------

    @property
    def mesh(self) -> Mesh:
        return self.wiring.mesh

    @property
    def scope(self) -> List[int]:
        return self.wiring.scope

    @property
    def local(self) -> List[int]:
        return self.wiring.local

    @property
    def home(self) -> torch.device:
        return self.wiring.home

    def device(self, s: int) -> torch.device:
        return self.wiring.device(s)

    def token(self) -> torch.Tensor:
        """The ordering token for an exchange written as its own
        `torch.autograd.Function` (`ring_attention`): pass it in, hand
        the Function's new token to `advance`."""
        return (self._token if self._token is not None
                else torch.zeros((), device=self.home))

    def advance(self, token: torch.Tensor) -> None:
        self._token = token

    def _exchange(self, op: _Op, xs: dict) -> dict:
        out = _Exchange.apply(op, self.token(), *(xs[k] for k in op.keys_in))
        self.advance(out[0])
        return dict(zip(op.keys_out, out[1:]))

    # ---- the autograd-aware exchanges --------------------------------------
    # (the closures hold `w`, the tensor-free wiring, never the program)

    def psum(self, xs: dict, axis: str) -> dict:
        if self.mesh.shape.get(axis, 1) == 1:
            return dict(xs)
        w = self.wiring
        return self._exchange(_Op(self.local, self.local,
                                  lambda v: w._psum(v, axis),
                                  lambda g: w._psum(g, axis)), xs)

    def all_gather(self, xs: dict, axis: str, dim: int = 0) -> dict:
        if self.mesh.shape.get(axis, 1) == 1:
            return dict(xs)
        w = self.wiring
        return self._exchange(_Op(self.local, self.local,
                                  lambda v: w._all_gather(v, axis, dim),
                                  lambda g: w._psum_scatter(g, axis, dim)),
                              xs)

    def psum_scatter(self, xs: dict, axis: str, dim: int = 0) -> dict:
        if self.mesh.shape.get(axis, 1) == 1:
            return dict(xs)
        w = self.wiring
        return self._exchange(_Op(self.local, self.local,
                                  lambda v: w._psum_scatter(v, axis, dim),
                                  lambda g: w._all_gather(g, axis, dim)),
                              xs)

    def ppermute(self, xs: dict, axis: str, shift: int = 1) -> dict:
        if self.mesh.shape.get(axis, 1) == 1:
            return dict(xs)
        w = self.wiring
        return self._exchange(_Op(self.local, self.local,
                                  lambda v: w.hop(axis, shift, v)[0],
                                  lambda g: w.hop(axis, -shift, g)[0]), xs)

    def move(self, pairs: Sequence[Tuple[int, int]], xs: dict) -> dict:
        """``out[i]`` on shard ``pairs[i][1]`` (for the local ones) is
        ``xs[i]`` from shard ``pairs[i][0]`` (given for the local ones)."""
        pairs = [(int(a), int(b)) for a, b in pairs]
        me = set(self.local)
        ins = [i for i, (a, _) in enumerate(pairs) if a in me]
        outs = [i for i, (_, b) in enumerate(pairs) if b in me]
        w = self.wiring

        def go(v, back):
            moves = [(i, b, a) if back else (i, a, b)
                     for i, (a, b) in enumerate(pairs)]
            return {i: t for (i, _), t in w.transfer(moves,
                                                     v.__getitem__).items()}

        return self._exchange(_Op(ins, outs, lambda v: go(v, False),
                                  lambda g: go(g, True)), xs)

    def broadcast(self, values: Sequence[Optional[torch.Tensor]],
                  groups: Sequence[Sequence[int]]) -> List[dict]:
        """``values[i]`` (None on a process that holds no shard of
        ``groups[i]``) copied to each local shard of ``groups[i]``:
        ``out[i][s]``.  The gradient of ``values[i]`` is the sum of its
        copies' gradients over the whole group in shard order (float32
        accumulation), the same on every process that holds it."""
        groups = [list(g) for g in groups]
        me = set(self.local)
        held = [i for i, g in enumerate(groups) if me.intersection(g)]
        if any(values[i] is None for i in held):
            raise ValueError("a broadcast value is missing on a process "
                             "that holds shards of its group")
        keys_out = [(i, s) for i in held for s in groups[i] if s in me]
        like = {i: (values[i].device, values[i].dtype) for i in held}
        w = self.wiring
        reps = w._processes()
        holders = [{w._proc[m] for m in g} for g in groups]
        rep = next((r for r in reps if r in me), None)

        def fwd(v):
            return {(i, s): v[i].to(w.device(s)) for i, s in keys_out}

        def bwd(g):
            # every copy's gradient to one shard of each holding process
            moves = [((i, s), s, r) for i, grp in enumerate(groups)
                     for s in grp for r in reps if w._proc[r] in holders[i]]
            got = w.transfer(moves, g.__getitem__)
            out = {}
            for i in held:
                parts = [got[(i, s), rep] for s in groups[i]]
                acc = _chain_sum(parts, torch.promote_types(
                    parts[0].dtype, torch.float32))
                out[i] = acc.to(*like[i])
            return out

        res = self._exchange(_Op(held, keys_out, fwd, bwd),
                             {i: values[i] for i in held})
        out = [dict() for _ in groups]
        for (i, s), t in res.items():
            out[i][s] = t
        return out

    def total(self, parts: dict, owners: Sequence[int]) -> torch.Tensor:
        """The owners' tensors (``parts``: this process's owners') summed
        in shard order, on every process, on `home`."""
        return self._fan_in(parts, owners, True)

    def gather(self, parts: dict,
               owners: Sequence[int]) -> List[torch.Tensor]:
        """The owners' tensors in the order of `owners`, on every
        process, on `home`."""
        return self._fan_in(parts, owners, False)

    def _fan_in(self, parts: dict, owners: Sequence[int], add: bool):
        owners = [int(o) for o in owners]
        mine = [o for o in owners if o in set(self.local)]
        like = {o: (parts[o].device, parts[o].dtype) for o in mine}
        w = self.wiring
        reps = w._processes()
        rep = next(r for r in reps if r in set(self.local))
        keys_out = ["out"] if add else list(range(len(owners)))

        def fwd(v):
            got = w.transfer([(o, o, r) for o in owners for r in reps],
                             v.__getitem__)
            xs = [got[o, rep].to(w.home) for o in owners]
            return {"out": _chain_sum(xs)} if add else dict(enumerate(xs))

        def bwd(g):
            return {o: (g["out"] if add else g[owners.index(o)])
                    .to(*like[o]) for o in mine}

        res = self._exchange(_Op(mine, keys_out, fwd, bwd),
                             {o: parts[o] for o in mine})
        return res["out"] if add else [res[i] for i in keys_out]


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


__all__ = ["Mesh", "P2P_SENT", "Program", "all_gather", "all_shards",
           "make_mesh", "pmean", "process_count",
           "process_index", "psum", "psum_scatter", "replicate",
           "round_batch_to_mesh", "shard_batch", "sparse_allgather_step",
           "sync_processes"]
