"""One partition-spec vocabulary for the replica axis, and the N→M
redistribution built on it (counterpart of
`deeplearning4j_tpu.parallel.partition`).

- `PartitionSpec(axis, dim, size)` — how one tree leaf relates to the
  replica axis: ``axis=None`` means replicated (every replica holds the
  whole leaf); otherwise dimension `dim` is split across mesh axis
  `axis`, and `size` records the true extent along `dim` before padding.
- `split_leaf` / `join_leaf` — equal pieces with the remainder
  zero-padded, and the exact inverse.
- `shard_tree` / `gather_tree` / `reshard` — the same over whole trees;
  `reshard` takes leaves carried as `n_from`-long shard lists to
  `n_to`-long ones, bitwise at the full-tree level for any N→M.
- `spec_to_json` / `spec_from_json` — the form a checkpoint manifest
  records, so a restore knows the saved layout.

Host-side numpy, as in the JAX package: `reshard` runs during a
checkpoint restore, before any mesh exists.  Trees are the port's nested
dicts and lists (tuples too); a list of arrays where a leaf belongs is a
shard list.  Keypaths are the JAX package's, dict keys in sorted order,
so a manifest written by either package resolves in the other.  The JAX
module's `as_jax` / `as_jax_leaf` bridge to `jax.sharding` has no
counterpart: the port's trainers read this vocabulary directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

PyTree = Any

KEYPATH_SEP = "//"


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """How one leaf is placed across the replica axis.

    ``axis=None`` (the default): replicated.  Otherwise dimension ``dim``
    is split across mesh axis ``axis``; ``size`` is the true extent along
    ``dim`` before any padding (None = unknown or unpadded)."""

    axis: Optional[str] = None
    dim: Optional[int] = None
    size: Optional[int] = None

    @property
    def is_replicated(self) -> bool:
        return self.axis is None or self.dim is None

    def to_json(self) -> dict:
        return {"axis": self.axis, "dim": self.dim, "size": self.size}

    @staticmethod
    def from_json(d: dict) -> "PartitionSpec":
        return PartitionSpec(axis=d.get("axis"), dim=d.get("dim"),
                             size=d.get("size"))


def replicated() -> PartitionSpec:
    return PartitionSpec()


def sharded(axis: str = "data", dim: int = 0,
            size: Optional[int] = None) -> PartitionSpec:
    return PartitionSpec(axis=axis, dim=int(dim), size=size)


def zero1(axis: str = "data", size: Optional[int] = None) -> PartitionSpec:
    """The ZeRO-1 weight-update layout: a flat ``[padded_extent(k0, n)]``
    moment or master vector split on dim 0 over the replica axis, one 1/N
    slice a replica; `size` is the padded flat length."""
    return sharded(axis, dim=0, size=size)


def is_partition_spec(obj) -> bool:
    return isinstance(obj, PartitionSpec)


# ---------------------------------------------------------------------------
# leaf-level split/join (padded-remainder handling)

def padded_extent(size: int, n: int) -> int:
    """Smallest multiple of `n` >= `size` (the per-shard extent is
    ``padded_extent(size, n) // n``)."""
    if n <= 0:
        raise ValueError(f"shard count must be >= 1, got {n}")
    return ((int(size) + n - 1) // n) * n


def split_leaf(arr, n: int, dim: int = 0) -> List[np.ndarray]:
    """`arr` in `n` equal pieces along `dim`, the remainder zero-padded;
    `join_leaf` with the true size is the exact inverse."""
    arr = np.asarray(arr)
    if arr.ndim == 0:
        raise ValueError("cannot split a 0-d leaf; mark it replicated")
    size = arr.shape[dim]
    total = padded_extent(size, n)
    if total != size:
        pad = [(0, 0)] * arr.ndim
        pad[dim] = (0, total - size)
        arr = np.pad(arr, pad)
    return [np.ascontiguousarray(piece)
            for piece in np.split(arr, n, axis=dim)]


def join_leaf(shards: Sequence[np.ndarray], dim: int = 0,
              size: Optional[int] = None) -> np.ndarray:
    """Concatenate shards along `dim` and strip the padding down to the
    true `size` (None = the shards were unpadded)."""
    full = np.concatenate([np.asarray(s) for s in shards], axis=dim)
    if size is not None and full.shape[dim] != size:
        if full.shape[dim] < size:
            raise ValueError(
                f"shards join to extent {full.shape[dim]} along dim "
                f"{dim}, smaller than the recorded size {size}")
        full = np.take(full, np.arange(int(size)), axis=dim)
    return full


# ---------------------------------------------------------------------------
# trees

def _is_shard_list(x) -> bool:
    return (isinstance(x, (list, tuple)) and len(x) > 0
            and all(isinstance(a, (np.ndarray, np.generic))
                    or hasattr(a, "__array__") for a in x))


def _children(node):
    """(key, child) pairs of a container in the JAX package's flatten
    order (dict keys sorted), or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn(leaf, *matching nodes of rest)`` over `tree`'s structure."""
    if is_leaf is None or not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: _map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                   for i, v in enumerate(tree)]
            return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def _leaves_with_paths(tree, is_leaf=None, prefix: str = ""):
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        key = f"{prefix}{KEYPATH_SEP}{k}" if prefix else str(k)
        out.extend(_leaves_with_paths(v, is_leaf, key))
    return out


def _spec_leaves(tree: PyTree, spec) -> PyTree:
    """`spec` resolved to a tree matching `tree`: one PartitionSpec
    broadcasts over every leaf; a flat {keypath: PartitionSpec} map (the
    `spec_from_json` form) is looked up per leaf keypath (a missing key
    raises); anything else is a structurally matching spec tree."""
    if isinstance(spec, PartitionSpec):
        return _map(lambda _: spec, tree, is_leaf=_is_shard_list)
    if (isinstance(spec, dict) and spec
            and all(isinstance(k, str) and is_partition_spec(v)
                    for k, v in spec.items())):
        # a flat keypath map (what a checkpoint manifest deserializes to)
        def lookup(key):
            ps = spec.get(key)
            if ps is None:
                raise ValueError(
                    f"partition spec has no entry for leaf {key!r} "
                    f"(known: {sorted(spec)[:8]}...)")
            return ps

        return _rebuild(tree, lookup)
    return spec


def _rebuild(tree, leaf_for_key, prefix: str = ""):
    """`tree`'s structure with each leaf replaced by
    ``leaf_for_key(keypath)``."""
    if _is_shard_list(tree) or _children(tree) is None:
        return leaf_for_key(prefix)

    def key(k):
        return f"{prefix}{KEYPATH_SEP}{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_for_key, key(k))
                for k, v in tree.items()}
    out = [_rebuild(v, leaf_for_key, key(i)) for i, v in enumerate(tree)]
    return out if isinstance(tree, list) else tuple(out)


def shard_tree(tree: PyTree, spec, n: int) -> PyTree:
    """Every leaf of `tree` split into a length-`n` shard list by its spec
    (a replicated leaf becomes `n` references to one array)."""
    spec_tree = _spec_leaves(tree, spec)

    def split(leaf, ps: PartitionSpec):
        arr = np.asarray(leaf)
        if ps.is_replicated or arr.ndim == 0:
            return [arr] * n
        return split_leaf(arr, n, ps.dim)

    return _map(split, tree, spec_tree)


def gather_tree(tree: PyTree, spec) -> PyTree:
    """Inverse of `shard_tree`: every shard-list leaf joined back into
    the full array (a replicated leaf takes shard 0)."""
    spec_tree = _spec_leaves(tree, spec)

    def join(shards, ps: PartitionSpec):
        if not _is_shard_list(shards):
            return np.asarray(shards)
        if ps.is_replicated:
            return np.asarray(shards[0])
        return join_leaf(shards, ps.dim, ps.size)

    return _map(join, tree, spec_tree, is_leaf=_is_shard_list)


def reshard(tree: PyTree, spec, n_from: int, n_to: int) -> PyTree:
    """Leaves carried as length-`n_from` shard lists come back as
    length-`n_to` shard lists: gathered along each leaf's spec'd dim (the
    padding stripped by the spec's true size), then split again, padded,
    for `n_to`.  Gathering the result gives the original arrays bitwise,
    for any N→M.  A replicated leaf is re-referenced, never copied; a
    bare-array leaf is taken as the already-gathered value."""
    if n_from < 1 or n_to < 1:
        raise ValueError(f"replica counts must be >= 1, got "
                         f"{n_from}→{n_to}")
    spec_tree = _spec_leaves(tree, spec)

    def redistribute(shards, ps: PartitionSpec):
        if _is_shard_list(shards):
            if len(shards) != n_from:
                raise ValueError(
                    f"leaf carries {len(shards)} shards, expected "
                    f"n_from={n_from}")
            full = (np.asarray(shards[0]) if ps.is_replicated
                    else join_leaf(shards, ps.dim, ps.size))
        else:
            full = np.asarray(shards)
        if ps.is_replicated or full.ndim == 0:
            return [full] * n_to
        return split_leaf(full, n_to, ps.dim)

    return _map(redistribute, tree, spec_tree, is_leaf=_is_shard_list)


# ---------------------------------------------------------------------------
# serialization (the checkpoint-manifest form)

def spec_to_json(spec) -> Dict[str, dict]:
    """A spec (one PartitionSpec, or a tree of them) as the JSON form a
    manifest records: keypath -> leaf-spec dict, a broadcast single spec
    under "*"."""
    if isinstance(spec, PartitionSpec):
        return {"*": spec.to_json()}
    return {key: leaf.to_json()
            for key, leaf in _leaves_with_paths(spec, is_partition_spec)}


def spec_from_json(d: Dict[str, dict]):
    """Inverse of `spec_to_json`: "*" gives the broadcast single spec
    back; otherwise a flat {keypath: PartitionSpec} map, which `reshard`,
    `shard_tree` and `gather_tree` resolve per leaf keypath."""
    if set(d) == {"*"}:
        return PartitionSpec.from_json(d["*"])
    return {k: PartitionSpec.from_json(v) for k, v in d.items()}


__all__ = ["KEYPATH_SEP", "PartitionSpec", "gather_tree", "is_partition_spec",
           "join_leaf", "padded_extent", "replicated", "reshard",
           "shard_tree", "sharded", "spec_from_json", "spec_to_json",
           "split_leaf", "zero1"]
