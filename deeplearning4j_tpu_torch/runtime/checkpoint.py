"""Parameter trees to and from ``.npz`` (subset of
`deeplearning4j_tpu.runtime.checkpoint`).

The JAX package's format: one array per leaf, keyed by the leaf's
``//``-joined keypath (``layers//0//attn//wq``); bfloat16 leaves are
stored as float32, which is exact.  The writer is atomic: a temporary file
made with ``mkstemp`` in the target directory, then ``os.replace``, so a
crash leaves the previous file or the new one, never a torn one.  The
sharded, checksummed train-state checkpoints of the JAX module are not
ported yet (ROADMAP.md, queue A3).
"""

from __future__ import annotations

import os
import pathlib
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.tree import KEYPATH_SEP, flatten_tree

def _fill(like, flat: Dict[str, Any], leaf, prefix: str = ""):
    """Rebuild `like`'s structure, each leaf ``leaf(flat[keypath], like)``."""
    if isinstance(like, dict):
        return {k: _fill(v, flat, leaf, f"{prefix}{KEYPATH_SEP}{k}"
                         if prefix else str(k)) for k, v in like.items()}
    if isinstance(like, list):
        return [_fill(v, flat, leaf, f"{prefix}{KEYPATH_SEP}{i}")
                for i, v in enumerate(like)]
    if prefix not in flat:
        raise KeyError(f"checkpoint is missing leaf {prefix!r} (structure "
                       f"mismatch with the restore template)")
    return leaf(flat[prefix], like)


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()       # exact; restored to the narrow dtype on load
        return a.numpy()
    return np.asarray(a)


def _atomic_savez(path: os.PathLike, arrays: Dict[str, np.ndarray]) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def tree_to_npz(path: os.PathLike, tree) -> None:
    """Write every leaf (tensor or array) of `tree` to `path`, atomically."""
    _atomic_savez(path, {k: _to_numpy(v)
                         for k, v in flatten_tree(tree).items()})


def _load_npz(path: os.PathLike) -> Dict[str, np.ndarray]:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def npz_to_tree(path: os.PathLike, like):
    """Restore `path` into the structure of `like` (keypath-matched):
    a tensor leaf of `like` gives a tensor of its dtype on its device, any
    other leaf a numpy array of its dtype."""
    def leaf(a, ref):
        if isinstance(ref, torch.Tensor):
            return torch.from_numpy(np.array(a)).to(device=ref.device,
                                                    dtype=ref.dtype)
        return np.asarray(a, dtype=np.asarray(ref).dtype)

    return _fill(like, _load_npz(path), leaf)


def read_lm_npz(path: os.PathLike, cfg) -> dict:
    """An ``lm_params.npz`` written by either package's ``lm`` command ->
    the float32 numpy parameter tree, checked leaf by leaf against the
    shapes of `cfg` (a `parallel.transformer.TransformerConfig`)."""
    from deeplearning4j_tpu_torch.parallel.transformer import param_shapes

    shapes = param_shapes(cfg)
    flat_shapes = flatten_tree(shapes)
    flat = _load_npz(path)
    missing = sorted(set(flat_shapes) - set(flat))
    extra = sorted(set(flat) - set(flat_shapes))
    if missing or extra:
        raise ValueError(f"{path}: parameters do not match the config "
                         f"(missing {missing[:5]}, unexpected {extra[:5]})")
    for key, want in flat_shapes.items():
        if tuple(flat[key].shape) != tuple(want):
            raise ValueError(f"{path}: {key} has shape "
                             f"{tuple(flat[key].shape)}, the config needs "
                             f"{tuple(want)}")
    return _fill(shapes, flat, lambda a, _: np.asarray(a, np.float32))


__all__ = ["npz_to_tree", "read_lm_npz", "tree_to_npz"]
