"""Parameter trees to and from ``.npz``, and whole networks to and from a
directory (subset of `deeplearning4j_tpu.runtime.checkpoint`).

The JAX package's format: one array per leaf, keyed by the leaf's
``//``-joined keypath (``layers//0//attn//wq``); bfloat16 leaves are
stored as float32, which is exact.  The writer is atomic: a temporary file
made with ``mkstemp`` in the target directory, then ``os.replace``, so a
crash leaves the previous file or the new one, never a torn one.

`save_model`/`load_model` write and read the JAX package's model
directory: ``conf.json`` + ``params.npz`` [+ ``updater.npz``] +
``meta.json``; a directory saved by either package loads in the other.
`save_params`/`load_params` write and read the flat parameter vector
(the CLI's ``params.bin`` / ``params.txt``) in the JAX package's format.
The sharded, checksummed train-state checkpoints of the JAX module go
with the resilience modules (ROADMAP.md, queue A6).
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.tree import KEYPATH_SEP, flatten_tree, map_tree


def _fill(like, flat: Dict[str, Any], leaf, prefix: str = ""):
    """Rebuild `like`'s structure, each leaf ``leaf(flat[keypath], like)``."""
    if isinstance(like, dict):
        return {k: _fill(v, flat, leaf, f"{prefix}{KEYPATH_SEP}{k}"
                         if prefix else str(k)) for k, v in like.items()}
    if isinstance(like, list):
        return [_fill(v, flat, leaf, f"{prefix}{KEYPATH_SEP}{i}"
                      if prefix else str(i)) for i, v in enumerate(like)]
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


def save_model(net, directory: os.PathLike, *, save_updater: bool = False
               ) -> pathlib.Path:
    """Write `conf.json` + `params.npz` (+ `updater.npz` when
    `save_updater=True` and the net has updater state) + `meta.json`."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "conf.json").write_text(net.conf.to_json())
    tree_to_npz(directory / "params.npz", net.params)
    if save_updater and net.updater_state is not None:
        tree_to_npz(directory / "updater.npz", net.updater_state)
    policy = net.precision
    meta = {"format": 1, "num_params": int(net.num_params()),
            "saved_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "param_dtype": policy.param_dtype,
            "precision": {"param_dtype": policy.param_dtype,
                          "compute_dtype": policy.compute_dtype,
                          "output_dtype": policy.output_dtype}}
    (directory / "meta.json").write_text(json.dumps(meta, indent=2))
    return directory


def load_model(directory: os.PathLike, device=None):
    """Rebuild a `MultiLayerNetwork` on `device` from a directory written
    by `save_model` in either package; restores the updater state too when
    `updater.npz` is present.  A precision policy recorded in meta.json
    that the conf does not declare (a net whose precision `set_precision`
    replaced) is adopted through `set_precision`, so the net comes back
    at its live dtypes; the loss-scale config is training-only and not
    saved (``fit(precision=...)`` turns it on again)."""
    import dataclasses

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.precision import resolve_policy

    directory = pathlib.Path(directory)
    net = MultiLayerNetwork.from_json((directory / "conf.json").read_text(),
                                      device=device)
    meta_path = directory / "meta.json"
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        saved = meta.get("precision")
        if saved is None and meta.get("param_dtype") is not None:
            saved = {"param_dtype": meta["param_dtype"]}  # older meta
        if saved is not None:
            policy = dataclasses.replace(
                resolve_policy(None, net.conf.conf), **saved)
            if policy != net.precision:
                net.set_precision(policy)
    net.params = map_tree(
        lambda p: p.requires_grad_(p.is_floating_point()),
        npz_to_tree(directory / "params.npz", net.params))
    if (directory / "updater.npz").exists():
        net.updater_state = npz_to_tree(directory / "updater.npz",
                                        net.updater_state)
    return net


def _params_meta_path(path: pathlib.Path) -> pathlib.Path:
    return path.with_name(path.name + ".meta.json")


def save_params(net, path: os.PathLike, mode: str = "binary") -> None:
    """The flat parameter vector (`params_flat`, float32) as a file (CLI
    parity: Nd4j.write / writeTxt).  ``binary``: raw values plus a
    ``<file>.meta.json`` sidecar ``{format, dtype, count}``; ``txt``: one
    value a line under a ``# dtype: float32`` header.  Either loads in
    the JAX package's `load_params`."""
    vec = net.params_flat()
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if mode == "binary":
        vec.tofile(path)
        _params_meta_path(path).write_text(json.dumps(
            {"format": 1, "dtype": str(vec.dtype), "count": int(vec.size)}))
    elif mode == "txt":
        np.savetxt(path, vec, header=f"dtype: {vec.dtype}")
    else:
        raise ValueError(f"unknown savemode {mode!r} (binary|txt)")


def load_params(net, path: os.PathLike, mode: str = "binary") -> None:
    """Restore a flat parameter file written by either package's
    `save_params`.  A binary file takes the dtype its sidecar records
    (float32 without one); bfloat16 values are widened to float32, which
    is exact.  The values are cast to each leaf's dtype."""
    path = pathlib.Path(path)
    if mode == "binary":
        dtype = "float32"
        meta_path = _params_meta_path(path)
        if meta_path.exists():
            try:
                dtype = json.loads(meta_path.read_text())["dtype"]
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(
                    f"corrupt params meta sidecar {meta_path}: {e}") from e
        if dtype == "bfloat16":
            bits = np.fromfile(path, dtype=np.uint16).astype(np.uint32)
            vec = (bits << 16).view(np.float32)
        else:
            vec = np.fromfile(path, dtype=np.dtype(dtype))
    elif mode == "txt":
        vec = np.loadtxt(path, dtype=np.float32).reshape(-1)
    else:
        raise ValueError(f"unknown savemode {mode!r} (binary|txt)")
    net.set_params_flat(vec)


__all__ = ["load_model", "load_params", "npz_to_tree", "read_lm_npz",
           "save_model", "save_params", "tree_to_npz"]
