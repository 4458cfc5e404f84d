"""Checkpoint and model serialization (counterpart of
`deeplearning4j_tpu.runtime.checkpoint`).

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

Train-state checkpoints (params + updater state + layer state + step)
are the JAX package's sharded snapshots: under ``ckpt-{step}/`` each tree
split into per-replica shard files (``params.s00000-of-00001.npz``, ...)
plus a ``MANIFEST.json`` recording the topology, a SHA-256 per shard
file and the step, with ``meta.json`` and a ``COMMIT`` marker, and a
directory-level ``manifest.json`` for retention (keep-last-K and the
best score).  The write is a two-phase commit: everything lands in a
``.tmp-ckpt-*`` staging directory, is fsync'd, COMMIT-marked and then
atomically renamed into place, so a kill -9 at any byte leaves the
previous or the new checkpoint loadable, never a torn one.  Loads verify
the recorded checksums and raise a typed `CheckpointCorruptError`; the
newest-first loader skips corrupt steps (logging which and why) and
falls back to the previous good one.  Either package loads the other's
checkpoints, at any shard count the JAX package writes.

A job of several processes (`runtime.launcher.initialize_multihost`)
writes the JAX package's v1 per-host layout instead: every process its
own ``params.proc{index:05d}.npz`` (and ``updater`` / ``state``), then a
barrier, then ``meta.json`` (``"processes"``) and ``COMMIT`` from
process 0, then a second barrier; each process loads its own file back.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pathlib
import re
import shutil
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel import partition
from deeplearning4j_tpu_torch.parallel.mesh import (
    process_count,
    process_index,
    sync_processes,
)
from deeplearning4j_tpu_torch.tree import KEYPATH_SEP, flatten_tree, map_tree

PyTree = Any

log = logging.getLogger(__name__)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint (shard file, per-checkpoint MANIFEST, or the
    directory's retention manifest) is corrupted, truncated, or
    missing pieces.  Typed so recovery paths can catch it and fall back
    to the previous good step instead of matching on raw
    zipfile/np.load exceptions."""

    def __init__(self, message: str, *, path=None, step=None):
        super().__init__(message)
        self.path = path
        self.step = step


def _check_integrity(path, size: int, digest: str, expected: dict,
                     step=None) -> None:
    """ONE size/SHA-256 comparison against a manifest entry — shared by
    the verify pass (`_verify_files`) and the load-on-same-read path
    (`_load_npz_arrays`), so the same defect reports identically from
    either."""
    name = pathlib.Path(path).name
    if expected.get("bytes") is not None and size != expected["bytes"]:
        raise CheckpointCorruptError(
            f"shard {name} truncated: {size} bytes on disk, manifest "
            f"records {expected['bytes']}", path=path, step=step)
    if digest != expected.get("sha256"):
        raise CheckpointCorruptError(
            f"shard {name} checksum mismatch (bit rot or torn write): "
            f"{digest[:12]}... != recorded "
            f"{str(expected.get('sha256'))[:12]}...", path=path,
            step=step)


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
    _atomic_savez(path, _flatten_with_paths(tree))


def _load_npz(path: os.PathLike) -> Dict[str, np.ndarray]:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def _load_npz_arrays(path: os.PathLike,
                     expected: Optional[dict] = None
                     ) -> Dict[str, np.ndarray]:
    """np.load with the failure modes typed: a truncated or bit-rotted
    npz surfaces as `CheckpointCorruptError`, never a raw
    zipfile.BadZipFile / OSError / ValueError from inside numpy.

    With `expected` ({sha256, bytes} from a checkpoint manifest), the
    file is read ONCE: size and SHA-256 are checked on the same bytes
    np.load then parses — no separate verification read."""
    import io
    import zipfile

    path = pathlib.Path(path)
    try:
        data = path.read_bytes()
    except OSError as e:
        raise CheckpointCorruptError(
            f"unreadable array file {path}: {type(e).__name__}: {e}",
            path=path) from e
    if expected is not None:
        _check_integrity(path, len(data),
                         hashlib.sha256(data).hexdigest(), expected)
    try:
        with np.load(io.BytesIO(data)) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(
            f"unreadable array file {path}: {type(e).__name__}: {e}",
            path=path) from e


def _restore_leaf(a, ref):
    """One stored array in the dtype (and, for a tensor, on the device)
    of the template leaf `ref`."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(a)).to(device=ref.device,
                                                dtype=ref.dtype)
    return np.asarray(a, dtype=np.asarray(ref).dtype)


def npz_to_tree(path: os.PathLike, like):
    """Restore `path` into the structure of `like` (keypath-matched):
    a tensor leaf of `like` gives a tensor of its dtype on its device, any
    other leaf a numpy array of its dtype."""
    return _fill(like, _load_npz(path), _restore_leaf)


def _match_into_like(arrays: Dict[str, np.ndarray], like: PyTree,
                     origin) -> PyTree:
    """`npz_to_tree`'s restore from arrays already read, a missing leaf
    typed: the newest-first fallback loop must be able to skip a
    checkpoint saved from another model revision."""
    try:
        return _fill(like, arrays, _restore_leaf)
    except KeyError as e:
        raise CheckpointCorruptError(
            f"checkpoint {origin}: {e.args[0]}", path=origin) from e


def _flatten_with_paths(tree: PyTree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in flatten_tree(tree).items()}


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


def published_updater_state(net):
    """The network's updater state, published first by a live ZeRO-1
    trainer: `DataParallelTrainer` owns the sharded moments while it runs
    and clears ``net.updater_state``, registering itself as
    ``net._updater_state_owner``; every save path reads through here, so
    a mid-run save keeps the trained moments without a `finalize`."""
    owner = getattr(net, "_updater_state_owner", None)
    if owner is not None:
        owner.sync_updater_state_to_net()
    return getattr(net, "updater_state", None)


def save_model(net, directory: os.PathLike, *, save_updater: bool = False
               ) -> pathlib.Path:
    """Write `conf.json` + `params.npz` (+ `updater.npz` when
    `save_updater=True` and the net has updater state) + `meta.json`."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "conf.json").write_text(net.conf.to_json())
    tree_to_npz(directory / "params.npz", net.params)
    upd = published_updater_state(net) if save_updater else None
    if upd is not None:
        tree_to_npz(directory / "updater.npz", upd)
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


# --------------------------------------------------------------------------
# Train-state checkpoints (params + updater state + step)
#
# One process (which includes every multi-device mesh of one process):
# the sharded v2 format with two-phase atomic commit.  A job of several
# processes (a `torch.distributed` group of world size > 1): the JAX
# package's v1 per-host format — every process writes its own
# ``params.proc{index:05d}.npz`` (and ``updater`` / ``state``), a
# barrier, process 0 alone writes ``meta.json``, ``COMMIT`` and the
# retention, a second barrier.  A staging-dir rename cannot span
# processes, so there the COMMIT marker is the commit.

def _host_suffix() -> str:
    """This process's v1 shard-file suffix: ``proc{index:05d}``, process 0
    in a one-process job."""
    return f"proc{process_index():05d}"


_TMP_PREFIX = ".tmp-ckpt-"
_ORPHAN_AGE_S = 60.0
# Staging dirs THIS process is actively writing — the orphan sweep must
# never reap a live write (cross-process leftovers are age-gated).
_ACTIVE_TMP: set = set()

_PHASE_HOOK = None


def set_phase_hook(hook):
    """Install `hook(phase: str, path)` fired between the single-host
    writer's durability phases (`begin`, `shard:<file>`, `meta`,
    `manifest`, `commit_marker`, `committed`), and in a job of several
    processes after each of this process's files (`shard:<file>`) and,
    on process 0, after the COMMIT marker (`committed`).  The chaos
    harness uses it to simulate kill -9 at every commit boundary and
    tests use it to snapshot intermediate directory states.  Returns the
    previous hook; pass None to uninstall."""
    global _PHASE_HOOK
    prev = _PHASE_HOOK
    _PHASE_HOOK = hook
    return prev


def _phase(name: str, path=None) -> None:
    hook = _PHASE_HOOK
    if hook is not None:
        hook(name, path)


def _fsync_path(path: os.PathLike) -> None:
    """fsync a file or directory by path (directory fsync makes the
    rename/creat durable on POSIX)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _file_sha256(path: os.PathLike) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _split_flat(flat: Dict[str, np.ndarray], n: int):
    """Split a flat keypath->array dict into `n` per-replica shard dicts
    (dim-0, padded-remainder) plus the per-leaf metadata the manifest
    records (true shape/dtype/split dim) so joins are bitwise exact."""
    shards: List[dict] = [{} for _ in range(n)]
    leaves: Dict[str, dict] = {}
    for key, arr in flat.items():
        if arr.ndim == 0 or n == 1:
            shards[0][key] = arr
            dim = None
        else:
            dim = 0
            for i, piece in enumerate(partition.split_leaf(arr, n, dim)):
                shards[i][key] = piece
        leaves[key] = {"shape": [int(s) for s in arr.shape],
                       "dtype": str(arr.dtype), "dim": dim}
    return shards, leaves


_RETIRED_RE = re.compile(rf"{re.escape(_TMP_PREFIX)}retired-(\d+)-.*")


def _rescue_retired(directory: pathlib.Path) -> None:
    """Heal the crash window between a re-save's two renames: the old
    copy of step N was moved aside (`.tmp-ckpt-retired-N-*`, still a
    COMPLETE committed checkpoint) and the new one never renamed in.
    Rename the retired copy back so the step stays loadable — called
    from the discovery path (`_committed_steps`) so even the FIRST load
    after the crash sees it, not just the next save's sweep.  The
    writer tolerates losing the race (its second rename retries over a
    rescued copy)."""
    try:
        children = list(directory.iterdir())
    except OSError:
        return
    for child in children:
        m = _RETIRED_RE.fullmatch(child.name)
        if m is None or not child.is_dir():
            continue
        final = directory / f"ckpt-{m.group(1)}"
        if not final.exists() and (child / "COMMIT").exists():
            try:
                os.rename(child, final)
                log.warning("rescued retired copy of checkpoint step %s "
                            "interrupted mid-re-save", m.group(1))
            except OSError:
                continue  # racing writer/reader; whoever wins is fine


def sweep_orphans(directory: os.PathLike,
                  age_s: float = _ORPHAN_AGE_S) -> List[str]:
    """Reap checkpoint debris a crash left behind: stale `.tmp-ckpt-*`
    staging dirs (not actively written by this process), uncommitted
    `ckpt-N` dirs (shards written, COMMIT never landed — the pre-v2
    crash window), and stray mkstemp leftovers (`tmp*.npz`,
    `*.manifest`).  Everything is age-gated (`age_s` since last mtime)
    so a concurrent writer in another process is never raced.  Returns
    the removed names; called by `save_checkpoint` on every save so
    orphans cannot accumulate forever."""
    directory = pathlib.Path(directory)
    if not directory.exists():
        return []
    _rescue_retired(directory)   # rescue BEFORE reaping, never after
    removed: List[str] = []
    now = time.time()
    for child in directory.iterdir():
        try:
            st = child.stat()
        except OSError:
            continue  # racing unlink
        if now - st.st_mtime < age_s:
            continue
        name = child.name
        retired = _RETIRED_RE.fullmatch(name)
        if (retired is not None and child.is_dir()
                and (child / "COMMIT").exists()
                and not (directory / f"ckpt-{retired.group(1)}").exists()):
            # sole surviving copy of its step (a re-saver died between
            # its two renames AFTER this sweep's rescue pass ran, or
            # rescue lost a rename race): never reap — the next
            # load/sweep rescues it.  Note the rename-aside preserves
            # the old dir's mtime, so the age gate alone cannot protect
            # this case.
            continue
        is_stale_tmp = (name.startswith(_TMP_PREFIX)
                        and str(child) not in _ACTIVE_TMP)
        is_uncommitted = (child.is_dir()
                          and re.fullmatch(r"ckpt-(\d+)", name) is not None
                          and not (child / "COMMIT").exists())
        is_stray = (child.is_file()
                    and (name.endswith(".manifest")
                         or (name.startswith("tmp")
                             and name.endswith(".npz"))))
        if not (is_stale_tmp or is_uncommitted or is_stray):
            continue
        try:
            if child.is_dir():
                shutil.rmtree(child)
            else:
                child.unlink()
            removed.append(name)
        except OSError:
            continue  # racing writer/sweeper; next save retries
    if removed:
        log.warning("checkpoint GC swept %d orphan(s) under %s: %s",
                    len(removed), directory, ", ".join(sorted(removed)))
    return removed


def _spec_as_tree_map(spec) -> Dict[str, Any]:
    """`save_checkpoint`'s `spec` as a {tree_name: spec} map: a dict keyed
    by tree names maps through; anything else is the params tree's."""
    if spec is None:
        return {}
    if isinstance(spec, dict) and spec and set(spec) <= {"params",
                                                         "updater",
                                                         "state"}:
        return dict(spec)
    return {"params": spec}


def save_checkpoint(directory: os.PathLike, step: int, params: PyTree,
                    updater_state: Optional[PyTree] = None,
                    extra: Optional[dict] = None,
                    keep: int = 3, score: Optional[float] = None,
                    keep_best: bool = True,
                    net_state: Optional[PyTree] = None,
                    spec=None, shards: Optional[int] = None
                    ) -> pathlib.Path:
    """Write checkpoint `step` under `directory/ckpt-{step}/` as a
    sharded snapshot: each tree (params / updater / net state) split
    into `shards` per-replica files (dim 0, the remainder padded) plus a
    `MANIFEST.json` recording the topology, per-shard SHA-256s, the
    partition `spec` (`parallel/partition.py`: how each leaf relates to
    the replica axis) and the step — the JAX package's layout, so either package loads the
    other's checkpoints.  The write is two-phase: staged in a
    `.tmp-ckpt-*` dir, fsync'd, COMMIT-marked, then atomically renamed
    into place, so a kill -9 at any point leaves the previous
    checkpoint intact and loadable.  Retains the newest `keep`
    checkpoints; with a `score` (a loss — lower is better) the
    directory manifest tracks the best-scoring checkpoint and
    `keep_best=True` protects it from GC even when it falls out of the
    newest-`keep` window.  `net_state` additionally persists
    non-parameter layer state (batch-norm running stats) — the
    resilience supervisor saves it so rollback/resume can't revive
    poisoned or stale statistics.

    In a job of several processes every process calls this with its
    (whole) trees: each writes its own per-host files and process 0
    commits after a barrier (`_save_multi_host`); `shards` and `spec`
    are ignored there, as in the JAX package."""
    directory = pathlib.Path(directory)
    ckpt = directory / f"ckpt-{step}"
    if process_count() > 1:
        return _save_multi_host(directory, ckpt, step, params,
                                updater_state, net_state, extra, keep,
                                score, keep_best)
    directory.mkdir(parents=True, exist_ok=True)
    # (orphan sweeping happens once per save, inside _gc_checkpoints)
    retention = _manifest_for_update(directory)
    n = max(1, int(shards or 1))
    _phase("begin", directory)
    tmp = pathlib.Path(tempfile.mkdtemp(
        prefix=f"{_TMP_PREFIX}{int(step)}-", dir=directory))
    _ACTIVE_TMP.add(str(tmp))
    try:
        manifest: dict = {
            "format": 2, "step": int(step),
            "topology": {"shards": n, "processes": 1},
            "trees": {}, "files": {},
            "partition": {name: partition.spec_to_json(sp)
                          for name, sp in _spec_as_tree_map(spec).items()},
            "saved_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        trees = {"params": params}
        if updater_state is not None:
            trees["updater"] = updater_state
        if net_state is not None:
            trees["state"] = net_state
        import io

        for name, tree in trees.items():
            shard_dicts, leaves = _split_flat(_flatten_with_paths(tree), n)
            files = []
            for i, sd in enumerate(shard_dicts):
                fname = f"{name}.s{i:05d}-of-{n:05d}.npz"
                # serialize to a buffer so the recorded hash comes from
                # the SAME bytes in one pass (no write-then-re-read)
                buf = io.BytesIO()
                np.savez(buf, **sd)
                data = buf.getvalue()
                (tmp / fname).write_bytes(data)
                _fsync_path(tmp / fname)
                manifest["files"][fname] = {
                    "sha256": hashlib.sha256(data).hexdigest(),
                    "bytes": len(data)}
                files.append(fname)
                _phase(f"shard:{fname}", tmp)
            manifest["trees"][name] = {"files": files, "leaves": leaves}
        meta = _ckpt_meta(step, extra, score)
        (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
        _fsync_path(tmp / "meta.json")
        _phase("meta", tmp)
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))
        _fsync_path(tmp / "MANIFEST.json")
        _phase("manifest", tmp)
        # COMMIT last inside the staging dir: v1 readers (and the remote
        # mirror) key committedness on this marker, and it only becomes
        # visible with the atomic rename below anyway.
        (tmp / "COMMIT").write_text("ok")
        _fsync_path(tmp / "COMMIT")
        _phase("commit_marker", tmp)
        _fsync_path(tmp)
        retired = None
        if ckpt.exists():
            # Re-save of the same step: rename the old copy ASIDE (never
            # rmtree-then-rename — a crash in that window would destroy
            # the only copy of the step).  The aside name carries the
            # tmp prefix; a crash between the two renames is healed by
            # `_rescue_retired` on the very next load or save.
            retired = pathlib.Path(tempfile.mkdtemp(
                prefix=f"{_TMP_PREFIX}retired-{int(step)}-",
                dir=directory))
            os.rmdir(retired)
            os.rename(ckpt, retired)
        try:
            os.rename(tmp, ckpt)
        except OSError:
            if retired is None or not ckpt.exists():
                raise
            # a concurrent reader's `_rescue_retired` renamed the old
            # copy back into place mid-window; retire it AGAIN (never
            # rmtree — that reopens the destroy-the-only-copy crash
            # window) and move the new save in
            retired = pathlib.Path(tempfile.mkdtemp(
                prefix=f"{_TMP_PREFIX}retired-{int(step)}-",
                dir=directory))
            os.rmdir(retired)
            os.rename(ckpt, retired)
            os.rename(tmp, ckpt)
        _fsync_path(directory)
        if retired is not None:
            shutil.rmtree(retired, ignore_errors=True)
    finally:
        _ACTIVE_TMP.discard(str(tmp))
    _phase("committed", ckpt)
    _update_retention(directory, step, meta, score, keep, keep_best,
                      retention)
    return ckpt


def _save_multi_host(directory: pathlib.Path, ckpt: pathlib.Path,
                     step: int, params: PyTree,
                     updater_state: Optional[PyTree],
                     net_state: Optional[PyTree], extra: Optional[dict],
                     keep: int, score: Optional[float],
                     keep_best: bool) -> pathlib.Path:
    """The JAX package's multi-host writer: this process's files
    (`_host_suffix`), the ``written`` barrier (every process's files are
    on disk before anyone commits), process 0 alone writes ``meta.json``
    and ``COMMIT`` and runs the retention and GC, the ``committed``
    barrier.  A process that dies before the first barrier fails its
    peers there (at the group's timeout at the latest), so no COMMIT
    appears and `latest_checkpoint` keeps the previous step."""
    ckpt.mkdir(parents=True, exist_ok=True)
    for name, tree in (("params", params), ("updater", updater_state),
                       ("state", net_state)):
        if tree is not None:
            fname = f"{name}.{_host_suffix()}.npz"
            tree_to_npz(ckpt / fname, tree)
            _phase(f"shard:{fname}", ckpt)
    sync_processes(f"ckpt-{step}-written")
    if process_index() == 0:
        # read the retention state BEFORE committing: after the marker
        # lands, a missing manifest would read as corruption
        retention = _manifest_for_update(directory)
        meta = _ckpt_meta(step, extra, score)
        (ckpt / "meta.json").write_text(json.dumps(meta, indent=2))
        (ckpt / "COMMIT").write_text("ok")
        _phase("committed", ckpt)
        _update_retention(directory, step, meta, score, keep, keep_best,
                          retention)
    sync_processes(f"ckpt-{step}-committed")
    return ckpt


def _ckpt_meta(step: int, extra: Optional[dict],
               score: Optional[float]) -> dict:
    meta = {"step": int(step), "processes": process_count(),
            "extra": extra or {},
            "saved_at": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if score is not None:
        meta["score"] = float(score)
    return meta


def _update_retention(directory: pathlib.Path, step: int, meta: dict,
                      score: Optional[float], keep: int,
                      keep_best: bool,
                      manifest: Optional[dict] = None) -> None:
    if manifest is None:
        manifest = _manifest_for_update(directory)
    entry = {"saved_at": meta["saved_at"]}
    if score is not None:
        entry["score"] = float(score)
    manifest["entries"][str(int(step))] = entry
    best = _best_step(manifest)
    manifest["best_step"] = best
    protect = frozenset({best}) if (keep_best and best is not None) \
        else frozenset()
    removed = _gc_checkpoints(directory, keep, protect=protect)
    for s in removed:
        manifest["entries"].pop(str(s), None)
    _write_manifest(directory, manifest)


# --------------------------------------------------------------------------
# Retention manifest: per-step scores + the best-scoring checkpoint

def _committed_steps(directory: pathlib.Path) -> List[Tuple[int,
                                                            pathlib.Path]]:
    """(step, path) for every committed checkpoint, ascending by step."""
    out = []
    if not directory.exists():
        return out
    _rescue_retired(directory)
    for child in directory.iterdir():
        m = re.fullmatch(r"ckpt-(\d+)", child.name)
        if m and (child / "COMMIT").exists():
            out.append((int(m.group(1)), child))
    return sorted(out)


def read_manifest(directory: os.PathLike) -> dict:
    """The directory's retention manifest ({entries: {step: {score,
    saved_at}}, best_step}).

    Never guessed at: a CORRUPT (unparseable) manifest with committed
    checkpoints present is REFUSED with a typed `CheckpointCorruptError`
    naming the recovery path, `rebuild_manifest` — an empty guess would
    forget `best_step`, and the very next save's GC would then delete
    the best-scoring checkpoint the manifest was protecting.  A MISSING
    manifest with committed checkpoints present is the (tiny) crash
    window between a first save's atomic rename and its retention
    write, so it is reconstructed in memory — losslessly, from the
    per-checkpoint metadata, NOT guessed — with a warning.  A genuinely
    fresh directory (no committed checkpoints) returns an empty
    manifest."""
    directory = pathlib.Path(directory)
    path = directory / "manifest.json"
    empty = {"format": 1, "entries": {}, "best_step": None}
    if not path.exists():
        if _committed_steps(directory):
            log.warning(
                "retention manifest %s is missing but committed "
                "checkpoints exist (crash between commit and retention "
                "write, or external deletion); reconstructing from the "
                "per-checkpoint metadata", path)
            return _reconstruct_manifest(directory)
        return empty
    try:
        m = json.loads(path.read_text())
        if not isinstance(m.get("entries"), dict):
            raise ValueError("'entries' is not a mapping")
    except (OSError, json.JSONDecodeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"retention manifest {path} is corrupt ({e}); refusing to "
            f"guess retention state — run deeplearning4j_tpu_torch.runtime."
            f"checkpoint.rebuild_manifest({str(directory)!r}) to "
            f"reconstruct it from the per-checkpoint metadata",
            path=path) from e
    return m


def _reconstruct_manifest(directory: pathlib.Path) -> dict:
    """The retention manifest recomputed (in memory, no write) from the
    per-checkpoint metadata — lossless: each committed `ckpt-N/meta.json`
    records its own score and save time."""
    manifest = {"format": 1, "entries": {}, "best_step": None,
                "rebuilt_at": time.strftime("%Y-%m-%dT%H:%M:%S")}
    for step, ckpt in _committed_steps(directory):
        try:
            meta = json.loads((ckpt / "meta.json").read_text())
        except (OSError, json.JSONDecodeError) as e:
            log.warning("manifest rebuild: skipping %s (unreadable "
                        "meta.json: %s)", ckpt.name, e)
            continue
        entry = {"saved_at": meta.get("saved_at")}
        if meta.get("score") is not None:
            entry["score"] = float(meta["score"])
        manifest["entries"][str(step)] = entry
    manifest["best_step"] = _best_step(manifest)
    return manifest


def rebuild_manifest(directory: os.PathLike) -> dict:
    """Reconstruct the retention manifest from the per-checkpoint
    metadata — the recovery path `read_manifest` names when the
    directory-level `manifest.json` is corrupt.  Writes the rebuilt
    manifest and returns it."""
    directory = pathlib.Path(directory)
    manifest = _reconstruct_manifest(directory)
    _write_manifest(directory, manifest)
    return manifest


def _manifest_for_update(directory: pathlib.Path) -> dict:
    """The retention manifest for a writer about to update it —
    auto-recovers (rebuild, with a warning) where the read path refuses,
    because a save must not wedge on a deleted manifest when the
    per-checkpoint metadata can reconstruct it exactly."""
    try:
        return read_manifest(directory)
    except CheckpointCorruptError as e:
        log.warning("retention manifest unreadable (%s); rebuilding from "
                    "per-checkpoint metadata", e)
        return rebuild_manifest(directory)


def _write_manifest(directory: pathlib.Path, manifest: dict) -> None:
    path = directory / "manifest.json"
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".manifest")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(manifest, indent=2))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _best_step(manifest: dict) -> Optional[int]:
    scored = [(e["score"], int(s)) for s, e in manifest["entries"].items()
              if isinstance(e, dict) and "score" in e]
    if not scored:
        return None
    # lowest loss wins; newest breaks ties
    return min(scored, key=lambda t: (t[0], -t[1]))[1]


def _scored_candidates(directory: pathlib.Path) -> List[pathlib.Path]:
    """Committed checkpoints ordered best-score-first (newest breaks
    ties) — THE score ladder, shared by `best_checkpoint` and
    `load_checkpoint(step="best")` so both settle identically."""
    manifest = read_manifest(directory)
    scored = sorted(
        ((e["score"], -int(s)) for s, e in manifest["entries"].items()
         if isinstance(e, dict) and "score" in e))
    out = []
    for _score, neg_step in scored:
        ckpt = directory / f"ckpt-{-neg_step}"
        if (ckpt / "COMMIT").exists():
            out.append(ckpt)
    return out


def best_checkpoint(directory: os.PathLike) -> Optional[pathlib.Path]:
    """The committed, INTEGRITY-VERIFIED checkpoint with the best
    (lowest) recorded score; corrupt candidates are skipped (logging
    which step was rejected and why) in favor of the next-best scored
    step.  None when no loadable scored checkpoint exists."""
    directory = pathlib.Path(directory)
    for ckpt in _scored_candidates(directory):
        try:
            verify_checkpoint(ckpt)
        except CheckpointCorruptError as e:
            log.warning("best_checkpoint: %s rejected: %s", ckpt.name, e)
            continue
        return ckpt
    return None


# --------------------------------------------------------------------------
# loading (checksum-verified, corrupt-step fallback)

def read_ckpt_manifest(ckpt: os.PathLike) -> Optional[dict]:
    """One checkpoint's `MANIFEST.json` (topology, partition spec,
    per-shard hashes); None for a v1 per-host checkpoint that predates
    the sharded format.  Unparseable manifests raise
    `CheckpointCorruptError`."""
    ckpt = pathlib.Path(ckpt)
    path = ckpt / "MANIFEST.json"
    if not path.exists():
        return None
    try:
        m = json.loads(path.read_text())
        if not isinstance(m.get("trees"), dict) or "step" not in m:
            raise ValueError("missing 'trees'/'step'")
    except (OSError, json.JSONDecodeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest {path}: {e}", path=path) from e
    return m


def _verify_files(ckpt: pathlib.Path, manifest: dict,
                  skip: frozenset = frozenset()) -> None:
    """Size + SHA-256 check of every manifest-listed file not in `skip`
    (files being loaded right now verify on their single read instead —
    see `_load_npz_arrays(expected=)`)."""
    for fname, info in manifest.get("files", {}).items():
        if fname in skip:
            continue
        path = ckpt / fname
        if not path.exists():
            raise CheckpointCorruptError(
                f"shard {fname} listed in {ckpt.name}/MANIFEST.json is "
                f"missing", path=path, step=manifest.get("step"))
        _check_integrity(path, path.stat().st_size, _file_sha256(path),
                         info, step=manifest.get("step"))


def verify_checkpoint(ckpt: os.PathLike) -> Optional[dict]:
    """Integrity check one committed checkpoint: every file the manifest
    records must exist with the recorded size and SHA-256 (a flipped
    byte or truncated shard is detected HERE, before any np.load).
    Returns the parsed manifest (None for v1 checkpoints, which carry
    no hashes — their integrity check is the np.load itself).  Raises
    `CheckpointCorruptError` on any mismatch."""
    ckpt = pathlib.Path(ckpt)
    if not (ckpt / "COMMIT").exists():
        raise CheckpointCorruptError(
            f"{ckpt} has no COMMIT marker (partial write)", path=ckpt)
    manifest = read_ckpt_manifest(ckpt)
    if manifest is None:
        if not list(ckpt.glob("params.*.npz")):
            raise CheckpointCorruptError(
                f"{ckpt} has no params shard files", path=ckpt)
        return None
    _verify_files(ckpt, manifest)
    return manifest


def _join_tree_v2(ckpt: pathlib.Path, manifest: dict, name: str,
                  like: PyTree, check: bool = False) -> Optional[PyTree]:
    """Join one tree's shard files back into the structure of `like`
    (bitwise: padding stripped via the manifest's recorded true
    shapes).  `check=True` verifies each shard's recorded size and
    SHA-256 on the same single read that loads it."""
    info = manifest["trees"].get(name)
    if info is None:
        return None
    files_meta = manifest.get("files", {})
    shard_arrays = [
        _load_npz_arrays(ckpt / fname,
                         files_meta.get(fname) if check else None)
        for fname in info["files"]]
    full: Dict[str, np.ndarray] = {}
    for key, lm in info["leaves"].items():
        try:
            if lm["dim"] is None:
                full[key] = shard_arrays[0][key]
            else:
                pieces = [sd[key] for sd in shard_arrays]
                full[key] = partition.join_leaf(
                    pieces, lm["dim"], lm["shape"][lm["dim"]])
        except KeyError as e:
            raise CheckpointCorruptError(
                f"shard files of {ckpt.name}/{name} are missing leaf "
                f"{key!r}", path=ckpt, step=manifest.get("step")) from e
    return _match_into_like(full, like, f"{ckpt.name}/{name}")


def load_net_state(ckpt: os.PathLike, like: PyTree) -> Optional[PyTree]:
    """Layer state (batch-norm running stats) from a checkpoint dir, in
    the structure of `like`; None when the checkpoint predates net_state
    or none was saved."""
    ckpt = pathlib.Path(ckpt)
    manifest = read_ckpt_manifest(ckpt)
    if manifest is not None:
        # check=True: the state shards hash-verify on this read (a
        # caller's earlier verify pass does not protect THIS read)
        return _join_tree_v2(ckpt, manifest, "state", like, check=True)
    path = ckpt / f"state.{_host_suffix()}.npz"
    if not path.exists():
        return None
    return npz_to_tree(path, like)


def latest_checkpoint(directory: os.PathLike) -> Optional[pathlib.Path]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    committed = _committed_steps(directory)
    return committed[-1][1] if committed else None


def _load_one(ckpt: pathlib.Path, params_like: PyTree,
              updater_like: Optional[PyTree], verify: bool
              ) -> Tuple[int, PyTree, Optional[PyTree], dict]:
    try:
        return _load_one_impl(ckpt, params_like, updater_like, verify)
    except KeyError as e:
        # malformed metadata (a meta.json without 'step', a manifest
        # tree without 'files'/'leaves') must be TYPED so the fallback
        # ladder can skip past it to the previous good step
        raise CheckpointCorruptError(
            f"malformed checkpoint metadata in {ckpt.name}: missing "
            f"key {e}", path=ckpt) from e


def _load_one_impl(ckpt: pathlib.Path, params_like: PyTree,
                   updater_like: Optional[PyTree], verify: bool
                   ) -> Tuple[int, PyTree, Optional[PyTree], dict]:
    if verify and not (ckpt / "COMMIT").exists():
        raise CheckpointCorruptError(
            f"{ckpt} has no COMMIT marker (partial write)", path=ckpt)
    manifest = read_ckpt_manifest(ckpt)
    try:
        meta = json.loads((ckpt / "meta.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"unreadable meta.json in {ckpt}: {e}", path=ckpt) from e
    if manifest is not None:
        # trees being restored hash-verify on their single load read;
        # the REST of the manifest's files (e.g. the state tree when no
        # template asked for it) are verified separately, so the whole
        # checkpoint is still vouched for without double IO
        params = _join_tree_v2(ckpt, manifest, "params", params_like,
                               check=verify)
        if params is None:
            raise CheckpointCorruptError(
                f"{ckpt.name}/MANIFEST.json lists no params tree",
                path=ckpt, step=manifest.get("step"))
        loaded = set(manifest["trees"]["params"]["files"])
        upd = None
        if updater_like is not None:
            upd = _join_tree_v2(ckpt, manifest, "updater", updater_like,
                                check=verify)
            if upd is not None:
                loaded |= set(manifest["trees"]["updater"]["files"])
        if verify:
            _verify_files(ckpt, manifest, skip=frozenset(loaded))
    else:  # v1 per-host format (no recorded hashes)
        if verify and not list(ckpt.glob("params.*.npz")):
            raise CheckpointCorruptError(
                f"{ckpt} has no params shard files", path=ckpt)
        params = npz_to_tree(ckpt / f"params.{_host_suffix()}.npz",
                             params_like)
        upd = None
        upd_path = ckpt / f"updater.{_host_suffix()}.npz"
        if updater_like is not None and upd_path.exists():
            upd = npz_to_tree(upd_path, updater_like)
    return meta["step"], params, upd, meta.get("extra", {})


def load_checkpoint(directory: os.PathLike, params_like: PyTree,
                    updater_like: Optional[PyTree] = None,
                    step: Optional[int] = None, verify: bool = True
                    ) -> Tuple[int, PyTree, Optional[PyTree], dict]:
    """Returns (step, params, updater_state, extra). With `step=None`,
    restores the newest committed checkpoint, SKIPPING corrupt ones —
    each rejected step is logged with the reason, and the previous good
    step loads instead, so a flipped byte or truncated shard costs one
    checkpoint interval, not the run.  `step="best"` restores the
    best-scoring loadable one per the retention manifest; an explicit
    integer `step` loads exactly that step or raises (the caller named
    a specific state — falling back silently would lie).  `verify=True`
    (default) checks every shard's recorded SHA-256 before reading it.

    Raises `FileNotFoundError` when no committed checkpoint exists, and
    `CheckpointCorruptError` when checkpoints exist but none is
    loadable."""
    directory = pathlib.Path(directory)
    if step == "best":
        # the shared score ladder through the SAME skip-and-log loop
        # below: each candidate is verified exactly once, and a best
        # candidate that fails at LOAD time (a v1 checkpoint carries no
        # hashes for verify to catch first) still falls down the ladder
        candidates = _scored_candidates(directory)
    elif step is not None:
        ckpt = directory / f"ckpt-{step}"
        if not ckpt.exists() or not (ckpt / "COMMIT").exists():
            raise FileNotFoundError(
                f"no committed checkpoint under {directory}")
        return _load_one(ckpt, params_like, updater_like, verify)
    else:
        candidates = [c for _s, c in reversed(_committed_steps(directory))]
    rejected: List[str] = []
    for ckpt in candidates:
        try:
            return _load_one(ckpt, params_like, updater_like, verify)
        except CheckpointCorruptError as e:
            log.warning("checkpoint %s rejected (falling back to the "
                        "previous good step): %s", ckpt.name, e)
            rejected.append(f"{ckpt.name}: {e}")
    if rejected:
        raise CheckpointCorruptError(
            f"no loadable checkpoint under {directory} — every committed "
            f"step failed verification: " + "; ".join(rejected),
            path=directory)
    raise FileNotFoundError(f"no committed checkpoint under {directory}")


def resume_train_state(directory: os.PathLike, runner,
                       with_extra: bool = False):
    """Restore the newest GOOD checkpoint under `directory` into any
    runner exposing ``restore_train_state(step, params, updater_state,
    net_state)`` (`MultiLayerNetwork`, `DataParallelTrainer`) — the ONE
    implementation of the load / settle-on-a-step / net_state / restore
    sequence (`DataParallelTrainer.resume`, the CLI's `-resume` and
    `TrainingSupervisor.resume`/`_rollback` delegate here).  Corrupt steps are skipped for the previous good one; a
    checkpoint carrying no updater state restores FRESH moments
    (keeping the live ones would re-poison clean restored params the
    moment a NaN step's momentum applies); any saved shard count loads
    onto any replica count (elastic N→M).
    Returns the
    restored step (or `(step, extra)` with ``with_extra=True`` so a
    supervisor can layer lr_scale/stream bookkeeping on top), or None
    when the directory holds no checkpoint."""
    directory = pathlib.Path(directory)
    if latest_checkpoint(directory) is None:
        return None
    net = getattr(runner, "net", runner)
    updater_like = (net.updater_state if net.updater_state is not None
                    else net._updater.init(net.params))
    step, params, upd, extra = load_checkpoint(
        directory, net.params, updater_like)
    # net_state from the step the loader SETTLED on (it may have fallen
    # back past a corrupt newest step)
    net_state = None
    if getattr(net, "state", None) is not None:
        net_state = load_net_state(directory / f"ckpt-{step}", net.state)
    if upd is None:
        upd = net._updater.init(params)
    runner.restore_train_state(step, params, upd, net_state)
    return (step, extra) if with_extra else step


def _gc_checkpoints(directory: pathlib.Path, keep: int,
                    protect: frozenset = frozenset()) -> list:
    """Remove all but the newest `keep` checkpoints, never touching steps
    in `protect` (best-score retention), and sweep crash orphans (see
    `sweep_orphans`). Returns the removed steps."""
    sweep_orphans(directory)
    ckpts = sorted(
        (int(m.group(1)), child)
        for child in directory.iterdir()
        if (m := re.fullmatch(r"ckpt-(\d+)", child.name)))
    removed = []
    for step, child in ckpts[:-keep] if keep > 0 else []:
        if step in protect:
            continue
        for f in child.iterdir():
            f.unlink()
        child.rmdir()
        removed.append(step)
    return removed


# --------------------------------------------------------------------------
# ModelSaver SPI + periodic listener (ModelSavingActor parity)

class ModelSaver:
    """SPI mirroring reference `ModelSaver` (DefaultModelSaver/S3ModelSaver)."""

    def save(self, net) -> None:
        raise NotImplementedError


class DiskModelSaver(ModelSaver):
    def __init__(self, directory: os.PathLike):
        self.directory = pathlib.Path(directory)

    def save(self, net) -> None:
        save_model(net, self.directory)


class CheckpointListener:
    """IterationListener that checkpoints every N iterations — the
    reference's ModelSavingActor 'save-every-N-updates' semantics
    (`ModelSavingActor.java:93-97`)."""

    def __init__(self, directory: os.PathLike, every: int = 100,
                 keep: int = 3, save_updater: bool = True):
        self.directory = pathlib.Path(directory)
        self.every = max(1, every)
        self.keep = keep
        self.save_updater = save_updater

    def iteration_done(self, model, iteration: int, score: float) -> None:
        if iteration % self.every != 0:
            return
        upd = published_updater_state(model) if self.save_updater else None
        save_checkpoint(self.directory, iteration, model.params,
                        updater_state=upd, extra={"score": float(score)},
                        keep=self.keep, score=float(score))


class AsyncCheckpointListener(CheckpointListener):
    """CheckpointListener that does NOT block the training loop on IO.

    At each trigger it snapshots the trees with on-device copies
    (`Tensor.clone()` — queued device work, required because the step
    updates the parameters IN PLACE: by the time a background thread
    would read them, the originals hold a later step), then a single
    worker thread copies the snapshot to the host and writes it while the
    device trains on.  At most one snapshot is live (queued OR being written);
    a trigger arriving while one is in flight is skipped with a warning
    rather than stacking HBM snapshots.  Call `close()` (or use as a
    context manager) to flush the last write; a closed listener raises
    if it keeps receiving iterations.

    Single-process only, as in the JAX package: `save_checkpoint`'s
    barriers cannot run on a background thread (processes could disagree
    on skips and deadlock the collective); a job of several processes
    uses the synchronous `CheckpointListener`.
    """

    def __init__(self, directory: os.PathLike, every: int = 100,
                 keep: int = 3, save_updater: bool = True):
        import queue
        import threading

        super().__init__(directory, every=every, keep=keep,
                         save_updater=save_updater)
        if process_count() > 1:
            raise NotImplementedError(
                "AsyncCheckpointListener is single-host (background-"
                "thread barriers would deadlock); use CheckpointListener "
                "in multi-host jobs")
        self._queue = queue.Queue(maxsize=1)
        self._queue_full = queue.Full
        self._closed = False
        self._errors: list = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, params, upd, score = item
                save_checkpoint(self.directory, step, params,
                                updater_state=upd,
                                extra={"score": score}, keep=self.keep,
                                score=score)
            except Exception as e:  # noqa: BLE001 — surfaced on next call
                self._errors.append(e)
            finally:
                # unfinished_tasks is the in-flight indicator: it counts
                # queued AND currently-writing snapshots.
                self._queue.task_done()

    def iteration_done(self, model, iteration: int, score: float) -> None:
        if self._errors:
            raise RuntimeError(
                "async checkpoint write failed") from self._errors.pop(0)
        if self._closed:
            raise RuntimeError(
                "AsyncCheckpointListener is closed — unregister it from "
                "the model or create a new one")
        if iteration % self.every != 0:
            return
        score = float(score)
        if self._queue.unfinished_tasks > 0:
            # Check BEFORE snapshotting: a skip must not pay for (and
            # momentarily hold) a full device copy.
            warnings.warn(
                f"async checkpoint at iteration {iteration} skipped: "
                f"previous write still in flight (raise `every`?)",
                stacklevel=2)
            return

        def snap(tree):
            return map_tree(
                lambda a: (a.detach().clone()
                           if isinstance(a, torch.Tensor) else a), tree)

        upd = (snap(published_updater_state(model)) if self.save_updater
               else None)
        self._queue.put((iteration, snap(model.params), upd, score))

    def close(self) -> None:
        """Flush pending writes and stop the worker (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join()
        if self._errors:
            raise RuntimeError(
                "async checkpoint write failed") from self._errors.pop(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["AsyncCheckpointListener", "CheckpointCorruptError",
           "CheckpointListener", "DiskModelSaver", "ModelSaver",
           "best_checkpoint", "latest_checkpoint", "load_checkpoint",
           "load_model", "load_net_state", "load_params", "npz_to_tree",
           "read_ckpt_manifest", "read_lm_npz", "read_manifest",
           "rebuild_manifest", "resume_train_state", "save_checkpoint",
           "save_model", "save_params", "set_phase_hook", "sweep_orphans",
           "tree_to_npz", "verify_checkpoint"]
