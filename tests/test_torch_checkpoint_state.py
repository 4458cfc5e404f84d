"""PyTorch port, slice 14: train-state checkpoints
(`runtime/checkpoint.py`'s sharded, checksummed, two-phase-committed
snapshots) against the JAX package's:

- a checkpoint written by either package loads in the other bitwise —
  params and updater state, one shard and several (a JAX 4-shard one
  included), and training continues alike from either restore;
- the same manifest layout: topology, per-shard SHA-256 and size, tree
  leaves with their true shapes;
- crash safety: a partial (uncommitted) step and a save killed at every
  durability phase leave the previous step loadable; the staging debris
  is swept; a re-save never destroys the old copy;
- retention: keep-last-K with the best score protected, ``step="best"``;
- integrity: a flipped or truncated shard is refused as
  `CheckpointCorruptError` and the loader falls back to the previous good
  step; a corrupt retention manifest is refused naming
  `rebuild_manifest`, which rebuilds it;
- `CheckpointListener` and `AsyncCheckpointListener`, and the multi-host
  layout (ROADMAP.md, A7; `tests/test_torch_multiprocess.py` runs it
  over real processes).
"""

import json
import logging
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.zoo import iris_mlp as jiris
from deeplearning4j_tpu.parallel.partition import keypath
from deeplearning4j_tpu.runtime import checkpoint as jck
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models.zoo import iris_mlp as tiris
from deeplearning4j_tpu_torch.resilience import (
    CheckpointChaosConfig,
    InjectedCheckpointCrash,
    chaos_checkpoint,
    corrupt_checkpoint,
    flip_byte,
)
from deeplearning4j_tpu_torch.runtime import checkpoint as tck
from deeplearning4j_tpu_torch.runtime.checkpoint import (
    AsyncCheckpointListener,
    CheckpointCorruptError,
    CheckpointListener,
    best_checkpoint,
    latest_checkpoint,
    load_checkpoint,
    read_ckpt_manifest,
    read_manifest,
    rebuild_manifest,
    resume_train_state,
    save_checkpoint,
    verify_checkpoint,
)
from deeplearning4j_tpu_torch.tree import flatten_tree
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

pytestmark = pytest.mark.chaos


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _tnet(steps=0):
    net = TNet(tiris(updater="adam"), device="cpu").init()
    x, y = _data()
    for _ in range(steps):
        net.fit_batch(x, y)
    return net


def _jnet(steps=0):
    net = JNet(jiris(updater="adam")).init()
    x, y = _data()
    for _ in range(steps):
        net.fit_batch(x, y)
    return net


def _tflat(tree):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in flatten_tree(tree).items()}


def _jflat(tree):
    return {keypath(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _pflat(net):
    return np.concatenate([v.ravel() for _, v in sorted(
        _tflat(net.params).items())])


# ---------------------------------------------------------------------------
# Across the packages


@pytest.mark.parametrize("shards", [1, 4])
def test_jax_checkpoint_loads_in_the_port_bitwise(tmp_path, shards):
    jn = _jnet(3)
    jck.save_checkpoint(tmp_path, 3, jn.params,
                        updater_state=jn.updater_state, shards=shards,
                        extra={"note": "jax"}, score=0.5)
    tn = _tnet()
    step, params, upd, extra = load_checkpoint(tmp_path, tn.params,
                                               tn.updater_state)
    assert step == 3 and extra == {"note": "jax"}
    _assert_bitwise(_tflat(params), _jflat(jn.params))
    _assert_bitwise(_tflat(upd), _jflat(jn.updater_state))
    assert read_ckpt_manifest(tmp_path / "ckpt-3")["topology"]["shards"] \
        == shards
    # training continues alike from the port's restore
    assert resume_train_state(tmp_path, tn) == 3
    assert tn._iteration == 3
    x, y = _data(seed=1)
    lj, lt = jn.fit_batch(x, y), tn.fit_batch(x, y)
    assert abs(lj - lt) < 1e-5
    np.testing.assert_allclose(_pflat(tn), np.concatenate(
        [v.ravel() for _, v in sorted(_jflat(jn.params).items())]),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shards", [1, 3])
def test_port_checkpoint_loads_in_jax_bitwise(tmp_path, shards):
    tn = _tnet(3)
    save_checkpoint(tmp_path, 3, tn.params, updater_state=tn.updater_state,
                    net_state=tn.state, shards=shards, extra={"k": 1},
                    score=0.25)
    jn = _jnet()
    step, params, upd, extra = jck.load_checkpoint(tmp_path, jn.params,
                                                   jn.updater_state)
    assert step == 3 and extra == {"k": 1}
    _assert_bitwise(_jflat(params), _tflat(tn.params))
    _assert_bitwise(_jflat(upd), _tflat(tn.updater_state))
    jck.verify_checkpoint(tmp_path / "ckpt-3")
    assert jck.read_manifest(tmp_path)["best_step"] == 3


def test_manifests_have_one_layout(tmp_path):
    jn, tn = _jnet(1), _tnet(1)
    jck.save_checkpoint(tmp_path / "j", 1, jn.params,
                        updater_state=jn.updater_state, shards=2)
    save_checkpoint(tmp_path / "t", 1, tn.params,
                    updater_state=tn.updater_state, shards=2)
    jm = read_ckpt_manifest(tmp_path / "j" / "ckpt-1")
    tm = read_ckpt_manifest(tmp_path / "t" / "ckpt-1")
    assert sorted(tm) == sorted(jm)
    assert tm["topology"] == jm["topology"]
    assert sorted(tm["files"]) == sorted(jm["files"])
    for name in ("params", "updater"):
        assert tm["trees"][name]["files"] == jm["trees"][name]["files"]
        assert tm["trees"][name]["leaves"] == jm["trees"][name]["leaves"]
    assert sorted(os.listdir(tmp_path / "t" / "ckpt-1")) == \
        sorted(os.listdir(tmp_path / "j" / "ckpt-1"))


def test_v1_single_host_jax_checkpoint_loads(tmp_path):
    """A pre-manifest checkpoint (``params.proc00000.npz`` + COMMIT)."""
    jn = _jnet(2)
    ckpt = tmp_path / "ckpt-2"
    ckpt.mkdir()
    jck.tree_to_npz(ckpt / "params.proc00000.npz", jn.params)
    (ckpt / "meta.json").write_text('{"step": 2, "extra": {}}')
    (ckpt / "COMMIT").write_text("ok")
    tn = _tnet()
    step, params, _upd, _ = load_checkpoint(tmp_path, tn.params)
    assert step == 2
    _assert_bitwise(_tflat(params), _jflat(jn.params))


def test_bfloat16_params_round_trip_exactly(tmp_path):
    tn = _tnet()
    tn.set_precision("bf16")
    save_checkpoint(tmp_path, 0, tn.params)
    back = TNet(tiris(updater="adam"), device="cpu").init()
    back.set_precision("bf16")
    _, params, _, _ = load_checkpoint(tmp_path, back.params)
    for k, v in flatten_tree(params).items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, flatten_tree(tn.params)[k])


# ---------------------------------------------------------------------------
# Crash safety


def test_crash_mid_save_loads_newest_complete(tmp_path):
    tn = _tnet(1)
    save_checkpoint(tmp_path, 5, tn.params, updater_state=tn.updater_state)
    partial = tmp_path / "ckpt-7"
    partial.mkdir()
    tck.tree_to_npz(partial / "params.proc00000.npz", tn.params)
    assert latest_checkpoint(tmp_path).name == "ckpt-5"
    step, params, _, _ = load_checkpoint(tmp_path, tn.params)
    assert step == 5
    _assert_bitwise(_tflat(params), _tflat(tn.params))


def test_kill_at_every_phase_loads_prev_or_new(tmp_path):
    ckdir = tmp_path / "c"
    tn = _tnet(1)
    save_checkpoint(ckdir, 1, tn.params, updater_state=tn.updater_state,
                    shards=4)
    p1 = _pflat(tn)
    tn.fit_batch(*_data())
    p2 = _pflat(tn)
    snapshots = []

    def hook(phase, _path):
        dst = tmp_path / f"snap-{len(snapshots)}"
        shutil.copytree(ckdir, dst)
        snapshots.append((phase, dst))

    prev = tck.set_phase_hook(hook)
    try:
        save_checkpoint(ckdir, 2, tn.params, updater_state=tn.updater_state,
                        shards=4)
    finally:
        tck.set_phase_hook(prev)
    phases = [ph for ph, _ in snapshots]
    assert phases[0] == "begin" and phases[-1] == "committed"
    assert sum(ph.startswith("shard:") for ph in phases) == 8
    assert {"meta", "manifest", "commit_marker"} <= set(phases)
    probe = _tnet()
    for phase, snap in snapshots:
        step, params, _, _ = load_checkpoint(snap, probe.params,
                                             probe.updater_state)
        assert step == (2 if phase == "committed" else 1), phase
        got = np.concatenate([v.ravel() for _, v in sorted(
            _tflat(params).items())])
        np.testing.assert_array_equal(got, p2 if step == 2 else p1)


@pytest.mark.parametrize("phase", ["shard:", "meta", "manifest",
                                   "commit_marker"])
def test_chaos_kill_mid_commit_then_sweep(tmp_path, phase):
    tn = _tnet(1)
    save_checkpoint(tmp_path, 1, tn.params, shards=2)
    tn.fit_batch(*_data())
    with chaos_checkpoint(CheckpointChaosConfig(crash_at_phase=phase)) \
            as chaos:
        with pytest.raises(InjectedCheckpointCrash):
            save_checkpoint(tmp_path, 2, tn.params, shards=2)
    assert chaos.crashed
    assert load_checkpoint(tmp_path, tn.params)[0] == 1
    debris = [c for c in tmp_path.iterdir()
              if c.name.startswith(".tmp-ckpt-")]
    assert debris
    old = time.time() - 3600
    for d in debris:
        os.utime(d, (old, old))
    save_checkpoint(tmp_path, 3, tn.params, shards=2)
    assert not [c for c in tmp_path.iterdir()
                if c.name.startswith(".tmp-ckpt-")]
    assert load_checkpoint(tmp_path, tn.params)[0] == 3


def test_resave_same_step_never_destroys_the_old_copy(tmp_path):
    tn = _tnet(1)
    save_checkpoint(tmp_path, 5, tn.params, shards=2)
    original = _pflat(tn)
    tn.fit_batch(*_data())
    for phase in ("shard:", "manifest", "commit_marker"):
        with chaos_checkpoint(CheckpointChaosConfig(crash_at_phase=phase)):
            with pytest.raises(InjectedCheckpointCrash):
                save_checkpoint(tmp_path, 5, tn.params, shards=2)
        step, params, _, _ = load_checkpoint(tmp_path, tn.params)
        assert step == 5
        got = np.concatenate([v.ravel() for _, v in sorted(
            _tflat(params).items())])
        np.testing.assert_array_equal(got, original)
    save_checkpoint(tmp_path, 5, tn.params, shards=2)   # completes
    _, params, _, _ = load_checkpoint(tmp_path, tn.params)
    _assert_bitwise(_tflat(params), _tflat(tn.params))


# ---------------------------------------------------------------------------
# Retention


def test_best_score_checkpoint_survives_gc(tmp_path):
    tn = _tnet()
    for step, score in {1: 1.0, 2: 0.2, 3: 0.5, 4: 0.6, 5: 0.7,
                        6: 0.8}.items():
        save_checkpoint(tmp_path, step, tn.params, keep=2, score=score)
    kept = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("ckpt-"))
    assert kept == ["ckpt-2", "ckpt-5", "ckpt-6"]
    assert best_checkpoint(tmp_path).name == "ckpt-2"
    assert latest_checkpoint(tmp_path).name == "ckpt-6"
    manifest = read_manifest(tmp_path)
    assert manifest["best_step"] == 2 and "1" not in manifest["entries"]
    assert jck.read_manifest(tmp_path)["best_step"] == 2
    assert load_checkpoint(tmp_path, tn.params, step="best")[0] == 2


def test_unscored_checkpoints_keep_plain_retention(tmp_path):
    tn = _tnet()
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, step, tn.params, keep=3)
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("ckpt-")) == \
        ["ckpt-3", "ckpt-4", "ckpt-5"]
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "nope", tn.params)


def test_corrupt_manifest_refuses_then_rebuilds(tmp_path):
    tn = _tnet()
    save_checkpoint(tmp_path, 1, tn.params, score=0.5)
    (tmp_path / "manifest.json").write_text("{not json")
    with pytest.raises(CheckpointCorruptError, match="rebuild_manifest"):
        read_manifest(tmp_path)
    rebuilt = rebuild_manifest(tmp_path)
    assert rebuilt["best_step"] == 1
    assert rebuilt["entries"]["1"]["score"] == 0.5
    (tmp_path / "manifest.json").unlink()
    assert read_manifest(tmp_path)["best_step"] == 1
    (tmp_path / "manifest.json").write_text("{not json")
    save_checkpoint(tmp_path, 2, tn.params, score=0.4)
    assert read_manifest(tmp_path)["best_step"] == 2
    assert "1" in read_manifest(tmp_path)["entries"]


# ---------------------------------------------------------------------------
# Integrity


def _two_steps(tmp_path):
    tn = _tnet(1)
    save_checkpoint(tmp_path, 1, tn.params, updater_state=tn.updater_state,
                    shards=2, score=0.5)
    good = _pflat(tn)
    tn.fit_batch(*_data())
    save_checkpoint(tmp_path, 2, tn.params, updater_state=tn.updater_state,
                    shards=2, score=0.4)
    return tn, good


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corrupt_shard_detected_falls_back(tmp_path, caplog, mode):
    tn, good = _two_steps(tmp_path)
    corrupt_checkpoint(tmp_path / "ckpt-2", mode=mode)
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(tmp_path, tn.params, step=2)
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(tmp_path / "ckpt-2")
    with caplog.at_level(logging.WARNING,
                         logger="deeplearning4j_tpu_torch.runtime.checkpoint"):
        step, params, _, _ = load_checkpoint(tmp_path, tn.params)
    assert step == 1
    np.testing.assert_array_equal(np.concatenate(
        [v.ravel() for _, v in sorted(_tflat(params).items())]), good)
    assert any("ckpt-2" in r.getMessage() and "rejected" in r.getMessage()
               for r in caplog.records)
    # the JAX loader refuses the same bytes
    with pytest.raises(jck.CheckpointCorruptError):
        jck.verify_checkpoint(tmp_path / "ckpt-2")


def test_flipped_byte_anywhere_is_detected(tmp_path):
    _two_steps(tmp_path)
    for shard in sorted((tmp_path / "ckpt-2").glob("*.npz")):
        backup = shard.read_bytes()
        flip_byte(shard, offset=len(backup) // 3)
        with pytest.raises(CheckpointCorruptError):
            verify_checkpoint(tmp_path / "ckpt-2")
        shard.write_bytes(backup)
    verify_checkpoint(tmp_path / "ckpt-2")


def test_all_corrupt_raises_typed_and_manifest_falls_back(tmp_path):
    tn, good = _two_steps(tmp_path)
    (tmp_path / "ckpt-2" / "MANIFEST.json").write_text("{torn")
    assert load_checkpoint(tmp_path, tn.params)[0] == 1
    corrupt_checkpoint(tmp_path / "ckpt-1", mode="truncate")
    with pytest.raises(CheckpointCorruptError, match="every committed step"):
        load_checkpoint(tmp_path, tn.params)


def test_structure_mismatch_is_typed(tmp_path):
    tn = _tnet()
    save_checkpoint(tmp_path, 1, tn.params)
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(tmp_path, [dict(p, extra=torch.zeros(1))
                                   for p in tn.params])


# ---------------------------------------------------------------------------
# Listeners and the multi-host layout


def test_checkpoint_listener_saves_periodically(tmp_path):
    tn = _tnet()
    tn.add_listener(CheckpointListener(tmp_path, every=2, keep=5))
    x, y = _data()
    for _ in range(5):
        tn.fit_batch(x, y)
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("ckpt-")) == ["ckpt-2", "ckpt-4"]
    jn = _jnet()
    step, params, upd, extra = jck.load_checkpoint(tmp_path, jn.params,
                                                   jn.updater_state)
    assert step == 4 and upd is not None and "score" in extra


def test_async_listener_snapshots_the_trigger_state(tmp_path):
    tn = _tnet()
    snaps = {}
    listener = AsyncCheckpointListener(tmp_path, every=2, keep=5)
    tn.add_listener(listener)
    tn.add_listener(lambda it, s: snaps.__setitem__(it, _pflat(tn))
                    if it % 2 == 0 else None)
    x, y = _data()
    for _ in range(4):
        tn.fit_batch(x, y)
        listener._queue.join()      # one write in flight at a time
    listener.close()
    for step in (2, 4):
        _, params, _, _ = load_checkpoint(tmp_path, tn.params, step=step)
        np.testing.assert_array_equal(np.concatenate(
            [v.ravel() for _, v in sorted(_tflat(params).items())]),
            snaps[step])
    with pytest.raises(RuntimeError, match="closed"):
        listener.iteration_done(tn, 6, 0.0)


def test_multi_host_checkpoints_name_a7(tmp_path, monkeypatch):
    """A7 part 3a: a job of several processes (the count patched to 2 in
    this one process, which is process 0) writes JAX's v1 per-host
    layout, and the async listener refuses with JAX's text."""
    monkeypatch.setattr(tck, "process_count", lambda: 2)
    save_checkpoint(tmp_path, 1, _tnet().params)
    ckpt = tmp_path / "ckpt-1"
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "COMMIT", "meta.json", "params.proc00000.npz"]
    assert json.loads((ckpt / "meta.json").read_text())["processes"] == 2
    with pytest.raises(NotImplementedError, match="single-host"):
        AsyncCheckpointListener(tmp_path)
