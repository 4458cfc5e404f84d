"""PyTorch port, slice 18: the partition vocabulary and elastic checkpoints
held against the JAX package (`parallel/partition.py`,
`runtime/checkpoint.py`'s partition manifest and N→M restore).

The same numpy trees go through both packages' `split_leaf`,
`join_leaf`, `shard_tree`, `gather_tree`, `reshard` and the spec JSON,
and must come out equal, array for array.  A checkpoint that JAX's
`DataParallelTrainer` writes on 2 devices with a partition manifest
restores into the port's trainer on 1 and 4 shards bitwise, and the
reverse: the port's 2-shard checkpoint into JAX's trainer on 1 and 4
devices.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import iris_mlp as jiris
from deeplearning4j_tpu.parallel import DataParallelTrainer as JDP
from deeplearning4j_tpu.parallel import make_mesh as jmesh
from deeplearning4j_tpu.parallel import partition as jpart
from deeplearning4j_tpu.resilience import ResilienceConfig as JRC
from deeplearning4j_tpu.resilience import TrainingSupervisor as JSup
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import iris_mlp as tiris
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.parallel import DataParallelTrainer as TDP
from deeplearning4j_tpu_torch.parallel import make_mesh as tmesh
from deeplearning4j_tpu_torch.parallel import partition as tpart
from deeplearning4j_tpu_torch.resilience import ResilienceConfig as TRC
from deeplearning4j_tpu_torch.resilience import TrainingSupervisor as TSup
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

RNG = np.random.default_rng(18)
TREE = {"layer": {"W": RNG.normal(size=(23, 3)).astype(np.float32),
                  "b": RNG.normal(size=(5,)).astype(np.float32)},
        "scale": np.float32(2.5),
        "rows": RNG.integers(0, 9, (7, 2)).astype(np.int32)}


def _specs(mod):
    return {"layer": {"W": mod.sharded("data", 0, size=23),
                      "b": mod.replicated()},
            "scale": mod.replicated(),
            "rows": mod.sharded("data", 1, size=2)}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_split_join_and_padding_equal_jax(n):
    for arr, dim in ((TREE["layer"]["W"], 0), (TREE["rows"], 1),
                     (np.arange(10, dtype=np.float32), 0)):
        ours, theirs = tpart.split_leaf(arr, n, dim), \
            jpart.split_leaf(arr, n, dim)
        assert len(ours) == len(theirs) == n
        for a, b in zip(ours, theirs):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        back = tpart.join_leaf(ours, dim, arr.shape[dim])
        np.testing.assert_array_equal(back, arr)
        np.testing.assert_array_equal(
            back, jpart.join_leaf(theirs, dim, arr.shape[dim]))
    assert tpart.padded_extent(23, n) == jpart.padded_extent(23, n)
    with pytest.raises(ValueError, match="0-d"):
        tpart.split_leaf(np.float32(1), n)


@pytest.mark.parametrize("n_from,n_to", [(4, 1), (4, 3), (2, 8), (1, 4)])
def test_shard_reshard_gather_equal_jax(n_from, n_to):
    ours = tpart.shard_tree(TREE, _specs(tpart), n_from)
    theirs = jpart.shard_tree(TREE, _specs(jpart), n_from)
    _assert_tree_equal(ours, theirs)
    r_ours = tpart.reshard(ours, _specs(tpart), n_from, n_to)
    r_theirs = jpart.reshard(theirs, _specs(jpart), n_from, n_to)
    _assert_tree_equal(r_ours, r_theirs)
    assert all(len(v) == n_to for v in r_ours["layer"].values())
    # replicated leaves are re-referenced, never copied
    assert r_ours["layer"]["b"][0] is r_ours["layer"]["b"][-1]
    _assert_tree_equal(tpart.gather_tree(r_ours, _specs(tpart)), TREE)
    with pytest.raises(ValueError, match="n_from"):
        tpart.reshard(ours, _specs(tpart), n_from + 1, n_to)
    with pytest.raises(ValueError, match="replica counts"):
        tpart.reshard(ours, tpart.replicated(), n_from, 0)


def test_spec_json_equal_jax_and_drives_reshard():
    ours = tpart.spec_to_json(_specs(tpart))
    theirs = jpart.spec_to_json(_specs(jpart))
    assert ours == theirs and list(ours) == list(theirs)
    assert tpart.spec_to_json(tpart.sharded("data", 1)) == \
        jpart.spec_to_json(jpart.sharded("data", 1))
    wire = tpart.spec_from_json(theirs)
    assert wire["layer//W"] == tpart.sharded("data", 0, size=23)
    assert tpart.spec_from_json({"*": tpart.zero1(size=8).to_json()}) == \
        tpart.sharded("data", 0, size=8)
    four = tpart.shard_tree(TREE, wire, 4)
    _assert_tree_equal(tpart.gather_tree(tpart.reshard(four, wire, 4, 2),
                                         wire), TREE)
    with pytest.raises(ValueError, match="no entry for leaf"):
        tpart.reshard({"other": [TREE["rows"]] * 4}, wire, 4, 2)


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = rng.normal(0, 0.3, (n, 4)).astype(np.float32) + y[:, None]
    return x, np.eye(3, dtype=np.float32)[y]


def _tflat(tree):
    """A port tree's leaves (the step included) as one float64 vector in
    the JAX flatten order (dict keys sorted; tensors are leaves)."""
    return np.concatenate([np.asarray(t.detach().cpu().double()).ravel()
                           for t in jax.tree_util.tree_leaves(tree)])


def _jflat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _jax_run(tmp_path, n, steps=4):
    x, y = _data()
    net = JNet(jiris(updater="adam")).init()
    tr = JDP(net, mesh=jmesh((n,), ("data",), devices=jax.devices()[:n]))
    sup = JSup(tr, JRC(checkpoint_dir=tmp_path, checkpoint_every=steps))
    sup.run([(x, y)] * steps, max_steps=steps)
    return net


def _port_net():
    return TNet(tiris(updater="adam"), device="cpu").init()


@pytest.mark.parametrize("m", [1, 4])
def test_jax_two_device_checkpoint_restores_on_port_shards(tmp_path, m):
    jnet = _jax_run(tmp_path, 2)
    manifest = jckpt.read_ckpt_manifest(tmp_path / "ckpt-4")
    assert manifest["topology"]["shards"] == 2
    assert manifest["partition"]["params"] == {"*": tpart.replicated()
                                               .to_json()}
    saved_p, saved_u = _jflat(jnet.params), _jflat(jnet.updater_state)
    net = _port_net()
    tr = TDP(net, mesh=tmesh((m,), ("data",), devices=["cpu"] * m))
    assert tr.resume(tmp_path) == 4
    tr.publish_train_state()
    np.testing.assert_array_equal(_tflat(net.params), saved_p)
    np.testing.assert_array_equal(_tflat(net.updater_state), saved_u)
    # the rebuilt ZeRO-1 slices hold the restored moments, padded for m
    k0 = net.num_params()
    assert tr._flat_k == tpart.padded_extent(k0, m)
    m_flat = torch.cat([s["m"]["p"] for s in tr._opt_shard])[:k0]
    np.testing.assert_array_equal(
        m_flat.numpy(), np.concatenate([np.asarray(a).ravel() for a in
                                        jax.tree_util.tree_leaves(
                                            jnet.updater_state["m"])]))
    x, y = _data()
    assert np.isfinite(tr.fit_batch(x, y))


@pytest.mark.parametrize("m", [1, 4])
def test_port_two_shard_checkpoint_restores_on_jax_devices(tmp_path, m):
    x, y = _data()
    net = _port_net()
    tr = TDP(net, mesh=tmesh((2,), ("data",), devices=["cpu"] * 2))
    sup = TSup(tr, TRC(checkpoint_dir=tmp_path, checkpoint_every=4))
    sup.run([(x, y)] * 4, max_steps=4)
    manifest = tckpt.read_ckpt_manifest(tmp_path / "ckpt-4")
    assert manifest["topology"]["shards"] == 2
    assert manifest["partition"]["updater"] == {"*": {
        "axis": None, "dim": None, "size": None}}
    saved_p, saved_u = _tflat(net.params), _tflat(net.updater_state)
    jnet = JNet(jiris(updater="adam")).init()
    jtr = JDP(jnet, mesh=jmesh((m,), ("data",), devices=jax.devices()[:m]))
    assert jtr.resume(tmp_path) == 4
    jtr.publish_train_state()
    np.testing.assert_array_equal(_jflat(jnet.params), saved_p)
    np.testing.assert_array_equal(_jflat(jnet.updater_state), saved_u)
    assert np.isfinite(jtr.fit_batch(x, y))


def test_port_reshards_its_own_checkpoint_bitwise(tmp_path):
    """2 → 1 and 2 → 4 inside the port: the published trees of every
    restore equal the saved ones, and a manifest spec read back reshards
    the saved shard files as JAX's would."""
    x, y = _data()
    net = _port_net()
    tr = TDP(net, mesh=tmesh((2,), ("data",), devices=["cpu"] * 2))
    for _ in range(3):
        tr.fit_batch(x, y)
    tr.publish_train_state()
    spec = tr.checkpoint_partition()
    tckpt.save_checkpoint(tmp_path, 3, net.params,
                          updater_state=net.updater_state,
                          spec=spec["spec"], shards=spec["shards"])
    saved_p, saved_u = _tflat(net.params), _tflat(net.updater_state)
    for m in (1, 4):
        net2 = _port_net()
        tr2 = TDP(net2, mesh=tmesh((m,), ("data",), devices=["cpu"] * m))
        assert tr2.resume(tmp_path) == 3
        tr2.publish_train_state()
        np.testing.assert_array_equal(_tflat(net2.params), saved_p)
        np.testing.assert_array_equal(_tflat(net2.updater_state), saved_u)
    # the JAX loader reads the port's manifest and shard files
    jnet = JNet(jiris(updater="adam")).init()
    step, params, _, _ = jckpt.load_checkpoint(tmp_path, jnet.params)
    assert step == 3
    np.testing.assert_array_equal(_jflat(params), saved_p)
    jm = jckpt.read_ckpt_manifest(tmp_path / "ckpt-3")
    assert jm["partition"] == {"params": {"*": jpart.replicated().to_json()},
                               "updater": {"*": jpart.replicated()
                                           .to_json()}}
    # a port net carried the JAX params over equals the restore too
    net3 = _port_net()
    net3.params = params_from_numpy(net3, params)
    np.testing.assert_array_equal(_tflat(net3.params), saved_p)
