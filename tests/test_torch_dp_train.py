"""PyTorch port, slice 18: the data-parallel trainer's callers against the
JAX package's — supervised DP training (sharded checkpoints, rollback,
fused chunks), `NetworkClassifier(distributed=True)` and the CLI's
``train -runtime spmd -replicas/-sync-every/-shard-update`` with
``-device cpu`` (N host shards; JAX's on its virtual CPU devices).

Both CLIs start from one saved model directory (written by the JAX
package, loaded by either) and read the same CSV, so their trained
parameters compare within 1e-5.  Rollback is driven by a deterministic
trigger (a one-shot typed score error): the JAX package's lr-50
divergence oracle is red (ROADMAP.md queue C).
"""

import contextlib
import io

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu import resilience as jr
from deeplearning4j_tpu.ml import pipeline as jml
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.optimize import InvalidScoreError as JInvalid
from deeplearning4j_tpu.parallel import DataParallelTrainer as JDP
from deeplearning4j_tpu.parallel import make_mesh as jmesh
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu_torch import cli as tcli
from deeplearning4j_tpu_torch import resilience as tr
from deeplearning4j_tpu_torch.ml import pipeline as tml
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.optimize import InvalidScoreError as TInvalid
from deeplearning4j_tpu_torch.parallel import DataParallelTrainer as TDP
from deeplearning4j_tpu_torch.parallel import make_mesh as tmesh
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

TOL = 1e-5


def _mlp(mod, seed=5, lr=0.02):
    return mod.MultiLayerConfiguration(
        conf=mod.NeuralNetConfiguration(learning_rate=lr, updater="adam",
                                        seed=seed),
        layers=(mod.DenseLayerConf(n_in=4, n_out=16, activation="relu"),
                mod.OutputLayerConf(n_in=16, n_out=3)))


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = rng.normal(0, 0.3, (n, 4)).astype(np.float32) + y[:, None]
    return x, np.eye(3, dtype=np.float32)[y]


def _pair(jc):
    jn = JNet(jc).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(jc.to_json()),
              device="cpu").init()
    tn.params = params_from_numpy(tn, jn.params)
    return jn, tn


def _trainers(jn, tn, n, **kw):
    return (JDP(jn, mesh=jmesh((n,), ("data",), devices=jax.devices()[:n]),
                **kw),
            TDP(tn, mesh=tmesh((n,), ("data",), devices=["cpu"] * n), **kw))


def _tflat(net):
    return net.params_flat()


def _jflat(net):
    return np.asarray(net.params_flat(), np.float32)
# ---- supervision, the estimator -------------------------------------------

class _Raiser:
    """Raises the package's typed score error once, inside step `at`."""

    def __init__(self, trainer, invalid, at):
        self.trainer, self.invalid, self.at = trainer, invalid, at
        self.fired = False

    def __getattr__(self, name):
        return getattr(self.trainer, name)

    def fit_batch(self, x, y, mask=None):
        if not self.fired and self.trainer._iteration == self.at:
            self.fired = True
            raise self.invalid(self.at, float("nan"))
        return self.trainer.fit_batch(x, y, mask)


@pytest.mark.parametrize("sync_every", [1, 3])
def test_supervised_dp_rolls_back_and_checkpoints_like_jax(tmp_path,
                                                           sync_every):
    """A supervisor over the trainer: sharded checkpoints with the
    trainer's partition, a rollback from a deterministic trigger (the
    JAX package's lr-50 oracle is red), the same report and parameters
    within 1e-5 of JAX's."""
    jn, tn = _pair(_mlp(jconf))
    jt, tt = _trainers(jn, tn, 2, sync_every=sync_every)
    x, y = _data()
    reps = {}
    for pkg, t, invalid, name in ((jr, jt, JInvalid, "j"),
                                  (tr, tt, TInvalid, "t")):
        sup = pkg.TrainingSupervisor(
            _Raiser(t, invalid, 7),
            pkg.ResilienceConfig(checkpoint_dir=tmp_path / name,
                                 checkpoint_every=4))
        reps[name] = sup.run([(x, y)] * 12, max_steps=12)
    t, j = reps["t"], reps["j"]
    assert (t.steps, t.rollbacks, t.lr_scale) == (j.steps, j.rollbacks,
                                                  j.lr_scale)
    assert t.rollbacks == 1
    from deeplearning4j_tpu_torch.runtime.checkpoint import (
        read_ckpt_manifest,
    )

    m = read_ckpt_manifest(tmp_path / "t" / "ckpt-4")
    assert m["topology"]["shards"] == 2 and "params" in m["partition"]
    jt.finalize()
    tt.finalize()
    np.testing.assert_allclose(_tflat(tn), _jflat(jn), rtol=0, atol=TOL)


def test_supervised_chunks_ride_the_zero1_plane(tmp_path):
    net = TNet(_mlp(tconf), device="cpu").init()
    t = TDP(net, mesh=tmesh(devices=["cpu"] * 2))
    x, y = _data()
    sup = tr.TrainingSupervisor(t, tr.ResilienceConfig(
        checkpoint_dir=tmp_path, checkpoint_every=4, chunk_size=4))
    rep = sup.run([(x, y)] * 8, max_steps=8)
    assert rep.steps == 8 and np.isfinite(rep.final_loss)
    ref = TNet(_mlp(tconf), device="cpu").init()
    rt = TDP(ref, mesh=tmesh(devices=["cpu"] * 2))
    rt.fit([(x, y)] * 8, chunk_size=4)
    assert np.array_equal(_tflat(net), _tflat(ref))


def test_network_classifier_distributed_matches_jax():
    """`NetworkClassifier(distributed=True)` from JAX's initial weights:
    the port's default host mesh (one shard on the CPU) against JAX's
    default (every virtual device). A mean gradient over equal shards is
    the full batch's up to rounding, so the trained parameters agree
    within 1e-5 and the score is the same."""
    conf = _mlp(jconf)
    x, y = _data(96)
    labels = y.argmax(1)
    j = jml.NetworkClassifier(conf, epochs=3, batch_size=32,
                              distributed=True)
    j.fit(x, labels)
    jn = JNet(conf).init()  # the classifier's own seeded init
    t = tml.NetworkClassifier(
        tconf.MultiLayerConfiguration.from_json(conf.to_json()), epochs=3,
        batch_size=32, distributed=True, device="cpu")
    orig_init = TNet.init

    def init_from_jax(self, seed=None):
        orig_init(self, seed)
        self.params = params_from_numpy(self, jn.params)
        return self

    TNet.init = init_from_jax
    try:
        t.fit(x, labels)
    finally:
        TNet.init = orig_init
    np.testing.assert_allclose(t.network.params_flat(),
                               np.asarray(j.network.params_flat()),
                               rtol=0, atol=TOL)
    assert t.score(x, labels) == j.score(x, labels)


# ---- the CLI ---------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def iris(tmp_path_factory):
    """A seeded Iris-shaped CSV and one saved initial model both CLIs
    start from."""
    d = tmp_path_factory.mktemp("spmd")
    rng = np.random.default_rng(0)
    labels = np.arange(150) % 3
    x = rng.standard_normal((150, 4)) * 0.3 + labels[:, None] * 2.0
    np.savetxt(d / "iris.csv", np.column_stack([x, labels]), delimiter=",",
               fmt="%.5f")
    jckpt.save_model(JNet(jzoo.iris_mlp()).init(), d / "init")
    return d


@pytest.mark.parametrize("flags", [
    ["-replicas", "2"], ["-replicas", "2", "-sync-every", "3"],
    ["-replicas", "2", "-shard-update", "off"],
    ["-replicas", "4", "-chunk", "3"]], ids=" ".join)
def test_cli_train_spmd_matches_jax(iris, tmp_path, flags):
    """-batch 32 over 150 rows leaves a 22-row tail, wrapped to 24 on 4
    replicas; each CLI's saved parameters within 1e-5 of the other's."""
    common = ["train", "-input", str(iris / "iris.csv"), "-model",
              str(iris / "init"), "-runtime", "spmd", "-epochs", "2",
              "-batch", "32"] + flags
    rc, text = _run(tcli.main, common + ["-output", str(tmp_path / "t"),
                                         "-device", "cpu"])
    assert rc == 0, text
    assert "elastic mesh over" in text
    jrc, jtext = _run(jcli.main, common + ["-output", str(tmp_path / "j")])
    assert jrc == 0, jtext
    for line in ("spmd: local-SGD mode", "spmd: -shard-update off"):
        assert (line in text) == (line in jtext)
    jn = jckpt.load_model(tmp_path / "j" / "model")
    tn = tckpt.load_model(tmp_path / "t" / "model", device="cpu")
    np.testing.assert_allclose(tn.params_flat(), _jflat(jn), rtol=0,
                               atol=TOL)


def test_cli_resilience_then_resume_on_fewer_replicas(iris, tmp_path):
    """`train -runtime spmd -resilience -replicas 4` writes 4-shard
    checkpoints; a plain `-resume -replicas 2` restores them onto 2
    (JAX's tests/test_elastic_ckpt.py:647)."""
    out = tmp_path / "run"
    common = ["train", "-model", "zoo:iris-mlp", "-input",
              str(iris / "iris.csv"), "-output", str(out), "-runtime",
              "spmd", "-epochs", "2", "-batch", "16", "-ckpt-every", "1",
              "-device", "cpu"]
    rc, text = _run(tcli.main, common + ["-resilience", "-replicas", "4"])
    assert rc == 0, text
    assert "resilience: completed: 20 steps" in text
    ckdir = out / "ckpts"
    first = tckpt.load_checkpoint(
        ckdir, TNet(tconf.MultiLayerConfiguration.from_json(
            jzoo.iris_mlp().to_json()), device="cpu").init().params)
    manifest = tckpt.read_ckpt_manifest(ckdir / f"ckpt-{first[0]}")
    assert manifest["topology"]["shards"] == 4
    assert manifest["partition"]["params"] == {"*": {
        "axis": None, "dim": None, "size": None}}
    rc, text = _run(tcli.main, common + ["-resume", "-replicas", "2"])
    assert rc == 0, text
    assert f"restored checkpoint step {first[0]}" in text
    assert "elastic mesh over 2" in text
    # the JAX CLI resumes the port's checkpoints onto its own mesh too
    jrc, jtext = _run(jcli.main, [a for a in common if a not in (
        "-device", "cpu")] + ["-resume", "-replicas", "1"])
    assert jrc == 0 and f"restored checkpoint step" in jtext


def test_cli_spmd_replicas_must_exist(iris):
    with pytest.raises(SystemExit, match=r"-replicas must be in \[1, 1\]"):
        tcli.main(["train", "-input", str(iris / "iris.csv"), "-model",
                   "zoo:iris-mlp", "-runtime", "spmd", "-replicas", "0",
                   "-device", "cpu"])
