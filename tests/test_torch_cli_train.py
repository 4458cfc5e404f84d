"""PyTorch port, slice 8: the `train` / `test` / `predict` command line on
the CPU (``-device cpu``), against the JAX package's readers of what it
writes: the saved model directory (`load_model`) and the flat parameter
files (`load_params`, binary and txt).  Options whose code paths are not
ported exit naming their ROADMAP.md queue.  (``-precision`` and
``-chunk`` are ported in slice 9: tests/test_torch_fused.py.)"""

import contextlib
import io
import re

import numpy as np
import pytest

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


def _separable(n=150, seed=0):
    """Three well-separated classes of 4 features (Iris-shaped)."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n) % 3
    x = rng.standard_normal((n, 4)) * 0.3 + labels[:, None] * 2.0
    return x.astype(np.float32), labels


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    x, labels = _separable()
    path = tmp_path_factory.mktemp("data") / "iris.csv"
    np.savetxt(path, np.column_stack([x, labels]), delimiter=",",
               fmt="%.5f")
    return path


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def trained(csv_file, tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    rc, text = _run(["train", "-input", str(csv_file), "-model",
                     "zoo:iris-mlp", "-output", str(out), "-epochs", "15",
                     "-batch", "32", "-device", "cpu"])
    return rc, text, out


def test_train_exits_0_and_prints_its_rate(trained):
    rc, text, out = trained
    assert rc == 0
    m = re.search(r"Trained 15 epochs on 150 examples \(([\d.]+) "
                  r"examples/sec\)", text)
    assert m and float(m.group(1)) > 0
    acc = float(re.search(r"Accuracy:\s+([\d.]+)", text).group(1))
    assert acc >= 0.9
    assert (out / "model" / "conf.json").exists()
    assert (out / "params.bin").exists()


def test_test_and_predict_read_the_saved_model(trained, csv_file,
                                               tmp_path):
    _, text, out = trained
    rc, tested = _run(["test", "-input", str(csv_file), "-model",
                       str(out / "model"), "-device", "cpu"])
    assert rc == 0 and "Accuracy" in tested
    preds_path = tmp_path / "preds.txt"
    rc, said = _run(["predict", "-input", str(csv_file), "-model",
                     str(out / "model"), "-output", str(preds_path),
                     "-device", "cpu"])
    assert rc == 0 and "Wrote 150 predictions" in said
    preds = np.loadtxt(preds_path, dtype=int)
    assert re.fullmatch(r"(\d\n)+", preds_path.read_text())
    x, _ = _separable()
    jnet = jckpt.load_model(out / "model")
    np.testing.assert_array_equal(preds, jnet.predict(x))
    back = tckpt.load_model(out / "model", device="cpu")
    np.testing.assert_array_equal(preds, back.predict(x))


@pytest.mark.parametrize("mode", ["binary", "txt"])
def test_save_params_round_trips_through_jax(mode, tmp_path):
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
    from deeplearning4j_tpu_torch.models import zoo as tzoo

    tn = TNet(tzoo.iris_mlp(), device="cpu").init()
    path = tmp_path / f"params.{mode}"
    tckpt.save_params(tn, path, mode=mode)
    jn = JNet(jzoo.iris_mlp()).init()
    jckpt.load_params(jn, path, mode=mode)
    np.testing.assert_array_equal(jn.params_flat(), tn.params_flat())
    jn.set_params_flat(jn.params_flat() * 2)
    jckpt.save_params(jn, tmp_path / f"jax.{mode}", mode=mode)
    tckpt.load_params(tn, tmp_path / f"jax.{mode}", mode=mode)
    np.testing.assert_array_equal(tn.params_flat(), jn.params_flat())


def test_load_params_reads_a_bfloat16_dump(tmp_path):
    import ml_dtypes

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
    from deeplearning4j_tpu_torch.models import zoo as tzoo

    tn = TNet(tzoo.iris_mlp(), device="cpu").init()
    vec = tn.params_flat().astype(ml_dtypes.bfloat16)
    vec.tofile(tmp_path / "p.bin")
    (tmp_path / "p.bin.meta.json").write_text(
        '{"format": 1, "dtype": "bfloat16", "count": %d}' % vec.size)
    tckpt.load_params(tn, tmp_path / "p.bin")
    np.testing.assert_array_equal(tn.params_flat(), vec.astype(np.float32))


def test_train_reads_svmlight_and_pretrains_a_pretrain_conf(tmp_path):
    x, labels = _separable(60, seed=1)
    path = tmp_path / "d.svm"
    path.write_text("".join(
        f"{c} " + " ".join(f"{i + 1}:{v:.4f}" for i, v in enumerate(row))
        + "\n" for row, c in zip((x > 1).astype(np.float32), labels)))
    conf = jzoo.dbn_mnist(layer_sizes=(4, 6), n_out=3)
    (tmp_path / "dbn.json").write_text(conf.to_json())
    rc, text = _run(["train", "-input", str(path), "-model",
                     str(tmp_path / "dbn.json"), "-output",
                     str(tmp_path / "out"), "-epochs", "2", "-batch", "20",
                     "-savemode", "txt", "-device", "cpu"])
    assert rc == 0 and "Trained 2 epochs on 60 examples" in text
    jn = jckpt.load_model(tmp_path / "out" / "model")
    jckpt.load_params(jn, tmp_path / "out" / "params.txt", mode="txt")
    back = tckpt.load_model(tmp_path / "out" / "model", device="cpu")
    np.testing.assert_allclose(jn.params_flat(), back.params_flat(),
                               rtol=1e-6)


@pytest.mark.parametrize("flags,queue", [
    (["-runtime", "spmd"], "A7"), (["-replicas", "2"], "A7"),
    (["-sync-every", "4"], "A7"), (["-resilience"], "A6"),
    (["-resume"], "A6"), (["-ckpt-dir", "x"], "A6"),
    (["-ckpt-every", "5"], "A6"), (["-ckpt-keep", "2"], "A6")],
    ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_unported_train_flags_exit_naming_their_queue(flags, queue,
                                                      csv_file):
    with pytest.raises(SystemExit, match=f"queue {queue}"):
        cli.main(["train", "-input", str(csv_file), "-model",
                  "zoo:iris-mlp", "-device", "cpu"] + flags)


def test_unported_train_properties_exit_too(csv_file, tmp_path):
    props = tmp_path / "train.props"
    props.write_text("# the JAX CLI's keys\ntrain.sync.every=4\n")
    with pytest.raises(SystemExit, match="queue A7"):
        cli.main(["train", "-input", str(csv_file), "-model",
                  "zoo:iris-mlp", "-conf", str(props), "-device", "cpu"])
    assert cli.load_properties(str(props)) == {"train.sync.every": "4"}
