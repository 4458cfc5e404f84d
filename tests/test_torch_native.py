"""PyTorch port, slice 9: the native data-IO library
(`deeplearning4j_tpu_torch.native`, the port's copy of ``dataio.cpp``,
built with g++ into ``_kernels_build/``) against the JAX package's
native readers and against the numpy parsers, on seeded files.

Everything is compared exactly: both libraries parse with the same C++
(``strtod`` into float64), and the datasets round to float32 the same
way.
"""

import gzip
import struct

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.datasets import fetchers as jfetch
from deeplearning4j_tpu_torch import _build
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch.datasets import fetchers as tfetch
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dataio")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 5)).astype(np.float32)
    labels = rng.integers(0, 4, 40)
    csv = d / "data.csv"
    np.savetxt(csv, np.column_stack([labels, x]), delimiter=",", fmt="%.6f",
               header="label,a,b,c,d,e", comments="")
    semi = d / "data_semi.csv"
    np.savetxt(semi, np.column_stack([x, labels]), delimiter=";",
               fmt="%.6f")
    svm = d / "data.svm"
    with open(svm, "w") as f:
        for row, lab in zip(x, labels):
            toks = [f"{j + 1}:{v:.6f}" for j, v in enumerate(row) if v > 0]
            f.write(f"{2 * lab - 3} qid:1 " + " ".join(toks) + " # c\n")
    idx = d / "images-idx3-ubyte"
    img = rng.integers(0, 256, (7, 4, 3)).astype(np.uint8)
    with open(idx, "wb") as f:
        f.write(struct.pack(">I", 0x0803) + struct.pack(">III", 7, 4, 3))
        f.write(img.tobytes())
    return {"csv": csv, "semi": semi, "svm": svm, "idx": idx, "img": img,
            "x": x, "labels": labels}


def test_library_builds_into_the_kernel_build_directory():
    assert tnative.have_native(), tnative.BUILD_ERROR
    path = tnative.library_path()
    assert path.parent == _build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libdataio-") and path.suffix == ".so"
    assert not (tnative.SOURCE.parent / "_dataio.so").exists()


def test_the_port_keeps_its_own_copy_of_the_source():
    """Same parsers as the JAX package's dataio.cpp (the two files differ
    only in their header comment)."""
    mine = tnative.SOURCE.read_text()
    theirs = (jnative._SRC).read_text()
    body = lambda s: s[s.index("#include"):]  # noqa: E731
    assert body(mine) == body(theirs)


def test_csv_read_equals_jax_and_numpy(files):
    got = tnative.csv_read(str(files["csv"]), skip_header=True, label_col=0)
    want = jnative.csv_read(str(files["csv"]), skip_header=True, label_col=0)
    for a, b in zip(got, want):
        assert a.dtype == np.float64 and a.tobytes() == b.tobytes()
    raw = np.genfromtxt(files["csv"], delimiter=",", skip_header=1)
    np.testing.assert_array_equal(got[0], raw[:, 1:])
    np.testing.assert_array_equal(got[1], raw[:, 0])


def test_svmlight_read_equals_jax(files):
    for n in (0, 5, 7):
        got = tnative.svmlight_read(str(files["svm"]), n)
        want = jnative.svmlight_read(str(files["svm"]), n)
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes()


def test_idx_read_equals_jax_and_the_numpy_reader(files):
    got = tnative.idx_read(str(files["idx"]))
    assert got.tobytes() == jnative.idx_read(str(files["idx"])).tobytes()
    np.testing.assert_array_equal(
        got, tfetch.read_idx(files["idx"]).reshape(7, -1).astype(np.float64))


def test_a_bad_file_raises_value_error(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,3\n4,5\n")
    with pytest.raises(ValueError, match="ragged CSV row"):
        tnative.csv_read(str(bad))
    with pytest.raises(ValueError, match="cannot read file"):
        tnative.svmlight_read(str(tmp_path / "missing.svm"))


@pytest.mark.parametrize("kind", ["csv", "semi", "svm"])
def test_fetchers_read_natively_and_equal_jax(files, kind):
    before = dict(tnative.READS)
    if kind == "svm":
        got = tfetch.svmlight_dataset(str(files["svm"]), 5)
        want = jfetch.svmlight_dataset(str(files["svm"]), 5)
        reader = "svmlight_read"
    else:
        kw = (dict(skip_header=True, label_col=0) if kind == "csv"
              else dict(delimiter=";"))
        got = tfetch.csv_dataset(str(files[kind]), **kw)
        want = jfetch.csv_dataset(str(files[kind]), **kw)
        reader = "csv_read"
    assert tnative.READS[reader] == before.get(reader, 0) + 1
    assert got.features.dtype == np.float32
    assert got.features.tobytes() == np.asarray(want.features).tobytes()
    assert got.labels.tobytes() == np.asarray(want.labels).tobytes()
    np.testing.assert_allclose(got.features, files["x"] if kind != "svm"
                               else np.where(files["x"] > 0, files["x"], 0),
                               atol=1e-6)


def test_without_a_compiler_the_python_parsers_read_the_same(
        files, monkeypatch, tmp_path):
    """No g++: `have_native()` is False, `BUILD_ERROR` says why, and the
    fetchers' Python parsers give the native readers' arrays."""
    native_csv = tfetch.csv_dataset(str(files["csv"]), skip_header=True,
                                    label_col=0)
    native_svm = tfetch.svmlight_dataset(str(files["svm"]), 5)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_ERROR", None)
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "libdataio-none.so")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.have_native()
    assert tnative.BUILD_ERROR == "g++ not found"
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.csv_read(str(files["csv"]))
    py_csv = tfetch.csv_dataset(str(files["csv"]), skip_header=True,
                                label_col=0)
    py_svm = tfetch.svmlight_dataset(str(files["svm"]), 5)
    for a, b in ((py_csv, native_csv), (py_svm, native_svm)):
        assert a.features.tobytes() == b.features.tobytes()
        assert a.labels.tobytes() == b.labels.tobytes()


def test_gzip_idx_stays_on_the_numpy_reader(files, tmp_path):
    gz = tmp_path / "images-idx3-ubyte.gz"
    with gzip.open(gz, "wb") as f:
        f.write(files["idx"].read_bytes())
    np.testing.assert_array_equal(tfetch.read_idx(gz), files["img"])
