"""PyTorch port: package boundaries, device policy and the CLI.

- Import hygiene: the port imports neither ``jax`` nor anything of the
  JAX package, nor ``ml_dtypes`` or ``transformers`` (a subprocess
  imports every module; an AST scan checks every import statement).
- Environment: the port reads only data and toolchain paths from the
  environment (an AST scan of every ``os.environ`` / ``os.getenv``).
- Device policy: entry points run on the card unless the caller asks for
  the CPU; with no card they raise instead of running on the CPU.
- CLI: ``serve -lm`` loads an LM directory written by the JAX package
  (``lm_config.json`` + ``lm_params.npz`` from ``tree_to_npz``).
"""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.runtime.checkpoint import tree_to_npz
from deeplearning4j_tpu_torch import cli, resolve_device
from deeplearning4j_tpu_torch.clustering import KMeansClustering, kmeans_fit
from deeplearning4j_tpu_torch.ml import NetworkClassifier
from deeplearning4j_tpu_torch.models import RNTN, RecursiveAutoEncoder, zoo
from deeplearning4j_tpu_torch.nlp import (
    HmmPosTagger,
    TreeParser,
    TreeVectorizer,
    default_tagger,
    parse_ptb,
    sentiment_trees,
)
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.runtime.model_import import (
    import_hf_gpt2,
    import_torch_sequential,
)
from deeplearning4j_tpu_torch.serving import ContinuousLMServer
from deeplearning4j_tpu_torch.ui.server import UiServer
from deeplearning4j_tpu_torch.utils import Viterbi
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "deeplearning4j_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeplearning4j_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deeplearning4j_tpu' or m.startswith('deeplearning4j_tpu.')"
        " or m.split('.')[0] in ('ml_dtypes', 'transformers')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # every module was imported: one per source file of the package
    assert int(out.stdout.strip()) == len(list(PORT.rglob("*.py")))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_module_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "deeplearning4j_tpu",
                            "ml_dtypes", "transformers"), (
            f"{path.relative_to(REPO)} imports {name}")


# the environment variables the port may read: data and toolchain paths,
# and the scaleout tracker's two deployment settings (its shared secret
# and frame cap, set alike on the master and its workers)
ENV_ALLOWED = {"DL4J_CACHE_DIR", "MNIST_DIR", "CIFAR10_DIR", "CUDA_HOME",
               "DL4J_NO_DOWNLOAD", "MNIST_BASE_URL", "CIFAR10_URL",
               "TEXT8_PATH", "DL4J_NEWS_DIR", "DL4J_TRACKER_SECRET",
               "DL4J_TRACKER_MAX_FRAME"}


def _env_reads(path):
    """(line, key) of each read of the environment; key None when it is
    not a string literal (a whole-environment read counts as one)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}

    def literal(node):
        return node.value if (isinstance(node, ast.Constant)
                              and isinstance(node.value, str)) else None

    for node in ast.walk(tree):
        is_environ = (isinstance(node, ast.Attribute)
                      and node.attr == "environ"
                      and isinstance(node.value, ast.Name)
                      and node.value.id == "os")
        is_getenv = (isinstance(node, ast.Attribute)
                     and node.attr == "getenv"
                     and isinstance(node.value, ast.Name)
                     and node.value.id == "os")
        if not (is_environ or is_getenv):
            continue
        up = parents.get(node)
        key = None
        if is_getenv and isinstance(up, ast.Call) and up.args:
            key = literal(up.args[0])
        elif isinstance(up, ast.Subscript):
            key = literal(up.slice)
        elif (isinstance(up, ast.Attribute) and up.attr == "get"
              and isinstance(parents.get(up), ast.Call)
              and parents[up].args):
            key = literal(parents[up].args[0])
        elif isinstance(up, ast.Compare):
            key = literal(up.left)
        yield node.lineno, key


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_the_port_reads_only_data_and_toolchain_paths_from_the_env(path):
    for line, key in _env_reads(path):
        assert key in ENV_ALLOWED, (
            f"{path.relative_to(REPO)}:{line} reads the environment "
            f"({key!r}); allowed: {sorted(ENV_ALLOWED)}")


def test_the_env_scan_sees_every_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n"
                   "a = os.environ.get('MNIST_DIR')\n"
                   "b = os.environ['CUDA_HOME']\n"
                   "c = os.getenv('DL4J_NEWS_DIR')\n"
                   "d = 'TEXT8_PATH' in os.environ\n"
                   "e = os.environ.get('DL4J_TPU_FLASH')\n"
                   "f = dict(os.environ)\n")
    assert sorted(_env_reads(src)) == [
        (2, "MNIST_DIR"), (3, "CUDA_HOME"), (4, "DL4J_NEWS_DIR"),
        (5, "TEXT8_PATH"), (6, "DL4J_TPU_FLASH"), (7, None)]


def test_device_policy_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    cfg = tt.TransformerConfig()
    params = tt.params_from_numpy(tt.numpy_params(cfg), device="cpu")
    with pytest.raises(RuntimeError):
        ContinuousLMServer(cfg, params)
    ui = UiServer(port=0)
    try:
        with pytest.raises(RuntimeError):
            ui.serve_lm(cfg, params)
    finally:
        ui.stop()
    with pytest.raises(RuntimeError):
        tt.init_params(cfg)
    with pytest.raises(RuntimeError):
        cli.main(["serve", "-lm", str(REPO / "no-such-dir")])
    trees = [parse_ptb("(1 (1 good) (0 (0 not) (0 bad)))")]
    gpt2 = types.SimpleNamespace(
        config=types.SimpleNamespace(vocab_size=8, n_positions=4, n_embd=4,
                                     n_layer=0, n_head=1),
        state_dict=lambda: {})
    iris_conf = zoo.iris_mlp()
    entry_points = [
        lambda: NetworkClassifier(iris_conf, epochs=1).fit(
            np.zeros((4, 4), np.float32), np.zeros(4, np.int64)),
        lambda: import_hf_gpt2(gpt2),
        lambda: import_torch_sequential(
            torch.nn.Sequential(torch.nn.Linear(4, 3))),
        lambda: RNTN().fit(trees),
        lambda: RecursiveAutoEncoder().fit(trees),
        lambda: KMeansClustering(2),
        lambda: kmeans_fit(np.zeros((4, 2), np.float32), 2),
        lambda: Viterbi(np.eye(2)),
        lambda: HmmPosTagger(),
        lambda: default_tagger(),
        lambda: TreeParser(),
        lambda: TreeVectorizer(),
        lambda: sentiment_trees(),
    ]
    for make in entry_points:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def _write_jax_lm(tmp_path, dtype):
    """What the JAX package's ``dl4j lm`` saves."""
    jcfg = jt.TransformerConfig(vocab_size=256, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, max_len=32,
                                attn_bias=True, tie_embeddings=True,
                                dtype=dtype)
    params = jt.init_params(jcfg, jax.random.PRNGKey(0))
    out = tmp_path / "lm"
    out.mkdir()
    (out / "lm_config.json").write_text(json.dumps(jcfg.__dict__))
    tree_to_npz(out / "lm_params.npz", params)
    return out, jcfg, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_loads_an_lm_saved_by_the_jax_package(tmp_path, dtype):
    out, jcfg, jparams = _write_jax_lm(tmp_path, dtype)
    cfg, params = cli.load_saved_lm(out, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert params["embed"].dtype == getattr(torch, dtype)
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               jparams))
    got = jax.tree_util.tree_leaves_with_path(tt.params_to_numpy(params))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cli_rejects_parameters_that_do_not_fit_the_config(tmp_path):
    out, jcfg, _ = _write_jax_lm(tmp_path, "float32")
    cfg = json.loads((out / "lm_config.json").read_text())
    cfg["d_ff"] = 128
    (out / "lm_config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="shape"):
        cli.load_saved_lm(out, device="cpu")


def test_cli_serve_boots_and_stops(tmp_path, capsys):
    out, _, _ = _write_jax_lm(tmp_path, "float32")
    rc = cli.main(["serve", "-lm", str(out), "-device", "cpu", "-port", "0",
                   "-lm-slots", "2", "-page-size", "4", "-lm-pages", "20",
                   "-prefill-chunk", "4", "-serve-seconds", "0.05"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "20 pages x 4 tokens" in text and "Serving on http://" in text
