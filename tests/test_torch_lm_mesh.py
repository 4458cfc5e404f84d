"""PyTorch port, slice 19: the `lm` mesh runtimes, `dryrun`, and the
public names of the mesh modules, against the JAX package's.

- `_lm_mesh_layout` equals JAX's for every device count and case.
- ``lm -runtime spmd|hybrid|pipeline -device cpu`` trains, saves and
  generates (one host device: the trivial mesh, as on one TPU chip);
  `_lm_mesh_train` on 8 host shards trains both mesh layouts to a finite,
  falling loss.
- The spmd step on 2 host shards equals the local step on the same
  batches within 1e-6 (float32, Adam).
- The port's dry run on 4 host shards is GREEN and writes its log.
- Each port module defines every public name of its JAX counterpart.
"""

import argparse
import importlib
import inspect
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu_torch import cli as tcli
from deeplearning4j_tpu_torch import dryrun as tdry
from deeplearning4j_tpu_torch.parallel import hybrid as th
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.tree import tree_leaves
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

LM_ARGS = ["-seq", "16", "-batch", "4", "-d-model", "16", "-layers", "2",
           "-heads", "2", "-epochs", "1"]


def _corpus(tmp_path, n=1200):
    rng = np.random.default_rng(0)
    words = ["the", "mesh", "ring", "stage", "model", "data", "seq"]
    text = " ".join(words[i] for i in rng.integers(0, len(words), n))
    path = tmp_path / "corpus.txt"
    path.write_text(text)
    return path


def test_layout_equals_jax():
    for n in (1, 2, 3, 4, 6, 8, 16):
        for runtime in ("hybrid", "pipeline"):
            for s, heads, layers, b in ((16, 4, 4, 8), (15, 3, 3, 7),
                                        (1024, 12, 12, 8), (16, 4, 3, 8)):
                assert tcli._lm_mesh_layout(runtime, n, s, heads, layers,
                                            b) == \
                    jcli._lm_mesh_layout(runtime, n, s, heads, layers, b)
    # the cases of tests/test_cli.py
    assert tcli._lm_mesh_layout("hybrid", 1, 16, 4, 4, 8)[0] == (1, 1, 1)
    assert tcli._lm_mesh_layout("pipeline", 1, 16, 4, 4, 8)[0] == (1, 1)
    assert tcli._lm_mesh_layout("pipeline", 8, 16, 4, 3, 8)[0] == (8, 1)
    assert tcli._lm_mesh_layout("hybrid", 4, 1024, 12, 12, 8) == \
        ((1, 2, 2), 8, None)
    assert tcli._lm_mesh_layout("pipeline", 4, 1024, 12, 12, 8) == \
        ((1, 4), 8, 2)


@pytest.mark.parametrize("runtime", ["spmd", "hybrid", "pipeline"])
def test_cli_runtime_trains_saves_and_generates(tmp_path, capsys, runtime):
    corpus = _corpus(tmp_path)
    out = tmp_path / "lm"
    assert tcli.main(["lm", "-input", str(corpus), "-output", str(out),
                      *LM_ARGS, "-runtime", runtime, "-device", "cpu",
                      "-generate", "the", "-max-new", "8"]) == 0
    text = capsys.readouterr().out
    first = {"spmd": "spmd: only 1 device visible — equivalent to local",
             "hybrid": "hybrid: training on mesh dp1/sp1/tp1 over 1 devices",
             "pipeline": "pipeline: training on mesh dp1/pp1 "
                         "(microbatches=2)"}[runtime]
    assert first in text
    assert "LM saved to" in text and "Trained" in text
    assert (out / "lm_params.npz").exists()
    cfg, params = tcli.load_saved_lm(out, device="cpu")
    assert cfg.n_layers == 2 and params["embed"].shape == (256, 16)
    # the saved LM loads and generates again without -input
    assert tcli.main(["lm", "-output", str(out), "-device", "cpu",
                      "-generate", "the", "-max-new", "4"]) == 0


def test_experts_under_pipeline_exit_naming_pipeline(tmp_path):
    with pytest.raises(SystemExit, match="pipeline"):
        tcli.main(["lm", "-input", str(_corpus(tmp_path)), *LM_ARGS,
                   "-experts", "2", "-runtime", "pipeline", "-device",
                   "cpu"])


@pytest.mark.parametrize("runtime,layout", [
    ("hybrid", "hybrid: training on mesh dp2/sp2/tp2 over 8 devices"),
    ("pipeline", "pipeline: training on mesh dp4/pp2 (microbatches=2)"),
])
def test_mesh_train_on_8_host_shards(tmp_path, capsys, monkeypatch,
                                     runtime, layout):
    losses = []
    cls = {"hybrid": th.HybridParallelTrainer,
           "pipeline": th.PipelineParallelTrainer}[runtime]

    class Recording(cls):
        def fit_batch_async(self, tokens, targets):
            loss = super().fit_batch_async(tokens, targets)
            losses.append(float(loss))
            return loss

    monkeypatch.setattr(th, cls.__name__, Recording)
    ids = np.frombuffer(_corpus(tmp_path, 700).read_bytes(),
                        np.uint8).astype(np.int64)
    args = argparse.Namespace(runtime=runtime, accum=1, lr=3e-3,
                              updater="adam", epochs=1, verbose=False,
                              device="cpu")
    cfg = tt.TransformerConfig(vocab_size=256, d_model=16, n_heads=2,
                               n_layers=2, d_ff=64, max_len=16)
    params = tcli._lm_mesh_train(args, cfg, ids, 7, 16,
                                 devices=[torch.device("cpu")] * 8)
    text = capsys.readouterr().out
    assert layout in text
    assert "-batch rounded up to 8" in text
    assert all(np.isfinite(losses)) and len(losses) > 20
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert set(params) == {"embed", "pos", "ln_f", "layers", "head"}
    assert params["layers"][1]["attn"]["wq"].shape == (16, 2, 8)


def test_spmd_step_equals_local():
    cfg = tt.TransformerConfig(vocab_size=31, d_model=16, n_heads=2,
                               n_layers=2, d_ff=32, max_len=8)
    tree = tt.numpy_params(cfg, seed=3)
    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.integers(0, 31, (8, 9)))
               for _ in range(3)]
    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    out = {}
    for name, m in (("local", None), ("spmd", mesh)):
        params = th._master_f32(tt.params_from_numpy(tree, device="cpu"))
        step, init = th.make_accum_train_step(cfg, lr=1e-2, accum=2,
                                              updater="adam", mesh=m)
        opt = init(params)
        losses = []
        for b in batches:
            params, opt, loss = step(params, opt, b[:, :-1], b[:, 1:])
            losses.append(float(loss))
        out[name] = (tree_leaves(params), losses)
    np.testing.assert_allclose(out["spmd"][1], out["local"][1], atol=1e-6)
    for a, b in zip(out["spmd"][0], out["local"][0]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)


def test_dryrun_on_4_host_shards_is_green(tmp_path, capsys):
    assert tdry.main(["4", "--device", "cpu", "--out", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "dryrun GREEN" in text
    for line in ("dryrun dp(4): ok", "dryrun dp(4)+zero1: ok",
                 "dryrun dp/sp/tp/ep mesh=(1,2,2): ok",
                 "dryrun dp/pp mesh=(2,2) microbatches=2: ok"):
        assert line in text
    logs = list(tmp_path.glob("dryrun_*.log"))
    assert len(logs) == 1
    head = logs[0].read_text().splitlines()
    assert head[0].startswith("# multichip dryrun evidence")
    for field in ("git_sha:", "n_devices: 4", "result: GREEN",
                  "wall_time_s:", "command:"):
        assert any(line.startswith(field) for line in head), field
    assert tdry._split_axes(8, 3) == (2, 2, 2)
    assert tdry._split_axes(4, 3) == (1, 2, 2)
    assert tdry._split_axes(6, 2) == (2, 3)


def _public(mod) -> set:
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", mod.__name__) == mod.__name__
            and n != "annotations"}


@pytest.mark.parametrize("name", ["hybrid", "pipeline", "ring_attention",
                                  "transformer"])
def test_port_module_defines_every_public_jax_name(name):
    jmod = importlib.import_module(f"deeplearning4j_tpu.parallel.{name}")
    tmod = importlib.import_module(f"deeplearning4j_tpu_torch.parallel.{name}")
    missing = sorted(n for n in _public(jmod) if not hasattr(tmod, n))
    assert not missing, missing
    assert _public(jmod)                     # the scan sees the names
    for n in _public(jmod):
        if inspect.isclass(getattr(jmod, n)):
            assert inspect.isclass(getattr(tmod, n)), n
