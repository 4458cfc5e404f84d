"""PyTorch port: three behaviours held to the JAX package's on the CPU.

- `runtime.checkpoint.save_params` writes the net's native parameter
  dtype: a bfloat16 `MultiLayerNetwork` with the JAX net's weights writes
  the bytes JAX's writes (the raw 2-byte words and the ``bfloat16``
  sidecar; the txt file's float32 values under ``# dtype: bfloat16``),
  each package loads the other's file, ``dtype=np.float32`` forces
  float32, and ``train -precision bf16 -savemode binary`` writes JAX's
  dtype.
- `UiServer.serve_lm(continuous=False)` builds no pool: over HTTP, the
  greedy, top-k and beam answers equal JAX's front's and JAX's
  `generate` / `beam_search`, and speculate, stream, ``/lm/prefill`` and
  ``/lm/admit_pages`` get the JAX front's 400s, body for body.
  Registering again stops the old pool.
- `nn.layers.core.rnn_output_apply` (the ``rnnoutputlayer``) gives JAX's
  output within 1e-6 on float32 ``[b, t, f]`` input.
"""

import dataclasses
import functools
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu.ui.server import UiServer as JaxUiServer
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
from deeplearning4j_tpu_torch.ui.server import UiServer
from test_torch_cli_train import csv_file  # noqa: F401 — fixture
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


# ---------------------------------------------------------------------------
# save_params in the native dtype


def _bf16_pair():
    """A bf16 iris MLP in each package with the same (bf16) weights."""
    jn = JNet(jzoo.iris_mlp()).init()
    jn.set_precision("bf16")
    tn = TNet(tzoo.iris_mlp(), device="cpu").init()
    tn.set_precision("bf16")
    tn.set_params_flat(jn.params_flat())
    assert all(p.dtype == torch.bfloat16 for _, p in tn._param_leaves())
    return jn, tn


@pytest.mark.parametrize("mode", ["binary", "txt"])
def test_a_bf16_net_writes_jax_bytes(mode, tmp_path):
    jn, tn = _bf16_pair()
    jpath, tpath = tmp_path / f"jax.{mode}", tmp_path / f"port.{mode}"
    jckpt.save_params(jn, jpath, mode=mode)
    tckpt.save_params(tn, tpath, mode=mode)
    assert tpath.read_bytes() == jpath.read_bytes()
    if mode == "binary":
        assert tpath.stat().st_size == 2 * tn.num_params()
        side = tmp_path / f"port.{mode}.meta.json"
        assert side.read_bytes() == \
            (tmp_path / f"jax.{mode}.meta.json").read_bytes()
        assert json.loads(side.read_text()) == {
            "format": 1, "dtype": "bfloat16", "count": tn.num_params()}
    else:
        assert tpath.read_text().startswith("# dtype: bfloat16\n")


@pytest.mark.parametrize("mode", ["binary", "txt"])
def test_each_package_loads_the_others_bf16_file(mode, tmp_path):
    jn, tn = _bf16_pair()
    want = jn.params_flat()
    tckpt.save_params(tn, tmp_path / "port", mode=mode)
    jback = JNet(jzoo.iris_mlp()).init()
    jback.set_precision("bf16")
    jckpt.load_params(jback, tmp_path / "port", mode=mode)
    np.testing.assert_array_equal(jback.params_flat(), want)
    jckpt.save_params(jn, tmp_path / "jax", mode=mode)
    tback = TNet(tzoo.iris_mlp(), device="cpu").init()
    tback.set_precision("bf16")
    tckpt.load_params(tback, tmp_path / "jax", mode=mode)
    np.testing.assert_array_equal(tback.params_flat(), want)


def test_dtype_float32_forces_the_float32_file(tmp_path):
    jn, tn = _bf16_pair()
    jckpt.save_params(jn, tmp_path / "jax.bin", dtype=np.float32)
    tckpt.save_params(tn, tmp_path / "port.bin", dtype=np.float32)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    assert json.loads((tmp_path / "port.bin.meta.json").read_text())[
        "dtype"] == "float32"
    # a float32 net's native file is the float32 one
    f32 = TNet(tzoo.iris_mlp(), device="cpu").init()
    tckpt.save_params(f32, tmp_path / "f32.bin")
    assert (tmp_path / "f32.bin").read_bytes() == \
        f32.params_flat().tobytes()


def test_train_savemode_binary_on_a_bf16_net_writes_jax_dtype(
        csv_file, tmp_path):  # noqa: F811 — the imported fixture
    out = tmp_path / "out"
    assert cli.main(["train", "-input", str(csv_file), "-model",
                     "zoo:iris-mlp", "-output", str(out), "-epochs", "2",
                     "-batch", "32", "-precision", "bf16", "-savemode",
                     "binary", "-device", "cpu"]) == 0
    meta = json.loads((out / "params.bin.meta.json").read_text())
    assert meta["dtype"] == "bfloat16"
    assert (out / "params.bin").stat().st_size == 2 * meta["count"]
    jn = jckpt.load_model(out / "model")
    jckpt.load_params(jn, out / "params.bin")
    back = tckpt.load_model(out / "model", device="cpu")
    np.testing.assert_array_equal(jn.params_flat(), back.params_flat())


# ---------------------------------------------------------------------------
# serve_lm(continuous=False)

JCFG = jt.TransformerConfig(vocab_size=64, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=32,
                            attn_bias=True, tie_embeddings=True)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))
PROMPT = [3, 1, 4, 1, 5]


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(CFG, seed=0)


def _jparams():
    return jax.tree_util.tree_map(jnp.asarray, _tree())


def _post(url, data, binary=False):
    body = data if binary else json.dumps(data).encode()
    kind = "application/octet-stream" if binary else "application/json"
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": kind})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def whole_sequence_fronts():
    jax_ui = JaxUiServer(port=0).serve_lm(JCFG, _jparams(),
                                          continuous=False)
    jax_ui.start()
    port_ui = UiServer(port=0)
    port_ui.serve_lm(CFG, _tree(), slots=2, page_size=4, device="cpu")
    pool = port_ui.state.lm_server
    port_ui.serve_lm(CFG, _tree(), continuous=False, device="cpu")
    port_ui.start()
    yield jax_ui, port_ui, pool
    port_ui.stop()
    jax_ui.stop()


def _both(fronts, path, payload, binary=False):
    return [_post(ui.url + path, payload, binary) for ui in fronts[:2]]


def test_registering_again_stops_the_pool(whole_sequence_fronts):
    jax_ui, port_ui, pool = whole_sequence_fronts
    assert not pool._running and pool._thread is None
    assert port_ui.state.lm_server is None
    assert jax_ui.state.lm_server is None
    assert port_ui.serving_stats()["lm"] is None


@pytest.mark.parametrize("knobs", [
    {}, {"top_k": 1, "temperature": 1.0}, {"top_k": 4},
    {"top_p": 0.5, "temperature": 0.0}],
    ids=["greedy", "top_k_1", "top_k_greedy", "top_p_greedy"])
def test_whole_sequence_answers_equal_jax(whole_sequence_fronts, knobs):
    payload = {"prompt_ids": PROMPT, "max_new_tokens": 6, **knobs}
    (jc, jb), (c, b) = _both(whole_sequence_fronts, "/lm/generate",
                             payload)
    assert jc == c == 200, (jb, b)
    want = np.asarray(jgen.generate(JCFG, _jparams(),
                                    np.asarray([PROMPT], np.int32), 6))
    assert b["ids"] == jb["ids"] == want[0].tolist()


def test_beam_answer_equals_jax(whole_sequence_fronts):
    payload = {"prompt_ids": PROMPT, "max_new_tokens": 5, "beam_size": 3}
    (jc, jb), (c, b) = _both(whole_sequence_fronts, "/lm/generate",
                             payload)
    assert jc == c == 200
    out, scores = jgen.beam_search(JCFG, _jparams(),
                                   np.asarray([PROMPT], np.int32),
                                   max_new_tokens=5, beam_size=3)
    assert b["ids"] == jb["ids"] == np.asarray(out)[0].tolist()
    assert b["score"] == pytest.approx(float(scores[0]), abs=1e-5)


@pytest.mark.parametrize("path,payload,binary", [
    ("/lm/generate", {"prompt_ids": PROMPT, "max_new_tokens": 4,
                      "speculate": True}, False),
    ("/lm/generate", {"prompt_ids": PROMPT, "max_new_tokens": 4,
                      "stream": True}, False),
    ("/lm/prefill", {"prompt_ids": PROMPT}, False),
    ("/lm/admit_pages", b"", True)],
    ids=["speculate", "stream", "prefill", "admit_pages"])
def test_pool_requests_get_jax_400s(whole_sequence_fronts, path, payload,
                                    binary):
    (jc, jb), (c, b) = _both(whole_sequence_fronts, path, payload, binary)
    assert jc == c == 400
    assert b == jb
    assert "continuous" in b["error"]


# ---------------------------------------------------------------------------
# rnn_output_apply


@pytest.mark.parametrize("activation", ["softmax", "identity", "tanh"])
def test_rnn_output_apply_matches_jax(activation):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    bias = rng.standard_normal((3,)).astype(np.float32)
    x = rng.standard_normal((2, 7, 5)).astype(np.float32)
    kw = dict(n_in=5, n_out=3, activation=activation)
    want, _ = jcore.rnn_output_apply(
        jlayers.RnnOutputLayerConf(**kw),
        {"W": jnp.asarray(w), "b": jnp.asarray(bias)}, {}, jnp.asarray(x))
    got, _ = tcore.rnn_output_apply(
        tlayers.RnnOutputLayerConf(**kw),
        {"W": torch.from_numpy(w), "b": torch.from_numpy(bias)}, {},
        torch.from_numpy(x))
    assert got.shape == (2, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    from deeplearning4j_tpu_torch.nn.layers import get_layer_impl

    impl = get_layer_impl(tlayers.RnnOutputLayerConf(**kw))
    assert impl.apply is tcore.rnn_output_apply
