"""PyTorch port, slice 16: model import (`runtime/model_import.py`) against
the JAX package and the source models.

- `import_hf_gpt2` on a tiny random ``GPT2LMHeadModel`` (built in the
  process, no download): the port's tree equals JAX's leaf for leaf,
  its logits match HF's within 2e-4 and JAX's within 1e-5; an untied
  head is honoured; each refusal raises as in JAX; an object with only
  ``.config`` and ``.state_dict()`` imports the same.
- `import_torch_sequential`: the MLP and conv cases of
  ``tests/test_model_import.py``, port against JAX (1e-6) against torch
  (1e-5 / 1e-4, JAX's tolerances), and the same refusals.
"""

import types

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.runtime import model_import as jmi
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.runtime import model_import as tmi
from deeplearning4j_tpu_torch.tree import flatten_tree
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

transformers = pytest.importorskip("transformers")

HF_ATOL = 2e-4          # the port's logits vs HF's (JAX's own test: 2e-4)
JAX_ATOL = 1e-5         # the port's logits vs JAX's on the same weights


def _tiny_gpt2(seed=0, **kw):
    cfg = transformers.GPT2Config(
        vocab_size=97, n_positions=32, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, **kw)
    torch.manual_seed(seed)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _jax_leaves(params) -> dict:
    return {"//".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}


def _same_tree(tparams, jparams):
    got = {k: v.detach().numpy() for k, v in flatten_tree(tparams).items()}
    want = _jax_leaves(jparams)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _tokens(cfg, seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def test_hf_gpt2_tree_equals_jax_and_logits_match_hf_and_jax():
    model = _tiny_gpt2()
    tcfg, tparams = tmi.import_hf_gpt2(model, device="cpu")
    jcfg, jparams = jmi.import_hf_gpt2(model)
    assert tcfg.__dict__ == jcfg.__dict__
    assert tcfg.attn_bias and not tcfg.tie_embeddings
    _same_tree(tparams, jparams)
    tokens = _tokens(tcfg)
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.numpy()
        got = tt.apply(tcfg, tparams, torch.tensor(tokens)).numpy()
    jgot = np.asarray(jt.apply(jcfg, jparams, tokens.astype(np.int32)))
    np.testing.assert_allclose(got, want, atol=HF_ATOL)
    np.testing.assert_allclose(got, jgot, atol=JAX_ATOL)


def test_imported_weights_do_not_share_memory_with_the_model():
    model = _tiny_gpt2(seed=3)
    _, params = tmi.import_hf_gpt2(model, device="cpu")
    before = model.transformer.wte.weight.detach().clone()
    with torch.no_grad():
        params["embed"].add_(1.0)
        params["layers"][0]["mlp"]["w1"].add_(1.0)
    torch.testing.assert_close(model.transformer.wte.weight.detach(),
                               before, rtol=0, atol=0)


def test_untied_head_is_honoured():
    model = _tiny_gpt2(seed=1)
    with torch.no_grad():
        model.lm_head.weight = torch.nn.Parameter(
            torch.randn_like(model.lm_head.weight))
    assert (model.lm_head.weight.data_ptr()
            != model.transformer.wte.weight.data_ptr())
    tcfg, tparams = tmi.import_hf_gpt2(model, device="cpu")
    _, jparams = jmi.import_hf_gpt2(model)
    _same_tree(tparams, jparams)
    np.testing.assert_array_equal(
        tparams["head"].numpy(), model.lm_head.weight.detach().numpy().T)
    tokens = _tokens(tcfg, seed=1)
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.numpy()
        got = tt.apply(tcfg, tparams, torch.tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=HF_ATOL)


def test_an_object_with_config_and_state_dict_imports_the_same():
    model = _tiny_gpt2(seed=2)
    hf = model.config
    plain = types.SimpleNamespace(
        vocab_size=hf.vocab_size, n_positions=hf.n_positions,
        n_embd=hf.n_embd, n_layer=hf.n_layer, n_head=hf.n_head,
        n_inner=None)
    weights = {k: v.detach().numpy().copy()
               for k, v in model.state_dict().items()}
    stand_in = types.SimpleNamespace(config=plain,
                                     state_dict=lambda: weights)
    cfg_a, a = tmi.import_hf_gpt2(stand_in, device="cpu")
    cfg_b, b = tmi.import_hf_gpt2(model, device="cpu")
    assert cfg_a == cfg_b
    for (ka, va), (kb, vb) in zip(flatten_tree(a).items(),
                                  flatten_tree(b).items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


@pytest.mark.parametrize("kw,match", [
    ({"activation_function": "relu"}, "activation"),
    ({"layer_norm_epsilon": 1e-6}, "layer_norm_epsilon"),
    ({"scale_attn_by_inverse_layer_idx": True},
     "scale_attn_by_inverse_layer_idx"),
    ({"reorder_and_upcast_attn": True}, "reorder_and_upcast_attn"),
    ({"scale_attn_weights": False}, "scale_attn_weights"),
])
def test_unsupported_gpt2_variants_are_refused_as_in_jax(kw, match):
    cfg = transformers.GPT2Config(vocab_size=31, n_positions=8, n_embd=8,
                                  n_layer=1, n_head=2, **kw)
    model = transformers.GPT2LMHeadModel(cfg)
    with pytest.raises(ValueError, match=match):
        jmi.import_hf_gpt2(model)
    with pytest.raises(ValueError, match=match):
        tmi.import_hf_gpt2(model, device="cpu")


def test_imported_gpt2_trains_on_the_port():
    model = _tiny_gpt2(seed=5)
    cfg, params = tmi.import_hf_gpt2(model, device="cpu")
    for t in flatten_tree(params).values():
        t.requires_grad_(True)
    tokens = torch.tensor(_tokens(cfg, seed=5, shape=(2, 17)))
    loss = tt.lm_loss(cfg, params, tokens[:, :-1], tokens[:, 1:])
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(t.grad).all()
               for t in flatten_tree(params).values())


# ---------------------------------------------------------------------------
# torch.nn.Sequential -> MultiLayerNetwork


def _mlp(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(4, 16), torch.nn.ReLU(),
        torch.nn.Linear(16, 8), torch.nn.Tanh(),
        torch.nn.Dropout(0.1),
        torch.nn.Linear(8, 3))


def _convnet(seed=1, pool=torch.nn.MaxPool2d):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Conv2d(1, 4, 3), torch.nn.ReLU(),      # valid padding
        pool(2),
        torch.nn.Flatten(),
        torch.nn.Linear(4 * 5 * 5, 10))


def _torch_probs(model, x_nhwc):
    x = torch.from_numpy(x_nhwc)
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        return torch.softmax(model.eval()(x), dim=1).numpy()


@pytest.mark.parametrize("case", ["mlp", "conv_max", "conv_avg"])
def test_sequential_import_matches_jax_and_torch(case):
    if case == "mlp":
        model, tol = _mlp(), 1e-5
        x = np.random.default_rng(0).random((10, 4)).astype(np.float32)
    else:
        pool = (torch.nn.MaxPool2d if case == "conv_max"
                else torch.nn.AvgPool2d)
        model, tol = _convnet(pool=pool), 1e-4
        x = np.random.default_rng(1).random((3, 12, 12, 1)).astype(
            np.float32)
    tnet, treport = tmi.import_torch_sequential(model, device="cpu")
    jnet, jreport = jmi.import_torch_sequential(model)
    assert treport == jreport
    assert tnet.conf.to_json() == jnet.conf.to_json()
    for tl, jl in zip(tnet.params, jnet.params):
        assert sorted(tl) == sorted(jl)
        for k in jl:
            np.testing.assert_array_equal(tl[k].detach().numpy(),
                                          np.asarray(jl[k]))
    got = tnet.label_probabilities(x)
    np.testing.assert_allclose(got, np.asarray(jnet.label_probabilities(x)),
                               atol=1e-6)
    np.testing.assert_allclose(got, _torch_probs(model, x), atol=tol)


def test_imported_sequential_trains_and_keeps_the_source_intact():
    model = _mlp(seed=2)
    before = [p.detach().clone() for p in model.parameters()]
    net, _ = tmi.import_torch_sequential(model, learning_rate=0.1,
                                         device="cpu")
    rng = np.random.default_rng(2)
    x = rng.random((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    first = net.score(x, y)
    for _ in range(20):
        net.fit_batch(x, y)
    assert net.score(x, y) < first
    for p, b in zip(model.parameters(), before):
        torch.testing.assert_close(p.detach(), b, rtol=0, atol=0)


@pytest.mark.parametrize("mods,match", [
    ([torch.nn.Linear(4, 4), torch.nn.LSTM(4, 4)], "unsupported"),
    ([torch.nn.ReLU()], "no Linear"),
    ([torch.nn.Conv2d(2, 4, 3, groups=2), torch.nn.Flatten(),
      torch.nn.Linear(4, 2)], "grouped"),
])
def test_sequential_refusals_as_in_jax(mods, match):
    model = torch.nn.Sequential(*mods)
    with pytest.raises(ValueError, match=match):
        jmi.import_torch_sequential(model)
    with pytest.raises(ValueError, match=match):
        tmi.import_torch_sequential(model, device="cpu")
