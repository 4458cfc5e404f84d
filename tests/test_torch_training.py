"""PyTorch port: the LM training slice.

`lm_loss` and its gradient tree, every updater, the accumulating train
step, the npz checkpoint and the ``lm`` CLI, each held against the JAX
package on the same numpy inputs and weights.  Tolerances: 1e-4 on the
loss and gradients of the model (float32; the two frameworks sum in
different orders), 1e-6 relative on the updaters (the same float32
formulas), and 1e-5 on the train step's losses and 1e-4 on its
parameters after 3 Adam steps.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.ops import updaters as ju
from deeplearning4j_tpu.parallel import hybrid as jh
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.runtime.checkpoint import tree_to_npz as j_tree_to_npz
from deeplearning4j_tpu_torch import cli as tcli
from deeplearning4j_tpu_torch.ops import updaters as tu
from deeplearning4j_tpu_torch.parallel import hybrid as th
from deeplearning4j_tpu_torch.parallel import kernels as tk
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.runtime import checkpoint as tc
from deeplearning4j_tpu_torch.tree import tree_leaves
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


def _cfgs(tied=True, bias=True, remat=False, vocab=64, max_len=16):
    jcfg = jt.TransformerConfig(vocab_size=vocab, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, max_len=max_len,
                                attn_bias=bias, tie_embeddings=tied,
                                remat=remat)
    return jcfg, tt.TransformerConfig(**dataclasses.asdict(jcfg))


def _tree(cfg, seed=0):
    """numpy weights with non-zero biases and norm offsets, so every
    parameter carries a gradient."""
    tree = tt.numpy_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, a):
        if path[-1] in ("bias", "scale", "b1", "b2", "bq", "bk", "bv", "bo"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        return perturb(path, t)

    return walk(tree)


def _jnp(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _batch(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, s)).astype(np.int32),
            rng.integers(0, vocab, (b, s)).astype(np.int32))


def _leaves_np(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            tree))


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("tied,bias", [(True, True), (True, False),
                                       (False, True), (False, False)])
def test_lm_loss_and_gradients_match_jax(tied, bias, remat):
    jcfg, cfg = _cfgs(tied, bias, remat)
    tree = _tree(cfg)
    tok, tgt = _batch(cfg.vocab_size)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jnp.asarray(tok), jnp.asarray(tgt)))(
            _jnp(tree))
    params = th._master_f32(tt.params_from_numpy(tree, device="cpu"))
    loss = tt.lm_loss(cfg, params, torch.from_numpy(tok),
                      torch.from_numpy(tgt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-4)
    got = jax.tree_util.tree_map(lambda p: p.grad.numpy(), params)
    want_paths = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, want_grads))
    got_paths = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_paths] == [p for p, _ in want_paths]
    for (path, a), (_, b) in zip(got_paths, want_paths):
        np.testing.assert_allclose(a, b, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_apply_runs_flash_attention_and_the_plain_forward_agrees():
    """`apply` goes through `flash_attention` (its plain version here);
    `_forward` with the plain `attention` is the kernel-free checker."""
    jcfg, cfg = _cfgs()
    params = tt.params_from_numpy(_tree(cfg), device="cpu")
    tok, _ = _batch(cfg.vocab_size)
    calls = []
    real = tt.flash_attention

    def spy(*a):
        calls.append(1)
        return real(*a)

    tt.flash_attention = spy
    try:
        logits = tt.apply(cfg, params, torch.from_numpy(tok))
    finally:
        tt.flash_attention = real
    assert len(calls) == cfg.n_layers
    plain = tt._forward(cfg, params, torch.from_numpy(tok), tt.attention)
    torch.testing.assert_close(logits, plain, atol=1e-5, rtol=0)
    want = jt.apply(jcfg, _jnp(_tree(cfg)), jnp.asarray(tok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4)
    logits2, aux = tt.apply(cfg, params, torch.from_numpy(tok),
                            return_aux=True)
    assert float(aux) == 0.0


def test_remat_recomputes_the_forward_once_per_block():
    """With cfg.remat the attention forward runs twice per block in a
    backward pass (the recompute), once without grad."""
    _, cfg = _cfgs(remat=True)
    params = th._master_f32(tt.params_from_numpy(_tree(cfg), device="cpu"))
    tok, tgt = _batch(cfg.vocab_size)
    calls = []
    real = tk.flash_forward_plain

    def spy(*a):
        calls.append(1)
        return real(*a)

    tk.flash_forward_plain = spy
    try:
        tt.lm_loss(cfg, params, tok, tgt).backward()
        n_train = len(calls)
        with torch.no_grad():
            tt.lm_loss(cfg, params, tok, tgt)
    finally:
        tk.flash_forward_plain = real
    assert n_train == 2 * cfg.n_layers
    assert len(calls) - n_train == cfg.n_layers


# ---------------------------------------------------------------------------
# updaters

UPDATER_CASES = {
    "sgd": dict(updater="sgd", learning_rate=0.1),
    "none": dict(updater="none", learning_rate=0.1),
    "adam": dict(updater="adam", learning_rate=0.01),
    "adam_clip": dict(updater="adam", learning_rate=0.01, clip_norm=0.5),
    "adamw": dict(updater="adamw", learning_rate=0.01, weight_decay=0.1),
    "adadelta": dict(updater="adadelta", rho=0.9),
    "nesterovs": dict(updater="nesterovs", learning_rate=0.05,
                      momentum=0.8),
    "adagrad": dict(updater="adagrad", learning_rate=0.05),
    "rmsprop": dict(updater="rmsprop", learning_rate=0.01, rho=0.9),
    "lion": dict(updater="lion", learning_rate=0.01),
    "lion_wd": dict(updater="lion", learning_rate=0.01, weight_decay=0.1),
    "sgd_l1_l2_clip_value": dict(updater="sgd", learning_rate=0.1, l1=0.01,
                                 l2=0.02, clip_value=0.5),
    "rmsprop_unit_norm": dict(updater="rmsprop", learning_rate=0.01,
                              unit_norm=True),
    "adam_warmup_cosine": dict(updater="adam", schedule=(0.02, 2, 5)),
}


@pytest.mark.parametrize("name", sorted(UPDATER_CASES))
def test_updater_three_steps_match_jax(name):
    kw = dict(UPDATER_CASES[name])
    sched = kw.pop("schedule", None)
    jkw, tkw = dict(kw), dict(kw)
    if sched is not None:
        jkw["lr_schedule"] = ju.warmup_cosine(*sched)
        tkw["lr_schedule"] = tu.warmup_cosine(*sched)
    rng = np.random.default_rng(len(name))
    shapes = {"w": (3, 4), "layers": [{"b": (4,)}, {"b": (2, 2)}]}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    jtr = ju.make_updater(ju.UpdaterConfig(**jkw))
    ttr = tu.make_updater(tu.UpdaterConfig(**tkw))
    jp = _jnp(params)
    js = jtr.init(jp)
    tp = tt.map_tree(lambda a: torch.from_numpy(a.copy()), params)
    ts = ttr.init(tp)
    for g in grads:
        ju_, js = jtr.update(_jnp(g), js, jp)
        jp = ju.apply_updates(jp, ju_)
        tu_, ts = ttr.update(tt.map_tree(torch.from_numpy, g), ts, tp)
        tp = tu.apply_updates(tp, tu_)
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32
    for a, b in zip(_leaves_np(tt.map_tree(lambda t: t.numpy(), tp)),
                    _leaves_np(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for key in js:
        if key != "step":
            for a, b in zip(_leaves_np(tt.map_tree(lambda t: t.numpy(),
                                                   ts[key])),
                            _leaves_np(js[key])):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                           err_msg=key)


@pytest.mark.parametrize("updater", ["sgd", "adam", "nesterovs", "adagrad",
                                     "rmsprop", "adadelta", "none"])
def test_weight_decay_is_refused_where_it_would_be_ignored(updater):
    with pytest.raises(ValueError, match="weight_decay"):
        tu.make_updater(tu.UpdaterConfig(updater=updater, weight_decay=0.1))


def test_warmup_cosine_and_grad_norm_match_jax():
    jsched, tsched = ju.warmup_cosine(0.1, 3, 10), tu.warmup_cosine(0.1, 3,
                                                                     10)
    for step in range(13):
        np.testing.assert_allclose(tsched(step),
                                   float(jsched(jnp.int32(step))),
                                   rtol=1e-7)
    with pytest.raises(ValueError):
        tu.warmup_cosine(0.1, 5, 5)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 3)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    np.testing.assert_allclose(
        float(tu.global_grad_norm(tt.map_tree(torch.from_numpy, tree))),
        float(ju.global_grad_norm(_jnp(tree))), rtol=1e-6)


def test_accumulators_and_parameters_keep_their_dtype():
    """bf16 parameters stay bf16 through `apply_updates`; accumulators keep
    the dtype they were created with."""
    tr = tu.make_updater(tu.UpdaterConfig(updater="adam",
                                          learning_rate=0.01))
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = tr.init(p)
    upd, state = tr.update({"w": torch.full((4,), 0.5,
                                            dtype=torch.bfloat16)}, state, p)
    tu.apply_updates(p, upd)
    assert p["w"].dtype == torch.bfloat16 and state["m"]["w"].dtype == \
        torch.bfloat16
    assert float(p["w"][0]) < 1.0


# ---------------------------------------------------------------------------
# the train step


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_accum_train_step_matches_jax(accum, remat):
    """3 Adam steps from the same numpy weights.  No attention biases
    here: the key bias's exact gradient is zero (softmax is shift-
    invariant within a row), and Adam turns the two frameworks' rounding
    noise there into full +-lr steps of opposite signs."""
    jcfg, cfg = _cfgs(tied=True, bias=False, remat=remat)
    tree = _tree(cfg)
    tok, tgt = _batch(cfg.vocab_size, b=4, seed=1)
    jstep, jinit = jh.make_accum_train_step(jcfg, lr=1e-2, accum=accum,
                                            updater="adam")
    tstep, tinit = th.make_accum_train_step(cfg, lr=1e-2, accum=accum,
                                            updater="adam")
    jp = _jnp(tree)
    js = jinit(jp)
    tp = th._master_f32(tt.params_from_numpy(tree, device="cpu"))
    ts = tinit(tp)
    for _ in range(3):
        jp, js, jl = jstep(jp, js, jnp.asarray(tok), jnp.asarray(tgt))
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(tok),
                           torch.from_numpy(tgt))
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
    for a, b in zip(_leaves_np(tt.params_to_numpy(tp)), _leaves_np(jp)):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_mixed_precision_keeps_f32_masters_and_casts_inside_the_graph():
    """bf16 compute: the f32 masters receive the gradients and stay f32;
    the caller's tensors are copied, never written."""
    _, cfg = _cfgs(bias=False)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    src = tt.params_from_numpy(_tree(cfg), device="cpu")
    before = src["embed"].clone()
    params = th._master_f32(src)
    step, init = th.make_accum_train_step(cfg16, lr=1e-2, accum=2,
                                          updater="adam")
    state = init(params)
    tok, tgt = _batch(cfg.vocab_size, b=4)
    params, state, loss = step(params, state, tok, tgt)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    for p in tree_leaves(params):
        assert p.dtype == torch.float32 and p.requires_grad and p.grad is None
    assert not torch.equal(params["embed"], before)
    torch.testing.assert_close(src["embed"], before, atol=0, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        step(params, state, tok[:3], tgt[:3])


# ---------------------------------------------------------------------------
# checkpoint and CLI


def test_npz_round_trip_and_keys_match_the_jax_writer(tmp_path):
    jcfg, cfg = _cfgs(tied=False)
    tree = _tree(cfg)
    params = tt.params_from_numpy(tree, device="cpu", dtype="bfloat16")
    tc.tree_to_npz(tmp_path / "t.npz", params)
    j_tree_to_npz(tmp_path / "j.npz", _jnp(tree))
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "layers//0//attn//wq" in a.files
        assert all(a[k].dtype == np.float32 for k in a.files)
    assert sorted(os.listdir(tmp_path)) == ["j.npz", "t.npz"]  # no temp
    back = tc.npz_to_tree(tmp_path / "t.npz", params)
    for x, y in zip(tree_leaves(back), tree_leaves(params)):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    with pytest.raises(KeyError, match="missing leaf"):
        tc.npz_to_tree(tmp_path / "t.npz", {"nope": torch.zeros(1)})


def _corpus(tmp_path, n=1500):
    path = tmp_path / "corpus.txt"
    rng = np.random.default_rng(0)
    words = [b"tensor", b"chip", b"kernel", b"port", b"train", b"loss"]
    path.write_bytes(b" ".join(words[i] for i in rng.integers(0, 6, n))[:n])
    return path


LM_ARGS = ["-seq", "16", "-batch", "4", "-accum", "2", "-d-model", "32",
           "-layers", "2", "-heads", "4"]


def test_cli_lm_writes_an_lm_both_packages_load(tmp_path, capsys):
    corpus = _corpus(tmp_path)
    out = tmp_path / "lm"
    rc = tcli.main(["lm", "-input", str(corpus), "-output", str(out),
                    *LM_ARGS, "-eval", str(corpus), "-device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Trained 23 steps (final loss" in text and "tokens/sec)" in text
    assert "eval: 64 windows x 16 bytes" in text
    saved = json.loads((out / "lm_config.json").read_text())
    assert saved["vocab_size"] == 256 and saved["dtype"] == "float32"
    jcfg, jparams = jcli._load_saved_lm(out)
    cfg, params = tcli.load_saved_lm(out, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for a, b in zip(_leaves_np(tt.params_to_numpy(params)),
                    _leaves_np(jparams)):
        np.testing.assert_array_equal(a, b)
    # no -input: load the saved LM and evaluate it
    rc = tcli.main(["lm", "-output", str(out), "-eval", str(corpus),
                    "-device", "cpu"])
    assert rc == 0
    nll = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("eval:")]
    assert nll and nll[0] in text


def test_cli_lm_samples_the_same_batches_as_the_jax_cli(tmp_path,
                                                        monkeypatch):
    corpus = _corpus(tmp_path)
    seen = {"jax": [], "torch": []}

    def recorder(kind, zero):
        def make(cfg, **kw):
            def step(params, opt_state, tokens, targets):
                seen[kind].append((np.asarray(tokens).copy(),
                                   np.asarray(targets).copy()))
                return params, opt_state, zero()
            return step, lambda params: {}
        return make

    monkeypatch.setattr(jh, "make_accum_train_step",
                        recorder("jax", lambda: jnp.float32(0)))
    monkeypatch.setattr(th, "make_accum_train_step",
                        recorder("torch", lambda: torch.zeros(())))
    args = ["lm", "-input", str(corpus), *LM_ARGS]
    jcli.main([*args, "-output", str(tmp_path / "j")])
    tcli.main([*args, "-output", str(tmp_path / "t"), "-device", "cpu"])
    assert len(seen["jax"]) == len(seen["torch"]) == 23
    for (jtok, jtgt), (ttok, ttgt) in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(jtok, ttok)
        np.testing.assert_array_equal(jtgt, ttgt)


@pytest.mark.parametrize("flags,item", [
    (["-runtime", "pipeline", "-experts", "2"], "pipeline"),
])
def test_cli_lm_refuses_unported_options(tmp_path, flags, item):
    corpus = _corpus(tmp_path)
    with pytest.raises(SystemExit, match=item):
        tcli.main(["lm", "-input", str(corpus), *LM_ARGS, *flags,
                   "-device", "cpu"])
