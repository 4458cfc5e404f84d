"""PyTorch port: MoE transformer layers on the train and serve paths
(`deeplearning4j_tpu_torch.parallel.transformer` `_moe*`, `apply`,
`lm_loss`; every decode step of `parallel.generation`; the pool;
`make_accum_train_step`; ``cli lm -experts``).

The same numpy weights (d 32, H 4, L 2, E 4, F 64, float32) go through
the JAX package and the port on the CPU.  Tolerances: relative 1e-5 on
the dense-masked and dispatch outputs, the load-balancing loss, `apply`
logits in both modes and `lm_loss` with every gradient (each leaf
against its own largest JAX value); the dropped assignments exactly;
decode steps within 1e-5 of the largest JAX logit; greedy and beam ids
exactly (a greedy divergence only at a near-tie, a JAX top-2 gap below
1e-4); the train step's losses within 1e-5 over 3 steps.
"""

import dataclasses
import functools
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import hybrid as jh
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu_torch import cli as tcli
from deeplearning4j_tpu_torch.parallel import generation as tgen
from deeplearning4j_tpu_torch.parallel import hybrid as th
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import ContinuousLMServer
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

REL = 1e-5
NEAR_TIE = 1e-4


def _jcfg(top_k=2, cf=1.25, **kw):
    return jt.TransformerConfig(
        vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        max_len=64, n_experts=4, moe_top_k=top_k, moe_capacity_factor=cf,
        attn_bias=True, tie_embeddings=True, **kw)


def _cfg(jcfg):
    return tt.TransformerConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=4)
def _tree(top_k=2):
    """numpy weights from the JAX `init_params` (carried over as numpy),
    with non-zero biases so every leaf has a gradient."""
    jp = jt.init_params(_jcfg(top_k), jax.random.PRNGKey(top_k))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    rng = np.random.default_rng(top_k)
    for layer in tree["layers"]:
        for key in ("b1", "b2"):
            layer["moe"][key] = (0.1 * rng.standard_normal(
                layer["moe"][key].shape)).astype(np.float32)
    return tree


def _jp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tp(tree):
    return tt.params_from_numpy(tree, device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _overflowing_layer(seed=0, skew=3.0):
    """One MoE layer's weights and inputs [2, 16, 32] whose router leans
    on expert 0, so a capacity of 1.25 drops assignments."""
    rng = np.random.default_rng(seed)
    d, f, e = 32, 64, 4
    p = {"gate": (rng.standard_normal((d, e)) / math.sqrt(d)),
         "w1": rng.standard_normal((e, d, f)) / math.sqrt(d),
         "b1": 0.1 * rng.standard_normal((e, f)),
         "w2": rng.standard_normal((e, f, d)) / math.sqrt(f),
         "b2": 0.1 * rng.standard_normal((e, d))}
    x = rng.standard_normal((2, 16, d))
    p["gate"][:, 0] += skew * x.reshape(-1, d).mean(0) / np.square(
        x.reshape(-1, d).mean(0)).sum()
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, x.astype(np.float32)


def _jax_keep(p, x, cf, top_k):
    """The JAX dispatch's kept assignments, recomputed from its own
    router (`_router_weights`) and the drop rule of `_moe_dispatch`."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf @ jnp.asarray(p["gate"]), axis=-1)
    idx, _ = jt._router_weights(probs, top_k)
    e_flat = np.asarray(idx).reshape(-1)
    e = p["w1"].shape[0]
    a = e_flat.size
    c = max(1, min(a, int(math.ceil(cf * a / e))))
    onehot = np.eye(e, dtype=np.int64)[e_flat]
    slot = (np.cumsum(onehot, 0) * onehot).sum(1) - 1
    return e_flat, slot < c


# ---------------------------------------------------------------------------
# the router and the MoE block


def test_router_takes_the_lower_index_among_equal_probabilities():
    """Constructed ties: equal router logits in float32, and a bfloat16
    softmax whose probabilities round equal.  The port picks the lower
    index first, as `lax.top_k` does."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.4, 0.0]], np.float32)
    for k in (1, 2, 3):
        jidx, jw = jt._router_weights(jnp.asarray(probs), k)
        tidx, tw = tt._router_weights(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert tt._router_weights(torch.from_numpy(probs), 2)[0].tolist() == [
        [0, 1], [1, 2], [0, 2]]
    # equal logits through the whole dense block: a zero gate
    p, x = _overflowing_layer()
    p = dict(p, gate=np.zeros_like(p["gate"]))
    for k in (1, 2):
        j = jt._moe_dense({n: jnp.asarray(v) for n, v in p.items()},
                          jnp.asarray(x), k)
        t = tt._moe_dense({n: torch.from_numpy(v) for n, v in p.items()},
                          torch.from_numpy(x), k)
        assert _rel(t.numpy(), j) <= REL
    # bfloat16: logits 1/512 apart tie after the softmax rounds them
    logits = torch.tensor([[1.0, 1.0 + 1 / 512, 0.0, 1.0 - 1 / 512]])
    p16 = torch.softmax(logits.to(torch.bfloat16), dim=-1)
    assert p16[0, 0] == p16[0, 1] == p16[0, 3]
    assert tt._router_weights(p16, 2)[0].tolist() == [[0, 1]]


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [0.0, 1.25])
def test_moe_block_matches_jax_on_an_overflowing_batch(top_k, cf):
    p, x = _overflowing_layer()
    jpar = {n: jnp.asarray(v) for n, v in p.items()}
    tpar = {n: torch.from_numpy(v) for n, v in p.items()}
    j = np.asarray(jt._moe(jpar, jnp.asarray(x), cf, top_k=top_k))
    t = tt._moe(tpar, torch.from_numpy(x), cf, top_k).numpy()
    assert _rel(t, j) <= REL
    if cf:
        # the dropped set: exactly JAX's
        e_flat, keep = _jax_keep(p, x, cf, top_k)
        te, _, _, tkeep, c = tt._moe_route(
            tpar, torch.from_numpy(x).reshape(-1, 32), cf, top_k)
        np.testing.assert_array_equal(te.numpy(), e_flat)
        np.testing.assert_array_equal(tkeep.numpy() > 0, keep)
        assert 0 < keep.sum() < keep.size              # it overflowed
        assert c == math.ceil(cf * keep.size / 4)
        # a dropped assignment adds nothing: its token's output is the
        # weighted sum of its kept assignments only
        dense = np.asarray(jt._moe_dense(jpar, jnp.asarray(x), top_k))
        tok_all_kept = keep.reshape(-1, top_k).all(1)
        np.testing.assert_allclose(
            t.reshape(-1, 32)[tok_all_kept],
            dense.reshape(-1, 32)[tok_all_kept], rtol=1e-5, atol=1e-6)
        none_kept = ~keep.reshape(-1, top_k).any(1)
        assert np.all(t.reshape(-1, 32)[none_kept] == 0)


def test_dispatch_without_drops_equals_the_dense_oracle():
    p, x = _overflowing_layer(skew=0.0)
    tpar = {n: torch.from_numpy(v) for n, v in p.items()}
    for k in (1, 2):
        dense = tt._moe_dense(tpar, torch.from_numpy(x), k)
        disp = tt._moe_dispatch(tpar, torch.from_numpy(x), 4.0, k)
        assert _rel(disp.numpy(), dense.numpy()) <= REL


@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_aux_loss_matches_jax(skew):
    """f comes from the argmax of the logits (top-1 whatever k is), P is
    the mean softmax; E * sum f P."""
    p, x = _overflowing_layer(skew=skew)
    j = float(jt._moe_aux_loss({n: jnp.asarray(v) for n, v in p.items()},
                               jnp.asarray(x)))
    t = float(tt._moe_aux_loss({n: torch.from_numpy(v)
                                for n, v in p.items()}, torch.from_numpy(x)))
    assert abs(t - j) <= REL * abs(j)


def test_moe_parameter_tree_matches_the_jax_init():
    jcfg = _jcfg()
    shapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jt.init_params(jcfg, jax.random.PRNGKey(0)))
    assert tt.param_shapes(_cfg(jcfg)) == shapes
    layer = tt.numpy_params(_cfg(jcfg), seed=0)["layers"][0]
    assert "mlp" not in layer and set(layer["moe"]) == {
        "gate", "w1", "b1", "w2", "b2"}
    assert tt.init_params(_cfg(jcfg), device="cpu")["layers"][1]["moe"][
        "w2"].shape == (4, 64, 32)


# ---------------------------------------------------------------------------
# apply and lm_loss


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("train", [False, True])
def test_apply_matches_jax_in_both_routing_modes(top_k, train):
    jcfg = _jcfg(top_k)
    tree = _tree(top_k)
    tok = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    jl, jaux = jt.apply(jcfg, _jp(tree), jnp.asarray(tok), train=train,
                        return_aux=True)
    tl, taux = tt.apply(_cfg(jcfg), _tp(tree), torch.from_numpy(tok),
                        train=train, return_aux=True)
    assert _rel(tl.detach().numpy(), jl) <= REL
    assert abs(float(taux) - float(jaux)) <= REL * abs(float(jaux))


@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (2, 0.0)])
def test_lm_loss_and_every_gradient_match_jax(top_k, cf):
    jcfg = dataclasses.replace(_jcfg(top_k), moe_capacity_factor=cf)
    cfg = _cfg(jcfg)
    tree = _tree(top_k)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, 64, (2, 16)).astype(np.int32)
    tgt = rng.integers(0, 64, (2, 16)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jnp.asarray(tok), jnp.asarray(tgt)))(
        _jp(tree))
    params = th._master_f32(_tp(tree))
    tloss = tt.lm_loss(cfg, params, tok, tgt)
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= REL * abs(
        float(jloss))
    grads_j = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
               jax.tree_util.tree_leaves_with_path(jgrads)}
    grads_t = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_leaves_with_path(
                   jax.tree_util.tree_map(lambda t: t.grad.numpy(), params,
                                          is_leaf=torch.is_tensor))}
    for name, gj in grads_j.items():
        gt = grads_t[name]
        if np.abs(gj).max() == 0:              # an expert without tokens
            assert np.abs(gt).max() == 0
            continue
        # the key bias's exact gradient is zero (softmax is shift
        # invariant): its noise is measured on the query bias's scale
        scale = np.abs(grads_j[name.replace("'bk'", "'bq'")]).max()
        assert np.abs(gt - gj).max() <= REL * scale, name


def test_lm_loss_adds_the_weighted_aux_loss_only_when_positive():
    jcfg = _jcfg()
    cfg = _cfg(jcfg)
    params = _tp(_tree())
    tok = np.random.default_rng(3).integers(0, 64, (2, 16)).astype(np.int32)
    with torch.no_grad():
        logits, aux = tt.apply(cfg, params, tok, train=True, return_aux=True)
        nll = -torch.log_softmax(logits, -1).gather(
            -1, torch.from_numpy(tok).long()[..., None]).mean()
        full = tt.lm_loss(cfg, params, tok, tok)
        none = tt.lm_loss(dataclasses.replace(cfg, moe_aux_weight=0.0),
                          params, tok, tok)
    assert float(aux) > 0
    torch.testing.assert_close(full, nll + 0.01 * aux, rtol=1e-6, atol=0)
    torch.testing.assert_close(none, nll, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# decode steps, generate, beam search, the pool


def _jax_full_logits(jcfg, tree, ids):
    return np.asarray(jt.apply(jcfg, _jp(tree), jnp.asarray([ids])))[0]


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_slot_and_paged_steps_match_the_jax_forward(top_k):
    """Every step is dense-masked: the dense cache's `decode_step`, the
    slot step and the paged steps (the 1-wide decode and a 4-wide chunk
    through `paged_forward`, and `spec_verify_step`) give, at each
    position, the logits of the JAX full forward (inference routing)."""
    jcfg = _jcfg(top_k)
    cfg, tree = _cfg(jcfg), _tree(top_k)
    params = _tp(tree)
    ids = np.random.default_rng(4).integers(0, 64, 10).tolist()
    want = _jax_full_logits(jcfg, tree, ids)
    scale = np.abs(want).max()
    # JAX's own cached decode agrees with its forward
    jcache = jgen.init_cache(jcfg, 1)
    for t in range(4):
        jl, jcache = jgen.decode_step(jcfg, _jp(tree), jcache,
                                      jnp.asarray([ids[t]]))
        assert np.abs(np.asarray(jl)[0] - want[t]).max() <= REL * scale
    # dense cache and slot cache
    cache = tgen.init_cache(cfg, 1, device="cpu")
    slots = tgen.init_slot_cache(cfg, 1, device="cpu")
    with torch.no_grad():
        for t, tok in enumerate(ids):
            logits, cache = tgen.decode_step(cfg, params, cache,
                                             torch.tensor([tok]))
            slog, slots = tgen.slot_decode_step(cfg, params, slots,
                                                torch.tensor([tok]))
            assert np.abs(logits[0].numpy() - want[t]).max() <= REL * scale
            assert np.abs(slog[0].numpy() - want[t]).max() <= REL * scale
        # paged: a 4-wide chunk, then 1-wide decode, then a verify round
        ps = 4
        mp = tgen.pages_per_seq(cfg, ps)
        pc = tgen.init_paged_cache(cfg, 1 + mp, ps, device="cpu")
        table = torch.arange(1, 1 + mp, dtype=torch.int32)[None]
        logits, pc = tgen.paged_forward(
            cfg, params, pc, table, torch.tensor([0], dtype=torch.int32),
            torch.tensor([4], dtype=torch.int32),
            torch.tensor([ids[:4]], dtype=torch.int32))
        assert np.abs(logits[0].numpy() - want[:4]).max() <= REL * scale
        for t in range(4, 6):
            last, pc = tgen.paged_decode_step(
                cfg, params, pc, table, torch.tensor([t], dtype=torch.int32),
                torch.tensor([1], dtype=torch.int32),
                torch.tensor([[ids[t]]], dtype=torch.int32))
            assert np.abs(last[0].numpy() - want[t]).max() <= REL * scale
        blog, acc, pc = tgen.spec_verify_step(
            cfg, params, pc, table, torch.tensor([6], dtype=torch.int32),
            torch.tensor([4], dtype=torch.int32),
            torch.tensor([3], dtype=torch.int32),
            torch.tensor([ids[6:10]], dtype=torch.int32))
    a = int(acc[0])
    assert np.abs(blog[0].numpy() - want[6 + a]).max() <= REL * scale


@pytest.mark.parametrize("top_k", [1, 2])
def test_greedy_generate_and_beam_search_ids_equal_jax(top_k):
    jcfg = _jcfg(top_k)
    cfg, tree = _cfg(jcfg), _tree(top_k)
    prompt = np.random.default_rng(5).integers(0, 64, (2, 6)).astype(
        np.int32)
    jids = np.asarray(jgen.generate(jcfg, _jp(tree), jnp.asarray(prompt),
                                    10))
    tids = tgen.generate(cfg, _tp(tree), prompt, 10, device="cpu").numpy()
    for b in range(2):
        if not np.array_equal(tids[b], jids[b]):
            p = int(np.nonzero(tids[b] != jids[b])[0][0])
            top2 = np.sort(_jax_full_logits(jcfg, tree,
                                            jids[b][:p].tolist())[-1])[-2:]
            assert top2[1] - top2[0] < NEAR_TIE
    jb, js = jgen.beam_search(jcfg, _jp(tree), jnp.asarray(prompt), 6,
                              beam_size=3)
    tb, ts = tgen.beam_search(cfg, _tp(tree), prompt, 6, beam_size=3,
                              device="cpu")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)


def test_the_paged_pool_serves_an_moe_config_like_jax_generate():
    jcfg = _jcfg(2)
    cfg, tree = _cfg(jcfg), _tree(2)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 64, n).tolist() for n in (3, 9, 13)]
    srv = ContinuousLMServer(cfg, tree, slots=2, page_size=4,
                             prefill_chunk=4, device="cpu")
    try:
        outs = [srv.generate(p, 6, timeout=120) for p in prompts]
        ledger = srv.page_ledger()
    finally:
        srv.stop()
    assert ledger["balanced"]
    for p, out in zip(prompts, outs):
        want = np.asarray(jgen.generate(jcfg, _jp(tree), jnp.asarray([p]),
                                        6))[0].tolist()
        assert out == want


# ---------------------------------------------------------------------------
# the train step and the CLI


def test_accum_train_step_matches_jax_over_three_steps():
    jcfg = dataclasses.replace(_jcfg(2), remat=True)
    cfg, tree = _cfg(jcfg), _tree(2)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, 64, (4, 16)).astype(np.int32)
    tgt = rng.integers(0, 64, (4, 16)).astype(np.int32)
    jstep, jinit = jh.make_accum_train_step(jcfg, lr=1e-2, accum=2,
                                            updater="adam")
    tstep, tinit = th.make_accum_train_step(cfg, lr=1e-2, accum=2,
                                            updater="adam")
    jp = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)
    js = jinit(jp)
    tp = th._master_f32(_tp(tree))
    ts = tinit(tp)
    for _ in range(3):
        jp, js, jl = jstep(jp, js, jnp.asarray(tok), jnp.asarray(tgt))
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(tok),
                           torch.from_numpy(tgt))
        assert abs(float(tl) - float(jl)) <= 1e-5


def test_bf16_train_step_keeps_f32_masters_of_the_experts():
    cfg = dataclasses.replace(_cfg(_jcfg(2)), dtype="bfloat16", remat=True)
    params = th._master_f32(_tp(_tree(2)))
    before = params["layers"][0]["moe"]["w1"].detach().clone()
    step, init = th.make_accum_train_step(cfg, lr=1e-2, accum=2,
                                          updater="adam")
    state = init(params)
    tok = np.random.default_rng(8).integers(0, 64, (4, 16))
    params, state, loss = step(params, state, tok, tok)
    assert np.isfinite(float(loss))
    moe = params["layers"][0]["moe"]
    assert all(t.dtype == torch.float32 and t.requires_grad
               for t in moe.values())
    assert not torch.equal(moe["w1"], before)


def _corpus(tmp_path, n=1500):
    path = tmp_path / "corpus.txt"
    rng = np.random.default_rng(0)
    words = [b"tensor", b"chip", b"kernel", b"port", b"train", b"loss"]
    path.write_bytes(b" ".join(words[i] for i in rng.integers(0, 6, n))[:n])
    return path


LM_ARGS = ["-seq", "16", "-batch", "4", "-accum", "2", "-d-model", "32",
           "-layers", "2", "-heads", "4"]


def test_cli_lm_experts_trains_saves_loads_and_generates(tmp_path, capsys):
    corpus = _corpus(tmp_path)
    out = tmp_path / "lm"
    rc = tcli.main(["lm", "-input", str(corpus), "-output", str(out),
                    *LM_ARGS, "-experts", "2", "-moe-top-k", "2",
                    "-device", "cpu"])
    assert rc == 0
    assert "Trained 23 steps" in capsys.readouterr().out
    saved = json.loads((out / "lm_config.json").read_text())
    assert saved["n_experts"] == 2 and saved["moe_top_k"] == 2
    # the saved directory loads in the port and in the JAX package
    rc = tcli.main(["lm", "-output", str(out), "-generate", "tensor",
                    "-max-new", "4", "-temperature", "0", "-device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    jcfg, jparams = jcli._load_saved_lm(out)
    assert jcfg.n_experts == 2
    want = jgen.generate(jcfg, jparams, jnp.asarray(
        [list(b"tensor")], jnp.int32), 4)
    assert text.strip() == bytes(np.asarray(want)[0].astype(
        np.uint8)).decode(errors="replace").strip()


def test_cli_lm_batches_and_losses_follow_the_jax_cli_with_experts(
        tmp_path, capsys):
    corpus = _corpus(tmp_path)
    args = ["lm", "-input", str(corpus), *LM_ARGS, "-experts", "2",
            "-epochs", "1"]
    jcli.main([*args, "-output", str(tmp_path / "j")])
    jtext = capsys.readouterr().out
    tcli.main([*args, "-output", str(tmp_path / "t"), "-device", "cpu"])
    ttext = capsys.readouterr().out
    jcfg = json.loads((tmp_path / "j" / "lm_config.json").read_text())
    tcfg = json.loads((tmp_path / "t" / "lm_config.json").read_text())
    assert jcfg == tcfg and tcfg["n_experts"] == 2
    assert "Trained 23 steps" in jtext and "Trained 23 steps" in ttext
