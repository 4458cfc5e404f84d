"""PyTorch port: the transformer LM and its paged forward
(`deeplearning4j_tpu_torch.parallel.transformer` / `.generation`).

Weights are made with the JAX package's own `init_params` (or numpy from a
seed), carried over as numpy arrays through `params_from_numpy`, and the
port's logits are held against JAX's at atol 1e-4 in float32.  Each
hazard of the port (tanh GELU, population-variance layer norm, the
position clip for padding columns, the last-fed-column logits, the null
page, tied heads) has its own check.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import ring_attention as jring
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu_torch.parallel import generation as tgen
from deeplearning4j_tpu_torch.parallel import transformer as tt
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

ATOL = 1e-4


def _cfgs(tied: bool, bias: bool, max_len: int = 24):
    jcfg = jt.TransformerConfig(vocab_size=256, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, max_len=max_len,
                                attn_bias=bias, tie_embeddings=tied)
    return jcfg, tt.TransformerConfig(**dataclasses.asdict(jcfg))


def _jax_tree(jcfg, seed=0):
    """JAX-initialized weights as numpy, with non-zero biases and norms
    so every parameter matters."""
    tree = jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name in ("bias", "b1", "b2", "bq", "bk", "bv", "bo"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        if name == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


VARIANTS = {"tied_bias": (True, True), "tied_nobias": (True, False),
            "untied_bias": (False, True), "untied_nobias": (False, False)}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_params_from_numpy_round_trip(name):
    jcfg, cfg = _cfgs(*VARIANTS[name])
    tree = _jax_tree(jcfg)
    params = tt.params_from_numpy(tree, device="cpu")
    # the JAX layouts survive the carry-over
    attn = params["layers"][0]["attn"]
    assert tuple(attn["wq"].shape) == (32, 4, 8)
    assert tuple(attn["wo"].shape) == (4, 8, 32)
    assert ("head" in params) == (not cfg.tie_embeddings)
    assert ("bq" in attn) == cfg.attn_bias
    back = tt.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_apply_matches_jax(name):
    jcfg, cfg = _cfgs(*VARIANTS[name])
    tree = _jax_tree(jcfg, seed=1)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 17)).astype(
        np.int32)
    want = np.asarray(jt.apply(jcfg, _jnp(tree), jnp.asarray(tokens)))
    got = tt.apply(cfg, tt.params_from_numpy(tree, device="cpu"),
                   torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_init_params_shapes_match_jax():
    jcfg, cfg = _cfgs(True, True)
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jt.init_params(jcfg, jax.random.PRNGKey(0)))
    tshapes = tt.map_tree(lambda a: tuple(a.shape),
                          tt.init_params(cfg, torch.Generator().manual_seed(0),
                                         device="cpu"))
    assert tshapes == jshapes
    assert tt.param_shapes(cfg) == jshapes
    np_tree = tt.numpy_params(cfg, seed=3)
    assert tt.map_tree(lambda a: a.shape, np_tree) == jshapes
    again = tt.numpy_params(cfg, seed=3)
    np.testing.assert_array_equal(np_tree["embed"], again["embed"])


def test_config_json_from_the_jax_package_loads():
    for make in ("gpt2_small", "gpt2_medium", "gpt2_large"):
        jcfg = getattr(jt, make)(max_len=1024)
        cfg = tt.TransformerConfig(**json.loads(json.dumps(jcfg.__dict__)))
        assert cfg == getattr(tt, make)(max_len=1024)
        assert cfg.head_dim == jcfg.head_dim
    assert tt.gpt2_small().vocab_size == 50304


def test_gelu_is_the_tanh_approximation():
    rng = np.random.default_rng(5)
    p = {"w1": rng.standard_normal((16, 32)).astype(np.float32),
         "b1": rng.standard_normal((32,)).astype(np.float32),
         "w2": rng.standard_normal((32, 16)).astype(np.float32),
         "b2": rng.standard_normal((16,)).astype(np.float32)}
    x = (3 * rng.standard_normal((2, 3, 16))).astype(np.float32)
    want = np.asarray(jt._mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x)))
    got = tt._mlp({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_layer_norm_population_variance_eps():
    rng = np.random.default_rng(6)
    p = {"scale": rng.standard_normal((8,)).astype(np.float32),
         "bias": rng.standard_normal((8,)).astype(np.float32)}
    # a small-variance row makes eps matter
    x = np.concatenate([rng.standard_normal((1, 8)),
                        1e-3 * rng.standard_normal((1, 8))]).astype(
                            np.float32)
    want = np.asarray(jt._layer_norm(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = tt._layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_plain_attention_matches_jax():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
               for _ in range(3))
    for causal in (True, False):
        want = np.asarray(jring.attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal))
        got = tt.attention(*map(torch.from_numpy, (q, k, v)),
                           causal=causal).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_tied_head_is_embed_transpose():
    jcfg, cfg = _cfgs(True, True)
    params = tt.params_from_numpy(_jax_tree(jcfg), device="cpu")
    assert torch.equal(tt.lm_head(params), params["embed"].T)
    jcfg, cfg = _cfgs(False, True)
    params = tt.params_from_numpy(_jax_tree(jcfg), device="cpu")
    assert tt.lm_head(params) is params["head"]


# ---------------------------------------------------------------------------
# the paged forward against JAX's gather path

def _paged_setup(ps, c, seed=0, max_len=24):
    jcfg, cfg = _cfgs(True, True, max_len=max_len)
    tree = _jax_tree(jcfg, seed=seed)
    mp = tgen.pages_per_seq(cfg, ps)
    b, pages = 4, 1 + 4 * mp
    rng = np.random.default_rng(seed + 10)
    pos = np.array([0, 3, max_len - 2, 7], np.int32)
    nf = np.array([c, min(c, 2), min(c, 2), 0], np.int32)   # lane 3 idle
    table = np.zeros((b, mp), np.int32)
    perm = rng.permutation(np.arange(1, pages)).astype(np.int32)
    for i in range(3):
        need = min(mp, (int(pos[i]) + c - 1) // ps + 1)
        table[i, :need] = perm[i * mp:i * mp + need]
    tokens = rng.integers(0, 256, (b, c)).astype(np.int32)
    shape = (jcfg.n_layers, pages, ps, jcfg.n_heads, jcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    return jcfg, cfg, tree, table, pos, nf, tokens, k0, v0


PAGED = [(4, 1), (4, 4), (5, 1), (5, 4)]


def _run_both(fn_j, fn_t, ps, c):
    jcfg, cfg, tree, table, pos, nf, tokens, k0, v0 = _paged_setup(ps, c)
    jout, jcache = fn_j(jcfg, _jnp(tree), {"k": jnp.asarray(k0),
                                           "v": jnp.asarray(v0)},
                        jnp.asarray(table), jnp.asarray(pos),
                        jnp.asarray(nf), jnp.asarray(tokens))
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy())}
    tout, tcache = fn_t(cfg, tt.params_from_numpy(tree, device="cpu"),
                        tcache, *map(torch.from_numpy,
                                     (table, pos, nf, tokens)))
    return (np.asarray(jout), jcache, tout.numpy(), tcache, nf)


@pytest.mark.parametrize("ps,c", PAGED)
def test_paged_forward_logits_match_jax(ps, c):
    """Logits at every fed column, including a lane near max_len whose
    padding columns would index past the position table (the clip)."""
    jout, jcache, tout, tcache, nf = _run_both(
        jgen.paged_forward, tgen.paged_forward, ps, c)
    for i, n in enumerate(nf):
        if n:
            np.testing.assert_allclose(tout[i, :n], jout[i, :n], atol=ATOL)
    # every page but the null page holds exactly what JAX scattered
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy()[:, 1:],
                                   np.asarray(jcache[key])[:, 1:],
                                   atol=1e-5)


@pytest.mark.parametrize("ps,c", PAGED)
def test_paged_decode_step_takes_the_last_fed_column(ps, c):
    """Logits at column max(n_feed - 1, 0) — including the idle lane
    (n_feed 0 -> column 0), whose logits JAX also returns."""
    jout, _, tout, _, nf = _run_both(
        jgen.paged_decode_step, tgen.paged_decode_step, ps, c)
    assert tout.shape == jout.shape == (4, 256)
    np.testing.assert_allclose(tout, jout, atol=ATOL)


def test_paged_forward_agrees_with_apply():
    """Prefill in chunks through the pool, then the whole prompt through
    `apply`: the paged path's logits at every position equal the
    full-recompute checker's."""
    jcfg, cfg = _cfgs(True, True, max_len=24)
    params = tt.params_from_numpy(_jax_tree(jcfg, seed=4), device="cpu")
    ps, c = 5, 4
    mp = tgen.pages_per_seq(cfg, ps)
    cache = tgen.init_paged_cache(cfg, 1 + mp, ps, device="cpu")
    table = torch.arange(1, mp + 1, dtype=torch.int32)[None]
    seq = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, 18).astype(np.int32))
    outs = []
    for start in range(0, 18, c):
        chunk = seq[start:start + c]
        n = len(chunk)
        tok = torch.zeros(1, c, dtype=torch.int32)
        tok[0, :n] = chunk
        logits, cache = tgen.paged_forward(
            cfg, params, cache, table, torch.tensor([start], dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32), tok)
        outs.append(logits[0, :n])
    want = tt.apply(cfg, params, seq[None].long())[0]
    torch.testing.assert_close(torch.cat(outs), want, atol=ATOL, rtol=0)


def test_pool_and_page_copy():
    jcfg, cfg = _cfgs(True, True)
    cache = tgen.init_paged_cache(cfg, 6, 4, device="cpu")
    assert tuple(cache["k"].shape) == (2, 6, 4, 4, 8)
    assert tgen.pages_per_seq(cfg, 5) == 5          # ceil(24 / 5)
    cache["k"][:, 2] = 1.5
    cache["v"][:, 2] = -2.0
    k, v = tgen.make_page_copy(cfg, 6, 4)(cache["k"], cache["v"], 2, 5)
    assert k is cache["k"] and v is cache["v"]        # in place
    assert torch.all(k[:, 5] == 1.5) and torch.all(v[:, 5] == -2.0)
    assert torch.all(k[:, 4] == 0)
