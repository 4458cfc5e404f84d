"""PyTorch port, slice 19: ring attention against the JAX package's.

The JAX side runs its ring inside ``shard_map`` over the conftest's
virtual CPU devices (`ring_attention`, and `ring_flash_attention` with
the Pallas kernels in interpret mode, as
`tests/test_parallel_extended.py` runs it); the port's runs as the
trainers run it, one `mesh.Program` over a one-process mesh of host
shards with the blocks as ``{shard: block}`` dicts, where the flash
wrappers run their plain block versions.  The same numpy q, k and v go
through both.

Tolerances: outputs within 2e-5 and gradients within 2e-4 absolute
(the JAX tests' own bounds), float32.  Block pairs: a causal ring of P
shards runs P (P + 1) / 2 of them, a non-causal one P**2, each once in
the forward and once in the backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deeplearning4j_tpu.parallel import make_mesh as jmesh
from deeplearning4j_tpu.parallel import ring_attention as jring
from deeplearning4j_tpu.parallel.data_parallel import shard_map
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import ring_attention as tring
from deeplearning4j_tpu_torch.parallel.kernels import flash_attention
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

FWD_TOL, GRAD_TOL = 2e-5, 2e-4


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_ring(fn, n, causal):
    mesh = jmesh((n,), ("seq",), devices=jax.devices()[:n])
    return shard_map(lambda q, k, v: fn(q, k, v, "seq", causal=causal),
                     mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                     out_specs=P(None, "seq"), check_rep=False)


def _program(n, axis="seq"):
    return tmesh.Program(tmesh.make_mesh((n,), (axis,),
                                         devices=["cpu"] * n))


def _port_ring(fn, n, causal, arrays):
    """(output [B, S, H, D], the leaf tensors q, k, v) of the port's ring
    over n host shards: each array cut on dim 1."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    blocks = [dict(enumerate(t.chunk(n, dim=1))) for t in leaves]
    out = fn(*blocks, "seq", causal, program=_program(n))
    return torch.cat([out[s] for s in range(n)], dim=1), leaves


def _jax_grads(ring, arrays):
    q, k, v = (jnp.asarray(a) for a in arrays)
    out = ring(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2),
                     (0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("flash", [False, True],
                         ids=["ring_attention", "ring_flash_attention"])
def test_ring_matches_jax(n, causal, flash):
    arrays = _qkv(2, 16, 2, 8, seed=2 + n)
    jfn = jring.ring_flash_attention if flash else jring.ring_attention
    tfn = tring.ring_flash_attention if flash else tring.ring_attention
    want, want_g = _jax_grads(jax.jit(_jax_ring(jfn, n, causal)), arrays)
    out, leaves = _port_ring(tfn, n, causal, arrays)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=FWD_TOL)
    (out ** 2).sum().backward()
    for leaf, g in zip(leaves, want_g):
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=GRAD_TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_block_pairs(monkeypatch, n, causal):
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = tring.flash_forward, tring.flash_bwd_block

    def count_fwd(q, k, v, c):
        calls["fwd"].append(c)
        return fwd(q, k, v, c)

    def count_bwd(q, k, v, g, lse, delta, c):
        calls["bwd"].append(c)
        return bwd(q, k, v, g, lse, delta, c)

    monkeypatch.setattr(tring, "flash_forward", count_fwd)
    monkeypatch.setattr(tring, "flash_bwd_block", count_bwd)
    out, _ = _port_ring(tring.ring_flash_attention, n, causal,
                        _qkv(1, 8 * n, 2, 4, seed=7))
    out.sum().backward()
    want = n * (n + 1) // 2 if causal else n * n
    for kind in ("fwd", "bwd"):
        assert len(calls[kind]) == want
        # causal: the n diagonal pairs take the causal mask, the rest none
        assert sum(calls[kind]) == (n if causal else 0)


def test_ring_cases_follow_jax():
    for causal in (True, False):
        for my in range(4):
            for kv in range(4):
                want = int(jring._ring_cases(causal, jnp.int32(my),
                                             jnp.int32(kv)))
                assert tring._ring_cases(causal, my, kv) == want


def test_axis_none_is_the_single_device_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 16, 2, 8, seed=4))
    np.testing.assert_array_equal(
        tring.ring_flash_attention(q, k, v, None, True).numpy(),
        flash_attention(q, k, v, True).numpy())
    want = jring.attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           causal=True)
    np.testing.assert_allclose(tring.ring_attention(q, k, v, None).numpy(),
                               np.asarray(want), atol=2e-6)


def test_ring_blocks_must_agree():
    prog = _program(2)
    blocks = {s: torch.zeros(1, 4, 2, 4) for s in range(2)}
    with pytest.raises(ValueError, match="same number"):
        tring.ring_flash_attention(blocks, {0: blocks[0]}, blocks, "seq",
                                   program=prog)
    with pytest.raises(ValueError, match="one shape"):
        tring.ring_attention(blocks, {s: torch.zeros(1, 5, 2, 4)
                                      for s in range(2)}, blocks, "seq",
                             program=prog)
    with pytest.raises(ValueError, match="needs the program"):
        tring.ring_flash_attention(blocks, blocks, blocks, "seq")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ppermute_reindexes_shards_on_one_device(n):
    """`Program.ppermute` over shards of one device: shard i's block
    moves to shard i + 1 as the same storage, never a copy."""
    shards = {i: torch.full((2,), float(i)) for i in range(n)}
    out = _program(n).ppermute(shards, "seq")
    assert [float(out[i][0]) for i in range(n)] == [float((i - 1) % n)
                                                    for i in range(n)]
    assert all(out[i].data_ptr() == shards[(i - 1) % n].data_ptr()
               for i in range(n))
