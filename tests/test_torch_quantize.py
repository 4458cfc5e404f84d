"""PyTorch port, slice 9: int8 weight quantization
(`deeplearning4j_tpu_torch.precision.quantize`), the bucket ladder
(`serving.bucketing`) and bucketed output, against the JAX package on the
same numpy inputs and weights, on the CPU.

Tolerances: the quantizers (numpy in both packages) bitwise; the int8
dense and conv products and `QuantizedNet.output` in float32 atol 1e-5
(the same int8 weights and scales, the products summed in another
order); bucketed output bitwise equal to a dispatch of the padded batch
(the JAX contract of `test_quantized_bucketed_slice_identity`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import precision as jprec
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.precision import quantize as jq
from deeplearning4j_tpu.serving import bucketing as jb
from deeplearning4j_tpu_torch import precision as tprec
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.precision import quantize as tq
from deeplearning4j_tpu_torch.serving import bucketing as tb
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse


def _pair(jc):
    jn = JNet(jc).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(jc.to_json()),
              device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


# ---- quantizers ----------------------------------------------------------------


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_symmetric_is_bitwise_jax(axis):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.3, (64, 32)).astype(np.float32)
    w[:, 3] = 0.0                       # an all-zero channel
    q, s = tq.quantize_symmetric(w, axis=axis)
    jq_, js = jq.quantize_symmetric(w, axis=axis)
    assert q.dtype == np.int8 and q.tobytes() == jq_.tobytes()
    assert s.tobytes() == js.tobytes()
    d = tq.dequantize(q, s, axis=axis)
    assert d.tobytes() == jq.dequantize(jq_, js, axis=axis).tobytes()
    shape = [1, 1]
    shape[axis] = -1
    assert (np.abs(d - w) <= s.reshape(shape) / 2 + 1e-7).all()


def test_kv_page_quantizers_are_bitwise_jax():
    rng = np.random.default_rng(1)
    pages = rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    for valid in (None, 7):
        q, s = tq.quantize_kv_pages(pages, valid)
        jq_, js = jq.quantize_kv_pages(pages, valid)
        assert q.tobytes() == jq_.tobytes() and s.tobytes() == js.tobytes()
        for dt in (np.float32, np.float16):
            assert tq.dequantize_kv_pages(q, s, dt).tobytes() == \
                jq.dequantize_kv_pages(jq_, js, dt).tobytes()
    with pytest.raises(ValueError, match="L, P, ps, H, K"):
        tq.quantize_kv_pages(pages[0])


def _qwb(rng, shape):
    w = rng.normal(0, 0.2, shape).astype(np.float32)
    b = rng.normal(0, 0.1, (shape[-1],)).astype(np.float32)
    q, s = jq.quantize_symmetric(w)
    return q, s, b


@pytest.mark.parametrize("ndim", [2, 3])
def test_int8_dense_matches_jax(ndim):
    rng = np.random.default_rng(2)
    q, s, b = _qwb(rng, (16, 8))
    x = rng.normal(0, 1, (4, 16) if ndim == 2 else (3, 5, 16)).astype(
        np.float32)
    want = np.asarray(jq.int8_dense(*(jnp.asarray(a) for a in (x, q, s, b)),
                                    "float32"))
    got = tq.int8_dense(*(torch.from_numpy(a) for a in (x, q, s, b)),
                        "float32")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), x @ jq.dequantize(q, s) + b,
                               atol=1e-5)


@pytest.mark.parametrize("padding,stride", [("SAME", (1, 1)),
                                            ("SAME", (2, 2)),
                                            ("VALID", (2, 1))])
def test_int8_conv_matches_jax(padding, stride):
    rng = np.random.default_rng(3)
    q, s, b = _qwb(rng, (3, 3, 2, 5))
    x = rng.random((2, 9, 8, 2), dtype=np.float32)
    want = np.asarray(jq.int8_conv(*(jnp.asarray(a) for a in (x, q, s, b)),
                                   "float32", stride, padding))
    got = tq.int8_conv(*(torch.from_numpy(a) for a in (x, q, s, b)),
                       "float32", stride, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---- QuantizedNet ------------------------------------------------------------------


NETS = {"mnist_mlp": (lambda: jzoo.mnist_mlp(width=64), (6, 784), 3),
        "lenet_mnist": (jzoo.lenet_mnist, (4, 28, 28, 1), 5),
        "lenet_digits": (jzoo.lenet_digits, (5, 8, 8, 1), 4)}


@pytest.mark.parametrize("name", sorted(NETS))
def test_quantized_net_matches_jax(name):
    conf, shape, n_quantized = NETS[name]
    jn, tn = _pair(conf())
    jqn, tqn = jprec.QuantizedNet(jn), tprec.QuantizedNet(tn)
    assert tqn.kinds == jqn.kinds
    assert tqn.quantized_layers == jqn.quantized_layers == n_quantized
    for tp, jp, kind in zip(tqn.qparams, jqn.qparams, tqn.kinds):
        if kind != "passthrough":
            assert tp["W_q"].dtype == torch.int8
            assert tp["W_q"].numpy().tobytes() == \
                np.asarray(jp["W_q"]).tobytes()
    x = np.random.default_rng(4).random(shape, dtype=np.float32)
    got, want = tqn.output(x), np.asarray(jqn.output(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(tqn.predict(x), np.asarray(jqn.predict(x)))
    assert tqn.param_bytes() == jqn.param_bytes()
    assert tqn.quantization_report() == jqn.quantization_report()
    assert tprec.param_bytes(tqn) == tqn.param_bytes()


def test_quantized_mlp_agrees_with_the_float_net_at_a_quarter_the_bytes():
    """bench_precision's bar: top-1 agreement >= 0.99 with the float net,
    resident parameter bytes >= 3.5x smaller."""
    tn = TNet(tconf.MultiLayerConfiguration.from_json(
        jzoo.mnist_mlp(width=64).to_json()), device="cpu").init()
    rng = np.random.default_rng(0)
    y = rng.integers(0, 10, 256)
    x = rng.normal(0, 0.3, (256, 784)).astype(np.float32)
    x[np.arange(256), y * 78] += 3.0       # separable synthetic classes
    for _ in range(15):
        tn.fit_batch(x, np.eye(10, dtype=np.float32)[y])
    q = tprec.QuantizedNet(tn)
    test = rng.normal(0, 0.3, (128, 784)).astype(np.float32)
    test[np.arange(128), (np.arange(128) % 10) * 78] += 3.0
    agreement = (q.predict(test) == tn.predict(test)).mean()
    assert agreement >= 0.99, agreement
    rep = q.quantization_report()
    assert rep["float_param_bytes"] / rep["param_bytes"] >= 3.5
    with pytest.raises(ValueError, match="int8"):
        tprec.QuantizedNet(tn, dtype="int4")


# ---- bucket ladders and bucketed output ------------------------------------------


def test_bucket_ladder_equals_jax():
    for args in ((100,), (16,), (1,), (300, 8)):
        assert tb.pow2_length_buckets(*args) == jb.pow2_length_buckets(*args)
    for buckets, lengths in (((1, 8, 32, 128), None), ((8, 4, 4), (16, 64)),
                             ((2,), None)):
        t, j = tb.BucketLadder(buckets, lengths), jb.BucketLadder(buckets,
                                                                  lengths)
        assert t.batch_buckets == j.batch_buckets
        assert t.length_buckets == j.length_buckets
        assert t.program_bound == j.program_bound
        assert t.max_batch == j.max_batch
        for n in range(1, t.max_batch + 1):
            assert t.batch_bucket(n) == j.batch_bucket(n)
    ladder = tb.BucketLadder((4,), (8, 16))
    x = np.ones((3, 5, 2), np.float32)
    px, pm = ladder.pad_length(x)
    jx, jm = jb.BucketLadder((4,), (8, 16)).pad_length(x)
    assert px.tobytes() == jx.tobytes() and pm.tobytes() == jm.tobytes()
    pr, n = ladder.pad_rows(x)
    assert pr.shape == (4, 5, 2) and n == 3
    for bad in (lambda: tb.BucketLadder(()), lambda: ladder.batch_bucket(5),
                lambda: ladder.length_bucket(17),
                lambda: tb.BucketLadder((2,)).length_bucket(3),
                lambda: tb.pow2_length_buckets(0)):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("quantized", [False, True])
def test_bucketed_output_is_the_padded_dispatch(quantized):
    """Real rows bitwise those of one dispatch of the padded batch; the
    forward sees one input signature per bucket; the values JAX's."""
    jn, tn = _pair(jzoo.mnist_mlp(width=32))
    net = tprec.QuantizedNet(tn) if quantized else tn
    jnet = jprec.QuantizedNet(jn) if quantized else jn
    ladder = tb.BucketLadder((1, 8, 32))
    rng = np.random.default_rng(0)
    for n in (3, 5, 8, 1, 20, 7):
        x = rng.random((n, 784), dtype=np.float32)
        got = net.output_bucketed(x, ladder=ladder)
        assert got.shape == (n, 10) and isinstance(got, np.ndarray)
        b = ladder.batch_bucket(n)
        padded = np.concatenate([x, np.zeros((b - n, 784), np.float32)])
        want = net.output(padded).numpy()[:n]
        assert got.tobytes() == want.tobytes()
        np.testing.assert_allclose(
            got, jnet.output_bucketed(x, ladder=jb.BucketLadder((1, 8, 32))),
            atol=1e-5)
    assert net.forward_program_count() == len(ladder.batch_buckets)


def test_forward_program_count_follows_signatures_and_set_precision():
    tn = TNet(tconf.MultiLayerConfiguration.from_json(
        jzoo.mnist_mlp(width=16).to_json()), device="cpu").init()
    assert tn.forward_program_count() == 0
    x = np.zeros((4, 784), np.float32)
    tn.output(x)
    tn.output(x)
    tn.predict(x)
    assert tn.forward_program_count() == 1
    tn.output(np.zeros((5, 784), np.float32))
    assert tn.forward_program_count() == 2
    tn.set_precision("bf16")
    assert tn.forward_program_count() == 0
    out = tn.output_bucketed(np.zeros((2, 784), np.float32))
    assert out.dtype == np.float32 and tn.forward_program_count() == 1
