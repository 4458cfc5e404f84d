"""PyTorch port, slice 9: the fused multi-step driver
(`deeplearning4j_tpu_torch.runtime.fused`) and `MultiLayerNetwork`'s
chunked fit against the JAX package on the same numpy inputs, weights
carried over with `params_from_numpy`, on the CPU.

Tolerances: the assembled chunks are equal to JAX's arrays; a chunk's
per-step losses, gradient norms and the parameters after it 1e-5
(float32; Adam on random, non-one-hot inputs so that no gradient element
sits near zero, where Adam's first step turns rounding noise into a ±lr
move).  Within the port, ``chunk_size`` 1 and 8 give bitwise-equal
parameters (the same per-step code and generators on the same data).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu.runtime import fused as jfused
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.optimize import (
    IterationListener,
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.runtime import fused as tfused
from test_torch_cli_train import _run, csv_file  # noqa: F401 — fixture
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

V, H = 11, 16


def _pair(jc):
    jn = JNet(jc).init()
    tn = TNet(tconf.MultiLayerConfiguration.from_json(jc.to_json()),
              device="cpu").init()
    tn.params = params_from_numpy(
        tn, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params])
    return jn, tn


def _data(n=37, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = rng.normal(0, 0.3, (n, 4)).astype(np.float32) + y[:, None]
    return x, np.eye(3, dtype=np.float32)[y]


def _batches(x, y, batch=8):
    """Mini-batches with a ragged tail (37 examples / 8: a tail of 5)."""
    return [(x[i:i + batch], y[i:i + batch]) for i in range(0, len(x), batch)]


def _seq_batches(n_batches=3, b=4, t=7, seed=0):
    """Random (non-one-hot) sequences with ragged masks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.standard_normal((b, t, V)).astype(np.float32)
        ids = rng.integers(0, V, (b, t))
        y = np.eye(V, dtype=np.float32)[ids]
        m = np.ones((b, t), np.float32)
        m[1, rng.integers(1, t):] = 0
        out.append((x, y, m))
    return out


# ---- chunk assembly ----------------------------------------------------------


STREAMS = {
    "ragged_tail": lambda: _batches(*_data(21)),
    "short_group": lambda: _batches(*_data(48)),
    "shape_flush": lambda: _batches(*_data(32)) + [
        (np.ones((8, 6), np.float32), np.zeros((8, 3), np.float32))],
    "larger_batch_flush": lambda: _batches(*_data(12), batch=4) + [
        _data(8, seed=1)],
    "masked_sequences": lambda: _seq_batches(5),
}


@pytest.mark.parametrize("chunk", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_assemble_chunks_equals_jax(name, chunk):
    want = list(jfused.assemble_chunks(iter(STREAMS[name]()), chunk))
    got = list(tfused.assemble_chunks(iter(STREAMS[name]()), chunk))
    assert [c.steps for c in got] == [c.steps for c in want]
    for a, b in zip(got, want):
        for field in ("xs", "ys", "weights", "masks"):
            wa, wb = getattr(a, field), getattr(b, field)
            assert (wa is None) == (wb is None), field
            if wa is not None:
                assert wa.dtype == wb.dtype, field
                np.testing.assert_array_equal(wa, wb, err_msg=field)


def test_assemble_takes_datasets_and_stack_batches_pads():
    x, y = _data(13)
    want = jfused.stack_batches([(x[:8], y[:8], None), (x[8:], y[8:], None)])
    got = tfused.stack_batches([(x[:8], y[:8], None), (x[8:], y[8:], None)])
    for field in ("xs", "ys", "weights"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.masks is None and got.weights[1].sum() == 5
    chunks = list(tfused.assemble_chunks(
        iter([TDataSet(x[:8], y[:8]), TDataSet(x[8:], y[8:])]), 2))
    assert [c.steps for c in chunks] == [2]
    with pytest.raises(ValueError, match="chunk_size"):
        list(tfused.assemble_chunks(iter([]), 0))


# ---- fit_chunk_async against JAX ------------------------------------------------


def test_fit_chunk_async_matches_jax_on_masked_sequences():
    jn, tn = _pair(jzoo.char_lstm(vocab_size=V, hidden=H))
    seqs = _seq_batches(4, seed=3)
    for chunk in tfused.assemble_chunks(iter(seqs), 2):
        j_l, j_g = jn.fit_chunk_async(chunk.xs, chunk.ys, chunk.masks,
                                      chunk.weights)
        t_l, t_g = tn.fit_chunk_async(chunk.xs, chunk.ys, chunk.masks,
                                      chunk.weights)
        assert t_l.shape == t_g.shape == (chunk.steps,)
        np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), rtol=1e-5)
        np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=1e-4)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-5)
    assert tn._iteration == jn._iteration == 4
    assert float(tn.last_grad_norm) == pytest.approx(
        float(jn.last_grad_norm), rel=1e-4)


def test_fit_chunk_async_pads_a_ragged_tail_like_jax():
    """The weighted objective: zero-weight padded rows change nothing."""
    jn, tn = _pair(jzoo.iris_mlp())
    x, y = _data(37, seed=2)
    rng = np.random.default_rng(9)
    x = x + rng.standard_normal(x.shape).astype(np.float32)
    for chunk in tfused.assemble_chunks(iter(_batches(x, y)), 5):
        j_l, _ = jn.fit_chunk_async(chunk.xs, chunk.ys, chunk.masks,
                                    chunk.weights)
        t_l, _ = tn.fit_chunk_async(chunk.xs, chunk.ys, chunk.masks,
                                    chunk.weights)
        np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), rtol=1e-5)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=1e-5)


# ---- chunk-size invariance ------------------------------------------------------


def _fit(chunk, epochs=2, prefetch=2, policy=None):
    net = TNet(tzoo.iris_mlp(), device="cpu").init()
    if policy is not None:
        net.set_precision(policy)
    net.fit(_batches(*_data()), epochs=epochs, chunk_size=chunk,
            prefetch=prefetch)
    return net


@pytest.mark.parametrize("chunk", [4, 7, 8])
def test_chunk_sizes_give_bitwise_equal_params(chunk):
    ref = _fit(1).params_flat()
    assert _fit(chunk).params_flat().tobytes() == ref.tobytes()


def test_prefetch_and_policy_do_not_break_invariance():
    a = _fit(8, prefetch=2, policy="mixed").params_flat()
    b = _fit(8, prefetch=0, policy="mixed").params_flat()
    c = _fit(1, prefetch=0, policy="mixed").params_flat()
    assert a.tobytes() == b.tobytes() == c.tobytes()


def test_poison_batch_mid_chunk_skips_only_its_step():
    x, y = _data(32)
    k = 4
    xs = np.broadcast_to(x, (k,) + x.shape).copy()
    ys = np.broadcast_to(y, (k,) + y.shape).copy()
    xs[2] = np.inf
    chunked = TNet(tzoo.iris_mlp(), device="cpu").init()
    chunked.set_precision("mixed")
    losses, gnorms = chunked.fit_chunk_async(xs, ys)
    losses = losses.numpy()
    assert not np.isfinite(losses[2]) and np.isfinite(losses[[0, 1, 3]]).all()
    assert not np.isfinite(float(gnorms[2]))
    assert np.isfinite(chunked.params_flat()).all()
    assert chunked.scaler_stats()["overflow_count"] == 1
    stepped = TNet(tzoo.iris_mlp(), device="cpu").init()
    stepped.set_precision("mixed")
    for i in range(k):
        stepped.fit_chunk_async(xs[i:i + 1], ys[i:i + 1])
    assert chunked.params_flat().tobytes() == stepped.params_flat().tobytes()
    jn = JNet(jzoo.iris_mlp()).init()
    jn.set_precision("mixed")
    jn.fit_chunk_async(xs, ys)
    assert chunked.scaler_stats() == jn.scaler_stats()


def test_chunked_fit_tracks_the_per_batch_fit():
    ref = TNet(tzoo.iris_mlp(), device="cpu").init()
    ref.fit(_batches(*_data()), epochs=2)
    np.testing.assert_allclose(_fit(4).params_flat(), ref.params_flat(),
                               atol=1e-5)


def test_chunked_fit_refusals():
    net = TNet(tzoo.iris_mlp(), device="cpu").init()
    data = _batches(*_data(16))
    with pytest.raises(ValueError, match="mutually exclusive"):
        net.fit(data, chunk_size=2, accum_steps=2)
    solver = tconf.MultiLayerConfiguration.from_json(
        jzoo.iris_mlp().to_json().replace('"stochastic_gradient_descent"',
                                          '"lbfgs"'))
    with pytest.raises(ValueError, match="solvers"):
        TNet(solver, device="cpu").init().fit(data, chunk_size=2)
    with pytest.raises(ValueError, match="chunk_size"):
        tfused.FusedTrainingDriver(net, chunk_size=0)
    with pytest.raises(ValueError, match="generators"):
        tfused.FusedTrainingDriver(net, 2).fit((b for b in data), epochs=2)


# ---- listeners --------------------------------------------------------------------


def test_listener_order_and_score_only_match_jax():
    """A score listener on its interval, a plain function every step, and
    a model-reading listener at chunk ends only: the calls (iteration,
    which listener) in JAX's order, the scores JAX's."""
    calls = {"j": [], "t": []}

    def attach(net, key, reading_cls):
        out = calls[key]
        net.add_listener(ScoreIterationListener(
            print_iterations=3, out=lambda s, o=out: o.append(("score", s))))
        net.add_listener(lambda it, s, o=out: o.append(("fn", it, s)))

        class Reader(reading_cls):
            def iteration_done(self, model, iteration, score, o=out):
                o.append(("model", iteration, score))

        net.add_listener(Reader())

    from deeplearning4j_tpu.optimize import (
        IterationListener as JIterationListener,
    )
    from deeplearning4j_tpu.optimize import (
        ScoreIterationListener as JScoreIterationListener,
    )

    jn, tn = _pair(jzoo.iris_mlp())
    attach(tn, "t", IterationListener)
    # the JAX net's listeners, from its own package
    out = calls["j"]
    jn.add_listener(JScoreIterationListener(
        print_iterations=3, out=lambda s: out.append(("score", s))))
    jn.add_listener(lambda it, s: out.append(("fn", it, s)))

    class JReader(JIterationListener):
        def iteration_done(self, model, iteration, score):
            out.append(("model", iteration, score))

    jn.add_listener(JReader())
    x, y = _data(32)
    rng = np.random.default_rng(1)
    x = x + rng.standard_normal(x.shape).astype(np.float32)
    jn.fit(_batches(x, y), epochs=2, chunk_size=4, prefetch=0)
    tn.fit(_batches(x, y), epochs=2, chunk_size=4, prefetch=0)
    kinds = [(c[0], c[1] if c[0] != "score" else None) for c in calls["t"]]
    assert kinds == [(c[0], c[1] if c[0] != "score" else None)
                     for c in calls["j"]]
    assert [c[1] for c in calls["t"] if c[0] == "model"] == [4, 8]
    for a, b in zip(calls["t"], calls["j"]):
        if a[0] != "score":
            assert a[2] == pytest.approx(b[2], rel=1e-5)


def test_chunk_reads_the_host_once_and_only_when_due(monkeypatch):
    reads = []
    real = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real(self, *a, **kw)

    net = TNet(tzoo.iris_mlp(), device="cpu").init()
    net.add_listener(ScoreIterationListener(print_iterations=100,
                                            out=lambda s: None))
    x, y = _data(32)
    xs = np.stack([x] * 4)
    ys = np.stack([y] * 4)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    net.fit_chunk_async(xs, ys)          # iterations 1..4: nothing due
    assert reads == []
    net.add_listener(lambda it, s: None)  # due every step
    net.fit_chunk_async(xs, ys)
    assert reads == [(4,)]               # one read of the loss vector


# ---- the CLI ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_chunked(csv_file, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("mixed")
    rc, text = _run(["train", "-input", str(csv_file), "-model",
                     "zoo:iris-mlp", "-output", str(out), "-epochs", "15",
                     "-batch", "32", "-precision", "mixed", "-chunk", "8",
                     "-device", "cpu"])
    return rc, text, out


def test_train_precision_and_chunk_flags(mixed_chunked):
    rc, text, out = mixed_chunked
    assert rc == 0
    assert "precision: param=float32/compute=bfloat16/out=float32" \
        "+loss-scale" in text
    assert "precision: loss-scale 32768, 0 overflow step(s) skipped" in text
    assert "Trained 15 epochs on 150 examples" in text
    acc = float(text.split("Accuracy:")[1].split()[0])
    assert acc >= 0.9


def test_train_precision_model_loads_in_jax(mixed_chunked, csv_file):  # noqa: F811,E501
    _, _, out = mixed_chunked
    jn = jckpt.load_model(out / "model")
    assert jn.precision.compute_dtype == "bfloat16"
    rc, text = _run(["test", "-input", str(csv_file), "-model",
                     str(out / "model"), "-device", "cpu"])
    assert rc == 0 and "Accuracy:" in text


def test_train_precision_and_chunk_properties(csv_file, tmp_path):  # noqa: F811,E501
    props = tmp_path / "train.props"
    props.write_text("train.precision=bf16\ntrain.chunk.size=4\n")
    rc, text = _run(["train", "-input", str(csv_file), "-model",
                     "zoo:iris-mlp", "-output", str(tmp_path / "o"),
                     "-epochs", "2", "-conf", str(props), "-device", "cpu"])
    assert rc == 0
    assert "precision: param=bfloat16/compute=bfloat16/out=float32" in text
    assert "loss-scale" not in text          # bf16 scales no loss
    jn = jckpt.load_model(tmp_path / "o" / "model")
    assert jn.precision.param_dtype == "bfloat16"


def test_dataset_objects_train_chunked_like_tuples():
    x, y = _data(24)
    a = TNet(tzoo.iris_mlp(), device="cpu").init()
    b = TNet(tzoo.iris_mlp(), device="cpu").init()
    a.fit([TDataSet(x[:8], y[:8]), TDataSet(x[8:], y[8:])], chunk_size=2)
    b.fit([(x[:8], y[:8]), (x[8:], y[8:])], chunk_size=2)
    assert a.params_flat().tobytes() == b.params_flat().tobytes()
    jn = JNet(jzoo.iris_mlp()).init()
    jn.fit([JDataSet(x[:8], y[:8]), JDataSet(x[8:], y[8:])], chunk_size=2)
    assert jn._iteration == a._iteration == 2
