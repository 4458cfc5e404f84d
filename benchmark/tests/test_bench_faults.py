"""A run with the timed path broken underneath comes out not correct.

The harness is driven on the CPU at a tiny size in float32 (the look
for a card skipped), with limits for that size: a sound run passes
them, and each fault the cell can have fails one of its numbers:

- serving: a token altered where it is produced;
- training: a step that returns its state unchanged; half of each
  microbatch left out, the mean taken over the rest.

(One chip only: no exchange between chips to leave out.)  The limits
here compare the same numbers as the cells' committed limits, at values
for this size; in training the float8 control (`benchmark.calibrate`,
the reference in float8 in the program's place) fails them too.
"""

import pytest
import torch

from benchmark import calibrate, run, spec

from conftest import tiny_config, tiny_serve_mix, tiny_train_mix

CPU = torch.device("cpu")
# a limit at this size for each number a committed limit may compare
TINY = {"served_gap": 1e-3, "served_gap_mean": 1e-4, "loss_gap": 1e-4,
        "grad_dist_median": 1e-3, "change_gap": 1e-2,
        "nonfinite_losses": 0.0}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def tiny_limits(cell):
    """The cell's committed limits, each number at its value for this
    size: the same numbers compared, and no other."""
    return {"numbers": {
        n: {"limit": TINY[n]}
        for n, v in spec.limits(cell)["numbers"].items()
        if v["limit"] is not None}}


@pytest.mark.parametrize("cell", CELLS)
def test_every_committed_number_has_a_tiny_limit(cell):
    assert tiny_limits(cell)["numbers"]


def _serve(bench, monkeypatch, seed):
    limits = tiny_limits("rag.gpt2-small")
    monkeypatch.setattr(spec, "limits", lambda name: limits)
    mix = tiny_serve_mix("rag")
    code, result = run.execute(
        ["--workload", "rag.gpt2-small", "--seed", str(seed),
         "--seconds", "4"], device=CPU, bench=bench,
        cfg=tiny_config("float32"), mix=mix)
    assert code == 0
    return result


def _train(bench, monkeypatch, seed):
    limits = tiny_limits("pretrain.gpt2-small")
    monkeypatch.setattr(spec, "limits", lambda name: limits)
    code, result = run.execute(
        ["--workload", "pretrain.gpt2-small", "--seed", str(seed),
         "--seconds", "0.5"], device=CPU, bench=bench,
        cfg=tiny_config("float32"), mix=tiny_train_mix())
    assert code == 0
    return result


def test_sound_serving_run_is_correct(bench, monkeypatch):
    result = _serve(bench, monkeypatch, 5)
    assert result["correct"], result["checks"]


def test_altered_token_is_caught(bench, monkeypatch):
    from deeplearning4j_tpu_torch.serving import ContinuousLMServer

    real = ContinuousLMServer.generate_stream

    def altered(self, prompt_ids, max_new_tokens, *a, **kw):
        for i, tok in enumerate(real(self, prompt_ids, max_new_tokens,
                                     *a, **kw)):
            yield (tok + 1) % self.cfg.vocab_size if i == 1 else tok

    monkeypatch.setattr(ContinuousLMServer, "generate_stream", altered)
    result = _serve(bench, monkeypatch, 5)
    assert not result["correct"]
    assert (result["checks"]["served_gap_mean"]["value"]
            > TINY["served_gap_mean"])


def test_sound_training_run_is_correct(bench, monkeypatch):
    result = _train(bench, monkeypatch, 9)
    assert result["correct"], result["checks"]


def _broken_step(monkeypatch, wrap):
    from deeplearning4j_tpu_torch.parallel import hybrid

    real = hybrid.make_accum_train_step

    def make(*a, **kw):
        step, init = real(*a, **kw)
        return wrap(step), init

    monkeypatch.setattr(hybrid, "make_accum_train_step", make)


def test_state_left_unchanged_is_caught(bench, monkeypatch):
    def wrap(step):
        def unchanged(params, opt, tok, tgt):
            keep = [p.detach().clone() for p in _leaves(params)]
            params, opt, loss = step(params, opt, tok, tgt)
            with torch.no_grad():
                for p, k in zip(_leaves(params), keep):
                    p.copy_(k)
            return params, opt, loss
        return unchanged

    _broken_step(monkeypatch, wrap)
    result = _train(bench, monkeypatch, 9)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_left_out_is_caught(bench, monkeypatch):
    def wrap(step):
        def half(params, opt, tok, tgt):
            # the first half of each microbatch's rows; the mean over them
            mb = tok.shape[0] // 2
            keep = torch.cat([torch.arange(0, mb // 2),
                              torch.arange(mb, mb + mb // 2)])
            return step(params, opt, tok[keep], tgt[keep])
        return half

    _broken_step(monkeypatch, wrap)
    result = _train(bench, monkeypatch, 9)
    assert not result["correct"]
    bad = [n for n, c in result["checks"].items()
           if c["limit"] is not None and c["value"] > c["limit"]]
    assert bad


def _leaves(tree):
    from benchmark.weights import leaves
    return [t for _, t in leaves(tree)]


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(cell):
    """What `benchmark.calibrate` reads on the card, at this size: the
    sound run passes the cell's limits, and each fault, and in training
    the float8 control, fails them.  A tiny served model's greedy tokens
    keep their lead under float8 at most positions, often at all of them,
    so the serving control is judged on the card alone
    (`test_bench_card.py`)."""
    limits = tiny_limits(cell)
    if cell.startswith("pretrain"):
        mix, seconds = tiny_train_mix(), 0.5
    else:
        mix, seconds = tiny_serve_mix(cell.split(".")[0]), 4.0
    cfg = tiny_config("float32")
    out = spec.kind(mix["kind"]).run(
        cell={}, cfg=cfg, mix=mix, seed=13, seconds=seconds, trace=False,
        device=CPU, t_start=0.0)
    nums = {k: v["value"] for k, v in out["numbers"].items()}
    assert out["failed"] == 0 and calibrate.verdict(nums, limits), nums
    got = calibrate.faults(out, cfg, mix, 13, CPU)
    assert "control_fp8" in got and len(got) >= 2
    if not cell.startswith("pretrain"):
        del got["control_fp8"]
    for what, readings in got.items():
        assert not calibrate.verdict(readings, limits), (what, readings)
