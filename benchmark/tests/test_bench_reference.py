"""The plain reference against the port at a tiny size on the CPU, in
float32: the forward, the training steps (AdamW, clip, decoupled decay)
and the served tokens."""

import pytest
import torch

from benchmark import gen, weights
from benchmark.kinds import port_config
from benchmark.reference import gpt2 as ref
from benchmark.reference import judge

from conftest import tiny_config, tiny_train_mix

CPU = torch.device("cpu")


def test_forward_matches_the_port():
    from deeplearning4j_tpu_torch.parallel import transformer as tfm

    cfg = tiny_config("float32")
    w = weights.make(cfg, 3, CPU, torch.float32)
    tokens = torch.randint(0, 512, (2, 40), generator=torch.Generator()
                           .manual_seed(0))
    got = tfm.apply(port_config(cfg), w, tokens)
    want = ref.forward(w, tokens, 1e-5)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_weights_repeat_by_seed_and_follow_the_plan():
    cfg = tiny_config("float32")
    a = weights.make(cfg, 2 ** 31 + 5, CPU, torch.float32)
    b = weights.make(cfg, 2 ** 31 + 5, CPU, torch.float32, separate=True)
    la, lb = weights.leaves(a), weights.leaves(b)
    assert [p for p, _ in la] == [p for p, _, _ in weights.leaf_plan(cfg)]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert weights.n_params(cfg) == sum(t.numel() for _, t in la)
    ln = a["layers"][0]["ln1"]["scale"]
    assert 0.5 < float(ln.mean()) < 1.5


def test_training_steps_match_the_port():
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        make_accum_train_step,
    )

    cfg, mix = tiny_config("float32"), tiny_train_mix()
    o = mix["optimizer"]
    batches = torch.from_numpy(gen.train_batches(mix, 512, 4))[:3]
    step, init = make_accum_train_step(
        port_config(cfg, remat=True), lr=o["lr"], accum=2,
        updater=o["updater"], clip_norm=o["clip_norm"],
        weight_decay=o["weight_decay"])
    p = weights.make(cfg, 4, CPU, torch.float32, separate=True)
    for _, t in weights.leaves(p):
        t.requires_grad_(True)
    names = [weights.path_name(x) for x, _ in weights.leaves(p)]
    start = [t.detach().clone() for _, t in weights.leaves(p)]
    opt, losses = init(p), []
    for i, b in enumerate(batches):
        p, opt, loss = step(p, opt, b[:, :-1], b[:, 1:])
        losses.append(float(loss))
        if i == 0:
            first = {n: m.detach() / (1 - o["beta1"])
                     for n, (_, m) in zip(names, weights.leaves(opt["m"]))}
    change = {n: float(torch.linalg.vector_norm(t.detach() - s))
              for n, (_, t), s in zip(names, weights.leaves(p), start)}
    r = ref.train_steps(weights.make(cfg, 4, CPU, torch.float32,
                                     separate=True), list(batches), 1e-5, o,
                        accum=2, rows=1)
    grad = {n: float(torch.linalg.vector_norm(g)) for n, g in first.items()}
    nums = judge.train_numbers({"loss": losses, "grad": grad,
                                "first": first, "change": change}, r)
    assert nums["loss_gap"]["value"] < 1e-5
    assert nums["grad_gap"]["value"] < 1e-4
    assert nums["grad_dist"]["value"] < 1e-4
    assert nums["change_gap"]["value"] < 1e-3
    # the key biases: gradient nought to rounding, left out of the change
    assert all("/bk" in n for n in nums["change_gap"]["left_out"])
    assert nums["change_gap"]["left_out"]


def test_served_tokens_of_the_port_are_the_reference_argmax():
    from deeplearning4j_tpu_torch.serving import ContinuousLMServer

    cfg = tiny_config("float32")
    w = weights.make(cfg, 6, CPU, torch.float32)
    srv = ContinuousLMServer(port_config(cfg), w, slots=2, page_size=16,
                             prefill_chunk=8, device="cpu")
    try:
        prompts = [list(range(7, 40)), list(range(100, 117))]
        served = [srv.generate(pr, 9)[len(pr):] for pr in prompts]
    finally:
        srv.stop()
    gaps = ref.served_gaps(w, list(zip(prompts, served)), 1e-5, CPU)
    assert judge.served_gap(gaps) < 1e-4
    altered = [(prompts[0], [(served[0][0] + 1) % 512] + served[0][1:])]
    assert judge.served_gap(ref.served_gaps(w, altered, 1e-5, CPU)) > 1e-3


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    e8 = (ref.fp8_round(x) - x).abs().max() / x.abs().max()
    e16 = (x.bfloat16().float() - x).abs().max() / x.abs().max()
    assert e8 > 8 * e16
    assert torch.equal(ref.fp8_round(ref.fp8_round(x)), ref.fp8_round(x))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_where_the_program_passes(seed):
    """At a size a test run holds: over the same positions, the widest
    gap of the token the float8 control puts first is several times that
    of the token the port puts first in bfloat16."""
    from deeplearning4j_tpu_torch.parallel import transformer as tfm

    cfg = tiny_config("bfloat16", n_embd=128, vocab_size=2048)
    w16 = weights.make(cfg, seed, CPU, torch.bfloat16)
    w = ref.as_float32(w16)
    seq = torch.randint(0, 2048, (1, 128), generator=torch.Generator()
                        .manual_seed(seed))
    with torch.no_grad():
        want = ref.forward(w, seq, 1e-5)[0]
        prog = tfm.apply(port_config(cfg), w16, seq)[0].float().argmax(-1)
        ctrl = ref.forward(w, seq, 1e-5, low="fp8")[0].argmax(-1)
    best = want.max(-1).values

    def gap(pick):
        return float((best - want.gather(-1, pick[:, None])[:, 0]).max())

    assert gap(ctrl) > 3 * gap(prog)
