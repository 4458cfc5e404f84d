"""The training step's share of the card's bf16 peak over the window:
model FLOPs a step (6 N a token plus causal attention, without the remat
recompute; `benchmark.peaks.train_step_flops`) times the window's steps,
over the window's seconds and 989 TFLOP/s."""

from benchmark import peaks

LAYER = "train step (parallel/hybrid.py)"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    if not ctx["steps"]:
        return None
    return (100.0 * ctx["step_flops"] * ctx["steps"] / ctx["seconds"]
            / peaks.PEAK_OPS[ctx["dtype"]])
