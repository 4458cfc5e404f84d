"""The whole serve step's share of the card's bf16 peak over the window:
the model FLOPs of the work delivered in it (each prompt's prefill where
its first token came inside the window, its positions from the mean
prefix-cache match on; each later token inside the window through the
blocks, the LM head and attention over its context; `benchmark.peaks`)
over the window's seconds and 989 TFLOP/s."""

from benchmark import peaks

LAYER = "whole serve step"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(ctx):
    dims, c = ctx["dims"], ctx["counters"]
    t0, t1 = ctx["t0"], ctx["t1"]
    matched = c["prefix_saved"] / c["requests"] if c["requests"] else 0.0
    flops = 0.0
    for r in ctx["requests"]:
        for j, t in enumerate(r["times"]):
            if not t0 <= t < t1:
                continue
            flops += (peaks.prefill_flops(dims, r["plen"], matched) if j == 0
                      else peaks.decode_flops(dims, r["plen"] + j))
    if flops <= 0:
        return None
    return 100.0 * flops / ctx["seconds"] / peaks.PEAK_OPS[ctx["dtype"]]
