"""The 95th percentile, over every request submitted inside the window,
of the time from submit to its first streamed token, at the clients.  A
closed loop runs the pool at its capacity, where such a tail swings with
the smallest change: it stands here beside ``serve_tokens_per_s``."""

from benchmark.kinds import p95

LAYER = "serve scheduler (serving/lm.py)"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(ctx):
    t0, t1 = ctx["t0"], ctx["t1"]
    ttft = [(r["times"][0] - r["t_sub"]) * 1e3 for r in ctx["requests"]
            if t0 <= r["t_sub"] < t1 and r["times"]]
    return p95(ttft) if ttft else None
