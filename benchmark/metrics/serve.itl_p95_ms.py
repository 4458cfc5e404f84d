"""The 95th percentile of every gap between consecutive streamed tokens
of a request with both tokens inside the window, at the clients.  A
closed loop runs the pool at its capacity, where such a tail swings with
the smallest change: it stands here beside ``serve_tokens_per_s``."""

from benchmark.kinds import p95

LAYER = "serve scheduler (serving/lm.py)"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(ctx):
    t0, t1 = ctx["t0"], ctx["t1"]
    itl = [(b - a) * 1e3 for r in ctx["requests"]
           for a, b in zip(r["times"], r["times"][1:]) if t0 <= a and b < t1]
    return p95(itl) if itl else None
