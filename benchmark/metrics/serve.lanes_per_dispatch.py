"""Real lanes a serving dispatch carries, over the window: the pool's
``record_dispatch`` lanes (`ServingMetrics.rows_total`) over its
dispatches (`ServingMetrics.dispatches_total`)."""

LAYER = "serve scheduler (serving/lm.py)"
UNIT = "lanes"
MOVES = "serve_tokens_per_s"


def read(ctx):
    c = ctx["counters"]
    return c["lanes"] / c["dispatches"] if c["dispatches"] else None
