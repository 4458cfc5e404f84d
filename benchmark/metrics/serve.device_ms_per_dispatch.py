"""Device busy time a serving dispatch, in the traced span: the union of
the device's activity (the profiler's trace) over the dispatches the
pool counted in the same span."""

LAYER = "serve model step (parallel/generation.py under runtime/programs.py)"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["counters"]["dispatches"] or tr["busy_s"] <= 0:
        return None
    return 1e3 * tr["busy_s"] / tr["counters"]["dispatches"]
