"""The host's time a training step, over the window: the mean length of
the ``train.step`` spans of the window's steps (the ``ctx["steps"]``
spans that come just before the traced steps).  The eager step returns
once its work is queued, so this is its host dispatch.  Read from the
port's span store, in this process after the run; None where the port
records no spans."""

LAYER = "train step (parallel/hybrid.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    try:
        from deeplearning4j_tpu_torch.obs.trace import spans
    except ImportError:
        return None
    steps = spans(("train.step",))
    traced = ctx["trace"]["steps"] if ctx.get("trace") else 0
    if traced:
        steps = steps[:-traced]
    steps = steps[-ctx["steps"]:] if ctx["steps"] else []
    if not steps:
        return None
    return sum(s.t1_ns - s.t0_ns for s in steps) / len(steps) / 1e6
