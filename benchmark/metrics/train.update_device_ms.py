"""The optimizer's time on the device a training step, over the window:
the mean device interval of the ``train.update`` spans of the window's
steps (the ``ctx["steps"]`` ``train.step`` spans just before the traced
steps).  Each interval is the stream's time from the update's first op
to its last, gaps while the host launches them included.  Read from the
port's span store, in this process after the run; None where the port
records no spans or no device intervals."""

LAYER = "optimizer (ops/updaters.py)"
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
    window = {s.sid for s in (steps[-ctx["steps"]:] if ctx["steps"] else [])}
    ms = [s.tag.ns() / 1e6 for s in spans(("train.update",))
          if s.parent in window and s.tag is not None]
    return sum(ms) / len(ms) if ms else None
