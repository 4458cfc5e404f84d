"""The 95th percentile of the queue wait of the requests enqueued inside
the window: each ``serve.queue`` span (enqueue to lane install) the
port recorded with its start in ``[t0, t1)``.  Read from the port's span
store, in this process after the run; None where the port records no
spans."""

from benchmark.kinds import p95

LAYER = "serve scheduler (serving/lm.py)"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(ctx):
    try:
        from deeplearning4j_tpu_torch.obs.trace import spans
    except ImportError:
        return None
    t0, t1 = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    waits = [(s.t1_ns - s.t0_ns) / 1e6 for s in spans(("serve.queue",))
             if t0 <= s.t0_ns < t1]
    return p95(waits) if waits else None
