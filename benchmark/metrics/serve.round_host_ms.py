"""The host's part of a serving round, over the window: the mean of each
``serve.round`` span the port recorded inside ``[t0, t1)`` less its
``serve.wait`` child (the round's one host sync, while the device runs
the step).  Read from the port's span store, in this process after the
run; None where the port records no spans."""

LAYER = "serve scheduler (serving/lm.py)"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(ctx):
    try:
        from deeplearning4j_tpu_torch.obs.trace import spans
    except ImportError:
        return None
    t0, t1 = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    rounds, waits = {}, {}
    for s in spans(("serve.round", "serve.wait")):
        if s.name == "serve.round":
            if t0 <= s.t0_ns < t1:
                rounds[s.sid] = s.t1_ns - s.t0_ns
        else:
            waits[s.parent] = s.t1_ns - s.t0_ns
    host = [d - waits.get(sid, 0) for sid, d in rounds.items()]
    return sum(host) / len(host) / 1e6 if host else None
