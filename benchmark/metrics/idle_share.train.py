"""Share of the traced training steps in which no operation ran on the
device (1 - the union of device activity over the span)."""

LAYER = "device"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
