"""Share of the traced span under serving load in which no operation ran
on the device (1 - the union of device activity over the span)."""

LAYER = "device"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
