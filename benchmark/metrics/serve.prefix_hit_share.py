"""Share of the prompt tokens of the window's requests that the radix
prefix cache served (`ServingMetrics.prefix_tokens_saved_total` over the
window, over the prompt tokens of the requests submitted in it; with a
closed loop of as many clients as slots a request is admitted as it is
submitted)."""

LAYER = "prefix cache (serving/paged.py)"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(ctx):
    c = ctx["counters"]
    if not c["prompt_tokens"]:
        return None
    return 100.0 * c["prefix_saved"] / c["prompt_tokens"]
