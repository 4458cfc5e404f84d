"""Share of the window's paged-attention (B1) launches made at the wide
width (the prefill chunk), from `paged_flash_attention.launches` keyed by
query width: every dispatch launches B1 once a layer, so this is the
share of dispatches that carry a prefill chunk, which lengthen the gaps
between the tokens of every lane in them."""

LAYER = "serve scheduler (serving/lm.py)"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(ctx):
    b1 = ctx["counters"]["b1"]
    total = sum(b1.values())
    if not total:
        return None
    return 100.0 * b1.get(ctx["wide_width"], 0) / total
