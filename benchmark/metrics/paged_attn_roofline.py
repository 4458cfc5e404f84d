"""Share of its roofline that paged attention (B1) reached in the traced
span under serving load.  A launch's bound is the larger of its bytes
over the card's memory rate and its flops over the dtype's peak
(`benchmark.peaks`): bytes the mean over the window's ``serve.round``
spans of ``kv_pages`` x ``page_size`` x 2 (K and V) x H x D x the
element's bytes, plus the fed columns' queries in and outputs out;
flops 4 x H x D a causal query-key pair (``qk_pairs``).  The bound
times the B1 launches the wrapper counted in the traced span, over the
device time of the kernels named below.

The mean is taken over the window, not the traced span, because the
traced rounds cannot be placed exactly on the window's clock; the
closed loop is steady, so the two hold the same mix of rounds.  None
where the port records no spans."""

from benchmark import peaks

LAYER = "kernels (csrc/paged_attention.cu via parallel/paged_kernel.py)"
UNIT = "%"
MOVES = "serve_tokens_per_s"
NAMES = ("paged_attention_mma_kernel", "paged_attention_vec_kernel",
         "paged_attention_merge_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    try:
        from deeplearning4j_tpu_torch.obs.trace import SPAN_COUNTS, spans
    except ImportError:
        return None
    launches = sum(tr["counters"]["b1"].values())
    device_s = sum(tr["kernels"].get(n, (0.0, 0))[0] for n in NAMES)
    t0, t1 = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    names = SPAN_COUNTS["serve.round"]
    rounds = [dict(zip(names, s.counts)) for s in spans(("serve.round",))
              if t0 <= s.t0_ns < t1]
    rounds = [c for c in rounds if c["page_size"]]
    if not launches or device_s <= 0 or not rounds:
        return None
    dims = ctx["dims"]
    row = dims["H"] * dims["K"] * (4 if ctx["dtype"] == "float32" else 2)
    n = len(rounds)
    kv = sum(c["kv_pages"] * c["page_size"] for c in rounds) / n * 2 * row
    qo = sum(c["fed_tokens"] for c in rounds) / n * 2 * row
    flops = sum(c["qk_pairs"] for c in rounds) / n * 4 * dims["H"] * dims["K"]
    bound = max((kv + qo) / peaks.HBM_BYTES_PER_S,
                flops / peaks.PEAK_OPS[ctx["dtype"]])
    return 100.0 * launches * bound / device_s
