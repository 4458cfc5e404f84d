"""Share of its roofline that flash attention the forward (B2) reached in the
traced training steps: the least time the card needs for the work of
each launch (`benchmark.peaks.flash_bound_s` at the microbatch's shape,
times the launches the kernel's wrapper counted in the span) over the
device time of the kernels named below."""

from benchmark import peaks

LAYER = "kernels (csrc/flash_attention.cu via parallel/kernels.py)"
UNIT = "%"
MOVES = "train_tokens_per_s"
KERNEL = "flash_fwd"
NAMES = ("flash_fwd_kernel", "flash_fwd_mma_kernel", "flash_fwd_chunk_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    launches = tr["counters"][KERNEL]
    device_s = sum(tr["kernels"].get(n, (0.0, 0))[0] for n in NAMES)
    if not launches or device_s <= 0:
        return None
    sh = ctx["shapes"]
    bound = peaks.flash_bound_s(KERNEL, sh["b"], sh["s"], sh["h"], sh["d"],
                                sh["causal"], sh["dtype"])
    return 100.0 * launches * bound / device_s
