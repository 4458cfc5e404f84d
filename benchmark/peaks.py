"""The yardstick's arithmetic: the card's published peaks, the work a
flash-attention launch needs, and the model FLOPs of a served token or a
training step.  All counted from shapes, never from the program.

Peaks: NVIDIA H100 SXM data sheet, dense rates (989 TFLOP/s bf16 / f16,
67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM3), at the full
700 W power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

# flash kernels: name -> products of 2 S^2 D B H flops each
FLASH_PRODUCTS = {"flash_fwd": 2, "flash_bwd_dkv": 4, "flash_bwd_dq": 3}


def flash_bound_s(name: str, b: int, s: int, h: int, d: int, causal: bool,
                  dtype: str) -> float:
    """The least seconds the card needs for one flash launch's work: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its flops (causal: half the score matrix)
    over the dtype's peak."""
    x = b * s * h * d * (4 if dtype == "float32" else 2)
    stat = b * h * s * 4                              # one [B*H, S] f32
    nbytes = {"flash_fwd": 4 * x + stat,              # q k v in, out, lse
              "flash_bwd_dkv": 6 * x + 2 * stat,      # q k v dO, dk dv
              "flash_bwd_dq": 5 * x + 2 * stat}[name]
    ops = FLASH_PRODUCTS[name] * 2 * s * s * d * b * h
    if causal:
        ops //= 2
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])


def block_params(dims: dict) -> int:
    """Parameters of the transformer blocks (matmul weights and biases;
    the layer norms' few are left out)."""
    d, f = dims["d"], dims["F"]
    return dims["L"] * (4 * d * d + 4 * d + 2 * d * f + f + d)


def head_params(dims: dict) -> int:
    """The LM head: the tied embedding, d x V."""
    return dims["d"] * dims["V"]


def attn_flops_per_token(dims: dict, context: int) -> int:
    """Scores and the weighted sum of one query over `context` keys, all
    layers (2 flops a multiply-add)."""
    return 4 * dims["L"] * dims["d"] * int(context)


def train_step_flops(dims: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step: 6 N per token (forward 2N,
    backward 4N; N the blocks and the LM head, whose weight is the tied
    embedding; the lookup itself costs nothing) plus causal attention,
    3 x (2 S^2 d / 2 x 2) per layer and sequence; the remat recompute is
    not counted."""
    n = block_params(dims) + head_params(dims)
    attn = 6 * dims["L"] * dims["d"] * seq * seq
    return int(6 * n * batch * seq + attn * batch)


def prefill_flops(dims: dict, plen: int, matched: float) -> float:
    """Model FLOPs of a prompt's prefill up to its first token: the
    positions from `matched` (served from the prefix cache) on, each
    through the blocks and attention over its causal context, and the LM
    head once, at the last position."""
    m = min(float(matched), plen - 1.0)
    fed = plen - m
    # positions m .. plen-1 attend to m+1 .. plen keys
    ctx_sum = (m + 1 + plen) * fed / 2.0
    return (2.0 * block_params(dims) * fed
            + 4.0 * dims["L"] * dims["d"] * ctx_sum
            + 2.0 * head_params(dims))


def decode_flops(dims: dict, context: int) -> float:
    """Model FLOPs of one decoded token whose query sees `context` keys:
    the blocks, the LM head and attention."""
    return (2.0 * (block_params(dims) + head_params(dims))
            + attn_flops_per_token(dims, context))
