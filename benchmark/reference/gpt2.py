"""Plain GPT-2 in float32: the reference that decides ``correct``.

Plain PyTorch operations only, written from the published GPT-2
architecture: learned position embeddings, pre-norm blocks (layer norm,
eps from the config), causal softmax attention with biases, a tanh-GELU
MLP of width ``n_inner``, a final layer norm and the LM head tied to the
token embedding.  No kernel, cache or batching of the program; nothing
of the program is imported.  It reads the benchmark's own seeded weight
tree (the layout in `benchmark.weights`).

Float32 with TF32 off (`exact_float32`).  ``low="fp8"`` is the control:
the same arithmetic with every matrix product's operands rounded to
float8 e4m3 (one scale a tensor, its largest magnitude at 448), the
precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F


def exact_float32() -> None:
    """Float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor; the
    gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def _mm(a: torch.Tensor, b: torch.Tensor, low: Optional[str]):
    if low == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    return a @ b


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


def as_float32(tree) -> dict:
    """A weight tree in float32 (a copy where the tree is not)."""
    return _f32(tree)


def forward(w: dict, tokens: torch.Tensor, eps: float,
            low: Optional[str] = None) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, V]`` in float32."""
    b, s = tokens.shape
    d = w["embed"].shape[1]
    x = w["embed"][tokens] + w["pos"][:s][None]
    causal = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    for lw in w["layers"]:
        a = lw["attn"]
        h_, k_ = a["wq"].shape[1], a["wq"].shape[2]
        h = F.layer_norm(x, (d,), lw["ln1"]["scale"], lw["ln1"]["bias"], eps)
        hf = h.reshape(b * s, d)

        def proj(wn, bn):
            y = _mm(hf, a[wn].reshape(d, h_ * k_), low) + a[bn].reshape(-1)
            return y.view(b, s, h_, k_).transpose(1, 2)      # [B, H, S, K]

        q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
        sc = _mm(q, k.transpose(-1, -2), low) / math.sqrt(k_)
        p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
        o = _mm(p, v, low).transpose(1, 2).reshape(b * s, h_ * k_)
        x = x + (_mm(o, a["wo"].reshape(h_ * k_, d), low)
                 + a["bo"]).view(b, s, d)
        m = lw["mlp"]
        h = F.layer_norm(x, (d,), lw["ln2"]["scale"], lw["ln2"]["bias"], eps)
        u = F.gelu(_mm(h.reshape(b * s, d), m["w1"], low) + m["b1"],
                   approximate="tanh")
        x = x + (_mm(u, m["w2"], low) + m["b2"]).view(b, s, d)
    x = F.layer_norm(x, (d,), w["ln_f"]["scale"], w["ln_f"]["bias"], eps)
    return _mm(x.reshape(b * s, d), w["embed"].t(), low).view(b, s, -1)


# ---------------------------------------------------------------------------
# Serving: teacher-forced logits over each prompt and its served tokens


@torch.no_grad()
def served_gaps(w: dict, requests: Sequence[tuple], eps: float,
                device, low: Optional[str] = None) -> List[List[float]]:
    """For each (prompt, served tokens): at every served position, the
    reference's largest logit minus its logit of the token served (with
    `low`, of the token the lower precision puts first instead)."""
    out = []
    for prompt, served in requests:
        seq = torch.tensor(list(prompt) + list(served[:-1]),
                           dtype=torch.long, device=device)[None]
        logits = forward(w, seq, eps)[0, len(prompt) - 1:]
        best = logits.max(dim=-1).values
        if low is None:
            pick = torch.tensor(list(served), dtype=torch.long,
                                device=device)
        else:
            pick = forward(w, seq, eps, low)[0, len(prompt) - 1:].argmax(-1)
        got = logits.gather(-1, pick[:, None])[:, 0]
        out.append((best - got).tolist())
    return out


# ---------------------------------------------------------------------------
# Training: the first steps of AdamW on the same batches


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield "/".join(str(p) for p in path), tree


def train_steps(w: dict, batches: Sequence[torch.Tensor], eps: float,
                opt: dict, accum: int, rows: int,
                low: Optional[str] = None,
                keep_rows: float = 1.0) -> Dict[str, object]:
    """AdamW steps from the float32 weights `w` (updated in place), one a
    batch ``[B, S + 1]``: the mean next-token cross-entropy over the
    batch, as `accum` microbatch means averaged, taken in blocks of
    `rows` rows; the global-norm clip; decoupled weight decay.
    `keep_rows` < 1 keeps only that share of each microbatch's rows (a
    fault: the rest left out, the mean over those kept).

    Returns the loss of each step, each leaf's gradient norm as the
    optimizer takes it (clipped) and unclipped at the first step, that
    clipped first gradient itself (``first``, leaves in host memory),
    and each leaf's change over all the steps."""
    named = list(_leaves(w))
    params = [p.requires_grad_(True) for _, p in named]
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2 = float(opt["beta1"]), float(opt["beta2"])
    lr, wd, ceps = float(opt["lr"]), float(opt["weight_decay"]), \
        float(opt["eps"])
    losses, first = [], {}
    for t, batch in enumerate(batches, start=1):
        for p in params:
            p.grad = None
        mbs = batch.shape[0] // accum
        step_loss = 0.0
        for i in range(accum):
            mb = batch[i * mbs:(i + 1) * mbs]
            mb = mb[:max(1, int(round(mbs * keep_rows)))]
            n_tok = mb.shape[0] * (mb.shape[1] - 1)
            for r in range(0, mb.shape[0], rows):
                blk = mb[r:r + rows]
                logits = forward(w, blk[:, :-1], eps, low)
                ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     blk[:, 1:].reshape(-1),
                                     reduction="sum") / (n_tok * accum)
                ce.backward()
                step_loss += float(ce.detach())
        losses.append(step_loss)
        with torch.no_grad():
            grads = [p.grad for p in params]
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(float(opt["clip_norm"]) / (gnorm + 1e-12),
                                max=1.0)
            if t == 1:
                first = {"raw": {n: float(torch.linalg.vector_norm(g))
                                 for (n, _), g in zip(named, grads)},
                         "clipped": {n: float(torch.linalg.vector_norm(
                             g * scale)) for (n, _), g in zip(named, grads)},
                         "tensors": {n: (g * scale).cpu()
                                     for (n, _), g in zip(named, grads)}}
            for p, g, m_, v_ in zip(params, grads, m, v):
                g = g * scale
                m_.mul_(b1).add_(g, alpha=1 - b1)
                v_.mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m_ / (1 - b1 ** t)
                vhat = v_ / (1 - b2 ** t)
                p.sub_(lr * (mhat / (vhat.sqrt() + ceps) + wd * p))
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p - s))
                  for (n, _), p, s in zip(named, params, start)}
    for p in params:
        p.grad = None
        p.requires_grad_(False)
    return {"loss": losses, "grad_raw": first["raw"],
            "grad": first["clipped"], "first": first["tensors"],
            "change": change}
