"""GPT-2 weights made from ``--seed`` on the device.

One ``torch.randn`` call over every parameter on a generator of the
device, in the dtype they are used in, then each leaf scaled in place.
The tree has the layout both sides read: the port's parameter tree
(``wq``/``wk``/``wv`` ``[d, H, K]``, ``wo`` ``[H, K, d]``, the embedding
tied to the LM head), which the plain reference reads as it is.  Made
twice from one seed on one device, the values are the same, so the
reference makes its own copy after the program's state is gone.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch


def gpt2_dims(cfg: dict) -> dict:
    d = int(cfg["n_embd"])
    return {"d": d, "L": int(cfg["n_layer"]), "H": int(cfg["n_head"]),
            "K": d // int(cfg["n_head"]), "V": int(cfg["vocab_size"]),
            "P": int(cfg["n_positions"]),
            "F": int(cfg["n_inner"] or 4 * d),
            "eps": float(cfg["layer_norm_epsilon"])}


def leaf_plan(cfg: dict) -> List[Tuple[tuple, tuple, str]]:
    """(path, shape, init) of every parameter, in one fixed order."""
    g = gpt2_dims(cfg)
    d, H, K, F_ = g["d"], g["H"], g["K"], g["F"]
    plan = [(("embed",), (g["V"], d), "w"), (("pos",), (g["P"], d), "w")]
    for i in range(g["L"]):
        pre = ("layers", i)
        plan += [
            (pre + ("ln1", "scale"), (d,), "ln"),
            (pre + ("ln1", "bias"), (d,), "b"),
            (pre + ("attn", "wq"), (d, H, K), "w"),
            (pre + ("attn", "wk"), (d, H, K), "w"),
            (pre + ("attn", "wv"), (d, H, K), "w"),
            (pre + ("attn", "wo"), (H, K, d), "wres"),
            (pre + ("attn", "bq"), (H, K), "b"),
            (pre + ("attn", "bk"), (H, K), "b"),
            (pre + ("attn", "bv"), (H, K), "b"),
            (pre + ("attn", "bo"), (d,), "b"),
            (pre + ("ln2", "scale"), (d,), "ln"),
            (pre + ("ln2", "bias"), (d,), "b"),
            (pre + ("mlp", "w1"), (d, F_), "w"),
            (pre + ("mlp", "b1"), (F_,), "b"),
            (pre + ("mlp", "w2"), (F_, d), "wres"),
            (pre + ("mlp", "b2"), (d,), "b"),
        ]
    plan += [(("ln_f", "scale"), (d,), "ln"), (("ln_f", "bias"), (d,), "b")]
    return plan


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _ in leaf_plan(cfg))


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def leaves(tree: dict):
    """(path, tensor) pairs of a parameter tree, in `leaf_plan` order."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def path_name(path: tuple) -> str:
    return "/".join(str(p) for p in path)


@torch.no_grad()
def make(cfg: dict, seed: int, device, dtype: torch.dtype,
         separate: bool = False) -> dict:
    """The seeded parameter tree on `device` in `dtype`.  Leaves are views
    of one buffer, or (`separate`) tensors of their own, as a trainer
    that updates leaf by leaf wants them."""
    plan = leaf_plan(cfg)
    total = sum(math.prod(s) for _, s, _ in plan)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    std = float(cfg["initializer_range"])
    res_std = std / math.sqrt(2 * int(cfg["n_layer"]))
    tree: dict = {}
    off = 0
    for path, shape, init in plan:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if init == "w":
            leaf.mul_(std)
        elif init == "wres":
            leaf.mul_(res_std)
        elif init == "b":
            leaf.mul_(0.02)
        elif init == "ln":
            leaf.mul_(0.1).add_(1.0)
        _put(tree, path, leaf.clone() if separate else leaf)
    return tree
