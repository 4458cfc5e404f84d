"""Determinism checking (counterpart of
`deeplearning4j_tpu.runtime.determinism`).

Run the same step twice from identical state and compare the results
leaf by leaf: bit-identical with ``atol == 0``.  This makes a
determinism claim checkable on a new card or library version, and it
reports a path that is not bitwise as it is: on the card, a scatter
that adds duplicate indices by atomics (`index_add_`, as Word2Vec's
steps do) sums them in whatever order the threads arrive, so its
results differ in their last bits from run to run.  Nothing here
switches on `torch.use_deterministic_algorithms`.

Each leaf is read to the host once (one copy a tensor, on any device).
With ``atol == 0`` bfloat16 and float16 leaves are compared by their raw
16-bit words, never by rounding through a wider float; the error names
the first leaf that differs and its max abs diff (``leaf``,
``max_abs_diff``).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike


class NondeterminismError(AssertionError):
    """Two runs differ; ``leaf`` is the first differing leaf's keypath
    and ``max_abs_diff`` its largest difference (None for a structural
    mismatch)."""

    def __init__(self, msg: str, leaf=None, max_abs_diff=None):
        super().__init__(msg)
        self.leaf = leaf
        self.max_abs_diff = max_abs_diff


_HALF = (torch.bfloat16, torch.float16)


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """(keypath, leaf) in ``jax.tree_util``'s order: dict keys sorted,
    lists and tuples in index order, None an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path or "/", tree


def _snapshot(tree) -> List[tuple]:
    """(keypath, words, values) a leaf, one read to the host a tensor:
    a bfloat16 / float16 leaf's raw 16-bit words and its values as
    float32; any other leaf's array, as both."""
    out = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            if t.dtype in _HALF:
                out.append((path, t.view(torch.int16).numpy(),
                            t.float().numpy()))
                continue
            a = t.numpy()
        else:
            a = np.asarray(leaf)
        out.append((path, a, a))
    return out


def check_step_determinism(make_state: Callable[[], object],
                           step: Callable[[object], object],
                           steps: int = 3,
                           atol: float = 0.0,
                           extract: Callable[[object], object] = lambda s: s
                           ) -> None:
    """Run `steps` steps twice from two fresh `make_state()` states and
    assert the `extract`ed result trees match to `atol` (0.0 =
    bit-identical).  Raises NondeterminismError naming the first
    mismatching leaf and its max abs diff."""
    def run():
        s = make_state()
        for _ in range(steps):
            s = step(s)
        return _snapshot(extract(s))

    a, b = run(), run()
    if len(a) != len(b):
        raise NondeterminismError(
            f"leaf count differs between runs: {len(a)} vs {len(b)}")
    for i, ((path, xw, x), (_, yw, y)) in enumerate(zip(a, b)):
        if x.shape != y.shape:
            raise NondeterminismError(
                f"leaf {i} ({path}): shape {x.shape} vs {y.shape}")
        if atol == 0.0:
            same = np.array_equal(xw, yw)
        else:
            same = np.allclose(x, y, atol=atol, rtol=0)
        if not same:
            diff = (float(np.max(np.abs(x.astype(np.float64)
                                        - y.astype(np.float64))))
                    if x.size else 0.0)
            raise NondeterminismError(
                f"leaf {i} ({path}): max abs diff {diff:g} after {steps} "
                f"steps (atol={atol})", leaf=path, max_abs_diff=diff)


def check_network_determinism(conf, x, y, steps: int = 3,
                              atol: float = 0.0,
                              device: DeviceLike = None) -> None:
    """Train a fresh `MultiLayerNetwork` on `device` (the card unless the
    caller asks for the CPU) twice on the same batch — the conf's seed
    drives init and dropout — and assert identical parameters."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    def step(net):
        net.fit_batch(x, y)
        return net

    check_step_determinism(
        lambda: MultiLayerNetwork(conf, device=device).init(), step,
        steps=steps, atol=atol, extract=lambda net: net.params)


__all__ = ["NondeterminismError", "check_network_determinism",
           "check_step_determinism"]
