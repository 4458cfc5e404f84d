"""Update aggregators (counterpart of
`deeplearning4j_tpu.scaleout.aggregators`; numpy on the host, as the JAX
package computes them).

Parity: reference `scaleout/aggregator/INDArrayAggregator.java` (sum then
divide — parameter averaging) and the delta-folding the Spark word2vec
driver does with `Word2VecChange` (SURVEY §3.4).

The JAX aggregators walk their trees with ``jax.tree_util``, whose
containers include dicts (keys sorted), lists and tuples, and whose
``None`` is an empty subtree; `tree_map_containers` walks those the same
way (`tree.map_tree` keeps tuples as leaves, which its callers rely on).
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np

from deeplearning4j_tpu_torch.scaleout.api import JobAggregator


def tree_map_containers(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over trees of one structure,
    as ``jax.tree_util.tree_map`` walks them: dicts (output keys sorted),
    lists and tuples are containers, ``None`` is an empty subtree; a
    structure that differs raises ValueError."""
    def same(kind, n=None):
        for r in rest:
            if type(r) is not kind or (n is not None and len(r) != n):
                raise ValueError(f"tree structures differ: {type(tree)} "
                                 f"against {type(r)}")

    if tree is None:
        same(type(None))
        return None
    if isinstance(tree, dict):
        same(type(tree))
        for r in rest:
            if set(r) != set(tree):
                raise ValueError(f"tree structures differ: dict keys "
                                 f"{sorted(tree)} against {sorted(r)}")
        return {k: tree_map_containers(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        same(type(tree), len(tree))
        out = [tree_map_containers(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def _tree_add(a, b):
    return tree_map_containers(lambda x, y: np.asarray(x) + np.asarray(y),
                               a, b)


class ParameterAveragingAggregator(JobAggregator):
    """Mean over worker parameter trees — the "iterative reduce" master
    computation, identical math to `MultiLayerNetwork.merge()`."""

    def __init__(self):
        self._sum: Any = None
        self._count = 0

    def accumulate(self, result: Any) -> None:
        self._sum = result if self._sum is None else _tree_add(
            self._sum, result)
        self._count += 1

    def aggregate(self) -> Any:
        if self._count == 0:
            return None
        return tree_map_containers(lambda s: np.asarray(s) / self._count,
                                   self._sum)

    def reset(self) -> None:
        self._sum, self._count = None, 0


class DeltaSumAggregator(JobAggregator):
    """Sum of sparse/dense deltas (distributed word2vec/glove: every worker's
    embedding delta is applied, not averaged)."""

    def __init__(self):
        self._deltas: List[Any] = []

    def accumulate(self, result: Any) -> None:
        self._deltas.append(result)

    def aggregate(self) -> Any:
        if not self._deltas:
            return None
        total = self._deltas[0]
        for d in self._deltas[1:]:
            total = _tree_add(total, d)
        return total

    def reset(self) -> None:
        self._deltas = []
