"""Vantage-point tree for metric-space nearest neighbors (a copy of
`deeplearning4j_tpu.clustering.vptree`: numpy and `heapq`, no device).

Parity: reference `clustering/vptree/VPTree.java` (345 LoC) — the structure
behind the UI nearest-neighbors resource
(`ui/nearestneighbors/NearestNeighborsResource.java`) and word2vec
`wordsNearest` serving. Supports euclidean and cosine ("dot") distances like
the reference's distance-function switch.
"""

from __future__ import annotations

import heapq
import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def _euclidean(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b))


def _cosine_distance(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 1.0
    return float(1.0 - np.dot(a, b) / (na * nb))


DISTANCES: dict = {"euclidean": _euclidean, "cosine": _cosine_distance,
                   "dot": _cosine_distance}


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


class VPTree:
    def __init__(self, items, labels: Optional[Sequence] = None,
                 distance: str = "euclidean", seed: int = 0):
        self.items = np.asarray(items, np.float64)
        self.labels = list(labels) if labels is not None else list(
            range(len(self.items)))
        if len(self.labels) != len(self.items):
            raise ValueError("labels/items length mismatch")
        self._dist: Callable = DISTANCES[distance]
        self._rng = random.Random(seed)
        self.root = self._build(list(range(len(self.items))))

    def _build(self, idx: List[int]) -> Optional[_VPNode]:
        if not idx:
            return None
        vp = idx[self._rng.randrange(len(idx))]
        rest = [i for i in idx if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        dists = [self._dist(self.items[vp], self.items[i]) for i in rest]
        median = float(np.median(dists))
        node.threshold = median
        inside = [i for i, d in zip(rest, dists) if d <= median]
        outside = [i for i, d in zip(rest, dists) if d > median]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    def knn(self, query, k: int) -> List[Tuple[float, object]]:
        """k nearest (distance, label), closest first."""
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap by -dist

        def tau() -> float:
            return -heap[0][0] if len(heap) >= k else float("inf")

        def rec(node: Optional[_VPNode]) -> None:
            if node is None:
                return
            d = self._dist(query, self.items[node.index])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            if node.inside is None and node.outside is None:
                return
            if d <= node.threshold:
                rec(node.inside)
                if d + tau() >= node.threshold:
                    rec(node.outside)
            else:
                rec(node.outside)
                if d - tau() <= node.threshold:
                    rec(node.inside)

        rec(self.root)
        return [(-d, self.labels[i])
                for d, i in sorted(heap, key=lambda t: -t[0])]

    def words_nearest(self, query, n: int) -> List[object]:
        """Labels only — the UI nearest-neighbors serving shape."""
        return [label for _, label in self.knn(query, n)]
