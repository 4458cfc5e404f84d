"""KD-tree for exact nearest-neighbor queries (a copy of
`deeplearning4j_tpu.clustering.kdtree`: numpy and `heapq`, no device).

Parity: reference `clustering/kdtree/KDTree.java` (370 LoC: insert, nn,
knn, range query over axis-aligned hyper-rectangles). Host-side structure
for query serving.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("point", "index", "left", "right")

    def __init__(self, point: np.ndarray, index: int):
        self.point = point
        self.index = index
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class KDTree:
    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_Node] = None
        self.size = 0

    def insert(self, point) -> None:
        point = np.asarray(point, np.float64)
        if point.shape != (self.dims,):
            raise ValueError(f"expected {self.dims}-d point, got {point.shape}")
        node = _Node(point, self.size)
        self.size += 1
        if self.root is None:
            self.root = node
            return
        cur, depth = self.root, 0
        while True:
            axis = depth % self.dims
            if point[axis] < cur.point[axis]:
                if cur.left is None:
                    cur.left = node
                    return
                cur = cur.left
            else:
                if cur.right is None:
                    cur.right = node
                    return
                cur = cur.right
            depth += 1

    @classmethod
    def build(cls, points) -> "KDTree":
        """Balanced build by median split (the reference only has incremental
        insert; balanced build is the better default for batch data)."""
        points = np.asarray(points, np.float64)
        tree = cls(points.shape[1])
        indices = np.arange(len(points))

        def rec(idx: np.ndarray, depth: int) -> Optional[_Node]:
            if len(idx) == 0:
                return None
            axis = depth % tree.dims
            order = np.argsort(points[idx, axis], kind="stable")
            idx = idx[order]
            mid = len(idx) // 2
            node = _Node(points[idx[mid]], int(idx[mid]))
            node.left = rec(idx[:mid], depth + 1)
            node.right = rec(idx[mid + 1:], depth + 1)
            return node

        tree.root = rec(indices, 0)
        tree.size = len(points)
        return tree

    def nn(self, point) -> Tuple[float, Optional[np.ndarray], int]:
        """(distance, point, index) of the nearest neighbor."""
        res = self.knn(point, 1)
        if not res:
            return float("inf"), None, -1
        return res[0]

    def knn(self, point, k: int) -> List[Tuple[float, np.ndarray, int]]:
        """k nearest (distance, point, index), closest first."""
        point = np.asarray(point, np.float64)
        heap: List[Tuple[float, int, np.ndarray]] = []  # max-heap by -dist

        def rec(node: Optional[_Node], depth: int) -> None:
            if node is None:
                return
            dist = float(np.linalg.norm(node.point - point))
            if len(heap) < k:
                heapq.heappush(heap, (-dist, node.index, node.point))
            elif dist < -heap[0][0]:
                heapq.heapreplace(heap, (-dist, node.index, node.point))
            axis = depth % self.dims
            diff = point[axis] - node.point[axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right,
                                                                  node.left)
            rec(near, depth + 1)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                rec(far, depth + 1)

        rec(self.root, 0)
        return [(-d, p, i) for d, i, p in sorted(heap, key=lambda t: -t[0])]

    def range(self, lower, upper) -> List[Tuple[np.ndarray, int]]:
        """All (point, index) inside the axis-aligned box [lower, upper]."""
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        out: List[Tuple[np.ndarray, int]] = []

        def rec(node: Optional[_Node], depth: int) -> None:
            if node is None:
                return
            if np.all(node.point >= lower) and np.all(node.point <= upper):
                out.append((node.point, node.index))
            axis = depth % self.dims
            if node.point[axis] >= lower[axis]:
                rec(node.left, depth + 1)
            if node.point[axis] <= upper[axis]:
                rec(node.right, depth + 1)

        rec(self.root, 0)
        return out

    def __len__(self) -> int:
        return self.size
