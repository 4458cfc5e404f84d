"""SpTree: n-dimensional Barnes-Hut space-partitioning tree (a copy of
`deeplearning4j_tpu.clustering.sptree`: numpy, no device).

Parity: reference `clustering/sptree/SpTree.java` (363 LoC), the
approximation structure behind `plot/BarnesHutTsne.java:629`. Generalizes
QuadTree to 2^d children per node; maintains center-of-mass per cell;
`compute_non_edge_forces` approximates the t-SNE repulsive term and
`compute_edge_forces` the attractive term from sparse row-CSR affinities.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SpTree:
    def __init__(self, data, center=None, half_width=None):
        data = np.asarray(data, np.float64)
        self.data = data
        self.d = data.shape[1]
        self.n_children = 2 ** self.d
        if center is None:
            mins, maxs = data.min(0), data.max(0)
            center = (mins + maxs) / 2.0
            half_width = np.maximum((maxs - mins) / 2.0, 1e-10) + 1e-5
        self.center = np.asarray(center, np.float64)
        self.half_width = np.asarray(half_width, np.float64)
        self.size = 0
        self.cum_center = np.zeros(self.d)
        self.index = -1          # leaf payload: row into data
        self.children: Optional[list] = None  # None while leaf
        for i in range(len(data)):
            self._insert(i)

    # -- construction -------------------------------------------------------

    @classmethod
    def _blank(cls, data, center, half_width) -> "SpTree":
        node = object.__new__(cls)
        node.data = data
        node.d = data.shape[1]
        node.n_children = 2 ** node.d
        node.center = center
        node.half_width = half_width
        node.size = 0
        node.cum_center = np.zeros(node.d)
        node.index = -1
        node.children = None
        return node

    def _child_for(self, point: np.ndarray) -> int:
        code = 0
        for axis in range(self.d):
            if point[axis] > self.center[axis]:
                code |= 1 << axis
        return code

    def _insert_into_child(self, i: int) -> None:
        code = self._child_for(self.data[i])
        if self.children[code] is None:
            offset = np.array([(1 if code >> a & 1 else -1)
                               for a in range(self.d)], np.float64)
            hw = self.half_width / 2.0
            self.children[code] = SpTree._blank(
                self.data, self.center + offset * hw, hw)
        self.children[code]._insert(i)

    def _insert(self, i: int) -> None:
        point = self.data[i]
        self.cum_center = (self.size * self.cum_center + point) / (self.size + 1)
        self.size += 1
        if self.children is None:
            if self.index < 0:
                self.index = i
                return
            # Duplicate (or cell too small to split further) collapses onto
            # the existing leaf, as in SpTree.java's duplicate check.
            if (np.allclose(self.data[self.index], point)
                    or float(np.max(self.half_width)) < 1e-12):
                return
            old = self.index
            self.index = -1
            self.children = [None] * self.n_children
            self._insert_into_child(old)   # old was already counted here
            self._insert_into_child(i)
            return
        self._insert_into_child(i)

    # -- Barnes-Hut forces --------------------------------------------------

    def compute_non_edge_forces(self, point_index: int, theta: float = 0.5):
        """(neg_force[d], sum_q) — approximate t-SNE repulsion at data[i]."""
        point = self.data[point_index]
        neg = np.zeros(self.d)
        sum_q = 0.0
        max_width0 = float(np.max(self.half_width)) * 2.0

        stack = [(self, max_width0)]
        while stack:
            node, max_width = stack.pop()
            if node is None or node.size == 0:
                continue
            if node.children is None and node.index == point_index:
                continue
            diff = point - node.cum_center
            d2 = float(diff @ diff)
            if node.children is None or max_width * max_width < (
                    theta * theta * d2):
                q = 1.0 / (1.0 + d2)
                mult = node.size * q
                # Leaf holding only the query's duplicates contributes its
                # non-query copies; a leaf IS single-point here by design.
                sum_q += mult
                neg += mult * q * diff
            else:
                for child in node.children:
                    if child is not None:
                        stack.append((child, max_width / 2.0))
        return neg, sum_q

    def compute_edge_forces(self, row_p, col_p, val_p) -> np.ndarray:
        """Attractive forces from sparse CSR affinities (rows=points).
        Mirrors SpTree.computeEdgeForces."""
        n = len(row_p) - 1
        pos = np.zeros((n, self.d))
        for i in range(n):
            for ofs in range(row_p[i], row_p[i + 1]):
                j = col_p[ofs]
                diff = self.data[i] - self.data[j]
                q = 1.0 / (1.0 + float(diff @ diff))
                pos[i] += val_p[ofs] * q * diff
        return pos

    def __len__(self) -> int:
        return self.size
