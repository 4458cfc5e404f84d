"""Quad-tree over 2-D points (a copy of
`deeplearning4j_tpu.clustering.quadtree`: numpy, no device).

Parity: reference `clustering/quadtree/QuadTree.java` (396 LoC): cell
boundary with containsPoint, insert with subdivide, center-of-mass
maintenance, and the Barnes-Hut `computeNonEdgeForces` used by 2-D t-SNE.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

QT_NODE_CAPACITY = 1


class Cell:
    """Axis-aligned cell centered at (x, y) with half-width/height hw, hh."""

    __slots__ = ("x", "y", "hw", "hh")

    def __init__(self, x: float, y: float, hw: float, hh: float):
        self.x, self.y, self.hw, self.hh = x, y, hw, hh

    def contains_point(self, point) -> bool:
        px, py = float(point[0]), float(point[1])
        return (self.x - self.hw <= px <= self.x + self.hw
                and self.y - self.hh <= py <= self.y + self.hh)


class QuadTree:
    def __init__(self, data=None, boundary: Optional[Cell] = None):
        self.boundary = boundary
        self.size = 0
        self.cum_center = np.zeros(2)
        self.point: Optional[np.ndarray] = None
        self.index = -1
        self.children: List[Optional["QuadTree"]] = [None, None, None, None]
        self.is_leaf = True
        if data is not None:
            data = np.asarray(data, np.float64)
            if self.boundary is None:
                mins, maxs = data.min(0), data.max(0)
                center = (mins + maxs) / 2.0
                half = np.maximum((maxs - mins) / 2.0, 1e-10) + 1e-5
                self.boundary = Cell(center[0], center[1], half[0], half[1])
            for i, p in enumerate(data):
                self.insert(p, i)

    def insert(self, point, index: int = -1) -> bool:
        point = np.asarray(point, np.float64)
        if self.boundary is None:
            self.boundary = Cell(float(point[0]), float(point[1]), 1.0, 1.0)
        if not self.boundary.contains_point(point):
            return False
        self.cum_center = (self.size * self.cum_center + point) / (self.size + 1)
        self.size += 1
        if self.is_leaf and self.point is None:
            self.point = point
            self.index = index
            return True
        # Duplicate points collapse onto the existing leaf.
        if self.is_leaf and self.point is not None and np.allclose(
                self.point, point):
            return True
        if self.is_leaf:
            self._subdivide()
        for child in self.children:
            if child.insert(point, index):
                return True
        return False

    def _subdivide(self) -> None:
        b = self.boundary
        hw, hh = b.hw / 2.0, b.hh / 2.0
        coords = [(b.x - hw, b.y + hh), (b.x + hw, b.y + hh),
                  (b.x - hw, b.y - hh), (b.x + hw, b.y - hh)]
        self.children = [QuadTree(boundary=Cell(x, y, hw, hh))
                         for x, y in coords]
        self.is_leaf = False
        point, index = self.point, self.index
        self.point, self.index = None, -1
        for child in self.children:
            if child.insert(point, index):
                break

    def compute_non_edge_forces(self, point_index: int, point,
                                theta: float = 0.5):
        """Barnes-Hut repulsive force at `point`; returns (neg_force[2], sum_q).
        Mirrors QuadTree.computeNonEdgeForces: skip self-leaf, recurse when the
        cell fails the theta criterion."""
        point = np.asarray(point, np.float64)
        neg = np.zeros(2)
        sum_q = 0.0

        def rec(node: "QuadTree") -> None:
            nonlocal sum_q, neg
            if node.size == 0:
                return
            if node.is_leaf and node.index == point_index and node.size == 1:
                return
            diff = point - node.cum_center
            d2 = float(diff @ diff)
            max_width = max(node.boundary.hw, node.boundary.hh) * 2.0
            if node.is_leaf or max_width * max_width < theta * theta * d2:
                q = 1.0 / (1.0 + d2)
                mult = node.size * q
                sum_q += mult
                neg += mult * q * diff
            else:
                for child in node.children:
                    rec(child)

        rec(self)
        return neg, sum_q

    def __len__(self) -> int:
        return self.size
