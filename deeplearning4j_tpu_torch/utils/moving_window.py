"""Sliding-window views over matrices (counterpart of
`deeplearning4j_tpu.utils.moving_window`; a copy: numpy and the standard
library only).

Parity: reference `util/MovingWindowMatrix.java` — extract all (or strided)
rows x cols sub-windows of a 2-D array, optionally with rotations, used for
patch-based training. numpy stride tricks instead of copy loops.
"""

from __future__ import annotations

from typing import List

import numpy as np


class MovingWindowMatrix:
    def __init__(self, matrix, window_rows: int, window_cols: int,
                 add_rotate: bool = False):
        self.matrix = np.asarray(matrix)
        if self.matrix.ndim != 2:
            raise ValueError("expected a 2-D matrix")
        if (window_rows > self.matrix.shape[0]
                or window_cols > self.matrix.shape[1]):
            raise ValueError("window larger than matrix")
        self.rows = window_rows
        self.cols = window_cols
        self.add_rotate = add_rotate

    def windows(self, stride_rows: int = 1, stride_cols: int = 1
                ) -> List[np.ndarray]:
        view = np.lib.stride_tricks.sliding_window_view(
            self.matrix, (self.rows, self.cols))
        out = [view[i, j].copy()
               for i in range(0, view.shape[0], stride_rows)
               for j in range(0, view.shape[1], stride_cols)]
        if self.add_rotate:
            rotated = []
            for w in out:
                for k in (1, 2, 3):
                    rotated.append(np.rot90(w, k))
            out.extend(rotated)
        return out
