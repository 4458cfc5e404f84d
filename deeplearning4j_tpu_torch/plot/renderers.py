"""Weight/activation renderers (counterpart of
`deeplearning4j_tpu.plot.renderers`).

Parity: reference `plot/FilterRenderer.java` (tiles first-layer weight
columns into a filter-grid image) and `plot/NeuralNetPlotter.java` (weight/
gradient/activation histograms; the reference shells out to bundled Python
matplotlib scripts under src/main/resources/scripts/ — here matplotlib is
invoked directly, gated so headless/minimal installs degrade to raw-array
output: where matplotlib is absent a renderer writes the grid as ``.npy``,
as the JAX package's does).  Weights and activations may be tensors on the
card in bfloat16; they are read to the host as float32 (`host_array`).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch


def host_array(x) -> np.ndarray:
    """`x` as a host numpy array; a tensor (any device, bfloat16 too) is
    read as float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _tile_filters(w: np.ndarray, shape: Optional[tuple] = None,
                  pad: int = 1) -> np.ndarray:
    """[n_in, n_out] weights -> one [H, W] grid image, one tile per output
    unit (FilterRenderer.renderFilters semantics)."""
    w = host_array(w)
    if w.ndim == 4:  # conv filters [kh, kw, in, out] -> flatten in
        kh, kw, cin, cout = w.shape
        w = w.reshape(kh * kw * cin, cout)
        shape = shape or (kh, kw * cin)
    n_in, n_out = w.shape
    if shape is None:
        side = int(math.sqrt(n_in))
        if side * side != n_in:
            shape = (1, n_in)
        else:
            shape = (side, side)
    th, tw = shape
    cols = int(math.ceil(math.sqrt(n_out)))
    rows = int(math.ceil(n_out / cols))
    grid = np.zeros((rows * (th + pad) - pad, cols * (tw + pad) - pad))
    for k in range(n_out):
        tile = w[:, k].reshape(th, tw)
        lo, hi = tile.min(), tile.max()
        tile = (tile - lo) / (hi - lo) if hi > lo else tile * 0
        r, c = divmod(k, cols)
        grid[r * (th + pad):r * (th + pad) + th,
             c * (tw + pad):c * (tw + pad) + tw] = tile
    return grid


class FilterRenderer:
    def render(self, w, path: str, shape: Optional[tuple] = None) -> np.ndarray:
        """Render weight columns as a filter grid; writes PNG if matplotlib
        is present, always returns the grid array."""
        grid = _tile_filters(host_array(w), shape)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(6, 6))
            ax.imshow(grid, cmap="gray", interpolation="nearest")
            ax.axis("off")
            fig.savefig(path, bbox_inches="tight", dpi=120)
            plt.close(fig)
        except Exception:  # noqa: BLE001 — headless/no-mpl -> .npy dump
            np.save(os.path.splitext(path)[0] + ".npy", grid)
        return grid


class NeuralNetPlotter:
    """Histogram plots of params/gradients/activations per layer."""

    def plot_network_gradient(self, params: Dict, grads: Dict,
                              out_dir: str) -> list:
        os.makedirs(out_dir, exist_ok=True)
        written = []
        for name, tree in (("weights", params), ("gradients", grads)):
            flat = self._flatten(tree)
            path = os.path.join(out_dir, f"{name}.png")
            if self._hist(flat, path, title=name):
                written.append(path)
        return written

    def plot_activations(self, activations, path: str) -> None:
        FilterRenderer().render(host_array(activations).T, path)

    @staticmethod
    def _flatten(tree) -> Dict[str, np.ndarray]:
        out = {}

        def rec(prefix, node):
            if isinstance(node, dict):
                for k, v in node.items():
                    rec(f"{prefix}/{k}" if prefix else str(k), v)
            elif isinstance(node, (list, tuple)):
                for k, v in enumerate(node):
                    rec(f"{prefix}/{k}" if prefix else str(k), v)
            else:
                out[prefix] = host_array(node).ravel()

        rec("", tree)
        return out

    @staticmethod
    def _hist(flat: Dict[str, np.ndarray], path: str, title: str) -> bool:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:  # noqa: BLE001 — no matplotlib -> skip plots
            return False
        n = max(len(flat), 1)
        cols = min(n, 3)
        rows = int(math.ceil(n / cols))
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                                 squeeze=False)
        for ax in axes.ravel():
            ax.axis("off")
        for ax, (name, vals) in zip(axes.ravel(), sorted(flat.items())):
            ax.axis("on")
            ax.hist(vals, bins=50)
            ax.set_title(name, fontsize=8)
        fig.suptitle(title)
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return True
