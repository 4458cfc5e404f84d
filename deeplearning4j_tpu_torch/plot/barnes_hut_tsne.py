"""Barnes-Hut t-SNE (O(n log n)); a copy of
`deeplearning4j_tpu.plot.barnes_hut_tsne`: numpy, no device.

Parity: reference `plot/BarnesHutTsne.java:62` — sparse input affinities
from k-nearest neighbors (the reference builds them with a VPTree) and a
per-iteration SpTree (`BarnesHutTsne.java:629`) approximating the repulsive
term with the theta criterion. Host-side: the tree phase is pointer-chasing;
the exact variant (`tsne.py`) is the device path for sizes where O(n^2)
fits.  The layout is drawn from numpy ``default_rng(seed)``, so an
embedding is bitwise the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.clustering.sptree import SpTree

EPS = 1e-12


def _knn_affinities(x: np.ndarray, perplexity: float, k: int):
    """Sparse row-CSR conditional affinities over the k nearest neighbors
    (mirrors computeGaussianPerplexity(D, perplexity, k))."""
    n = len(x)
    d2 = (np.sum(x * x, 1)[:, None] + np.sum(x * x, 1)[None, :]
          - 2.0 * x @ x.T)
    np.fill_diagonal(d2, np.inf)
    nbrs = np.argsort(d2, axis=1)[:, :k]                    # [n,k]
    vals = np.zeros((n, k))
    log_u = np.log(perplexity)
    for i in range(n):
        dd = d2[i, nbrs[i]]
        beta, lo, hi = 1.0, -np.inf, np.inf
        for _ in range(50):
            p = np.exp(-dd * beta)
            sum_p = max(p.sum(), EPS)
            h = np.log(sum_p) + beta * float((dd * p).sum()) / sum_p
            if abs(h - log_u) < 1e-5:
                break
            if h > log_u:
                lo = beta
                beta = beta * 2.0 if np.isinf(hi) else (beta + hi) / 2.0
            else:
                hi = beta
                beta = beta / 2.0 if np.isinf(lo) else (beta + lo) / 2.0
        vals[i] = p / max(p.sum(), EPS)
    # symmetrize into CSR: P = (P + P^T) / 2n over the union sparsity
    from collections import defaultdict
    sym: dict = defaultdict(float)
    for i in range(n):
        for jj, j in enumerate(nbrs[i]):
            sym[(i, int(j))] += vals[i, jj] / 2.0
            sym[(int(j), i)] += vals[i, jj] / 2.0
    rows = [[] for _ in range(n)]
    for (i, j), v in sym.items():
        rows[i].append((j, v))
    total = sum(v for r in rows for _, v in r)
    row_p = np.zeros(n + 1, np.int64)
    col_p, val_p = [], []
    for i in range(n):
        rows[i].sort()
        row_p[i + 1] = row_p[i] + len(rows[i])
        for j, v in rows[i]:
            col_p.append(j)
            val_p.append(v / max(total, EPS))
    return row_p, np.asarray(col_p, np.int64), np.asarray(val_p)


class BarnesHutTsne:
    """theta=0 degenerates toward exact; theta~0.5 is the usual tradeoff."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, learning_rate: float = 200.0,
                 n_iter: int = 1000, stop_lying_iter: int = 250,
                 exaggeration: float = 12.0, seed: int = 0):
        self.n_components = n_components
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.stop_lying_iter = stop_lying_iter
        self.exaggeration = exaggeration
        self.seed = seed
        self.y: Optional[np.ndarray] = None

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = len(x)
        k = min(int(3 * self.perplexity), n - 1)
        row_p, col_p, val_p = _knn_affinities(x, self.perplexity, k)

        rng = np.random.default_rng(self.seed)
        y = 1e-4 * rng.standard_normal((n, self.n_components))
        dy = np.zeros_like(y)
        gains = np.ones_like(y)
        momentum, final_momentum = 0.5, 0.8

        for it in range(self.n_iter):
            exag = self.exaggeration if it < self.stop_lying_iter else 1.0
            tree = SpTree(y)
            pos = tree.compute_edge_forces(row_p, col_p, val_p * exag)
            neg = np.zeros_like(y)
            sum_q = 0.0
            for i in range(n):
                f, q = tree.compute_non_edge_forces(i, self.theta)
                neg[i] = f
                sum_q += q
            grad = pos - neg / max(sum_q, EPS)
            mom = momentum if it < 250 else final_momentum
            same = np.sign(grad) == np.sign(dy)
            gains = np.maximum(np.where(same, gains * 0.8, gains + 0.2), 0.01)
            dy = mom * dy - self.learning_rate * gains * grad
            y = y + dy
            y -= y.mean(0)
        self.y = y
        return y

    calculate = fit_transform
