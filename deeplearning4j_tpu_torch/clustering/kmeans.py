"""KMeans clustering on the device (counterpart of
`deeplearning4j_tpu.clustering.kmeans`).

Parity: reference `clustering/kmeans/KMeansClustering.java:31` driven by
`BaseClusteringAlgorithm.java` (init random centres -> iterate
assignment / update -> stop at a fixed iteration count or when the
centres move less than a threshold).  The whole assignment is one [n, k]
distance matrix in the expanded-norm form (one matmul), as in the JAX
package; no Pallas kernel there, so plain PyTorch ops here.

The JAX package's `lax.while_loop` is a plain loop: one host read a
sweep for the ``shift > tol`` test (`kmeans_lloyd` counts them).  The
initial centres are ``k`` distinct points drawn by a seeded CPU
`torch.Generator` (the card and the CPU draw the same ones; JAX's
threefry draw cannot be reproduced), and the Lloyd loop takes initial
centres, so a caller can start it from any draw, JAX's included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.plot.tsne import _as_f32


def _pairwise_sq_dists(points: torch.Tensor,
                       centers: torch.Tensor) -> torch.Tensor:
    """[n, k] squared euclidean distances via the expanded-norm matmul
    form."""
    pn = torch.sum(points * points, dim=1, keepdim=True)        # [n, 1]
    cn = torch.sum(centers * centers, dim=1)[None, :]           # [1, k]
    cross = points @ centers.T                                  # [n, k]
    return pn + cn - 2.0 * cross


def initial_indices(n: int, k: int, seed: int) -> torch.Tensor:
    """k distinct point indices from a CPU generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:k]


def kmeans_lloyd(points: torch.Tensor, init_centers: torch.Tensor,
                 max_iter: int = 100, tol: float = 1e-4
                 ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Lloyd sweeps from `init_centers` while ``it < max_iter`` and the
    largest centre shift exceeds `tol`.  Returns (centres [k, d],
    assignments [n], n_iter, host reads).  An empty cluster keeps its
    centre (the reference's "no points -> centre unchanged")."""
    k = init_centers.shape[0]

    def assign(centers):
        return torch.argmin(_pairwise_sq_dists(points, centers), dim=1)

    centers, shift, it, reads = init_centers, float("inf"), 0, 0
    while it < max_iter and shift > tol:
        onehot = torch.nn.functional.one_hot(assign(centers), k).to(
            points.dtype)                                        # [n, k]
        counts = torch.sum(onehot, dim=0)                        # [k]
        means = (onehot.T @ points) / torch.clamp(counts, min=1.0)[:, None]
        new_centers = torch.where(counts[:, None] > 0, means, centers)
        shift = float(torch.max(torch.linalg.norm(new_centers - centers,
                                                  dim=1)))
        reads += 1
        centers, it = new_centers, it + 1
    return centers, assign(centers), it, reads


def kmeans_fit(points, k: int, seed: int = 0, max_iter: int = 100,
               tol: float = 1e-4, device: DeviceLike = None):
    """Lloyd iterations from `k` seeded distinct points.  Returns
    (centres [k, d], assignments [n], n_iter) as tensors on the points'
    device and an int."""
    points = _as_f32(points, device)
    init = points[initial_indices(points.shape[0], k, seed).to(
        points.device)]
    centers, assignments, n_iter, _ = kmeans_lloyd(points, init, max_iter,
                                                   tol)
    return centers, assignments, n_iter


class KMeansClustering:
    """Object surface mirroring `KMeansClustering.setup(k, maxIter,
    dist)`; clusters on `device` (the card unless ``device="cpu"``)."""

    def __init__(self, k: int, max_iter: int = 100, tol: float = 1e-4,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.k = k
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed
        self.centers: Optional[np.ndarray] = None
        self.n_iter = 0
        self.host_reads = 0

    @classmethod
    def setup(cls, k: int, max_iter: int = 100, seed: int = 0,
              device: DeviceLike = None) -> "KMeansClustering":
        return cls(k=k, max_iter=max_iter, seed=seed, device=device)

    def fit(self, points) -> np.ndarray:
        """Cluster points [n, d]; returns assignments [n]."""
        pts = _as_f32(points, self.device).to(self.device)
        init = pts[initial_indices(pts.shape[0], self.k, self.seed).to(
            self.device)]
        centers, assignments, self.n_iter, self.host_reads = kmeans_lloyd(
            pts, init, self.max_iter, self.tol)
        self.centers = centers.cpu().numpy()
        return assignments.cpu().numpy()

    def predict(self, points) -> np.ndarray:
        if self.centers is None:
            raise ValueError("fit() first")
        d = _pairwise_sq_dists(_as_f32(points, self.device).to(
            self.device), torch.as_tensor(self.centers, device=self.device))
        return torch.argmin(d, dim=1).cpu().numpy()
