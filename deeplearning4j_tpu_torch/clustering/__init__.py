"""Clustering and spatial search of the port (counterpart of
`deeplearning4j_tpu.clustering`).

Parity: reference `deeplearning4j-core/.../clustering/` — KMeans
(`kmeans/KMeansClustering.java:31`), KDTree, VPTree (behind the UI's
nearest-neighbors endpoints), QuadTree and SpTree (Barnes-Hut).  KMeans
is the FLOP-heavy part (distance matrices) and runs on the device (the
card unless ``device="cpu"``); the trees are pointer-chasing host
structures (numpy copies of the JAX package's).
"""

from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.kmeans import (
    KMeansClustering,
    kmeans_fit,
    kmeans_lloyd,
)
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree
from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree

__all__ = ["KMeansClustering", "kmeans_fit", "kmeans_lloyd", "KDTree",
           "VPTree", "QuadTree", "SpTree"]
