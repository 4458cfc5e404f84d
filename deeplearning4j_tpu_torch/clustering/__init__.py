"""Spatial search of the port (counterpart of
`deeplearning4j_tpu.clustering`): the vantage-point tree behind the UI's
nearest-neighbors endpoints.  KMeans, the KD-, quad- and SP-trees are not
ported (ROADMAP.md, A6)."""

from deeplearning4j_tpu_torch.clustering.vptree import VPTree

__all__ = ["VPTree"]
