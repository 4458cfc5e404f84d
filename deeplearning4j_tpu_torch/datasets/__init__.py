"""Datasets (counterpart of `deeplearning4j_tpu.datasets`): `DataSet` so
far; the iterators and fetchers are ROADMAP.md queue A3b."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

__all__ = ["DataSet"]
