"""Datasets (counterpart of `deeplearning4j_tpu.datasets`): `DataSet`,
the iterators and the fetchers (`datasets.fetchers`).  The downloader and
`vectorizer` are ROADMAP.md queue A6."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    ArrayDataSetIterator,
    BucketedSequenceIterator,
    DataSetIterator,
    MultipleEpochsIterator,
    PrefetchDataSetIterator,
    ReconstructionDataSetIterator,
    SamplingDataSetIterator,
)

__all__ = [
    "DataSet", "DataSetIterator", "ArrayDataSetIterator",
    "MultipleEpochsIterator", "SamplingDataSetIterator",
    "BucketedSequenceIterator", "PrefetchDataSetIterator",
    "ReconstructionDataSetIterator",
]
