"""Datasets (counterpart of `deeplearning4j_tpu.datasets`): `DataSet`,
the iterators, the fetchers (`datasets.fetchers`), the download-and-cache
tier they resolve through (`datasets.downloader`) and the image
vectorizer (`datasets.vectorizer`)."""

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
