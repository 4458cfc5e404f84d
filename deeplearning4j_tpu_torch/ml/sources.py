"""Named data sources for the estimator API (counterpart of
`deeplearning4j_tpu.ml.sources`).

Parity: reference `dl4j-spark-ml` Spark SQL relations —
`sql/sources/mnist/MnistRelation.scala:90`, `iris/IrisRelation`,
`lfw/LfwRelation` — which expose the bundled datasets as schema-carrying
tables the pipeline API can load by name. Without Spark, the analog is a
small registry of sources that each yield a `DataSet` plus a column
schema, so `load_source("iris")` is the one-liner the Scala
`sqlContext.read.format("...iris").load()` was.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSource:
    """A named, schema-carrying dataset (reference BaseRelation role)."""

    def __init__(self, name: str, loader: Callable[..., DataSet],
                 feature_shape: tuple, num_classes: Optional[int],
                 description: str):
        self.name = name
        self._loader = loader
        self.feature_shape = feature_shape
        self.num_classes = num_classes
        self.description = description

    def load(self, **kw) -> DataSet:
        return self._loader(**kw)

    def schema(self) -> dict:
        return {"name": self.name,
                "features": list(self.feature_shape),
                "num_classes": self.num_classes,
                "description": self.description}


def _iris(**kw) -> DataSet:
    from deeplearning4j_tpu_torch.datasets.fetchers import iris_dataset

    return iris_dataset(**kw)


def _mnist(**kw) -> DataSet:
    from deeplearning4j_tpu_torch.datasets.fetchers import mnist_dataset

    return mnist_dataset(**kw)


def _lfw(**kw) -> DataSet:
    from deeplearning4j_tpu_torch.datasets.fetchers import lfw_dataset

    return lfw_dataset(**kw)


def _cifar10(**kw) -> DataSet:
    from deeplearning4j_tpu_torch.datasets.fetchers import cifar10_dataset

    return cifar10_dataset(**kw)


def _news(**kw) -> DataSet:
    from deeplearning4j_tpu_torch.nlp.news import news_dataset

    return news_dataset(**kw)


SOURCES: Dict[str, DataSource] = {
    s.name: s for s in (
        DataSource("iris", _iris, (4,), 3,
                   "150-example Iris (IrisRelation parity)"),
        DataSource("mnist", _mnist, (28, 28, 1), 10,
                   "MNIST NHWC (MnistRelation parity)"),
        DataSource("lfw", _lfw, (50, 37, 1), None,
                   "Labeled Faces in the Wild (LfwRelation parity)"),
        DataSource("cifar10", _cifar10, (32, 32, 3), 10,
                   "CIFAR-10 NHWC (BASELINE #5 dataset)"),
        DataSource("newsgroups", _news, (None,), None,
                   "TF-IDF vectorized labeled news corpus"),
    )
}


def load_source(name: str, **kw) -> DataSet:
    """`load_source("iris")` — the `read.format(...).load()` one-liner."""
    if name not in SOURCES:
        raise KeyError(f"unknown data source '{name}'; known: "
                       f"{sorted(SOURCES)}")
    return SOURCES[name].load(**kw)


def source_schema(name: str) -> dict:
    if name not in SOURCES:
        raise KeyError(f"unknown data source '{name}'; known: "
                       f"{sorted(SOURCES)}")
    return SOURCES[name].schema()


__all__ = ["DataSource", "SOURCES", "load_source", "source_schema"]
