"""Estimators, transformers, pipelines (counterpart of
`deeplearning4j_tpu.ml.pipeline`).

Parity: reference dl4j-spark-ml estimators (SURVEY §2.3 dl4j-spark-ml row).
Convention: fit(X[, y]) -> self, predict/transform on arrays, get_params/
set_params for config introspection — drop-in friendly next to sklearn
without importing it.  The estimators train the port's
`MultiLayerNetwork` on `device` (the card unless the caller asks for the
CPU).  Features stay float32 numpy on the host, whatever the network's
input dtype (numpy has no bfloat16): the network casts them to its
compute dtype on the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.fetchers import one_hot
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.device import DeviceLike
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration


class _BaseEstimator:
    def get_params(self) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def set_params(self, **kwargs) -> "_BaseEstimator":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown param {k!r}")
            setattr(self, k, v)
        return self


class StandardScaler(_BaseEstimator):
    """Zero-mean/unit-variance feature scaling (the preprocessing the
    reference bakes into DataSet.normalizeZeroMeanZeroUnitVariance)."""

    def __init__(self):
        self.mean_: Optional[np.ndarray] = None
        self.std_: Optional[np.ndarray] = None

    def fit(self, x, y=None) -> "StandardScaler":
        x = np.asarray(x, np.float32)
        self.mean_ = x.mean(axis=0)
        self.std_ = x.std(axis=0)
        self.std_[self.std_ == 0] = 1.0
        return self

    def transform(self, x) -> np.ndarray:
        if self.mean_ is None:
            raise ValueError("fit() first")
        return (np.asarray(x, np.float32) - self.mean_) / self.std_

    def fit_transform(self, x, y=None) -> np.ndarray:
        return self.fit(x, y).transform(x)


class NetworkClassifier(_BaseEstimator):
    """MultiLayerNetwork as a classifier estimator, trained on `device`.

    ``distributed=True`` trains through `DataParallelTrainer`, the
    replacement for the reference's ParameterAveragingTrainingStrategy
    (TrainingStrategy.scala:39-81), over every visible card, or over one
    host shard when ``device="cpu"``.
    """

    def __init__(self, conf: MultiLayerConfiguration, epochs: int = 10,
                 batch_size: int = 32, distributed: bool = False,
                 device: DeviceLike = None):
        self.conf = conf
        self.epochs = epochs
        self.batch_size = batch_size
        self.distributed = distributed
        self.device = device
        self._net: Optional[MultiLayerNetwork] = None

    @property
    def network(self) -> MultiLayerNetwork:
        if self._net is None:
            raise ValueError("fit() first")
        return self._net

    def fit(self, x, y) -> "NetworkClassifier":
        x = np.asarray(x, np.float32)
        y = np.asarray(y)
        if y.ndim == 1:
            n_out = self.conf.layers[-1].n_out
            y = one_hot(y.astype(int), n_out)
        self._net = MultiLayerNetwork(self.conf, device=self.device).init()
        if self.distributed:
            from deeplearning4j_tpu_torch.parallel import (
                DataParallelTrainer,
                make_mesh,
            )

            mesh = (make_mesh(devices=[self._net.device])
                    if self._net.device.type == "cpu" else None)
            trainer = DataParallelTrainer(self._net, mesh=mesh)
            n = trainer.n_devices
            batch = max(self.batch_size // n * n, n)
            for _ in range(self.epochs):
                for s in range(0, len(x) - batch + 1, batch):
                    trainer.fit_batch(x[s:s + batch], y[s:s + batch])
            trainer.finalize()
            return self
        it = ArrayDataSetIterator(x, y, batch=self.batch_size)
        self._net.fit(it, epochs=self.epochs)
        return self

    def predict_proba(self, x) -> np.ndarray:
        return np.asarray(self.network.label_probabilities(
            np.asarray(x, np.float32)))

    def predict(self, x) -> np.ndarray:
        return self.predict_proba(x).argmax(axis=1)

    def score(self, x, y) -> float:
        y = np.asarray(y)
        if y.ndim == 2:
            y = y.argmax(axis=1)
        return float((self.predict(x) == y).mean())


class NetworkReconstruction(_BaseEstimator):
    """Unsupervised feature extraction: pretrain, then transform() emits a
    chosen layer's activations (MultiLayerNetworkReconstruction.scala —
    reconstruction via the pretrained hidden representation)."""

    def __init__(self, conf: MultiLayerConfiguration, epochs: int = 10,
                 batch_size: int = 32, layer: int = -1,
                 device: DeviceLike = None):
        self.conf = conf
        self.epochs = epochs
        self.batch_size = batch_size
        self.layer = layer
        self.device = device
        self._net: Optional[MultiLayerNetwork] = None

    def fit(self, x, y=None) -> "NetworkReconstruction":
        x = np.asarray(x, np.float32)
        self._net = MultiLayerNetwork(self.conf, device=self.device).init()
        dummy = np.zeros((len(x), 1), np.float32)
        it = ArrayDataSetIterator(x, dummy, batch=self.batch_size)
        self._net.pretrain(it, epochs=self.epochs)
        return self

    def transform(self, x) -> np.ndarray:
        if self._net is None:
            raise ValueError("fit() first")
        acts = self._net.feed_forward(
            np.asarray(x, np.float32))
        return acts[self.layer].detach().float().cpu().numpy()

    def fit_transform(self, x, y=None) -> np.ndarray:
        return self.fit(x).transform(x)


class Pipeline(_BaseEstimator):
    """Chain of (name, transformer/estimator) steps, sklearn-shaped:
    intermediate steps need fit/transform, the last needs fit and either
    predict or transform."""

    def __init__(self, steps: Sequence[Tuple[str, object]]):
        self.steps: List[Tuple[str, object]] = list(steps)

    def _validate(self):
        names = [n for n, _ in self.steps]
        if len(set(names)) != len(names):
            raise ValueError("duplicate step names")

    def fit(self, x, y=None) -> "Pipeline":
        self._validate()
        for name, step in self.steps[:-1]:
            x = step.fit_transform(x, y) if hasattr(step, "fit_transform") \
                else step.fit(x, y).transform(x)
        last = self.steps[-1][1]
        last.fit(x, y) if y is not None else last.fit(x)
        return self

    def _pre(self, x):
        for _, step in self.steps[:-1]:
            x = step.transform(x)
        return x

    def predict(self, x) -> np.ndarray:
        return self.steps[-1][1].predict(self._pre(x))

    def predict_proba(self, x) -> np.ndarray:
        return self.steps[-1][1].predict_proba(self._pre(x))

    def transform(self, x) -> np.ndarray:
        return self.steps[-1][1].transform(self._pre(x))

    def score(self, x, y) -> float:
        return self.steps[-1][1].score(self._pre(x), y)


__all__ = ["NetworkClassifier", "NetworkReconstruction", "Pipeline",
           "StandardScaler"]
