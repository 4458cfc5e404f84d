"""DataSet: a (features, labels[, mask]) pair with the reference's utility
surface (reference: ND4J `DataSet` + `SplitTestAndTrain`, consumed throughout
deeplearning4j-core/datasets); counterpart of
`deeplearning4j_tpu.datasets.dataset`, unchanged."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    mask: Optional[np.ndarray] = None  # [batch, time] for sequence data

    def __post_init__(self):
        self.features = np.asarray(self.features)
        self.labels = np.asarray(self.labels)

    def num_examples(self) -> int:
        return self.features.shape[0]

    def split_test_and_train(self, n_train: int, seed: Optional[int] = None
                             ) -> Tuple["DataSet", "DataSet"]:
        """Reference SplitTestAndTrain semantics: shuffle then split."""
        idx = np.arange(self.num_examples())
        if seed is not None:
            np.random.default_rng(seed).shuffle(idx)
        tr, te = idx[:n_train], idx[n_train:]
        return self._take(tr), self._take(te)

    def _take(self, idx: np.ndarray) -> "DataSet":
        return DataSet(
            self.features[idx], self.labels[idx],
            None if self.mask is None else self.mask[idx],
        )

    def shuffle(self, seed: int = 0) -> "DataSet":
        idx = np.arange(self.num_examples())
        np.random.default_rng(seed).shuffle(idx)
        return self._take(idx)

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [
            self._take(np.arange(i, min(i + batch_size, self.num_examples())))
            for i in range(0, self.num_examples(), batch_size)
        ]

    def normalize_zero_mean_unit_variance(self) -> "DataSet":
        mu = self.features.mean(axis=0, keepdims=True)
        sd = self.features.std(axis=0, keepdims=True) + 1e-8
        return dataclasses.replace(self, features=(self.features - mu) / sd)

    def scale_0_1(self) -> "DataSet":
        lo = self.features.min()
        hi = self.features.max()
        return dataclasses.replace(
            self, features=(self.features - lo) / max(hi - lo, 1e-8))

    @staticmethod
    def merge(datasets: List["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets], axis=0),
            np.concatenate([d.labels for d in datasets], axis=0),
            (None if datasets[0].mask is None
             else np.concatenate([d.mask for d in datasets], axis=0)),
        )
