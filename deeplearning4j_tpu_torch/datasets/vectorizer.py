"""Vectorizers: raw inputs -> DataSet (counterpart of
`deeplearning4j_tpu.datasets.vectorizer`; numpy, on `utils/image_loader`).

Parity: reference `datasets/vectorizer/Vectorizer.java` (the SPI) and
`ImageVectorizer.java` (RGB image file -> flattened row vector with
binarize-by-threshold / normalize-to-[0,1] options + one-hot label).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class Vectorizer:
    """SPI: anything that can produce a DataSet (reference Vectorizer.java)."""

    def vectorize(self) -> DataSet:
        raise NotImplementedError


class ImageVectorizer(Vectorizer):
    """One labeled image -> DataSet (reference ImageVectorizer.java).

    ``binarize(threshold)``: brightness-agnostic 0/1 features (anything
    below the threshold is zero); ``normalize()``: scale into [0, 1].
    The two are mutually exclusive, last call wins — same as chaining the
    reference's builder-style mutators.
    """

    def __init__(self, image: os.PathLike, num_labels: int, label: int,
                 height: Optional[int] = None, width: Optional[int] = None):
        from deeplearning4j_tpu_torch.utils.image_loader import ImageLoader

        self.image = image
        self.num_labels = num_labels
        self.label = label
        self.loader = ImageLoader(height=height, width=width)
        self._binarize = False
        self._normalize = False
        self.threshold = 30

    def binarize(self, threshold: int = 30) -> "ImageVectorizer":
        self._binarize, self._normalize = True, False
        self.threshold = threshold
        return self

    def normalize(self) -> "ImageVectorizer":
        self._normalize, self._binarize = True, False
        return self

    def vectorize(self) -> DataSet:
        # ImageLoader yields [0,1]; the reference operates on raw 0-255
        # pixels (threshold default 30), so restore that scale first.
        x = np.asarray(self.loader.as_row_vector(self.image), np.float32)
        x = x.reshape(1, -1) * 255.0
        if self._binarize:
            x = (x > self.threshold).astype(np.float32)
        elif self._normalize:
            x = x / 255.0
        y = np.zeros((1, self.num_labels), np.float32)
        y[0, self.label] = 1.0
        return DataSet(x, y)
