"""Image → array loading (counterpart of
`deeplearning4j_tpu.utils.image_loader`; a copy: numpy and the standard
library only).

Parity: reference `util/ImageLoader.java` (load image files into row
vectors, optionally resized, for the LFW pipeline). PIL-backed and gated so
minimal installs raise a clear error instead of importing eagerly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ImageLoader:
    def __init__(self, height: Optional[int] = None,
                 width: Optional[int] = None, grayscale: bool = True):
        self.height = height
        self.width = width
        self.grayscale = grayscale

    def _pil(self):
        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "ImageLoader requires Pillow (PIL) to be installed") from e
        return Image

    def load(self, path: str) -> np.ndarray:
        """[H, W] (grayscale) or [H, W, C] float32 in [0, 1]."""
        Image = self._pil()
        img = Image.open(path)
        if self.grayscale:
            img = img.convert("L")
        else:
            img = img.convert("RGB")
        if self.height and self.width:
            img = img.resize((self.width, self.height))
        arr = np.asarray(img, np.float32) / 255.0
        return arr

    def as_row_vector(self, path: str) -> np.ndarray:
        return self.load(path).reshape(1, -1)

    def as_matrix(self, paths) -> np.ndarray:
        return np.concatenate([self.as_row_vector(p) for p in paths], axis=0)
