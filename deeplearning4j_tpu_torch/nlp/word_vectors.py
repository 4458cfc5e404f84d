"""WordVectors query API: similarity / nearest neighbours over an
embedding matrix (counterpart of `deeplearning4j_tpu.nlp.word_vectors`).

Parity: reference `models/embeddings/wordvectors/WordVectorsImpl.java`
(540 LoC — cosine `similarity()`, `wordsNearest()`) and the lookup-table
accessors. `syn0` stays a host numpy array, as in the JAX package; the
cosine scan of `words_nearest` is one matrix-vector product on the
model's device over the normalised matrix, whose device copy is kept
until `syn0` changes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class WordVectors:
    """Embedding matrix + vocab with the reference's query surface.
    `device` is where `words_nearest` computes: the card unless the
    caller passes ``device="cpu"``."""

    def __init__(self, vocab: VocabCache, vectors: np.ndarray,
                 device: DeviceLike = None):
        self.vocab = vocab
        self.device = resolve_device(device)
        self.syn0 = np.asarray(vectors, np.float32)
        self.vector_length = int(self.syn0.shape[1])
        self._norms: Optional[np.ndarray] = None
        self._norms_dev: Optional[torch.Tensor] = None

    # -- accessors ---------------------------------------------------------
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return self.syn0[i] if i >= 0 else None

    def __contains__(self, word: str) -> bool:
        return word in self.vocab

    def _normed(self) -> np.ndarray:
        if self._norms is None or self._norms.shape != self.syn0.shape:
            n = np.linalg.norm(self.syn0, axis=1, keepdims=True)
            self._norms = self.syn0 / np.maximum(n, 1e-12)
            self._norms_dev = None
        return self._norms

    def _normed_on_device(self) -> torch.Tensor:
        normed = self._normed()
        if self._norms_dev is None:
            self._norms_dev = torch.from_numpy(normed).to(self.device)
        return self._norms_dev

    # -- queries (reference WordVectorsImpl) -------------------------------
    def similarity(self, w1: str, w2: str) -> float:
        v1, v2 = self.get_word_vector(w1), self.get_word_vector(w2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        return float(np.dot(v1, v2) / max(denom, 1e-12))

    def words_nearest(self, word_or_vec, top_n: int = 10,
                      exclude: Sequence[str] = ()) -> List[str]:
        if isinstance(word_or_vec, str):
            vec = self.get_word_vector(word_or_vec)
            if vec is None:
                return []
            exclude = tuple(exclude) + (word_or_vec,)
        else:
            vec = np.asarray(word_or_vec, np.float32)
        normed = self._normed_on_device()
        q = vec / max(np.linalg.norm(vec), 1e-12)
        sims = (normed @ torch.from_numpy(
            np.asarray(q, np.float32)).to(self.device)).cpu().numpy()
        for w in exclude:
            i = self.vocab.index_of(w)
            if i >= 0:
                sims[i] = -np.inf
        top = np.argsort(-sims)[:top_n]
        return [self.vocab.word_at(int(i)) for i in top if np.isfinite(sims[i])]

    def analogy(self, a: str, b: str, c: str, top_n: int = 5) -> List[str]:
        """a:b :: c:? — the classic king-queen probe."""
        va, vb, vc = (self.get_word_vector(w) for w in (a, b, c))
        if va is None or vb is None or vc is None:
            return []
        return self.words_nearest(vb - va + vc, top_n=top_n,
                                  exclude=(a, b, c))
