"""Text vectorizers: bag-of-words counts and TF-IDF → DataSet
(counterpart of `deeplearning4j_tpu.nlp.vectorizers`, on the port's
`datasets`).

Parity: reference `bagofwords/vectorizer/` — `BaseTextVectorizer.java`,
`CountVectorizer`, `TfidfVectorizer` (vectorize(text, label) → DataSet).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import one_hot
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class BaseTextVectorizer:
    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 max_features: Optional[int] = None):
        self.vocab = VocabCache(min_word_frequency=min_word_frequency,
                                max_words=max_features)
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self._doc_freq: Dict[str, int] = {}
        self._idf = np.zeros(0, np.float32)
        self.num_docs = 0

    def fit(self, documents: Sequence[str]) -> "BaseTextVectorizer":
        self._fit_tokens([self.tokenizer.tokenize(d) for d in documents])
        return self

    def _fit_tokens(self, token_lists: Sequence[Sequence[str]]) -> None:
        self.vocab.fit(token_lists)
        self.num_docs = len(token_lists)
        for toks in token_lists:
            for w in set(toks):
                if self.vocab.contains(w):
                    self._doc_freq[w] = self._doc_freq.get(w, 0) + 1
        self._idf = np.zeros(len(self.vocab), np.float32)
        for w, df in self._doc_freq.items():
            self._idf[self.vocab.index_of(w)] = math.log(
                max(self.num_docs, 1) / df)

    def fit_transform(self, documents: Sequence[str]) -> np.ndarray:
        """fit + transform tokenizing each document once (a large corpus is
        tokenized twice by fit(docs) followed by transform(docs))."""
        token_lists = [self.tokenizer.tokenize(d) for d in documents]
        self._fit_tokens(token_lists)
        return np.stack([self._row(toks) for toks in token_lists])

    def _row(self, tokens: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def transform(self, documents: Sequence[str]) -> np.ndarray:
        return np.stack([self._row(self.tokenizer.tokenize(d))
                         for d in documents])

    def vectorize(self, documents: Sequence[str],
                  labels: Sequence[int],
                  num_classes: Optional[int] = None) -> DataSet:
        """text+label → DataSet (reference TextVectorizer.vectorize)."""
        x = self.transform(documents)
        y = np.asarray(labels, int)
        k = num_classes or int(y.max()) + 1
        return DataSet(x.astype(np.float32), one_hot(y, k))


class CountVectorizer(BaseTextVectorizer):
    """Raw term counts (reference CountVectorizer)."""

    def _row(self, tokens):
        row = np.zeros(len(self.vocab), np.float32)
        for t in tokens:
            i = self.vocab.index_of(t)
            if i >= 0:
                row[i] += 1.0
        return row


class TfidfVectorizer(BaseTextVectorizer):
    """TF-IDF weights (reference TfidfVectorizer: tf * log(N/df))."""

    def _row(self, tokens):
        row = np.zeros(len(self.vocab), np.float32)
        if not tokens:
            return row
        for t in tokens:
            i = self.vocab.index_of(t)
            if i >= 0:
                row[i] += 1.0
        row /= max(len(tokens), 1)
        return row * self._idf
