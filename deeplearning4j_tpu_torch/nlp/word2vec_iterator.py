"""Word2Vec -> supervised DataSet bridge (counterpart of
`deeplearning4j_tpu.nlp.word2vec_iterator`, on the port's `datasets`).

Parity: reference `models/word2vec/iterator/Word2VecDataSetIterator.java`
(286 LoC) + `WindowConverter.java`: slide a centered window over each
labeled sentence, featurize the window as the concatenation of its tokens'
word vectors, label it with the sentence's label — producing the DataSets
a windowed classifier (e.g. a tagger MLP on the port's
`MultiLayerNetwork`) trains on.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import one_hot
from deeplearning4j_tpu_torch.nlp.windows import Window, windows


def window_to_vector(w2v, window: Window) -> np.ndarray:
    """Concatenated word vectors of the window's tokens (WindowConverter.
    asExampleMatrix); unknown/pad tokens contribute zero vectors."""
    dim = w2v.syn0.shape[1]
    parts = []
    for tok in window.as_tokens():
        idx = w2v.vocab.index_of(tok) if hasattr(w2v.vocab, "index_of") \
            else w2v.vocab.get(tok, -1)
        parts.append(w2v.syn0[idx] if 0 <= idx < len(w2v.syn0)
                     else np.zeros(dim, np.float32))
    return np.concatenate(parts).astype(np.float32)


class Word2VecDataSetIterator:
    """Iterate (features, labels) DataSet batches from labeled sentences.

    `sentences_with_labels`: any iterable of (sentence, label) pairs — a
    LabelAwareSentenceIterator's `.pairs()` works directly.  Feature dim =
    window_size * vector_length; labels one-hot over `labels`."""

    def __init__(self, w2v, sentences_with_labels, labels: Sequence[str],
                 batch: int = 10, window_size: int = 5,
                 tokenizer=None):
        self.w2v = w2v
        self.source = sentences_with_labels
        self.labels = list(labels)
        self._label_idx = {l: i for i, l in enumerate(self.labels)}
        self.batch = batch
        self.window_size = window_size
        if tokenizer is None:
            from deeplearning4j_tpu_torch.nlp.tokenization import (
                DefaultTokenizerFactory,
            )
            tokenizer = DefaultTokenizerFactory()
        self.tokenizer = tokenizer
        self._pairs: Optional[List] = None

    @property
    def input_columns(self) -> int:
        return self.window_size * self.w2v.syn0.shape[1]

    def _materialized(self) -> List:
        if self._pairs is None:
            pairs = (self.source.pairs()
                     if hasattr(self.source, "pairs") else self.source)
            self._pairs = [(s, l) for s, l in pairs]
        return self._pairs

    def _examples(self) -> Iterator[tuple]:
        for sentence, label in self._materialized():
            tokens = (self.tokenizer.tokenize(sentence)
                      if isinstance(sentence, str) else list(sentence))
            if not tokens:
                continue
            y = self._label_idx[label]
            for win in windows(tokens, self.window_size):
                yield window_to_vector(self.w2v, win), y

    def __iter__(self) -> Iterator[DataSet]:
        feats: List[np.ndarray] = []
        ys: List[int] = []
        for x, y in self._examples():
            feats.append(x)
            ys.append(y)
            if len(feats) == self.batch:
                yield DataSet(np.stack(feats),
                              one_hot(np.asarray(ys), len(self.labels)))
                feats, ys = [], []
        if feats:
            yield DataSet(np.stack(feats),
                          one_hot(np.asarray(ys), len(self.labels)))

    def reset(self) -> None:
        pass  # re-iteration re-reads the materialized pairs

    def all_data(self) -> DataSet:
        """Entire corpus as one DataSet (convenience for evaluation)."""
        xs, ys = [], []
        for x, y in self._examples():
            xs.append(x)
            ys.append(y)
        return DataSet(np.stack(xs), one_hot(np.asarray(ys),
                                             len(self.labels)))
