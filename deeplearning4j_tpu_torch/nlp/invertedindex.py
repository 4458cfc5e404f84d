"""In-memory inverted index with mini-batch document sampling
(counterpart of `deeplearning4j_tpu.nlp.invertedindex`, unchanged).

Parity: reference `text/invertedindex/LuceneInvertedIndex.java` (929 LoC) —
the role it plays for Word2Vec batching: store docs as word lists, map
word→documents, and serve random mini-batches of documents for training.
Lucene (on-disk segments, analyzers) is infrastructure this package does
not need; a dict-backed index covers the consumed API.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class InvertedIndex:
    def __init__(self, vocab: Optional[VocabCache] = None):
        self.vocab = vocab
        self._docs: List[List[str]] = []
        self._word_to_docs: Dict[str, set] = defaultdict(set)

    # -- reference InvertedIndex API ---------------------------------------
    def add_word_to_doc(self, doc: int, word: str) -> None:
        while doc >= len(self._docs):
            self._docs.append([])
        self._docs[doc].append(word)
        self._word_to_docs[word].add(doc)

    def add_doc(self, words: Sequence[str]) -> int:
        doc_id = len(self._docs)
        self._docs.append(list(words))
        for w in words:
            self._word_to_docs[w].add(doc_id)
        return doc_id

    def document(self, index: int) -> List[str]:
        return list(self._docs[index])

    def documents(self, word: str) -> List[int]:
        return sorted(self._word_to_docs.get(word, ()))

    def num_documents(self) -> int:
        return len(self._docs)

    def all_docs(self) -> List[List[str]]:
        return [list(d) for d in self._docs]

    # -- mini-batch sampling (the Word2Vec batching role) ------------------
    def sample_batches(self, batch_size: int, num_batches: int,
                       seed: int = 0) -> Iterator[List[List[str]]]:
        rng = np.random.default_rng(seed)
        n = len(self._docs)
        if n == 0:
            return
        for _ in range(num_batches):
            idx = rng.integers(0, n, batch_size)
            yield [list(self._docs[i]) for i in idx]

    def eachDocWithLabel(self):  # reference casing kept for familiarity
        for i, d in enumerate(self._docs):
            yield list(d), i
