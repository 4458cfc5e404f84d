"""Vocabulary store + Huffman coding for hierarchical softmax (counterpart
of `deeplearning4j_tpu.nlp.vocab`, unchanged: the same word order, codes
and points).

Parity: reference `models/word2vec/wordstore/VocabCache` /
`InMemoryLookupCache.java` (word→index/frequency), `VocabWord.java`, and
`Huffman.java:29` (binary Huffman tree over word frequencies assigning each
word its code bits and inner-node "points" path, consumed by the HS
objective at `InMemoryLookupTable.iterateSample:192`).

Codes/points are padded into dense int arrays (`VocabCache.hs_arrays()`)
so the whole batch's Huffman paths are two gathers on the device instead
of per-word Java loops.
"""

from __future__ import annotations

import heapq
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class VocabWord:
    """Reference `VocabWord.java`: word + frequency + HS codes/points."""
    word: str
    count: int = 0
    index: int = -1
    codes: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)


class VocabCache:
    """Word→VocabWord store with frequency-ordered contiguous indices."""

    def __init__(self, min_word_frequency: int = 1,
                 max_words: Optional[int] = None):
        self.min_word_frequency = min_word_frequency
        self.max_words = max_words  # keep only the top-N frequent words
        self.words: Dict[str, VocabWord] = {}
        self._index: List[str] = []

    # -- building ----------------------------------------------------------
    def fit(self, sentences: Iterable[Sequence[str]]) -> "VocabCache":
        counts: Counter = Counter()
        for tokens in sentences:
            counts.update(tokens)
        for word, count in counts.most_common():
            if self.max_words is not None and len(self._index) >= self.max_words:
                break
            if count >= self.min_word_frequency:
                self.add(word, count)
        return self

    def add(self, word: str, count: int = 1) -> VocabWord:
        if word in self.words:
            vw = self.words[word]
            vw.count += count
            return vw
        vw = VocabWord(word=word, count=count, index=len(self._index))
        self.words[word] = vw
        self._index.append(word)
        return vw

    # -- lookups (reference VocabCache API) --------------------------------
    def index_of(self, word: str) -> int:
        vw = self.words.get(word)
        return vw.index if vw else -1

    def word_at(self, index: int) -> str:
        return self._index[index]

    def word_frequency(self, word: str) -> int:
        vw = self.words.get(word)
        return vw.count if vw else 0

    def contains(self, word: str) -> bool:
        return word in self.words

    def num_words(self) -> int:
        return len(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, word: str) -> bool:
        return word in self.words

    def total_word_count(self) -> int:
        return sum(vw.count for vw in self.words.values())

    def encode(self, tokens: Sequence[str]) -> np.ndarray:
        """Tokens → int32 indices, dropping OOV (reference trainSentence
        skips unknown words)."""
        idx = [self.index_of(t) for t in tokens]
        return np.asarray([i for i in idx if i >= 0], np.int32)

    # -- hierarchical softmax arrays --------------------------------------
    def hs_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense (points, codes, lengths): [V, L] int32 paths through the
        Huffman tree per word, padded with 0; lengths [V]. Requires
        Huffman(...).build() first."""
        V = len(self._index)
        L = max((len(self.words[w].codes) for w in self._index), default=0)
        points = np.zeros((V, L), np.int32)
        codes = np.zeros((V, L), np.int32)
        lengths = np.zeros((V,), np.int32)
        for w in self._index:
            vw = self.words[w]
            n = len(vw.codes)
            lengths[vw.index] = n
            points[vw.index, :n] = vw.points
            codes[vw.index, :n] = vw.codes
        return points, codes, lengths


class Huffman:
    """Builds the Huffman tree over word frequencies and writes each word's
    `codes` (branch bits) and `points` (inner-node indices) — reference
    `Huffman.java:29` build()."""

    def __init__(self, vocab: VocabCache):
        self.vocab = vocab

    def build(self) -> VocabCache:
        vocab = self.vocab
        V = len(vocab)
        if V == 0:
            return vocab
        if V == 1:
            only = vocab.words[vocab.word_at(0)]
            only.codes, only.points = [0], [0]
            return vocab
        # Standard word2vec-style array Huffman: leaves 0..V-1, inner nodes
        # V..2V-2; inner node k is addressed as (k - V) in syn1.
        count = np.empty(2 * V - 1, np.int64)
        for w, vw in vocab.words.items():
            count[vw.index] = vw.count
        heap = [(int(count[i]), i) for i in range(V)]
        heapq.heapify(heap)
        parent = np.zeros(2 * V - 1, np.int32)
        binary = np.zeros(2 * V - 1, np.int8)
        for k in range(V, 2 * V - 1):
            c1, i1 = heapq.heappop(heap)
            c2, i2 = heapq.heappop(heap)
            count[k] = c1 + c2
            parent[i1] = k
            parent[i2] = k
            binary[i2] = 1
            heapq.heappush(heap, (int(count[k]), k))
        root = 2 * V - 2
        for w, vw in vocab.words.items():
            codes: List[int] = []
            points: List[int] = []
            node = vw.index
            while node != root:
                codes.append(int(binary[node]))
                node = int(parent[node])
                points.append(node - V)
            vw.codes = list(reversed(codes))
            vw.points = list(reversed(points))
        return vocab


def build_negative_table(vocab: VocabCache, table_size: int = 100_000,
                         power: float = 0.75) -> np.ndarray:
    """Unigram^0.75 sampling table (reference
    `InMemoryLookupTable.makeTable:165` / word2vec-C): int32 [table_size]
    where word i occupies a share proportional to count_i^power. Negative
    sampling is then a uniform gather into this table on device."""
    V = len(vocab)
    freqs = np.array([vocab.word_frequency(vocab.word_at(i))
                      for i in range(V)], np.float64) ** power
    cum = np.cumsum(freqs / freqs.sum())
    positions = (np.arange(table_size) + 0.5) / table_size
    return np.searchsorted(cum, positions).astype(np.int32).clip(0, V - 1)
