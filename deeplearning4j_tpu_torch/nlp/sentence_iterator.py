"""Sentence / document iterator SPIs (counterpart of
`deeplearning4j_tpu.nlp.sentence_iterator`, unchanged).

Parity: reference `text/sentenceiterator/` (Collection/Line/File/UIMA
iterators, label-aware variants, SentencePreProcessor) and
`text/documentiterator/`. All are thin, restartable streams over text
sources — the corpus side of the Word2Vec/GloVe pipelines.
"""

from __future__ import annotations

import os
import pathlib
from typing import Callable, Iterable, Iterator, Optional, Sequence


class SentenceIterator:
    """SPI: nextSentence/hasNext/reset (+ Python iteration), with an
    optional SentencePreProcessor applied to every sentence."""

    def __init__(self, pre_processor: Optional[Callable[[str], str]] = None):
        self.pre_processor = pre_processor

    def _raw(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[str]:
        self.reset()
        for sentence in self._raw():
            yield (self.pre_processor(sentence) if self.pre_processor
                   else sentence)


class CollectionSentenceIterator(SentenceIterator):
    """Over an in-memory collection (reference
    `CollectionSentenceIterator`)."""

    def __init__(self, sentences: Sequence[str], pre_processor=None):
        super().__init__(pre_processor)
        self.sentences = list(sentences)

    def _raw(self):
        return iter(self.sentences)


class LineSentenceIterator(SentenceIterator):
    """One sentence per line of a file (reference `LineSentenceIterator`)."""

    def __init__(self, path: os.PathLike, pre_processor=None):
        super().__init__(pre_processor)
        self.path = pathlib.Path(path)

    def _raw(self):
        with open(self.path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class FileSentenceIterator(SentenceIterator):
    """Every file under a directory, one sentence per line (reference
    `FileSentenceIterator` walks a dir)."""

    def __init__(self, root: os.PathLike, pre_processor=None):
        super().__init__(pre_processor)
        self.root = pathlib.Path(root)

    def _raw(self):
        files = ([self.root] if self.root.is_file()
                 else sorted(p for p in self.root.rglob("*") if p.is_file()))
        for path in files:
            with open(path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield line


class LabelAwareSentenceIterator(SentenceIterator):
    """(sentence, label) streams for ParagraphVectors (reference
    `LabelAwareSentenceIterator` / LabelAwareListSentenceIterator)."""

    def __init__(self, sentences: Sequence[str], labels: Sequence[str],
                 pre_processor=None):
        super().__init__(pre_processor)
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels must align")
        self.sentences = list(sentences)
        self.labels = list(labels)
        self._pos = 0

    def _raw(self):
        for i, s in enumerate(self.sentences):
            self._pos = i
            yield s

    def current_label(self) -> str:
        return self.labels[self._pos]

    def pairs(self) -> Iterator[tuple]:
        for s, l in zip(self.sentences, self.labels):
            yield ((self.pre_processor(s) if self.pre_processor else s), l)


class DocumentIterator:
    """SPI over whole documents (reference `text/documentiterator/`)."""

    def __init__(self, docs: Iterable[str]):
        self.docs = list(docs)

    def __iter__(self) -> Iterator[str]:
        return iter(self.docs)
