"""Document iterators: whole-document streams for vectorizers and doc2vec
(counterpart of `deeplearning4j_tpu.nlp.document_iterator`, unchanged).

Parity: reference `text/documentiterator/*` — `DocumentIterator` (InputStream
per document), `FileDocumentIterator` (one file = one document),
`LabelAwareDocumentIterator` variants.  Documents here are strings (the
tokenizer SPI consumes text, not streams).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple


class DocumentIterator:
    """SPI: iterate whole documents (reference DocumentIterator)."""

    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionDocumentIterator(DocumentIterator):
    def __init__(self, documents: Sequence[str]):
        self.documents = list(documents)

    def __iter__(self) -> Iterator[str]:
        return iter(self.documents)


class FileDocumentIterator(DocumentIterator):
    """One file under `root` = one document (reference
    FileDocumentIterator.java)."""

    def __init__(self, root: os.PathLike, suffix: str = ""):
        self.root = Path(root)
        self.suffix = suffix

    def _files(self) -> List[Path]:
        return sorted(p for p in self.root.rglob(f"*{self.suffix}")
                      if p.is_file())

    def __iter__(self) -> Iterator[str]:
        for p in self._files():
            yield p.read_text(errors="replace")


class LabelAwareDocumentIterator(DocumentIterator):
    """Documents + labels; directory mode labels each document with its
    parent directory name (the standard corpus-on-disk layout)."""

    def __init__(self, documents: Optional[Sequence[str]] = None,
                 labels: Optional[Sequence[str]] = None,
                 root: Optional[os.PathLike] = None, suffix: str = ""):
        if root is not None:
            paths = sorted(p for p in Path(root).rglob(f"*{suffix}")
                           if p.is_file())
            self._docs = [p.read_text(errors="replace") for p in paths]
            self._labels = [p.parent.name for p in paths]
        else:
            if documents is None or labels is None:
                raise ValueError("need documents+labels or root")
            if len(documents) != len(labels):
                raise ValueError("documents/labels length mismatch")
            self._docs = list(documents)
            self._labels = list(labels)
        self._pos = 0

    def __iter__(self) -> Iterator[str]:
        for d, _ in self.pairs():
            yield d

    def pairs(self) -> Iterator[Tuple[str, str]]:
        return iter(zip(self._docs, self._labels))

    def label_set(self) -> List[str]:
        return sorted(set(self._labels))
