"""Labeled news-corpus loader: directory-of-label-dirs -> TF-IDF/BoW
DataSet (counterpart of `deeplearning4j_tpu.nlp.news`; host numpy, on the
port's downloader and vectorizers).

Parity: reference `datasets/loader/ReutersNewsGroupsLoader.java` (downloads
the 20-Newsgroups archive, walks one subdirectory per label, vectorizes
with TfidfVectorizer/BagOfWordsVectorizer) and its thin iterator wrapper
`datasets/iterator/ReutersNewsGroupsDataSetIterator.java`.

Differences from the reference: the corpus root is pluggable (any
directory whose immediate subdirectories are labels and whose files are
documents), the download is gated behind the shared dataset downloader
(zero-egress hosts fall back to a small bundled corpus with a loud
warning), and the result is a dense `DataSet` ready for
`MultiLayerNetwork.fit`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.downloader import (
    cache_dir,
    download,
    downloads_allowed,
    warn_fallback,
)
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nlp.vectorizers import (
    CountVectorizer,
    TfidfVectorizer,
)

NEWSGROUP_URL = "http://qwone.com/~jason/20Newsgroups/20news-18828.tar.gz"

# Tiny bundled fallback corpus (three topics, clearly separable vocabulary)
# used only when no corpus directory exists and downloads are unavailable.
_FALLBACK = {
    "sport": [
        "the team won the match with a late goal",
        "the coach praised the players after the game",
        "fans cheered as the striker scored twice",
        "the league title race goes to the final match",
    ],
    "tech": [
        "the new chip doubles memory bandwidth",
        "the compiler fuses kernels for faster inference",
        "engineers shipped a faster network driver",
        "the processor schedules threads across cores",
    ],
    "finance": [
        "the market rallied as rates fell",
        "investors bought bonds after the earnings report",
        "the bank raised its growth forecast",
        "shares climbed on strong quarterly profits",
    ],
}


def _round_robin(streams: dict, num_examples: Optional[int]
                 ) -> Tuple[List[str], List[str]]:
    """Interleave {label: iterator-of-documents} round-robin so a
    ``num_examples`` cap yields a class-balanced subset instead of
    exhausting the alphabetically-first label.  Iterators may yield None
    for unreadable items (skipped without consuming the cap)."""
    docs, doc_labels = [], []
    live = sorted(streams)
    while live and (num_examples is None or len(docs) < num_examples):
        for label in list(live):
            if num_examples is not None and len(docs) >= num_examples:
                break
            doc = next(streams[label], _round_robin)  # sentinel = exhausted
            if doc is _round_robin:
                live.remove(label)
                continue
            if doc is None:
                continue
            docs.append(doc)
            doc_labels.append(label)
    return docs, doc_labels


def _read_or_none(f: Path) -> Optional[str]:
    try:
        return f.read_text(errors="replace")
    except OSError:
        return None


def _walk_label_dirs(root: Path, num_examples: Optional[int]
                     ) -> Tuple[List[str], List[str], List[str]]:
    """(documents, doc_labels, label_names) from one-subdir-per-label."""
    labels = sorted(d.name for d in root.iterdir() if d.is_dir())
    streams = {
        label: (_read_or_none(f)
                for f in sorted((root / label).rglob("*")) if f.is_file())
        for label in labels
    }
    docs, doc_labels = _round_robin(streams, num_examples)
    return docs, doc_labels, labels


def _fetch_newsgroups() -> Optional[Path]:
    """Download + extract 20news into the dataset cache; None if offline."""
    root = cache_dir("newsgroups")
    extracted = root / "20news-18828"
    if extracted.is_dir():
        return extracted
    if not downloads_allowed():
        return None
    archive = root / "20news-18828.tar.gz"
    try:
        download(NEWSGROUP_URL, archive)
        import shutil
        import tarfile

        # Extract to a temp dir, then atomically rename — an interrupted
        # extractall must not leave a half-populated tree that later runs
        # would silently treat as the full corpus.
        tmp = root / ".extract.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        with tarfile.open(archive) as tf:
            tf.extractall(tmp, filter="data")
        (tmp / "20news-18828").rename(extracted)
        shutil.rmtree(tmp, ignore_errors=True)
    except Exception as e:  # noqa: BLE001 - any failure -> offline fallback
        warn_fallback("newsgroups", f"download failed: {e}",
                      "bundled mini news corpus")
        return None
    return extracted if extracted.is_dir() else None


def news_corpus(root: Optional[os.PathLike] = None,
                num_examples: Optional[int] = None
                ) -> Tuple[List[str], List[str], List[str]]:
    """(documents, doc_labels, label_names) for a labeled news corpus.

    Resolution order: explicit ``root`` > $DL4J_NEWS_DIR > cached/downloaded
    20-Newsgroups > bundled mini corpus (loud warning).
    """
    if root is not None:
        if not Path(root).is_dir():
            raise FileNotFoundError(f"news corpus root not found: {root}")
        if not any(d.is_dir() for d in Path(root).iterdir()):
            raise ValueError(
                f"no label subdirectories under {root}: expected one "
                f"subdirectory per label containing document files")
        return _walk_label_dirs(Path(root), num_examples)
    env_root = os.environ.get("DL4J_NEWS_DIR")
    if env_root:
        if Path(env_root).is_dir() and any(
                d.is_dir() for d in Path(env_root).iterdir()):
            return _walk_label_dirs(Path(env_root), num_examples)
        warn_fallback(
            "newsgroups",
            f"$DL4J_NEWS_DIR={env_root} is not a directory with label "
            f"subdirectories", "downloaded/bundled corpus")
    fetched = _fetch_newsgroups()
    if fetched is not None:
        return _walk_label_dirs(fetched, num_examples)
    warn_fallback("newsgroups", "no corpus dir and downloads unavailable",
                  "bundled mini news corpus")
    docs, doc_labels = _round_robin(
        {label: iter(texts) for label, texts in _FALLBACK.items()},
        num_examples)
    return docs, doc_labels, sorted(_FALLBACK)


def news_dataset(root: Optional[os.PathLike] = None, tfidf: bool = True,
                 num_examples: Optional[int] = None,
                 min_word_frequency: int = 1,
                 max_features: Optional[int] = 10_000) -> DataSet:
    """Vectorized news corpus as a DataSet (ReutersNewsGroupsLoader parity:
    tfidf=True -> TfidfVectorizer, else BagOfWords/CountVectorizer).

    ``max_features`` caps the vocabulary at the top-N frequent terms so the
    dense feature matrix stays bounded (the full 20news vocabulary would be
    ~100k terms — ~7 GB dense); pass None for the uncapped reference
    behavior."""
    docs, doc_labels, labels = news_corpus(root, num_examples)
    vec_cls = TfidfVectorizer if tfidf else CountVectorizer
    vec = vec_cls(min_word_frequency=min_word_frequency,
                  max_features=max_features)
    features = np.asarray(vec.fit_transform(docs), dtype=np.float32)
    index = {l: i for i, l in enumerate(labels)}
    y = np.eye(len(labels), dtype=np.float32)[[index[l] for l in doc_labels]]
    return DataSet(features, y)


class NewsGroupsDataSetIterator(ArrayDataSetIterator):
    """Batched iterator over the vectorized news corpus (reference
    ReutersNewsGroupsDataSetIterator.java)."""

    def __init__(self, batch: int, num_examples: Optional[int] = None,
                 tfidf: bool = True, root: Optional[os.PathLike] = None):
        ds = news_dataset(root, tfidf=tfidf, num_examples=num_examples)
        super().__init__(ds.features, ds.labels, batch)


__all__ = ["NEWSGROUP_URL", "NewsGroupsDataSetIterator", "news_corpus",
           "news_dataset"]
