"""Word-vector serialization: word2vec-C compatible text and binary formats
(counterpart of `deeplearning4j_tpu.nlp.serde`: the files are
byte-identical across the two packages).

Parity: reference `models/embeddings/loader/WordVectorSerializer.java:76` —
`writeWordVectors:335` (text: `word v1 v2 ...` per line),
`loadGoogleModel` (binary: header `V D\\n` then `word<space><D float32s>`),
`loadTxt:422`. Files written here load in gensim/word2vec-C and vice versa.
The loaders take the `device` that the returned `WordVectors` queries on
(`words_nearest`): the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os

import numpy as np

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.nlp.word_vectors import WordVectors


def write_word_vectors(wv: WordVectors, path: os.PathLike) -> None:
    """Text format (reference writeWordVectors:335): one `word floats...`
    line per word, no header (reference writes no header either)."""
    with open(path, "w", encoding="utf-8") as f:
        for i in range(len(wv.vocab)):
            word = wv.vocab.word_at(i)
            vals = " ".join(f"{v:.6g}" for v in wv.syn0[i])
            f.write(f"{word} {vals}\n")


def load_txt_vectors(path: os.PathLike,
                     device: DeviceLike = None) -> WordVectors:
    """Load text vectors (reference loadTxt:422). Tolerates an optional
    gensim-style `V D` header line."""
    device = resolve_device(device)
    vocab = VocabCache()
    rows = []
    with open(path, encoding="utf-8") as f:
        first = f.readline().split()
        if len(first) == 2 and all(t.isdigit() for t in first):
            pass  # header line; skip
        elif first:
            vocab.add(first[0])
            rows.append([float(v) for v in first[1:]])
        for line in f:
            parts = line.split()  # robust to repeated/trailing whitespace
            if len(parts) < 2:
                continue
            vocab.add(parts[0])
            rows.append([float(v) for v in parts[1:]])
    return WordVectors(vocab, np.asarray(rows, np.float32), device=device)


def write_binary_model(wv: WordVectors, path: os.PathLike) -> None:
    """Google word2vec binary format (header `V D\\n`, then per word:
    `word ` + D little-endian float32s + `\\n`)."""
    with open(path, "wb") as f:
        V, D = wv.syn0.shape
        f.write(f"{V} {D}\n".encode())
        for i in range(V):
            f.write(wv.vocab.word_at(i).encode("utf-8") + b" ")
            f.write(wv.syn0[i].astype("<f4").tobytes())
            f.write(b"\n")


def read_binary_model(path: os.PathLike,
                      device: DeviceLike = None) -> WordVectors:
    """Reference `loadGoogleModel(binary=true)`."""
    device = resolve_device(device)
    vocab = VocabCache()
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").split()
        V, D = int(header[0]), int(header[1])
        vecs = np.empty((V, D), np.float32)
        for i in range(V):
            word = bytearray()
            while True:
                ch = f.read(1)
                if ch in (b" ", b""):
                    break
                if ch != b"\n":
                    word += ch
            vocab.add(word.decode("utf-8"))
            vecs[i] = np.frombuffer(f.read(4 * D), "<f4")
            nl = f.read(1)
            if nl not in (b"\n", b""):  # some writers omit the newline
                f.seek(-1, 1)
    return WordVectors(vocab, vecs, device=device)
