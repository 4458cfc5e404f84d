"""ParagraphVectors (doc2vec), DBOW flavour on top of Word2Vec
(counterpart of `deeplearning4j_tpu.nlp.paragraph_vectors`).

Parity: reference `models/paragraphvectors/ParagraphVectors.java:61` —
document labels live in the same vocab/lookup table as words (:64), and
`dbow():295` trains the label's vector to predict each word of the
document through the same HS/NEG objective as skip-gram. Inference for an
unseen document gradient-descends a fresh vector against frozen output
weights, with the DBOW loss's gradient written out by hand (the JAX
package takes `jax.grad` of the same loss).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, decayed_lr


class ParagraphVectors(Word2Vec):
    """DBOW paragraph vectors: labels as pseudo-words."""

    LABEL_PREFIX = "LABEL_"  # keeps labels distinct from corpus words

    def __init__(self, train_words: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.train_words = train_words
        self.labels: List[str] = []

    def fit_labelled(self, sentences: Sequence[str],
                     labels: Sequence[str]) -> "ParagraphVectors":
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels must align")
        token_lists = self._sentences_to_tokens(sentences)
        self.labels = sorted(set(labels))
        # Labels enter the vocab as pseudo-words (reference: labels are
        # VocabWords :64). Their count is the number of DBOW training pairs
        # they appear in (= doc length), floored at min_word_frequency so the
        # vocab filter can never silently drop a label.
        with_labels = list(token_lists)
        floor = max(self.vocab.min_word_frequency, 1)
        for toks, lab in zip(token_lists, labels):
            with_labels.append(
                [self.LABEL_PREFIX + lab] * max(len(toks), floor))
        self.build_vocab(with_labels)
        self.reset_weights()

        rng = np.random.default_rng(self.seed)
        gen = self._generator(self.seed)
        syn0, out = self._tables_to_device()

        encoded = [self.vocab.encode(t) for t in token_lists]
        label_idx = np.asarray(
            [self.vocab.index_of(self.LABEL_PREFIX + l) for l in labels],
            np.int32)
        if (label_idx < 0).any():
            raise AssertionError("label missing from vocab after build")

        # DBOW pairs: (input=label, target=word) for every word of the doc;
        # optionally also plain skip-gram pairs to train word vectors.
        lens = [len(s) for s in encoded]
        if sum(lens):
            arr = np.stack([np.repeat(label_idx, lens),
                            np.concatenate(encoded)], axis=1).astype(np.int32)
        else:
            arr = np.zeros((0, 2), np.int32)
        if self.train_words:
            arr = np.concatenate([arr, self._make_pairs(encoded, rng)])

        dev, B = self.device, self.batch_size
        total = max(len(arr) * self.epochs, 1)
        n_batches = (len(arr) + B - 1) // B
        full_valid = torch.ones(B, device=dev)
        tail_valid = torch.zeros(B, device=dev)
        tail_valid[:len(arr) - (n_batches - 1) * B] = 1.0
        seen = 0
        for epoch in range(self.epochs):
            arr = arr[rng.permutation(len(arr))]
            padded = np.zeros((n_batches * B, 2), np.int32)
            padded[:len(arr)] = arr
            # the epoch's pairs on the device at once, [batches, 2, B]
            staged = torch.from_numpy(np.ascontiguousarray(
                padded.reshape(n_batches, B, 2).transpose(0, 2, 1))
            ).to(dev).long()
            for bi in range(n_batches):
                n_real = min(B, len(arr) - bi * B)
                lr = decayed_lr(self.learning_rate, self.min_learning_rate,
                                seen, total)
                self._step(syn0, out, staged[bi, 0], staged[bi, 1], lr,
                           full_valid if n_real == B else tail_valid, gen)
                seen += n_real
        self._tables_from_device(syn0, out)
        return self

    # -- queries -----------------------------------------------------------
    def get_label_vector(self, label: str) -> Optional[np.ndarray]:
        return self.get_word_vector(self.LABEL_PREFIX + label)

    def similarity_to_label(self, words: Sequence[str], label: str) -> float:
        """Cosine between the mean word vector and a label vector."""
        vecs = [v for w in words if (v := self.get_word_vector(w)) is not None]
        lv = self.get_label_vector(label)
        if not vecs or lv is None:
            return float("nan")
        mean = np.mean(vecs, axis=0)
        denom = np.linalg.norm(mean) * np.linalg.norm(lv)
        return float(np.dot(mean, lv) / max(denom, 1e-12))

    def predict(self, words: Sequence[str]) -> Optional[str]:
        """Nearest label for a tokenized document (reference
        ParagraphVectors usage in sentiment examples)."""
        scored = [(self.similarity_to_label(words, l), l)
                  for l in self.labels]
        scored = [(s, l) for s, l in scored if np.isfinite(s)]
        return max(scored)[1] if scored else None

    def infer_vector(self, words: Sequence[str], steps: int = 50,
                     lr: float = 0.05) -> np.ndarray:
        """Gradient-descend a fresh doc vector against frozen output
        weights (DBOW objective; HS without the MAX_EXP skip, NEG with
        `negative` draws per word from a generator seeded ``seed + 1``)."""
        idx = self.vocab.encode(list(words))
        if len(idx) == 0:
            return np.zeros(self.vector_length, np.float32)
        rng = np.random.default_rng(self.seed)
        v = ((rng.random(self.vector_length) - 0.5)
             / self.vector_length).astype(np.float32)
        dev = self.device
        targets = torch.from_numpy(idx).to(dev).long()
        vec = torch.from_numpy(v).to(dev)
        if self.negative == 0:
            points, codes, lengths = self._hs
            p = points[targets]
            mask = (torch.arange(p.shape[1], device=dev)[None, :]
                    < lengths[targets][:, None]).float()
            sign = 1.0 - 2.0 * codes[targets].float()
            w = torch.tensor(self.syn1, device=dev)[p]          # [N, L, D]
            for _ in range(steps):
                # loss = -sum(mask * logsigmoid(sign * w.vec))
                dots = torch.einsum("d,nld->nl", vec, w)
                g = sign * torch.sigmoid(-sign * dots) * mask
                grad = -torch.einsum("nl,nld->d", g, w)
                vec = vec - lr * grad
        else:
            syn1neg = torch.tensor(self.syn1neg, device=dev)
            negs = self._negatives(self._generator(self.seed + 1), len(idx))
            pos = syn1neg[targets]                              # [N, D]
            neg = syn1neg[negs]                                 # [N, K, D]
            keep = (negs != targets[:, None]).float()
            for _ in range(steps):
                # loss = -(sum logsigmoid(pos.vec)
                #          + sum keep * logsigmoid(-neg.vec))
                g_pos = torch.sigmoid(-(pos @ vec))
                g_neg = torch.sigmoid(torch.einsum("nkd,d->nk", neg, vec))
                grad = (torch.einsum("nk,nkd->d", g_neg * keep, neg)
                        - g_pos @ pos)
                vec = vec - lr * grad
        return vec.cpu().numpy()
