"""Word2Vec: skip-gram with hierarchical softmax and/or negative sampling,
dense-batched on one device (counterpart of
`deeplearning4j_tpu.nlp.word2vec`, single device).

Parity: reference `models/word2vec/Word2Vec.java:59` (fit():103 — vocab
build → Huffman → training loop; `skipGram():319`; `iterate():342`) and the
HS/NEG inner loop `InMemoryLookupTable.iterateSample:192` with its expTable
sigmoid LUT, unigram^0.75 negative table, and linear learning-rate decay
floored at minLearningRate.

The design is the JAX package's:

- the host encodes sentences to int32 arrays once, then per epoch emits
  skip-gram (input, target) pairs with the word2vec dynamic-window trick
  (numpy ``default_rng(seed)``: the same pairs as the JAX package),
  staged on the device in bounded chunks and cut into fixed-size batches;
- one step evaluates a whole batch: embedding gathers, a [B, L] batched
  dot against the Huffman path rows (HS) or [B, K] negatives gathered
  from the unigram table (NEG), exact log-sigmoid instead of the
  1000-entry LUT, masked sum;
- gradients for syn0/syn1 are hand-derived for the TOUCHED rows only and
  applied with ``index_add_``: duplicate rows of a batch add up, and no
  dense [V, D] gradient is ever formed, so vocabulary size costs memory,
  not step time.  The JAX package wrote no Pallas kernel here (XLA's
  gathers and scatter-adds), so these are plain PyTorch ops.

The tables live on the model's device as float32 tensors from the start
of `fit` to its end and come back to numpy then.  Negatives are drawn by
a `torch.Generator` on that device seeded from `seed` (`_negatives`); the
NEG step takes them as an argument.

``mesh=`` (a `parallel.mesh.Mesh`) shards each pair batch over the
mesh's first axis through `parallel.mesh.sparse_allgather_step`: every
shard computes its (row, delta) pairs on its device, the pairs are
gathered in shard order — O(B·D), never a dense table — and one scatter
updates the tables; the batch size rounds up to a multiple of the
shards.  A step's negatives are drawn for the whole batch and sharded
with it, so a mesh trains on the single-device draws.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import DeviceLike
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    Huffman,
    VocabCache,
    build_negative_table,
)
from deeplearning4j_tpu_torch.nlp.word_vectors import WordVectors
from deeplearning4j_tpu_torch.parallel.mesh import (
    round_batch_to_mesh,
    sparse_allgather_step,
)

# Reference MAX_EXP (InMemoryLookupTable.java): in the HIERARCHICAL
# SOFTMAX loop, pairs whose dot saturates (|dot| >= 6) contribute NO
# update — `iterateSample:214` skips them.  Besides parity, this keeps a
# batched step stable: a row that receives hundreds of same-direction
# contributions in one batch (a ParagraphVectors label) would otherwise
# feed back |g|~1 updates and diverge.  The NEG step has no clip.
MAX_EXP = 6.0

# Pairs staged on the device per chunk during fit(): device memory stays
# O(chunk) on huge corpora while no host-to-device copy sits in the
# per-batch loop.
STAGE_PAIRS = 1_048_576


def apply_deltas(syn0: torch.Tensor, syn1: torch.Tensor, lr: float, aux):
    """Scatter-add ``lr * delta`` into the touched rows of both tables, in
    place: `aux` is ((syn0 rows, deltas), (syn1 rows, deltas), ...), the
    output table's pieces added in their order."""
    (r0, d0), *rest = aux
    syn0.index_add_(0, r0, d0, alpha=lr)
    for r1, d1 in rest:
        syn1.index_add_(0, r1, d1, alpha=lr)
    return syn0, syn1


def hs_deltas(syn0: torch.Tensor, syn1: torch.Tensor,
              hs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              inputs: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor):
    """The hierarchical-softmax step's batch loss and its sparse pieces
    ((inputs, dh), (path rows, dw)) for `apply_deltas`.  `hs` is (points,
    codes, lengths) on the device; `valid` zeroes padded pairs.  Padded
    path columns are masked to a zero delta, so their row-0 index adds
    nothing."""
    points, codes, lengths = hs
    h = syn0[inputs]                                     # [B, D]
    p = points[targets]                                  # [B, L]
    c = codes[targets]
    mask = (torch.arange(points.shape[1], device=h.device)[None, :]
            < lengths[targets][:, None]).to(h.dtype)
    mask = mask * valid.to(h.dtype)[:, None]
    w = syn1[p]                                          # [B, L, D]
    dots = torch.einsum("bd,bld->bl", h, w)
    sign = 1.0 - 2.0 * c.to(h.dtype)                     # label 1 for code 0
    loss = -torch.sum(F.logsigmoid(sign * dots) * mask)
    # descent direction of the loss in dots; MAX_EXP zeroes saturated pairs
    g = sign * torch.sigmoid(-sign * dots) * mask
    g = torch.where(dots.abs() < MAX_EXP, g, 0.0)
    dh = torch.einsum("bl,bld->bd", g, w)
    dw = g[:, :, None] * h[:, None, :]
    return loss, ((inputs, dh),
                  (p.reshape(-1), dw.reshape(-1, h.shape[1])))


def hs_step(syn0: torch.Tensor, syn1: torch.Tensor,
            hs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
            inputs: torch.Tensor, targets: torch.Tensor, lr: float,
            valid: torch.Tensor) -> torch.Tensor:
    """One hierarchical-softmax step, in place on `syn0` and `syn1`;
    returns the batch loss (a device scalar).  `lr` is a float32 value
    (the caller rounds it)."""
    loss, aux = hs_deltas(syn0, syn1, hs, inputs, targets, valid)
    apply_deltas(syn0, syn1, lr, aux)
    return loss


def neg_deltas(syn0: torch.Tensor, syn1neg: torch.Tensor,
               inputs: torch.Tensor, targets: torch.Tensor,
               negs: torch.Tensor, valid: torch.Tensor):
    """The negative-sampling step's batch loss and its sparse pieces for
    `apply_deltas`, with the given negatives `negs` [B, K] (word
    indices); the output table's rows are the targets' first, then the
    negatives', as the JAX step orders them.  A negative equal to its
    pair's target is masked out.  No MAX_EXP clip: the reference's NEG
    loop clamps the sigmoid instead, which the exact sigmoid matches
    asymptotically."""
    h = syn0[inputs]                                     # [B, D]
    pos = syn1neg[targets]                               # [B, D]
    neg = syn1neg[negs]                                  # [B, K, D]
    pos_dot = torch.sum(h * pos, dim=1)
    neg_dot = torch.einsum("bd,bkd->bk", h, neg)
    v = valid.to(h.dtype)
    neg_mask = torch.where(negs == targets[:, None], 0.0, v[:, None])
    loss = -(torch.sum(F.logsigmoid(pos_dot) * v)
             + torch.sum(F.logsigmoid(-neg_dot) * neg_mask))
    g_pos = torch.sigmoid(-pos_dot) * v                  # [B]
    g_neg = -torch.sigmoid(neg_dot) * neg_mask           # [B, K]
    dh = g_pos[:, None] * pos + torch.einsum("bk,bkd->bd", g_neg, neg)
    dpos = g_pos[:, None] * h
    dneg = g_neg[:, :, None] * h[:, None, :]
    return loss, ((inputs, dh), (targets, dpos),
                  (negs.reshape(-1), dneg.reshape(-1, h.shape[1])))


def neg_step(syn0: torch.Tensor, syn1neg: torch.Tensor,
             inputs: torch.Tensor, targets: torch.Tensor,
             negs: torch.Tensor, lr: float,
             valid: torch.Tensor) -> torch.Tensor:
    """One negative-sampling step, in place on `syn0` and `syn1neg`;
    returns the batch loss."""
    loss, aux = neg_deltas(syn0, syn1neg, inputs, targets, negs, valid)
    apply_deltas(syn0, syn1neg, lr, aux)
    return loss


def decayed_lr(start: float, floor: float, seen: int, total: int) -> float:
    """Linear decay by pairs seen (reference `alpha` decay,
    Word2Vec.java:231-238), floored, rounded to float32 as the JAX package
    hands it to its step."""
    frac = min(seen / total, 1.0)
    return float(np.float32(max(start * (1 - frac), floor)))


class Word2Vec(WordVectors):
    """Skip-gram word embeddings (reference Word2Vec.java defaults:
    layerSize 100, window 5, alpha .025, minLearningRate 1e-2*alpha,
    negative sampling off → hierarchical softmax on).  Trains on `device`
    (the card unless ``device="cpu"``), over `mesh` when one is given."""

    def __init__(self,
                 vector_length: int = 100,
                 window: int = 5,
                 min_word_frequency: int = 1,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 negative: int = 0,
                 subsample: float = 0.0,
                 batch_size: int = 2048,
                 epochs: int = 1,
                 seed: int = 42,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 mesh=None,
                 device: DeviceLike = None):
        self.mesh = mesh  # shard the pair batches over its first axis
        if mesh is not None:
            batch_size = round_batch_to_mesh(batch_size, mesh)
        self.vector_length = vector_length
        self.window = window
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.subsample = subsample
        self.batch_size = batch_size
        self.epochs = epochs
        self.seed = seed
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        vocab = VocabCache(min_word_frequency=min_word_frequency)
        super().__init__(vocab, np.zeros((0, vector_length), np.float32),
                         device=device)
        self.syn1: Optional[np.ndarray] = None      # HS inner nodes
        self.syn1neg: Optional[np.ndarray] = None   # NEG output vectors
        self._hs = None  # (points, codes, lengths) on the device
        self._neg_table = None

    # ------------------------------------------------------------------
    # vocab + weights

    def _sentences_to_tokens(self, sentences) -> List[List[str]]:
        out = []
        for s in sentences:
            out.append(self.tokenizer.tokenize(s) if isinstance(s, str)
                       else list(s))
        return out

    def build_vocab(self, token_lists: Sequence[Sequence[str]]) -> None:
        self.vocab.fit(token_lists)
        if len(self.vocab) == 0:
            raise ValueError("empty vocabulary — corpus too small or "
                             "min_word_frequency too high")
        Huffman(self.vocab).build()

    def reset_weights(self) -> None:
        """syn0 uniform in [-.5,.5]/D, syn1 zeros — reference
        `InMemoryLookupTable.resetWeights():94-100`."""
        rng = np.random.default_rng(self.seed)
        V, D = len(self.vocab), self.vector_length
        self.syn0 = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
        self.syn1 = np.zeros((max(V - 1, 1), D), np.float32)
        if self.negative > 0:
            self.syn1neg = np.zeros((V, D), np.float32)
            self._neg_table = torch.from_numpy(
                build_negative_table(self.vocab)).to(self.device).long()
        self._hs = tuple(torch.from_numpy(a).to(self.device).long()
                         for a in self.vocab.hs_arrays())
        self._norms = None

    def _negatives(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """[n, negative] word indices: uniform draws into the unigram^0.75
        table by `gen` on the model's device."""
        idx = torch.randint(0, self._neg_table.shape[0], (n, self.negative),
                            generator=gen, device=self.device)
        return self._neg_table[idx]

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _step(self, syn0, out, inputs, targets, lr, valid, gen):
        """One step in place on the tables, over the mesh when there is
        one; returns its loss."""
        if self.negative > 0:
            step = sparse_allgather_step(
                self.mesh,
                lambda s0, s1, _lr, i, t, v, ng: neg_deltas(s0, s1, i, t,
                                                            ng, v),
                apply_deltas, n_state=2, n_scalar=1, n_sharded=4)
            *_, loss = step(syn0, out, lr, inputs, targets, valid,
                            self._negatives(gen, inputs.shape[0]))
            return loss
        step = sparse_allgather_step(
            self.mesh,
            lambda s0, s1, _lr, i, t, v: hs_deltas(
                s0, s1, tuple(a.to(s0.device) for a in self._hs), i, t, v),
            apply_deltas, n_state=2, n_scalar=1, n_sharded=3)
        *_, loss = step(syn0, out, lr, inputs, targets, valid)
        return loss

    def _tables_to_device(self):
        """Copies of syn0 and the output table (syn1 for HS, syn1neg for
        NEG) on the device, as float32 tensors."""
        out = self.syn1 if self.negative == 0 else self.syn1neg
        return (torch.tensor(self.syn0, device=self.device),
                torch.tensor(out, device=self.device))

    def _tables_from_device(self, syn0: torch.Tensor,
                            out: torch.Tensor) -> None:
        self.syn0 = syn0.cpu().numpy()
        if self.negative == 0:
            self.syn1 = out.cpu().numpy()
        else:
            self.syn1neg = out.cpu().numpy()
        self._norms = None

    # ------------------------------------------------------------------
    # pair generation (host side; reference skipGram():319)

    def _make_pairs(self, encoded: List[np.ndarray], rng: np.random.Generator
                    ) -> np.ndarray:
        """All (input=context, target=center) pairs for one epoch with the
        word2vec reduced-window trick; subsampling of frequent words if
        configured. Returns int32 [N, 2]; the same draws as the JAX
        package's."""
        total = self.vocab.total_word_count()
        keep_prob = None
        if self.subsample > 0:
            freq = np.array([self.vocab.word_frequency(self.vocab.word_at(i))
                             for i in range(len(self.vocab))], np.float64)
            ratio = freq / (self.subsample * total)
            keep_prob = np.minimum((np.sqrt(ratio) + 1) / ratio, 1.0)
        # one numpy pass per offset d in [1, window]: context j for center
        # i iff |j-i| <= window - b[i] within the sentence
        sents = [s for s in encoded if len(s)]
        if not sents:
            return np.zeros((0, 2), np.int32)
        flat = np.concatenate(sents).astype(np.int32)
        sid = np.repeat(np.arange(len(sents)), [len(s) for s in sents])
        if keep_prob is not None and len(flat):
            keep = rng.random(len(flat)) < keep_prob[flat]
            flat, sid = flat[keep], sid[keep]
        n = len(flat)
        if n < 2:
            return np.zeros((0, 2), np.int32)
        win = self.window - rng.integers(0, self.window, n)  # in [1, window]
        chunks = []
        for d in range(1, self.window + 1):
            left = np.arange(n - d)
            same = sid[left] == sid[left + d]
            # center=left, context=left+d — gated by LEFT's reduced window
            c = left[same & (d <= win[left])]
            chunks.append(np.stack([flat[c + d], flat[c]], axis=1))
            # center=left+d, context=left — gated by RIGHT's reduced window
            c = left[same & (d <= win[left + d])]
            chunks.append(np.stack([flat[c], flat[c + d]], axis=1))
        arr = np.concatenate(chunks, axis=0).astype(np.int32)
        if not len(arr):
            return np.zeros((0, 2), np.int32)
        # a permutation gather: rng.shuffle swaps 2-D rows one by one
        return arr[rng.permutation(len(arr))]

    # ------------------------------------------------------------------
    # fit (reference Word2Vec.fit():103)

    def _pair_producer(self, encoded, out_q) -> None:
        """Epoch pair arrays generated on a worker thread (numpy releases
        the GIL for the heavy ops) while the main thread dispatches steps;
        the 1-deep queue bounds host memory to one epoch ahead."""
        rng = np.random.default_rng(self.seed)
        try:
            for _ in range(self.epochs):
                out_q.put(("pairs", self._make_pairs(encoded, rng)))
            out_q.put(("done", None))
        except BaseException as e:  # noqa: BLE001 - re-raised by consumer
            out_q.put(("error", e))

    def _epoch_pairs(self, encoded):
        """(iterator over each epoch's pairs, producer thread or None).
        With a second core the pairs come from a producer thread; on one
        core inline.  Either way one rng generates the epochs in order, so
        the pairs and the tables are the same."""
        if (os.cpu_count() or 1) <= 1:
            def inline():
                rng = np.random.default_rng(self.seed)
                for _ in range(self.epochs):
                    yield self._make_pairs(encoded, rng)
            return inline(), None
        pair_q: "queue.Queue" = queue.Queue(maxsize=1)
        producer = threading.Thread(target=self._pair_producer,
                                    args=(encoded, pair_q), daemon=True)
        producer.start()

        def threaded():
            while True:
                kind, payload = pair_q.get()
                if kind == "error":
                    raise payload
                if kind == "done":
                    return
                yield payload
        return threaded(), producer

    def fit(self, sentences) -> "Word2Vec":
        token_lists = self._sentences_to_tokens(sentences)
        if len(self.vocab) == 0:
            self.build_vocab(token_lists)
        if self.syn0.shape[0] != len(self.vocab):
            self.reset_weights()
        encoded = [self.vocab.encode(t) for t in token_lists]
        gen = self._generator(self.seed)
        syn0, out = self._tables_to_device()
        dev, B = self.device, self.batch_size
        full_valid = torch.ones(B, device=dev)
        epochs, producer = self._epoch_pairs(encoded)
        total_pairs = None
        seen = 0
        for pairs in epochs:
            if total_pairs is None:
                total_pairs = max(len(pairs) * self.epochs, 1)
            n_batches = (len(pairs) + B - 1) // B  # 0 -> epoch skipped
            chunk_batches = max(1, STAGE_PAIRS // B)
            for c0 in range(0, n_batches, chunk_batches):
                c1 = min(c0 + chunk_batches, n_batches)
                part = pairs[c0 * B:c1 * B]
                padded = np.zeros(((c1 - c0) * B, 2), np.int32)
                padded[:len(part)] = part
                # [batches, 2, B]: each batch's inputs and targets contiguous
                chunk = torch.from_numpy(np.ascontiguousarray(
                    padded.reshape(c1 - c0, B, 2).transpose(0, 2, 1))
                ).to(dev).long()
                for bi in range(c1 - c0):
                    n_real = min(B, len(pairs) - (c0 + bi) * B)
                    valid = full_valid
                    if n_real < B:
                        valid = torch.zeros(B, device=dev)
                        valid[:n_real] = 1.0
                    lr = decayed_lr(self.learning_rate,
                                    self.min_learning_rate, seen,
                                    total_pairs)
                    self._step(syn0, out, chunk[bi, 0], chunk[bi, 1], lr,
                               valid, gen)
                    seen += n_real
        if producer is not None:
            producer.join()
        self._tables_from_device(syn0, out)
        return self

    # reference naming
    train = fit
