"""GloVe: co-occurrence counting + weighted least squares embeddings
(counterpart of `deeplearning4j_tpu.nlp.glove`, single device).

Parity: reference `models/glove/Glove.java:60` (fit():109),
`CoOccurrences.java` (symmetric window counts weighted 1/distance) and
`GloveWeightLookupTable.java` (per-element AdaGrad on the weighted
least-squares objective, xMax=100, alpha=0.75).

Co-occurrence counting stays on the host (a numpy pass over the corpus);
training runs on the model's device as batched AdaGrad steps over
shuffled COO triples (i, j, X_ij): gathers, elementwise math and
``index_add_`` scatters of the touched rows (`glove_step`).  The four
tables (w, w-context, b, b-context) and their AdaGrad accumulators live
on the device from the start of training to its end; each minibatch's
loss stays there until its epoch ends.  ``mesh=`` shards each COO batch
over the mesh's first axis (`parallel.mesh.sparse_allgather_step`): each
shard's (row, gradient) entries are gathered in shard order and the
AdaGrad scatters applied once, as on one device; the batch size rounds
up to a multiple of the shards.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.nlp.word_vectors import WordVectors
from deeplearning4j_tpu_torch.parallel.mesh import (
    round_batch_to_mesh,
    sparse_allgather_step,
)

ADAGRAD_EPS = 1e-8


class CoOccurrences:
    """Symmetric windowed co-occurrence counts, weight 1/distance
    (reference CoOccurrences.java:357)."""

    def __init__(self, window: int = 15):
        self.window = window
        self.counts: Dict[Tuple[int, int], float] = defaultdict(float)

    def fit(self, encoded: Sequence[np.ndarray]) -> "CoOccurrences":
        """One numpy pass per offset d (weight 1/d, both directions);
        weighted counts aggregate via np.unique on packed (row, col)
        keys."""
        sents = [np.asarray(s, np.int64) for s in encoded if len(s)]
        if not sents:
            return self
        flat = np.concatenate(sents)
        sid = np.repeat(np.arange(len(sents)), [len(s) for s in sents])
        n = len(flat)
        vmax = int(flat.max()) + 1
        longest = max(len(s) for s in sents)
        # Aggregate per offset (peak memory O(n), not O(window*n)); cap d
        # at the longest sentence — larger offsets can never match.
        for d in range(1, min(self.window, longest - 1) + 1):
            left = np.arange(n - d)
            ok = sid[left] == sid[left + d]
            a, b = flat[left + d][ok], flat[left][ok]   # (later, earlier)
            if not len(a):
                continue
            packed = np.concatenate([a * vmax + b, b * vmax + a])
            uniq, inv = np.unique(packed, return_inverse=True)
            sums = np.bincount(inv, minlength=len(uniq)) / d
            for key, total in zip(uniq, sums):
                self.counts[(int(key // vmax),
                             int(key % vmax))] += float(total)
        return self

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self.counts:
            return (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
        items = list(self.counts.items())
        ij = np.asarray([k for k, _ in items], np.int32)
        x = np.asarray([v for _, v in items], np.float32)
        return ij[:, 0], ij[:, 1], x


def glove_step(params: Tuple[torch.Tensor, ...],
               adagrad: Tuple[torch.Tensor, ...], ii: torch.Tensor,
               jj: torch.Tensor, xx: torch.Tensor, valid: torch.Tensor,
               lr: float, x_max: float, alpha: float) -> torch.Tensor:
    """One sparse AdaGrad step of the weighted least-squares objective, in
    place on `params` (w, wc, b, bc) and `adagrad`; returns the batch loss.
    Per-entry gradients are closed-form for the touched rows.  Each
    table's accumulator takes the whole batch's g² first; every entry then
    divides by the square root of its row's accumulator gathered after
    that scatter; then the parameter update is scattered.  `valid` zeroes
    padded entries (whose indices are real rows)."""
    loss, aux = glove_deltas(params, adagrad, ii, jj, xx, valid, x_max,
                             alpha)
    glove_apply(params, adagrad, aux, lr)
    return loss


def glove_deltas(params, adagrad, ii, jj, xx, valid, x_max: float,
                 alpha: float):
    """The batch loss and the per-entry gradients of the touched rows,
    with their rows: (ii, jj, (d/dw[ii], d/dwc[jj], d/db, d/dbc))."""
    w, wc, b, bc = params
    diff = torch.sum(w[ii] * wc[jj], dim=1) + b[ii] + bc[jj] - torch.log(xx)
    fx = torch.clamp((xx / x_max) ** alpha, max=1.0)
    e = valid * fx * diff                               # [B]
    loss = 0.5 * torch.sum(e * diff)                    # valid^2 == valid
    return loss, (ii, jj, (e[:, None] * wc[jj], e[:, None] * w[ii], e, e))


def glove_apply(params, adagrad, aux, lr: float):
    """The AdaGrad scatters of `glove_deltas`' entries, in place: each
    accumulator first, then the update divided by its root."""
    ii, jj, grads = aux
    for p, h, r, g in zip(params, adagrad, (ii, jj, ii, jj), grads):
        h.index_add_(0, r, g * g)
        p.index_add_(0, r, -lr * g / torch.sqrt(h[r] + ADAGRAD_EPS))
    return params, adagrad


class Glove(WordVectors):
    """GloVe embeddings (reference defaults: xMax=100, alpha=0.75,
    learning rate 0.05 AdaGrad).  Trains on `device` (the card unless
    ``device="cpu"``), over `mesh` when one is given."""

    def __init__(self,
                 vector_length: int = 100,
                 window: int = 15,
                 min_word_frequency: int = 1,
                 learning_rate: float = 0.05,
                 x_max: float = 100.0,
                 alpha: float = 0.75,
                 batch_size: int = 4096,
                 epochs: int = 25,
                 seed: int = 42,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 mesh=None,
                 device: DeviceLike = None):
        self.mesh = mesh  # shard the COO batches over its first axis
        if mesh is not None:
            batch_size = round_batch_to_mesh(batch_size, mesh)
        self.window = window
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.epochs = epochs
        self.seed = seed
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        super().__init__(VocabCache(min_word_frequency=min_word_frequency),
                         np.zeros((0, vector_length), np.float32),
                         device=device)
        self.vector_length = vector_length
        self._params: Optional[Tuple[torch.Tensor, ...]] = None

    def _tokenize_all(self, sentences):
        return [self.tokenizer.tokenize(s) if isinstance(s, str)
                else list(s) for s in sentences]

    def _init_params(self) -> None:
        V, D = len(self.vocab), self.vector_length
        rng = np.random.default_rng(self.seed)
        self._params = tuple(torch.from_numpy(a).to(self.device) for a in (
            (rng.random((V, D)) - 0.5).astype(np.float32) / D,   # w
            (rng.random((V, D)) - 0.5).astype(np.float32) / D,   # w-context
            np.zeros(V, np.float32),                             # b
            np.zeros(V, np.float32)))                            # b-context
        self._adagrad = tuple(torch.zeros_like(p) for p in self._params)

    def _train(self, ii, jj, xx, epochs: int, rng) -> List[float]:
        dev, B = self.device, self.batch_size
        order = np.arange(len(xx))
        ii, jj, xx = (torch.from_numpy(a).to(dev) for a in (ii, jj, xx))
        ii, jj = ii.long(), jj.long()
        n_batches = (len(order) + B - 1) // B
        full_valid = torch.ones(B, device=dev)
        tail_valid = torch.zeros(B, device=dev)
        tail_valid[:len(order) - (n_batches - 1) * B] = 1.0
        losses = []
        for _ in range(epochs):
            rng.shuffle(order)
            # the tail batch is padded with the epoch's first entries, as
            # the JAX package pads it; the epoch's order goes to the device
            # in one copy
            pad = np.arange(n_batches * B - len(order)) % len(order)
            sel_all = torch.from_numpy(
                np.concatenate([order, order[pad]])).to(dev)
            # every minibatch loss stays on the device; one read an epoch,
            # summed on the host in float64 as the JAX package sums them
            epoch_losses = []
            for bi in range(n_batches):
                sel = sel_all[bi * B:(bi + 1) * B]
                last = bi == n_batches - 1
                epoch_losses.append(self._step(
                    ii[sel], jj[sel], xx[sel],
                    tail_valid if last else full_valid))
            losses.append(sum(torch.stack(epoch_losses).cpu().double()
                              .tolist()))
        self._refresh_syn0()
        return losses

    def _step(self, ii, jj, xx, valid) -> torch.Tensor:
        """One AdaGrad step on the batch, over the mesh when there is one;
        returns its loss."""
        step = sparse_allgather_step(
            self.mesh,
            lambda p, h, i, j, x, v: glove_deltas(p, h, i, j, x, v,
                                                  self.x_max, self.alpha),
            lambda p, h, aux: glove_apply(p, h, aux, self.learning_rate),
            n_state=2, n_sharded=4)
        *_, loss = step(self._params, self._adagrad, ii, jj, xx, valid)
        return loss

    def _refresh_syn0(self) -> None:
        w, wc = (p.cpu().numpy() for p in self._params[:2])
        self.syn0 = (w + wc).astype(np.float32)  # GloVe paper: sum both sets
        self._norms = None

    def fit(self, sentences) -> "Glove":
        token_lists = self._tokenize_all(sentences)
        if len(self.vocab) == 0:
            self.vocab.fit(token_lists)
        if len(self.vocab) == 0:
            raise ValueError("empty vocabulary")
        encoded = [self.vocab.encode(t) for t in token_lists]
        ii, jj, xx = CoOccurrences(self.window).fit(encoded).to_coo()
        if len(xx) == 0:
            raise ValueError("no co-occurrences — corpus too small")
        self._init_params()
        self.losses = self._train(ii, jj, xx, self.epochs,
                                  np.random.default_rng(self.seed))
        return self

    def partial_fit(self, sentences, epochs: int = 1) -> "Glove":
        """Continue AdaGrad training on one sentence batch against the
        CURRENT weights (vocab must already be built) — the incremental
        unit a distributed GlovePerformer executes per job."""
        if len(self.vocab) == 0:
            raise ValueError("build vocab first (call fit once)")
        if self._params is None:
            self._init_params()
        encoded = [self.vocab.encode(t)
                   for t in self._tokenize_all(sentences)]
        ii, jj, xx = CoOccurrences(self.window).fit(encoded).to_coo()
        if len(xx) == 0:
            return self
        self._train(ii, jj, xx, epochs, np.random.default_rng(self.seed))
        return self

    train = fit
