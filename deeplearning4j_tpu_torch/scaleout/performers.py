"""Worker performers: what a worker does with a job (counterpart of
`deeplearning4j_tpu.scaleout.performers`).

Parity: reference `NeuralNetWorkPerformer` (Akka runtime: build net from
conf JSON, set master params, fit job's DataSet, emit params — same contract
as Spark's `IterativeReduceFlatMap.java:61-81`) and
`scaleout/perform/models/word2vec/Word2VecPerformer.java:50` (train a
sentence batch, emit embedding deltas).

A replica trains on its model's device (the card unless the caller asks
for the CPU); what it publishes, and what it installs, are host numpy
trees.  The port's training updates parameters in place, and on the CPU
a tensor's ``numpy()`` is a view of it, so every published result is a
copy and every installed state is copied in: a result never changes
under the aggregator, and the one tree the master broadcasts to every
replica is never written.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike
from deeplearning4j_tpu_torch.scaleout.api import Job, WorkerPerformer


def _host_copy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def host_params(params) -> list:
    """A network's parameter tree as host float32 numpy copies: a list of
    per-layer dicts with the JAX package's keys."""
    return [{k: _host_copy(v.float()) for k, v in layer.items()}
            for layer in params]


class NetworkPerformer(WorkerPerformer):
    """Trains a MultiLayerNetwork replica on the job's (x, y) batch.

    Ships the model as (conf-JSON, params) exactly like the reference's
    universal format (`MultiLayerNetwork.java:97-101`): every worker
    constructs its replica from JSON on `device`, installs the master's
    params in `update()`, fits, and returns host copies of its params for
    averaging.
    """

    def __init__(self, conf_json: str, epochs: int = 1,
                 device: DeviceLike = None):
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork

        self.net = MultiLayerNetwork.from_json(conf_json, device=device)
        self.epochs = epochs

    def perform(self, job: Job) -> None:
        x, y = job.work
        for _ in range(self.epochs):
            self.net.fit_batch(x, y)
        # Publish HOST copies: the next fit_batch updates the live
        # tensors in place (a CPU tensor's numpy() is a view of them),
        # and the TCP tracker's allowlist refuses torch tensors.
        job.result = host_params(self.net.params)
        job.done = True

    def update(self, state: Any) -> None:
        if state is not None:
            from deeplearning4j_tpu_torch.models import params_from_numpy

            # Fresh tensors per replica: the tracker broadcasts ONE
            # averaged tree to every performer, and training writes the
            # installed parameters in place; params_from_numpy copies.
            self.net.params = params_from_numpy(self.net, state)


class Word2VecPerformer(WorkerPerformer):
    """Trains a Word2Vec replica on a batch of sentences; the result is the
    (syn0, out) DELTA vs the round's starting weights, so the master can
    fold every worker's contribution (DeltaSumAggregator) — the reference's
    Word2VecChange collection (SURVEY §3.4).  The tables are host numpy
    arrays; each fit trains copies of them on the model's device."""

    def __init__(self, word2vec):
        self.w2v = word2vec
        if self.w2v.syn0 is None or not len(self.w2v.syn0):
            raise ValueError("word2vec must have built vocab + weights")

    def perform(self, job: Job) -> None:
        w2v = self.w2v
        start_syn0 = w2v.syn0.copy()
        out_name = "syn1" if w2v.negative == 0 else "syn1neg"
        start_out = getattr(w2v, out_name).copy()
        w2v.fit(job.work)
        job.result = {
            "syn0": w2v.syn0 - start_syn0,
            out_name: getattr(w2v, out_name) - start_out,
        }
        # restore: deltas are applied by the master's aggregate broadcast
        w2v.syn0 = start_syn0
        setattr(w2v, out_name, start_out)
        job.done = True

    def update(self, state: Optional[dict]) -> None:
        if not state:
            return
        w2v = self.w2v
        w2v.syn0 = w2v.syn0 + state["syn0"]
        out_name = "syn1" if w2v.negative == 0 else "syn1neg"
        setattr(w2v, out_name, getattr(w2v, out_name) + state[out_name])
        # the cosine scan's normalised matrix, and its device copy
        w2v._norms = None
        w2v._norms_dev = None


class GlovePerformer(WorkerPerformer):
    """Trains a GloVe replica on a batch of sentences; the result is the
    DELTA of the (w, w-context, b, b-context) tables vs the round's start,
    folded by DeltaSumAggregator — the reference's GloveChange collection
    (`scaleout/perform/models/glove/GlovePerformer.java:229`,
    GloveChange tracked per-word weight + bias deltas).  The tables live
    on the model's device; deltas are host numpy arrays."""

    KEYS = ("w", "wc", "b", "bc")

    def __init__(self, glove, epochs: int = 1):
        self.glove = glove
        self.epochs = epochs
        if len(glove.vocab) == 0:
            raise ValueError("glove must have a built vocab + weights "
                             "(fit on a seed corpus first)")
        if getattr(glove, "_params", None) is None:
            glove._init_params()

    def perform(self, job: Job) -> None:
        g = self.glove
        start = tuple(_host_copy(p) for p in g._params)
        g.partial_fit(job.work, epochs=self.epochs)
        job.result = {k: _host_copy(p) - s for k, p, s
                      in zip(self.KEYS, g._params, start)}
        # restore: deltas are applied by the master's aggregate broadcast
        # (the AdaGrad accumulators keep this job's squares, as in the
        # JAX package)
        g._params = tuple(torch.from_numpy(s).to(g.device) for s in start)
        g._refresh_syn0()
        job.done = True

    def update(self, state: Optional[dict]) -> None:
        if not state:
            return
        g = self.glove
        g._params = tuple(
            torch.from_numpy(_host_copy(p) + np.asarray(state[k])).to(
                g.device) for k, p in zip(self.KEYS, g._params))
        g._refresh_syn0()
