"""Fused multi-step training driver: K optimizer steps a dispatch
(counterpart of `deeplearning4j_tpu.runtime.fused`).

- :func:`assemble_chunks` groups an (x, y, mask) batch stream into
  ``[K, B, ...]`` stacks.  A ragged tail batch is padded to the group's
  batch size with zero rows and zero example weights instead of changing
  shape, so every chunk of a stream has one of two shapes per batch
  shape: ``[K, ...]`` and ``[1, ...]``.
- :class:`FusedTrainingDriver` pipelines the assembler (host), a staging
  stage on `PrefetchDataSetIterator` that moves chunk i+1 to the device
  on a background thread (the runner's `stage_chunk`) while chunk i
  trains, and the runner's `fit_chunk_async`.
- the runner protocol: any object with ``fit_chunk_async(xs, ys, masks,
  weights, unroll) -> (losses, grad_norms)`` and ``stage_chunk(chunk)``;
  `MultiLayerNetwork` and the synchronous `DataParallelTrainer`
  implement it (the trainer cuts each step's batch over its shards).

In the JAX package a chunk is one `lax.scan` program.  In the port it is
K eager steps of the same per-step code, each with the per-iteration
generator of the unchunked step, returning the losses and gradient
norms as ``[K]`` device tensors with at most one host read a chunk (for
due listeners).  So ``chunk_size=1`` and ``chunk_size=K`` run identical
steps on identical data: bitwise-equal parameters on the CPU.  Under a
loss-scaled precision policy the scaler state rides across the chunk,
so a poison batch skips only its own step.  Chunk assembly keeps the
dtype the pipeline fed.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np


class HostChunk(NamedTuple):
    """One assembled chunk: `steps` stacked batches (leading dim = steps
    a dispatch).  ``weights[k, b] == 0`` marks a padded tail row that
    contributes nothing to step k's update.  `stage_chunk` returns the
    same tuple with tensors on the device."""

    xs: np.ndarray                    # [K, B, ...features]
    ys: np.ndarray                    # [K, B, ...labels]
    weights: np.ndarray               # [K, B] float32 example weights
    masks: Optional[np.ndarray]       # [K, B, T] or None

    @property
    def steps(self) -> int:
        return int(self.xs.shape[0])


def _stack(items, pad_b: int) -> HostChunk:
    x0, y0, m0 = items[0]
    k = len(items)
    xs = np.zeros((k, pad_b) + x0.shape[1:], x0.dtype)
    ys = np.zeros((k, pad_b) + y0.shape[1:], y0.dtype)
    ws = np.zeros((k, pad_b), np.float32)
    ms = (None if m0 is None
          else np.zeros((k, pad_b) + m0.shape[1:], np.float32))
    for i, (x, y, m) in enumerate(items):
        n = x.shape[0]
        xs[i, :n] = x
        ys[i, :n] = y
        ws[i, :n] = 1.0
        if ms is not None:
            ms[i, :n] = m
    return HostChunk(xs, ys, ws, ms)


def stack_batches(batches) -> HostChunk:
    """Stack a list of (x, y, mask) batches into one HostChunk, padding
    ragged batches to the largest batch size."""
    norm = [(np.asarray(x), np.asarray(y),
             None if m is None else np.asarray(m)) for x, y, m in batches]
    return _stack(norm, max(x.shape[0] for x, _, _ in norm))


def assemble_chunks(batches: Iterable[Tuple], chunk_size: int
                    ) -> Iterable[HostChunk]:
    """Group an (x, y, mask) stream into :class:`HostChunk`s.

    - The first batch of a group fixes the group's batch size; smaller
      (tail) batches are padded to it with zero rows + zero weights.
    - A feature-shape change, a mask-presence change or a LARGER batch
      flushes the open group and starts a new one.
    - A group holding fewer than `chunk_size` batches (end of stream,
      shape flush) is emitted as length-1 chunks, so the chunk shapes per
      batch shape are ``[chunk_size, ...]`` and ``[1, ...]`` however
      epochs divide.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    buf: list = []
    key = None
    pad_b = 0

    def flush():
        out = []
        if len(buf) == chunk_size:
            out.append(_stack(buf, pad_b))
        else:
            out.extend(_stack([b], pad_b) for b in buf)
        buf.clear()
        return out

    for batch in batches:
        if isinstance(batch, tuple):
            x, y, m = (batch + (None,))[:3]
        else:  # DataSet-like
            x, y, m = (batch.features, batch.labels,
                       getattr(batch, "mask", None))
        x = np.asarray(x)
        y = np.asarray(y)
        m = None if m is None else np.asarray(m)
        k = (x.shape[1:], y.shape[1:], None if m is None else m.shape[1:])
        if key is None:
            key, pad_b = k, x.shape[0]
        if k != key or x.shape[0] > pad_b:
            yield from flush()
            key, pad_b = k, x.shape[0]
        buf.append((x, y, m))
        if len(buf) == chunk_size:
            yield from flush()
    yield from flush()


class FusedTrainingDriver:
    """Drives a runner's `fit_chunk_async` over a batch stream.

    `prefetch > 0` stages the next chunk on the device from a background
    thread while the current chunk trains.  `unroll` is passed to the
    runner (the JAX scan's unroll factor; the port's eager chunk runs
    its steps one after another either way)."""

    def __init__(self, runner, chunk_size: int = 8, prefetch: int = 2,
                 unroll: int = 1):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.runner = runner
        self.chunk_size = int(chunk_size)
        self.prefetch = int(prefetch)
        self.unroll = max(1, int(unroll))

    def _stream(self, data, epochs: int):
        from deeplearning4j_tpu_torch.models.multi_layer_network import (
            _as_batches,
            _maybe_reset,
        )

        for _ in range(epochs):
            yield from _as_batches(data)
            _maybe_reset(data)

    def fit(self, data, epochs: int = 1):
        """Train over `data` (the forms `MultiLayerNetwork.fit` takes)
        with `chunk_size` steps a dispatch; waits for the last chunk."""
        import types

        import torch

        if isinstance(data, types.GeneratorType) and epochs != 1:
            raise ValueError(
                "one-shot generators cannot replay across epochs; "
                "materialize the batches or pass an iterator with reset()")
        chunks = assemble_chunks(self._stream(data, epochs),
                                 self.chunk_size)
        if self.prefetch > 0:
            from deeplearning4j_tpu_torch.datasets.iterators import (
                PrefetchDataSetIterator,
            )

            staged = PrefetchDataSetIterator(
                chunks, depth=self.prefetch,
                transform=self.runner.stage_chunk)
        else:
            staged = (self.runner.stage_chunk(c) for c in chunks)
        last = None
        for chunk in staged:
            last = self.runner.fit_chunk_async(
                chunk.xs, chunk.ys, chunk.masks, chunk.weights,
                unroll=self.unroll)
        if last is not None and last[0].is_cuda:
            torch.cuda.synchronize(last[0].device)
        return self.runner


__all__ = ["FusedTrainingDriver", "HostChunk", "assemble_chunks",
           "stack_batches"]
