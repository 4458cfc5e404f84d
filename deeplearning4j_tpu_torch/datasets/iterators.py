"""DataSet iterators (counterpart of
`deeplearning4j_tpu.datasets.iterators`, unchanged).

Parity: reference `datasets/iterator/DataSetIterator.java:53` +
`BaseDatasetIterator`, and the wrapper iterators (`MultipleEpochsIterator`,
`SamplingDataSetIterator`, `ReconstructionDataSetIterator`).  Iterators
yield fixed-shape batches: a short final batch is padded to the batch
size by wrapping around to the epoch's first examples (so those examples
carry slightly more weight that epoch), or dropped with
``drop_last=True``."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Base protocol: python-iterable of DataSet batches + reset()."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:  # re-shuffle / rewind; default no-op
        pass

    def batch_size(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> int:
        raise NotImplementedError


class ArrayDataSetIterator(DataSetIterator):
    """In-memory iterator over arrays (the workhorse, reference
    BaseDatasetIterator)."""

    def __init__(self, features, labels, batch: int, *, mask=None,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.data = DataSet(features, labels, mask)
        self.batch = batch
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __iter__(self) -> Iterator[DataSet]:
        ds = self.data
        if self.shuffle:
            ds = ds.shuffle(self.seed + self._epoch)
        n = ds.num_examples()
        for i in range(0, n, self.batch):
            j = min(i + self.batch, n)
            if j - i < self.batch:
                if self.drop_last or j - i == 0:
                    break
                # Pad to batch size with wraparound so shapes stay static.
                idx = np.concatenate(
                    [np.arange(i, j), np.arange(0, self.batch - (j - i))])
                yield ds._take(idx)
            else:
                yield ds._take(np.arange(i, j))

    def reset(self) -> None:
        self._epoch += 1

    def batch_size(self) -> int:
        return self.batch

    def total_examples(self) -> int:
        return self.data.num_examples()


class MultipleEpochsIterator(DataSetIterator):
    """Replays an underlying iterator N times (reference
    MultipleEpochsIterator)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self.epochs = epochs
        self.base = base

    def __iter__(self):
        for _ in range(self.epochs):
            yield from self.base
            self.base.reset()

    def reset(self):
        self.base.reset()

    def batch_size(self):
        return self.base.batch_size()

    def total_examples(self):
        return self.epochs * self.base.total_examples()


class SamplingDataSetIterator(DataSetIterator):
    """Random with-replacement sampling of batches (reference
    SamplingDataSetIterator)."""

    def __init__(self, data: DataSet, batch: int, num_batches: int, seed: int = 0):
        self.data = data
        self.batch = batch
        self.num_batches = num_batches
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        for _ in range(self.num_batches):
            idx = self.rng.integers(0, self.data.num_examples(), self.batch)
            yield self.data._take(idx)

    def batch_size(self):
        return self.batch

    def total_examples(self):
        return self.batch * self.num_batches


class ReconstructionDataSetIterator(DataSetIterator):
    """Wraps an iterator, setting each batch's labels to its features —
    the autoencoder/RBM pretraining feed (reference
    ReconstructionDataSetIterator.java:30, whose ``next()`` does
    ``ret.setLabels(ret.getFeatureMatrix())``)."""

    def __init__(self, base: DataSetIterator):
        self.base = base

    def __iter__(self) -> Iterator[DataSet]:
        for ds in self.base:
            yield DataSet(ds.features, ds.features, ds.mask)

    def reset(self):
        self.base.reset()

    def batch_size(self):
        return self.base.batch_size()

    def total_examples(self):
        return self.base.total_examples()


class PrefetchDataSetIterator(DataSetIterator):
    """Background-thread prefetch over any DataSetIterator: batch b+1 is
    prepared on a host thread while the device trains on batch b, behind
    a bounded queue (the reference's async fetcher / queue pattern,
    BaseDataFetcher + DiskBasedQueue).  ``transform`` runs on the
    producer thread before an item is queued (for example a copy to the
    device)."""

    _DONE = object()

    def __init__(self, base: DataSetIterator, depth: int = 2,
                 transform=None):
        import queue as _queue
        import threading as _threading

        self.base = base
        self.depth = max(1, depth)
        self.transform = transform
        self._queue_mod = _queue
        self._threading = _threading

    def __iter__(self):
        q = self._queue_mod.Queue(maxsize=self.depth)
        errors = []
        stop = self._threading.Event()
        full_exc = self._queue_mod.Full

        def put_until_stopped(item) -> bool:
            # A plain q.put would block FOREVER if the consumer abandons
            # the generator mid-epoch (exception in the training loop):
            # poll the stop flag so the producer always exits.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except full_exc:
                    continue
            return False

        def producer():
            try:
                for item in self.base:
                    if self.transform is not None:
                        item = self.transform(item)
                    if not put_until_stopped(item):
                        return
            except Exception as e:  # noqa: BLE001 — re-raise on consumer side
                errors.append(e)
            finally:
                put_until_stopped(self._DONE)

        t = self._threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
        if errors:
            raise errors[0]

    def reset(self):
        self.base.reset()

    def batch_size(self):
        return self.base.batch_size()

    def total_examples(self):
        return self.base.total_examples()


class BucketedSequenceIterator(DataSetIterator):
    """Length-bucketed batching for variable-length sequences: sequences
    are grouped into length buckets (boundaries default to powers of two),
    padded only to the bucket's ceiling, and emitted as [batch, T_bucket,
    ...] DataSets with [batch, T] masks, so padding waste stays bounded.

    sequences: list of [T_i, F] float arrays; labels: list of matching
    [T_i, C] (per-step) or [C] (per-sequence) arrays.
    """

    def __init__(self, sequences, labels, batch_size: int = 32,
                 boundaries=None, seed: int = 0,
                 drop_remainder: bool = False):
        if len(sequences) != len(labels):
            raise ValueError("sequences and labels must align")
        if not sequences:
            raise ValueError("no sequences")
        self.sequences = [np.asarray(s, np.float32) for s in sequences]
        self.labels = [np.asarray(y, np.float32) for y in labels]
        self.batch = batch_size
        self.drop_remainder = drop_remainder
        self.seed = seed
        self._epoch = 0
        max_len = max(len(s) for s in self.sequences)
        if boundaries is None:
            boundaries, b = [], 8
            while b < max_len:
                boundaries.append(b)
                b *= 2
        self.boundaries = sorted(set(list(boundaries) + [max_len]))

    def _bucket_of(self, n: int) -> int:
        for b in self.boundaries:
            if n <= b:
                return b
        return self.boundaries[-1]

    def __iter__(self):
        # Module contract (see ArrayDataSetIterator): __iter__ is
        # idempotent — re-iterating without reset() replays the same
        # shuffle; reset() advances to the next epoch's shuffle.
        rng = np.random.default_rng(self.seed + self._epoch)
        buckets = {}
        for i, s in enumerate(self.sequences):
            buckets.setdefault(self._bucket_of(len(s)), []).append(i)
        order = []
        for bound in sorted(buckets):
            idx = np.asarray(buckets[bound])
            rng.shuffle(idx)
            for k in range(0, len(idx), self.batch):
                sel = idx[k:k + self.batch]
                if len(sel) < self.batch:
                    if self.drop_remainder:
                        continue
                    # Pad to batch size with wraparound from the same
                    # bucket (module convention, see ArrayDataSetIterator)
                    # so shapes stay static.
                    sel = np.concatenate(
                        [sel, idx[np.arange(self.batch - len(sel))
                                  % len(idx)]])
                order.append((bound, sel))
        rng.shuffle(order)
        for bound, sel in order:
            n = len(sel)
            feat_dim = self.sequences[sel[0]].shape[1:]
            x = np.zeros((n, bound) + feat_dim, np.float32)
            mask = np.zeros((n, bound), np.float32)
            per_step = self.labels[sel[0]].ndim > 1
            if per_step:
                y = np.zeros((n, bound) + self.labels[sel[0]].shape[1:],
                             np.float32)
            else:
                y = np.zeros((n,) + self.labels[sel[0]].shape, np.float32)
            for row, i in enumerate(sel):
                t = len(self.sequences[i])
                x[row, :t] = self.sequences[i]
                mask[row, :t] = 1.0
                if per_step:
                    y[row, :t] = self.labels[i]
                else:
                    y[row] = self.labels[i]
            yield DataSet(x, y, mask=mask)

    def reset(self) -> None:
        self._epoch += 1  # next epoch's shuffle (ArrayDataSetIterator parity)

    def batch_size(self) -> int:
        return self.batch

    def total_examples(self) -> int:
        return len(self.sequences)
