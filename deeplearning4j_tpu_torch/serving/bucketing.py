"""Shape bucketing for the serving path (counterpart of
`deeplearning4j_tpu.serving.bucketing`).

`BucketLadder` holds a short ascending list of batch buckets (default
1/8/32/128) and, for sequence models, a ladder of length buckets.  A
dispatch is padded UP to the next bucket, so any traffic runs a bounded
set of input shapes.  That bounds the programs `output_bucketed` builds,
one a signature (`MultiLayerNetwork.forward_program_count`), as it bounds
the JAX package's compiled XLA programs.  Padding never changes a
result: padded batch rows are computed and sliced away (inference rows
are independent), padded time steps are masked out per example.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

DEFAULT_BATCH_BUCKETS = (1, 8, 32, 128)


def pow2_length_buckets(max_len: int, min_len: int = 16) -> Tuple[int, ...]:
    """Powers of two from min_len up to (and including) max_len."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    out = []
    b = max(1, min_len)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class BucketLadder:
    """A fixed ladder of (batch[, length]) buckets.

    `batch_bucket(n)` / `length_bucket(t)` return the smallest bucket that
    fits; an oversize request raises.  `program_bound` is the most
    distinct dispatch shapes the ladder can produce."""

    def __init__(self,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 length_buckets: Optional[Sequence[int]] = None):
        self.batch_buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError(f"batch buckets must be positive ints, got "
                             f"{batch_buckets}")
        self.length_buckets = (None if length_buckets is None else
                               tuple(sorted(set(int(b)
                                                for b in length_buckets))))
        if self.length_buckets is not None and (
                not self.length_buckets or self.length_buckets[0] < 1):
            raise ValueError(f"length buckets must be positive ints, got "
                             f"{length_buckets}")

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    @property
    def program_bound(self) -> int:
        """Worst-case distinct dispatch shapes: |batch| x |length|."""
        return len(self.batch_buckets) * (len(self.length_buckets)
                                          if self.length_buckets else 1)

    def batch_bucket(self, n: int) -> int:
        """Smallest batch bucket >= n."""
        if n < 1:
            raise ValueError(f"batch must be >= 1, got {n}")
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(f"batch {n} exceeds the largest bucket "
                         f"{self.batch_buckets[-1]}; split the request or "
                         f"extend the ladder")

    def length_bucket(self, t: int) -> int:
        """Smallest length bucket >= t (requires a length ladder)."""
        if self.length_buckets is None:
            raise ValueError("this ladder has no length buckets")
        if t < 1:
            raise ValueError(f"length must be >= 1, got {t}")
        for b in self.length_buckets:
            if t <= b:
                return b
        raise ValueError(f"length {t} exceeds the largest bucket "
                         f"{self.length_buckets[-1]}")

    def pad_rows(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        """Zero-pad axis 0 up to the batch bucket: (padded, n_real)."""
        n = int(x.shape[0])
        b = self.batch_bucket(n)
        if b == n:
            return x, n
        pad = np.zeros((b - n,) + x.shape[1:], x.dtype)
        return np.concatenate([x, pad], axis=0), n

    def pad_length(self, x: np.ndarray,
                   mask: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Zero-pad axis 1 (time) of a [n, T, ...] batch up to the length
        bucket: (padded_x, mask [n, T_bucket] with 1.0 over real steps)."""
        t = int(x.shape[1])
        tb = self.length_bucket(t)
        if mask is None:
            mask = np.ones(x.shape[:2], np.float32)
        if tb == t:
            return x, mask
        pad_x = np.zeros((x.shape[0], tb - t) + x.shape[2:], x.dtype)
        pad_m = np.zeros((x.shape[0], tb - t), np.float32)
        return (np.concatenate([x, pad_x], axis=1),
                np.concatenate([mask, pad_m], axis=1))


__all__ = ["BucketLadder", "DEFAULT_BATCH_BUCKETS", "pow2_length_buckets"]
