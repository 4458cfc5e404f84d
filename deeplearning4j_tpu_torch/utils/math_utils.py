"""Numeric helpers (counterpart of `deeplearning4j_tpu.utils.math_utils`;
a copy: numpy and the standard library only).

Parity: the used surface of reference `util/MathUtils.java` (1,293 LoC —
sigmoid, log2, entropy/information gain, normalization, correlation,
distances, ssq, uniform sampling, bernoulli likelihood). numpy-vectorized
instead of the reference's per-element Java loops.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

SMALL = 1e-6


def sigmoid(x):
    x = np.asarray(x, np.float64)
    return 1.0 / (1.0 + np.exp(-x))


def log2(x) -> np.ndarray:
    return np.log2(np.asarray(x, np.float64))


def entropy(probs: Sequence[float]) -> float:
    """Shannon entropy in bits; zeros contribute nothing."""
    p = np.asarray(probs, np.float64)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def information_gain(parent: Sequence[float],
                     splits: Sequence[Sequence[float]],
                     weights: Sequence[float]) -> float:
    """entropy(parent) - sum_i w_i * entropy(split_i)."""
    gain = entropy(parent)
    for w, s in zip(weights, splits):
        gain -= w * entropy(s)
    return float(gain)


def normalize(values, new_min: float = 0.0, new_max: float = 1.0):
    v = np.asarray(values, np.float64)
    lo, hi = v.min(), v.max()
    if hi == lo:
        return np.full_like(v, (new_min + new_max) / 2.0)
    return (v - lo) / (hi - lo) * (new_max - new_min) + new_min


def correlation(a, b) -> float:
    """Pearson correlation coefficient."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ac, bc = a - a.mean(), b - b.mean()
    denom = math.sqrt(float((ac * ac).sum() * (bc * bc).sum()))
    if denom == 0:
        return 0.0
    return float((ac * bc).sum() / denom)


def cosine_similarity(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(a @ b / (na * nb))


def euclidean_distance(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64)))


def manhattan_distance(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).sum())


def ssq(values) -> float:
    v = np.asarray(values, np.float64)
    return float((v * v).sum())


def uniform(rng: np.random.Generator, lo: float, hi: float) -> float:
    return float(rng.random() * (hi - lo) + lo)


def bernoulli_log_likelihood(targets, probs) -> float:
    """sum t*log(p) + (1-t)*log(1-p), clipped away from 0/1."""
    t = np.asarray(targets, np.float64)
    p = np.clip(np.asarray(probs, np.float64), SMALL, 1.0 - SMALL)
    return float((t * np.log(p) + (1 - t) * np.log(1 - p)).sum())
