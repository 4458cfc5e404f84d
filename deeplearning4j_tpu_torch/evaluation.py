"""Classification evaluation: confusion matrix, precision/recall/F1/accuracy
(counterpart of `deeplearning4j_tpu.evaluation`, unchanged).

Parity: reference `eval/Evaluation.java:36` (eval(real,guess) :67 argmax +
confusion update; stats() :149; precision/recall/f1/accuracy :177-267) and
`eval/ConfusionMatrix.java` (generic counts). Host-side numpy — metrics are
bookkeeping, not device work.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np


class ConfusionMatrix:
    """Generic confusion counts keyed by (actual, predicted)."""

    def __init__(self, classes: Optional[Sequence[int]] = None):
        self.counts: Dict[int, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
        self.classes: set = set(classes or [])

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.counts[actual][predicted] += count
        self.classes.add(actual)
        self.classes.add(predicted)

    def count(self, actual: int, predicted: int) -> int:
        return self.counts[actual][predicted]

    def actual_total(self, actual: int) -> int:
        return sum(self.counts[actual].values())

    def predicted_total(self, predicted: int) -> int:
        return sum(row[predicted] for row in self.counts.values())

    def to_array(self) -> np.ndarray:
        classes = sorted(self.classes)
        idx = {c: i for i, c in enumerate(classes)}
        arr = np.zeros((len(classes), len(classes)), dtype=np.int64)
        for a, row in self.counts.items():
            for p, n in row.items():
                arr[idx[a], idx[p]] = n
        return arr

    def __str__(self) -> str:
        classes = sorted(self.classes)
        arr = self.to_array()
        header = "      " + " ".join(f"{c:>6}" for c in classes)
        rows = [header] + [
            f"{c:>6}" + " ".join(f"{arr[i, j]:>6}" for j in range(len(classes)))
            for i, c in enumerate(classes)
        ]
        return "\n".join(rows)


class Evaluation:
    """Accumulating classifier evaluation over (one-hot or index) labels."""

    def __init__(self, num_classes: Optional[int] = None):
        self.confusion = ConfusionMatrix(range(num_classes) if num_classes else None)
        self.examples = 0

    def eval(self, labels: np.ndarray, predictions: np.ndarray) -> None:
        """labels/predictions: [batch, num_classes] scores or [batch] indices
        (reference eval(realOutcomes, guesses) :67)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        actual = labels.argmax(-1) if labels.ndim > 1 else labels.astype(int)
        guess = predictions.argmax(-1) if predictions.ndim > 1 else predictions.astype(int)
        for a, g in zip(actual.reshape(-1), guess.reshape(-1)):
            self.confusion.add(int(a), int(g))
        self.examples += actual.size

    # ---- metrics ----------------------------------------------------------

    def true_positives(self, cls: int) -> int:
        return self.confusion.count(cls, cls)

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is None:
            vals = [self.precision(c) for c in sorted(self.confusion.classes)]
            return float(np.mean(vals)) if vals else 0.0
        denom = self.confusion.predicted_total(cls)
        return self.true_positives(cls) / denom if denom else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is None:
            vals = [self.recall(c) for c in sorted(self.confusion.classes)]
            return float(np.mean(vals)) if vals else 0.0
        denom = self.confusion.actual_total(cls)
        return self.true_positives(cls) / denom if denom else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def accuracy(self) -> float:
        if not self.examples:
            return 0.0
        correct = sum(self.true_positives(c) for c in self.confusion.classes)
        return correct / self.examples

    def stats(self) -> str:
        """Printable report (reference stats() :149)."""
        lines = [
            "==================== Evaluation ====================",
            f"Examples:  {self.examples}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall:    {self.recall():.4f}",
            f"F1 Score:  {self.f1():.4f}",
            "Confusion matrix (rows=actual, cols=predicted):",
            str(self.confusion),
        ]
        return "\n".join(lines)

    def merge(self, other: "Evaluation") -> None:
        """Combine evaluations from shards (for multi-host eval)."""
        for a, row in other.confusion.counts.items():
            for p, n in row.items():
                self.confusion.add(a, p, n)
        self.examples += other.examples
