"""Text-processing performers for the job runtime (counterpart of
`deeplearning4j_tpu.scaleout.text_performers`; a copy: host Python only).

Parity: reference `scaleout/perform/text/*` — the word-count example worker
that demonstrates the WorkerPerformer/JobAggregator contract on non-tensor
work (SURVEY §2.2 "Scaleout performers" row; `WordCountTest`).
"""

from __future__ import annotations


from deeplearning4j_tpu_torch.scaleout.api import (
    Job,
    JobAggregator,
    WorkerPerformer,
)
from deeplearning4j_tpu_torch.utils.counter import Counter


class WordCountPerformer(WorkerPerformer):
    """job.work = iterable of sentences (str or token list) → Counter."""

    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer or (lambda s: s.split())

    def perform(self, job: Job) -> None:
        counts: Counter = Counter()
        for sentence in job.work:
            tokens = (self.tokenizer(sentence) if isinstance(sentence, str)
                      else sentence)
            for tok in tokens:
                counts.increment(tok)
        job.result = counts
        job.done = True

    def update(self, state) -> None:
        pass  # stateless


class CounterAggregator(JobAggregator):
    """Fold worker Counters into one global Counter."""

    def __init__(self):
        self._total: Counter = Counter()

    def accumulate(self, result: Counter) -> None:
        for k, v in result.items():
            self._total.increment(k, v)

    def aggregate(self) -> Counter:
        return self._total

    def reset(self) -> None:
        self._total = Counter()
