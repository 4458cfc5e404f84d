"""Shared retry policy: exponential backoff with jitter (counterpart of
`deeplearning4j_tpu.resilience.retry`).

One policy object serves every transient-failure site in the codebase —
the dataset downloaders' mirror loops, the supervisor's batch-fetch path,
remote storage.  Pure stdlib (no torch import): the downloaders must be
importable before any accelerator runtime comes up.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: attempt k sleeps
    ``min(base_delay * multiplier**k, max_delay)`` +/- ``jitter`` fraction.

    ``retryable`` is the exception allowlist — anything else propagates
    immediately (KeyboardInterrupt/SystemExit never match: they are
    BaseExceptions and retry_call only catches Exception subclasses).
    """

    max_attempts: int = 3
    base_delay: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.1  # fraction of the delay, uniform +/-
    retryable: Tuple[Type[Exception], ...] = (OSError,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")


def backoff_delays(policy: RetryPolicy,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """The ``max_attempts - 1`` sleep durations between attempts."""
    rng = rng if rng is not None else random.Random()
    for k in range(policy.max_attempts - 1):
        delay = min(policy.base_delay * policy.multiplier ** k,
                    policy.max_delay)
        if policy.jitter:
            delay += delay * policy.jitter * (2.0 * rng.random() - 1.0)
        yield max(0.0, delay)


def retry_call(fn: Callable[[], T], *, policy: RetryPolicy,
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None,
               on_retry: Optional[Callable[[int, Exception, float],
                                           None]] = None,
               describe: str = "") -> T:
    """Call ``fn`` up to ``policy.max_attempts`` times.

    Retries only exceptions matching ``policy.retryable``; the last
    failure re-raises unchanged.  ``on_retry(attempt, exc, delay)`` fires
    before each sleep (logging/telemetry hook); ``sleep``/``rng`` are
    injectable so tests run without wall-clock waits."""
    delays = backoff_delays(policy, rng)
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except policy.retryable as e:
            if attempt == policy.max_attempts:
                raise
            delay = next(delays)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
    raise AssertionError(f"unreachable: retry loop fell through "
                         f"({describe or fn!r})")
