"""Counter / CounterMap (counterpart of
`deeplearning4j_tpu.utils.counter`; a copy: numpy and the standard library
only).

Parity: reference vendored Berkeley-NLP `berkeley/Counter.java` (643 LoC)
and `CounterMap.java` — count/weight maps with argmax, normalization, and
pretty-printing, used across the NLP stack.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Generic, Hashable, Iterable, List, Optional, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class Counter(Generic[K]):
    def __init__(self, items: Optional[Iterable[K]] = None):
        self._counts: Dict[K, float] = defaultdict(float)
        if items:
            for it in items:
                self.increment(it)

    def increment(self, key: K, amount: float = 1.0) -> float:
        self._counts[key] += amount
        return self._counts[key]

    def set_count(self, key: K, count: float) -> None:
        self._counts[key] = count

    def get_count(self, key: K) -> float:
        return self._counts.get(key, 0.0)

    def remove(self, key: K) -> float:
        return self._counts.pop(key, 0.0)

    def total_count(self) -> float:
        return sum(self._counts.values())

    def arg_max(self) -> Optional[K]:
        if not self._counts:
            return None
        return max(self._counts, key=self._counts.get)

    def max_count(self) -> float:
        return self._counts[self.arg_max()] if self._counts else 0.0

    def normalize(self) -> "Counter[K]":
        total = self.total_count()
        if total:
            for k in self._counts:
                self._counts[k] /= total
        return self

    def sorted_keys(self, descending: bool = True) -> List[K]:
        return sorted(self._counts, key=self._counts.get,
                      reverse=descending)

    def keys(self):
        return self._counts.keys()

    def items(self):
        return self._counts.items()

    def __contains__(self, key: K) -> bool:
        return key in self._counts

    def __len__(self) -> int:
        return len(self._counts)

    def __str__(self) -> str:
        top = ", ".join(f"{k}: {self._counts[k]:g}"
                        for k in self.sorted_keys()[:10])
        return f"Counter[{top}]"


class CounterMap(Generic[K, V]):
    """key -> Counter of sub-keys (conditional counts)."""

    def __init__(self):
        self._maps: Dict[K, Counter[V]] = {}

    def increment(self, key: K, sub: V, amount: float = 1.0) -> float:
        return self.get_counter(key).increment(sub, amount)

    def set_count(self, key: K, sub: V, count: float) -> None:
        self.get_counter(key).set_count(sub, count)

    def get_count(self, key: K, sub: V) -> float:
        c = self._maps.get(key)
        return c.get_count(sub) if c else 0.0

    def get_counter(self, key: K) -> Counter[V]:
        if key not in self._maps:
            self._maps[key] = Counter()
        return self._maps[key]

    def total_count(self) -> float:
        return sum(c.total_count() for c in self._maps.values())

    def normalize(self) -> "CounterMap[K, V]":
        for c in self._maps.values():
            c.normalize()
        return self

    def keys(self):
        return self._maps.keys()

    def items(self) -> Iterable[Tuple[K, Counter[V]]]:
        return self._maps.items()

    def __contains__(self, key: K) -> bool:
        return key in self._maps

    def __len__(self) -> int:
        return len(self._maps)
