"""Overload survival for the LM pool: priorities, host swap, brownout
(the port's copy of `deeplearning4j_tpu.serving.pressure`; stdlib only).

- **Priority classes**: the closed request vocabulary (``interactive``
  > ``batch`` > ``best_effort``) every front accepts and the pool's
  admission queue is ordered by.  `normalize_priority` is the
  validation gate: an unknown class is the client's 400.
- **`SwapStore`**: a bounded host-side byte store for preempted lanes'
  serialized KV state (`serving/transfer.py` frames, so a restore gets
  the SHA-256 check).  LRU and byte-capped; a victim whose state was
  dropped surfaces as `SwapEvictedError` at restore, and the pool
  recomputes the lane from its prompt, which yields the same tokens.
  Single-mutator like `PagePool`: the LM worker thread owns every
  mutation, under the server's lock; the store takes no locks.
- **`BrownoutLadder`**: the pool-pressure automaton that degrades before
  shedding.  Its inputs are the pages-free fraction and the queue depth
  per slot; its output a level 0..4:

      0 healthy     nothing degraded
      1 no_spec     speculation off
      2 narrow      the prefill ride-along width halved
      3 preempt     best_effort lanes preempted whenever higher-class
                    work waits
      4 shed        best_effort admissions refused (503 + Retry-After);
                    interactive and batch still admit

  Hysteresis both ways: a level is entered the moment a signal crosses
  its threshold, and left one level at a time, after both signals have
  stayed calm for `down_dwell` consecutive updates.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Priority classes

# The closed vocabulary, best-first.  Rank is the queue sort key:
# LOWER rank = more important = served first = never preempted by the
# ladder.  Requests default to interactive, so one class is FIFO by
# arrival.
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")
PRIORITY_RANK: Dict[str, int] = {c: i for i, c in
                                 enumerate(PRIORITY_CLASSES)}
RANK_INTERACTIVE = PRIORITY_RANK["interactive"]
RANK_BATCH = PRIORITY_RANK["batch"]
RANK_BEST_EFFORT = PRIORITY_RANK["best_effort"]
DEFAULT_PRIORITY = "interactive"


def normalize_priority(priority: Optional[str]) -> str:
    """THE priority-validation gate, shared by the HTTP fronts (as
    400s) and `ContinuousLMServer` (as ValueErrors).  None means the
    client sent nothing: default interactive — a latency-sensitive
    caller must not silently become preemptible."""
    if priority is None:
        return DEFAULT_PRIORITY
    p = str(priority)
    if p not in PRIORITY_RANK:
        raise ValueError(
            f"priority must be one of {PRIORITY_CLASSES}, got {p!r}")
    return p


# ---------------------------------------------------------------------------
# Host-side swap store for preempted lanes


class SwapEvictedError(RuntimeError):
    """A preempted lane's swapped-out state is gone: the byte-capped
    store evicted it (LRU) to make room for later victims, or the blob
    never fit the cap at all.  The pool's restore path answers this by
    RECOMPUTING the lane from its prompt — deterministic decode makes
    the recomputed tokens byte-identical to the swapped ones, so the
    client never sees this error, only the accounting does."""


class SwapStore:
    """Bounded LRU byte store: swap_key -> serialized lane state.

    Single-mutator (the LM worker thread, under the server's condition
    lock) like `PagePool` — no locks of its own.  `put` stores a blob,
    evicting least-recently-stored entries until it fits (a blob larger
    than the whole cap is refused outright — counted, not stored);
    `take` removes and returns a blob, raising `SwapEvictedError` for a
    key that is no longer there.  `peak_bytes` is the high-water mark
    a byte-cap check reads.
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self._blobs: "collections.OrderedDict[str, bytes]" = (
            collections.OrderedDict())
        self.bytes_stored = 0
        self.peak_bytes = 0
        self.puts = 0
        self.takes = 0
        self.evicted = 0        # entries dropped to make room
        self.rejected = 0       # blobs larger than the whole cap

    def __len__(self) -> int:
        return len(self._blobs)

    def put(self, key: str, blob: bytes) -> Optional[List[str]]:
        """Store `blob` under `key`.  Returns the list of keys evicted
        to make room (possibly empty), or None when the blob alone
        exceeds the cap and was refused — the caller falls back to
        recompute-from-prompt for that lane instead of silently
        wiping every other victim's state for one oversized lane."""
        size = len(blob)
        if size > self.capacity_bytes:
            self.rejected += 1
            return None
        evicted: List[str] = []
        while self.bytes_stored + size > self.capacity_bytes:
            old_key, old = self._blobs.popitem(last=False)
            self.bytes_stored -= len(old)
            self.evicted += 1
            evicted.append(old_key)
        self._blobs[key] = blob
        self.bytes_stored += size
        self.peak_bytes = max(self.peak_bytes, self.bytes_stored)
        self.puts += 1
        return evicted

    def take(self, key: str) -> bytes:
        """Remove and return the blob under `key`; `SwapEvictedError`
        when it was evicted (or never stored)."""
        blob = self._blobs.pop(key, None)
        if blob is None:
            raise SwapEvictedError(
                f"swapped-out lane state {key!r} is gone (evicted from "
                f"the {self.capacity_bytes}-byte store)")
        self.bytes_stored -= len(blob)
        self.takes += 1
        return blob

    def discard(self, key: str) -> None:
        """Drop a blob without reading it (its request was shed or
        abandoned before restore); a no-op when already evicted."""
        blob = self._blobs.pop(key, None)
        if blob is not None:
            self.bytes_stored -= len(blob)

    def clear(self) -> None:
        self._blobs.clear()
        self.bytes_stored = 0

    def stats(self) -> Dict:
        return {"entries": len(self._blobs),
                "bytes": self.bytes_stored,
                "capacity_bytes": self.capacity_bytes,
                "peak_bytes": self.peak_bytes,
                "puts": self.puts, "takes": self.takes,
                "evicted": self.evicted, "rejected": self.rejected}


# ---------------------------------------------------------------------------
# Brownout degradation ladder

# Level names, index == level (the closed vocabulary stats/docs use)
BROWNOUT_LEVELS = ("healthy", "no_spec", "narrow", "preempt", "shed")


@dataclasses.dataclass(frozen=True)
class PressureConfig:
    """Thresholds for the 4 degraded levels (index k = level k+1).

    A level is ENTERED when pages-free fraction drops to
    ``enter_free_frac[k]`` or queue-depth-per-slot reaches
    ``enter_queue_ratio[k]``; it is LEFT (one step down) only after
    BOTH signals have stayed calm — free fraction above
    enter + ``exit_free_margin`` AND queue ratio below
    enter * ``exit_queue_factor`` — for ``down_dwell`` consecutive
    updates.  The margin/factor gap plus the dwell are the hysteresis:
    a pool hovering at a threshold cannot flap."""

    enter_free_frac: Tuple[float, ...] = (0.5, 0.25, 0.125, 0.05)
    enter_queue_ratio: Tuple[float, ...] = (2.0, 4.0, 8.0, 16.0)
    exit_free_margin: float = 0.125
    exit_queue_factor: float = 0.5
    down_dwell: int = 3

    def __post_init__(self):
        if len(self.enter_free_frac) != len(self.enter_queue_ratio):
            raise ValueError(
                f"enter_free_frac ({len(self.enter_free_frac)}) and "
                f"enter_queue_ratio ({len(self.enter_queue_ratio)}) "
                f"must define the same number of levels")
        if not self.enter_free_frac:
            raise ValueError("at least one degraded level is required")
        if list(self.enter_free_frac) != sorted(self.enter_free_frac,
                                                reverse=True):
            raise ValueError("enter_free_frac must be non-increasing "
                             "(deeper levels = less free)")
        if list(self.enter_queue_ratio) != sorted(self.enter_queue_ratio):
            raise ValueError("enter_queue_ratio must be non-decreasing "
                             "(deeper levels = more queued)")
        if self.down_dwell < 1:
            raise ValueError(f"down_dwell must be >= 1, got "
                             f"{self.down_dwell}")
        if len(self.enter_free_frac) != len(BROWNOUT_LEVELS) - 1:
            # the rung EFFECTS are a closed vocabulary (no_spec /
            # narrow / preempt / shed, hardwired at levels 1-4 in the
            # pool): a shorter ladder would silently drop the preempt
            # and shed rungs, a longer one would add levels that do
            # nothing
            raise ValueError(
                f"exactly {len(BROWNOUT_LEVELS) - 1} degraded levels "
                f"are required (the rung effects "
                f"{BROWNOUT_LEVELS[1:]} are fixed), got "
                f"{len(self.enter_free_frac)}")


class BrownoutLadder:
    """The pool-pressure automaton.  Single-mutator (the LM worker
    thread calls `update` once per admission round); readers take the
    server's lock like every other pool stat."""

    def __init__(self, config: Optional[PressureConfig] = None):
        self.config = config if config is not None else PressureConfig()
        self.level = 0
        self.max_level = len(self.config.enter_free_frac)
        self._calm_updates = 0
        self.transitions_up = 0
        self.transitions_down = 0
        # bounded history of (from, to) level moves, oldest dropped
        self.history: "collections.deque[Tuple[int, int]]" = (
            collections.deque(maxlen=64))
        self.updates = 0

    def _target(self, free_frac: float, queue_ratio: float) -> int:
        cfg, target = self.config, 0
        for k in range(self.max_level):
            if (free_frac <= cfg.enter_free_frac[k]
                    or queue_ratio >= cfg.enter_queue_ratio[k]):
                target = k + 1
        return target

    def update(self, pages_free: int, pages_total: int,
               queue_depth: int, slots: int) -> List[Tuple[int, int]]:
        """One pressure reading -> the transitions it caused (usually
        none).  Upward moves are immediate (pressure is NOW) and may
        jump several levels on a sudden exhaustion; downward moves are
        one level per `down_dwell` consecutive calm updates."""
        self.updates += 1
        cfg = self.config
        free_frac = pages_free / max(1, pages_total)
        queue_ratio = queue_depth / max(1, slots)
        target = self._target(free_frac, queue_ratio)
        moves: List[Tuple[int, int]] = []
        if target > self.level:
            moves.append((self.level, target))
            self.level = target
            self._calm_updates = 0
            self.transitions_up += 1
        elif self.level > 0:
            k = self.level - 1
            calm = (free_frac > cfg.enter_free_frac[k]
                    + cfg.exit_free_margin
                    and queue_ratio < cfg.enter_queue_ratio[k]
                    * cfg.exit_queue_factor)
            if calm:
                self._calm_updates += 1
                if self._calm_updates >= cfg.down_dwell:
                    moves.append((self.level, self.level - 1))
                    self.level -= 1
                    self._calm_updates = 0
                    self.transitions_down += 1
            else:
                self._calm_updates = 0
        for m in moves:
            self.history.append(m)
        return moves

    @property
    def transitions(self) -> int:
        return self.transitions_up + self.transitions_down

    def stats(self) -> Dict:
        return {"level": self.level,
                "level_name": BROWNOUT_LEVELS[
                    min(self.level, len(BROWNOUT_LEVELS) - 1)],
                "transitions_up": self.transitions_up,
                "transitions_down": self.transitions_down,
                "updates": self.updates,
                "recent": [list(m) for m in self.history][-8:]}


__all__ = [
    "BROWNOUT_LEVELS",
    "BrownoutLadder",
    "DEFAULT_PRIORITY",
    "PRIORITY_CLASSES",
    "PRIORITY_RANK",
    "PressureConfig",
    "RANK_BATCH",
    "RANK_BEST_EFFORT",
    "RANK_INTERACTIVE",
    "SwapEvictedError",
    "SwapStore",
    "normalize_priority",
]
