"""Host-side state for the paged KV cache: page allocator + radix cache.

A copy of `deeplearning4j_tpu.serving.paged` (pure Python; the port keeps
its own copy rather than importing the JAX package).

The device side (`parallel.generation.make_paged_step`) addresses one
fixed pool of `[pages, page_size, H, K]` KV pages per layer through a
per-slot block table.  This module owns which physical page holds what:

- `PagePool` — a refcounted free-list allocator over the page ids.
  Page 0 is the reserved NULL page (masked lanes write it, unallocated
  block-table entries point at it) and is never handed out.  Pages are
  allocated on admission and refcount-freed on completion, so device
  capacity is sum-of-actual-lengths instead of `slots * max_len`.
- `RadixPrefixCache` — a page-granular radix tree over prompt token
  prefixes.  Each node covers exactly one FULL page (`page_size`
  tokens); a request whose prompt extends a cached prefix shares those
  pages (refcounted) and skips prefill for them entirely.  A prefix
  that diverges mid-page is served copy-on-write: `match()` hands back
  the divergence page + matched offset, the server copies it into a
  fresh page on device and overwrites from the divergence point.
  Un-shared cached pages (refcount 1 — held only by the tree) are
  evicted LRU-leaf-first when the pool runs dry.

Everything here is plain host Python with no locking of its own: the
LM server's WORKER THREAD is the single mutator (admission under the
server's condition lock; completion frees, radix inserts and CoW
releases in the worker's lock-free fold path).  Single-thread ownership
— not the lock — is the invariant; a second mutator path would corrupt
the refcount ledger even if it took the server's lock.

KV values at position t are a deterministic function of tokens[0..t]
and the weights, which is what makes sharing sound: a reused page holds
byte-identical k/v to what the new request would have written.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple


class PageLeakError(AssertionError):
    """The page ledger stopped balancing: allocated != in_use + free."""


class PagePool:
    """Refcounted fixed pool of KV page ids.

    `alloc(n)` hands out n pages with refcount 1 (or None when the free
    list is short — the caller decides whether to evict or queue);
    `retain`/`release` move shared pages' refcounts; a page whose
    refcount reaches 0 returns to the free list.  Page 0 (null) is
    outside the economy entirely.
    """

    def __init__(self, pages: int, page_size: int):
        if pages < 2:
            raise ValueError(f"pages must be >= 2 (page 0 is the "
                             f"reserved null page), got {pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.pages = int(pages)
        self.page_size = int(page_size)
        # LIFO free list: recently-freed pages are re-used first, which
        # keeps the working set of touched pages small
        self._free: List[int] = list(range(self.pages - 1, 0, -1))
        self._ref = [0] * self.pages

    @property
    def usable(self) -> int:
        """Allocatable pages (total minus the null page)."""
        return self.pages - 1

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.usable - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None when fewer than n are
        free (all-or-nothing: a partial grant would deadlock two lanes
        each holding half of what the other needs)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def retain(self, page_ids: Sequence[int]) -> None:
        for p in page_ids:
            if not 0 < p < self.pages or self._ref[p] <= 0:
                raise PageLeakError(
                    f"retain of un-allocated page {p} (ref "
                    f"{self._ref[p] if 0 <= p < self.pages else '?'})")
            self._ref[p] += 1

    def release(self, page_ids: Sequence[int]) -> None:
        for p in page_ids:
            if not 0 < p < self.pages or self._ref[p] <= 0:
                raise PageLeakError(
                    f"release of un-held page {p} (ref "
                    f"{self._ref[p] if 0 <= p < self.pages else '?'})")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    def check_ledger(self) -> Dict:
        """The page-accounting invariant (chaos tests assert it):
        allocated == in_use + free, every free page at refcount 0,
        every non-free page at refcount > 0."""
        held = sum(1 for p in range(1, self.pages) if self._ref[p] > 0)
        free_refs_ok = all(self._ref[p] == 0 for p in self._free)
        out = {"pages": self.usable, "free": self.free,
               "in_use": self.in_use, "held": held,
               "balanced": (held == self.in_use
                            and self.free + held == self.usable
                            and free_refs_ok)}
        return out


class _RadixNode:
    __slots__ = ("key", "page", "children", "last_used", "parent")

    def __init__(self, key: Optional[Tuple[int, ...]], page: Optional[int],
                 parent: Optional["_RadixNode"]):
        self.key = key                  # page_size tokens this page holds
        self.page = page                # physical page id
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.last_used = 0
        self.parent = parent


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class RadixPrefixCache:
    """Page-granular radix tree: prompt token prefix -> cached page run.

    Sharing granularity is one full page, so only prompts of at least
    `page_size` tokens ever create reusable nodes; the divergence page
    is served copy-on-write by the caller.  The tree holds ONE refcount
    on every cached page; `evict()` drops LRU leaves whose page nobody
    else holds, returning capacity without ever invalidating a page an
    active lane still reads.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.ps = pool.page_size
        self.root = _RadixNode(None, None, None)
        self._clock = itertools.count(1)
        self.nodes = 0

    # ---- lookup -----------------------------------------------------------

    def match(self, tokens: Sequence[int]
              ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached prefix of `tokens`.

        Returns `(full_pages, partial)`: the page ids covering whole
        matched pages, plus `(page_id, matched_len)` when the next page
        matches only its first `matched_len` tokens (the copy-on-write
        divergence page).  EVERY returned page is retained (+1 ref) so
        eviction cannot free it between match and use — the caller
        releases the partial page after copying, and the full pages
        when the lane completes.  Callers cap reuse by passing
        `tokens[:plen-1]`: the last prompt token must always be re-fed
        to produce the first sampled logits."""
        tick = next(self._clock)
        node, pages, i = self.root, [], 0
        partial: Optional[Tuple[int, int]] = None
        while True:
            chunk = tuple(int(t) for t in tokens[i:i + self.ps])
            child = (node.children.get(chunk)
                     if len(chunk) == self.ps else None)
            if child is not None:
                child.last_used = tick
                pages.append(child.page)
                node, i = child, i + self.ps
                continue
            if chunk:
                best, blen = None, 0
                for key, cand in node.children.items():
                    m = _common_prefix(key, chunk)
                    if m > blen:
                        best, blen = cand, m
                if best is not None:
                    best.last_used = tick
                    partial = (best.page, blen)
            break
        if pages:
            self.pool.retain(pages)
        if partial is not None:
            self.pool.retain([partial[0]])
        return pages, partial

    # ---- insert -----------------------------------------------------------

    def insert(self, tokens: Sequence[int], page_ids: Sequence[int]) -> int:
        """Register a lane's full prompt pages once its prefill is done:
        `page_ids[i]` holds tokens `[i*ps, (i+1)*ps)`.  Nodes already
        present (e.g. the shared pages this lane itself reused, or a
        concurrent identical prompt that prefilled first) are kept;
        genuinely new pages get +1 tree refcount.  Returns how many
        pages the tree newly took ownership of."""
        tick = next(self._clock)
        node, inserted = self.root, 0
        for i, page in enumerate(page_ids):
            chunk = tuple(int(t) for t in tokens[i * self.ps:
                                                 (i + 1) * self.ps])
            if len(chunk) < self.ps:
                raise ValueError("insert() takes only FULL prompt pages")
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode(chunk, int(page), node)
                node.children[chunk] = child
                self.pool.retain([int(page)])
                self.nodes += 1
                inserted += 1
            child.last_used = tick
            node = child
        return inserted

    # ---- eviction ---------------------------------------------------------

    def _leaves(self) -> List[_RadixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evictable(self) -> int:
        """Pages eviction could reclaim if run to exhaustion: nodes the
        tree alone holds (refcount 1) whose whole subtree is likewise
        tree-only — eviction is leaf-first, so a shared descendant pins
        every ancestor above it.  Admission uses this to decide whether
        evicting can possibly satisfy a request BEFORE destroying any
        cached prefix (an eviction that cannot free enough pages would
        wipe the cache and still admit nothing)."""

        def count(node: _RadixNode) -> Tuple[int, bool]:
            n, ok = 0, True
            for child in node.children.values():
                cn, cok = count(child)
                n += cn
                ok = ok and cok
            if node is self.root:
                return n, ok
            if ok and self.pool.refcount(node.page) == 1:
                return n + 1, True
            return n, False

        return count(self.root)[0]

    def evict(self, need_free: int) -> int:
        """Drop LRU nodes whose page only the tree holds until the pool
        has `need_free` pages free (or nothing evictable remains),
        leaf-first so a freed child can expose its parent.  Returns the
        number of pages evicted.  Pages an active lane still shares
        (refcount > 1) are skipped: releasing the tree's ref on them
        frees no capacity and only destroys future reuse.  One heap
        pass — candidates are collected once and parents pushed as
        their last child goes, not a full tree re-walk per page."""
        if self.pool.free >= need_free:
            return 0
        tie = itertools.count()
        heap: List[Tuple[int, int, _RadixNode]] = []

        def push(node: _RadixNode) -> None:
            if not node.children and self.pool.refcount(node.page) == 1:
                heapq.heappush(heap, (node.last_used, next(tie), node))

        for leaf in self._leaves():
            push(leaf)
        evicted = 0
        while heap and self.pool.free < need_free:
            _, _, victim = heapq.heappop(heap)
            # a node may sit in the heap twice (pushed as a leaf, again
            # as an emptied parent) or have been pinned since: re-check
            if (victim.children
                    or victim.parent.children.get(victim.key) is not victim
                    or self.pool.refcount(victim.page) != 1):
                continue
            del victim.parent.children[victim.key]
            self.pool.release([victim.page])
            self.nodes -= 1
            evicted += 1
            if victim.parent is not self.root:
                push(victim.parent)
        return evicted

    def forget(self, tokens: Sequence[int]) -> int:
        """Drop the tree's hold on the full-page chain covering
        `tokens`, deepest-first: the hibernation sweep's targeted
        eviction.  Once a session's pages rest on the state store, the
        tree's refcount is the only thing keeping them on device.  A
        node is dropped only while it is a leaf the tree alone holds
        (refcount 1); the walk stops at the first node that is still
        shared or still has children (which also pins every ancestor
        above it, exactly like `evict()`).  Returns pages released."""
        node, chain = self.root, []
        i = 0
        while True:
            chunk = tuple(int(t) for t in tokens[i:i + self.ps])
            child = (node.children.get(chunk)
                     if len(chunk) == self.ps else None)
            if child is None:
                break
            chain.append(child)
            node, i = child, i + self.ps
        dropped = 0
        for victim in reversed(chain):
            if victim.children or self.pool.refcount(victim.page) != 1:
                break
            del victim.parent.children[victim.key]
            self.pool.release([victim.page])
            self.nodes -= 1
            dropped += 1
        return dropped

    def clear(self) -> int:
        """Release every tree-held page back to THIS pool.  Diagnostic
        /test helper only: the server's real reset path
        (`ContinuousLMServer._reset_pool_locked`) discards the pool and tree
        wholesale instead, because after a failed dispatch the device
        page CONTENTS are gone too and per-slot bookkeeping must reset
        with them — clear() alone would leave that state stale."""
        dropped = 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.release([n.page])
            dropped += 1
        self.root = _RadixNode(None, None, None)
        self.nodes = 0
        return dropped


__all__ = ["PageLeakError", "PagePool", "RadixPrefixCache"]
