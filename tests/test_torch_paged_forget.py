"""PyTorch port: `RadixPrefixCache.forget`, the hibernation sweep's
targeted eviction (`deeplearning4j_tpu_torch.serving.paged`).

The oracle is the JAX package's `RadixPrefixCache` over its own
`PagePool`: both trees take the same sequence of insert, match, release
and forget operations, and after each one the return values, the node
counts and every page's refcount must be equal.  The cases cover a
chain the tree alone holds, a node a lane still shares, a node with
children, a partial chain (tokens that stop inside a page or past the
cached run), and a seeded random mix of all four operations.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.serving.paged import PagePool as JPool
from deeplearning4j_tpu.serving.paged import RadixPrefixCache as JTree
from deeplearning4j_tpu_torch.serving.paged import PagePool, RadixPrefixCache

PS = 4
PAGES = 24


class _Pair:
    """The two packages' pool and tree side by side; every call is made
    on both and must answer the same."""

    def __init__(self):
        self.jpool, self.pool = JPool(PAGES, PS), PagePool(PAGES, PS)
        self.jtree, self.tree = JTree(self.jpool), RadixPrefixCache(self.pool)

    def check(self):
        assert self.tree.nodes == self.jtree.nodes
        assert self.pool.free == self.jpool.free
        for p in range(PAGES):
            assert self.pool.refcount(p) == self.jpool.refcount(p), p
        assert self.pool.check_ledger()["balanced"]

    def alloc(self, n):
        got, jgot = self.pool.alloc(n), self.jpool.alloc(n)
        assert got == jgot
        self.check()
        return got

    def insert(self, tokens, pages):
        got = self.tree.insert(tokens, pages)
        assert got == self.jtree.insert(tokens, pages)
        self.check()
        return got

    def match(self, tokens):
        got = self.tree.match(tokens)
        assert got == self.jtree.match(tokens)
        self.check()
        return got

    def release(self, pages):
        self.pool.release(pages)
        self.jpool.release(pages)
        self.check()

    def forget(self, tokens):
        got = self.tree.forget(tokens)
        assert got == self.jtree.forget(tokens)
        self.check()
        return got


def _lane(pair, tokens):
    """A lane that prefilled `tokens` into fresh pages, registered its
    full pages with the tree and finished: the tree's ref remains."""
    n = len(tokens) // PS
    pages = pair.alloc(n)
    pair.insert(tokens[:n * PS], pages)
    pair.release(pages)
    return pages


def test_a_chain_only_the_tree_holds_is_released_whole():
    pair = _Pair()
    toks = list(range(1, 13))
    _lane(pair, toks)
    assert pair.forget(toks) == 3
    assert pair.tree.nodes == 0 and pair.pool.free == PAGES - 1
    assert pair.forget(toks) == 0


def test_a_shared_node_stops_the_walk():
    pair = _Pair()
    toks = list(range(1, 13))
    _lane(pair, toks)
    held, partial = pair.match(toks[:8])      # a lane still reads 2 pages
    assert len(held) == 2 and partial is None
    assert pair.forget(toks) == 1             # only the deepest page goes
    pair.release(held)
    assert pair.forget(toks) == 2


def test_a_node_with_children_stops_the_walk():
    pair = _Pair()
    stem = list(range(1, 9))
    _lane(pair, stem + [20, 21, 22, 23])
    _lane(pair, stem + [30, 31, 32, 33])
    # forgetting one branch drops its leaf, then meets the shared stem,
    # which still has the other branch below it
    assert pair.forget(stem + [20, 21, 22, 23]) == 1
    assert pair.tree.nodes == 3
    assert pair.forget(stem) == 0             # the stem is not a leaf
    assert pair.forget(stem + [30, 31, 32, 33]) == 3
    assert pair.tree.nodes == 0


@pytest.mark.parametrize("tokens", [
    list(range(1, 7)),                        # stops inside page 2
    list(range(1, 9)) + [99, 98, 97, 96],     # diverges after 2 pages
    list(range(1, 17)),                       # runs past the cached chain
    [5, 5, 5, 5],                             # no page matches
], ids=["inside_a_page", "diverging", "past_the_chain", "no_match"])
def test_a_partial_chain(tokens):
    pair = _Pair()
    _lane(pair, list(range(1, 13)))
    pair.forget(tokens)
    # what the partial forget left still serves matches identically
    held, partial = pair.match(list(range(1, 13)))
    pair.release(held + ([partial[0]] if partial else []))


@pytest.mark.parametrize("seed", range(6))
def test_random_operation_sequences(seed):
    rng = np.random.default_rng(seed)
    pair = _Pair()
    held = []
    prompts = [list(rng.integers(0, 3, size=int(rng.integers(4, 17))))
               for _ in range(12)]
    for _ in range(80):
        op = rng.integers(0, 4)
        toks = [int(t) for t in prompts[int(rng.integers(0, len(prompts)))]]
        if op == 0 and pair.pool.free >= len(toks) // PS:
            _lane(pair, toks)
        elif op == 1:
            full, partial = pair.match(toks)
            if partial is not None:
                pair.release([partial[0]])
            held.append(full)
        elif op == 2 and held:
            pair.release(held.pop(int(rng.integers(0, len(held)))))
        else:
            pair.forget(toks)
    for pages in held:
        pair.release(pages)
    for toks in prompts:
        pair.forget(toks)
    assert pair.tree.nodes == pair.jtree.nodes
