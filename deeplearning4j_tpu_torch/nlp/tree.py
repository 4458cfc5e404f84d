"""Constituency trees: structure, PTB-bracket parsing, binarization, and
compilation to padded post-order programs (a copy of
`deeplearning4j_tpu.nlp.tree`: host numpy, no device).

Parity: reference `nn/layers/feedforward/autoencoder/recursive/Tree.java`
(485 LoC) and `text/corpora/treeparser/TreeParser.java` (UIMA/OpenNLP
constituency parsing -> Tree). Trees parse from Penn-Treebank bracket
strings (the format the reference's sentiment fixtures use) or build as
right-branching binarizations of plain token lists.

`compile_trees` turns each tree into a POST-ORDER program over a node
buffer — arrays (is_leaf, word, left, right, label, mask) padded to a
common length — which the port's tree models (models/rntn.py,
models/recursive_autoencoder.py) run node by node, batched over the
trees, in place of the reference's per-node Java recursion
(`RNTN.forwardPropagateTree:426`).  The arrays are equal to the JAX
package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class Tree:
    label: Optional[int] = None          # class label (e.g. sentiment 0-4)
    word: Optional[str] = None           # set on leaves
    children: List["Tree"] = field(default_factory=list)

    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def tokens(self) -> List[str]:
        return [l.word for l in self.leaves()]

    def nodes(self) -> List["Tree"]:
        """Post-order traversal (children before parents)."""
        out = []
        for c in self.children:
            out.extend(c.nodes())
        out.append(self)
        return out

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def binarize(self) -> "Tree":
        """Left-factor n-ary nodes into binary ones (the RNTN combine is
        strictly binary, RNTN.java:344)."""
        if self.is_leaf():
            return Tree(label=self.label, word=self.word)
        kids = [c.binarize() for c in self.children]
        if len(kids) == 1:
            only = kids[0]
            # collapse unary chains, keep the outermost label
            return Tree(label=self.label if self.label is not None
                        else only.label, word=only.word,
                        children=only.children)
        node = kids[0]
        for right in kids[1:-1]:
            node = Tree(label=self.label, children=[node, right])
        return Tree(label=self.label, children=[node, kids[-1]])


def parse_ptb(s: str) -> Tree:
    """Parse one Penn-Treebank-style bracketed tree, e.g.
    ``(3 (2 good) (3 (2 not) (1 bad)))`` — numeric labels, words at
    leaves (the SST format the reference's sentiment corpus uses)."""
    tokens = s.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def rec() -> Tree:
        nonlocal pos
        assert tokens[pos] == "(", f"expected ( at {pos}"
        pos += 1
        label: Optional[int] = None
        if tokens[pos] not in "()":
            try:
                label = int(tokens[pos])
            except ValueError:
                label = None  # syntactic category labels are dropped
            pos += 1
        node = Tree(label=label)
        while tokens[pos] != ")":
            if tokens[pos] == "(":
                node.children.append(rec())
            else:
                node.word = tokens[pos]
                pos += 1
        pos += 1
        return node

    tree = rec()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens in tree string: {tokens[pos:]}")
    return tree


def right_branching(tokens: Sequence[str], label: int = 0) -> Tree:
    """Binary tree over a plain sentence when no parse exists (replaces the
    reference's dependency on an external constituency parser)."""
    if not tokens:
        raise ValueError("empty sentence")
    node = Tree(label=label, word=tokens[-1])
    for w in reversed(tokens[:-1]):
        node = Tree(label=label, children=[Tree(label=label, word=w), node])
    return node


@dataclass
class TreeProgram:
    """Padded post-order programs for a batch of trees (host arrays)."""

    is_leaf: np.ndarray   # [B, N] int32 1/0
    word: np.ndarray      # [B, N] int32 vocab index (0 where internal/pad)
    left: np.ndarray      # [B, N] int32 buffer index of left child
    right: np.ndarray     # [B, N] int32 buffer index of right child
    label: np.ndarray     # [B, N] int32 class label (0 where absent)
    mask: np.ndarray      # [B, N] float32 1 for real nodes
    labeled: np.ndarray   # [B, N] float32 1 where the node CARRIES a label
    root: np.ndarray      # [B] int32 buffer index of the root
    n_nodes: int

    def __len__(self) -> int:
        return self.is_leaf.shape[0]


def compile_trees(trees: Sequence[Tree], word_index,
                  max_nodes: Optional[int] = None,
                  unk_index: int = 0) -> TreeProgram:
    """Binarized trees → post-order programs, padded to a common length.

    word_index: dict word→int or callable. Labels default to 0 when a node
    carries none; the `labeled` array records which nodes actually carry
    one (label=None ⇒ labeled=0), so losses can supervise only labeled
    nodes — e.g. root-only sentence classification.
    """
    lookup = (word_index if callable(word_index)
              else lambda w: word_index.get(w, unk_index))
    progs = []
    for t in trees:
        t = t.binarize()
        nodes = t.nodes()
        if any(len(n.children) not in (0, 2) for n in nodes):
            raise ValueError("binarize() must yield strictly binary trees")
        index = {id(n): i for i, n in enumerate(nodes)}
        rows = []
        for n in nodes:
            has = int(n.label is not None)
            if n.is_leaf():
                rows.append((1, lookup(n.word), 0, 0, n.label or 0, has))
            else:
                l, r = (index[id(c)] for c in n.children)
                rows.append((0, 0, l, r, n.label or 0, has))
        progs.append(rows)

    n = max_nodes or max(len(p) for p in progs)
    if max(len(p) for p in progs) > n:
        raise ValueError(f"tree with {max(len(p) for p in progs)} nodes "
                         f"exceeds max_nodes={n}")
    b = len(progs)
    arrs = {k: np.zeros((b, n), np.int32)
            for k in ("is_leaf", "word", "left", "right", "label")}
    mask = np.zeros((b, n), np.float32)
    labeled = np.zeros((b, n), np.float32)
    root = np.zeros(b, np.int32)
    for i, rows in enumerate(progs):
        cols = np.asarray(rows, np.int64).T      # one row-slice a column
        m = len(rows)
        for k, col in zip(("is_leaf", "word", "left", "right", "label"),
                          cols):
            arrs[k][i, :m] = col
        labeled[i, :m] = cols[5]
        mask[i, :m] = 1.0
        root[i] = len(rows) - 1
    return TreeProgram(arrs["is_leaf"], arrs["word"], arrs["left"],
                       arrs["right"], arrs["label"], mask, labeled, root, n)
