"""The one traffic generator: every mix is a data file of parameters
(``benchmark/traffic/<name>.json``) read here, so a new mix is a new
file.

Sizes are stratified, so every seed gives the same set of sizes in
another order: requests come in blocks of ``clients``, and in each block
the prompt lengths, the output lengths and the shared prefix chosen are
each one fixed grid of values, permuted by the seed.  Every request
decodes greedily.  Token ids are uniform over the vocabulary, drawn per
request from ``(seed, request index)``; training batches draw
Zipf-distributed ids.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_PROMPT, _PREFIX, _TRAIN = 1, 2, 3


def _grid(lo: int, hi: int, n: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi] (both ends inclusive)."""
    return (lo + np.floor((np.arange(n) + 0.5) * (hi - lo + 1) / n)
            ).astype(np.int64)


class ServeRequests:
    """Request `i` of a serving mix: (prompt ids, max_new_tokens).
    Client ``c`` of ``clients`` sends
    requests c, c + clients, c + 2 clients, ... in turn."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, int(vocab), int(seed)
        self.block = int(mix["clients"])
        self.prefixes = [
            np.random.default_rng([self.seed, _PREFIX, j]).integers(
                0, self.vocab, int(mix["prefix_tokens"])).tolist()
            for j in range(int(mix["shared_prefixes"]))]
        b = self.block
        self._unique = _grid(*mix["unique_tokens"], b)
        self._out = _grid(*mix["output_tokens"], b)
        n_pre = max(1, int(mix["shared_prefixes"]))
        self._which = np.arange(b) % n_pre
        self._blocks: dict = {}

    def _perms(self, blk: int):
        if blk not in self._blocks:
            rng = np.random.default_rng([self.seed, _PROMPT, blk])
            self._blocks[blk] = [rng.permutation(self.block)
                                 for _ in range(3)]
        return self._blocks[blk]

    def sizes(self, i: int) -> Tuple[int, int, int]:
        """(unique prompt tokens, new tokens, shared prefix)."""
        blk, j = divmod(int(i), self.block)
        pu, po, pw = self._perms(blk)
        return (int(self._unique[pu[j]]), int(self._out[po[j]]),
                int(self._which[pw[j]]))

    def request(self, i: int) -> Tuple[List[int], int]:
        n_unique, n_out, which = self.sizes(i)
        rng = np.random.default_rng([self.seed, _PROMPT, 1 << 20, int(i)])
        prompt = (list(self.prefixes[which]) if self.prefixes else [])
        prompt += rng.integers(0, self.vocab, n_unique).tolist()
        return prompt, n_out


def train_batches(mix: dict, vocab: int, seed: int) -> np.ndarray:
    """``[staged_batches, global_batch, seq_len + 1]`` int64 token ids, a
    Zipf law of exponent ``zipf_s`` over the vocabulary's ranks, the
    ranks mapped to ids by a permutation drawn from the seed."""
    rng = np.random.default_rng([int(seed), _TRAIN])
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -float(mix["zipf_s"])
    p /= p.sum()
    ids = rng.permutation(vocab)
    shape = (int(mix["staged_batches"]), int(mix["global_batch"]),
             int(mix["seq_len"]) + 1)
    return ids[rng.choice(vocab, size=shape, p=p)].astype(np.int64)
