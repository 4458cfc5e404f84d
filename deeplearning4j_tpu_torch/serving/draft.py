"""Drafters for speculative decoding in the LM pool (counterpart of
`deeplearning4j_tpu.serving.draft`).

The pool's verify step (`parallel.generation.make_spec_step`) scores a
lane's drafted tokens in one wide dispatch and accepts or rolls back on
the device; a `Drafter` supplies the drafts.  It proposes up to `budget`
continuation tokens per lane per round from the lane's committed history
(prompt + generated).  Draft quality moves only throughput: the accept
rule keeps greedy output equal to 1-token decode whatever is proposed.

- `NgramDrafter`: prompt lookup.  Match the lane's recent tokens against
  its own earlier history and propose what followed the most recent
  prior occurrence.  Host Python only, no device work.
- `ModelDrafter`: a draft LM (a small config, or the target itself for
  self-speculation) decoding greedily in its own dense slot cache
  through `make_slot_step`, one 1-wide dispatch per fed or drafted
  token: one program, ``lm:draft``, in the pool's graph memory pool.

A drafter belongs to the pool's worker thread, which alone calls it.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.obs.compilewatch import compile_scope


@runtime_checkable
class Drafter(Protocol):
    """One round of proposals for the whole slot pool.

    `histories[i]` is lane i's committed tokens (prompt + generated), or
    None for a lane that must not be drafted for (inactive, sampling, or
    out of budget); `budgets[i]` caps lane i's proposal.  Returns one
    list per lane, possibly empty, never longer than its budget; None
    lanes get []."""

    name: str

    def propose(self, histories: Sequence[Optional[Sequence[int]]],
                budgets: Sequence[int]) -> List[List[int]]:
        ...  # pragma: no cover — protocol signature only

    def reset(self) -> None:
        """Forget all lane state (the pool was rebuilt)."""
        ...  # pragma: no cover — protocol signature only

    def compiled_programs(self) -> int:
        """Device programs this drafter adds to the pool's."""
        ...  # pragma: no cover — protocol signature only


class NgramDrafter:
    """Prompt-lookup drafting over each lane's own history.

    For the longest n in [min_ngram, max_ngram] whose history suffix
    occurs earlier in the history, propose the tokens that followed the
    most recent prior occurrence, up to the budget.  Degenerate inputs
    (empty or too short a history, no prior occurrence, nothing after
    it) propose nothing, and the lane decodes one token that round."""

    name = "ngram"

    def __init__(self, max_ngram: int = 4, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}..{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def _propose_one(self, hist: Sequence[int], budget: int) -> List[int]:
        h = list(hist)
        n_hist = len(h)
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            suffix = h[n_hist - n:]
            # the most recent prior occurrence whose continuation fills
            # the budget; one too close to the end gives a cut
            # continuation (for a periodic tail the nearest match is the
            # overlapping one), so keep scanning and fall back to the
            # longest continuation seen
            best: List[int] = []
            for i in range(n_hist - n - 1, -1, -1):
                if h[i] == suffix[0] and h[i:i + n] == suffix:
                    cont = h[i + n:i + n + budget]
                    if len(cont) == budget:
                        return cont
                    if len(cont) > len(best):
                        best = cont
            if best:
                return best
        return []

    def propose(self, histories, budgets) -> List[List[int]]:
        return [[] if hist is None or budget < 1
                else self._propose_one(hist, int(budget))
                for hist, budget in zip(histories, budgets)]

    def reset(self) -> None:
        pass                        # stateless: the history rides each call

    def compiled_programs(self) -> int:
        return 0


class ModelDrafter:
    """Small-model drafting: a draft LM greedily rolls out `budget`
    tokens per lane in its own dense slot cache on `device` (None = the
    card).

    Lane state heals itself from the histories handed to `propose`: each
    call rewinds a lane to the longest common prefix of what it fed and
    the new history (rejected drafts and reused slots fall out; the
    cache masks everything past a row's position, so a rewind is a host
    counter move), teacher-forces the missing suffix, then rolls out the
    proposal.  A lane with nothing to feed in a round re-feeds its last
    token at its own position, which rewrites the same key and value."""

    name = "model"

    def __init__(self, cfg, params, slots: int, target_vocab: int = 0,
                 target_max_len: int = 0, device: DeviceLike = None,
                 pool=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if target_vocab and cfg.vocab_size < target_vocab:
            raise ValueError(
                f"draft model vocab ({cfg.vocab_size}) smaller than the "
                f"target's ({target_vocab}): drafts could never cover "
                f"the target's tokens")
        if target_max_len and cfg.max_len < target_max_len:
            raise ValueError(
                f"draft model max_len ({cfg.max_len}) smaller than the "
                f"target's ({target_max_len}): a lane's history would "
                f"outgrow the draft cache mid-request")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.n_slots = int(slots)
        self.pool = pool            # the pool's graph memory pool
        self._step = None
        self._cache = None          # (k, v) slot-cache tensors
        self._fed: List[List[int]] = [[] for _ in range(self.n_slots)]

    # ---- device plumbing --------------------------------------------------

    def _ensure_started(self) -> None:
        if self._step is not None:
            return
        from deeplearning4j_tpu_torch.parallel.generation import (
            init_slot_cache,
            make_slot_step,
            place_params,
        )

        self.params = place_params(self.cfg, self.params, self.device)
        self._step = make_slot_step(self.cfg, self.pool, key="lm:draft")
        cache = init_slot_cache(self.cfg, self.n_slots, device=self.device)
        self._cache = (cache["k"], cache["v"])

    def warmup(self) -> None:
        """One draft dispatch before traffic (the pool's `warmup()` calls
        it); it writes position 0 of every lane, so the lane state is
        reset after it."""
        self._ensure_started()
        zi = np.zeros((self.n_slots,), np.int32)
        self._dispatch(zi, zi)
        self.reset()

    def _dispatch(self, tokens, pos) -> np.ndarray:
        """One 1-wide draft step -> ``[B]`` greedy next tokens (every
        lane at temperature 0)."""
        zi = np.zeros((self.n_slots,), np.int32)
        zf = np.zeros((self.n_slots,), np.float32)
        with compile_scope("lm:draft"):
            nxt, k, v = self._step(self.params, *self._cache, pos, tokens,
                                   zf, zi, zi)
        self._cache = (k, v)
        return nxt.cpu().numpy()

    # ---- drafting ---------------------------------------------------------

    def propose(self, histories, budgets) -> List[List[int]]:
        if len(histories) != self.n_slots:
            raise ValueError(f"expected {self.n_slots} lane histories, "
                             f"got {len(histories)}")
        budgets = [int(b) for b in budgets]
        if not any(b > 0 and h is not None
                   for h, b in zip(histories, budgets)):
            return [[] for _ in histories]
        self._ensure_started()
        pending: List[List[int]] = []
        for i, hist in enumerate(histories):
            if hist is None:
                pending.append([])
                continue
            h = [int(t) for t in hist]
            cp = 0
            fed = self._fed[i]
            for a, b in zip(fed, h):
                if a != b:
                    break
                cp += 1
            self._fed[i] = fed[:cp]        # rewind = pointer move
            pending.append(h[cp:])
        # a history the draft cache cannot hold (a drafter built without
        # the factory's max_len check) sits the round out rather than
        # writing at clamped positions
        for i in range(self.n_slots):
            if (histories[i] is not None
                    and len(self._fed[i]) + len(pending[i])
                    > self.cfg.max_len):
                pending[i] = []
                budgets[i] = 0
        if not any(b > 0 and h is not None
                   for h, b in zip(histories, budgets)):
            return [[] for _ in histories]
        # teacher-force the missing suffixes in lockstep; at least one
        # round runs, so every drafted lane's last committed token has
        # been (re-)fed and its next-token prediction is current
        rounds = max(1, max(len(p) for p in pending))
        pred = None
        for _ in range(rounds):
            tokens = np.zeros((self.n_slots,), np.int32)
            pos = np.zeros((self.n_slots,), np.int32)
            for i in range(self.n_slots):
                if pending[i]:
                    tokens[i] = pending[i].pop(0)
                    pos[i] = len(self._fed[i])
                    self._fed[i].append(int(tokens[i]))
                elif self._fed[i]:             # idle: re-feed the last
                    tokens[i] = self._fed[i][-1]
                    pos[i] = len(self._fed[i]) - 1
            pred = self._dispatch(tokens, pos)
        # greedy rollout: feed each round's prediction back in
        out: List[List[int]] = [[] for _ in range(self.n_slots)]
        k_max = max(budgets)
        for t in range(k_max):
            for i in range(self.n_slots):
                if (histories[i] is not None and self._fed[i]
                        and t < budgets[i]):
                    out[i].append(int(pred[i]))
            if t + 1 >= k_max:
                break
            tokens = np.zeros((self.n_slots,), np.int32)
            pos = np.zeros((self.n_slots,), np.int32)
            for i in range(self.n_slots):
                if (histories[i] is not None and self._fed[i]
                        and t + 1 < budgets[i]
                        and len(self._fed[i]) < self.cfg.max_len):
                    tokens[i] = pred[i]
                    pos[i] = len(self._fed[i])
                    self._fed[i].append(int(pred[i]))
                elif self._fed[i]:
                    tokens[i] = self._fed[i][-1]
                    pos[i] = len(self._fed[i]) - 1
            pred = self._dispatch(tokens, pos)
        return [p[:b] for p, b in zip(out, budgets)]

    def reset(self) -> None:
        self._fed = [[] for _ in range(self.n_slots)]

    def compiled_programs(self) -> int:
        return 1


def make_drafter(mode: str, cfg, params, slots: int, draft_model=None,
                 device: DeviceLike = None, pool=None) -> Optional[Drafter]:
    """The pool's drafter factory: `mode` in {"off", "ngram", "model"}.
    For "model", `draft_model` is an optional (cfg, params) pair; the
    default is self-speculation with the target's own weights (every
    greedy draft accepted: a check of the wiring, not a speed-up)."""
    if mode == "off":
        return None
    if mode == "ngram":
        return NgramDrafter()
    if mode == "model":
        d_cfg, d_params = (draft_model if draft_model is not None
                           else (cfg, params))
        return ModelDrafter(d_cfg, d_params, slots,
                            target_vocab=cfg.vocab_size,
                            target_max_len=cfg.max_len, device=device,
                            pool=pool)
    raise ValueError(
        f"speculate must be 'off', 'ngram' or 'model', got {mode!r}")


__all__ = ["Drafter", "ModelDrafter", "NgramDrafter", "make_drafter"]
