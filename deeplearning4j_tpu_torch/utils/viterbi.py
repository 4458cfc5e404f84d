"""Viterbi decoding on the device (counterpart of
`deeplearning4j_tpu.utils.viterbi`).

Parity: reference `util/Viterbi.java` (194 LoC — most likely label
sequence from per-step outcome probabilities with a Markov transition
prior).  The forward max-plus recursion runs on the device in float32,
one step a time index, in the JAX package's order: ``prev[:, None] +
log_trans``, then the max and the argmax over the from-states, then the
emission.  Ties go to the first index (``torch.argmax``, as
``jnp.argmax``).  The back-pointers ``[T-1, S]``, the final state and
the best log-prob come to the host in one copy, and the backtrace runs
there: one read a decode, not T.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device


def _decode(log_emit: torch.Tensor, log_trans: torch.Tensor,
            log_init: torch.Tensor) -> Tuple[np.ndarray, float]:
    """log_emit [T, S], log_trans [S, S] (from -> to), log_init [S], all
    on one device -> (path [T] int32, best log-prob)."""
    t_len, s = log_emit.shape
    prev = log_init + log_emit[0]
    ptrs = []
    for t in range(1, t_len):
        scores = prev[:, None] + log_trans            # [S_from, S_to]
        ptrs.append(torch.argmax(scores, dim=0))       # [S_to]
        prev = torch.amax(scores, dim=0) + log_emit[t]
    # one read: back-pointers, final state and log-prob as float32
    # (state indices < 2**24 are exact in float32)
    packed = torch.cat(([torch.stack(ptrs).reshape(-1).to(torch.float32)]
                        if ptrs else [])
                       + [torch.argmax(prev).reshape(1).to(torch.float32),
                          torch.amax(prev).reshape(1)]).cpu().numpy()
    backptrs = packed[:-2].astype(np.int64).reshape(t_len - 1, s)
    path = np.empty(t_len, np.int32)
    path[-1] = int(packed[-2])
    for t in range(t_len - 2, -1, -1):
        path[t] = backptrs[t, path[t + 1]]
    return path, float(packed[-1])


class Viterbi:
    """decode(emission_probs) -> most likely state sequence, on `device`
    (the card unless ``device="cpu"``)."""

    def __init__(self, transition, initial=None, log_space: bool = False,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        trans = np.asarray(transition, np.float64)
        if not log_space:
            trans = np.log(np.maximum(trans, 1e-300))
        self.log_trans = torch.tensor(trans.astype(np.float32),
                                      device=self.device)
        n = trans.shape[0]
        if initial is None:
            init = np.full(n, -np.log(n))
        else:
            init = np.asarray(initial, np.float64)
            if not log_space:
                init = np.log(np.maximum(init, 1e-300))
        self.log_init = torch.tensor(init.astype(np.float32),
                                     device=self.device)

    def decode(self, emissions, log_space: bool = False):
        """emissions [T, S] (probabilities unless log_space). Returns
        (states [T] np.int32, best_logprob)."""
        e = np.asarray(emissions, np.float64)
        if not log_space:
            e = np.log(np.maximum(e, 1e-300))
        return _decode(torch.tensor(e.astype(np.float32),
                                    device=self.device),
                       self.log_trans, self.log_init)
