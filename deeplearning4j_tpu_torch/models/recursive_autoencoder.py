"""Recursive autoencoder over constituency trees, on the device
(counterpart of `deeplearning4j_tpu.models.recursive_autoencoder`).

Parity: reference `nn/layers/feedforward/autoencoder/recursive/
RecursiveAutoEncoder.java` — each internal node encodes its two children
(c = tanh(We [a;b] + be)) and is trained to reconstruct them
(([a';b'] = Wd c + bd), loss = ||[a;b] - [a';b']||^2 summed over internal
nodes).  Runs on the RNTN's padded post-order tree programs and node
loop (models/rntn.py `run_programs`), batched over the trees;
`torch.autograd` for the gradients, AdaGrad with the eps inside the
square root.  `fit` reads the loss curve back once at the end.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models.rntn import (
    adagrad_update,
    loss_and_grads,
    params_from_numpy,
    program_arrays,
    run_programs,
)
from deeplearning4j_tpu_torch.nlp.tree import Tree, compile_trees


def loss_fn(params, arrays) -> torch.Tensor:
    """Mean reconstruction error over the real nodes (JAX's
    ``sum(errs * mask) / max(sum(mask), 1)``); `arrays` = (is_leaf, word,
    left, right, mask)."""
    *prog, mask = arrays
    _, errs = RecursiveAutoEncoder._forward(params, *prog)
    return torch.sum(errs * mask) / torch.clamp(torch.sum(mask), min=1.0)


class RecursiveAutoEncoder:
    """Runs on `device` (the card unless ``device="cpu"``)."""

    def __init__(self, d: int = 32, lr: float = 0.05, epochs: int = 50,
                 seed: int = 0, max_nodes: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.d = d
        self.lr = lr
        self.epochs = epochs
        self.seed = seed
        self.max_nodes = max_nodes
        self.vocab: Dict[str, int] = {"<unk>": 0}
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.losses: List[float] = []

    @classmethod
    def from_numpy(cls, params, vocab: Dict[str, int],
                   **kwargs) -> "RecursiveAutoEncoder":
        """A model holding a JAX autoencoder's parameters and vocabulary;
        d from the shapes."""
        model = cls(d=np.shape(params["We"])[1], **kwargs)
        model.params = params_from_numpy(params, model.device)
        model.vocab = dict(vocab)
        return model

    def _init_params(self) -> Dict[str, torch.Tensor]:
        """The JAX package's draws: numpy ``default_rng(seed)`` in the
        order embed, We, Wd."""
        rng = np.random.default_rng(self.seed)
        d = self.d

        def r(*shape, scale):
            return rng.standard_normal(shape) * scale

        return params_from_numpy({
            "embed": r(len(self.vocab), d, scale=0.1),
            "We": r(2 * d, d, scale=1.0 / np.sqrt(2 * d)),
            "be": np.zeros((d,)),
            "Wd": r(d, 2 * d, scale=1.0 / np.sqrt(d)),
            "bd": np.zeros((2 * d,)),
        }, self.device)

    @staticmethod
    def _forward(params, is_leaf, word, left, right) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
        """Every tree at once; returns (buffer [B, N, d], per-node
        reconstruction error [B, N], 0 at leaves)."""
        errs = []
        not_leaf = (1 - is_leaf).to(params["embed"].dtype)

        def encode(a, b, t):
            ab = torch.cat([a, b], dim=1)
            enc = torch.tanh(ab @ params["We"] + params["be"])
            recon = enc @ params["Wd"] + params["bd"]
            errs.append(torch.sum((recon - ab) ** 2, dim=1) * not_leaf[:, t])
            return enc

        buf = run_programs(params, is_leaf, word, left, right, encode)
        return buf, torch.stack(errs, dim=1)

    def fit(self, trees: Sequence[Tree]) -> "RecursiveAutoEncoder":
        for t in trees:
            for w in t.tokens():
                self.vocab.setdefault(w, len(self.vocab))
        prog = compile_trees(trees, self.vocab, self.max_nodes)
        if self.params is None:
            self.params = self._init_params()
        arrays = program_arrays(prog, self.device, with_targets=False) + (
            torch.from_numpy(prog.mask).to(self.device),)
        ada = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.losses = []
        device_losses = []
        for _ in range(self.epochs):
            loss, grads = loss_and_grads(loss_fn, self.params, arrays)
            self.params, ada = adagrad_update(self.params, ada, grads,
                                              self.lr)
            device_losses.append(loss)
        if device_losses:
            self.losses = torch.stack(device_losses).tolist()
        return self

    def encode(self, trees: Sequence[Tree]) -> np.ndarray:
        """Root vector per tree [B, d] — the sentence embedding."""
        prog = compile_trees(trees, self.vocab, self.max_nodes)
        with torch.no_grad():
            bufs, _ = self._forward(self.params, *program_arrays(
                prog, self.device, with_targets=False))
            root = torch.from_numpy(prog.root.astype(np.int64))
            return bufs[torch.arange(len(prog), device=self.device),
                        root.to(self.device)].cpu().numpy()
