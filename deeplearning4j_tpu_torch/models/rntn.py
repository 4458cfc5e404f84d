"""RNTN: recursive neural tensor network (Socher sentiment model) on the
device (counterpart of `deeplearning4j_tpu.models.rntn`).

Parity: reference `models/rntn/RNTN.java:82` — binary tensor combine
(`:344-356`: h = tanh(W [a;b] + [a;b]^T V [a;b])), per-node softmax
sentiment classification, AdaGrad training, `RNTNEval.java` (node/root
accuracy).  Each binarized tree is a padded post-order program
(nlp/tree.py `compile_trees`); the forward runs the programs node by
node, batched over the trees, as the JAX package's vmapped `lax.scan`
does, and `torch.autograd` differentiates it.

The node buffer ``[B, N, d]`` is written out of place
(`Tensor.index_copy`): an in-place write into a buffer autograd saved
for an earlier gather would break the gradient.  A padded node (is_leaf
0, left = right = 0) combines ``buf[0]`` with itself and the loss mask
drops it; both branches of the leaf / combine ``torch.where`` are
computed and the unselected one gets a zero gradient, as in JAX.  The
JAX package wrote no Pallas kernel here (XLA's einsum and gathers), so
the products are plain PyTorch ops.  `fit` queues every epoch without a
host read and reads the loss curve back once at the end.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.tree import Tree, TreeProgram, compile_trees

# the parameters the L2 term leaves out
_NO_L2 = ("b", "bs")


def _combine(params, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tensor combine of child vectors [B, d] x [B, d] -> [B, d]."""
    ab = torch.cat([a, b], dim=1)                              # [B, 2d]
    std = ab @ params["W"] + params["b"]                       # [B, d]
    tensor = torch.einsum("bi,ijk,bj->bk", ab, params["V"], ab)
    return torch.tanh(std + tensor)


def run_programs(params, is_leaf, word, left, right,
                 node_fn) -> torch.Tensor:
    """The node loop shared by the tree models: ``[B, N]`` int64 program
    arrays on the parameters' device -> the node buffer ``[B, N, d]``.
    Node t of every tree is ``tanh(embed[word])`` at a leaf, else
    ``node_fn(buf[left], buf[right], t)``."""
    embed = params["embed"]
    bsz, n = is_leaf.shape
    d = embed.shape[1]
    # `F.embedding`'s backward reduces duplicate rows by segment (every
    # internal and padded node reads row 0); advanced indexing's backward
    # accumulates them one after another
    leaf_vecs = torch.tanh(torch.nn.functional.embedding(word, embed))
    is_leaf_col = (is_leaf == 1)[:, :, None]
    steps = torch.arange(n, device=embed.device)
    # children as rows of the flattened [B * N, d] buffer, one row of
    # indices a step: `index_select`'s backward is an `index_add_` (no
    # index sort, as advanced indexing's backward has)
    base = torch.arange(bsz, device=embed.device)[None, :] * n
    left_rows = (left.T + base).contiguous()                   # [N, B]
    right_rows = (right.T + base).contiguous()
    buf = torch.zeros(bsz, n, d, dtype=embed.dtype, device=embed.device)
    for t in range(n):
        flat = buf.view(bsz * n, d)
        comb = node_fn(flat.index_select(0, left_rows[t]),
                       flat.index_select(0, right_rows[t]), t)
        vec = torch.where(is_leaf_col[:, t], leaf_vecs[:, t], comb)
        buf = buf.index_copy(1, steps[t:t + 1], vec[:, None, :])
    return buf


def _batch_logits(params, prog_arrays) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Every tree program at once: the node buffer [B, N, d] and the
    logits [B, N, C]."""
    bufs = run_programs(params, *prog_arrays,
                        lambda a, b, t: _combine(params, a, b))
    logits = torch.einsum("bnd,dc->bnc", bufs, params["Ws"]) + params["bs"]
    return bufs, logits


def loss_fn(params, arrays, reg: float) -> torch.Tensor:
    """The JAX package's objective (`rntn.py:109-121`): mean NLL over the
    real nodes that carry a label, plus `reg` times the L2 of every
    parameter but ``b`` and ``bs`` (``embed`` included).  `arrays` =
    (is_leaf, word, left, right, label, mask) with mask = real AND
    labelled."""
    is_leaf, word, left, right, label, mask = arrays
    _, logits = _batch_logits(params, (is_leaf, word, left, right))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, label[..., None])[..., 0]
    data = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    l2 = sum(torch.sum(p * p) for k, p in params.items() if k not in _NO_L2)
    return data + reg * l2


def loss_and_grads(loss, params, *args) -> Tuple[torch.Tensor, Dict]:
    """(loss, {name: gradient}) of ``loss(params, *args)`` by autograd,
    with `params` left untouched."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    value = loss(leaves, *args)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


def adagrad_update(params, ada, grads, lr: float) -> Tuple[Dict, Dict]:
    """``p - lr g / sqrt(h + 1e-8)`` with ``h = ada + g^2``: the eps sits
    inside the square root, as in the JAX package (not after it, as in
    the port's Adam)."""
    new_p, new_a = {}, {}
    with torch.no_grad():
        for k in params:
            h = ada[k] + grads[k] * grads[k]
            new_p[k] = params[k] - lr * grads[k] / torch.sqrt(h + 1e-8)
            new_a[k] = h
    return new_p, new_a


def program_arrays(prog: TreeProgram, device: torch.device,
                   with_targets: bool = True) -> tuple:
    """A program's arrays on `device`: int64 indices (and the label and
    real-and-labelled mask when `with_targets`)."""
    idx = tuple(torch.from_numpy(a.astype(np.int64)).to(device) for a in (
        prog.is_leaf, prog.word, prog.left, prog.right))
    if not with_targets:
        return idx
    return idx + (torch.from_numpy(prog.label.astype(np.int64)).to(device),
                  torch.from_numpy(prog.mask * prog.labeled).to(device))


def params_from_numpy(params, device: DeviceLike = None) -> Dict[
        str, torch.Tensor]:
    """A JAX tree model's parameter dict (arrays) as float32 tensors on
    `device`, copied: no tensor shares memory with its source."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.array(v, np.float32), device=dev)
            for k, v in params.items()}


class RNTN:
    """fit on labelled trees; predicts a class per node (root = sentence).

    Defaults follow the reference: d=25 features, AdaGrad lr 0.01
    (the defaults of RNTN.java), parameters initialised small-random.
    Runs on `device` (the card unless ``device="cpu"``).
    """

    def __init__(self, num_classes: int = 5, d: int = 25, lr: float = 0.01,
                 reg: float = 1e-4, epochs: int = 20, seed: int = 0,
                 max_nodes: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.d = d
        self.lr = lr
        self.reg = reg
        self.epochs = epochs
        self.seed = seed
        self.max_nodes = max_nodes
        self.vocab: Dict[str, int] = {"<unk>": 0}
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.losses: List[float] = []

    @classmethod
    def from_numpy(cls, params, vocab: Dict[str, int],
                   **kwargs) -> "RNTN":
        """A model holding a JAX RNTN's parameters and vocabulary (its
        ``params`` and ``vocab``); d and the class count from the
        shapes."""
        d, c = np.shape(params["Ws"])
        model = cls(num_classes=c, d=d, **kwargs)
        model.params = params_from_numpy(params, model.device)
        model.vocab = dict(vocab)
        return model

    # -- vocab --------------------------------------------------------------
    def _build_vocab(self, trees: Sequence[Tree]) -> None:
        for t in trees:
            for w in t.tokens():
                if w not in self.vocab:
                    self.vocab[w] = len(self.vocab)

    def _init_params(self) -> Dict[str, torch.Tensor]:
        """The JAX package's draws: numpy ``default_rng(seed)`` in the
        order embed, W, V, Ws."""
        rng = np.random.default_rng(self.seed)
        d, c, v = self.d, self.num_classes, len(self.vocab)

        def r(*shape, scale):
            return rng.standard_normal(shape) * scale

        return params_from_numpy({
            "embed": r(v, d, scale=0.1),
            "W": r(2 * d, d, scale=1.0 / np.sqrt(2 * d)),
            "b": np.zeros((d,)),
            "V": r(2 * d, 2 * d, d, scale=1.0 / (2 * d)),
            "Ws": r(d, c, scale=1.0 / np.sqrt(d)),
            "bs": np.zeros((c,)),
        }, self.device)

    # -- training -----------------------------------------------------------
    def _step(self, params, ada, arrays):
        loss, grads = loss_and_grads(loss_fn, params, arrays, self.reg)
        new_p, new_a = adagrad_update(params, ada, grads, self.lr)
        return new_p, new_a, loss

    def fit(self, trees: Sequence[Tree]) -> "RNTN":
        self._build_vocab(trees)
        prog = compile_trees(trees, self.vocab, self.max_nodes)
        if self.params is None:
            self.params = self._init_params()
        ada = {k: torch.zeros_like(v) for k, v in self.params.items()}
        arrays = program_arrays(prog, self.device)
        # every epoch queued without a host read; the loss curve comes
        # back in one read at the end
        self.losses = []     # a failed fit must not keep a stale curve
        device_losses = []
        for _ in range(self.epochs):
            self.params, ada, loss = self._step(self.params, ada, arrays)
            device_losses.append(loss)
        if device_losses:
            self.losses = torch.stack(device_losses).tolist()
        return self

    # -- inference ----------------------------------------------------------
    def _compile(self, trees: Sequence[Tree]) -> TreeProgram:
        return compile_trees(trees, self.vocab, self.max_nodes)

    def _predict_all(self, prog: TreeProgram) -> np.ndarray:
        """argmax class of every node [B, N] (one host read)."""
        with torch.no_grad():
            _, logits = _batch_logits(self.params, program_arrays(
                prog, self.device, with_targets=False))
            return torch.argmax(logits, dim=-1).cpu().numpy()

    def predict_nodes(self, trees: Sequence[Tree]) -> List[np.ndarray]:
        """Per-tree array of predicted class per (post-order) node."""
        if self.params is None:
            raise ValueError("fit() first")
        prog = self._compile(trees)
        pred = self._predict_all(prog)
        out = []
        for i in range(len(prog)):
            real = int(prog.mask[i].sum())
            out.append(pred[i, :real])
        return out

    def predict(self, trees: Sequence[Tree]) -> np.ndarray:
        """Root (whole-sentence) class per tree."""
        prog = self._compile(trees)
        pred = self._predict_all(prog)
        return pred[np.arange(len(prog)), prog.root]


class RNTNEval:
    """Node-level and root-level accuracy (reference RNTNEval.java)."""

    def __init__(self):
        self.node_correct = 0
        self.node_total = 0
        self.root_correct = 0
        self.root_total = 0

    def eval(self, model: RNTN, trees: Sequence[Tree]) -> None:
        prog = model._compile(trees)
        node_preds = model.predict_nodes(trees)
        root_preds = model.predict(trees)
        for i, preds in enumerate(node_preds):
            real = int(prog.mask[i].sum())
            labels = prog.label[i, :real]
            self.node_correct += int((preds == labels).sum())
            self.node_total += real
            self.root_correct += int(root_preds[i] == prog.label[i,
                                                               prog.root[i]])
            self.root_total += 1

    def node_accuracy(self) -> float:
        return self.node_correct / max(self.node_total, 1)

    def root_accuracy(self) -> float:
        return self.root_correct / max(self.root_total, 1)

    def stats(self) -> str:
        return (f"RNTN eval: node acc {self.node_accuracy():.4f} "
                f"({self.node_correct}/{self.node_total}), root acc "
                f"{self.root_accuracy():.4f} "
                f"({self.root_correct}/{self.root_total})")
