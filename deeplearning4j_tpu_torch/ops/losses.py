"""Named loss registry (counterpart of `deeplearning4j_tpu.ops.losses`).

Every loss has signature ``loss(labels, predictions) -> scalar``: a
per-row value reduced over the last axis, then the mean over every
leading axis (batch, and time for sequences).  `per_row_loss` gives the
per-row values themselves, which the network's masked sequence loss
weights (the JAX package gets them by vmapping the loss over rows).
Losses score activated outputs; the ``*_with_logits`` names take raw
logits (``mcxent_with_logits`` is a log-softmax over the last axis).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_EPS = 1e-7


def _clip(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, _EPS, 1.0 - _EPS)


def _sq(labels, preds):
    return torch.sum(torch.square(labels - preds), dim=-1)


def _xent(labels, preds):
    p = _clip(preds)
    return -torch.sum(labels * torch.log(p)
                      + (1.0 - labels) * torch.log(1.0 - p), dim=-1)


def _mcxent(labels, preds):
    return -torch.sum(labels * torch.log(_clip(preds)), dim=-1)


def _rmse_xent(labels, preds):
    return torch.sum(torch.sqrt(torch.square(labels - preds) + _EPS), dim=-1)


def _expll(labels, preds):
    p = _clip(preds)
    return torch.sum(p - labels * torch.log(p), dim=-1)


def _mcxent_logits(labels, logits):
    return -torch.sum(labels * F.log_softmax(logits, dim=-1), dim=-1)


def _xent_logits(labels, logits):
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    return torch.sum(per, dim=-1)


def _cosine(labels, preds):
    ln = torch.linalg.vector_norm(labels, dim=-1) + _EPS
    pn = torch.linalg.vector_norm(preds, dim=-1) + _EPS
    return -torch.sum(labels * preds, dim=-1) / (ln * pn)


def _hinge(labels, preds):
    signed = 2.0 * labels - 1.0
    return torch.sum(torch.clamp(1.0 - signed * preds, min=0.0), dim=-1)


def _mae(labels, preds):
    return torch.sum(torch.abs(labels - preds), dim=-1)


# name -> per-row value (last axis reduced); rmse is the one loss whose
# whole-batch value is not the mean of its rows' (sqrt of the mean)
_ROWS: Dict[str, LossFn] = {
    "mse": _sq, "rmse": _sq, "squared_loss": _sq, "xent": _xent,
    "mcxent": _mcxent, "negativeloglikelihood": _mcxent,
    "rmse_xent": _rmse_xent, "expll": _expll,
    "reconstruction_crossentropy": _xent,
    "mcxent_with_logits": _mcxent_logits,
    "xent_with_logits": _xent_logits, "cosine_proximity": _cosine,
    "hinge": _hinge, "mae": _mae,
}


def _key(name: str) -> str:
    key = name.lower()
    if key not in _ROWS:
        raise KeyError(f"Unknown loss '{name}'. Known: {sorted(_ROWS)}")
    return key


def per_row_loss(name: str, labels: torch.Tensor,
                 preds: torch.Tensor) -> torch.Tensor:
    """The loss of each row on its own (shape ``preds.shape[:-1]``)."""
    key = _key(name)
    rows = _ROWS[key](labels, preds)
    return torch.sqrt(rows + _EPS) if key == "rmse" else rows


def get_loss(name: str) -> LossFn:
    key = _key(name)
    rows = _ROWS[key]
    if key == "rmse":
        return lambda y, p: torch.sqrt(torch.mean(rows(y, p)) + _EPS)
    return lambda y, p: torch.mean(rows(y, p))


def available_losses() -> list[str]:
    return sorted(_ROWS)


__all__ = ["available_losses", "get_loss", "per_row_loss"]
