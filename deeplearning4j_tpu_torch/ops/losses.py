"""Named loss registry (counterpart of `deeplearning4j_tpu.ops.losses`).

Every loss has signature ``loss(labels, predictions) -> scalar``: for the
built-ins a per-row value reduced over the last axis, then the mean over
every leading axis (batch, and time for sequences).  `register_loss`
adds (or replaces) a loss under a name with that whole-batch signature,
as in the JAX package.  `per_row_loss` gives the per-row values, which
the network's masked sequence loss and example-weighted objective
weight: a built-in's directly (`_ROWS`), a registered loss by
evaluating it on each row alone (``torch.func.vmap`` of
``fn(labels[None], preds[None])``, as the JAX package vmaps it).
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


# The public whole-batch losses, by the JAX package's names.

def mse(labels, preds):
    """Mean squared error, averaged over batch and summed over features."""
    return torch.mean(_sq(labels, preds))


def rmse(labels, preds):
    return torch.sqrt(mse(labels, preds) + _EPS)


def squared_loss(labels, preds):
    """Total squared error (reference SQUARED_LOSS)."""
    return torch.mean(_sq(labels, preds))


def xent(labels, preds):
    """Binary cross-entropy on sigmoid outputs (reference XENT)."""
    return torch.mean(_xent(labels, preds))


def mcxent(labels, preds):
    """Multi-class cross-entropy on softmax outputs (reference MCXENT)."""
    return torch.mean(_mcxent(labels, preds))


def negative_log_likelihood(labels, preds):
    """Reference NEGATIVELOGLIKELIHOOD — same functional form as MCXENT."""
    return mcxent(labels, preds)


def rmse_xent(labels, preds):
    """Reference RMSE_XENT: sqrt of squared error (legacy hybrid)."""
    return torch.mean(_rmse_xent(labels, preds))


def expll(labels, preds):
    """Exponential log-likelihood (Poisson-style, reference EXPLL)."""
    return torch.mean(_expll(labels, preds))


def reconstruction_crossentropy(labels, preds):
    """Reference RECONSTRUCTION_CROSSENTROPY (autoencoder/RBM scoring)."""
    return xent(labels, preds)


def mcxent_with_logits(labels, logits):
    """Fused softmax + cross-entropy on raw logits."""
    return torch.mean(_mcxent_logits(labels, logits))


def xent_with_logits(labels, logits):
    """Fused sigmoid + binary cross-entropy on raw logits."""
    return torch.mean(_xent_logits(labels, logits))


def cosine_proximity(labels, preds):
    return torch.mean(_cosine(labels, preds))


def hinge(labels, preds):
    """Hinge loss; labels in {0,1} one-hot -> mapped to +-1."""
    return torch.mean(_hinge(labels, preds))


def mae(labels, preds):
    return torch.mean(_mae(labels, preds))


_BUILTIN: Dict[str, LossFn] = {
    "mse": mse, "rmse": rmse, "squared_loss": squared_loss, "xent": xent,
    "mcxent": mcxent, "negativeloglikelihood": negative_log_likelihood,
    "rmse_xent": rmse_xent, "expll": expll,
    "reconstruction_crossentropy": reconstruction_crossentropy,
    "mcxent_with_logits": mcxent_with_logits,
    "xent_with_logits": xent_with_logits,
    "cosine_proximity": cosine_proximity, "hinge": hinge, "mae": mae,
}
_LOSSES: Dict[str, LossFn] = dict(_BUILTIN)


def register_loss(name: str, fn: LossFn) -> None:
    """Register `fn(labels, preds) -> scalar` (the mean over the batch)
    under `name` (case-insensitive); replaces a loss of that name."""
    _LOSSES[name.lower()] = fn


def _key(name: str) -> str:
    key = name.lower()
    if key not in _LOSSES:
        raise KeyError(f"Unknown loss '{name}'. Known: {sorted(_LOSSES)}")
    return key


def per_row_loss(name: str, labels: torch.Tensor,
                 preds: torch.Tensor) -> torch.Tensor:
    """The loss of each row on its own (shape ``preds.shape[:-1]``)."""
    key = _key(name)
    fn = _LOSSES[key]
    if fn is not _BUILTIN.get(key):
        lead = preds.shape[:-1]
        rows = torch.func.vmap(lambda yy, oo: fn(yy[None], oo[None]))(
            labels.reshape(-1, labels.shape[-1]),
            preds.reshape(-1, preds.shape[-1]))
        return rows.reshape(lead)
    rows = _ROWS[key](labels, preds)
    return torch.sqrt(rows + _EPS) if key == "rmse" else rows


def get_loss(name: str) -> LossFn:
    return _LOSSES[_key(name)]


def available_losses() -> list[str]:
    return sorted(_LOSSES)


__all__ = ["available_losses", "cosine_proximity", "expll", "get_loss",
           "hinge", "mae", "mcxent", "mcxent_with_logits", "mse",
           "negative_log_likelihood", "per_row_loss",
           "reconstruction_crossentropy", "register_loss", "rmse",
           "rmse_xent", "squared_loss", "xent", "xent_with_logits"]
