"""The numbers that decide ``correct``, each held to its limit.

Serving (greedy requests only; a sampled token has no single right
answer), over a sample of the finished requests drawn from the seed with
the longest in it: ``served_gap``, the widest gap by which a served
token's logit lies below the reference's largest logit at its position,
and ``served_gap_mean``, that gap's mean over every checked position.

Training, over the first steps, taken by the worst leaf and measured
against the reference's norm of that leaf or of the median leaf,
whichever is larger:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the gap of the first gradient's norm, as the optimizer
  takes it (the program's read from its first moment after one step);
- ``grad_dist``: the distance between the program's first gradient and
  the reference's, ``|g - g_ref|`` (the gradients themselves, not their
  norms), by the worst leaf, and ``grad_dist_median``, by the median
  leaf;
- ``change_gap``: the gap of the parameters' change over the steps;
  leaves whose first reference gradient is under a thousandth of the
  median leaf's (nought to rounding, as a key bias under softmax) are
  left out.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import torch


def served_gap(gaps: List[List[float]]) -> float:
    return max(max(g) for g in gaps if g)


def served_gap_mean(gaps: List[List[float]]) -> float:
    flat = [x for g in gaps for x in g]
    return sum(flat) / len(flat)


def _relative(diff: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """``diff[leaf] / max(ref[leaf], the median leaf's ref)`` for the
    leaves `keep` admits."""
    names = [n for n in ref if keep is None or keep(n)]
    floor = statistics.median(ref[n] for n in names)
    return {n: diff[n] / max(ref[n], floor, 1e-30) for n in names}


def _worst(diff: Dict[str, float], ref: Dict[str, float],
           keep=None) -> Tuple[float, str]:
    """The largest relative gap (`_relative`) and its leaf."""
    rel = _relative(diff, ref, keep)
    at = max(rel, key=rel.get)
    return rel[at], at


def _gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    return {n: abs(prog[n] - ref[n]) for n in ref}


def train_numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    """prog / ref: ``{"loss": [..], "grad": {leaf: norm}, "first":
    {leaf: tensor}, "change": {leaf: norm}}`` (ref also ``grad_raw``)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                   ref["loss"]))
    grad, grad_at = _worst(_gaps(prog["grad"], ref["grad"]), ref["grad"])
    dist = {n: float(torch.linalg.vector_norm(
        prog["first"][n].float() - ref["first"][n].float()))
        for n in ref["first"]}
    grad_dist, dist_at = _worst(dist, ref["grad"])
    dist_median = statistics.median(_relative(dist, ref["grad"]).values())
    raw = ref["grad_raw"]
    floor = 1e-3 * statistics.median(raw.values())
    change, change_at = _worst(_gaps(prog["change"], ref["change"]),
                               ref["change"], keep=lambda n: raw[n] >= floor)
    left_out = sorted(n for n in raw if raw[n] < floor)
    return {"loss_gap": {"value": loss},
            "grad_gap": {"value": grad, "leaf": grad_at},
            "grad_dist": {"value": grad_dist, "leaf": dist_at},
            "grad_dist_median": {"value": dist_median},
            "change_gap": {"value": change, "leaf": change_at,
                           "left_out": left_out}}


def judge(numbers: Dict[str, dict], limits: Optional[dict]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(every compared number within its limit, ``{name: {value,
    limit}}``).  A number the limits file does not compare is reported
    with its reading and limit None; without a limits file nothing can
    pass."""
    checks, ok = {}, limits is not None
    compared = (limits or {}).get("numbers", {})
    for name, num in numbers.items():
        lim = compared.get(name, {}).get("limit")
        checks[name] = {"value": num["value"], "limit": lim}
        if lim is not None and not num["value"] <= lim:
            ok = False
    if limits is not None and not any(
            compared.get(n, {}).get("limit") is not None for n in numbers):
        ok = False
    return ok, checks
