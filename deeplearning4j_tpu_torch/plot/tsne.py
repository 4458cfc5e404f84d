"""Exact t-SNE on the device (counterpart of `deeplearning4j_tpu.plot.tsne`).

Parity: reference `plot/Tsne.java:49` — `computeGaussianPerplexity():127`
(per-point binary search for the Gaussian beta hitting the target
perplexity) and `calculate():208` (gradient loop with momentum, adaptive
per-element gains and early exaggeration).  The perplexity search runs
every row's bisection at once, each row frozen once it converges (the JAX
package's vmapped `lax.while_loop`); the gradient loop is a Python loop
of [n, n] tensor ops on the device, in float32.  The initial layout is
drawn from a `torch.Generator` seeded with `seed`: `jax.random` draws
cannot be matched bit for bit, so the fits of the two packages differ
from their first step.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device

EPS = 1e-12


def _as_f32(x, device: DeviceLike) -> torch.Tensor:
    """`x` as a float32 tensor: a tensor stays on its device, anything
    else goes to `device` (None = the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=resolve_device(device))


def _sq_dists(x: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances with a zero diagonal (full float32
    products: TF32 would break self-distance == 0)."""
    n2 = torch.sum(x * x, dim=1)
    d2 = n2[:, None] + n2[None, :] - 2.0 * (x @ x.T)
    d2 = torch.clamp(d2, min=0.0)
    return d2 * (1.0 - torch.eye(d2.shape[0], dtype=d2.dtype,
                                 device=d2.device))


def row_search(d2: torch.Tensor, perplexity: float, tol: float = 1e-5,
               max_iter: int = 50):
    """Every row's binary search on beta (Tsne.java:127's hBeta loop) at
    once; a row stops updating once its entropy is within `tol` of
    log(perplexity) or after `max_iter` updates.  Returns (the row
    affinities [n, n], each row summing to 1; beta [n])."""
    n = d2.shape[0]
    dev = d2.device
    log_u = torch.log(torch.tensor(perplexity, dtype=torch.float32,
                                   device=dev))
    off_diag = ~torch.eye(n, dtype=torch.bool, device=dev)

    def entropy_p(beta):
        p = torch.where(off_diag, torch.exp(-d2 * beta[:, None]), 0.0)
        sum_p = torch.clamp(torch.sum(p, dim=1), min=EPS)
        h = torch.log(sum_p) + beta * torch.sum(d2 * p, dim=1) / sum_p
        return h, p / sum_p[:, None]

    beta = torch.ones(n, dtype=torch.float32, device=dev)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    for _ in range(max_iter):
        h, _ = entropy_p(beta)
        active = torch.abs(h - log_u) > tol
        if not bool(active.any()):
            break
        too_high = h > log_u      # entropy too high -> narrow the Gaussian
        new_lo = torch.where(too_high, beta, lo)
        new_hi = torch.where(too_high, hi, beta)
        new_beta = torch.where(
            too_high,
            torch.where(torch.isinf(new_hi), beta * 2.0,
                        (beta + new_hi) / 2.0),
            torch.where(torch.isinf(new_lo), beta / 2.0,
                        (beta + new_lo) / 2.0))
        beta = torch.where(active, new_beta, beta)
        lo = torch.where(active, new_lo, lo)
        hi = torch.where(active, new_hi, hi)
    _, p = entropy_p(beta)
    return p, beta


def gaussian_perplexity(x, perplexity: float,
                        device: DeviceLike = None) -> torch.Tensor:
    """Symmetrized input affinity matrix P [n, n] (float32, on `x`'s
    device for a tensor, else on `device`)."""
    rows, _ = row_search(_sq_dists(_as_f32(x, device)), perplexity)
    p = rows + rows.T
    return torch.clamp(p / torch.clamp(torch.sum(p), min=EPS), min=EPS)


def tsne_step(y: torch.Tensor, dy: torch.Tensor, gains: torch.Tensor,
              p: torch.Tensor, it: int, learning_rate: float = 500.0,
              initial_momentum: float = 0.5, final_momentum: float = 0.8,
              switch_momentum_iter: int = 250, stop_lying_iter: int = 250,
              exaggeration: float = 4.0, min_gain: float = 0.01):
    """One gradient-descent iteration of exact t-SNE from (y, dy, gains)
    at iteration `it`; returns the new (y, dy, gains), y centred."""
    n = p.shape[0]
    d2 = _sq_dists(y)
    num = 1.0 / (1.0 + d2)
    num = num * (1.0 - torch.eye(n, dtype=y.dtype, device=y.device))
    q = torch.clamp(num / torch.clamp(torch.sum(num), min=EPS), min=EPS)
    p_eff = p * exaggeration if it < stop_lying_iter else p
    pq = (p_eff - q) * num
    grad = 4.0 * ((torch.diag(torch.sum(pq, dim=1)) - pq) @ y)
    momentum = (initial_momentum if it < switch_momentum_iter
                else final_momentum)
    same_sign = torch.sign(grad) == torch.sign(dy)
    gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                        min=min_gain)
    dy = momentum * dy - learning_rate * gains * grad
    y = y + dy
    return y - torch.mean(y, dim=0), dy, gains


def kl_divergence(p: torch.Tensor, y: torch.Tensor) -> float:
    """KL(P || Q) of a layout `y` against the input affinities `p`."""
    n = p.shape[0]
    num = 1.0 / (1.0 + _sq_dists(y))
    num = num * (1.0 - torch.eye(n, dtype=y.dtype, device=y.device))
    q = torch.clamp(num / torch.clamp(torch.sum(num), min=EPS), min=EPS)
    return float(torch.sum(p * torch.log(p / q)))


def tsne_fit(x, seed: int = 0, n_components: int = 2,
             perplexity: float = 30.0, learning_rate: float = 500.0,
             n_iter: int = 1000, initial_momentum: float = 0.5,
             final_momentum: float = 0.8, switch_momentum_iter: int = 250,
             stop_lying_iter: int = 250, exaggeration: float = 4.0,
             min_gain: float = 0.01,
             device: DeviceLike = None) -> torch.Tensor:
    """A full exact-t-SNE run; returns Y [n, n_components] on the device.
    The initial layout is ``1e-4 * N(0, 1)`` from a generator seeded with
    `seed`."""
    x = _as_f32(x, device)
    p = gaussian_perplexity(x, perplexity)
    n = p.shape[0]
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    y = 1e-4 * torch.randn((n, n_components), generator=gen,
                           dtype=torch.float32, device=x.device)
    dy = torch.zeros_like(y)
    gains = torch.ones_like(y)
    for it in range(n_iter):
        y, dy, gains = tsne_step(
            y, dy, gains, p, it, learning_rate=learning_rate,
            initial_momentum=initial_momentum,
            final_momentum=final_momentum,
            switch_momentum_iter=switch_momentum_iter,
            stop_lying_iter=stop_lying_iter, exaggeration=exaggeration,
            min_gain=min_gain)
    return y


class Tsne:
    """Builder-style surface mirroring Tsne.java's Builder; runs on
    `device` (the card unless ``device="cpu"``)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 500.0, n_iter: int = 1000,
                 seed: int = 0, device: DeviceLike = None, **kwargs):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.seed = seed
        self.device = resolve_device(device)
        self.kwargs = kwargs
        self.y: Optional[np.ndarray] = None

    def calculate(self, x) -> np.ndarray:
        self.y = tsne_fit(
            x, seed=self.seed, n_components=self.n_components,
            perplexity=self.perplexity, learning_rate=self.learning_rate,
            n_iter=self.n_iter, device=self.device,
            **self.kwargs).cpu().numpy()
        return self.y

    fit_transform = calculate

    def save_coords(self, path: str, labels=None) -> None:
        """CSV of coords(,label) — the format the UI t-SNE resource serves."""
        if self.y is None:
            raise ValueError("calculate() first")
        with open(path, "w", encoding="utf-8") as f:
            for i, row in enumerate(self.y):
                cells = [f"{v:.6f}" for v in row]
                if labels is not None:
                    cells.append(str(labels[i]))
                f.write(",".join(cells) + "\n")
