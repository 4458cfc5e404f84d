"""Unsupervised pretraining layers: the denoising AutoEncoder and the RBM
(counterpart of `deeplearning4j_tpu.nn.layers.pretrain`).

Parity: reference autoencoder/AutoEncoder.java (corruption, tied weights,
visible bias) and rbm/RBM.java:66 (CD-k :102, Gibbs :259, propUp/propDown
:311/:348, BINARY/GAUSSIAN/RECTIFIED/SOFTMAX units).  Both layers also act
as plain feedforward encoders inside a stack.

Sampling draws from a `torch.Generator` (Philox on the card), which can
never reproduce `jax.random`'s threefry bits: the chain's draws differ
from the JAX package's, while its statistics agree.  CD-k is a gradient
estimator, not the gradient of a loss, so `rbm_cd_grads` runs the Gibbs
chain (`rbm_gibbs_chain`) and then `cd_statistics`, a pure function of
the chain's means, which tests hold against the JAX package's own
intermediate values.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers import LayerImpl, register_layer_impl
from deeplearning4j_tpu_torch.nn.layers.common import (
    activate,
    apply_dropout,
    dense_params,
)
from deeplearning4j_tpu_torch.ops import losses


# ---- AutoEncoder ---------------------------------------------------------

def ae_init(conf: L.AutoEncoderConf, gen, dtype=torch.float32):
    params = dense_params(conf, gen, dtype)
    params["vb"] = torch.zeros((conf.n_in,), dtype=dtype)  # decoder bias
    return params, {}


def ae_apply(conf, params, state, x, *, train=False, rng=None, mask=None):
    x = apply_dropout(x, conf.dropout, train, rng)
    return activate(conf, x @ params["W"] + params["b"]), state


register_layer_impl("autoencoder", LayerImpl(ae_init, ae_apply))


def ae_reconstruct(conf: L.AutoEncoderConf, params, h) -> torch.Tensor:
    """Decode with tied weights ``W.T`` + visible bias."""
    return torch.sigmoid(h @ params["W"].T + params["vb"])


def corrupt(x: torch.Tensor, level: float,
            gen: torch.Generator) -> torch.Tensor:
    """`x` with each entry kept with probability ``1 - level`` and zeroed
    otherwise (the JAX package's Bernoulli keep mask)."""
    if level <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - level
    return torch.where(keep, x, torch.zeros_like(x))


def ae_pretrain_loss(conf: L.AutoEncoderConf, params, x,
                     rng: torch.Generator) -> torch.Tensor:
    """Denoising-AE objective: corrupt, encode, decode, score the
    reconstruction against the clean input."""
    corrupted = corrupt(x, conf.corruption_level, rng)
    h = activate(conf, corrupted @ params["W"] + params["b"])
    return losses.get_loss(conf.loss)(x, ae_reconstruct(conf, params, h))


# ---- RBM -----------------------------------------------------------------

def rbm_init(conf: L.RBMConf, gen, dtype=torch.float32):
    params = dense_params(conf, gen, dtype)  # W [n_vis, n_hid], b hidden
    params["vb"] = torch.zeros((conf.n_in,), dtype=dtype)
    return params, {}


def rbm_apply(conf, params, state, x, *, train=False, rng=None, mask=None):
    # As a stack layer the RBM is its propUp mean (reference propUp :311).
    x = apply_dropout(x, conf.dropout, train, rng)
    return _unit_mean(conf.hidden_unit, x @ params["W"] + params["b"]), state


register_layer_impl("rbm", LayerImpl(rbm_init, rbm_apply))


def _unit_mean(unit: str, z: torch.Tensor) -> torch.Tensor:
    unit = unit.lower()
    if unit == "binary":
        return torch.sigmoid(z)
    if unit == "gaussian":
        return z
    if unit == "rectified":
        return torch.relu(z)
    if unit == "softmax":
        return torch.softmax(z, dim=-1)
    raise ValueError(f"Unknown RBM unit type: {unit}")


def _unit_sample(unit: str, mean: torch.Tensor, z: torch.Tensor,
                 gen: torch.Generator) -> torch.Tensor:
    unit = unit.lower()
    if unit == "binary":
        return (torch.rand(mean.shape, generator=gen, device=mean.device)
                < mean).to(mean.dtype)
    if unit == "gaussian":
        return mean + torch.randn(mean.shape, generator=gen,
                                  device=mean.device, dtype=mean.dtype)
    if unit == "rectified":
        # NReLU: relu(z + N(0, sigmoid(z))) (Nair & Hinton 2010), the
        # reference's RECTIFIED sampling in RBM.java:217-296
        noise = torch.randn(mean.shape, generator=gen, device=mean.device,
                            dtype=mean.dtype)
        return torch.relu(z + noise * torch.sqrt(torch.sigmoid(z)))
    if unit == "softmax":
        probs = (mean.float() + 1e-9).reshape(-1, mean.shape[-1])
        idx = torch.multinomial(probs, 1, generator=gen).reshape(
            mean.shape[:-1])
        return F.one_hot(idx, mean.shape[-1]).to(mean.dtype)
    raise ValueError(f"Unknown RBM unit type: {unit}")


def rbm_gibbs_chain(conf: L.RBMConf, params, v0: torch.Tensor,
                    gen: torch.Generator) -> Tuple[torch.Tensor, ...]:
    """CD-k's chain from the data `v0`: ``(h0_mean, vk_mean, hk_mean)``,
    the hidden mean at the data and the visible and hidden means of the
    k-th Gibbs step (each step samples v from the sampled h, then h)."""
    w, hb, vb = params["W"], params["b"], params["vb"]
    hz = v0 @ w + hb
    h0_mean = _unit_mean(conf.hidden_unit, hz)
    h = _unit_sample(conf.hidden_unit, h0_mean, hz, gen)
    for _ in range(conf.k):
        vz = h @ w.T + vb
        v_mean = _unit_mean(conf.visible_unit, vz)
        v = _unit_sample(conf.visible_unit, v_mean, vz, gen)
        hz = v @ w + hb
        h_mean = _unit_mean(conf.hidden_unit, hz)
        h = _unit_sample(conf.hidden_unit, h_mean, hz, gen)
    return h0_mean, v_mean, h_mean


def cd_statistics(v0, h0_mean, vk_mean, hk_mean
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """CD's gradient from the chain's means, in the descent direction
    (ready for an updater): ``-(positive - negative)`` statistics, and the
    reconstruction cross-entropy of the clipped ``vk_mean``."""
    n = v0.shape[0]
    grads = {
        "W": -(v0.T @ h0_mean - vk_mean.T @ hk_mean) / n,
        "b": -torch.mean(h0_mean - hk_mean, dim=0),
        "vb": -torch.mean(v0 - vk_mean, dim=0),
    }
    recon_err = losses.get_loss("reconstruction_crossentropy")(
        v0, torch.clamp(vk_mean, 0.0, 1.0))
    return grads, recon_err


@torch.no_grad()
def rbm_cd_grads(conf: L.RBMConf, params, v0: torch.Tensor,
                 gen: torch.Generator
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """CD-k gradient estimator (reference contrastiveDivergence
    RBM.java:102): (grads, reconstruction error)."""
    return cd_statistics(v0, *rbm_gibbs_chain(conf, params, v0, gen))


def rbm_pretrain_loss(conf: L.RBMConf, params, x, rng=None) -> torch.Tensor:
    """Monitoring score: reconstruction cross-entropy of one mean-field
    pass (the reference scores RBMs the same way via setScoreWithZ)."""
    h = _unit_mean(conf.hidden_unit, x @ params["W"] + params["b"])
    v = _unit_mean(conf.visible_unit, h @ params["W"].T + params["vb"])
    return losses.get_loss("reconstruction_crossentropy")(
        x, torch.clamp(v, 1e-6, 1 - 1e-6))


__all__ = ["ae_apply", "ae_init", "ae_pretrain_loss", "ae_reconstruct",
           "cd_statistics", "corrupt", "rbm_apply", "rbm_cd_grads",
           "rbm_gibbs_chain", "rbm_init", "rbm_pretrain_loss"]
