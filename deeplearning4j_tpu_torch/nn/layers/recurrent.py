"""Recurrent layers: Graves LSTM (peepholes), vanilla LSTM, GRU
(counterpart of `deeplearning4j_tpu.nn.layers.recurrent`).

Parity: reference GravesLSTM.java:47 — Graves (2013) LSTM with peephole
connections, forget-gate bias initialised to 5.0 (:63-73); and the older
LSTM.java:58.  Params per layer: ``W [n_in, 4n]``, ``RW [n, 4n]``, ``b
[4n]`` and, with peepholes, ``pi``/``pf``/``po`` ``[n]``; gate order
``[i, f, o, g]``; activations ``[batch, time, features]``.

Path policy for the LSTMs, decided from the conf before any call.  With
no mask and the tanh activation the time loop is the fused scan
(`lstm_kernel.fused_lstm_scan`: the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor) when the conf says ``fused=True``, or
says nothing (``fused=None``) and the width is one the kernel takes
(``n_out <= lstm_kernel.MAX_HIDDEN``).  ``fused=False``, ``fused=None``
above that width, a mask or another activation runs the step-by-step
scan in the compute dtype, as the JAX package's ``lax.scan`` body does;
that is a configured path, not a fallback.  An explicit ``fused=True``
above the width raises the kernel's ``ValueError`` on the card.  The JAX
package resolves ``fused=None`` to its scan for any width (unless its
environment switch is set): the two paths agree in f32, and in bf16
differ by design (the fused scan carries h and c in f32).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers import LayerImpl, register_layer_impl
from deeplearning4j_tpu_torch.nn.layers.common import apply_dropout
from deeplearning4j_tpu_torch.nn.layers.lstm_kernel import (
    MAX_HIDDEN,
    fused_lstm_scan,
)
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.initializers import init_weights


def _lstm_init(conf, gen, dtype, peephole: bool):
    n_in, n = conf.n_in, conf.n_out
    b = torch.zeros((4 * n,), dtype=dtype)
    # Gate order: [i, f, o, g]. Forget-gate bias init per the reference.
    b[n:2 * n] = conf.forget_gate_bias_init
    params = {
        "W": init_weights(gen, (n_in, 4 * n), conf.weight_init, dtype,
                          conf.distribution),
        "RW": init_weights(gen, (n, 4 * n), conf.weight_init, dtype,
                           conf.distribution),
        "b": b,
    }
    if peephole:
        # Peephole vectors (the "+3" columns of the reference's packed RW).
        params["pi"] = torch.zeros((n,), dtype=dtype)
        params["pf"] = torch.zeros((n,), dtype=dtype)
        params["po"] = torch.zeros((n,), dtype=dtype)
    return params, {}


def uses_fused_scan(conf, mask) -> bool:
    """The path policy: the fused scan unless a mask, a non-tanh
    activation or ``fused=False`` asks for the step-by-step scan;
    ``fused=None`` means the fused scan only up to the kernel's width
    (``MAX_HIDDEN``)."""
    if mask is not None or conf.activation.lower() != "tanh":
        return False
    if conf.fused is None:
        return conf.n_out <= MAX_HIDDEN
    return bool(conf.fused)


def _lstm_apply(conf, params, state, x, *, train=False, rng=None, mask=None,
                peephole: bool = True):
    """x: [batch, time, n_in]; mask: optional [batch, time] (1=valid)."""
    x = apply_dropout(x, conf.dropout, train, rng)
    n = conf.n_out
    batch = x.shape[0]
    act = get_activation(conf.activation)

    # The input projection for every step at once: one [B*T, n_in] x
    # [n_in, 4n] product; the time loop only carries the recurrent one.
    xz = torch.matmul(x, params["W"]) + params["b"]
    xz_t = xz.transpose(0, 1)  # [time, batch, 4n], a view

    if uses_fused_scan(conf, mask):
        zeros = torch.zeros((n,), dtype=x.dtype, device=x.device)
        hs = fused_lstm_scan(
            xz_t, params["RW"],
            params["pi"] if peephole else zeros,
            params["pf"] if peephole else zeros,
            params["po"] if peephole else zeros)
        if conf.return_sequences:
            return hs.transpose(0, 1), state
        return hs[-1], state

    mask_t = (None if mask is None
              else mask.to(x.dtype).transpose(0, 1)[..., None])  # [T,B,1]
    h = torch.zeros((batch, n), dtype=x.dtype, device=x.device)
    c = torch.zeros((batch, n), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(xz_t.shape[0]):
        h_prev, c_prev = h, c
        z = xz_t[t] + h_prev @ params["RW"]
        zi, zf, zo, zg = torch.split(z, n, dim=-1)
        if peephole:
            zi = zi + c_prev * params["pi"]
            zf = zf + c_prev * params["pf"]
        i = torch.sigmoid(zi)
        f = torch.sigmoid(zf)
        g = act(zg)
        c = f * c_prev + i * g
        if peephole:
            zo = zo + c * params["po"]
        o = torch.sigmoid(zo)
        h = o * act(c)
        if mask_t is not None:
            m = mask_t[t]
            h = m * h + (1 - m) * h_prev
            c = m * c + (1 - m) * c_prev
        hs.append(h)
    if conf.return_sequences:
        return torch.stack(hs, dim=1), state  # [batch, time, n]
    return h, state


def graves_lstm_init(conf: L.GravesLSTMConf, gen, dtype=torch.float32):
    return _lstm_init(conf, gen, dtype, peephole=True)


def graves_lstm_apply(conf, params, state, x, **kw):
    return _lstm_apply(conf, params, state, x, peephole=True, **kw)


register_layer_impl("graveslstm", LayerImpl(graves_lstm_init,
                                            graves_lstm_apply))


def lstm_init(conf: L.LSTMConf, gen, dtype=torch.float32):
    return _lstm_init(conf, gen, dtype, peephole=False)


def lstm_apply(conf, params, state, x, **kw):
    return _lstm_apply(conf, params, state, x, peephole=False, **kw)


register_layer_impl("lstm", LayerImpl(lstm_init, lstm_apply))


# ---- GRU: no kernel in either package --------------------------------------

def gru_init(conf: L.GRUConf, gen, dtype=torch.float32):
    n_in, n = conf.n_in, conf.n_out
    params = {
        "W": init_weights(gen, (n_in, 3 * n), conf.weight_init, dtype,
                          conf.distribution),
        "RW": init_weights(gen, (n, 3 * n), conf.weight_init, dtype,
                           conf.distribution),
        "b": torch.zeros((3 * n,), dtype=dtype),
    }
    return params, {}


def gru_apply(conf, params, state, x, *, train=False, rng=None, mask=None):
    x = apply_dropout(x, conf.dropout, train, rng)
    n = conf.n_out
    act = get_activation(conf.activation)
    xz_t = (torch.matmul(x, params["W"]) + params["b"]).transpose(0, 1)
    mask_t = (None if mask is None
              else mask.to(x.dtype).transpose(0, 1)[..., None])
    h = torch.zeros((x.shape[0], n), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(xz_t.shape[0]):
        h_prev = h
        zr, zu, zc = torch.split(xz_t[t], n, dim=-1)
        rr, ru, rc = torch.split(h_prev @ params["RW"], n, dim=-1)
        r = torch.sigmoid(zr + rr)
        u = torch.sigmoid(zu + ru)
        cand = act(zc + r * rc)
        h = u * h_prev + (1 - u) * cand
        if mask_t is not None:
            m = mask_t[t]
            h = m * h + (1 - m) * h_prev
        hs.append(h)
    if conf.return_sequences:
        return torch.stack(hs, dim=1), state
    return h, state


register_layer_impl("gru", LayerImpl(gru_init, gru_apply))
