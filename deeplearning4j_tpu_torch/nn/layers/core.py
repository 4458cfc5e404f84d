"""Core feedforward layers: dense, output, batch-norm, embedding, dropout,
activation (counterpart of `deeplearning4j_tpu.nn.layers.core`).

Parity: reference BaseLayer.preOutput() = x.mmul(W).addiRowVector(b)
(BaseLayer.java:328-345) and activate() (:347-357); OutputLayer.java:57.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers import LayerImpl, register_layer_impl
from deeplearning4j_tpu_torch.nn.layers.common import (
    activate,
    apply_dropout,
    dense_params,
    effective_weights,
    input_dropout,
)
from deeplearning4j_tpu_torch.ops.initializers import init_weights


# ---- dense ---------------------------------------------------------------

def dense_init(conf: L.DenseLayerConf, gen, dtype=torch.float32):
    return dense_params(conf, gen, dtype), {}


def dense_apply(conf, params, state, x, *, train=False, rng=None, mask=None):
    x = input_dropout(conf, x, train, rng)
    z = x @ effective_weights(conf, params, train, rng) + params["b"]
    return activate(conf, z), state


register_layer_impl("denselayer", LayerImpl(dense_init, dense_apply))


# ---- output --------------------------------------------------------------
# Same forward as dense; the loss lives in the model-level objective, which
# fuses softmax+CE on logits for stability (ops/losses mcxent_with_logits).

register_layer_impl("outputlayer", LayerImpl(dense_init, dense_apply))


def rnn_output_apply(conf, params, state, x, *, train=False, rng=None,
                     mask=None):
    # x: [batch, time, features] — apply the dense head per timestep.
    x = input_dropout(conf, x, train, rng)
    z = torch.einsum("bti,io->bto", x,
                     effective_weights(conf, params, train, rng)) + params["b"]
    return activate(conf, z), state


register_layer_impl("rnnoutputlayer", LayerImpl(dense_init, rnn_output_apply))


# ---- batch norm ----------------------------------------------------------

def batchnorm_init(conf: L.BatchNormConf, gen, dtype=torch.float32):
    n = conf.n_out or conf.n_in
    params = {"scale": torch.ones((n,), dtype=dtype),
              "bias": torch.zeros((n,), dtype=dtype)}
    state = {"mean": torch.zeros((n,), dtype=torch.float32),
             "var": torch.ones((n,), dtype=torch.float32)}
    return params, state


def batchnorm_apply(conf, params, state, x, *, train=False, rng=None,
                    mask=None):
    axes = tuple(range(x.dim() - 1))  # normalise over all but the channel axis
    if train:
        # Moments always accumulate in f32: a bf16 sum-of-squares over a
        # real batch loses most of its mantissa, and the running stats
        # feed every later inference.
        xf = x.float()
        mean_f32 = xf.mean(dim=axes)
        var_f32 = xf.var(dim=axes, unbiased=False)
        m = conf.momentum
        # running stats update from the full-resolution f32 moments;
        # only the copies used to normalize this batch drop to x.dtype
        new_state = {
            "mean": (m * state["mean"] + (1 - m) * mean_f32).detach(),
            "var": (m * state["var"] + (1 - m) * var_f32).detach(),
        }
        mean = mean_f32.to(x.dtype)
        var = var_f32.to(x.dtype)
    else:
        mean, var = state["mean"].to(x.dtype), state["var"].to(x.dtype)
        new_state = state
    inv = torch.rsqrt(var + conf.epsilon)
    y = (x - mean) * inv * params["scale"] + params["bias"]
    return activate(conf, y), new_state


register_layer_impl("batchnorm", LayerImpl(batchnorm_init, batchnorm_apply))


# ---- embedding -----------------------------------------------------------

def embedding_init(conf: L.EmbeddingLayerConf, gen, dtype=torch.float32):
    tbl = init_weights(gen, (conf.n_in, conf.n_out), conf.weight_init, dtype,
                       conf.distribution)
    return {"table": tbl}, {}


def embedding_apply(conf, params, state, ids, *, train=False, rng=None,
                    mask=None):
    # ids: integer tensor of any shape -> [..., n_out]
    out = params["table"][ids.long()]
    return activate(conf, out), state


register_layer_impl("embeddinglayer", LayerImpl(embedding_init,
                                                 embedding_apply))


# ---- dropout / activation-only ------------------------------------------

def _stateless_init(conf, gen, dtype=torch.float32):
    return {}, {}


def dropout_apply(conf, params, state, x, *, train=False, rng=None,
                  mask=None):
    return apply_dropout(x, conf.dropout, train, rng), state


register_layer_impl("dropoutlayer", LayerImpl(_stateless_init, dropout_apply))


def activation_apply(conf, params, state, x, *, train=False, rng=None,
                     mask=None):
    return activate(conf, x), state


register_layer_impl("activationlayer", LayerImpl(_stateless_init,
                                                 activation_apply))
