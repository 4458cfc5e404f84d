"""Convolution and subsampling (pooling) layers (counterpart of
`deeplearning4j_tpu.nn.layers.convolution`).

Parity: reference ConvolutionLayer.java:49 and SubsamplingLayer.java:51
(MAX/AVG/SUM/NONE pooling).  Activations are NHWC and the kernel is kept
HWIO ``[kh, kw, in, out]``, as in the JAX package, so parameter vectors
and saved models are shared.  ``x.permute(0, 3, 1, 2)`` is a free
channels-last NCHW view of an NHWC tensor, so `F.conv2d` and the pooling
ops (cuDNN on the card) read the activations in place, and the result
permutes back to NHWC without a copy.

Padding follows XLA's: ``"SAME"`` pads ``max((ceil(n/s) - 1)*s + k - n, 0)``
along each spatial axis, half before and the odd one after (the bottom /
right edge); ``"VALID"`` pads nothing.  `F.conv2d(padding="same")` takes
no stride and the pooling ops pad symmetrically, so the padding is
explicit (`F.pad`): zeros for the convolution and the sum, ``-inf`` for
the max.  A SAME average divides each window by the number of real
elements it covers, not by ``kh*kw``.

On the card a float32 convolution is im2col and one matmul
(`im2col_conv`): a strided view of the NHWC input, copied once as
``[N*oh*ow, in*kh*kw]`` rows, times the kernel as ``[in*kh*kw, out]``.
cuDNN takes the weight gradient of some float32 convolutions by
Winograd, whose error on LeNet-5's first layer is beyond the 1e-4
relative to which `chip_smoke.py` holds the card's float32 gradients
against the CPU's, and `F.conv2d` with cuDNN off takes 6 to 15 times as
long a training step (PERF.md).  bfloat16 on the card (cuDNN) and every
dtype on the CPU take `F.conv2d`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers import LayerImpl, register_layer_impl
from deeplearning4j_tpu_torch.nn.layers.common import activate, apply_dropout
from deeplearning4j_tpu_torch.ops.initializers import init_weights


def same_pads(size: int, k: int, s: int) -> tuple:
    """(before, after) padding of one spatial axis under XLA's "SAME"."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _nchw_padded(conf, x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """NHWC `x` as a channels-last NCHW view, padded for ``conf.padding``
    with `value`."""
    return pad_nchw(x, conf.padding, conf.kernel_size, conf.stride, value)


def pad_nchw(x: torch.Tensor, padding: str, kernel_size, stride,
             value: float = 0.0) -> torch.Tensor:
    """NHWC `x` as a channels-last NCHW view, padded as XLA pads
    `padding` ("SAME" or "VALID") for a `kernel_size` window at `stride`,
    with `value`."""
    xc = x.permute(0, 3, 1, 2)
    pad = padding.upper()
    if pad == "VALID":
        return xc
    if pad != "SAME":
        raise ValueError(f"Unknown padding: {padding!r} (SAME|VALID)")
    (kh, kw), (sh, sw) = kernel_size, stride
    top, bottom = same_pads(x.shape[1], kh, sh)
    left, right = same_pads(x.shape[2], kw, sw)
    if top == bottom == left == right == 0:
        return xc
    return F.pad(xc, (left, right, top, bottom), value=value)


def conv_init(conf: L.ConvolutionLayerConf, gen, dtype=torch.float32):
    kh, kw = conf.kernel_size
    shape = (kh, kw, conf.n_in, conf.n_out)  # HWIO
    return {"W": init_weights(gen, shape, conf.weight_init, dtype,
                              conf.distribution),
            "b": torch.zeros((conf.n_out,), dtype=dtype)}, {}


def im2col_conv(xc: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    """`_conv_nhwc` as im2col over the whole batch and one matmul."""
    kh, kw, cin, cout = w.shape
    cols = xc.permute(0, 2, 3, 1).unfold(1, kh, stride[0]).unfold(
        2, kw, stride[1])                       # [N, oh, ow, in, kh, kw]
    n, oh, ow = cols.shape[:3]
    w_mat = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return (cols.reshape(n * oh * ow, cin * kh * kw) @ w_mat).reshape(
        n, oh, ow, cout)


def _conv_nhwc(xc: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    """Cross-correlation of the padded NCHW view `xc` with the HWIO kernel
    `w`, as NHWC."""
    if xc.is_cuda and xc.dtype == torch.float32:
        return im2col_conv(xc, w, stride)
    return F.conv2d(xc, w.permute(3, 2, 0, 1),
                    stride=stride).permute(0, 2, 3, 1)


def conv_apply(conf, params, state, x, *, train=False, rng=None, mask=None):
    x = apply_dropout(x, conf.dropout, train, rng)
    z = _conv_nhwc(_nchw_padded(conf, x), params["W"], tuple(conf.stride))
    return activate(conf, z + params["b"]), state


register_layer_impl("convolutionlayer", LayerImpl(conv_init, conv_apply))


def _pool_init(conf, gen, dtype=torch.float32):
    return {}, {}


def _window_sum(xc: torch.Tensor, conf) -> torch.Tensor:
    return F.avg_pool2d(xc, tuple(conf.kernel_size), tuple(conf.stride),
                        divisor_override=1)


def pool_apply(conf: L.SubsamplingLayerConf, params, state, x, *,
               train=False, rng=None, mask=None):
    kind = conf.pooling_type.lower()
    if kind == "none":
        return x, state
    if kind == "max":
        out = F.max_pool2d(_nchw_padded(conf, x, -math.inf),
                           tuple(conf.kernel_size), tuple(conf.stride))
    elif kind in ("avg", "sum"):
        out = _window_sum(_nchw_padded(conf, x), conf)
        if kind == "avg":
            if conf.padding.upper() == "SAME":
                # border windows divide by their real elements only
                ones = torch.ones((1, x.shape[1], x.shape[2], 1),
                                  dtype=x.dtype, device=x.device)
                out = out / _window_sum(_nchw_padded(conf, ones), conf)
            else:
                kh, kw = conf.kernel_size
                out = out / float(kh * kw)
    else:
        raise ValueError(f"Unknown pooling type: {conf.pooling_type}")
    return activate(conf, out.permute(0, 2, 3, 1)), state


register_layer_impl("subsamplinglayer", LayerImpl(_pool_init, pool_apply))
