"""Int8 weight-quantized inference (counterpart of
`deeplearning4j_tpu.precision.quantize`).

Per-channel symmetric int8 quantization stores each dense or conv weight
as int8 plus one float32 scale per output channel, about 4x fewer
resident parameter bytes.  For a per-output-channel scale ``s[j]``,
``x @ dequant(Q) == (x @ Q) * s`` exactly in the compute dtype, so the
products run on the int8 weights cast to the compute dtype and the
scale applies to the (smaller) output.  In the JAX package these are XLA
casts and a product outside any Pallas kernel; here they are a cast and
`torch.matmul`, or the conv route of `nn.layers.convolution` (NHWC, XLA's
SAME padding): no hand kernel is involved.

`QuantizedNet` wraps a trained `MultiLayerNetwork` for inference: dense,
output, RNN-output and convolution layers take the int8 weights, every
other layer its normal apply on the original float params.  It has the
float net's serving surface (`output`, `output_bucketed`, `predict`,
`forward_program_count`).  The KV-page quantizers are numpy, as in the
JAX package (host-side page shipping).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.precision.policy import dtype_of, tree_bytes


# Layer type tags whose {W, b} params take the int8 dense/conv products.
_DENSE_TAGS = ("denselayer", "outputlayer", "rnnoutputlayer")
_CONV_TAGS = ("convolutionlayer",)


def quantize_symmetric(w, axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel symmetric int8 quantization along `axis` (the output-
    channel axis): (q int8, scale float32), dequant = q * scale."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, np.float32(1.0), scale)  # all-zero channel
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis=reduce_axes).astype(np.float32)


def dequantize(q: np.ndarray, scale: np.ndarray, axis: int = -1
               ) -> np.ndarray:
    """Reference dequantization (the products never materialize it)."""
    q = np.asarray(q, np.float32)
    shape = [1] * q.ndim
    shape[axis % q.ndim] = -1
    return q * np.asarray(scale, np.float32).reshape(shape)


def quantize_kv_pages(pages: np.ndarray, valid: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-page symmetric int8 quantization of a KV page stack
    ``[L, P, ps, H, K]``, one scale per (layer, page, head).  Positions
    at or past `valid` (page-major) are zeroed before the scale is taken,
    so stale rows of a partly filled tail page cannot inflate it.
    Returns (q int8 ``[L, P, ps, H, K]``, scale float32 ``[L, P, H]``)."""
    w = np.asarray(pages, np.float32)
    if w.ndim != 5:
        raise ValueError(f"page stack must be [L, P, ps, H, K], "
                         f"got shape {w.shape}")
    L, P, ps, H, K = w.shape
    if valid is not None:
        pos = np.arange(P * ps).reshape(P, ps)
        w = np.where((pos < int(valid))[None, :, :, None, None], w, 0.0)
    amax = np.max(np.abs(w), axis=(2, 4), keepdims=True)  # [L, P, 1, H, 1]
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, np.float32(1.0), scale)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale.reshape(L, P, H).astype(np.float32)


def dequantize_kv_pages(q: np.ndarray, scale: np.ndarray,
                        dtype=np.float32) -> np.ndarray:
    """Inverse of `quantize_kv_pages`: a float page stack in `dtype`."""
    q = np.asarray(q)
    if q.ndim != 5:
        raise ValueError(f"page stack must be [L, P, ps, H, K], "
                         f"got shape {q.shape}")
    L, P, ps, H, K = q.shape
    s = np.asarray(scale, np.float32).reshape(L, P, 1, H, 1)
    return (q.astype(np.float32) * s).astype(dtype)


def int8_dense(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               b: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``(x @ Q) * s + b`` in the compute dtype, Q cast from int8 (a
    ``[B, T, in]`` sequence head takes the same product per step)."""
    ct = dtype_of(compute_dtype)
    z = x.to(ct) @ q.to(ct)
    return z * scale.to(ct) + b.to(ct)


def int8_conv(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              b: torch.Tensor, compute_dtype, strides, padding
              ) -> torch.Tensor:
    """NHWC convolution on int8 HWIO weights cast to the compute dtype
    (the port's conv route, XLA's SAME padding); the per-output-channel
    scale applies to the ``[B, H, W, cout]`` result."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        _conv_nhwc,
        pad_nchw,
    )

    ct = dtype_of(compute_dtype)
    w = q.to(ct)
    xc = pad_nchw(x.to(ct), padding, tuple(w.shape[:2]), tuple(strides))
    z = _conv_nhwc(xc, w, tuple(strides))
    return z * scale.to(ct) + b.to(ct)


def quantize_net_params(net) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Quantize every eligible layer of a network's params: eligible
    layers get ``{"W_q": int8, "W_scale": f32[cout], "b": f32}`` and kind
    "dense" or "conv", every other layer keeps its float params (kind
    "passthrough").  Tensors on the network's device."""
    dev = net.device
    qparams: List[Dict[str, Any]] = []
    kinds: List[str] = []
    for lc, p in zip(net.conf.layers, net.params):
        tag = lc.type_tag()
        if tag in _DENSE_TAGS + _CONV_TAGS and "W" in p:
            w = p["W"].detach().float().cpu().numpy()
            q, s = quantize_symmetric(w, axis=-1)
            qparams.append({
                "W_q": torch.from_numpy(q).to(dev),
                "W_scale": torch.from_numpy(s).to(dev),
                "b": p["b"].detach().float().to(dev)})
            kinds.append("dense" if tag in _DENSE_TAGS else "conv")
        else:
            qparams.append({k: v.detach() for k, v in p.items()})
            kinds.append("passthrough")
    return qparams, kinds


class QuantizedNet:
    """Inference-only int8-weight view of a `MultiLayerNetwork`, with the
    float net's serving surface.  Quantization error is bounded per
    channel (|w - dequant(q)| <= amax/254)."""

    def __init__(self, net, dtype: str = "int8",
                 compute_dtype: Optional[str] = None):
        if dtype != "int8":
            raise ValueError(f"unsupported quantization dtype {dtype!r} "
                             f"(int8 only)")
        if net.params is None:
            net.init()
        self.net = net
        self.dtype = dtype
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else net.precision.compute_dtype)
        self.qparams, self.kinds = quantize_net_params(net)
        self.quantized_layers = sum(k != "passthrough" for k in self.kinds)
        self._signatures: set = set()
        self._bucket_programs = None

    # ---- forward -----------------------------------------------------------

    @torch.no_grad()
    def _forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        """`MultiLayerNetwork._forward` (inference) with the int8
        products on the quantized layers."""
        from deeplearning4j_tpu_torch.models.multi_layer_network import (
            _cast_floating,
            apply_preprocessor,
        )
        from deeplearning4j_tpu_torch.nn.layers.common import activate

        net = self.net
        ct = dtype_of(self.compute_dtype)
        if x.is_floating_point():
            x = x.to(ct)
        for i, (lc, kind) in enumerate(zip(net.conf.layers, self.kinds)):
            if str(i) in net.conf.input_preprocessors:
                x = apply_preprocessor(net.conf.input_preprocessors[str(i)],
                                       x)
            p = self.qparams[i]
            if kind == "dense":
                x = activate(lc, int8_dense(x, p["W_q"], p["W_scale"],
                                            p["b"], ct))
            elif kind == "conv":
                x = activate(lc, int8_conv(x, p["W_q"], p["W_scale"],
                                           p["b"], ct, lc.stride,
                                           lc.padding))
            else:
                is_rnn_layer = x.dim() == 3
                x, _ = net.impls[i].apply(
                    lc, _cast_floating(p, ct), net.state[i], x, train=False,
                    rng=None, mask=mask if is_rnn_layer else None)
        return x.to(dtype_of(net.precision.output_dtype))

    def output(self, x, mask=None) -> torch.Tensor:
        from deeplearning4j_tpu_torch.models.multi_layer_network import (
            _as_tensor,
        )

        x = _as_tensor(x, self.net.device)
        mask = _as_tensor(mask, self.net.device)
        self._signatures.add((tuple(x.shape), x.dtype, mask is not None))
        return self._forward(x, mask)

    def output_bucketed(self, x, mask=None, ladder=None) -> np.ndarray:
        """Pad the batch up the ladder, one program a bucket, slice on the
        host (the float net's `output_bucketed` discipline)."""
        from deeplearning4j_tpu_torch.models.multi_layer_network import (
            _host_input,
        )
        from deeplearning4j_tpu_torch.runtime.programs import (
            BucketPrograms,
        )
        from deeplearning4j_tpu_torch.serving.bucketing import BucketLadder
        from deeplearning4j_tpu_torch.tree import tree_leaves

        if ladder is None:
            ladder = BucketLadder()
        padded, n = ladder.pad_rows(_host_input(x))
        if mask is not None:
            mask, _ = ladder.pad_rows(_host_input(mask))
        if self._bucket_programs is None:
            self._bucket_programs = BucketPrograms(
                self.net.device,
                lambda xt, mt: self._forward(xt, mt).float(),
                lambda: [*tree_leaves(self.qparams),
                         *tree_leaves(self.net.state)])
        self._signatures.add((tuple(padded.shape),
                              torch.from_numpy(padded[:0]).dtype,
                              mask is not None))
        out = self._bucket_programs(padded, mask)
        return out if n == padded.shape[0] else out[:n]

    def predict(self, x, mask=None) -> np.ndarray:
        return self.output(x, mask).argmax(dim=-1).cpu().numpy()

    def forward_program_count(self) -> int:
        """Distinct input signatures (shape, dtype, mask present) the
        forward has run: the JAX count of compiled forward programs,
        which the bucket ladder bounds (`output_bucketed` builds one
        program for each)."""
        return len(self._signatures)

    # ---- accounting --------------------------------------------------------

    def param_bytes(self) -> int:
        """Resident serving parameter bytes: int8 weights + f32 scales +
        f32 biases + any passthrough float params."""
        return tree_bytes(self.qparams)

    def quantization_report(self) -> Dict[str, Any]:
        return {
            "dtype": self.dtype,
            "quantized_layers": self.quantized_layers,
            "total_layers": len(self.kinds),
            "param_bytes": self.param_bytes(),
            "float_param_bytes": tree_bytes(self.net.params),
        }


__all__ = ["QuantizedNet", "dequantize", "dequantize_kv_pages", "int8_conv",
           "int8_dense", "quantize_kv_pages", "quantize_net_params",
           "quantize_symmetric"]
