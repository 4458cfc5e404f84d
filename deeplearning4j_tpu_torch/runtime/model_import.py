"""Import external models (counterpart of
`deeplearning4j_tpu.runtime.model_import`).

Parity-plus: the reference reserved a module for model import and never
built it (`dl4j-caffe/` — pom only, SURVEY §2.4).  Two importers, by the
JAX package's rules, so both packages build the same model from the same
weights:

- `import_torch_sequential`: a `torch.nn.Sequential` of Linear / Conv2d
  / MaxPool2d / AvgPool2d / Flatten / Dropout / activations -> the port's
  `MultiLayerNetwork`, with layouts transposed to the framework's:
  Linear.weight [out, in] -> W [in, out]; Conv2d.weight [out, in, kh, kw]
  -> W [kh, kw, in, out] (HWIO, NHWC inputs).  The weights go through
  numpy into the conf layout, as in the JAX package.
- `import_hf_gpt2`: a HuggingFace-style GPT-2 (anything with a
  ``.config`` carrying GPT-2's fields and a ``.state_dict()`` under HF's
  names) -> ``(TransformerConfig, params)`` of `parallel/transformer.py`.
  ``transformers`` is never imported.

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayerConf,
    DenseLayerConf,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    OutputLayerConf,
    SubsamplingLayerConf,
)

_ACTIVATIONS = {
    "ReLU": "relu",
    "Tanh": "tanh",
    "Sigmoid": "sigmoid",
    "Softmax": "softmax",
    "GELU": "gelu",
    "LeakyReLU": "leakyrelu",
    "Identity": "identity",
}


def _np(t) -> np.ndarray:
    """A float32 numpy copy of a tensor (any device, any float dtype) or
    an array: the imported weights never share memory with the source."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.array(t, np.float32)


def _next_activation(mods: List, i: int) -> Tuple[str, int]:
    """Peek whether module i+1 is an activation; returns (name, skip)."""
    if i + 1 < len(mods):
        name = type(mods[i + 1]).__name__
        if name in _ACTIVATIONS:
            return _ACTIVATIONS[name], 1
    return "identity", 0


def _pool_dims(m) -> Tuple[tuple, tuple]:
    k = m.kernel_size if isinstance(m.kernel_size, tuple) else (
        m.kernel_size, m.kernel_size)
    s = m.stride if isinstance(m.stride, tuple) else (
        (m.stride, m.stride) if m.stride else k)
    return k, s


def import_torch_sequential(model, learning_rate: float = 0.01,
                            updater: str = "sgd",
                            device: DeviceLike = None):
    """torch.nn.Sequential -> (MultiLayerNetwork on `device`, conversion
    report).

    The LAST Linear becomes an OutputLayerConf (softmax + cross-entropy by
    convention, matching how Caffe/DL4J classifiers terminate)."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    dev = resolve_device(device)
    mods = list(model)
    last_linear = max((i for i, m in enumerate(mods)
                      if isinstance(m, torch.nn.Linear)), default=None)
    if last_linear is None:
        raise ValueError("no Linear layer found — nothing to classify with")

    confs: List = []
    params: List[dict] = []
    report: List[str] = []
    preprocessors = {}
    last_channels: Optional[int] = None   # conv channels for flatten reorder
    pending_flatten = False
    i = 0
    while i < len(mods):
        m = mods[i]
        name = type(m).__name__
        if isinstance(m, torch.nn.Linear):
            w = _np(m.weight).T                      # [in, out]
            if pending_flatten and last_channels:
                # torch flattened NCHW (channel-major); the cnn_to_ffn
                # preprocessor flattens NHWC (channel-last): permute the
                # weight ROWS accordingly. H/W split assumed square.
                c = last_channels
                hw = w.shape[0] // c
                side = int(round(hw ** 0.5))
                if side * side != hw:
                    raise ValueError(
                        "cannot infer square spatial dims for flatten "
                        f"reorder (features={w.shape[0]}, channels={c})")
                idx = (np.arange(w.shape[0])
                       .reshape(c, side, side)      # torch (c, h, w) order
                       .transpose(1, 2, 0)          # ours  (h, w, c)
                       .ravel())
                w = w[idx]
                report.append("flatten reorder: NCHW->NHWC row permutation")
            pending_flatten = False
            b = (_np(m.bias) if m.bias is not None
                 else np.zeros(w.shape[1], np.float32))
            if i == last_linear:
                confs.append(OutputLayerConf(
                    n_in=w.shape[0], n_out=w.shape[1]))
                report.append(f"{name} -> OutputLayer"
                              f" [{w.shape[0]}->{w.shape[1]}]")
                i += 1
            else:
                act, skip = _next_activation(mods, i)
                confs.append(DenseLayerConf(
                    n_in=w.shape[0], n_out=w.shape[1], activation=act))
                report.append(f"{name}(+{act}) -> DenseLayer")
                i += 1 + skip
            params.append({"W": w, "b": b})
        elif isinstance(m, torch.nn.Conv2d):
            if m.groups != 1:
                raise ValueError("grouped conv import not supported")
            w = np.ascontiguousarray(
                np.transpose(_np(m.weight), (2, 3, 1, 0)))      # HWIO
            b = (_np(m.bias) if m.bias is not None
                 else np.zeros(w.shape[3], np.float32))
            act, skip = _next_activation(mods, i)
            pad = m.padding if isinstance(m.padding, str) else (
                "SAME" if any(np.atleast_1d(m.padding)) else "VALID")
            confs.append(ConvolutionLayerConf(
                n_in=w.shape[2], n_out=w.shape[3],
                kernel_size=(w.shape[0], w.shape[1]),
                stride=tuple(np.atleast_1d(m.stride)[:2].tolist())
                if np.atleast_1d(m.stride).size else (1, 1),
                padding=pad if isinstance(pad, str) else "VALID",
                activation=act))
            report.append(f"{name}(+{act}) -> ConvolutionLayer "
                          f"k={w.shape[0]}x{w.shape[1]}")
            last_channels = w.shape[3]
            params.append({"W": w, "b": b})
            i += 1 + skip
        elif isinstance(m, torch.nn.MaxPool2d):
            k, s = _pool_dims(m)
            confs.append(SubsamplingLayerConf(kernel_size=k, stride=s,
                                              pooling_type="max"))
            report.append(f"{name} -> SubsamplingLayer k={k}")
            params.append({})
            i += 1
        elif isinstance(m, torch.nn.AvgPool2d):
            k, s = _pool_dims(m)
            confs.append(SubsamplingLayerConf(kernel_size=k, stride=s,
                                              pooling_type="avg"))
            report.append(f"{name} -> SubsamplingLayer(avg) k={k}")
            params.append({})
            i += 1
        elif isinstance(m, torch.nn.Flatten):
            preprocessors[str(len(confs))] = {"type": "cnn_to_ffn"}
            report.append(f"{name} -> cnn_to_ffn preprocessor")
            pending_flatten = True
            i += 1
        elif isinstance(m, torch.nn.Dropout):
            report.append(f"{name} -> folded into surrounding layers "
                          "(inference import)")
            i += 1
        elif name in _ACTIVATIONS:
            # standalone activation not consumed by a previous layer
            report.append(f"{name} -> skipped (leading activation)")
            i += 1
        else:
            raise ValueError(f"unsupported module for import: {name}")

    mlc = MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=learning_rate,
                                    updater=updater),
        layers=tuple(confs),
        input_preprocessors=preprocessors)
    net = MultiLayerNetwork(mlc, device=dev).init()
    for li, p in enumerate(params):
        for key, val in p.items():
            ref = net.params[li][key]
            if tuple(ref.shape) != val.shape:
                raise ValueError(
                    f"layer {li} param {key}: shape "
                    f"{val.shape} != expected {tuple(ref.shape)}")
            net.params[li][key] = (
                torch.from_numpy(val).to(device=ref.device, dtype=ref.dtype)
                .requires_grad_(ref.is_floating_point()))
    return net, report


# ---------------------------------------------------------------------------
# HuggingFace GPT-2 -> TransformerLM (parallel/transformer.py)


def import_hf_gpt2(model, device: DeviceLike = None):
    """Import a HuggingFace ``GPT2LMHeadModel`` (or any object with its
    ``.config`` fields and ``.state_dict()`` names) into the port's
    TransformerLM: returns ``(TransformerConfig, params)`` usable with
    ``parallel.transformer.apply``, the params on `device` (the card
    unless the caller asks for the CPU), in float32.

    GPT-2 is pre-LN with learned positions, tanh-gelu and attention
    projection biases (``attn_bias=True``); the mapping is the JAX
    package's:

    - wte/wpe            -> embed [V,d] / pos [P,d]; head = lm_head.T
      (the same matrix as wte for tied checkpoints, honoured when not)
    - h[i].ln_1/ln_2     -> layers[i].ln1/ln2 {scale, bias}
    - h[i].attn.c_attn   -> wq/wk/wv [d,h,k] + bq/bk/bv [h,k]
      (HF Conv1D stores [in, out] with y = x @ W + b; the 3d output axis
      splits q,k,v and reshapes head-major, matching HF's split_heads)
    - h[i].attn.c_proj   -> wo [h,k,d] + bo [d]
    - h[i].mlp.c_fc/c_proj -> w1 [d,f]+b1 / w2 [f,d]+b2
    - ln_f               -> final layer norm

    Refused, as in the JAX package: an activation other than tanh-gelu,
    a layer-norm epsilon other than 1e-5, and the attention variants
    (`scale_attn_by_inverse_layer_idx`, `reorder_and_upcast_attn`,
    `scale_attn_weights=False`)."""
    from deeplearning4j_tpu_torch.parallel.transformer import (
        TransformerConfig,
        params_from_numpy,
    )

    dev = resolve_device(device)
    hf = model.config
    act = getattr(hf, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"unsupported activation {act!r}: the TransformerLM uses "
            f"tanh-approximated gelu (gelu_new)")
    eps = getattr(hf, "layer_norm_epsilon", 1e-5)
    if abs(eps - 1e-5) > 1e-12:
        raise ValueError(f"unsupported layer_norm_epsilon {eps}: the "
                         f"TransformerLM hard-codes 1e-5")
    for flag in ("scale_attn_by_inverse_layer_idx",
                 "reorder_and_upcast_attn", "scale_attn_weights"):
        v = getattr(hf, flag, None)
        ok = flag == "scale_attn_weights"
        if v is not None and v is not ok:
            raise ValueError(f"unsupported GPT-2 variant: {flag}={v} "
                             f"changes attention math vs this TransformerLM")
    d, h = hf.n_embd, hf.n_head
    k = d // h
    n_inner = getattr(hf, "n_inner", None)
    f = n_inner if n_inner is not None else 4 * d
    cfg = TransformerConfig(vocab_size=hf.vocab_size, d_model=d, n_heads=h,
                            n_layers=hf.n_layer, d_ff=f,
                            max_len=hf.n_positions, attn_bias=True)
    sd = dict(model.state_dict())
    prefix = "transformer." if any(s.startswith("transformer.")
                                   for s in sd) else ""

    def g(name):
        return _np(sd[prefix + name])

    wte = g("wte.weight")
    layers = []
    for i in range(hf.n_layer):
        p = f"h.{i}."
        ca_w, ca_b = g(p + "attn.c_attn.weight"), g(p + "attn.c_attn.bias")
        wq, wk, wv = np.split(ca_w, 3, axis=1)
        bq, bk, bv = np.split(ca_b, 3)
        layers.append({
            "ln1": {"scale": g(p + "ln_1.weight"),
                    "bias": g(p + "ln_1.bias")},
            "ln2": {"scale": g(p + "ln_2.weight"),
                    "bias": g(p + "ln_2.bias")},
            "attn": {
                "wq": wq.reshape(d, h, k), "wk": wk.reshape(d, h, k),
                "wv": wv.reshape(d, h, k),
                "bq": bq.reshape(h, k), "bk": bk.reshape(h, k),
                "bv": bv.reshape(h, k),
                "wo": g(p + "attn.c_proj.weight").reshape(h, k, d),
                "bo": g(p + "attn.c_proj.bias"),
            },
            "mlp": {
                "w1": g(p + "mlp.c_fc.weight"),
                "b1": g(p + "mlp.c_fc.bias"),
                "w2": g(p + "mlp.c_proj.weight"),
                "b2": g(p + "mlp.c_proj.bias"),
            },
        })
    tree = {
        "embed": wte,
        "pos": g("wpe.weight"),
        "layers": layers,
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
        # an untied checkpoint's lm_head.weight is its own matrix; a tied
        # one's is wte (HF's state_dict lists it, or leaves it out)
        "head": (_np(sd["lm_head.weight"]) if "lm_head.weight" in sd
                 else wte).T,
    }
    return cfg, params_from_numpy(tree, device=dev)


__all__ = ["import_hf_gpt2", "import_torch_sequential"]
