"""KV page shipping: the wire format of disaggregated serving (the port's
copy of `deeplearning4j_tpu.serving.transfer`).

A lane's finished KV pages leave one pool and enter another as one
binary frame: magic, a length-prefixed JSON header, and the raw page
payload.  The header carries the SHA-256 of the payload and the
`model_signature` of the exporting pool, so a flipped byte or a
mismatched deployment is a typed `PageShipError`, never silent garbage
KV.  The same frame parks a preempted lane in the host swap store and a
hibernated session on the tiered state store.

The frames are byte-compatible with the JAX package's in both
directions.  Pages are CPU tensors here: a bfloat16 page stack is written
and read as raw 2-byte words under the header name ``"bfloat16"`` (the
JAX package reads that name through ``ml_dtypes``; numpy has no
bfloat16, and this module needs none).

A shipped page holds the same k/v the importing pool would compute: KV
at position t is a function of tokens[0..t] and the weights, so a
shipped lane decodes the tokens a locally prefilled one does, greedy or
seeded sampling.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.precision.quantize import (
    dequantize_kv_pages,
    quantize_kv_pages,
)

# frame magic + format version.  v1: raw k‖v page payload.  v2: adds a
# "quant" header section — the payload is int8 k‖v followed by the
# float32 per-(layer, page, head) scale stacks.  Exact frames still
# serialize as v1, so a v1-only reader keeps working until it meets a
# quantized frame, which it rejects by version.
MAGIC = b"DL4JKVS\x01"
WIRE_VERSION = 2
_KNOWN_VERSIONS = (1, 2)

# header fields every frame must carry
_REQUIRED = ("version", "prompt", "max_new", "temperature", "seed",
             "committed", "pos", "page_size", "n_pages", "dtype",
             "shape", "sha256", "model")

# the header's dtype names (numpy's, as the JAX package writes them)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


class PageShipError(RuntimeError):
    """A KV page shipment could not be accepted: truncated or misframed
    bytes, a failed SHA-256 check, or geometry incompatible with the
    importing pool.  The answer is to recompute locally, never to
    trust the pages."""


def _dtype_name(dtype: torch.dtype) -> str:
    """A page tensor's dtype as the frame header names it."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"no wire name for page dtype {dtype}") from None


def _wire_dtype(name) -> torch.dtype:
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise PageShipError(f"shipment dtype {name!r} unknown") from None


def _raw(t: torch.Tensor) -> bytes:
    """A tensor's bytes in C order (bfloat16 as its 2-byte words)."""
    t = t.detach().contiguous().cpu()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_raw(data: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    """Inverse of `_raw`: a fresh tensor of `dtype` and `shape`."""
    buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    return buf.view(dtype).reshape(tuple(shape))


def model_signature(cfg, page_size: int) -> Dict:
    """The geometry a shipped page stack is only meaningful under.
    `max_len`/`vocab_size` ride along for request re-validation on the
    importing side; the KV-shape fields are the hard compatibility
    gate."""
    return {"n_layers": int(cfg.n_layers), "n_heads": int(cfg.n_heads),
            "head_dim": int(cfg.head_dim), "dtype": str(cfg.dtype),
            "max_len": int(cfg.max_len),
            "vocab_size": int(cfg.vocab_size),
            "page_size": int(page_size)}


@dataclasses.dataclass
class PageExport:
    """One lane's shippable state: the request contract, the tokens
    committed so far, the next cache position and the page stacks
    ``[L, n_pages, ps, H, K]`` (CPU tensors)."""

    prompt: List[int]
    max_new: int
    temperature: float
    seed: int
    committed: List[int]        # tokens generated so far (>= 1)
    pos: int                    # next cache position (== len(prompt))
    page_size: int
    pages_k: torch.Tensor       # [L, n_pages, ps, H, K]
    pages_v: torch.Tensor
    model: Dict                 # model_signature of the exporting pool
    session_id: Optional[str] = None
    # admission class: a shipped or swapped lane keeps its priority on
    # the pool it lands in; absent from a frame -> interactive
    priority: str = "interactive"
    # billing identity (the JAX package's tenancy plane); this port has
    # one tenant, "default"
    tenant: str = "default"
    # compression: with `quant` set, the pages are int8 and scales_k /
    # scales_v carry the per-(layer, page, head) float32 scales;
    # `quant["exact_dtype"]` names what they dequantize back to.  None =
    # an exact frame (the v1 layout).
    quant: Optional[Dict] = None
    scales_k: Optional[torch.Tensor] = None
    scales_v: Optional[torch.Tensor] = None

    @property
    def n_pages(self) -> int:
        return int(self.pages_k.shape[1])

    @property
    def quantized(self) -> bool:
        return self.quant is not None

    def nbytes(self) -> int:
        """Bytes this export carries (the wire and at-rest size): int8
        pages + scales when quantized, raw pages when exact."""
        n = 2 * self.pages_k.numel() * self.pages_k.element_size()
        if self.scales_k is not None:
            n += 2 * self.scales_k.numel() * 4
        return int(n)

    def exact_nbytes(self) -> int:
        """Bytes the same pages occupy unquantized."""
        if self.quant is None:
            return 2 * self.pages_k.numel() * self.pages_k.element_size()
        itemsize = _wire_dtype(self.quant["exact_dtype"]).itemsize
        return int(2 * self.pages_k.numel() * itemsize)

    def dequantized(self) -> "PageExport":
        """An exact PageExport with the pages restored to
        ``quant["exact_dtype"]`` (itself when already exact), dequantized
        on the host, so the install is the one exact frames use."""
        if self.quant is None:
            return self
        dt = _wire_dtype(self.quant["exact_dtype"])

        def restore(q, s):
            return torch.from_numpy(dequantize_kv_pages(
                q.numpy(), s.numpy(), np.float32)).to(dt)

        return dataclasses.replace(
            self, pages_k=restore(self.pages_k, self.scales_k),
            pages_v=restore(self.pages_v, self.scales_v),
            quant=None, scales_k=None, scales_v=None)


def quantize_export(ex: PageExport) -> PageExport:
    """Exact PageExport -> per-page int8 PageExport (itself when already
    quantized).  Positions at or past `ex.pos` are zeroed before the
    scales are taken (`quantize_kv_pages`)."""
    if ex.quant is not None:
        return ex

    def quant(t):
        q, s = quantize_kv_pages(t.float().numpy(), valid=ex.pos)
        return torch.from_numpy(q), torch.from_numpy(s)

    qk, sk = quant(ex.pages_k)
    qv, sv = quant(ex.pages_v)
    return dataclasses.replace(
        ex, pages_k=qk, pages_v=qv, scales_k=sk, scales_v=sv,
        quant={"mode": "int8",
               "exact_dtype": _dtype_name(ex.pages_k.dtype)})


def serialize_export(ex: PageExport) -> bytes:
    """PageExport -> one wire frame: MAGIC + u32 header length + JSON
    header + raw page payload (k then v, C order; a quantized export
    appends its float32 scale stacks after the int8 pages).  The
    header's sha256 covers the payload exactly as framed.  Exact
    exports frame as v1."""
    pk, pv = ex.pages_k, ex.pages_v
    if tuple(pk.shape) != tuple(pv.shape):
        raise ValueError(f"pages_k {tuple(pk.shape)} != pages_v "
                         f"{tuple(pv.shape)}")
    payload = _raw(pk) + _raw(pv)
    if ex.quant is not None:
        payload += (_raw(ex.scales_k.to(torch.float32))
                    + _raw(ex.scales_v.to(torch.float32)))
    header = {
        "version": WIRE_VERSION if ex.quant is not None else 1,
        "prompt": [int(t) for t in ex.prompt],
        "max_new": int(ex.max_new),
        "temperature": float(ex.temperature),
        "seed": int(ex.seed),
        "committed": [int(t) for t in ex.committed],
        "pos": int(ex.pos),
        "page_size": int(ex.page_size),
        "n_pages": int(pk.shape[1]),
        "dtype": _dtype_name(pk.dtype),
        "shape": [int(d) for d in pk.shape],
        "sha256": hashlib.sha256(payload).hexdigest(),
        "model": dict(ex.model),
    }
    if ex.quant is not None:
        header["quant"] = {"mode": str(ex.quant["mode"]),
                           "exact_dtype": str(ex.quant["exact_dtype"]),
                           "scale_shape": [int(d)
                                           for d in ex.scales_k.shape]}
    if ex.session_id is not None:
        header["session_id"] = str(ex.session_id)
    if ex.priority != "interactive":
        header["priority"] = str(ex.priority)
    if ex.tenant != "default":
        header["tenant"] = str(ex.tenant)
    hj = json.dumps(header).encode()
    return MAGIC + struct.pack(">I", len(hj)) + hj + payload


def deserialize_export(data: bytes) -> PageExport:
    """One wire frame -> PageExport, integrity-verified.  Every malformed
    input (wrong magic, truncated header or payload, non-JSON header,
    missing fields, shape or byte-count mismatch, failed SHA-256) raises
    `PageShipError` naming what broke."""
    pre = len(MAGIC) + 4
    if len(data) < pre or data[:len(MAGIC)] != MAGIC:
        raise PageShipError(
            f"not a KV page shipment: bad magic/short frame "
            f"({len(data)} bytes)")
    (hlen,) = struct.unpack(">I", data[len(MAGIC):pre])
    if len(data) < pre + hlen:
        raise PageShipError(
            f"truncated shipment header ({len(data)} bytes, header "
            f"needs {pre + hlen})")
    try:
        header = json.loads(data[pre:pre + hlen])
    except ValueError as e:
        raise PageShipError(f"shipment header is not JSON: {e}") from e
    missing = [k for k in _REQUIRED if k not in header]
    if missing:
        raise PageShipError(f"shipment header missing {missing}")
    if int(header["version"]) not in _KNOWN_VERSIONS:
        raise PageShipError(
            f"shipment wire version {header['version']} not in "
            f"{_KNOWN_VERSIONS}")
    payload = data[pre + hlen:]
    digest = hashlib.sha256(payload).hexdigest()
    if digest != header["sha256"]:
        raise PageShipError(
            f"shipment integrity check failed: sha256 {digest[:12]}… != "
            f"header {str(header['sha256'])[:12]}…")
    shape = tuple(int(d) for d in header["shape"])
    dt = _wire_dtype(header["dtype"])
    quant = header.get("quant")
    sk = sv = None
    sshape = ()
    if quant is not None:
        if quant.get("mode") != "int8":
            raise PageShipError(
                f"shipment quantization mode {quant.get('mode')!r} "
                f"unknown (this reader speaks int8 only)")
        if dt != torch.int8:
            raise PageShipError(
                f"quantized shipment payload dtype {header['dtype']} != "
                f"int8")
        if str(quant.get("exact_dtype")) not in _DTYPES:
            raise PageShipError(
                f"shipment exact_dtype {quant.get('exact_dtype')!r} "
                f"unknown")
        sshape = tuple(int(d) for d in quant.get("scale_shape", ()))
        if len(sshape) != 3 or sshape[:2] != (shape[0], shape[1]) or \
                sshape[2] != shape[3]:
            raise PageShipError(
                f"shipment scale stack {sshape} != per-(layer, page, "
                f"head) for pages {shape}")
        sbytes = int(np.prod(sshape)) * 4
    else:
        sbytes = 0
    half = int(np.prod(shape)) * dt.itemsize
    want = 2 * half + 2 * sbytes
    if len(payload) != want:
        raise PageShipError(
            f"shipment payload {len(payload)} bytes != {want} for "
            f"2 x {shape} {header['dtype']}"
            + (f" + 2 x {sshape} float32 scales" if quant else ""))
    pk = _from_raw(payload[:half], dt, shape)
    pv = _from_raw(payload[half:2 * half], dt, shape)
    if quant is not None:
        sk = _from_raw(payload[2 * half:2 * half + sbytes], torch.float32,
                       sshape)
        sv = _from_raw(payload[2 * half + sbytes:], torch.float32, sshape)
        quant = {"mode": "int8", "exact_dtype": str(quant["exact_dtype"])}
    return PageExport(
        prompt=[int(t) for t in header["prompt"]],
        max_new=int(header["max_new"]),
        temperature=float(header["temperature"]),
        seed=int(header["seed"]),
        committed=[int(t) for t in header["committed"]],
        pos=int(header["pos"]),
        page_size=int(header["page_size"]),
        pages_k=pk, pages_v=pv, model=dict(header["model"]),
        session_id=header.get("session_id"),
        priority=str(header.get("priority", "interactive")),
        tenant=str(header.get("tenant", "default")),
        quant=quant, scales_k=sk, scales_v=sv)


def check_compatible(ex: PageExport, cfg, page_size: int,
                     mid_decode: bool = False,
                     prefix: bool = False) -> None:
    """The import gate: the shipped geometry must equal the importing
    pool's, field for field; raises `PageShipError` naming every
    mismatched field.

    ``mid_decode`` admits a preempted lane's frame, swapped out anywhere
    past its prompt; ``prefix`` a hibernated prompt prefix (``prompt``
    is exactly the covered tokens, ``pos`` a page boundary, nothing
    committed)."""
    local = model_signature(cfg, page_size)
    bad = [f"{k}: shipped {ex.model.get(k)!r} != local {v!r}"
           for k, v in local.items() if ex.model.get(k) != v]
    if bad:
        raise PageShipError(
            "shipment incompatible with this pool — " + "; ".join(bad))
    want = (local["n_layers"], ex.n_pages, local["page_size"],
            local["n_heads"], local["head_dim"])
    if tuple(ex.pages_k.shape) != want:
        raise PageShipError(
            f"shipment page stack {tuple(ex.pages_k.shape)} != "
            f"{want} for this pool's geometry")
    if prefix:
        if ex.pos != len(ex.prompt):
            raise PageShipError(
                f"hibernated prefix pos {ex.pos} != covered tokens "
                f"{len(ex.prompt)}: a prefix frame stores exactly what "
                f"its pages hold")
        if ex.pos % local["page_size"] != 0:
            raise PageShipError(
                f"hibernated prefix pos {ex.pos} is not a multiple of "
                f"page_size {local['page_size']}: only full pages rest")
        if ex.committed:
            raise PageShipError(
                f"hibernated prefix carries {len(ex.committed)} "
                f"committed tokens: prefix frames hold pages, not lanes")
    elif mid_decode:
        if ex.pos < len(ex.prompt):
            raise PageShipError(
                f"swapped lane pos {ex.pos} < prompt length "
                f"{len(ex.prompt)}: only post-prefill lanes swap")
    elif ex.pos != len(ex.prompt):
        raise PageShipError(
            f"shipment pos {ex.pos} != prompt length "
            f"{len(ex.prompt)}: only prefill-complete lanes ship")
    if not prefix and not ex.committed:
        raise PageShipError(
            "shipment carries no committed token: prefill completion "
            "always samples the first one")
    if ex.n_pages != -(-ex.pos // local["page_size"]):
        raise PageShipError(
            f"shipment has {ex.n_pages} pages for pos {ex.pos} at "
            f"page_size {local['page_size']}")


__all__ = [
    "MAGIC",
    "PageExport",
    "PageShipError",
    "WIRE_VERSION",
    "check_compatible",
    "deserialize_export",
    "model_signature",
    "quantize_export",
    "serialize_export",
]
