"""PyTorch port: KV page shipping and disaggregated prefill/decode
(`deeplearning4j_tpu_torch.serving.transfer`, `prefill_export` /
`admit_with_pages`, `make_page_gather` / `make_page_install`,
``POST /lm/prefill`` and ``/lm/admit_pages``, ``serve -lm-ship``).

The oracle is the behaviour of the JAX package's `tests/test_disagg.py`
(`TestWireFormat`, `TestShipParity`, `TestHTTPSurface`,
`TestCLISurface`), with the same weights reaching both packages as
numpy arrays.  Frames cross between the packages in both directions,
exact and quantized, float32 and bfloat16: a bfloat16 frame written by
the port is byte-identical to the JAX package's for the same pages.
Shipped greedy ids in float32 equal the JAX package's `generate`; in
bfloat16 the two packages' arithmetic differs, so ids are held equal
up to a near-tie (the first divergence where the reference's top-2
logits lie within 4 bfloat16 ulps of the largest).
"""

import dataclasses
import functools
import json
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import generation as jgen
from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.serving import ContinuousLMServer as JServer
from deeplearning4j_tpu.serving import transfer as jtr
from deeplearning4j_tpu_torch import cli as tcli
from deeplearning4j_tpu_torch.parallel import generation as tgen
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.serving import ContinuousLMServer
from deeplearning4j_tpu_torch.serving.transfer import (
    MAGIC,
    PageExport,
    PageShipError,
    check_compatible,
    deserialize_export,
    model_signature,
    quantize_export,
    serialize_export,
)
from deeplearning4j_tpu_torch.ui.server import UiServer
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

PS, CHUNK, SLOTS = 8, 4, 2


def _jcfg(dtype="float32"):
    return jt.TransformerConfig(vocab_size=50, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32, max_len=64,
                                dtype=dtype)


def _cfg(dtype="float32"):
    return tt.TransformerConfig(**dataclasses.asdict(_jcfg(dtype)))


@functools.lru_cache(maxsize=1)
def _tree():
    return tt.numpy_params(_cfg(), seed=0)


def _jparams(dtype="float32"):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), _tree())


@functools.lru_cache(maxsize=64)
def _want(prompt: tuple, new: int, dtype: str = "float32") -> list:
    out = jgen.generate(_jcfg(dtype), _jparams(dtype),
                        np.asarray([prompt], np.int32), new)
    return np.asarray(out)[0].tolist()


def _srv(page_size=PS, ship=True, dtype="float32", **kw):
    return ContinuousLMServer(_cfg(dtype), _tree(), slots=SLOTS,
                              page_size=page_size, prefill_chunk=CHUNK,
                              ship=ship, device="cpu", **kw)


def _jsrv(dtype="float32", **kw):
    return JServer(_jcfg(dtype), _jparams(dtype), slots=SLOTS, page_size=PS,
                   prefill_chunk=CHUNK, ship=True, **kw)


def _fake_export(n_pages=2, ps=4, layers=1, heads=2, kd=8, plen=7,
                 dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    shape = (layers, n_pages, ps, heads, kd)
    return PageExport(
        prompt=list(range(plen)), max_new=5, temperature=0.5, seed=7,
        committed=[3], pos=plen, page_size=ps,
        pages_k=torch.rand(shape, generator=gen).to(dtype),
        pages_v=torch.rand(shape, generator=gen).to(dtype),
        model={"n_layers": layers, "n_heads": heads, "head_dim": kd,
               "dtype": "float32", "max_len": 32, "vocab_size": 50,
               "page_size": ps},
        session_id="sess-1")


def _as_jax_export(ex: PageExport):
    """The same export as the JAX package's dataclass, numpy pages (the
    bfloat16 bits through `ml_dtypes`, which the JAX package has)."""
    import ml_dtypes

    def arr(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return jtr.PageExport(
        prompt=ex.prompt, max_new=ex.max_new, temperature=ex.temperature,
        seed=ex.seed, committed=ex.committed, pos=ex.pos,
        page_size=ex.page_size, pages_k=arr(ex.pages_k),
        pages_v=arr(ex.pages_v), model=ex.model, session_id=ex.session_id,
        priority=ex.priority, tenant=ex.tenant, quant=ex.quant,
        scales_k=arr(ex.scales_k), scales_v=arr(ex.scales_v))


def _bits(a) -> bytes:
    return (a.contiguous().view(torch.uint8).numpy().tobytes()
            if isinstance(a, torch.Tensor) else np.ascontiguousarray(
                a).tobytes())


def _assert_ids(got, want, dtype, reference_logits):
    """Equal ids; in bfloat16, a divergence only at a near-tie of the
    reference's logits at that position."""
    if got == want or dtype == "float32":
        assert got == want
        return
    p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    logits = np.sort(reference_logits(want[:p]))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(logits[-1]))) - 7)
    assert logits[-1] - logits[-2] <= 4 * ulp, (got, want, p)


def _jax_logits(dtype):
    def at_last(ids):
        return np.asarray(jt.apply(_jcfg(dtype), _jparams(dtype),
                                   jnp.asarray([ids])), np.float32)[0, -1]
    return at_last


# ---------------------------------------------------------------------------
# the wire format (no model)


class TestWireFormat:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_round_trip(self, dtype):
        ex = _fake_export(dtype=dtype)
        out = deserialize_export(serialize_export(ex))
        assert out.prompt == ex.prompt and out.committed == [3]
        assert out.max_new == 5 and out.seed == 7 and out.pos == ex.pos
        assert out.temperature == 0.5 and out.session_id == "sess-1"
        assert out.pages_k.dtype == dtype
        assert torch.equal(out.pages_k, ex.pages_k)
        assert torch.equal(out.pages_v, ex.pages_v)
        assert out.model == ex.model and out.priority == "interactive"

    def test_corrupted_payload_rejected(self):
        blob = bytearray(serialize_export(_fake_export()))
        blob[-5] ^= 0x20                       # flip one payload bit
        with pytest.raises(PageShipError, match="integrity"):
            deserialize_export(bytes(blob))

    def test_truncated_and_misframed_rejected(self):
        blob = serialize_export(_fake_export())
        with pytest.raises(PageShipError):
            deserialize_export(blob[:10])          # truncated header
        with pytest.raises(PageShipError):
            deserialize_export(blob[:-9])          # truncated payload
        with pytest.raises(PageShipError, match="magic"):
            deserialize_export(b"NOPE" + blob[4:])
        with pytest.raises(PageShipError):
            deserialize_export(b"")

    @pytest.mark.parametrize("field,value,match", [
        ("sha256", None, "missing"), ("dtype", "complex64", "dtype"),
        ("version", 9, "version")])
    def test_header_tampering_rejected(self, field, value, match):
        blob = serialize_export(_fake_export())
        pre = len(MAGIC) + 4
        (hlen,) = struct.unpack(">I", blob[len(MAGIC):pre])
        header = json.loads(blob[pre:pre + hlen])
        if value is None:
            del header[field]
        else:
            header[field] = value
        hj = json.dumps(header).encode()
        forged = MAGIC + struct.pack(">I", len(hj)) + hj + blob[pre + hlen:]
        with pytest.raises(PageShipError, match=match):
            deserialize_export(forged)

    def test_compatibility_gate(self):
        cfg = _cfg()
        ex = _fake_export()
        with pytest.raises(PageShipError, match="incompatible"):
            check_compatible(ex, cfg, PS)      # d16/2-head vs fake geometry
        sig = model_signature(cfg, PS)
        assert sig == jtr.model_signature(_jcfg(), PS)
        good = dataclasses.replace(ex, model=sig, page_size=PS,
                                   pages_k=torch.zeros(1, 1, PS, 2, 8),
                                   pages_v=torch.zeros(1, 1, PS, 2, 8))
        check_compatible(good, cfg, PS)
        with pytest.raises(PageShipError, match="prompt length"):
            check_compatible(dataclasses.replace(good, pos=6), cfg, PS)
        check_compatible(dataclasses.replace(good, pos=8), cfg, PS,
                         mid_decode=True)
        with pytest.raises(PageShipError, match="committed"):
            check_compatible(dataclasses.replace(good, committed=[]), cfg,
                             PS)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_quantized_frame_ratio_and_error(self, dtype):
        ex = _fake_export(n_pages=3, ps=16, kd=64, plen=40, dtype=dtype)
        q = quantize_export(ex)
        assert q.quantized and not ex.quantized
        assert quantize_export(q) is q
        back = deserialize_export(serialize_export(q))
        assert back.quantized and torch.equal(back.pages_k, q.pages_k)
        assert torch.equal(back.scales_v, q.scales_v)
        # int8 pages and one float32 scale per (layer, page, head):
        # 1/s + 4/(ps K s) of the exact bytes for itemsize s
        s = torch.empty((), dtype=dtype).element_size()
        assert q.nbytes() / q.exact_nbytes() == pytest.approx(
            1 / s + 4 / (16 * 64 * s))
        if dtype == torch.float32:
            assert q.nbytes() <= 0.3 * q.exact_nbytes()
        deq = back.dequantized()
        assert deq.pages_k.dtype == dtype and not deq.quantized
        live = slice(0, ex.pos)
        got = deq.pages_k.float().flatten(1, 2)[:, live]
        want = ex.pages_k.float().flatten(1, 2)[:, live]
        assert (got - want).abs().max() <= want.abs().max() / 100
        # positions at or past pos were zeroed before the scales
        assert float(deq.pages_k.flatten(1, 2)[:, ex.pos:].abs().max()) == 0


# ---------------------------------------------------------------------------
# cross-package frames


class TestCrossPackageFrames:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("quantized", [False, True])
    def test_frames_are_byte_identical_both_ways(self, dtype, quantized):
        ex = _fake_export(n_pages=2, ps=8, kd=8, plen=12, dtype=dtype)
        if quantized:
            ex = quantize_export(ex)
            # the JAX package quantizes the same pages to the same bytes
            jq = jtr.quantize_export(_as_jax_export(
                deserialize_export(serialize_export(
                    _fake_export(n_pages=2, ps=8, kd=8, plen=12,
                                 dtype=dtype)))))
            assert jtr.serialize_export(jq) == serialize_export(ex)
        blob = serialize_export(ex)
        assert jtr.serialize_export(_as_jax_export(ex)) == blob
        header = json.loads(blob[len(MAGIC) + 4:len(MAGIC) + 4 + struct.unpack(
            ">I", blob[len(MAGIC):len(MAGIC) + 4])[0]])
        assert header["dtype"] == ("int8" if quantized else
                                   {torch.float32: "float32",
                                    torch.bfloat16: "bfloat16"}[dtype])
        # each package reads the other's frame to the same bits
        jex = jtr.deserialize_export(blob)
        assert _bits(jex.pages_k) == _bits(ex.pages_k)
        back = deserialize_export(jtr.serialize_export(jex))
        assert torch.equal(back.pages_v, ex.pages_v)
        if quantized:
            assert jex.quant["exact_dtype"] == back.quant["exact_dtype"]
            np.testing.assert_array_equal(
                np.asarray(jex.dequantized().pages_k, np.float32),
                back.dequantized().pages_k.float().numpy())

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("quantized", [False, True])
    def test_a_jax_frame_is_admitted_by_the_port(self, dtype, quantized):
        rng = np.random.default_rng(40)
        prompt = rng.integers(0, 50, 13).tolist()
        jsrv = _jsrv(dtype)
        dec = _srv(dtype=dtype)
        try:
            ex = jsrv.prefill_export(prompt, 6, timeout=120)
            if quantized:
                ex = jtr.quantize_export(ex)
            want = jsrv.admit_with_pages(ex, timeout=120)
            got = dec.admit_with_pages(
                deserialize_export(jtr.serialize_export(ex)), timeout=120)
            assert dec.page_ledger()["balanced"]
        finally:
            jsrv.stop()
            dec.stop()
        _assert_ids(got, want, dtype, _jax_logits(dtype))
        if dtype == "float32" and not quantized:
            assert got == _want(tuple(prompt), 6)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("quantized", [False, True])
    def test_a_port_frame_is_admitted_by_jax(self, dtype, quantized):
        rng = np.random.default_rng(41)
        prompt = rng.integers(0, 50, 11).tolist()
        pre = _srv(dtype=dtype)
        jsrv = _jsrv(dtype)
        try:
            ex = pre.prefill_export(prompt, 6, timeout=120)
            if quantized:
                ex = quantize_export(ex)
            mine = pre.admit_with_pages(ex, timeout=120)
            got = jsrv.admit_with_pages(
                jtr.deserialize_export(serialize_export(ex)), timeout=120)
        finally:
            pre.stop()
            jsrv.stop()
        _assert_ids(mine, got, dtype, _jax_logits(dtype))
        if dtype == "float32" and not quantized:
            assert got == _want(tuple(prompt), 6)


# ---------------------------------------------------------------------------
# the gather / install pair


def test_page_gather_and_install_round_trip_with_null_rows():
    cfg = _cfg()
    pages, mp = 12, tgen.pages_per_seq(cfg, PS)
    cache = tgen.init_paged_cache(cfg, pages, PS, device="cpu")
    gen = torch.Generator().manual_seed(1)
    cache["k"].copy_(torch.randn(cache["k"].shape, generator=gen))
    cache["v"].copy_(torch.randn(cache["v"].shape, generator=gen))
    gather = tgen.make_page_gather(cfg, pages, PS)
    install = tgen.make_page_install(cfg, pages, PS)
    row = np.zeros(mp, np.int32)
    row[:3] = [5, 2, 9]
    pk, pv = gather(cache["k"], cache["v"], row)
    assert pk.shape == (1, mp, PS, 2, 8)
    assert torch.equal(pk[:, 1], cache["k"][:, 2])
    dst = tgen.init_paged_cache(cfg, pages, PS, device="cpu")
    target = np.zeros(mp, np.int32)
    target[:3] = [7, 1, 3]
    k, v = install(dst["k"], dst["v"], pk[:, :3], pv[:, :3], target, 2)
    assert k is dst["k"]                    # in place
    assert torch.equal(k[:, 7], cache["k"][:, 5])
    assert torch.equal(v[:, 1], cache["v"][:, 2])
    # the row at n landed on the null page, not on page 3
    assert float(k[:, 3].abs().max()) == 0
    assert float(k[:, 1:].abs().sum()) == float(
        cache["k"][:, [5, 2]].abs().sum())


# ---------------------------------------------------------------------------
# shipped lanes (the JAX package's TestShipParity behaviours)


class TestShipParity:
    @pytest.mark.parametrize("ps", [8, 5])   # 5 does not divide prompts
    def test_greedy_parity_across_page_sizes(self, ps):
        rng = np.random.default_rng(ps)
        pre = _srv(page_size=ps)
        dec = _srv(page_size=ps)
        try:
            for plen, new in ((13, 8), (16, 6), (7, 1), (22, 10)):
                prompt = rng.integers(0, 50, (plen,)).tolist()
                ex = deserialize_export(serialize_export(
                    pre.prefill_export(prompt, new, timeout=60)))
                got = dec.admit_with_pages(ex, timeout=60)
                assert got == _want(tuple(prompt), new)
            assert pre.page_ledger()["balanced"]
            assert dec.page_ledger()["balanced"]
        finally:
            pre.stop()
            dec.stop()

    def test_seeded_sampling_parity(self):
        """A shipped sampled lane equals a locally decoded one bit for
        bit: `committed` and the token count travel in the frame, and the
        Gumbel noise is keyed on (seed, count)."""
        rng = np.random.default_rng(1)
        pre, dec, loc = _srv(), _srv(), _srv(ship=False)
        try:
            for seed in (0, 3, 99):
                prompt = rng.integers(0, 50, (11,)).tolist()
                ex = pre.prefill_export(prompt, 8, temperature=0.8,
                                        seed=seed, timeout=60)
                got = dec.admit_with_pages(ex, timeout=60)
                want = loc.generate(prompt, 8, temperature=0.8, seed=seed,
                                    timeout=60)
                assert got == want
        finally:
            pre.stop()
            dec.stop()
            loc.stop()

    def test_ship_into_speculating_pool(self):
        rng = np.random.default_rng(2)
        pre = _srv()
        dec = _srv(speculate="ngram", draft_len=3)
        try:
            prompt = rng.integers(0, 50, (4,)).tolist() * 3
            ex = pre.prefill_export(prompt, 12, timeout=60)
            got = dec.admit_with_pages(ex, timeout=60)
            assert got == _want(tuple(prompt), 12)
            assert dec.page_ledger()["balanced"]
        finally:
            pre.stop()
            dec.stop()

    def test_concurrent_ship_and_local_traffic(self):
        rng = np.random.default_rng(3)
        pre, dec = _srv(), _srv()
        prompts = [rng.integers(0, 50, (10 + i,)).tolist()
                   for i in range(4)]
        results = [None] * 4

        def shipped(i):
            ex = pre.prefill_export(prompts[i], 8, timeout=120)
            results[i] = dec.admit_with_pages(ex, timeout=120)

        def local(i):
            results[i] = dec.generate(prompts[i], 8, timeout=120)

        try:
            threads = [threading.Thread(target=shipped if i % 2 else local,
                                        args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            for p, got in zip(prompts, results):
                assert got == _want(tuple(p), 8)
            assert pre.page_ledger()["balanced"]
            assert dec.page_ledger()["balanced"]
        finally:
            pre.stop()
            dec.stop()

    def test_second_ship_reuses_decode_radix(self):
        rng = np.random.default_rng(7)
        pre, dec = _srv(), _srv()
        try:
            system = rng.integers(0, 50, (16,)).tolist()  # 2 full pages
            for tail in ([1, 2], [3, 4]):
                prompt = system + tail
                ex = pre.prefill_export(prompt, 6, timeout=60)
                got = dec.admit_with_pages(ex, timeout=60)
                assert got == _want(tuple(prompt), 6)
            st = dec.stats()
            assert st["prefix_hits"] >= 1
            assert st["prefix_tokens_saved"] >= 16
            assert dec.page_ledger()["balanced"]
        finally:
            pre.stop()
            dec.stop()

    def test_prefill_worker_keeps_radix_prefix(self):
        rng = np.random.default_rng(4)
        pre = _srv()
        try:
            system = rng.integers(0, 50, (16,)).tolist()
            pre.prefill_export(system + [1, 2], 4, timeout=60)
            pre.prefill_export(system + [3, 4], 4, timeout=60)
            st = pre.stats()
            assert st["prefix_hits"] >= 1
            assert st["ship"]["out"] == 2
        finally:
            pre.stop()

    def test_ship_requires_paged_and_flag(self):
        with pytest.raises(ValueError, match="paged"):
            ContinuousLMServer(_cfg(), _tree(), kv="dense", ship=True,
                               device="cpu")
        srv = _srv(ship=False)
        try:
            with pytest.raises(ValueError, match="ship"):
                srv.prefill_export([1, 2, 3], 4)
            with pytest.raises(ValueError, match="ship"):
                srv.admit_with_pages(_fake_export())
        finally:
            srv.stop()

    def test_incompatible_geometry_rejected_typed(self):
        dec = _srv()
        try:
            with pytest.raises(PageShipError, match="incompatible"):
                dec.admit_with_pages(_fake_export())
        finally:
            dec.stop()

    def test_warmup_runs_the_shipping_pair(self):
        """Warmup runs one dispatch of each program, the gather/install
        pair included (the JAX package counts the same five programs);
        the shipped lanes after it are exact."""
        rng = np.random.default_rng(5)
        pre, dec = _srv(), _srv()
        try:
            assert pre.warmup() == 5   # decode, chunk, copy, gather, install
            assert dec.warmup() == 5
            assert _srv(ship=False).warmup() == 3
            for _ in range(2):
                prompt = rng.integers(0, 50, (13,)).tolist()
                ex = pre.prefill_export(prompt, 6, timeout=60)
                got = dec.admit_with_pages(
                    deserialize_export(serialize_export(ex)), timeout=60)
                assert got == _want(tuple(prompt), 6)
        finally:
            pre.stop()
            dec.stop()

    def test_ttft_and_ship_accounting(self):
        rng = np.random.default_rng(6)
        pre, dec = _srv(), _srv()
        try:
            prompt = rng.integers(0, 50, (13,)).tolist()
            ex = pre.prefill_export(prompt, 6, timeout=60)
            dec.admit_with_pages(ex, timeout=60)
            n_pages = -(-len(prompt) // PS)
            pst, dst = pre.stats(), dec.stats()
            assert pst["ship"]["out"] == 1 and dst["ship"]["in"] == 1
            assert pst["ship"]["pages_shipped"] == n_pages
            assert pst["ship"]["ship_bytes"] == ex.nbytes()
            assert pst["ttft"]["count"] == 1
            assert dst["ttft"]["count"] == 1
            assert ex.n_pages == n_pages and pst["kv"]["ship"] is True
        finally:
            pre.stop()
            dec.stop()

    def test_a_budget_of_one_answers_without_a_slot(self):
        pre, dec = _srv(), _srv()
        try:
            ex = pre.prefill_export([4, 5, 6], 1, timeout=60)
            assert dec.admit_with_pages(ex, timeout=60) == _want(
                (4, 5, 6), 1)
            assert dec.stats()["requests"] == 1
            assert dec.page_ledger()["in_use"] == 0
        finally:
            pre.stop()
            dec.stop()


# ---------------------------------------------------------------------------
# HTTP and CLI


def _post(url, payload, raw=False, timeout=60):
    data = payload if raw else json.dumps(payload).encode()
    ctype = "application/octet-stream" if raw else "application/json"
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


class TestHTTPSurface:
    @pytest.fixture(scope="class")
    def ui(self):
        srv = UiServer(port=0)
        srv.serve_lm(_cfg(), _tree(), slots=SLOTS, page_size=PS,
                     prefill_chunk=CHUNK, ship=True, device="cpu")
        srv.start()
        yield srv
        srv.stop()

    def test_prefill_admit_over_http(self, ui):
        prompt = np.random.default_rng(30).integers(0, 50, (14,)).tolist()
        status, ctype, blob = _post(ui.url + "/lm/prefill",
                                    {"prompt_ids": prompt,
                                     "max_new_tokens": 6})
        assert status == 200 and ctype == "application/octet-stream"
        status, _, body = _post(ui.url + "/lm/admit_pages", blob, raw=True)
        assert status == 200
        assert json.loads(body)["ids"] == _want(tuple(prompt), 6)

    def test_corrupt_admit_is_422(self, ui):
        prompt = np.random.default_rng(31).integers(0, 50, (14,)).tolist()
        _, _, blob = _post(ui.url + "/lm/prefill",
                           {"prompt_ids": prompt, "max_new_tokens": 4})
        bad = bytearray(blob)
        bad[-3] ^= 0x40
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(ui.url + "/lm/admit_pages", bytes(bad), raw=True)
        assert ei.value.code == 422
        assert json.loads(ei.value.read())["kind"] == "page_ship"

    def test_session_id_on_single_serve(self, ui):
        prompt = np.random.default_rng(32).integers(0, 50, (6,)).tolist()
        for _ in range(3):
            _post(ui.url + "/lm/generate",
                  {"prompt_ids": prompt, "max_new_tokens": 3,
                   "session_id": "single-serve-chat"})
        with urllib.request.urlopen(ui.url + "/serving/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())["lm"]
        assert stats["session_queries"] >= 3
        assert stats["session_affinity_hits"] >= 2
        assert stats["ttft"]["count"] >= 3

    @pytest.mark.parametrize("sid", [{"not": "scalar"}, ""])
    def test_bad_session_id_is_400(self, ui, sid):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(ui.url + "/lm/generate",
                  {"prompt_ids": [1, 2], "max_new_tokens": 2,
                   "session_id": sid})
        assert ei.value.code == 400

    def test_prefill_on_unshipped_pool_is_typed_422(self):
        srv = UiServer(port=0)
        srv.serve_lm(_cfg(), _tree(), slots=SLOTS, page_size=PS,
                     prefill_chunk=CHUNK, device="cpu")
        srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(srv.url + "/lm/prefill",
                      {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})
            assert ei.value.code == 422
            assert json.loads(ei.value.read())["kind"] == "page_ship"
        finally:
            srv.stop()


class TestCLISurface:
    def test_parser_accepts_the_mobility_flags(self):
        args = tcli.build_parser().parse_args(
            ["serve", "-lm", "lm-out", "-lm-ship", "-lm-preempt",
             "-lm-swap-mb", "8", "-lm-brownout", "-lm-hibernate-idle-s",
             "2.5", "-lm-disk-dir", "d", "-lm-disk-mb", "16",
             "-lm-swap-quantize", "off"])
        assert args.lm_ship and args.lm_preempt and args.lm_brownout
        assert args.lm_swap_mb == 8 and args.lm_disk_mb == 16
        assert args.lm_hibernate_idle_s == 2.5 and args.lm_disk_dir == "d"
        assert args.lm_swap_quantize == "off"

    @pytest.mark.parametrize("flags,match", [
        (["-lm-kv", "dense", "-lm-ship"], "paged"),
        (["-lm-kv", "dense", "-lm-preempt"], "paged"),
        (["-lm-kv", "dense", "-lm-brownout"], "paged"),
        (["-lm-kv", "dense", "-lm-hibernate-idle-s", "1"], "paged"),
        (["-lm-disk-dir", "d"], "-lm-hibernate-idle-s or -lm-preempt")])
    def test_serve_consistency_exits(self, flags, match):
        args = tcli.build_parser().parse_args(
            ["serve", "-lm", "x", *flags, "-device", "cpu"])
        with pytest.raises(SystemExit, match=match):
            tcli.cmd_serve(args)

    def test_serve_starts_a_shipping_pool(self, tmp_path, capsys):
        out = tmp_path / "lm"
        out.mkdir()
        (out / "lm_config.json").write_text(json.dumps(
            dataclasses.asdict(_cfg())))
        from deeplearning4j_tpu_torch.runtime.checkpoint import tree_to_npz
        tree_to_npz(out / "lm_params.npz", _tree())
        rc = tcli.main(["serve", "-lm", str(out), "-port", "0", "-lm-ship",
                        "-lm-preempt", "-lm-brownout", "-serve-seconds",
                        "0.2", "-device", "cpu"])
        assert rc == 0
        assert "ship/preempt/brownout" in capsys.readouterr().out
