"""PyTorch port: the LM front's ``tenant`` and ``stream`` fields against
the JAX package's front.

Both packages' `UiServer.serve_lm` run on one tiny config on the CPU, and
every case goes over HTTP to both:

- ``tenant`` from the JSON field or the ``X-Tenant`` header, checked on
  every decode leg (the continuous pool, `beam_search`, top-k and top-p
  `generate`) and on ``/lm/prefill``: with no tenant registry only
  "default" is served; an unknown tenant, an int naming one, and a value
  that is not a string are 400 on both sides;
- ``stream`` with beams, top-k or top-p is a 400 on both sides;
- ``stream: true`` alone: both fronts answer SSE (200,
  ``text/event-stream``) with equal bytes.

Without a registry the port's `ContinuousLMServer.generate` and
`prefill_export` refuse a non-default tenant in process, in the JAX
pool's words.  Fronts with a tenant registry are held against each
other in `test_torch_front_ops.py`.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import transformer as jt
from deeplearning4j_tpu.ui.server import UiServer as JaxUiServer
from deeplearning4j_tpu_torch.parallel import transformer as tt
from deeplearning4j_tpu_torch.ui.server import UiServer
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

JCFG = jt.TransformerConfig(vocab_size=64, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_len=24,
                            attn_bias=True, tie_embeddings=True)
CFG = tt.TransformerConfig(**dataclasses.asdict(JCFG))
PROMPT = [3, 1, 4, 1, 5]

# the decode legs of /lm/generate, by the knobs that select them
LEGS = {
    "pool": {},
    "beam": {"beam_size": 2},
    "top_k": {"top_k": 5, "temperature": 0.9, "seed": 3},
    "top_p": {"top_p": 0.9, "temperature": 0.7, "seed": 4},
}
# (JSON fields, headers)
TENANTS = {
    "acme_field": ({"tenant": "acme"}, {}),
    "acme_header": ({}, {"X-Tenant": "acme"}),
    "int": ({"tenant": 5}, {}),
    "list": ({"tenant": [1]}, {}),
    "too_long": ({"tenant": "t" * 129}, {}),
    "default": ({"tenant": "default"}, {}),
    "default_header": ({}, {"X-Tenant": "default"}),
}


def _post(url, payload, headers=()):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **dict(headers)})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.fixture(scope="module")
def fronts():
    tree = tt.numpy_params(CFG, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    knobs = dict(slots=2, page_size=4, prefill_chunk=4, ship=True)
    jax_ui = JaxUiServer(port=0)
    jax_ui.serve_lm(JCFG, jparams, **knobs)
    jax_ui.start()
    port_ui = UiServer(port=0).serve_lm(
        CFG, tt.params_from_numpy(tree, device="cpu"), device="cpu",
        **knobs).start()
    yield jax_ui, port_ui
    port_ui.stop()
    jax_ui.stop()


def _both(fronts, path, payload, headers=()):
    return [_post(ui.url + path, payload, headers) for ui in fronts]


@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("tenant", sorted(TENANTS))
def test_tenant_on_every_decode_leg_answers_as_the_jax_front(
        fronts, leg, tenant):
    fields, headers = TENANTS[tenant]
    payload = {"prompt_ids": PROMPT, "max_new_tokens": 2, **LEGS[leg],
               **fields}
    (jcode, _, jbody), (code, _, body) = _both(fronts, "/lm/generate",
                                               payload, headers)
    assert code == jcode, (jbody, body)
    if tenant.startswith("default"):
        assert code == 200
        if leg == "pool":     # greedy: the same ids on both sides
            assert json.loads(body)["ids"] == json.loads(jbody)["ids"]
    else:
        assert code == 400
        err = json.loads(body)["error"]
        assert err == json.loads(jbody)["error"]
        if tenant == "list":
            assert "tenant must be a string" in err
        elif tenant == "too_long":
            assert "1..128" in err
        else:
            assert "unknown tenant" in err and "serve -tenants" in err


@pytest.mark.parametrize("tenant", ["acme_field", "acme_header", "int",
                                    "list", "default"])
def test_tenant_on_prefill_answers_as_the_jax_front(fronts, tenant):
    fields, headers = TENANTS[tenant]
    payload = {"prompt_ids": PROMPT, "max_new_tokens": 3, **fields}
    (jcode, jtype, _), (code, ctype, body) = _both(fronts, "/lm/prefill",
                                                   payload, headers)
    assert code == jcode
    if tenant == "default":
        assert code == 200 and ctype == jtype == "application/octet-stream"
    else:
        assert code == 400 and "tenant" in json.loads(body)["error"]


@pytest.mark.parametrize("leg", ["beam", "top_k", "top_p"])
def test_stream_with_a_whole_sequence_leg_is_400_on_both(fronts, leg):
    payload = {"prompt_ids": PROMPT, "max_new_tokens": 2, "stream": True,
               **LEGS[leg]}
    (jcode, _, _), (code, _, body) = _both(fronts, "/lm/generate", payload)
    assert jcode == code == 400
    assert "cannot stream" in json.loads(body)["error"]


def test_stream_alone_is_a_400_naming_a4_9_where_jax_streams(fronts):
    # the name is kept from when the port refused streams; both fronts
    # now answer the same event stream
    payload = {"prompt_ids": PROMPT, "max_new_tokens": 3, "stream": True}
    before = fronts[1].state.lm_server.stats()["requests"]
    (jcode, jtype, jbody), (code, ctype, body) = _both(
        fronts, "/lm/generate", payload)
    assert jcode == code == 200
    assert jtype == ctype == "text/event-stream"
    assert body == jbody
    events = body.decode().split("\n\n")
    assert events[-2].startswith("event: done\ndata: ")
    done = json.loads(events[-2].split("data: ", 1)[1])["ids"]
    toks = [json.loads(e[len("data: "):])["token"] for e in events[:-2]]
    assert done == PROMPT + toks and len(toks) == 3
    assert fronts[1].state.lm_server.stats()["requests"] == before + 1


def test_the_pool_refuses_a_non_default_tenant_in_process(fronts):
    srv, jsrv = fronts[1].state.lm_server, fronts[0].state.lm_server
    for call in ("generate", "prefill_export"):
        with pytest.raises(ValueError) as jinfo:
            getattr(jsrv, call)(PROMPT, 2, tenant="acme")
        with pytest.raises(ValueError) as info:
            getattr(srv, call)(PROMPT, 2, tenant="acme")
        assert str(info.value) == str(jinfo.value)
        assert "no tenant registry is installed" in str(info.value)
    assert srv.generate(PROMPT, 2, tenant="default") == \
        srv.generate(PROMPT, 2)
    export = srv.prefill_export(PROMPT, 3, tenant="default")
    assert export.tenant == "default"
    assert np.asarray(export.prompt).tolist() == PROMPT
