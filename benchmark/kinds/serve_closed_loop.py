"""Serving under a closed loop of streaming clients.

Set-up makes the weights on the device from the seed (bfloat16, as
served), builds the port's `ContinuousLMServer` with the mix's pool
settings, builds every program (`warmup`), and ramps the clients up:
client c starts at ``ramp_s * c / clients`` and the window opens
``settle_s`` after the last has started, with every slot busy.  Each
client sends its next request through `generate_stream` as soon as its
last one ends and stamps every token as it arrives.

The window is ``--seconds`` long.  ``serve_tokens_per_s``: tokens that
reached the clients inside the window over its length.  Every token's
arrival and every request's submit are kept for the per-layer readers
(the tails of first-token time and inter-token gaps among them).  After
the window (and, with a
trace, a traced span under the same load) no client submits again and
each abandons its request in flight once that has its first token.  A
request submitted inside the window is ``attempted``; ``failed`` if it
raised, never had a token, or ended short without being abandoned.

``correct``: finished requests drawn from the seed, the longest among
them, until ``check_tokens`` served tokens, judged against the plain
reference once the program's state is freed (`reference.judge`).
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from benchmark import gen, weights
from benchmark.kinds import peak_bytes, port_config, release
from benchmark.reference import gpt2 as ref
from benchmark.reference import judge
from benchmark.trace import Tracer

JOIN_S = 240.0


def _counters(srv, paged) -> dict:
    m = srv.metrics
    return {"dispatches": int(m.dispatches_total.value),
            "lanes": int(m.rows_total.value),
            "prefix_saved": int(m.prefix_tokens_saved_total.value),
            "b1": paged.launches.by_key(),
            "builds": int(srv.stats()["compiles_total"])}


def _delta(a: dict, b: dict) -> dict:
    out = {k: b[k] - a[k] for k in a if k != "b1"}
    out["b1"] = {w: b["b1"].get(w, 0) - a["b1"].get(w, 0)
                 for w in set(a["b1"]) | set(b["b1"])}
    return out


def _client(srv, reqs, c: int, n: int, start_at: float,
            stop: threading.Event, records: list) -> None:
    """Client c: requests c, c + n, ... back to back.  Its first request
    decodes (c + 1) / n of its tokens, so the first wave ends spread over
    a request's lifetime and the loop starts near its steady state.
    Once `stop` is set it sends nothing more, and abandons the request in
    flight as soon as that has its first token."""
    time.sleep(max(0.0, start_at - time.perf_counter()))
    k = 0
    while not stop.is_set():
        idx = c + k * n
        prompt, max_new = reqs.request(idx)
        if k == 0:
            max_new = max(1, -(-max_new * (c + 1) // n))
        k += 1
        rec = {"idx": idx, "plen": len(prompt), "max_new": max_new,
               "times": [], "tokens": [], "error": None, "abandoned": False}
        rec["t_sub"] = time.perf_counter()
        try:
            stream = srv.generate_stream(prompt, max_new)
            for tok in stream:
                rec["times"].append(time.perf_counter())
                rec["tokens"].append(tok)
                if stop.is_set() and len(rec["tokens"]) < max_new:
                    rec["abandoned"] = True
                    stream.close()
                    break
        except Exception as e:      # a failed request is counted, not fatal
            rec["error"] = repr(e)
        records.append(rec)


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def run(cell, cfg, mix, seed, seconds, trace, device, t_start) -> dict:
    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
    )
    from deeplearning4j_tpu_torch.serving import ContinuousLMServer

    dims = weights.gpt2_dims(cfg)
    s = mix["server"]
    params = weights.make(cfg, seed, device, torch.bfloat16)
    srv = ContinuousLMServer(
        port_config(cfg), params, slots=int(s["slots"]), kv=s["kv"],
        page_size=int(s["page_size"]),
        prefill_chunk=int(s["prefill_chunk"]), speculate=s["speculate"],
        device=device)
    srv.warmup()
    reqs = gen.ServeRequests(mix, dims["V"], seed)
    n = int(mix["clients"])
    records: list = []
    stop = threading.Event()
    t_go = time.perf_counter()
    threads = [threading.Thread(
        target=_client, daemon=True,
        args=(srv, reqs, c, n, t_go + float(mix["ramp_s"]) * c / n, stop,
              records)) for c in range(n)]
    for t in threads:
        t.start()
    t0 = t_go + float(mix["ramp_s"]) + float(mix["settle_s"])
    _sleep_until(t0)
    c0, t0 = _counters(srv, paged_flash_attention), time.perf_counter()
    setup_s = t0 - t_start
    _sleep_until(t0 + seconds)
    c1, t1 = _counters(srv, paged_flash_attention), time.perf_counter()
    traced = None
    if trace:
        tracer = Tracer(device)
        tracer.start()
        ca = _counters(srv, paged_flash_attention)
        time.sleep(float(mix["trace_s"]))
        cb = _counters(srv, paged_flash_attention)
        traced = tracer.stop()
        traced["counters"] = _delta(ca, cb)
    stop.set()
    deadline = time.perf_counter() + JOIN_S
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    hung = sum(t.is_alive() for t in threads)
    t_after = time.perf_counter()
    memory_peak = peak_bytes(device)
    srv.stop()
    window = _delta(c0, c1)
    if window["builds"]:
        print(f"warning: {window['builds']} programs built inside the "
              f"window", file=sys.stderr)

    in_w = [r for r in list(records) if t0 <= r["t_sub"] < t1]
    bad = [r for r in in_w
           if r["error"] is not None or not r["tokens"]
           or (len(r["tokens"]) != r["max_new"] and not r["abandoned"])]
    tokens = sum(sum(1 for x in r["times"] if t0 <= x < t1)
                 for r in records)
    e2e = {"serve_tokens_per_s": tokens / (t1 - t0), "setup_s": setup_s}
    window["prompt_tokens"] = sum(r["plen"] for r in in_w)
    window["requests"] = len(in_w)
    ctx = {"kind": "serve", "dims": dims, "dtype": cfg["dtype"],
           "seconds": t1 - t0, "t0": t0, "t1": t1,
           "wide_width": int(s["prefill_chunk"]), "counters": window,
           "requests": [{"plen": r["plen"], "t_sub": r["t_sub"],
                         "times": r["times"]} for r in records],
           "trace": traced}

    # the comparison, once the program's state is gone
    del srv, params
    release(device)
    sample = _sample(records, seed, int(mix["check_tokens"]), reqs)
    if sample:
        w = ref.as_float32(weights.make(cfg, seed, device, torch.bfloat16))
        ref.exact_float32()
        gaps = ref.served_gaps(w, sample, dims["eps"], device)
        numbers = {"served_gap": {"value": judge.served_gap(gaps),
                                  "tokens": sum(len(g) for g in gaps),
                                  "requests": len(gaps)},
                   "served_gap_mean": {"value": judge.served_gap_mean(gaps)}}
        del w
    else:
        numbers = {"served_gap": {"value": float("inf"), "tokens": 0,
                                  "requests": 0},
                   "served_gap_mean": {"value": float("inf")}}
    release(device)
    timing = {"setup_s": setup_s, "window_s": t1 - t0,
              "after_window_s": t_after - t1,
              "reference_s": time.perf_counter() - t_after}
    return {"attempted": len(in_w), "failed": len(bad) + hung,
            "timing": timing,
            "end_to_end": e2e, "ctx": ctx, "trace": traced,
            "memory_peak_bytes": memory_peak, "numbers": numbers,
            "records": records, "sample": sample}


def _sample(records, seed: int, want: int, reqs) -> list:
    """(prompt, served tokens) of finished requests: the longest,
    then others in an order drawn from the seed, until `want` served
    tokens."""
    done = [r for r in records if r["error"] is None
            and len(r["tokens"]) == r["max_new"]]
    if not done:
        return []
    done.sort(key=lambda r: r["idx"])
    longest = max(done, key=lambda r: (r["plen"] + len(r["tokens"]),
                                       -r["idx"]))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 7]).permutation(len(rest))
    picked, total = [longest], len(longest["tokens"])
    for i in order:
        if total >= want:
            break
        picked.append(rest[i])
        total += len(rest[i]["tokens"])
    return [(reqs.request(r["idx"])[0], list(r["tokens"])) for r in picked]
