"""BENCHMARK.json against the benchmark's contract, the result line of a
run (driven on the CPU at a tiny size, the look for a card skipped), and
that a configuration, a mix, a cell and a metric are added as files
only."""

import json
import re
import shutil

import pytest
import torch

from benchmark import run, spec

from conftest import tiny_config, tiny_serve_mix, tiny_train_mix

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CPU = torch.device("cpu")


def test_benchmark_json_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in bench["command"])
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        cfg = spec.config(c)
        assert cfg["source"].startswith(c["source"])
        assert set(c["reduced"]) == set(cfg["changed"])
        assert not any(k.endswith(("_dim", "_rank")) or "n_embd" in k
                       or "n_head" in k or "n_inner" in k
                       for k in c["reduced"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(names)
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert spec.traffic(w["traffic"])["kind"]
        assert spec.limits(w["name"]) is not None, w["name"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    layers = {}
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        mod = spec.metric_module(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
            m["layer"], m["unit"], m["moves"])
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  spec.end_to_end_for(bench, w)}
    for w in bench["workloads"]:
        reported = [m["name"] for m in spec.end_to_end_for(bench, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer_for(bench, w["name"])
    assert len(json.dumps(bench)) < 64 * 1024


def _check_line(result, bench, workload, trace):
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device", "checks"}
    assert list(result)[-1] == "checks"
    assert json.loads(json.dumps(result)) == result
    dev = result["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        want = {m["name"] for m in spec.per_layer_for(bench, workload)}
        assert set(result["metrics"]) <= want and result["metrics"]
    else:
        want = {m["name"] for m in spec.end_to_end_for(bench, workload)}
        assert set(result["metrics"]) == want
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
def test_serve_run_prints_the_contract_line(bench, trace):
    code, result = run.execute(
        ["--workload", "rag.gpt2-small", "--seed", str(2 ** 31 + 3),
         "--seconds", "2", "--trace", str(trace)], device=CPU, bench=bench,
        cfg=tiny_config("float32"), mix=tiny_serve_mix("rag"))
    assert code == 0
    _check_line(result, bench, "rag.gpt2-small", trace)
    assert result["failed"] == 0


@pytest.mark.parametrize("trace", [0, 1])
def test_train_run_prints_the_contract_line(bench, trace):
    code, result = run.execute(
        ["--workload", "pretrain.gpt2-small", "--seed", "77",
         "--seconds", "1", "--trace", str(trace)], device=CPU, bench=bench,
        cfg=tiny_config("float32"), mix=tiny_train_mix())
    assert code == 0
    _check_line(result, bench, "pretrain.gpt2-small", trace)
    assert result["attempted"] >= 3 and set(result["checks"]) == {
        "loss_gap", "grad_gap", "grad_dist", "grad_dist_median",
        "change_gap", "nonfinite_losses"}
    if trace:
        assert "mfu.train" in result["metrics"]


def test_no_card_means_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "rag.gpt2-small", "--seed", "1",
                     "--seconds", "1"]) == run.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


def test_added_files_are_found_by_name(tmp_path, monkeypatch, bench):
    """A configuration, a mix, a cell's limits and a metric, each a new
    file, and their entries: found without editing a file."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    new = json.loads(json.dumps(bench))
    cfg = spec.config(bench["configs"][0])
    cfg["n_layer"] = 2
    (root / "benchmark/configs/gpt2-medium-2l.json").write_text(
        json.dumps(cfg))
    mix = dict(spec.traffic("chat"), clients=32)
    (root / "benchmark/traffic/chat-32.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/chat-32.gpt2-medium-2l.json").write_text(
        json.dumps({"numbers": {"served_gap": {"limit": 1.0}}}))
    (root / "benchmark/metrics/serve.requests.py").write_text(
        'LAYER = "serve scheduler (serving/lm.py)"\nUNIT = "requests"\n'
        'MOVES = "serve_tokens_per_s"\n\n\ndef read(ctx):\n'
        '    return ctx["counters"]["requests"] or None\n')
    new["configs"].append({"name": "gpt2-medium-2l", "source": "x",
                           "file": "benchmark/configs/gpt2-medium-2l.json",
                           "reduced": ["n_layer"], "why": "y"})
    new["workloads"].append({"name": "chat-32.gpt2-medium-2l",
                             "config": "gpt2-medium-2l",
                             "traffic": "chat-32", "chips": 1,
                             "why": "z"})
    for m in new["end_to_end"]:
        if "workloads" in m and "rag.gpt2-small" in m["workloads"]:
            m["workloads"].append("chat-32.gpt2-medium-2l")
    new["per_layer"].append({"name": "serve.requests", "unit": "requests",
                             "better": "higher", "source": "program_counter",
                             "layer": "serve scheduler (serving/lm.py)",
                             "moves": "serve_tokens_per_s",
                             "workloads": ["chat-32.gpt2-medium-2l"]})
    monkeypatch.setattr(spec, "BENCH_DIR", root / "benchmark")
    cell = spec.cell(new, "chat-32.gpt2-medium-2l")
    assert spec.config(cell["config_entry"], root)["n_layer"] == 2
    assert spec.traffic(cell["traffic"])["clients"] == 32
    assert spec.limits(cell["name"])["numbers"]["served_gap"]["limit"] == 1.0
    got = spec.read_per_layer(new, cell["name"],
                              {"counters": {"requests": 5}})
    assert got == {"serve.requests": {"value": 5.0, "unit": "requests"}}
    assert spec.kind(spec.traffic(cell["traffic"])["kind"]).run


def test_a_mix_with_other_adam_constants_is_refused(bench):
    """The reference reads the mix's betas and eps; the port's step
    takes none, so a mix that states others than the step runs fails
    before any step."""
    mix = tiny_train_mix()
    mix["optimizer"] = dict(mix["optimizer"], beta2=0.95)
    with pytest.raises(ValueError, match="beta2"):
        run.execute(["--workload", "pretrain.gpt2-small", "--seed", "3",
                     "--seconds", "0.5"], device=torch.device("cpu"),
                    bench=bench, cfg=tiny_config("float32"), mix=mix)
