"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this folder and
the port (`deeplearning4j_tpu_torch`).  The cell's traffic names its
kind, whose module sets up, measures the window, and compares what the
timed path produced with the plain reference.  With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, read by `benchmark/metrics/<name>.py` from the
window's counters and a traced span after it.

The last lines on standard error, and the ``checks`` key that comes last
in the result, give each number compared with its limit.  The run exits
with another code than 0 and prints no result when there are fewer cards
than the cell asks for, or when any of ``jax``, ``jaxlib``, ``flax`` or
the JAX package was loaded into this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_BENCH = Path(__file__).resolve().parent
# every cache the run may write stays inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(_BENCH / ".cache" / _sub))
# a library that loads JAX by itself (transformers) is told not to
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")
EXIT_NO_CARD, EXIT_JAX = 2, 3


def loaded_forbidden(modules=None) -> list:
    """Loaded modules whose whole top-level name is a forbidden one (the
    port, ``deeplearning4j_tpu_torch``, is not ``deeplearning4j_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _cards(chips: int):
    """The card the run uses, or None (the reason on standard error)."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def _number(x: float) -> float:
    return float(x) if math.isfinite(float(x)) else None


def execute(argv=None, device=None, bench=None, cfg=None, mix=None):
    """One run: (exit code, result dict or None).  Tests pass `device`
    (skipping the look for a card), and may pass `bench`, `cfg` and `mix`
    in place of the files."""
    import torch

    from benchmark import spec
    from benchmark.reference import judge

    args = _parse(argv)
    bench = spec.benchmark() if bench is None else bench
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(cell["config_entry"]) if cfg is None else cfg
    mix = spec.traffic(cell["traffic"]) if mix is None else mix
    if device is None:
        device = _cards(int(cell["chips"]))
        if device is None:
            return EXIT_NO_CARD, None
    out = spec.kind(mix["kind"]).run(
        cell=cell, cfg=cfg, mix=mix, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=device, t_start=T_START)
    ok, checks = judge.judge(out["numbers"], spec.limits(args.workload))
    correct = bool(ok and out["failed"] == 0)
    if args.trace:
        metrics = spec.read_per_layer(bench, args.workload, out["ctx"])
    else:
        units = {m["name"]: m["unit"]
                 for m in spec.end_to_end_for(bench, args.workload)}
        metrics = {n: {"value": _number(out["end_to_end"][n]), "unit": u}
                   for n, u in units.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if out["trace"] is not None:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                               "idle_gaps": out["trace"]["idle_gaps"]}
    result["checks"] = checks
    print("timing: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                 out["timing"].items()), file=sys.stderr)
    return 0, result


def main(argv=None) -> int:
    code, result = execute(argv)
    if result is None:
        return code
    found = loaded_forbidden()
    if found:
        print(f"refused: modules of JAX or the JAX package were loaded: "
              f"{found[:10]}", file=sys.stderr)
        return EXIT_JAX
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
