"""The readings that the limits of ``correct`` are set from, on the card
at the cell's own size, in one process:

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,...,12 \
        --control-seeds 1,2,3 --seconds 4 [--out FILE]

For every seed it runs the cell as a benchmark run does (a short window)
and keeps the numbers its comparison reads: the lower readings.  For the
control seeds it also reads the control in the program's place (the
plain reference in float8, `reference.gpt2`) and the faults the cell can
have, against the same float32 reference:

- serving: at every served position of the checked requests, the gap of
  the token the float8 reference puts first; a served token altered (one
  a request, at a position drawn from the seed);
- training: the float8 reference's steps; half of each microbatch left
  out, the mean over the rest; the state left unchanged (no update).

Each line of the output (JSON, one a reading) names the seed, what was
read, the numbers, and the ``correct`` that the cell's committed limits
(`benchmark/limits/<cell>.json`, through `reference.judge`) give them:
true for every sound run, false for every control and fault.  The last
line sums each number's largest lower reading and smallest upper
reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import run as bench_run
from benchmark import spec, weights
from benchmark.kinds import release
from benchmark.reference import gpt2 as ref
from benchmark.reference import judge


def _serve_faults(out, cfg, seed, device) -> dict:
    dims = weights.gpt2_dims(cfg)
    w = ref.as_float32(weights.make(cfg, seed, device, torch.bfloat16))
    ref.exact_float32()
    sample = out["sample"]
    control = ref.served_gaps(w, sample, dims["eps"], device, low="fp8")
    rng = np.random.default_rng([int(seed), 11])
    altered = []
    for prompt, served in sample:
        served = list(served)
        j = int(rng.integers(0, len(served)))
        served[j] = (served[j] + 1 + int(rng.integers(0, dims["V"] - 1))) \
            % dims["V"]
        altered.append((prompt, served))
    fault = ref.served_gaps(w, altered, dims["eps"], device)
    del w
    release(device)
    return {what: {"served_gap": judge.served_gap(g),
                   "served_gap_mean": judge.served_gap_mean(g)}
            for what, g in (("control_fp8", control),
                            ("fault_token_altered", fault))}


def _train_faults(out, cfg, mix, seed, device) -> dict:
    dims = weights.gpt2_dims(cfg)
    o, accum, rows = mix["optimizer"], int(mix["accum"]), \
        int(mix["reference_rows"])
    from benchmark import gen

    data = torch.from_numpy(gen.train_batches(mix, dims["V"], seed)).to(
        device)
    first = [data[i] for i in range(int(mix["setup_steps"]))]
    r = out["reference"]
    ref.exact_float32()
    res = {}
    for what, kw in (("control_fp8", {"low": "fp8"}),
                     ("fault_half_batch", {"keep_rows": 0.5})):
        w = weights.make(cfg, seed, device, torch.float32, separate=True)
        got = ref.train_steps(w, first, dims["eps"], o, accum, rows, **kw)
        res[what] = {k: v["value"] for k, v in
                     judge.train_numbers(got, r).items()}
        del w
        release(device)
    unchanged = {"loss": [r["loss"][0]] * len(r["loss"]),
                 "grad": r["grad"], "first": r["first"],
                 "change": {n: 0.0 for n in r["change"]}}
    res["fault_state_unchanged"] = {
        k: v["value"] for k, v in judge.train_numbers(unchanged, r).items()}
    return res


def faults(out, cfg, mix, seed, device) -> dict:
    """``{what: {number: value}}`` of the control and of each fault the
    cell's kind can have, against the reference of `out`'s run."""
    if mix["kind"].startswith("serve"):
        return _serve_faults(out, cfg, seed, device)
    return _train_faults(out, cfg, mix, seed, device)


def verdict(numbers: dict, limits: dict) -> bool:
    """The ``correct`` that `limits` give these readings."""
    return judge.judge({k: {"value": v} for k, v in numbers.items()},
                       limits)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(cell["config_entry"])
    mix = spec.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    drv = spec.kind(mix["kind"])
    limits = spec.limits(args.workload)
    sink = open(args.out, "a") if args.out else None
    lower, upper = {}, {}

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    for seed in seeds:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = drv.run(cell=cell, cfg=cfg, mix=mix, seed=seed,
                      seconds=args.seconds, trace=False, device=device,
                      t_start=time.perf_counter())
        nums = {k: v["value"] for k, v in out["numbers"].items()}
        for k, v in nums.items():
            lower[k] = max(lower.get(k, 0.0), v)
        emit({"seed": seed, "what": "program", "numbers": nums,
              "correct": bool(out["failed"] == 0
                              and verdict(nums, limits)),
              "detail": {k: {x: y for x, y in v.items() if x != "value"}
                         for k, v in out["numbers"].items()},
              "failed": out["failed"], "attempted": out["attempted"],
              "end_to_end": out["end_to_end"],
              "seconds": time.perf_counter() - t})
        if seed in controls:
            for what, nums in faults(out, cfg, mix, seed, device).items():
                for k, v in nums.items():
                    upper.setdefault(what, {})
                    upper[what][k] = min(upper[what].get(k, float("inf")), v)
                emit({"seed": seed, "what": what, "numbers": nums,
                      "correct": verdict(nums, limits)})
        del out
        release(device)
    emit({"summary": True, "lower_max": lower, "upper_min": upper,
          "card": torch.cuda.get_device_name(device),
          "loaded_forbidden": bench_run.loaded_forbidden()})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
