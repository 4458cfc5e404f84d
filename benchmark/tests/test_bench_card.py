"""On the card, at each cell's own size (skipped without one; minutes a
cell): a run comes out correct, and the control, the plain reference in
float8 in the program's place, fails the cell's committed limits, as do
the faults the cell can have, read against the same reference."""

import json
import subprocess
import sys

import pytest

from benchmark import spec

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(card, name, tmp_path):
    log = tmp_path / "calib.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.calibrate", "--workload", name,
         "--seeds", "4242", "--control-seeds", "4242", "--seconds", "2",
         "--out", str(log)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    read = [x for x in lines if "what" in x]
    assert {x["what"] for x in read} >= {"program", "control_fp8"}
    for line in read:
        want = line["what"] == "program"
        assert line["correct"] is want, (line["what"], line["numbers"])
