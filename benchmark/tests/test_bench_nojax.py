"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
interpreter imports the harness, every load kind, configuration, traffic
mix and metric file, and the port's modules the kinds use, and no
loaded module's whole top-level name is ``jax``, ``jaxlib``, ``flax`` or
``deeplearning4j_tpu``."""

import json
import subprocess
import sys

from benchmark import run, spec

SCRIPT = r"""
import json, sys
from pathlib import Path
import benchmark.run as run
from benchmark import calibrate, gen, peaks, spec, trace, weights
from benchmark.kinds import serve_closed_loop, train_steps
from benchmark.reference import gpt2, judge
bench = spec.benchmark()
for c in bench["configs"]:
    spec.config(c)
for w in bench["workloads"]:
    spec.kind(spec.traffic(w["traffic"])["kind"])
for m in bench["per_layer"]:
    spec.metric_module(m["name"])
for p in sorted((spec.BENCH_DIR / "metrics").glob("*.py")):
    spec.metric_module(p.stem)
import deeplearning4j_tpu_torch.serving
import deeplearning4j_tpu_torch.parallel.hybrid
import deeplearning4j_tpu_torch.parallel.paged_kernel
print(json.dumps(run.loaded_forbidden()))
"""


def test_a_fresh_interpreter_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_check_compares_whole_top_level_names():
    mods = {"deeplearning4j_tpu_torch": 1, "deeplearning4j_tpu_torch.x": 1,
            "jaxtyping": 1, "flaxen": 1}
    assert run.loaded_forbidden(mods) == []
    mods.update({"jax.numpy": 1, "deeplearning4j_tpu": 1, "flax": 1})
    assert run.loaded_forbidden(mods) == ["deeplearning4j_tpu", "flax",
                                          "jax.numpy"]


def test_the_reference_imports_nothing_of_the_port():
    for name in ("gpt2.py", "judge.py"):
        text = (spec.BENCH_DIR / "reference" / name).read_text()
        assert "deeplearning4j_tpu" not in text
        assert "import jax" not in text
