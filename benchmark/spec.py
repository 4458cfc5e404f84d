"""Everything the harness finds by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration, traffic mix and chips, and the metrics.  The files behind
those names sit in folders of their own, so a later change adds a cell,
a mix or a metric by adding files and entries, never by editing one:

- ``benchmark/configs/<config>.json``: the model's sizes as run;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, read by the
  module its ``kind`` names (``benchmark/kinds/<kind>.py``);
- ``benchmark/metrics/<metric>.py``: one per-layer metric's reader;
- ``benchmark/limits/<cell>.json``: the limits of the numbers that decide
  a cell's ``correct``, with the readings they were set from.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _name(value: str, what: str) -> str:
    if not NAME.match(str(value)):
        raise ValueError(f"{what} {value!r} is not a name (letters, digits, "
                         f"'_', '.', '-'; at most 64)")
    return str(value)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    """The cell named `workload`, with its config entry beside it."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            cfgs = {c["name"]: c for c in bench["configs"]}
            return {**w, "config_entry": cfgs[w["config"]]}
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(entry: dict, root: Path = ROOT) -> dict:
    """A configuration's file (the path BENCHMARK.json gives)."""
    return load_json(root / entry["file"])


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{_name(name, 'traffic')}.json")


def limits(workload: str) -> Optional[dict]:
    path = BENCH_DIR / "limits" / f"{_name(workload, 'workload')}.json"
    return load_json(path) if path.is_file() else None


def kind(name: str):
    """The module that runs a traffic mix of kind `name`."""
    if not re.match(r"^[a-z][a-z0-9_]*$", name):
        raise ValueError(f"traffic kind {name!r} is not a module name")
    return importlib.import_module(f"benchmark.kinds.{name}")


def metric_module(name: str):
    """A per-layer metric's reader, ``benchmark/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{_name(name, 'metric')}.py"
    mod_name = "benchmark.metrics." + name.replace(".", "__").replace("-", "_")
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def end_to_end_for(bench: dict, workload: str) -> List[dict]:
    """The end-to-end metrics this cell reports: those without a
    ``workloads`` list, and those whose list names it."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_for(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics read in this cell: those whose ``workloads``
    name it; one without the key wherever the cell reports the metric it
    moves."""
    reported = {m["name"] for m in end_to_end_for(bench, workload)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def read_per_layer(bench: dict, workload: str, ctx: Dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell read from `ctx`; one whose reader
    finds nothing to read (returns None) is left out."""
    out = {}
    for m in per_layer_for(bench, workload):
        value = metric_module(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
