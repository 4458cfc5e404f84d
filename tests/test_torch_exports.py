"""PyTorch port, slice 16: the package namespaces export what the JAX
package's export (ROADMAP C1).

For the top level (`__all__` and the lazy `_LAZY` table) and every
subpackage of `deeplearning4j_tpu`, each exported name must import from
the port's namespace of the same path — unless it is listed in
`UNPORTED` under the ROADMAP queue that will port it.  A listed name
that the port does define fails the test, so the list only shrinks as
slices land.
"""

import importlib
import pkgutil

import pytest

import deeplearning4j_tpu
import deeplearning4j_tpu_torch
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

_A0 = "A0 (one program a step: the compile watcher's place)"
_A6 = "A6 (scaleout/, slice 17)"
_A7 = "A7 (multi-device)"

# package -> {name: queue}
UNPORTED = {
    "deeplearning4j_tpu": {"DataParallelTrainer": _A7, "make_mesh": _A7},
    "deeplearning4j_tpu.obs": {"COMPILE_EVENT": _A0, "CompileWatcher": _A0,
                               "compile_scope": _A0,
                               "compile_watcher": _A0},
    "deeplearning4j_tpu.parallel": {
        n: _A7 for n in ("make_mesh", "DataParallelTrainer",
                         "PartitionSpec", "replicated", "sharded",
                         "reshard", "shard_tree", "gather_tree")},
    "deeplearning4j_tpu.precision": {"shard_update_finite": _A7},
    "deeplearning4j_tpu.scaleout": {
        n: _A6 for n in (
            "Job", "JobIterator", "WorkerPerformer", "JobAggregator",
            "WorkRouter", "StateTracker", "RemoteStateTracker",
            "StateTrackerServer", "ParameterAveragingAggregator",
            "DeltaSumAggregator", "NetworkPerformer", "Word2VecPerformer",
            "GlovePerformer", "Master", "Worker", "DistributedRunner",
            "IterativeReduceWorkRouter", "HogwildWorkRouter")},
}

PACKAGES = ["deeplearning4j_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(deeplearning4j_tpu.__path__,
                                          "deeplearning4j_tpu.")
    if m.ispkg)


def _exports(name):
    mod = importlib.import_module(name)
    names = list(getattr(mod, "__all__", []))
    if name == "deeplearning4j_tpu":
        names += list(mod._LAZY)
    return names


def _port_of(name):
    return "deeplearning4j_tpu_torch" + name[len("deeplearning4j_tpu"):]


@pytest.mark.parametrize("package", PACKAGES)
def test_every_exported_name_imports_from_the_port(package):
    unported = UNPORTED.get(package, {})
    names = _exports(package)
    assert set(unported) <= set(names), "UNPORTED lists a name JAX dropped"
    try:
        port = importlib.import_module(_port_of(package))
    except ImportError:
        port = None
        assert set(names) <= set(unported), (
            f"{_port_of(package)} is missing but not every name is queued")
    missing = [n for n in names if n not in unported
               and not hasattr(port, n)]
    assert not missing, f"{_port_of(package)} lacks {missing}"
    landed = [n for n in unported if port is not None and hasattr(port, n)]
    assert not landed, (f"{landed} are ported now: take them out of "
                        f"UNPORTED")


def test_named_imports_of_the_issue():
    from deeplearning4j_tpu_torch.runtime import (  # noqa: F401
        check_step_determinism,
        get_store,
        save_checkpoint,
    )
    from deeplearning4j_tpu_torch.serving import (  # noqa: F401
        FleetSupervisor,
        PageExport,
        SwapStore,
    )
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    assert deeplearning4j_tpu_torch.MultiLayerNetwork is MultiLayerNetwork
    assert "load_source" in dir(deeplearning4j_tpu_torch)


@pytest.mark.parametrize("name", ["DataParallelTrainer", "make_mesh"])
def test_unported_lazy_names_raise_naming_their_queue(name):
    with pytest.raises(AttributeError, match="A7"):
        getattr(deeplearning4j_tpu_torch, name)
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        deeplearning4j_tpu_torch.nope


def test_port_exports_resolve_to_their_defining_modules():
    """Each port `__all__` name is really bound (no stale entry)."""
    for package in PACKAGES:
        try:
            port = importlib.import_module(_port_of(package))
        except ImportError:
            continue
        for n in getattr(port, "__all__", []):
            assert hasattr(port, n), f"{port.__name__}.__all__ lists {n}"
