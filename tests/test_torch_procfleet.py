"""PyTorch port, slice 14: process-hosted serving fleets
(`serving/procfleet.py`, `serving/_stub_worker.py`,
`runtime/launcher.py`, the process half of `serving/fleet.py`,
`resilience/chaos.py`'s process faults and ``serve-fleet -processes``)
against the JAX package's:

- `RestartPolicy` / `ElasticRestartPolicy` backoff schedules and
  quarantine verdicts equal to JAX's under one seed; `rewrite_replicas`
  equal; `replica_serve_command` equal but for the module name and
  ``-device``;
- launcher hygiene: log rotation and tailing, the one-shot port-bind
  retry, zero zombies over spawn/kill cycles, the group kill, the
  ready-timeout report carrying the log tail;
- the supervisor over the port's stub worker (real processes, real
  signals): lifecycle, kill -9, SIGSTOP wedge, crash-loop quarantine,
  cross-host attach, a mid-storm kill with zero failed requests;
- ``/fleet/stats`` ``supervision`` keys and the ``fleet_process_*``
  exposition lines equal on both packages' fronts after the same
  crash-and-restart;
- one ``serve-fleet -processes`` run with a real ``serve`` worker on
  ``-device cpu`` (zoo:iris-mlp): boot, answer, SIGTERM drain, the
  worker's drain snapshot with the port's ``kernel_launches``.
"""

import ast
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.runtime import launcher as jl
from deeplearning4j_tpu.serving import FleetRouter as JRouter
from deeplearning4j_tpu.serving import FleetServer as JServer
from deeplearning4j_tpu.serving import procfleet as jp
from deeplearning4j_tpu_torch.resilience import (
    ProcessChaosConfig,
    chaos_procfleet,
)
from deeplearning4j_tpu_torch.runtime import launcher as tl
from deeplearning4j_tpu_torch.serving import FleetRouter, FleetServer
from deeplearning4j_tpu_torch.serving import procfleet as tp
from deeplearning4j_tpu_torch.serving.procfleet import (
    DEATH_CLEAN,
    DEATH_CRASH,
    DEATH_WEDGED,
    RestartPolicy,
    WORKER_DOWN,
    WORKER_QUARANTINED,
    WORKER_READY,
    WORKER_STOPPED,
    WorkerSpec,
    stub_worker_command,
)
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

pytestmark = [pytest.mark.procfleet, pytest.mark.fleet, pytest.mark.chaos]

_X = np.zeros((1, 4), np.float32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _until(pred, timeout_s: float = 15.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _fast_supervisor(router, pkg=tp, **overrides):
    """Supervisor of package `pkg` at test speed (ms backoff, sub-second
    probes)."""
    policy = overrides.pop("policy", None) or pkg.RestartPolicy(
        backoff_initial_s=0.05, backoff_max_s=0.5, jitter=0.0,
        crash_loop_threshold=overrides.pop("crash_loop_threshold", 5),
        crash_loop_window_s=overrides.pop("crash_loop_window_s", 30.0))
    kw = dict(poll_interval_s=0.05, ready_timeout_s=10.0,
              wedge_threshold=2, probe_timeout_s=0.4, detach_grace_s=0.1)
    kw.update(overrides)
    return pkg.FleetSupervisor(router, policy=policy, **kw)


def _manage_stub(sup, name: str, pkg=tp, **stub_kw):
    port = _free_port()
    return sup.manage(pkg.WorkerSpec(
        name=name, url=f"http://127.0.0.1:{port}",
        command=pkg.stub_worker_command(port, **stub_kw)))


def _drive_until(sup, pred, timeout_s: float = 15.0, what: str = "state"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        sup.poll_once()
        if pred(sup):
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}; stats="
                         f"{sup.stats()}")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


# ---------------------------------------------------------------------------
# Policies and command generation, against the JAX package


@pytest.mark.parametrize("kw", [
    dict(backoff_initial_s=0.5, backoff_max_s=4.0, jitter=0.0),
    dict(backoff_initial_s=1.0, backoff_max_s=8.0, jitter=0.25),
    dict(backoff_initial_s=0.2, backoff_max_s=30.0, backoff_factor=3.0,
         jitter=0.1)], ids=["exact", "jitter", "factor3"])
def test_restart_policy_backoff_equals_jax_under_one_seed(kw):
    jpol = jp.RestartPolicy(rng=random.Random(7), **kw)
    tpol = tp.RestartPolicy(rng=random.Random(7), **kw)
    ks = [0, 1, 2, 3, 4, 5, 9, 0, 1]
    assert [tpol.backoff_s(k) for k in ks] == [jpol.backoff_s(k) for k in ks]
    if kw["jitter"] == 0.0:
        assert [tpol.backoff_s(k) for k in range(5)] == \
            [0.5, 1.0, 2.0, 4.0, 4.0]


@pytest.mark.parametrize("deaths,now", [
    ([0.0, 1.0, 2.0], 2.0), ([0.0, 20.0, 21.0], 21.0), ([1.0, 2.0], 2.0),
    ([5.0, 9.0, 15.0, 15.5], 16.0)])
def test_quarantine_verdicts_equal_jax(deaths, now):
    kw = dict(crash_loop_threshold=3, crash_loop_window_s=10.0)
    assert tp.RestartPolicy(**kw).quarantine_due(deaths, now) == \
        jp.RestartPolicy(**kw).quarantine_due(deaths, now)
    with pytest.raises(ValueError, match="crash_loop_threshold"):
        tp.RestartPolicy(crash_loop_threshold=0)


@pytest.mark.parametrize("command", [
    ["w", "-replicas", "4"], ["w", "--replicas=4"], ["w"],
    ["w", "-replicas=4", "x"]])
def test_rewrite_replicas_equals_jax(command):
    assert tp.rewrite_replicas(command, 2) == jp.rewrite_replicas(command, 2)


def test_elastic_policy_rewrites_respawns_only():
    class W:
        incarnation = 0

    pol = tp.ElasticRestartPolicy(replicas_after_crash=2)
    jpol = jp.ElasticRestartPolicy(replicas_after_crash=2)
    cmd = ["w", "-replicas", "4"]
    for inc in (0, 1, 3):
        W.incarnation = inc
        assert pol.respawn_command(W, cmd) == jpol.respawn_command(W, cmd)
    with pytest.raises(ValueError, match="replicas_after_crash"):
        tp.ElasticRestartPolicy(replicas_after_crash=0)


@pytest.mark.parametrize("kw", [
    dict(model_dir="m"),
    dict(model_dir="m", max_queue=0, breaker_threshold=0, deadline_ms=50.0,
         quantize="int8", warmup=False, drain_stats="d.json"),
    dict(model_dir=None, lm_dir="lm", lm_slots=8, lm_page_size=16,
         prefill_chunk=16, lm_ship=True, port=9001, buckets="1,8")],
    ids=["classifier", "knobs", "lm"])
@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_replica_serve_command_equals_jax_but_module_and_device(kw, device):
    kw = dict(kw)
    model = kw.pop("model_dir")
    j = jl.replica_serve_command(model, python="py", **kw)
    t = tl.replica_serve_command(model, python="py", device=device, **kw)
    want = ["py", "-m", "deeplearning4j_tpu_torch.cli"] + j[3:]
    assert t == want + ([] if device is None else ["-device", device])
    with pytest.raises(ValueError, match="needs model_dir"):
        tl.replica_serve_command(None)


def test_launcher_commands_roles_and_urls_equal_jax(tmp_path):
    kw = dict(n_replicas=3, base_port=9100, lm_dir="lm", lm_ship=True,
              roles=["prefill", "decode", "decode"], log_dir=str(tmp_path))
    jlaunch = jl.FleetProcessLauncher(None, **kw)
    tlaunch = tl.FleetProcessLauncher(None, device="cpu", **kw)
    assert tlaunch.urls() == jlaunch.urls()
    for i in range(3):
        assert tlaunch.role(i) == jlaunch.role(i)
        assert tlaunch.log_path(i) == jlaunch.log_path(i)
        j = jlaunch.command(i)
        assert tlaunch.command(i) == (
            j[:2] + ["deeplearning4j_tpu_torch.cli"] + j[3:]
            + ["-device", "cpu"])
    with pytest.raises(ValueError, match="roles has 2 entries"):
        tl.FleetProcessLauncher(None, n_replicas=3,
                                roles=["a", "b"]).role(0)


def test_stub_worker_is_stdlib_only_and_run_by_path():
    cmd = stub_worker_command(1234, ready_delay_s=0.5, never_ready=True,
                              boot_exit_code=3)
    path = cmd[1]
    assert path.endswith(os.path.join("deeplearning4j_tpu_torch", "serving",
                                      "_stub_worker.py"))
    tree = ast.parse(open(path).read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert roots <= set(sys.stdlib_module_names), roots
    j = jp.stub_worker_command(1234, ready_delay_s=0.5, never_ready=True,
                               boot_exit_code=3)
    assert cmd[2:] == j[2:]
    # boot flake: prints and exits with the code, no torch import paid
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    assert out.returncode == 3 and "boot flake" in out.stdout


# ---------------------------------------------------------------------------
# Launcher hygiene


def test_rotate_and_tail(tmp_path):
    log = tmp_path / "w.log"
    log.write_text("old line\n" * 100)
    tl.rotate_log(log, max_bytes=10, keep=2)
    assert not log.exists() and (tmp_path / "w.log.1").exists()
    log.write_text("newer\n" * 100)
    tl.rotate_log(log, max_bytes=10, keep=2)
    assert (tmp_path / "w.log.2").exists()
    (tmp_path / "t.log").write_text("\n".join(f"line-{i}"
                                              for i in range(50)))
    assert tl.tail_lines(tmp_path / "t.log", 3).splitlines() == \
        ["line-47", "line-48", "line-49"]
    assert tl.tail_lines(tmp_path / "t.log", 3) == \
        jl.tail_lines(tmp_path / "t.log", 3)
    assert tl.tail_lines(tmp_path / "missing.log") == "<no log captured>"


def test_spawn_logged_captures_stdout_with_separator(tmp_path):
    log = tmp_path / "child.log"
    proc = tl.spawn_logged(
        [sys.executable, "-c",
         "import sys; print('out-line'); print('err-line', file=sys.stderr)"],
        log)
    assert proc.wait(timeout=30) == 0
    text = log.read_text()
    assert text.startswith("--- spawn ")
    assert "out-line" in text and "err-line" in text


_SLEEPER = [sys.executable, "-c", "import time; time.sleep(60)"]
_STUBBORN = [sys.executable, "-c", """
import os, signal, subprocess, sys, time
signal.signal(signal.SIGTERM, signal.SIG_IGN)
child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
print("CHILD" + "PID:" + str(child.pid), flush=True)
time.sleep(60)
"""]


def _launcher(tmp_path, command, n=1):
    launcher = tl.FleetProcessLauncher("unused-model", n_replicas=n,
                                       base_port=_free_port(),
                                       log_dir=str(tmp_path))
    launcher.command = lambda i: list(command)
    return launcher


def test_spawn_kill_cycles_never_leave_zombies(tmp_path):
    launcher = _launcher(tmp_path, _SLEEPER)
    reaped = []
    for _ in range(3):
        proc = launcher.spawn(0)
        assert proc.poll() is None
        launcher.kill(0)
        assert proc.returncode is not None      # reaped, not defunct
        reaped.append(proc.pid)
    assert len(set(reaped)) == 3


def test_stop_escalates_to_group_kill_and_reaps(tmp_path):
    launcher = _launcher(tmp_path, _STUBBORN)
    proc = launcher.spawn(0)
    _until(lambda: "CHILDPID:" in launcher.tail_log(0), 30.0,
           what="the stubborn worker's child")
    child = int(launcher.tail_log(0).rsplit("CHILDPID:", 1)[1]
                .splitlines()[0])
    assert launcher.stop(0, grace_s=0.3) is False
    assert proc.returncode is not None
    _until(lambda: not _pid_alive(child), 10.0, what="the group's child")


def test_stop_all_covers_every_index(tmp_path):
    launcher = _launcher(tmp_path, _SLEEPER, n=2)
    procs = launcher.spawn_all()
    assert launcher.stop_all(grace_s=5.0)
    assert all(p.returncode is not None for p in procs)


def test_spawn_retries_once_then_fails_typed(tmp_path):
    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    retries = []
    try:
        with pytest.raises(tl.WorkerSpawnError, match="still bound"):
            tl.spawn_logged(_SLEEPER, tmp_path / "w.log", host="127.0.0.1",
                            port=port, bind_retry_delay_s=0.05,
                            on_bind_retry=lambda: retries.append(1))
    finally:
        blocker.close()
    assert retries == [1]


def test_retry_succeeds_when_collision_clears(tmp_path):
    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    proc = tl.spawn_logged(_SLEEPER, tmp_path / "w.log", host="127.0.0.1",
                           port=port, bind_retry_delay_s=0.05,
                           on_bind_retry=blocker.close)
    try:
        assert proc.poll() is None
    finally:
        tl.kill_process_tree(proc)
        proc.wait()


def test_attach_all_timeout_report_carries_log_tail(tmp_path):
    port = _free_port()
    launcher = tl.FleetProcessLauncher("unused-model", n_replicas=1,
                                       base_port=port, log_dir=str(tmp_path))
    launcher.command = lambda i: stub_worker_command(port, never_ready=True)
    router = FleetRouter()
    try:
        with pytest.raises(TimeoutError) as exc:
            launcher.attach_all(router, ready_timeout_s=1.5)
        assert "last log" in str(exc.value)
        assert "stub-worker: listening" in str(exc.value)
        assert router.replicas() == []
    finally:
        launcher.stop_all(grace_s=2.0)
        router.stop()


def test_attach_all_attaches_process_replicas(tmp_path):
    port = _free_port()
    launcher = tl.FleetProcessLauncher("unused-model", n_replicas=1,
                                       base_port=port, log_dir=str(tmp_path))
    launcher.command = lambda i: stub_worker_command(port)
    router = FleetRouter()
    try:
        (replica,) = launcher.attach_all(router, ready_timeout_s=15.0)
        assert replica.name == "worker-0"
        assert replica.process is launcher.procs[0]
        assert router.predict_proba(_X, timeout=30).shape == (1, 3)
        assert replica.drain(grace_s=5.0)       # SIGTERM, clean exit
        assert replica.process.returncode == 0
    finally:
        launcher.stop_all(grace_s=2.0)
        router.stop()


def test_registry_dir_backend_roundtrip(tmp_path):
    reg = tl.ClusterConfigRegistry(directory=str(tmp_path / "cfg"))
    reg.register("mesh", {"axes": [2, 4]})
    reg.register("serve", {"port": 8081})
    assert reg.retrieve("mesh") == {"axes": [2, 4]}
    assert reg.keys() == ["mesh", "serve"]
    # the JAX registry reads the same directory
    assert jl.ClusterConfigRegistry(
        directory=str(tmp_path / "cfg")).retrieve("serve") == {"port": 8081}
    with pytest.raises(KeyError):
        reg.retrieve("absent")
    with pytest.raises(ValueError, match="exactly one"):
        tl.ClusterConfigRegistry()


# ---------------------------------------------------------------------------
# The supervisor over the port's stub worker


def test_spawn_attach_predict_and_clean_stop():
    router = FleetRouter()
    sup = _fast_supervisor(router)
    try:
        _manage_stub(sup, "worker-0")
        _manage_stub(sup, "worker-1")
        assert sup.wait_all_ready(15.0)
        assert sorted(r.name for r in router.replicas()) == \
            ["worker-0", "worker-1"]
        assert router.predict_proba(_X, timeout=30).shape == (1, 3)
        assert sup.stop_worker("worker-0", grace_s=5.0)
        st = sup.stats()
        assert st["workers"]["worker-0"]["state"] == WORKER_STOPPED
        assert st["workers"]["worker-0"]["deaths"][-1]["kind"] == DEATH_CLEAN
        assert st["counters"]["deaths_clean"] == 1
        assert st["counters"]["restarts"] == 0
        assert [r.name for r in router.replicas()] == ["worker-1"]
    finally:
        sup.stop(grace_s=5.0)
        router.stop()


def test_kill9_classified_crash_restarted_and_readmitted():
    router = FleetRouter()
    sup = _fast_supervisor(router)
    try:
        worker = _manage_stub(sup, "worker-0")
        assert sup.wait_all_ready(15.0)
        old_pid = worker.proc.pid
        os.kill(old_pid, signal.SIGKILL)
        _drive_until(sup, lambda s: s.counters["deaths_crash"] >= 1,
                     what="crash detection")
        death = sup.stats()["workers"]["worker-0"]["deaths"][-1]
        assert death["kind"] == DEATH_CRASH
        assert "signal 9" in death["detail"]
        assert "stub-worker: listening" in death["detail"]
        _drive_until(sup, lambda s: s.poll_once()["worker-0"] == WORKER_READY,
                     what="backoff restart + warm-then-attach")
        st = sup.stats()
        assert st["counters"]["restarts"] == 1
        assert st["workers"]["worker-0"]["pid"] != old_pid
        assert [r.name for r in router.replicas()] == ["worker-0#1"]
        assert st["restart_events"][-1]["latency_s"] > 0
        assert router.predict_proba(_X, timeout=30).shape == (1, 3)
    finally:
        sup.stop(grace_s=5.0)
        router.stop()


def test_never_ready_killed_with_log_tail_in_report():
    router = FleetRouter()
    sup = _fast_supervisor(router, ready_timeout_s=0.8,
                           crash_loop_threshold=1)
    try:
        _manage_stub(sup, "worker-0", never_ready=True)
        _drive_until(sup, lambda s: s.stats()["workers"]["worker-0"][
            "state"] == WORKER_QUARANTINED, what="ready-timeout quarantine")
        death = sup.stats()["workers"]["worker-0"]["deaths"][-1]
        assert death["kind"] == DEATH_CRASH
        assert "not ready within" in death["detail"]
        assert "stub-worker: listening" in death["detail"]
        assert router.replicas() == []
    finally:
        sup.stop(grace_s=5.0)
        router.stop()


def test_sigstop_wedge_hard_killed_and_restarted():
    router = FleetRouter()
    sup = _fast_supervisor(router, probe_timeout_s=0.3)
    try:
        worker = _manage_stub(sup, "worker-0")
        assert sup.wait_all_ready(15.0)
        old_pid = worker.proc.pid
        os.kill(old_pid, signal.SIGSTOP)
        _drive_until(sup, lambda s: s.counters["deaths_wedged"] >= 1,
                     what="wedge classification")
        death = sup.stats()["workers"]["worker-0"]["deaths"][-1]
        assert death["kind"] == DEATH_WEDGED
        assert "alive but /readyz failed" in death["detail"]
        _drive_until(sup, lambda s: s.poll_once()["worker-0"] == WORKER_READY,
                     what="restart after the wedge kill")
        assert sup.stats()["workers"]["worker-0"]["pid"] != old_pid
        assert not _pid_alive(old_pid)
    finally:
        sup.stop(grace_s=5.0)
        router.stop()


def test_unrequested_clean_exit_is_terminal():
    router = FleetRouter()
    sup = _fast_supervisor(router)
    try:
        port = _free_port()
        sup.manage(WorkerSpec("oneshot", f"http://127.0.0.1:{port}",
                              command=[sys.executable, "-c",
                                       "print('bye', flush=True)"]))
        _drive_until(sup, lambda s: s.stats()["workers"]["oneshot"][
            "state"] == WORKER_STOPPED, what="clean-exit classification")
        last = sup.stats()["workers"]["oneshot"]["deaths"][-1]
        assert last["kind"] == DEATH_CLEAN
        assert "(unrequested)" in last["detail"]
        assert sup.stats()["counters"]["restarts"] == 0
    finally:
        sup.stop(grace_s=5.0)
        router.stop()


def test_boot_flake_quarantined_typed_surfaced_and_released():
    router = FleetRouter()
    sup = _fast_supervisor(router, crash_loop_threshold=3)
    chaos = chaos_procfleet(sup, ProcessChaosConfig(
        flake_boot_spawns=(0, 1, 2, 3, 4), flake_exit_code=7))
    try:
        _manage_stub(sup, "flaky")
        _drive_until(sup, lambda s: s.stats()["workers"]["flaky"]["state"]
                     == WORKER_QUARANTINED, what="crash-loop quarantine")
        st = sup.stats()
        worker = st["workers"]["flaky"]
        assert "CrashLoopError" in worker["error"]
        assert worker["deaths"][-1]["exit"] == 7
        assert st["counters"]["quarantines"] == 1
        assert st["counters"]["deaths_crash"] == 3
        assert chaos.spawns == 3
        fleet = router.fleet_stats()
        assert fleet["supervision"]["quarantined"] == ["flaky"]
        router.poll_health_once()
        assert sup.poll_once()["flaky"] == WORKER_QUARANTINED
        chaos.uninstall()
        sup.release("flaky")
        _drive_until(sup, lambda s: s.poll_once()["flaky"] == WORKER_READY,
                     what="post-release recovery")
        assert sup.stats()["workers"]["flaky"]["error"] is None
        with pytest.raises(ValueError, match="not quarantined"):
            sup.release("flaky")
    finally:
        chaos.uninstall()
        sup.stop(grace_s=5.0)
        router.stop()


def test_cross_host_attach_probes_delegates_and_readmits():
    class Delegating(RestartPolicy):
        def __init__(self):
            super().__init__(crash_loop_threshold=10, crash_loop_window_s=1.0)
            self.asked = []

        def restart(self, worker):
            self.asked.append(worker.name)
            return True

    port = _free_port()
    external = subprocess.Popen(stub_worker_command(port))
    router = FleetRouter()
    policy = Delegating()
    sup = _fast_supervisor(router, policy=policy, probe_timeout_s=0.3)
    try:
        sup.manage(WorkerSpec("remote", f"http://127.0.0.1:{port}"))
        _drive_until(sup, lambda s: s.poll_once()["remote"] == WORKER_READY,
                     what="cross-host attach")
        external.kill()
        external.wait()
        _drive_until(sup, lambda s: s.stats()["workers"]["remote"]["state"]
                     == WORKER_DOWN, what="unreachable detection")
        st = sup.stats()
        assert st["counters"]["spawns"] == 0
        assert st["counters"]["restart_delegations"] == 1
        assert policy.asked == ["remote"]
        external = subprocess.Popen(stub_worker_command(port))
        _drive_until(sup, lambda s: s.poll_once()["remote"] == WORKER_READY,
                     what="re-attach after the external restart")
        assert [r.name for r in router.replicas()] == ["remote#1"]
    finally:
        sup.stop(grace_s=5.0)
        router.stop()
        tl.kill_process_tree(external)
        external.wait()


def test_kill9_mid_storm_zero_failed_restarted_readmitted():
    router = FleetRouter(request_timeout_s=60.0)
    sup = _fast_supervisor(router)
    chaos = chaos_procfleet(sup, ProcessChaosConfig(kill_at_dispatch=20))
    failed, lock = [], threading.Lock()
    try:
        for i in range(3):
            _manage_stub(sup, f"worker-{i}")
        assert sup.wait_all_ready(15.0)
        sup.start(0.05)

        def client():
            for _ in range(20):
                try:
                    router.predict_proba(_X, timeout=60)
                except Exception as e:  # noqa: BLE001 — the test counts failures
                    with lock:
                        failed.append(e)

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert failed == []
        assert len(chaos.killed) == 1
        _until(lambda: sup.counters["restarts"] >= 1, 20.0,
               what="the supervised restart")
        _until(lambda: all(w["state"] == WORKER_READY
                           for w in sup.stats()["workers"].values()), 20.0,
               what="re-admission")
        stats = router.fleet_stats(include_replica_stats=False)
        assert stats["fleet"]["replicas_routable"] == 3
        assert stats["fleet"]["failovers"] >= 1
        assert sup.stats()["counters"]["quarantines"] == 0
    finally:
        chaos.uninstall()
        sup.stop(grace_s=5.0)
        router.stop()


# ---------------------------------------------------------------------------
# Observability: both fronts after the same crash and restart


def _crash_and_restart(pkg, router_cls, server_cls):
    """One stub worker behind a front: SIGKILL, restart, readmit; returns
    (/fleet/stats, the fleet_process_* lines of /metrics)."""
    router = router_cls()
    sup = _fast_supervisor(router, pkg=pkg)
    front = None
    try:
        worker = _manage_stub(sup, "worker-0", pkg=pkg)
        assert sup.wait_all_ready(15.0)
        front = server_cls(router, port=0).start()
        os.kill(worker.proc.pid, signal.SIGKILL)
        _drive_until(sup, lambda s: (
            s.counters["restarts"] >= 1
            and s.stats()["workers"]["worker-0"]["state"] == WORKER_READY),
            what="crash + restart before the scrape")
        with urllib.request.urlopen(front.url + "/fleet/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(front.url + "/metrics", timeout=30) as r:
            lines = [ln for ln in r.read().decode().splitlines()
                     if "fleet_process_" in ln]
        return stats, lines
    finally:
        sup.stop(grace_s=5.0)
        if front is not None:
            front.stop()
        else:
            router.stop()


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        out = set()
        for k, v in tree.items():
            out |= {f"{prefix}/{k}"} | _keys(v, f"{prefix}/{k}")
        return out
    return set()


def test_supervision_section_and_exposition_equal_on_both_fronts():
    jstats, jlines = _crash_and_restart(jp, JRouter, JServer)
    tstats, tlines = _crash_and_restart(tp, FleetRouter, FleetServer)
    assert _keys(tstats["supervision"]) == _keys(jstats["supervision"])
    for st in (jstats, tstats):
        sup = st["supervision"]
        assert sup["counters"] == {
            "spawns": 2, "restarts": 1, "spawn_retries": 0,
            "quarantines": 0, "restart_delegations": 0,
            "deaths_clean": 0, "deaths_crash": 1, "deaths_wedged": 0}
        assert sup["workers"]["worker-0"]["state"] == WORKER_READY

    def norm(lines):
        # the restart latency is a wall time: its name and type only
        return [re.sub(r"(last_restart_latency_seconds) [0-9.e+-]+$",
                       r"\1 <t>", ln) for ln in lines]

    assert norm(tlines) == norm(jlines)
    assert "fleet_process_spawns_total 2.0" in tlines or \
        "fleet_process_spawns_total 2" in tlines
    assert 'fleet_process_deaths_total{kind="crash"} 1' in "\n".join(tlines)


# ---------------------------------------------------------------------------
# serve-fleet -processes with a real worker on the CPU


def test_cli_serve_fleet_processes_boots_serves_and_drains(tmp_path):
    base = _free_port()
    logs = tmp_path / "logs"
    stats = tmp_path / "fleet.json"
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve-fleet",
         "-model", "zoo:iris-mlp", "-replicas", "1", "-processes",
         "-warmup", "-buckets", "1,8", "-port", "0", "-device", "cpu",
         "-worker-base-port", str(base), "-worker-log-dir", str(logs),
         "-restart-backoff-s", "0.2", "-health-interval-s", "0.2",
         "-ready-timeout-s", "120", "-drain-stats", str(stats)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, start_new_session=True)
    lines = []
    try:
        url = None
        deadline = time.monotonic() + 150
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"Serving fleet on (http://\S+)", line)
            if m:
                url = m.group(1)
                break
            assert time.monotonic() < deadline, "".join(lines)
        assert url, "".join(lines)
        req = urllib.request.Request(
            url + "/model/predict",
            data=json.dumps({"features": [[0.1, 0.2, 0.3, 0.4]] * 2}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert len(json.loads(r.read())["predictions"]) == 2
        with urllib.request.urlopen(url + "/fleet/stats", timeout=30) as r:
            fleet = json.loads(r.read())
        sup = fleet["supervision"]
        assert sup["workers"]["worker-0"]["state"] == WORKER_READY
        assert sup["counters"]["spawns"] == 1
        worker_pid = sup["workers"]["worker-0"]["pid"]
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            assert "fleet_process_spawns_total" in r.read().decode()
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=90)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    text = "".join(lines)
    assert proc.returncode == 0, text
    assert "supervised worker processes in rotation" in text
    assert not _pid_alive(worker_pid)           # reaped, no orphan
    snap = json.loads(stats.read_text())       # taken before the stop
    assert snap["supervision"]["workers"]["worker-0"]["state"] == \
        WORKER_READY
    log = (logs / "worker-0.log").read_text()
    assert "serve: SIGTERM — draining" in log
    drain = json.loads((logs / "worker-0.drain.json").read_text())
    assert drain["kernel_launches"]["total"]["paged_attention"] == 0
    assert set(drain["kernel_launches"]) == {"warmup", "total"}
