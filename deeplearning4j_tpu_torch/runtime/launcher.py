"""Process launching, the cluster config registry and pod provisioning
(counterpart of `deeplearning4j_tpu.runtime.launcher`).

- `initialize_multihost`: joins this process to the job's
  `torch.distributed` process group, the counterpart of
  `jax.distributed.initialize` (NCCL on the card, gloo on the CPU);
  `parallel.mesh.make_mesh` then builds the mesh over every process;
- `ClusterConfigRegistry`: register/retrieve JSON configs cluster-wide,
  backed by a shared directory or a tracker's global map (the reference's
  ZooKeeper config register);
- `spawn_logged` / `kill_process_tree` / `rotate_log` / `tail_lines`:
  spawning a worker process the supervisable way (its own session, its
  output captured to a size-rotated log, a port-bind pre-check) and
  tearing its process group down;
- `replica_serve_command` / `FleetProcessLauncher`: one ``cli serve``
  worker process per serving replica, supervised by
  `serving.procfleet.FleetSupervisor`;
- `TpuPodProvisioner`: the gcloud TPU-VM command lines for a pod slice
  (create, ssh fan-out, scp, delete), the JAX module's, argument for
  argument.  Generating them is in scope; running them needs cloud
  credentials.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         device=None, timeout_s: float = 600.0) -> dict:
    """Join this process to the job's `torch.distributed` process group
    and return JAX's summary: ``process_index``, ``process_count``,
    ``local_devices`` (the cards this process was given: 1 when `device`
    names one, every visible card when it is left to the default, 1 on
    the CPU) and ``global_devices`` (their sum over the processes).

    `coordinator_address` (``host:port`` of process 0's rendezvous) makes
    a ``tcp://`` rendezvous with `num_processes` and `process_id`; with
    no address torch's ``env://`` rendezvous reads the launcher's
    variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), as `jax.distributed` discovers a TPU pod.  `device`
    follows the port's device rule (`device.resolve_device`: the card by
    default, `RuntimeError` without one; ``"cpu"`` asks for the CPU) and
    picks the backend: NCCL on a card, gloo on the CPU.  `backend`
    overrides that choice explicitly (``"gloo"`` for several processes
    on one card, which NCCL refuses).  A collective or barrier that
    waits longer than `timeout_s` for a peer fails."""
    import datetime

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend,
        init_method=("env://" if coordinator_address is None
                     else f"tcp://{coordinator_address}"),
        timeout=datetime.timedelta(seconds=float(timeout_s)), **kwargs)
    local = (torch.cuda.device_count()
             if dev.type == "cuda" and device is None else 1)
    counts: list = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": local,
        "global_devices": sum(counts),
    }


class ClusterConfigRegistry:
    """Register/retrieve named JSON configs cluster-wide.

    backend="dir": a shared filesystem directory (NFS/GCS-fuse) holds one
    JSON file per key — the znode analog.
    backend="tracker": the scaleout TCP tracker's global map serves the
    configs (pass a StateTracker/RemoteStateTracker as `tracker`).
    """

    def __init__(self, directory: Optional[str] = None, tracker=None):
        if (directory is None) == (tracker is None):
            raise ValueError("pass exactly one of directory / tracker")
        self.directory = directory
        self.tracker = tracker
        if directory:
            os.makedirs(directory, exist_ok=True)

    def register(self, key: str, config: dict) -> None:
        if self.tracker is not None:
            self.tracker.set_global(f"config/{key}", json.dumps(config))
            return
        path = pathlib.Path(self.directory) / f"{key}.json"
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(config, indent=2, sort_keys=True))
        tmp.replace(path)

    def retrieve(self, key: str) -> dict:
        if self.tracker is not None:
            raw = self.tracker.get_global(f"config/{key}")
            if raw is None:
                raise KeyError(key)
            return json.loads(raw)
        path = pathlib.Path(self.directory) / f"{key}.json"
        if not path.exists():
            raise KeyError(key)
        return json.loads(path.read_text())

    def keys(self) -> List[str]:
        if self.tracker is not None:
            raise NotImplementedError("tracker backend lists via tracker")
        return sorted(p.stem for p in
                      pathlib.Path(self.directory).glob("*.json"))


class WorkerSpawnError(RuntimeError):
    """Spawning a worker process failed for a reason the caller can act
    on (port-bind collision after the retry, unlaunchable command).  The
    message carries the worker's captured log tail when one exists."""


def _port_in_use(host: str, port: int) -> bool:
    """True when `host:port` is actively bound.  SO_REUSEADDR on the
    probe socket matches the workers' own listen sockets, so a port in
    TIME_WAIT (a restarted worker's previous incarnation) reads as FREE
    — only a live listener collides."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, int(port)))
        except OSError:
            return True
    return False


def rotate_log(path, max_bytes: int = 512 * 1024, keep: int = 3) -> None:
    """Size-capped rotation: when `path` exceeds `max_bytes`, shift
    ``path -> path.1 -> ... -> path.keep`` (oldest dropped).  Called at
    spawn time, so one worker incarnation's log is never split
    mid-stream — a crash report's tail always reads contiguously."""
    path = pathlib.Path(path)
    try:
        if not path.exists() or path.stat().st_size <= max_bytes:
            return
        for i in range(keep - 1, 0, -1):
            src = path.with_name(path.name + f".{i}")
            if src.exists():
                src.replace(path.with_name(path.name + f".{i + 1}"))
        if keep >= 1:
            path.replace(path.with_name(path.name + ".1"))
    except OSError:
        # rotation is best-effort: a full disk or permission hiccup must
        # not block the spawn itself (the log just keeps growing)
        pass


def tail_lines(path, n: int = 20) -> str:
    """The last `n` lines of a (possibly missing) log file — what gets
    attached to ready-timeout and crash reports."""
    try:
        raw = pathlib.Path(path).read_bytes()
    except OSError:
        return "<no log captured>"
    text = raw.decode("utf-8", errors="replace")
    lines = text.splitlines()
    return "\n".join(lines[-n:]) if lines else "<log empty>"


def spawn_logged(command: List[str], log_path=None, *,
                 host: Optional[str] = None, port: Optional[int] = None,
                 bind_retry_delay_s: float = 0.5,
                 max_log_bytes: int = 512 * 1024, log_keep: int = 3,
                 on_bind_retry: Optional[Callable[[], None]] = None,
                 env: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    """Spawn one worker process the supervisable way:

    - stdout+stderr captured to `log_path` (size-rotated at spawn, with
      a spawn-separator line) so crash/ready-timeout reports can attach
      the last lines;
    - its own session (process GROUP), so teardown can `killpg` the
      worker *and* anything it forked instead of orphaning children;
    - when `host`/`port` are given, a port-bind pre-check that retries
      ONCE after `bind_retry_delay_s` (a restarting worker racing its
      previous incarnation's close) before failing with a typed
      `WorkerSpawnError` — never a silent spawn into a port another
      process owns.
    """
    if host is not None and port is not None:
        if _port_in_use(host, port):
            if on_bind_retry is not None:
                on_bind_retry()
            time.sleep(max(0.0, float(bind_retry_delay_s)))
            if _port_in_use(host, port):
                tail = tail_lines(log_path) if log_path else ""
                raise WorkerSpawnError(
                    f"port {host}:{port} still bound after one "
                    f"{bind_retry_delay_s}s bind-collision retry; refusing "
                    f"to spawn {command[:3]}..."
                    + (f"\nlast log lines:\n{tail}" if tail else ""))
    stdout = stderr = None
    log_f = None
    if log_path is not None:
        log_path = pathlib.Path(log_path)
        log_path.parent.mkdir(parents=True, exist_ok=True)
        rotate_log(log_path, max_bytes=max_log_bytes, keep=log_keep)
        log_f = open(log_path, "ab")
        log_f.write((f"--- spawn {time.strftime('%Y-%m-%dT%H:%M:%S')} "
                     f"cmd={' '.join(map(str, command))}\n").encode())
        log_f.flush()
        stdout, stderr = log_f, subprocess.STDOUT
    try:
        proc = subprocess.Popen(command, stdout=stdout, stderr=stderr,
                                start_new_session=True, env=env)
    finally:
        if log_f is not None:
            # the child inherited the fd; the parent's copy would leak
            # one open file per restart otherwise
            log_f.close()
    return proc


def kill_process_tree(proc: subprocess.Popen,
                      sig: int = signal.SIGKILL) -> None:
    """Signal a spawned worker's whole process GROUP (it was started in
    its own session — `spawn_logged`), falling back to the process alone
    when the group is not ours to signal.  Killing only the leader would
    orphan anything the worker forked."""
    try:
        pgid = os.getpgid(proc.pid)
    except (ProcessLookupError, OSError):
        pgid = None
    if pgid is not None and pgid == proc.pid:
        # only when the worker IS its group's leader (start_new_session):
        # signalling some inherited group could hit the parent itself
        try:
            os.killpg(pgid, sig)
            return
        except (ProcessLookupError, PermissionError, OSError):
            pass
    try:
        proc.send_signal(sig)
    except (ProcessLookupError, OSError):
        pass


def replica_serve_command(model_dir: Optional[str], *,
                          host: str = "127.0.0.1",
                          port: int = 8081, buckets: str = "1,8,32",
                          max_batch: int = 32, max_wait_ms: float = 2.0,
                          warmup: bool = True,
                          max_queue: Optional[int] = None,
                          deadline_ms: Optional[float] = None,
                          breaker_threshold: Optional[int] = None,
                          quantize: Optional[str] = None,
                          lm_dir: Optional[str] = None,
                          lm_slots: Optional[int] = None,
                          lm_page_size: Optional[int] = None,
                          prefill_chunk: Optional[int] = None,
                          lm_ship: bool = False,
                          drain_stats: Optional[str] = None,
                          python: Optional[str] = None,
                          device: Optional[str] = None) -> List[str]:
    """The command line for ONE process-hosted serving replica: a
    ``cli serve`` worker on its own port, with graceful SIGTERM drain
    built in (cli.py), ready to be attached to a `FleetRouter` by URL.
    The JAX package's command with this package's module, plus
    ``-device`` when `device` is given (the worker's default is
    ``cuda``).  `FleetProcessLauncher` spawns them."""
    if not model_dir and not lm_dir:
        raise ValueError("replica_serve_command needs model_dir and/or "
                         "lm_dir (a worker with neither serves nothing)")
    cmd = [python or sys.executable, "-m", "deeplearning4j_tpu_torch.cli",
           "serve", "-host", host,
           "-port", str(int(port)), "-buckets", buckets,
           "-max-batch", str(int(max_batch)),
           "-max-wait-ms", str(float(max_wait_ms))]
    if model_dir:
        cmd += ["-model", str(model_dir)]
    if lm_dir:
        # LM worker knobs: role-split fleets run LM pools in
        # their workers; the role itself is ROUTER state (WorkerSpec),
        # not a worker flag — every worker serves the same surface
        cmd += ["-lm", str(lm_dir)]
        if lm_slots is not None:
            cmd += ["-lm-slots", str(int(lm_slots))]
        if lm_page_size is not None:
            cmd += ["-page-size", str(int(lm_page_size))]
        if prefill_chunk is not None:
            cmd += ["-prefill-chunk", str(int(prefill_chunk))]
        if lm_ship:
            cmd.append("-lm-ship")
    if warmup:
        cmd.append("-warmup")
    # `is not None`, not truthiness: the serve parser documents 0 as
    # "unbounded"/"disabled", so an explicit 0 must be EMITTED (omitting
    # it would silently reinstate the parser defaults: max-queue 256,
    # breaker-threshold 5)
    if max_queue is not None:
        cmd += ["-max-queue", str(int(max_queue))]
    if deadline_ms is not None:
        cmd += ["-deadline-ms", str(float(deadline_ms))]
    if breaker_threshold is not None:
        cmd += ["-breaker-threshold", str(int(breaker_threshold))]
    if quantize:
        cmd += ["-quantize", quantize]
    # the SIGTERM drain snapshot must never land in whatever CWD the
    # parent happened to run from (`serve`'s default is a relative
    # serving_stats.json — a worker fleet would litter the repo root);
    # callers that care pass a real path, everyone else discards it
    cmd += ["-drain-stats", str(drain_stats) if drain_stats
            else os.devnull]
    if device is not None:
        cmd += ["-device", str(device)]
    return cmd


@dataclass
class FleetProcessLauncher:
    """Process-per-replica launching for real serving-fleet deployments
    (serving/fleet.py): replica i is its own ``cli serve`` process on
    `base_port + i` — a replica crash is a real process death, and the
    router's failover/ejection path sees exactly what it would see in
    production.  `spawn()` launches workers in their own sessions with
    rotating per-worker log capture and a port-bind-collision retry;
    `stop()`/`kill()`/`stop_all()` always reap.  End-to-end process
    supervision (crash detection, backoff restart, crash-loop
    quarantine, re-attach) lives in `serving.procfleet.FleetSupervisor`
    — `FleetSupervisor.manage_launcher(launcher)` hands it these
    workers.  `device` is passed to every worker as ``-device`` (None:
    the worker's default, ``cuda``).  The CPU tests run the process path
    against the stdlib stub worker (`serving/_stub_worker.py`) and one
    real ``-device cpu`` worker."""

    model_dir: Optional[str]
    n_replicas: int = 2
    host: str = "127.0.0.1"
    base_port: int = 8081
    buckets: str = "1,8,32"
    max_batch: int = 32
    max_wait_ms: float = 2.0
    warmup: bool = True
    max_queue: Optional[int] = None
    deadline_ms: Optional[float] = None
    breaker_threshold: Optional[int] = None
    quantize: Optional[str] = None
    # LM serving + disaggregated roles: when `roles` is set
    # (one entry per worker: "prefill"/"decode"/"both"), worker i's
    # router-side replica carries roles[i]; the worker COMMANDS are
    # identical either way — role is routing policy, not worker config
    lm_dir: Optional[str] = None
    lm_slots: Optional[int] = None
    lm_page_size: Optional[int] = None
    prefill_chunk: Optional[int] = None
    lm_ship: bool = False
    roles: Optional[List[str]] = None
    # per-worker stdout/stderr capture (None = inherit the launcher's):
    # {log_dir}/worker-{i}.log, size-rotated at spawn
    log_dir: Optional[str] = None
    max_log_bytes: int = 512 * 1024
    log_rotations: int = 3
    device: Optional[str] = None
    # spawned children, by worker index — `spawn`/`stop`/`kill` keep this
    # reaped (`wait()`ed) so spawn/kill cycles never accumulate zombies
    procs: Dict[int, subprocess.Popen] = field(default_factory=dict,
                                               repr=False)

    def port(self, i: int) -> int:
        return int(self.base_port) + int(i)

    def url(self, i: int) -> str:
        return f"http://{self.host}:{self.port(i)}"

    def urls(self) -> List[str]:
        return [self.url(i) for i in range(int(self.n_replicas))]

    def role(self, i: int) -> str:
        """Router-side role for worker i ("both" when undifferentiated)."""
        if self.roles is None:
            return "both"
        if len(self.roles) != int(self.n_replicas):
            raise ValueError(
                f"roles has {len(self.roles)} entries for "
                f"{self.n_replicas} workers")
        return self.roles[int(i)]

    def command(self, i: int) -> List[str]:
        # worker drain snapshots ride the log dir (one file per worker)
        # or are discarded — never the parent's CWD
        drain = (str(pathlib.Path(self.log_dir)
                     / f"worker-{i}.drain.json")
                 if self.log_dir is not None else None)
        return replica_serve_command(
            self.model_dir, host=self.host, port=self.port(i),
            buckets=self.buckets, max_batch=self.max_batch,
            max_wait_ms=self.max_wait_ms, warmup=self.warmup,
            max_queue=self.max_queue, deadline_ms=self.deadline_ms,
            breaker_threshold=self.breaker_threshold,
            quantize=self.quantize, lm_dir=self.lm_dir,
            lm_slots=self.lm_slots, lm_page_size=self.lm_page_size,
            prefill_chunk=self.prefill_chunk, lm_ship=self.lm_ship,
            drain_stats=drain, device=self.device)

    def log_path(self, i: int) -> Optional[pathlib.Path]:
        if self.log_dir is None:
            return None
        return pathlib.Path(self.log_dir) / f"worker-{i}.log"

    def tail_log(self, i: int, lines: int = 20) -> str:
        """The worker's last captured log lines (attached to crash and
        ready-timeout reports); a placeholder string when no `log_dir`
        was configured."""
        path = self.log_path(i)
        return tail_lines(path, lines) if path else "<no log captured>"

    def spawn(self, i: int,
              on_bind_retry: Optional[Callable[[], None]] = None
              ) -> "subprocess.Popen":
        """Spawn worker `i` in its own session with log capture and the
        one-shot port-bind-collision retry (`spawn_logged`).  A previous
        incarnation that already exited is `wait()`ed first — repeated
        spawn/kill cycles must never accumulate defunct children."""
        prev = self.procs.get(i)
        if prev is not None and prev.poll() is not None:
            prev.wait()
        proc = spawn_logged(self.command(i), self.log_path(i),
                            host=self.host, port=self.port(i),
                            max_log_bytes=self.max_log_bytes,
                            log_keep=self.log_rotations,
                            on_bind_retry=on_bind_retry)
        self.procs[i] = proc
        return proc

    def spawn_all(self) -> List["subprocess.Popen"]:
        return [self.spawn(i) for i in range(int(self.n_replicas))]

    def stop(self, i: int, grace_s: float = 5.0) -> bool:
        """SIGTERM worker `i` (graceful drain — cli.py installs the
        handler), escalate to a process-group SIGKILL after `grace_s`,
        and ALWAYS `wait()` the child so it is reaped.  Returns True
        when the worker exited within the grace window."""
        proc = self.procs.get(i)
        if proc is None:
            return True
        drained = True
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=max(0.0, float(grace_s)))
            except subprocess.TimeoutExpired:
                drained = False
                kill_process_tree(proc)
        proc.wait()
        return drained

    def kill(self, i: int) -> None:
        """SIGKILL worker `i`'s whole process group and reap it — the
        chaos 'worker process died' fault, and the teardown path for a
        wedged (SIGSTOP'd) worker that cannot answer a SIGTERM."""
        proc = self.procs.get(i)
        if proc is None:
            return
        kill_process_tree(proc)
        proc.wait()

    def stop_all(self, grace_s: float = 5.0) -> bool:
        drained = True
        for i in list(self.procs):
            drained &= self.stop(i, grace_s=grace_s)
        return drained

    def wait_ready(self, i: int, timeout_s: float = 60.0,
                   poll_interval_s: float = 0.5) -> bool:
        """Poll worker `i`'s `/readyz` until it answers 200 or
        `timeout_s` elapses.  A ``cli serve`` worker takes seconds to
        bind and warm its buckets; until then the port connection-refuses
        and readiness is False."""
        import http.client
        import urllib.request

        deadline = time.monotonic() + float(timeout_s)
        url = self.url(i) + "/readyz"
        while True:
            try:
                with urllib.request.urlopen(url, timeout=2.0) as resp:
                    if resp.status == 200:
                        return True
            except (http.client.HTTPException, OSError):
                pass           # not bound yet / not ready yet: keep polling
            if time.monotonic() >= deadline:
                return False
            time.sleep(float(poll_interval_s))

    def attach_all(self, router, ready_timeout_s: float = 60.0) -> list:
        """Spawn every worker, wait for each `/readyz` to go green, then
        attach it to a `FleetRouter` by URL.  A fresh `Replica` is
        routable the moment it is attached (ACTIVE state, closed
        breaker), so attaching before the worker has bound its port and
        warmed its buckets would route live traffic into
        connection-refused — the workers are spawned up front (they warm
        concurrently) but each joins rotation only once ready.  A worker
        that never goes green within `ready_timeout_s` raises
        `TimeoutError` (the spawned processes are left for the caller to
        reap — `procs` in the raised message)."""
        from deeplearning4j_tpu_torch.serving.fleet import Replica

        procs = [self.spawn(i) for i in range(int(self.n_replicas))]
        out = []
        for i, proc in enumerate(procs):
            if not self.wait_ready(i, timeout_s=ready_timeout_s):
                # the timeout report must say WHY the worker never went
                # green — its own captured output, not a bare timeout
                raise TimeoutError(
                    f"worker-{i} at {self.url(i)} not ready after "
                    f"{ready_timeout_s}s; {len(procs)} spawned worker "
                    f"processes left running for the caller to reap "
                    f"(launcher.stop_all()).\nworker-{i} last log "
                    f"lines:\n{self.tail_log(i)}")
            # "worker-{i}", not "replica-{i}": the router's own factory
            # names replicas "replica-{seq}", and failover exclusion /
            # pick tie-breaks key on the NAME — a collision would make
            # one replica's failure exclude an unrelated healthy one
            out.append(router.attach(
                Replica(f"worker-{i}", self.url(i), process=proc)))
        return out


@dataclass
class TpuPodProvisioner:
    """gcloud command generation for a TPU pod slice (EC2-provisioner
    parity — declarative box creation + per-host command fan-out)."""

    name: str
    zone: str
    accelerator_type: str = "v5litepod-8"
    runtime_version: str = "v2-alpha-tpuv5-lite"
    project: Optional[str] = None
    labels: Dict[str, str] = field(default_factory=dict)

    def _flag(self, name: str, value: str) -> List[str]:
        return [f"--{name}={value}"]

    def create_command(self, spot: bool = False) -> List[str]:
        cmd = ["gcloud", "compute", "tpus", "tpu-vm", "create", self.name,
               *self._flag("zone", self.zone),
               *self._flag("accelerator-type", self.accelerator_type),
               *self._flag("version", self.runtime_version)]
        if self.project:
            cmd += self._flag("project", self.project)
        if spot:
            cmd.append("--spot")
        if self.labels:
            cmd += self._flag("labels", ",".join(
                f"{k}={v}" for k, v in sorted(self.labels.items())))
        return cmd

    def run_command(self, shell_command: str,
                    worker: str = "all") -> List[str]:
        """SSH fan-out to pod workers (HostProvisioner.runRemoteCommand)."""
        cmd = ["gcloud", "compute", "tpus", "tpu-vm", "ssh", self.name,
               *self._flag("zone", self.zone),
               *self._flag("worker", worker),
               *self._flag("command", shell_command)]
        if self.project:
            cmd += self._flag("project", self.project)
        return cmd

    def scp_command(self, local: str, remote: str,
                    worker: str = "all") -> List[str]:
        cmd = ["gcloud", "compute", "tpus", "tpu-vm", "scp", local,
               f"{self.name}:{remote}",
               *self._flag("zone", self.zone),
               *self._flag("worker", worker)]
        if self.project:
            cmd += self._flag("project", self.project)
        return cmd

    def delete_command(self) -> List[str]:
        cmd = ["gcloud", "compute", "tpus", "tpu-vm", "delete", self.name,
               *self._flag("zone", self.zone), "--quiet"]
        if self.project:
            cmd += self._flag("project", self.project)
        return cmd


__all__ = ["ClusterConfigRegistry", "FleetProcessLauncher",
           "TpuPodProvisioner", "WorkerSpawnError", "initialize_multihost",
           "kill_process_tree", "replica_serve_command", "rotate_log",
           "spawn_logged", "tail_lines"]
