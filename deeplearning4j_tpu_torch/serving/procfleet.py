"""Process-per-replica fleet supervision (counterpart of
`deeplearning4j_tpu.serving.procfleet`).

The fleet router (serving/fleet.py) ejects a dead replica and fails
traffic over, but nothing restarts it — a ``kill -9`` on a real
``cli serve`` worker would leave a corpse forever.  `FleetSupervisor` is
the layer that owns worker PROCESSES end-to-end:

- **Crash detection** — every poll tick checks `Popen` exit status AND
  the worker's `/readyz` together, classifying deaths into a closed
  vocabulary:

  * ``clean``  — exit 0 or SIGTERM (a requested stop / graceful drain);
  * ``crash``  — any other exit (kill -9, a boot flake's nonzero exit,
    a segfault) or a worker that never went ready within
    `ready_timeout_s` (killed, with its log tail in the report);
  * ``wedged`` — the process is ALIVE but `/readyz` has failed
    `wedge_threshold` consecutive probes (SIGSTOP, a deadlocked
    worker): the supervisor hard-kills it and treats it as a death,
    because a wedged port is worse than a dead one — connections hang
    instead of failing fast.

- **Backoff restart** — a crashed worker respawns after an exponential,
  jittered delay (`RestartPolicy.backoff_s`, drawn from `random` as the
  JAX package draws it, so one seed gives both packages one schedule);
  the resurrected worker re-enters rotation through warm-then-attach:
  it is attached to the router only once its `/readyz` goes green, so
  in-flight traffic NEVER routes to a cold port.  Each incarnation's
  replica is named ``{worker}#{k}`` — failover exclusion keys on the
  name, so a request that excluded the corpse never skips the
  resurrection.

- **Crash-loop quarantine** — `crash_loop_threshold` deaths inside
  `crash_loop_window_s` quarantines the worker behind a typed
  `CrashLoopError` surfaced in `/fleet/stats` (`supervision` section)
  and the `fleet_process_quarantines_total` counter; the poll loop
  skips it (no restart storm, no stalled health sweeps) until
  `release()`.

- **Cross-host attach** — a `WorkerSpec` with no ``command`` is a
  worker this supervisor did NOT spawn (another host's, another
  orchestrator's): liveness is probes only, restart authority is
  delegated to the pluggable `RestartPolicy.restart()` hook, and a
  worker that comes back (same URL) is re-attached through the same
  warm-then-attach gate.

Per-worker stdout/stderr are captured to size-rotated log files
(`runtime.launcher.spawn_logged`); crash and ready-timeout reports
attach the last ~20 lines.  Supervision events publish through the obs
registry as ``fleet_process_*`` counters (`collector_samples`), and
`FleetRouter.fleet_stats()` inlines `stats()` whenever a supervisor is
installed.  Deterministic process chaos — kill -9 at dispatch K,
SIGSTOP wedge, boot-flake exits — lives in
`resilience.chaos.ProcessChaosConfig` / `chaos_procfleet`.
"""

from __future__ import annotations

import collections
import http.client
import pathlib
import random
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.serving.resilience import ServingError


class CrashLoopError(ServingError):
    """A worker died `crash_loop_threshold` times inside
    `crash_loop_window_s` and was quarantined: restarting it again
    would just burn the backoff schedule on a deterministic failure
    (bad binary, bad port, bad model dir).  Surfaced — not raised into
    the poll loop — via `FleetSupervisor.stats()` / `/fleet/stats` so
    the health plane keeps running while a human (or `release()`)
    decides."""


# Death classifications (the closed vocabulary stats and tests use):
DEATH_CLEAN = "clean"
DEATH_CRASH = "crash"
DEATH_WEDGED = "wedged"

# Worker lifecycle states:
WORKER_STARTING = "starting"        # spawned/probing, not yet in rotation
WORKER_READY = "ready"              # attached, serving
WORKER_BACKOFF = "backoff"          # died; waiting out the restart delay
WORKER_QUARANTINED = "quarantined"  # crash-looped; needs release()
WORKER_STOPPED = "stopped"          # clean stop requested and done
WORKER_DOWN = "down"                # URL-attached worker unreachable


_STUB_WORKER = pathlib.Path(__file__).with_name("_stub_worker.py")


def stub_worker_command(port: int, host: str = "127.0.0.1", *,
                        ready_delay_s: float = 0.0,
                        never_ready: bool = False,
                        boot_exit_code: Optional[int] = None) -> List[str]:
    """Command line for one stdlib stub worker (`_stub_worker.py`) —
    run BY FILE PATH so the child skips the package's torch import and
    boots in ~100ms.  The supervision test body."""
    cmd = [sys.executable, str(_STUB_WORKER), "--port", str(int(port)),
           "--host", host]
    if ready_delay_s:
        cmd += ["--ready-delay-s", str(float(ready_delay_s))]
    if never_ready:
        cmd.append("--never-ready")
    if boot_exit_code is not None:
        cmd += ["--boot-exit-code", str(int(boot_exit_code))]
    return cmd


class RestartPolicy:
    """Restart scheduling + crash-loop bookkeeping, pluggable per
    supervisor.

    - `backoff_s(k)`: the delay before respawn number `k` (0-based
      count of consecutive crashes) — exponential
      ``initial * factor**k`` capped at `backoff_max_s`, +/- `jitter`
      fraction uniform (same shape as `resilience.retry.RetryPolicy`,
      so a fleet of workers killed together does not thundering-herd
      the same restart instant).
    - `quarantine_due(death_times, now)`: True when
      `crash_loop_threshold` deaths landed inside
      `crash_loop_window_s`.
    - `restart(worker)`: the delegation hook for workers the
      supervisor did NOT spawn (cross-host URL attach) — the base
      policy has no authority there and returns False (probes only);
      subclass it to call a remote orchestrator.  Returning True counts
      a `restart_delegations` event; either way the supervisor keeps
      probing and re-attaches when the endpoint comes back.
    - `respawn_command(worker, command)`: rewrite the command a
      respawn runs — the ELASTIC restart seam: an elastic training
      worker that crashed on N replicas can resurrect on a shrunken
      host by having its `-replicas N` rewritten (see
      `rewrite_replicas` / `ElasticRestartPolicy`).  The base policy
      returns the command unchanged.
    """

    def __init__(self, backoff_initial_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 backoff_factor: float = 2.0, jitter: float = 0.25,
                 crash_loop_threshold: int = 3,
                 crash_loop_window_s: float = 60.0,
                 rng: Optional[random.Random] = None):
        if crash_loop_threshold < 1:
            raise ValueError(f"crash_loop_threshold must be >= 1, got "
                             f"{crash_loop_threshold}")
        self.backoff_initial_s = float(backoff_initial_s)
        self.backoff_max_s = float(backoff_max_s)
        self.backoff_factor = float(backoff_factor)
        self.jitter = float(jitter)
        self.crash_loop_threshold = int(crash_loop_threshold)
        self.crash_loop_window_s = float(crash_loop_window_s)
        self._rng = rng if rng is not None else random.Random()

    def backoff_s(self, consecutive_crashes: int) -> float:
        delay = min(self.backoff_initial_s
                    * self.backoff_factor ** max(0, consecutive_crashes),
                    self.backoff_max_s)
        if self.jitter:
            delay += delay * self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, delay)

    def quarantine_due(self, death_times, now: float) -> bool:
        recent = [t for t in death_times
                  if now - t <= self.crash_loop_window_s]
        return len(recent) >= self.crash_loop_threshold

    def restart(self, worker: "SupervisedWorker") -> bool:
        return False

    def respawn_command(self, worker: "SupervisedWorker",
                        command: List[str]) -> List[str]:
        """The command a (re)spawn of `worker` runs; called by the
        supervisor's `_spawn_command` on EVERY spawn (inspect
        ``worker.incarnation``/``consecutive_crashes`` to act only on
        respawns).  Base policy: unchanged."""
        return command


def rewrite_replicas(command: List[str], n: int) -> List[str]:
    """Rewrite the `-replicas`/`--replicas` value in a worker command
    line to `n` (appending the flag when absent) — the elastic-restart
    rewrite a `RestartPolicy.respawn_command` applies so a training
    worker saved on N replicas resurrects on an M-replica host.  The
    checkpoint plane makes the count change safe: snapshots restore
    onto any replica count (`runtime.checkpoint` N→M)."""
    out = list(command)
    for i, arg in enumerate(out):
        if arg in ("-replicas", "--replicas") and i + 1 < len(out):
            out[i + 1] = str(int(n))
            return out
        if arg.startswith(("-replicas=", "--replicas=")):
            out[i] = f"{arg.split('=', 1)[0]}={int(n)}"
            return out
    return out + ["--replicas", str(int(n))]


class ElasticRestartPolicy(RestartPolicy):
    """RestartPolicy whose respawns pass a NEW replica count: the first
    respawn (and every one after) runs the worker command with
    `-replicas` rewritten to `replicas_after_crash` — the
    shrunken-host resurrection.  Everything else (backoff, quarantine)
    is inherited."""

    def __init__(self, replicas_after_crash: int, **kwargs):
        super().__init__(**kwargs)
        if replicas_after_crash < 1:
            raise ValueError(f"replicas_after_crash must be >= 1, got "
                             f"{replicas_after_crash}")
        self.replicas_after_crash = int(replicas_after_crash)

    def respawn_command(self, worker: "SupervisedWorker",
                        command: List[str]) -> List[str]:
        if worker.incarnation == 0:      # first spawn: as configured
            return command
        return rewrite_replicas(command, self.replicas_after_crash)


@dataclass
class WorkerSpec:
    """One supervised worker: a URL plus (for workers this supervisor
    spawns) the command to run and where its log goes.  ``command is
    None`` means cross-host attach: probes only, restart delegated to
    the policy."""

    name: str
    url: str
    command: Optional[List[str]] = None
    log_path: Optional[str] = None
    # disaggregated role: routing policy the supervisor
    # stamps onto every incarnation's Replica — a resurrected prefill
    # worker comes back AS a prefill worker
    role: str = "both"

    def host_port(self):
        parsed = urllib.parse.urlparse(self.url)
        return parsed.hostname or "127.0.0.1", parsed.port


@dataclass
class SupervisedWorker:
    """Runtime state for one supervised worker (internal mutable record;
    read it via `FleetSupervisor.stats()`)."""

    spec: WorkerSpec
    proc: Optional[object] = None          # subprocess.Popen
    replica: Optional[object] = None       # serving.fleet.Replica
    state: str = WORKER_STARTING
    incarnation: int = 0                   # spawns so far
    attaches: int = 0                      # rotations joined so far
    consecutive_crashes: int = 0           # resets on a healthy attach
    probe_failures: int = 0                # consecutive, while attached
    stop_requested: bool = False
    started_at: float = 0.0
    backoff_until: float = 0.0
    died_at: Optional[float] = None        # pending-restart latency clock
    last_restart_latency_s: Optional[float] = None
    error: Optional[str] = None            # CrashLoopError repr
    death_times: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=32))
    deaths: List[Dict] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.spec.name


class FleetSupervisor:
    """Own spawned ``cli serve`` worker processes end-to-end: detect
    deaths (exit status + `/readyz` together), classify them, restart
    with backoff, quarantine crash-loops, and re-admit resurrected
    workers through warm-then-attach.  See the module docstring for the
    full lifecycle.

    The supervisor runs its own poll loop (`start()`/`stop()`, or
    explicit `poll_once()` for deterministic tests); it installs itself
    as ``router.supervisor`` so `/fleet/stats` carries the supervision
    section.  `clock` is injectable for tests."""

    def __init__(self, router, *, policy: Optional[RestartPolicy] = None,
                 poll_interval_s: float = 0.5,
                 ready_timeout_s: float = 60.0,
                 wedge_threshold: int = 3,
                 probe_timeout_s: float = 2.0,
                 detach_grace_s: float = 0.5,
                 log_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.router = router
        router.supervisor = self
        self.policy = policy if policy is not None else RestartPolicy()
        self.poll_interval_s = float(poll_interval_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.wedge_threshold = int(wedge_threshold)
        self.probe_timeout_s = float(probe_timeout_s)
        self.detach_grace_s = float(detach_grace_s)
        self._log_dir = log_dir
        self._clock = clock
        self._lock = threading.RLock()
        self.workers: Dict[str, SupervisedWorker] = {}
        self.counters: Dict[str, int] = {
            "spawns": 0, "restarts": 0, "spawn_retries": 0,
            "quarantines": 0, "restart_delegations": 0,
            "deaths_clean": 0, "deaths_crash": 0, "deaths_wedged": 0,
        }
        self.restart_events: List[Dict] = []
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is not None:
            registry.register_collector(self.collector_samples)

    # ---- membership -------------------------------------------------------

    def log_dir(self) -> str:
        if self._log_dir is None:
            self._log_dir = tempfile.mkdtemp(prefix="dl4j-procfleet-")
        return self._log_dir

    def manage(self, spec: WorkerSpec) -> SupervisedWorker:
        """Take ownership of one worker.  Specs WITH a command are
        spawned immediately (state `starting`, attached once `/readyz`
        goes green); URL-only specs are probed until green, then
        attached."""
        with self._lock:
            if spec.name in self.workers:
                raise ValueError(f"worker {spec.name!r} already managed")
            if spec.command is not None and spec.log_path is None:
                spec.log_path = str(pathlib.Path(self.log_dir())
                                    / f"{spec.name}.log")
            worker = SupervisedWorker(spec=spec,
                                      started_at=self._clock())
            self.workers[spec.name] = worker
        if spec.command is not None:
            self._spawn(worker)
        return worker

    def manage_launcher(self, launcher) -> List[SupervisedWorker]:
        """Supervise every worker of a
        `runtime.launcher.FleetProcessLauncher` (same `worker-{i}`
        names `attach_all` uses; the launcher's `log_dir` is adopted
        when set, the supervisor's own otherwise)."""
        out = []
        for i in range(int(launcher.n_replicas)):
            log_path = launcher.log_path(i)
            out.append(self.manage(WorkerSpec(
                name=f"worker-{i}", url=launcher.url(i),
                command=launcher.command(i),
                log_path=str(log_path) if log_path is not None else None,
                role=(launcher.role(i) if hasattr(launcher, "role")
                      else "both"))))
        return out

    def release(self, name: str) -> SupervisedWorker:
        """Lift a quarantine: clear the crash-loop record and schedule
        an immediate respawn (or, for a URL worker, resume probing)."""
        with self._lock:
            worker = self.workers[name]
            if worker.state != WORKER_QUARANTINED:
                raise ValueError(f"worker {name!r} is {worker.state}, "
                                 f"not quarantined")
            worker.error = None
            worker.death_times.clear()
            worker.consecutive_crashes = 0
            if worker.spec.command is not None:
                worker.state = WORKER_BACKOFF
                worker.backoff_until = self._clock()
            else:
                worker.state = WORKER_DOWN
        return worker

    # ---- spawning ---------------------------------------------------------

    def _spawn_command(self, worker: SupervisedWorker) -> List[str]:
        """The command one spawn runs — a seam `chaos_procfleet` wraps
        to inject boot flakes, and the policy's `respawn_command` hook
        rewrites (e.g. a new `-replicas` count for an elastic
        resurrection on a shrunken host)."""
        return self.policy.respawn_command(worker,
                                           list(worker.spec.command))

    def _count_spawn_retry(self) -> None:
        with self._lock:
            self.counters["spawn_retries"] += 1

    def _spawn(self, worker: SupervisedWorker) -> None:
        from deeplearning4j_tpu_torch.runtime.launcher import (
            WorkerSpawnError,
            spawn_logged,
        )

        host, port = worker.spec.host_port()
        command = self._spawn_command(worker)
        now = self._clock()
        try:
            proc = spawn_logged(command, worker.spec.log_path,
                                host=host, port=port,
                                on_bind_retry=self._count_spawn_retry)
        except (WorkerSpawnError, OSError) as e:
            # an unspawnable worker is a death at incarnation start —
            # same backoff/quarantine path as a boot crash
            self._record_death(worker, DEATH_CRASH,
                               f"spawn failed: {e}", now=now)
            return
        with self._lock:
            worker.proc = proc
            worker.incarnation += 1
            worker.stop_requested = False
            worker.probe_failures = 0
            worker.started_at = now
            worker.state = WORKER_STARTING
            self.counters["spawns"] += 1
            if worker.incarnation > 1:
                self.counters["restarts"] += 1

    # ---- probing / attach -------------------------------------------------

    def _probe(self, url: str) -> bool:
        try:
            with urllib.request.urlopen(url + "/readyz",
                                        timeout=self.probe_timeout_s) as r:
                return r.status == 200
        except (http.client.HTTPException, OSError, ValueError):
            return False

    def _attach(self, worker: SupervisedWorker, now: float) -> None:
        """Warm-then-attach: called only after `/readyz` went green (a
        ``cli serve`` worker warms its buckets BEFORE binding readiness),
        so a resurrected worker joins rotation warm and in-flight
        traffic never lands on a cold port."""
        from deeplearning4j_tpu_torch.serving.fleet import Replica

        with self._lock:
            # incarnation-suffixed replica names: failover exclusion and
            # pick tie-breaks key on the NAME, so the resurrection must
            # not inherit the corpse's exclusion entry
            name = (worker.name if worker.attaches == 0
                    else f"{worker.name}#{worker.attaches}")
            replica = Replica(name, worker.spec.url, process=worker.proc,
                              role=worker.spec.role)
            worker.replica = replica
            worker.state = WORKER_READY
            worker.probe_failures = 0
            worker.consecutive_crashes = 0
            worker.attaches += 1
            if worker.died_at is not None:
                latency = now - worker.died_at
                worker.last_restart_latency_s = latency
                worker.died_at = None
                self.restart_events.append({
                    "worker": worker.name, "replica": name,
                    "incarnation": worker.incarnation,
                    "latency_s": round(latency, 3), "at": time.time()})
        self.router.attach(replica)

    def _detach(self, worker: SupervisedWorker) -> None:
        with self._lock:
            replica = worker.replica
            worker.replica = None
        if replica is not None:
            # remove() folds what counts it can still fetch and reports
            # the rest as retired.lost — a corpse cannot answer
            self.router.remove(replica, grace_s=self.detach_grace_s)

    # ---- death handling ---------------------------------------------------

    def _kill_proc(self, worker: SupervisedWorker) -> None:
        from deeplearning4j_tpu_torch.runtime.launcher import kill_process_tree

        proc = worker.proc
        if proc is not None and proc.poll() is None:
            kill_process_tree(proc)
            proc.wait()

    def _log_tail(self, worker: SupervisedWorker, lines: int = 20) -> str:
        from deeplearning4j_tpu_torch.runtime.launcher import tail_lines

        if worker.spec.log_path is None:
            return "<no log captured>"
        return tail_lines(worker.spec.log_path, lines)

    def _classify_exit(self, worker: SupervisedWorker,
                       rc: int) -> (str, str):
        import signal as _signal

        if rc == 0 or rc == -int(_signal.SIGTERM):
            kind = DEATH_CLEAN
            how = ("exit 0" if rc == 0 else "SIGTERM")
        else:
            kind = DEATH_CRASH
            how = (f"signal {-rc}" if rc < 0 else f"exit {rc}")
        if not worker.stop_requested and kind == DEATH_CLEAN:
            how += " (unrequested)"
        return kind, how

    def _record_death(self, worker: SupervisedWorker, kind: str,
                      detail: str, now: float,
                      exit_code: Optional[int] = None) -> None:
        """One death: classify, count, detach the corpse's replica, and
        decide what happens next — stopped (requested), quarantined
        (crash loop), backoff (local respawn) or down (delegated)."""
        self._detach(worker)
        with self._lock:
            if worker.state == WORKER_STOPPED:
                # terminal: a racing second reporter (stop_worker vs a
                # poll tick that classified the SIGTERM exit first) must
                # not record the same death twice
                return
            worker.proc = None
            worker.deaths.append({
                "kind": kind, "detail": detail, "exit": exit_code,
                "incarnation": worker.incarnation, "at": time.time()})
            del worker.deaths[:-8]          # bounded history
            self.counters[f"deaths_{kind}"] += 1
            if worker.stop_requested or kind == DEATH_CLEAN:
                worker.state = WORKER_STOPPED
                return
            if worker.died_at is None:
                worker.died_at = now        # restart-latency clock
            worker.death_times.append(now)
            worker.consecutive_crashes += 1
            if self.policy.quarantine_due(worker.death_times, now):
                err = CrashLoopError(
                    f"worker {worker.name!r} crash-looped: "
                    f"{len(worker.death_times)} deaths, last "
                    f"{self.policy.crash_loop_threshold} inside "
                    f"{self.policy.crash_loop_window_s}s "
                    f"(last: {kind}: {detail.splitlines()[0][:160]}); "
                    f"quarantined — release() to retry")
                worker.error = repr(err)
                worker.state = WORKER_QUARANTINED
                self.counters["quarantines"] += 1
                return
            if worker.spec.command is not None:
                worker.state = WORKER_BACKOFF
                worker.backoff_until = now + self.policy.backoff_s(
                    worker.consecutive_crashes - 1)
                return
            worker.state = WORKER_DOWN
        # delegation hook OUTSIDE the lock: a policy may do slow I/O
        if self.policy.restart(worker):
            with self._lock:
                self.counters["restart_delegations"] += 1

    # ---- the supervision sweep --------------------------------------------

    def poll_once(self) -> Dict[str, str]:
        """One supervision sweep over every managed worker; returns
        ``{worker: state}`` after the sweep.  Deterministic tests call
        this directly with an injected clock; `start()` runs it on the
        poll loop."""
        with self._lock:
            workers = list(self.workers.values())
        for worker in workers:
            self._tick(worker)
        with self._lock:
            return {w.name: w.state for w in self.workers.values()}

    def _tick(self, worker: SupervisedWorker) -> None:
        now = self._clock()
        with self._lock:
            state = worker.state
            proc = worker.proc
        if state in (WORKER_QUARANTINED, WORKER_STOPPED):
            return
        if state == WORKER_BACKOFF:
            if now >= worker.backoff_until:
                self._spawn(worker)
            return
        # exit status first: a dead process's port may still accept for
        # a beat (TIME_WAIT handoff), and the classification should say
        # "crash: signal 9", not "unreachable"
        if proc is not None:
            rc = proc.poll()
            if rc is not None:
                proc.wait()                # reap — never leave a zombie
                kind, how = self._classify_exit(worker, rc)
                detail = how
                if kind != DEATH_CLEAN:
                    detail += ("; last log lines:\n"
                               + self._log_tail(worker))
                self._record_death(worker, kind, detail, now,
                                   exit_code=rc)
                return
        if state == WORKER_STARTING:
            if self._probe(worker.spec.url):
                self._attach(worker, self._clock())
                return
            if (proc is not None
                    and now - worker.started_at > self.ready_timeout_s):
                # never went green: kill it and report WITH the log tail
                tail = self._log_tail(worker)
                self._kill_proc(worker)
                self._record_death(
                    worker, DEATH_CRASH,
                    f"not ready within {self.ready_timeout_s}s of spawn; "
                    f"killed; last log lines:\n{tail}", now)
            return
        if state == WORKER_DOWN:
            # a delegated/externally-restarted worker coming back on the
            # same URL re-enters through the same warm-then-attach gate
            if self._probe(worker.spec.url):
                self._attach(worker, self._clock())
            return
        # WORKER_READY: liveness = the probe
        if self._probe(worker.spec.url):
            with self._lock:
                worker.probe_failures = 0
            return
        with self._lock:
            worker.probe_failures += 1
            wedged = worker.probe_failures >= self.wedge_threshold
        if not wedged:
            return
        if proc is not None:
            # alive-but-unresponsive (SIGSTOP, deadlock): hard-kill —
            # a wedged port hangs clients; a dead one fails fast and
            # the backoff path brings a working incarnation back
            tail = self._log_tail(worker)
            self._kill_proc(worker)
            self._record_death(
                worker, DEATH_WEDGED,
                f"process alive but /readyz failed "
                f"{worker.probe_failures} consecutive probes; "
                f"hard-killed; last log lines:\n{tail}", now)
        else:
            self._record_death(
                worker, DEATH_CRASH,
                f"endpoint unreachable ({worker.probe_failures} "
                f"consecutive probe failures; not spawned here — "
                f"restart delegated to the policy)", now)

    # ---- lifecycle --------------------------------------------------------

    def start(self, interval_s: Optional[float] = None) -> None:
        if interval_s is not None:
            self.poll_interval_s = float(interval_s)
        if self._thread is not None:
            return
        self._stop_event.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-supervisor")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop_event.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — supervision-loop survival backstop: a bug in one sweep must not end ALL future restarts
                pass

    def stop_loop(self) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def stop_worker(self, name: str, grace_s: float = 5.0) -> bool:
        """Clean stop: SIGTERM (the worker's graceful drain), escalate
        to a process-group SIGKILL after `grace_s`, always reap.  The
        death classifies `clean` — `stop_requested` is set BEFORE the
        signal so a racing poll tick agrees."""
        import subprocess

        with self._lock:
            worker = self.workers[name]
            worker.stop_requested = True
            proc = worker.proc
        self._detach(worker)
        drained = True
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=max(0.0, float(grace_s)))
            except subprocess.TimeoutExpired:
                drained = False
                self._kill_proc(worker)
        if proc is None:
            # nothing was running (backoff/quarantined/down/attached):
            # park the worker terminally WITHOUT fabricating a death —
            # there was no process to die (the quarantine error, if
            # any, stays visible in stats)
            with self._lock:
                worker.state = WORKER_STOPPED
            return drained
        rc = proc.wait()
        # _record_death is a no-op if a racing poll tick classified the
        # SIGTERM exit first (stop_requested was set before the signal,
        # so that classification was `clean` too)
        self._record_death(worker, DEATH_CLEAN,
                           "stop requested"
                           + ("" if drained else " (grace expired; "
                              "process group killed)"),
                           self._clock(), exit_code=rc)
        return drained

    def stop(self, grace_s: float = 5.0) -> bool:
        """Stop the loop, then every worker (clean SIGTERM -> reap)."""
        self.stop_loop()
        drained = True
        with self._lock:
            names = [n for n, w in self.workers.items()
                     if w.state not in (WORKER_STOPPED,)]
        for name in names:
            drained &= self.stop_worker(name, grace_s=grace_s)
        return drained

    def wait_all_ready(self, timeout_s: float = 60.0) -> bool:
        """Block until every non-quarantined managed worker is READY
        (attached) or `timeout_s` elapses.  Drives `poll_once` itself
        when the background loop is not running."""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            with self._lock:
                pending = [w for w in self.workers.values()
                           if w.state not in (WORKER_READY,
                                              WORKER_QUARANTINED,
                                              WORKER_STOPPED)]
            if not pending:
                return True
            if time.monotonic() >= deadline:
                return False
            if self._thread is None:
                self.poll_once()
            time.sleep(0.05)

    # ---- observation ------------------------------------------------------

    def stats(self) -> Dict:
        """The `/fleet/stats` supervision section: per-worker state +
        death history, the event counters, recent restart latencies,
        and the quarantine list with its typed errors."""
        with self._lock:
            workers = {}
            for w in self.workers.values():
                workers[w.name] = {
                    "state": w.state, "url": w.spec.url,
                    "managed": w.spec.command is not None,
                    "pid": (w.proc.pid if w.proc is not None else None),
                    "incarnation": w.incarnation,
                    "attaches": w.attaches,
                    "consecutive_crashes": w.consecutive_crashes,
                    "probe_failures": w.probe_failures,
                    "last_restart_latency_s": w.last_restart_latency_s,
                    "error": w.error,
                    "deaths": list(w.deaths[-5:]),
                    "log_path": w.spec.log_path,
                }
            return {
                "workers": workers,
                "counters": dict(self.counters),
                "quarantined": sorted(
                    w.name for w in self.workers.values()
                    if w.state == WORKER_QUARANTINED),
                "restart_events": list(self.restart_events[-20:]),
            }

    def collector_samples(self):
        """`fleet_process_*` samples for an obs `MetricsRegistry`
        collector (`registry.register_collector(sup.collector_samples)`
        — `FleetServer` wires this for the `serve-fleet -processes`
        front)."""
        with self._lock:
            c = dict(self.counters)
            states = collections.Counter(
                w.state for w in self.workers.values())
            # restart_events is append-only in attach order, so its
            # tail IS the most recent restart fleet-wide
            last = (self.restart_events[-1]["latency_s"]
                    if self.restart_events else None)
        plain = (("fleet_process_spawns_total",
                  "worker processes spawned", c["spawns"]),
                 ("fleet_process_restarts_total",
                  "crashed/wedged workers respawned", c["restarts"]),
                 ("fleet_process_spawn_retries_total",
                  "port-bind-collision spawn retries",
                  c["spawn_retries"]),
                 ("fleet_process_quarantines_total",
                  "workers quarantined for crash-looping",
                  c["quarantines"]),
                 ("fleet_process_restart_delegations_total",
                  "restarts delegated to the policy (cross-host)",
                  c["restart_delegations"]))
        for name, help, value in plain:
            yield (name, "counter", help, {}, float(value))
        for kind in (DEATH_CLEAN, DEATH_CRASH, DEATH_WEDGED):
            yield ("fleet_process_deaths_total", "counter",
                   "worker deaths by classification",
                   {"kind": kind}, float(c[f"deaths_{kind}"]))
        for state in (WORKER_STARTING, WORKER_READY, WORKER_BACKOFF,
                      WORKER_QUARANTINED, WORKER_STOPPED, WORKER_DOWN):
            yield ("fleet_process_workers", "gauge",
                   "supervised workers by state",
                   {"state": state}, float(states.get(state, 0)))
        if last is not None:
            yield ("fleet_process_last_restart_latency_seconds", "gauge",
                   "most recent death-to-readmission latency",
                   {}, float(last))


__all__ = [
    "CrashLoopError",
    "DEATH_CLEAN",
    "DEATH_CRASH",
    "DEATH_WEDGED",
    "FleetSupervisor",
    "RestartPolicy",
    "SupervisedWorker",
    "WORKER_BACKOFF",
    "WORKER_DOWN",
    "WORKER_QUARANTINED",
    "WORKER_READY",
    "WORKER_STARTING",
    "WORKER_STOPPED",
    "WorkerSpec",
    "stub_worker_command",
]
