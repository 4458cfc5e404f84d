"""Deterministic fault injection for the resilience subsystem
(counterpart of `deeplearning4j_tpu.resilience.chaos`).

Every recovery path must be exercisable on the CPU without real network
flakes or real preemptions, so faults are injected at *configured
indices* — no randomness, same failures every run:

- training: `ChaosDataSource` (NaN batches, a fetch that raises OSError
  once, slow fetches, a simulated preemption) and `chaos_runner` (hung
  steps past the watchdog).  `ChaosDataSource` is a plain iterator, not
  a generator: raising from ``__next__`` does not kill it, so the
  supervisor's retry and resume paths keep pulling from the same source;
- checkpoints: `chaos_checkpoint` kills a save at a durability phase,
  `flip_byte` / `truncate_file` / `corrupt_checkpoint` damage a
  committed one;
- serving: `chaos_dispatch` (whole-dispatch faults, slow dispatches,
  poison rows for bisection);
- the fleet: `chaos_fleet` (a replica killed at a dispatch attempt,
  slow attempts, lying readyz probes; every keyword of the router's
  dispatch passes through) and `chaos_procfleet` (real SIGKILL / SIGSTOP
  to worker process groups at dispatch attempts, boot-flake spawns);
- the overload plane: `chaos_pool` (denied page allocations),
  `chaos_swap` (corrupt or dropped swap puts), `chaos_disk` (torn,
  flipped, vanished, ENOSPC and killed disk-tier writes);
- tenancy: `chaos_tenant`, the closed-loop noisy neighbor.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.resilience.faults import SimulatedPreemption
from deeplearning4j_tpu_torch.resilience.supervisor import _normalize


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Batch indices (0-based, in fetch order) at which to inject faults."""

    nan_steps: Sequence[int] = ()
    fetch_fail_steps: Sequence[int] = ()
    slow_fetch_steps: Sequence[int] = ()
    slow_seconds: float = 0.05
    preempt_at: Optional[int] = None
    # step-function faults (used by chaos_runner, counted in runner steps)
    hang_steps: Sequence[int] = ()
    hang_seconds: float = 0.0


class ChaosDataSource:
    """Iterator over (x, y, mask) batches with configured fault injection.

    ``batches`` is materialized up front so the source can re-yield the
    batch a failed fetch pointed at.  Each fetch failure and the
    preemption fire exactly once; position (``index``) survives both, so
    a resumed run continues from the next un-consumed batch.
    """

    def __init__(self, batches, config: ChaosConfig):
        self.batches = [_normalize(b) for b in batches]
        self.config = config
        self.index = 0
        self._failed: set = set()
        self._preempted = False

    def __iter__(self) -> "ChaosDataSource":
        return self

    def __len__(self) -> int:
        return len(self.batches)

    def __next__(self):
        i = self.index
        if i >= len(self.batches):
            raise StopIteration
        cfg = self.config
        if cfg.preempt_at == i and not self._preempted:
            self._preempted = True
            raise SimulatedPreemption(f"chaos: preemption before batch {i}")
        if i in cfg.fetch_fail_steps and i not in self._failed:
            self._failed.add(i)
            raise OSError(f"chaos: injected fetch failure at batch {i}")
        if i in cfg.slow_fetch_steps:
            time.sleep(cfg.slow_seconds)
        self.index = i + 1
        x, y, mask = self.batches[i]
        if i in cfg.nan_steps:
            x = np.full_like(np.asarray(x, dtype=np.float32), np.nan)
        return x, y, mask


class _ChaosRunner:
    """Runner proxy whose fit_batch hangs at configured step indices."""

    def __init__(self, runner, config: ChaosConfig):
        self._runner = runner
        self._config = config
        self._calls = 0

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def fit_batch(self, x, y, mask=None):
        call = self._calls
        self._calls += 1
        if call in self._config.hang_steps and self._config.hang_seconds:
            time.sleep(self._config.hang_seconds)
        return self._runner.fit_batch(x, y, mask)


def chaos_runner(runner, config: ChaosConfig):
    """Wrap a runner so its ``fit_batch`` sleeps ``config.hang_seconds``
    at each step index in ``config.hang_steps`` — drives the watchdog
    path.  All other attributes delegate to the wrapped runner."""
    return _ChaosRunner(runner, config)


# ---------------------------------------------------------------------------
# Serving-plane fault injection


class InjectedDispatchFault(RuntimeError):
    """The typed failure `chaos_dispatch` raises — tests match on it,
    and it must never be confused with a real device error."""


@dataclasses.dataclass(frozen=True)
class ServingChaosConfig:
    """Dispatch indices (0-based, in call order) at which to inject
    serving faults, plus the poison-row sentinel.

    - ``fail_dispatch_steps``: the dispatch at each index raises
      `InjectedDispatchFault` (consecutive indices drive the circuit
      breaker open; the first non-listed index is the half-open probe
      that closes it again);
    - ``slow_dispatch_steps``: the dispatch sleeps ``slow_seconds``
      first (drives queue build-up -> overload rejection and deadline
      shedding);
    - ``poison_value``: any dispatch whose batch contains a row made
      ENTIRELY of this value raises — the deterministic stand-in for a
      request whose payload crashes the device program.  Bisection must
      isolate exactly those rows' requests.
    """

    fail_dispatch_steps: Sequence[int] = ()
    slow_dispatch_steps: Sequence[int] = ()
    slow_seconds: float = 0.05
    poison_value: Optional[float] = None


class _ChaosDispatch:
    """Dispatch proxy with configured fault injection (call-counted)."""

    def __init__(self, dispatch, config: ServingChaosConfig):
        self._dispatch = dispatch
        self.config = config
        self.calls = 0

    def __call__(self, x, mask, n_real):
        i = self.calls
        self.calls += 1
        cfg = self.config
        if i in cfg.slow_dispatch_steps:
            time.sleep(cfg.slow_seconds)
        if i in cfg.fail_dispatch_steps:
            raise InjectedDispatchFault(
                f"chaos: injected dispatch fault at dispatch {i}")
        if cfg.poison_value is not None:
            rows = np.asarray(x)
            flat = rows.reshape(rows.shape[0], -1)
            poisoned = np.all(flat == cfg.poison_value, axis=1)
            if poisoned.any():
                raise InjectedDispatchFault(
                    f"chaos: poison row(s) {np.nonzero(poisoned)[0].tolist()} "
                    f"in dispatch {i}")
        return self._dispatch(x, mask, n_real)


def chaos_dispatch(dispatch, config: ServingChaosConfig):
    """Wrap a `MicroBatcher` dispatch function with deterministic fault
    injection — install with
    ``batcher._dispatch = chaos_dispatch(batcher._dispatch, cfg)`` (or on
    `ServingEngine.batcher`).  The wrapper counts calls on ``.calls`` so
    tests can assert how many device dispatches actually happened."""
    return _ChaosDispatch(dispatch, config)


# ---------------------------------------------------------------------------
# Fleet-level fault injection


@dataclasses.dataclass(frozen=True)
class FleetChaosConfig:
    """Fleet faults, keyed by deterministic counters.

    - ``kill_at_attempt``: just before dispatch attempt #N (0-based,
      router-wide) the victim replica is hard-killed.  Default victim is
      the replica that attempt targets — the most adversarial choice:
      the request in hand MUST fail over.  ``kill_replica`` names a
      specific victim instead.
    - ``slow_attempt_steps``: the dispatch attempt sleeps
      ``slow_seconds`` first (when ``slow_replica`` is set, only
      attempts routed to that replica sleep) — drives load skew, spill
      routing and autoscale.
    - ``flaky_readyz_polls``: per-replica probe indices (0-based, in
      poll order) at which the readyz probe reports not-ready even
      though the replica is fine — the flapping-readyz fault that
      drives eject -> half-open probe -> re-admit.  ``flaky_replica``
      restricts it to one replica (None = every replica flaps at those
      indices).
    """

    kill_at_attempt: Optional[int] = None
    kill_replica: Optional[str] = None
    slow_attempt_steps: Sequence[int] = ()
    slow_seconds: float = 0.05
    slow_replica: Optional[str] = None
    flaky_readyz_polls: Sequence[int] = ()
    flaky_replica: Optional[str] = None


class _FleetChaos:
    """Installed over a `FleetRouter`'s `_dispatch` / `_probe_readyz`
    hooks (instance attributes shadow the methods).  Counters:
    ``attempts`` (dispatch attempts seen), ``probes`` (readyz probes per
    replica name), ``killed`` (victim names, in kill order)."""

    def __init__(self, router, config: FleetChaosConfig):
        self.router = router
        self.config = config
        self.attempts = 0
        self.probes: dict = {}
        self.killed: list = []
        self._lock = threading.Lock()
        self._orig_dispatch = router._dispatch
        self._orig_probe = router._probe_readyz
        router._dispatch = self._dispatch
        router._probe_readyz = self._probe

    def uninstall(self) -> None:
        self.router._dispatch = self._orig_dispatch
        self.router._probe_readyz = self._orig_probe

    def _victim(self, replica):
        cfg = self.config
        if cfg.kill_replica is None:
            return replica
        for r in self.router.replicas():
            if r.name == cfg.kill_replica:
                return r
        return None

    def _dispatch(self, replica, path, body, timeout=None,
                  request_id=None, **kw):
        cfg = self.config
        with self._lock:
            i = self.attempts
            self.attempts += 1
            kill = (cfg.kill_at_attempt == i
                    and cfg.kill_replica not in self.killed)
        if kill:
            victim = self._victim(replica)
            if victim is not None:
                victim.kill()
                with self._lock:
                    self.killed.append(victim.name)
        if (i in cfg.slow_attempt_steps
                and cfg.slow_replica in (None, replica.name)):
            time.sleep(cfg.slow_seconds)
        return self._orig_dispatch(replica, path, body, timeout,
                                   request_id=request_id, **kw)

    def _probe(self, replica) -> bool:
        with self._lock:
            n = self.probes.get(replica.name, 0)
            self.probes[replica.name] = n + 1
        cfg = self.config
        if (n in cfg.flaky_readyz_polls
                and cfg.flaky_replica in (None, replica.name)):
            return False
        return self._orig_probe(replica)


def chaos_fleet(router, config: FleetChaosConfig) -> _FleetChaos:
    """Install deterministic fleet faults on a `FleetRouter` (see
    `FleetChaosConfig`).  Returns the installed wrapper — its counters
    are the test observables; call ``.uninstall()`` to restore the
    router's real hooks."""
    return _FleetChaos(router, config)


# ---------------------------------------------------------------------------
# Process-supervision fault injection


@dataclasses.dataclass(frozen=True)
class ProcessChaosConfig:
    """Real-process faults for the `FleetSupervisor`
    (serving/procfleet.py), keyed by deterministic counters.  Unlike
    `FleetChaosConfig` (which stops a thread-hosted replica's server),
    these act on actual worker PROCESSES with actual signals — the
    supervisor must observe a genuine SIGKILL'd exit status and a
    genuine SIGSTOP'd wedge.

    - ``kill_at_dispatch``: just before router dispatch attempt #N
      (0-based) the victim worker's process group gets SIGKILL — the
      mid-storm hard kill.  Fires once.  Default victim is the worker
      serving that attempt (the request in hand MUST fail over);
      ``kill_worker`` names a specific victim.
    - ``sigstop_at_dispatch``: same, with SIGSTOP — the process stays
      ALIVE but stops answering, driving the wedged-but-alive
      classification and the supervisor's hard-kill escalation.
    - ``flake_boot_spawns``: supervisor-wide spawn indices (0-based, in
      spawn order) whose command is replaced by one that exits
      ``flake_exit_code`` immediately — the boot flake that drives
      backoff restarts into crash-loop quarantine.
    """

    kill_at_dispatch: Optional[int] = None
    kill_worker: Optional[str] = None
    sigstop_at_dispatch: Optional[int] = None
    sigstop_worker: Optional[str] = None
    flake_boot_spawns: Sequence[int] = ()
    flake_exit_code: int = 3


class _ProcessChaos:
    """Installed over a `FleetSupervisor`'s `_spawn_command` hook and
    its router's `_dispatch` (instance attributes shadow the methods).
    Counters: ``attempts`` (dispatch attempts), ``spawns`` (spawn
    commands issued), ``killed``/``stopped`` (victim worker names)."""

    def __init__(self, supervisor, config: ProcessChaosConfig):
        self.supervisor = supervisor
        self.config = config
        self.attempts = 0
        self.spawns = 0
        self.killed: list = []
        self.stopped: list = []
        self._lock = threading.Lock()
        self._orig_dispatch = supervisor.router._dispatch
        self._orig_spawn_command = supervisor._spawn_command
        supervisor.router._dispatch = self._dispatch
        supervisor._spawn_command = self._spawn_command

    def uninstall(self) -> None:
        self.supervisor.router._dispatch = self._orig_dispatch
        self.supervisor._spawn_command = self._orig_spawn_command

    def _victim(self, replica, name: Optional[str]):
        sup = self.supervisor
        if name is not None:
            return sup.workers.get(name)
        for worker in sup.workers.values():
            if worker.replica is replica:
                return worker
        return None

    def _signal_worker(self, worker, sig) -> bool:
        from deeplearning4j_tpu_torch.runtime.launcher import kill_process_tree

        proc = worker.proc if worker is not None else None
        if proc is None or proc.poll() is not None:
            return False
        kill_process_tree(proc, sig)
        return True

    def _dispatch(self, replica, path, body, timeout=None,
                  request_id=None, **kw):
        import signal as _signal

        cfg = self.config
        with self._lock:
            i = self.attempts
            self.attempts += 1
            kill = cfg.kill_at_dispatch == i and not self.killed
            wedge = cfg.sigstop_at_dispatch == i and not self.stopped
        if kill:
            victim = self._victim(replica, cfg.kill_worker)
            if self._signal_worker(victim, _signal.SIGKILL):
                with self._lock:
                    self.killed.append(victim.name)
        if wedge:
            victim = self._victim(replica, cfg.sigstop_worker)
            if self._signal_worker(victim, _signal.SIGSTOP):
                with self._lock:
                    self.stopped.append(victim.name)
        return self._orig_dispatch(replica, path, body, timeout,
                                   request_id=request_id, **kw)

    def _spawn_command(self, worker):
        import sys

        with self._lock:
            i = self.spawns
            self.spawns += 1
        if i in self.config.flake_boot_spawns:
            return [sys.executable, "-c",
                    f"import sys; print('chaos: boot flake (spawn "
                    f"{i})', flush=True); "
                    f"sys.exit({int(self.config.flake_exit_code)})"]
        return self._orig_spawn_command(worker)


def chaos_procfleet(supervisor,
                    config: ProcessChaosConfig) -> _ProcessChaos:
    """Install deterministic process faults on a `FleetSupervisor` (see
    `ProcessChaosConfig`): SIGKILL/SIGSTOP real worker processes at
    configured dispatch attempts, boot-flake configured spawns.
    Returns the installed wrapper; ``.uninstall()`` restores the real
    hooks."""
    return _ProcessChaos(supervisor, config)


# ---------------------------------------------------------------------------
# Overload-survival fault injection


@dataclasses.dataclass(frozen=True)
class SwapChaosConfig:
    """Host swap-store faults, keyed by put order (0-based).

    - ``corrupt_puts``: the blob stored at each listed put index has
      ONE byte flipped mid-payload BEFORE it enters the store — the
      deterministic stand-in for host-memory bit rot in a swapped-out
      lane.  The wire frame's SHA-256 check must catch it at restore
      and the pool must recompute that lane from its prompt (typed
      `PageShipError` in the ledger/trace, byte-identical output,
      never a wrong token).
    - ``drop_puts``: the put at each listed index is silently NOT
      stored — the deterministic stand-in for byte-cap eviction.  The
      restore path must surface `SwapEvictedError` internally and
      recompute, same contract.
    """

    corrupt_puts: Sequence[int] = ()
    drop_puts: Sequence[int] = ()


class _SwapChaos:
    """Installed over a `SwapStore`'s `put` (instance attribute shadows
    the method).  Counter: ``puts`` (calls seen)."""

    def __init__(self, store, config: SwapChaosConfig):
        self.store = store
        self.config = config
        self.puts = 0
        self._orig_put = store.put
        store.put = self._put

    def uninstall(self) -> None:
        self.store.put = self._orig_put

    def _put(self, key: str, blob: bytes):
        i = self.puts
        self.puts += 1
        if i in self.config.drop_puts:
            # pretend the cap evicted it instantly: stored nowhere, so
            # take() raises the typed SwapEvictedError at restore
            return []
        if i in self.config.corrupt_puts:
            # flip the LAST byte — always inside the raw page payload,
            # so the frame parses fine and the SHA-256 integrity check
            # is what catches it (the exact fault class the hash is for)
            pos = len(blob) - 1
            blob = blob[:pos] + bytes([blob[pos] ^ 0xFF])
        return self._orig_put(key, blob)


def chaos_swap(store, config: SwapChaosConfig) -> _SwapChaos:
    """Install deterministic swap-store faults on a
    `serving.pressure.SwapStore` (see `SwapChaosConfig`); returns the
    wrapper — ``.uninstall()`` restores the real `put`."""
    return _SwapChaos(store, config)


@dataclasses.dataclass(frozen=True)
class DiskChaosConfig:
    """Disk-tier blob faults, keyed by BLOB write order
    (0-based; manifest writes are not counted — they ride the same
    atomic writer but faulting them is the unreadable-manifest case
    `DiskTier.open` already owns).  Every fault lands on the victim
    session alone: its resume must surface a typed
    `PageShipError`/`SwapEvictedError` internally and recompute from
    the prompt, byte-identical, ledger balanced.

    - ``truncate_writes``: the blob file is cut to ``truncate_keep``
      bytes (default: half) AFTER staging — the torn/short write the
      manifest's size+SHA-256 must catch at take.
    - ``flip_writes``: one mid-payload byte is flipped on its way to
      disk — at-rest bit rot, caught by the SHA-256 check.
    - ``unlink_writes``: the blob vanishes right after its durable
      write (manifest still names it) — the missing-file rung.
    - ``enospc_writes``: the write raises ENOSPC before any byte lands
      — the full-disk rung; the tier drops the entry, counted
      ``write_failed``.
    - ``kill_writes``: the staging file is written and fsynced, then
      the writer dies BEFORE the rename — kill -9 in the commit window;
      the tier sees a failed write now, and the orphaned ``.tmp-``
      debris is what a successor's `open()` garbage-collects.
    """

    truncate_writes: Sequence[int] = ()
    truncate_keep: Optional[int] = None
    flip_writes: Sequence[int] = ()
    unlink_writes: Sequence[int] = ()
    enospc_writes: Sequence[int] = ()
    kill_writes: Sequence[int] = ()


class _DiskChaos:
    """Installed over a `DiskTier`'s `_write_atomic` (instance
    attribute shadows the method; accepts a `TieredStateStore` and
    reaches its `.disk`).  Counter: ``writes`` (blob writes seen)."""

    _MANIFEST = "MANIFEST.json"

    def __init__(self, tier, config: DiskChaosConfig):
        disk = getattr(tier, "disk", None)
        self.tier = disk if disk is not None else tier
        if not hasattr(self.tier, "_write_atomic"):
            raise TypeError(
                f"chaos_disk needs a DiskTier (or a TieredStateStore "
                f"with one), got {type(tier).__name__}")
        self.config = config
        self.writes = 0
        self._orig = self.tier._write_atomic
        self.tier._write_atomic = self._write

    def uninstall(self) -> None:
        self.tier._write_atomic = self._orig

    def _write(self, final_path, data: bytes) -> None:
        name = os.path.basename(str(final_path))
        if name == self._MANIFEST:
            self._orig(final_path, data)
            return
        i = self.writes
        self.writes += 1
        c = self.config
        if i in c.enospc_writes:
            raise OSError(errno.ENOSPC,
                          "No space left on device (chaos)", str(final_path))
        if i in c.kill_writes:
            # stage exactly like the real writer, then die in the
            # commit window: debris on disk, nothing manifested
            tmp = os.path.join(os.path.dirname(str(final_path)),
                               ".tmp-" + name)
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            raise OSError(errno.EIO,
                          "killed between write and rename (chaos)",
                          str(final_path))
        if i in c.flip_writes:
            pos = len(data) // 2
            data = data[:pos] + bytes([data[pos] ^ 0xFF]) + data[pos + 1:]
        if i in c.truncate_writes:
            keep = (len(data) // 2 if c.truncate_keep is None
                    else int(c.truncate_keep))
            data = data[:keep]
        self._orig(final_path, data)
        if i in c.unlink_writes:
            os.unlink(final_path)


def chaos_disk(tier, config: DiskChaosConfig) -> _DiskChaos:
    """Install deterministic disk-tier faults on a
    `serving.hibernate.DiskTier` (or the `TieredStateStore` wrapping
    one); returns the wrapper — ``.uninstall()`` restores the real
    atomic writer."""
    return _DiskChaos(tier, config)


@dataclasses.dataclass(frozen=True)
class PoolChaosConfig:
    """Paged-pool exhaustion faults, keyed by alloc order (0-based):
    ``deny_allocs`` lists alloc calls that return None (the pool
    pretends to be dry) regardless of the free list — drives the
    FIFO head-of-line wait and the preemption path deterministically
    without corrupting the refcount ledger."""

    deny_allocs: Sequence[int] = ()


class _PoolChaos:
    """Installed over a `PagePool`'s `alloc` (instance attribute
    shadows the method).  Counter: ``allocs`` (calls seen)."""

    def __init__(self, pool, config: PoolChaosConfig):
        self.pool = pool
        self.config = config
        self.allocs = 0
        self._orig_alloc = pool.alloc
        pool.alloc = self._alloc

    def uninstall(self) -> None:
        self.pool.alloc = self._orig_alloc

    def _alloc(self, n: int):
        i = self.allocs
        self.allocs += 1
        if i in self.config.deny_allocs:
            return None
        return self._orig_alloc(n)


def chaos_pool(pool, config: PoolChaosConfig) -> _PoolChaos:
    """Install deterministic exhaustion faults on a
    `serving.paged.PagePool` (see `PoolChaosConfig`); returns the
    wrapper — ``.uninstall()`` restores the real `alloc`."""
    return _PoolChaos(pool, config)


# ---------------------------------------------------------------------------
# Tenancy fault injection


@dataclasses.dataclass(frozen=True)
class TenantChaosConfig:
    """A deterministic noisy neighbor for the tenancy plane: closed-loop
    flood threads submitting as one tenant at a multiple of its token
    quota, so WFQ isolation, the 429 path, and burn-rate-driven
    brownout victim selection are all drivable in the tests without a real
    abusive client.

    - ``tenant``: the flooding identity (must exist in the server's
      registry — the flood exercises enforcement, not the unknown-
      tenant 400);
    - ``rate_multiple``: offered token rate as a multiple of the
      tenant's quota (5.0 = five times what the bucket refills);
      for an unmetered tenant the flood just runs flat out;
    - ``prompt_tokens`` / ``max_new_tokens``: per-request shape (their
      sum is the per-request quota cost);
    - ``priority``: admission class the flood claims (default
      ``best_effort`` — the class the brownout ladder sheds first);
    - ``threads``: concurrent closed-loop submitters;
    - ``timeout_s``: per-request client wait bound.
    """

    tenant: str = "flood"
    rate_multiple: float = 5.0
    prompt_tokens: int = 4
    max_new_tokens: int = 4
    priority: str = "best_effort"
    threads: int = 2
    timeout_s: float = 5.0


class _TenantFlood:
    """Closed-loop flood threads against a `ContinuousLMServer` with a
    tenant registry installed.  Counters (the test/bench observables):
    ``submitted``, ``completed``, ``throttled`` (quota 429s),
    ``rejected`` (any other typed refusal — overload shed, deadline),
    ``tokens_out`` (generated tokens actually served to the flood)."""

    def __init__(self, server, config: TenantChaosConfig):
        # typed errors imported lazily: resilience/chaos.py must stay
        # importable without the serving plane
        from deeplearning4j_tpu_torch.serving.resilience import (
            ServingError, TenantQuotaError)

        if getattr(server, "tenants", None) is None:
            raise ValueError(
                "chaos_tenant needs a server with a tenant registry")
        self.server = server
        self.config = config
        self._quota_error = TenantQuotaError
        self._typed_error = ServingError
        spec = server.tenants.spec(config.tenant)
        cost = max(1, int(config.prompt_tokens)
                   + int(config.max_new_tokens))
        # closed-loop pacing: each thread sleeps so the flood's OFFERED
        # token rate is rate_multiple × quota — fast enough to always
        # be over budget, slow enough that the observables (throttled
        # vs completed counts) are stable across machines
        if spec.rate > 0:
            per_s = spec.rate * max(1.0, float(config.rate_multiple))
            self.interval_s = cost * max(1, config.threads) / per_s
        else:
            self.interval_s = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list = []
        self.submitted = 0
        self.completed = 0
        self.throttled = 0
        self.rejected = 0
        self.tokens_out = 0

    def _loop(self, deadline: float, seed: int) -> None:
        cfg = self.config
        prompt = [1 + (seed % 7)] * max(1, int(cfg.prompt_tokens))
        while (not self._stop.is_set()
               and time.perf_counter() < deadline):
            with self._lock:
                self.submitted += 1
            try:
                out = self.server.generate(
                    prompt, int(cfg.max_new_tokens),
                    timeout=cfg.timeout_s, priority=cfg.priority,
                    tenant=cfg.tenant)
                with self._lock:
                    self.completed += 1
                    self.tokens_out += max(0, len(out) - len(prompt))
            except self._quota_error:
                with self._lock:
                    self.throttled += 1
            except self._typed_error:
                with self._lock:
                    self.rejected += 1
            if self.interval_s:
                time.sleep(self.interval_s)

    def run(self, duration_s: float) -> "_TenantFlood":
        """Flood for ``duration_s`` wall seconds (blocking), then join
        every thread; returns self so counters chain."""
        deadline = time.perf_counter() + max(0.0, float(duration_s))
        self._threads = [
            threading.Thread(target=self._loop, args=(deadline, i),
                             daemon=True,
                             name=f"tenant-flood-{self.config.tenant}-{i}")
            for i in range(max(1, int(self.config.threads)))]
        for t in self._threads:
            t.start()
        for t in self._threads:
            t.join()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=self.config.timeout_s)

    def stats(self) -> dict:
        with self._lock:
            return {"tenant": self.config.tenant,
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "throttled": self.throttled,
                    "rejected": self.rejected,
                    "tokens_out": self.tokens_out}


def chaos_tenant(server, config: TenantChaosConfig) -> _TenantFlood:
    """Build a deterministic noisy-neighbor flood against a
    `serving.lm.ContinuousLMServer` with a tenant registry (see
    `TenantChaosConfig`).  ``chaos_tenant(server, cfg).run(1.0)``
    floods for a second and returns the wrapper; ``.stats()`` has the
    submitted/throttled/completed ledger the bench gates on."""
    return _TenantFlood(server, config)


# ---------------------------------------------------------------------------
# Checkpoint-plane fault injection


class InjectedCheckpointCrash(RuntimeError):
    """The typed failure `chaos_checkpoint` raises from inside
    `save_checkpoint`'s phase hook — the deterministic stand-in for a
    kill -9 mid-commit.  The writer does NOT clean its staging files up
    on the way out (a real SIGKILL wouldn't), so the directory is left
    exactly as a crash at that boundary would leave it: the previous
    checkpoint intact, the partial one unreferenced (orphan-swept on
    the next save)."""


@dataclasses.dataclass(frozen=True)
class CheckpointChaosConfig:
    """Where to kill a checkpoint save, keyed by the writer's
    durability phases (`runtime.checkpoint.set_phase_hook`):

    - ``crash_at_phase``: phase name (or prefix, e.g. ``"shard:"`` to
      hit the first shard-file boundary) at which the save raises
      `InjectedCheckpointCrash`.  Phases, in order: ``begin``,
      ``shard:<file>`` per shard written, ``meta``, ``manifest``,
      ``commit_marker``, ``committed`` (after the atomic rename).
    - ``crash_at_save``: which save (0-based, counted by ``begin``
      phases) the crash applies to — later saves proceed normally, so
      a test can bank a good step k-1 before killing step k.  Fires
      once.
    """

    crash_at_phase: Optional[str] = None
    crash_at_save: int = 0


class _CheckpointChaos:
    """Context manager installing the phase hook; counters: ``saves``
    (begin phases seen), ``phases`` (every phase fired, in order),
    ``crashed`` (whether the injected crash fired)."""

    def __init__(self, config: CheckpointChaosConfig):
        self.config = config
        self.saves = -1
        self.phases: list = []
        self.crashed = False
        self._prev = None

    def __enter__(self) -> "_CheckpointChaos":
        from deeplearning4j_tpu_torch.runtime import checkpoint as ckpt_lib

        self._prev = ckpt_lib.set_phase_hook(self._hook)
        return self

    def __exit__(self, *exc) -> None:
        from deeplearning4j_tpu_torch.runtime import checkpoint as ckpt_lib

        ckpt_lib.set_phase_hook(self._prev)

    def _hook(self, phase: str, path) -> None:
        if phase == "begin":
            self.saves += 1
        self.phases.append(phase)
        cfg = self.config
        if (cfg.crash_at_phase is not None and not self.crashed
                and self.saves == cfg.crash_at_save
                and phase.startswith(cfg.crash_at_phase)):
            self.crashed = True
            raise InjectedCheckpointCrash(
                f"chaos: checkpoint save {self.saves} killed at phase "
                f"{phase!r}")


def chaos_checkpoint(config: CheckpointChaosConfig) -> _CheckpointChaos:
    """Use as a context manager:

    ``with chaos_checkpoint(CheckpointChaosConfig(crash_at_phase=
    "manifest")) as chaos: ...`` — every `save_checkpoint` inside the
    block runs under the hook; the configured one dies mid-commit and
    leaves its partial staging dir on disk, exactly like a kill -9."""
    return _CheckpointChaos(config)


def flip_byte(path, offset: int = -1) -> None:
    """Flip (XOR 0xFF) ONE byte of `path` in place — deterministic bit
    rot.  Negative offsets index from the end (default: last byte,
    which for an npz sits inside the zip central directory or the last
    array's data — both must be DETECTED, never silently loaded)."""
    with open(path, "r+b") as f:
        f.seek(0, 2)
        size = f.tell()
        pos = offset if offset >= 0 else size + offset
        if not 0 <= pos < size:
            raise ValueError(f"offset {offset} outside {size}-byte file")
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def truncate_file(path, keep_bytes: Optional[int] = None) -> None:
    """Truncate `path` to `keep_bytes` (default: half its size) — the
    torn-write / full-disk shard."""
    size = int(os.path.getsize(path))
    keep = size // 2 if keep_bytes is None else int(keep_bytes)
    with open(path, "r+b") as f:
        f.truncate(keep)


def corrupt_checkpoint(ckpt_dir, mode: str = "flip",
                       tree: str = "params") -> "os.PathLike":
    """Corrupt one shard file of a committed checkpoint: ``mode="flip"``
    flips a byte mid-file, ``"truncate"`` halves it.  Returns the
    corrupted path.  The elastic loader must detect either via the
    manifest's SHA-256/size and fall back to the previous good step."""
    import pathlib

    ckpt_dir = pathlib.Path(ckpt_dir)
    shards = sorted(ckpt_dir.glob(f"{tree}.*.npz"))
    if not shards:
        raise FileNotFoundError(
            f"no {tree!r} shard files under {ckpt_dir}")
    victim = shards[0]
    if mode == "flip":
        flip_byte(victim, offset=os.path.getsize(victim) // 2)
    elif mode == "truncate":
        truncate_file(victim)
    else:
        raise ValueError(f"unknown corruption mode {mode!r} "
                         f"(flip|truncate)")
    return victim


__all__ = ["ChaosConfig", "ChaosDataSource", "CheckpointChaosConfig",
           "DiskChaosConfig", "FleetChaosConfig", "InjectedCheckpointCrash",
           "InjectedDispatchFault", "PoolChaosConfig", "ProcessChaosConfig",
           "ServingChaosConfig", "SwapChaosConfig", "TenantChaosConfig",
           "chaos_checkpoint", "chaos_disk", "chaos_dispatch", "chaos_fleet",
           "chaos_pool", "chaos_procfleet", "chaos_runner", "chaos_swap",
           "chaos_tenant", "corrupt_checkpoint", "flip_byte",
           "truncate_file"]
