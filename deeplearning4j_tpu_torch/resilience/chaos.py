"""Deterministic fault injection for the serving plane and the fleet
(the serving and fleet part of `deeplearning4j_tpu.resilience.chaos`).

- `chaos_dispatch` wraps a micro-batcher dispatch function so
  whole-dispatch faults fire at configured dispatch indices (drives the
  circuit breaker), slow dispatches fire at configured indices (drives
  overload and deadline shedding), and any request whose rows are
  entirely `poison_value` fails its dispatch (drives poison-request
  bisection);
- `chaos_fleet` wraps a `FleetRouter`'s dispatch and readyz-probe hooks
  so a replica is killed at a configured dispatch-attempt index (drives
  failover resubmission), dispatches are slowed at configured indices
  (drives load skew and autoscale), and readyz probes lie at configured
  poll indices (drives eject -> half-open probe -> re-admit).  Every
  keyword of the router's dispatch (the page-shipping legs' binary bodies
  and deadlines) passes through.

All deterministic and counter-driven.  The training-side faults (NaN
batches, fetch failures, preemption, hung steps) and the pool, swap,
tenant and process faults are not ported (ROADMAP.md, A6 and A7).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np


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


__all__ = ["FleetChaosConfig", "InjectedDispatchFault", "ServingChaosConfig",
           "chaos_dispatch", "chaos_fleet"]
