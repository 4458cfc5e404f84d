"""Serving fleet: replicated engines behind a failover router
(counterpart of `deeplearning4j_tpu.serving.fleet`, thread-hosted
replicas only).

- `Replica` — one engine endpoint in the fleet: a URL plus lifecycle
  hooks.  Thread-hosted replicas carry their in-process `UiServer`
  (`spawn_local_replica`, how the CPU tests and the ``serve-fleet`` CLI
  host them); an externally started ``cli serve`` worker attaches by URL.
  Process-per-replica launching and supervision are not ported
  (ROADMAP.md, A5 part 2).
- `FleetRouter` — dispatch + health + lifecycle:

  * least-loaded dispatch (router-side in-flight per replica) with
    rendezvous prefix-affinity hashing for LM traffic, so one prompt
    prefix keeps landing on the same replica (its prefix cache) without
    a rebalance storm when membership changes;
  * health ejection: a background loop (or explicit `poll_health_once`)
    probes each replica's `/readyz`; failures feed that replica's own
    `CircuitBreaker` — threshold failures eject it from rotation, the
    cooldown's half-open window makes the next probe the re-admission
    test;
  * failover: predict is pure, so a failed dispatch is *resubmitted* on
    a different replica with an excluded-replica set.  Replica 503/504
    answers (overload, draining, deadline) fail over WITHOUT a breaker
    penalty; connection-level failures and other 5xx count toward
    ejection.  4xx answers are the client's request and never retry;
  * rolling weight swaps: `rolling_swap()` spawns a warm standby with
    the new weights, attaches it, takes one old replica out of rotation,
    drains it, stops it — repeat per replica;
  * queue-depth-driven autoscale per replica role, bounded by
    `[min_replicas, max_replicas]`.

- **Disaggregated prefill/decode roles**: `prefill` workers chew long
  prompts chunk by chunk and ship the finished KV pages
  (`serving/transfer.py`) to the `decode` worker the router picked up
  front; `decode`/`both` workers run the token loop and take
  short-prompt traffic directly.  Sticky `session_id` rendezvous
  affinity keeps a multi-turn chat on the replica holding its pages;
  spill-over off an overloaded preferred replica is served by page
  shipping.  The failure ladder never fails a request: dead prefill
  worker -> resubmit the prompt to a peer; rejected/corrupt shipment or
  no prefill capacity -> recompute on a decode worker.
  `open_lm_stream` routes SSE token streams the same way.

- `FleetServer` — the fleet's own HTTP front (`/model/predict`,
  `/lm/generate`, `/fleet/stats`, `/serving/stats`, `/metrics`,
  `/trace/recent`, `/healthz`, `/readyz`) with the typed-failure ->
  status mapping of `ui/server.py`, plus fleet-wide graceful drain (the
  ``serve-fleet`` SIGTERM path).  Its ``/metrics`` carries the fleet
  plane, the ``fleet_*`` families and uptime; the JAX package's compile
  counter (its compile watcher) has no counterpart, as eager PyTorch
  compiles nothing.
- `check_fleet_ledger` — the cross-layer accounting invariant: every
  request the fleet answered was answered by exactly one replica, so
  `sum(replica.requests) == fleet.requests` and client-side
  `submitted == fleet.requests + fleet.rejected`.

Deterministic fleet chaos (kill-replica, slow-replica, flapping-readyz)
lives in `resilience/chaos.py` (`FleetChaosConfig` / `chaos_fleet`).
"""

from __future__ import annotations

import collections
import hashlib
import http.client
import inspect
import json
import math
import threading
import time
import urllib.error
import urllib.request
from concurrent import futures
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.obs.registry import (
    EXPOSITION_CONTENT_TYPE,
    MetricsRegistry,
)
from deeplearning4j_tpu_torch.obs.trace import (
    TraceRecorder,
    chrome_trace,
    new_request_id,
    span,
    trace,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.resilience import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
    DeadlineExceededError,
    ServingHTTPMixin,
    ServingHTTPServer,
    ServingUnavailableError,
)


class FleetClientError(ValueError):
    """A replica answered 4xx: the request payload itself is wrong, so
    retrying it on a different replica would just fail again — the
    router propagates it instead of failing over.  Maps back to the
    replica's status code at the fleet front.  A quota 429
    is exactly this shape — every replica sharing the tenant registry
    would refuse identically — and carries the replica's own
    ``retry_after_s`` so the front can relay the Retry-After header."""

    def __init__(self, msg: str, status: int = 400,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.status = int(status)
        self.retry_after_s = (None if retry_after_s is None
                              else float(retry_after_s))


class _ReplicaDispatchError(RuntimeError):
    """Internal: one dispatch attempt against one replica failed in a
    way that justifies failover.  `replica_fault` distinguishes a
    replica that is *broken* (connection refused/reset, 500 — counts
    toward breaker ejection) from one that is alive but unavailable
    (503 overload/draining, 504 deadline — fail over penalty-free)."""

    def __init__(self, msg: str, replica_fault: bool):
        super().__init__(msg)
        self.replica_fault = bool(replica_fault)


# Replica lifecycle states (the closed vocabulary /fleet/stats uses):
REPLICA_ACTIVE = "active"
REPLICA_DRAINING = "draining"
REPLICA_STOPPED = "stopped"

# Worker roles (disaggregated serving): prefill workers chew
# long prompts and ship finished KV pages; decode workers run the token
# loop (and take short-prompt traffic directly); "both" is the classic
# undifferentiated worker.  Role routing only constrains LM traffic —
# classifier dispatch stays role-agnostic.
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_BOTH = "both"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_BOTH)
# which roles may serve each side of the split
_PREFILL_ROLES = (ROLE_PREFILL,)
_DECODE_ROLES = (ROLE_DECODE, ROLE_BOTH)


class Replica:
    """One serving endpoint in the fleet.

    `server` is the in-process `UiServer` for thread-hosted replicas
    (tests, `serve-fleet` CLI); None for a purely attached URL (an
    externally managed worker).  The router assigns
    `breaker` at attach time when none is supplied, and owns the
    router-side counters (`in_flight`, `dispatches`, `failures`).
    """

    def __init__(self, name: str, url: str, server=None,
                 breaker: Optional[CircuitBreaker] = None, version: int = 0,
                 role: str = ROLE_BOTH):
        self.name = str(name)
        self.url = url.rstrip("/")
        self.server = server
        self.breaker = breaker
        self.version = int(version)
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        self.role = role
        self.lock = threading.Lock()
        self.state = REPLICA_ACTIVE
        self.in_flight = 0      # router-side queue-depth proxy
        self.dispatches = 0     # successful dispatches via the router
        self.failures = 0       # replica-fault dispatch failures
        self.ejections = 0      # breaker closed/half-open -> open
        self.readmissions = 0   # open/half-open -> closed
        self._ejected = False

    def _on_breaker(self, state: str) -> None:
        # NOTE: fired while the breaker holds ITS lock; `self.lock` is
        # only ever taken after a breaker lock (never the reverse), so
        # the ordering is acyclic.
        with self.lock:
            if state == BREAKER_OPEN:
                self.ejections += 1
                self._ejected = True
            elif state == "closed" and self._ejected:
                self.readmissions += 1
                self._ejected = False

    def routable(self) -> bool:
        """Eligible for new traffic: in rotation and not breaker-open.
        `breaker.state` lazily commits open -> half_open once the
        cooldown elapses, so an ejected replica re-enters routing
        exactly when its re-admission probe window opens."""
        if self.state != REPLICA_ACTIVE:
            return False
        return self.breaker is None or self.breaker.state != BREAKER_OPEN

    # ---- lifecycle --------------------------------------------------------

    def begin_drain(self) -> None:
        if self.server is not None:
            self.server.begin_drain()

    def drain(self, grace_s: float = 5.0) -> bool:
        """Graceful: stop admission, let in-flight work finish."""
        if self.server is not None:
            return self.server.drain(grace_s)
        return True

    def stop(self) -> None:
        self.state = REPLICA_STOPPED
        if self.server is not None:
            self.server.stop()

    def kill(self) -> None:
        """Hard stop — the chaos 'replica died' fault: the HTTP socket
        closes and the engine fails queued work typed; in-flight router
        dispatches see a connection error or a 503 and fail over either
        way.  Deliberately does NOT flip `state`: the control plane has
        not noticed the death yet — the router must discover it the
        honest way (dispatch failures and failed readyz probes feeding
        the breaker until ejection)."""
        if self.server is not None:
            self.server.stop()

    def summary(self) -> Dict:
        with self.lock:
            out = {"name": self.name, "url": self.url, "state": self.state,
                   "role": self.role,
                   "version": self.version, "in_flight": self.in_flight,
                   "dispatches": self.dispatches, "failures": self.failures,
                   "ejections": self.ejections,
                   "readmissions": self.readmissions}
        out["breaker"] = self.breaker.state if self.breaker else None
        return out


def spawn_local_replica(name: str, net=None, *, lm=None, lm_slots: int = 4,
                        host: str = "127.0.0.1", ladder=None,
                        max_batch: Optional[int] = None,
                        max_wait_ms: float = 2.0, warmup_example=None,
                        max_queue_depth: Optional[int] = None,
                        default_deadline_s: Optional[float] = None,
                        breaker_threshold: Optional[int] = 5,
                        breaker_cooldown_s: float = 1.0,
                        quantize: Optional[str] = None,
                        lm_kv: str = "paged", lm_page_size: int = 16,
                        lm_pages: Optional[int] = None,
                        lm_prefill_chunk: int = 8,
                        lm_speculate: str = "off",
                        lm_draft_len: int = 4,
                        lm_ship: bool = False,
                        lm_preempt: bool = False,
                        lm_swap_bytes: int = 64 << 20,
                        lm_brownout=None,
                        lm_tenants=None,
                        lm_hibernate_idle_s: Optional[float] = None,
                        lm_state_dir: Optional[str] = None,
                        lm_state_disk_bytes: int = 1 << 30,
                        lm_swap_quantize: bool = True,
                        role: str = ROLE_BOTH,
                        version: int = 0, device=None) -> Replica:
    """Thread-hosted replica: an in-process `UiServer` on a free port
    with its own engine surface (`/model/predict`, `/lm/generate`,
    `/serving/stats`, `/readyz`).  `warmup_example` runs every bucket
    shape BEFORE the replica is returned — a rolling swap attaches only
    warm standbys, which is what makes the flip zero-5xx.  `lm` is an
    optional `(cfg, params)` pair for the continuous LM pool, decoded on
    `device` (None = the card); `net` serves on its own device.  Every
    replica in one process launches its kernels from its own threads on
    torch's current stream, each wrapper with its own scratch."""
    from deeplearning4j_tpu_torch.ui.server import UiServer

    srv = UiServer(host=host, port=0, device=device)
    if net is not None:
        from deeplearning4j_tpu_torch.serving.bucketing import BucketLadder

        ladder = ladder if ladder is not None else BucketLadder()
        srv.serve_model(
            net, ladder=ladder,
            max_batch=(max_batch if max_batch is not None
                       else ladder.max_batch),
            max_wait_ms=max_wait_ms, warmup_example=warmup_example,
            max_queue_depth=max_queue_depth,
            default_deadline_s=default_deadline_s,
            breaker_threshold=breaker_threshold,
            breaker_cooldown_s=breaker_cooldown_s, quantize=quantize)
    if lm is not None:
        cfg, params = lm
        # a role-differentiated worker always speaks the page-shipping
        # wire plane — that is what its role MEANS; undifferentiated
        # workers opt in via lm_ship (sticky-session spill-over shipping)
        ship = bool(lm_ship) or role != ROLE_BOTH
        srv.serve_lm(cfg, params, slots=lm_slots,
                     max_queue_depth=max_queue_depth,
                     default_deadline_s=default_deadline_s,
                     breaker_threshold=breaker_threshold,
                     breaker_cooldown_s=breaker_cooldown_s,
                     kv=lm_kv, page_size=lm_page_size, pages=lm_pages,
                     prefill_chunk=lm_prefill_chunk,
                     speculate=lm_speculate, draft_len=lm_draft_len,
                     ship=ship, preempt=lm_preempt,
                     swap_bytes=lm_swap_bytes, brownout=lm_brownout,
                     tenants=lm_tenants,
                     hibernate_idle_s=lm_hibernate_idle_s,
                     state_dir=lm_state_dir,
                     state_disk_bytes=lm_state_disk_bytes,
                     swap_quantize=lm_swap_quantize, device=device)
        # run every dispatch width BEFORE the replica enters rotation —
        # the same warm-before-traffic rule as warmup_example
        if srv.state.lm_server is not None:
            srv.state.lm_server.warmup()
    srv.start()
    return Replica(name, srv.url, server=srv, version=version, role=role)


class FleetRouter:
    """Failover router over N replica endpoints.

    `factory(name) -> Replica` spawns a warm replica (see
    `spawn_local_replica`); `replicas` spawns that many up front.
    Externally launched workers attach by URL via `attach()`.  All
    dispatch is HTTP to the replica's endpoint surface, so thread-hosted
    and attached replicas fail (and fail over) identically.
    """

    def __init__(self, factory: Optional[Callable[[str], Replica]] = None,
                 replicas: int = 0, *,
                 replica_breaker_threshold: int = 2,
                 replica_breaker_cooldown_s: float = 1.0,
                 health_interval_s: float = 1.0,
                 request_timeout_s: float = 60.0,
                 probe_timeout_s: float = 2.0,
                 affinity_prefix_tokens: int = 8,
                 affinity_spill_depth: int = 8,
                 disagg_min_prompt: int = 32,
                 min_replicas: int = 1, max_replicas: int = 8,
                 scale_up_depth: float = 4.0,
                 scale_down_depth: float = 0.5,
                 metrics: Optional[ServingMetrics] = None,
                 tracer: Optional[TraceRecorder] = None):
        self.factory = factory
        self.replica_breaker_threshold = int(replica_breaker_threshold)
        self.replica_breaker_cooldown_s = float(replica_breaker_cooldown_s)
        self.health_interval_s = float(health_interval_s)
        self.request_timeout_s = float(request_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.affinity_prefix_tokens = int(affinity_prefix_tokens)
        self.affinity_spill_depth = int(affinity_spill_depth)
        # disaggregation: prompts at least this long are
        # split prefill/decode when prefill-role workers exist; shorter
        # ones go straight to a decode worker (shipping a page of KV
        # costs more than prefilling a short prompt locally)
        self.disagg_min_prompt = int(disagg_min_prompt)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_depth = float(scale_up_depth)
        self.scale_down_depth = float(scale_down_depth)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        # fleet-level request tracing: every routed request
        # gets ONE trace whose spans name each dispatch attempt and
        # failover hop — a replica killed mid-storm shows up as a
        # failed span on the corpse and a successful span on the
        # replica that answered, under the same X-Request-Id the
        # replicas' own serving planes traced
        self.tracer = tracer if tracer is not None else TraceRecorder()
        self._lock = threading.Lock()
        self._replicas: List[Replica] = []
        self._seq = 0
        self._version = 0
        self.failovers = 0       # failed dispatch attempts that moved on
        self.swaps = 0           # completed rolling swaps
        self.scale_ups = 0
        self.scale_downs = 0
        self.health_polls = 0
        # disaggregation ledger: successful page shipments,
        # shipments that fell back to a local recompute (integrity /
        # dead worker / no prefill capacity), sticky-session routing
        # outcomes, and per-role successful-dispatch counts
        self.ships = 0
        self.ship_fallbacks = 0
        self.session_spill_ships = 0
        self.session_affinity_hits = 0
        self._role_requests: Dict[str, int] = {r: 0 for r in ROLES}
        self._session_route: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict())
        self._session_capacity = 4096
        self.autoscale = False   # health loop calls autoscale_tick() too
        self._autoscale_busy = threading.Lock()
        # ledger counts of gracefully retired replicas (rolling swap /
        # scale-down) + how many retired without reporting (a corpse) —
        # check_fleet_ledger folds these in
        self._retired_agg = {"requests": 0, "rejected": 0, "shed": 0,
                             "deadline_missed": 0, "poison_isolated": 0}
        self._retired_lost = 0
        self._stop_health = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        for _ in range(int(replicas)):
            self.add_replica()

    # ---- membership -------------------------------------------------------

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def attach(self, replica: Replica) -> Replica:
        """Put a replica into rotation.  Assigns the router's breaker
        policy when the replica has none; every breaker transition feeds
        the replica's ejection/re-admission counters."""
        if replica.breaker is None:
            replica.breaker = CircuitBreaker(
                failure_threshold=self.replica_breaker_threshold,
                cooldown_s=self.replica_breaker_cooldown_s)
        replica.breaker.add_listener(replica._on_breaker)
        with self._lock:
            self._replicas.append(replica)
        return replica

    def add_replica(self, role: Optional[str] = None) -> Replica:
        """Spawn (via the factory) and attach one replica.  `role`
        puts the new replica into a specific role
        group — how role-aware autoscaling grows the prefill and
        decode pools independently.  A factory that accepts a `role`
        keyword gets it (so it can build a ship-capable pool for a
        role-differentiated worker); otherwise the replica is
        re-stamped after the fact — role is ROUTER state (every worker
        serves the same surface), and a re-stamped worker whose pool
        happens not to ship only ever costs recompute fallbacks, never
        failed requests."""
        if self.factory is None:
            raise ValueError("no replica factory configured")
        if role is not None and role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        with self._lock:
            name = f"replica-{self._seq}"
            self._seq += 1
            version = self._version
        takes_role = False
        if role is not None:
            try:
                takes_role = "role" in inspect.signature(
                    self.factory).parameters
            except (TypeError, ValueError):
                takes_role = False
        replica = (self.factory(name, role=role) if takes_role
                   else self.factory(name))
        replica.version = version
        if role is not None:
            replica.role = role
        return self.attach(replica)

    def remove(self, replica: Replica, grace_s: float = 5.0) -> bool:
        """Take a replica out of rotation, drain it gracefully, stop
        it.  Returns True when its in-flight work finished in time.
        The replica's final serving counts are folded into the router's
        retired aggregate first, so the fleet ledger keeps balancing
        after rolling swaps and scale-downs instead of permanently
        reporting the retired replicas' requests as lost."""
        with self._lock:
            replica.state = REPLICA_DRAINING
        drained = replica.drain(grace_s)
        payload = self._replica_stats(replica)
        with self._lock:
            # fold ONLY when this call actually takes the replica out of
            # the list: concurrent remove()s of the same replica (e.g. a
            # rolling swap racing an async autoscale scale-down) must
            # count its requests exactly once
            removed = replica in self._replicas
            if removed:
                self._replicas.remove(replica)
                if payload is None:
                    # a corpse never answers: its counts are
                    # unrecoverable — the ledger reports that honestly
                    self._retired_lost += 1
                else:
                    _fold_plane_counts(self._retired_agg, payload)
        replica.stop()
        return drained

    def has_routable(self) -> bool:
        with self._lock:
            return any(r.routable() for r in self._replicas)

    # ---- picking ----------------------------------------------------------

    @staticmethod
    def _rendezvous_weight(key: str, name: str) -> bytes:
        return hashlib.blake2b(f"{key}|{name}".encode(),
                               digest_size=8).digest()

    def _pick(self, excluded: frozenset = frozenset(),
              key: Optional[str] = None,
              roles: Optional[Sequence[str]] = None) -> Optional[Replica]:
        """Choose a replica for one dispatch attempt.  Least-loaded by
        router-side in-flight (ties broken deterministically by name);
        with an affinity `key`, rendezvous hashing picks a preferred
        replica that stays stable under membership changes, spilling to
        least-loaded only when the preferred one is backed up by more
        than `affinity_spill_depth` requests over the least loaded.
        `roles` restricts candidacy (the disaggregated LM split);
        None = role-agnostic (classifier traffic)."""
        with self._lock:
            candidates = [r for r in self._replicas
                          if r.routable() and r.name not in excluded
                          and (roles is None or r.role in roles)]
        if not candidates:
            return None
        # a half-open replica is ejected-pending-probe, not healthy: its
        # in_flight is ~0 precisely BECAUSE it got no traffic, so plain
        # least-loaded would prefer the corpse for every new request.
        # Route to closed-breaker replicas whenever any exist; half-open
        # ones are the last resort (and `_dispatch`'s allow_dispatch
        # gate caps them to one probe at a time)
        healthy = [r for r in candidates
                   if r.breaker is None
                   or r.breaker.state == BREAKER_CLOSED]
        pool = healthy or candidates
        least = min(pool, key=lambda r: (r.in_flight, r.name))
        if key is None:
            return least
        preferred = max(pool,
                        key=lambda r: self._rendezvous_weight(key, r.name))
        if preferred.in_flight - least.in_flight > self.affinity_spill_depth:
            return least
        return preferred

    # ---- transport --------------------------------------------------------

    def _http(self, method: str, url: str, body=None,
              timeout: Optional[float] = None,
              headers: Optional[Dict[str, str]] = None,
              raw_body: Optional[bytes] = None,
              raw_response: bool = False):
        """One HTTP exchange.  JSON in/out by default; `raw_body` sends
        an octet-stream request (a KV page shipment), `raw_response`
        returns the body bytes unparsed (a shipment coming back)."""
        if raw_body is not None:
            data, ctype = raw_body, "application/octet-stream"
        else:
            data = None if body is None else json.dumps(body).encode()
            ctype = "application/json"
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": ctype, **(headers or {})})
        with urllib.request.urlopen(
                req, timeout=(timeout if timeout is not None
                              else self.request_timeout_s)) as resp:
            raw = resp.read()
            if raw_response:
                return resp.status, raw
            return resp.status, json.loads(raw or b"{}")

    def _dispatch(self, replica: Replica, path: str, body,
                  timeout: Optional[float] = None,
                  request_id: Optional[str] = None,
                  raw_body: Optional[bytes] = None,
                  raw_response: bool = False,
                  deadline_ms: Optional[float] = None):
        """One dispatch attempt against one replica.  Raises
        `FleetClientError` (4xx — never retried) or
        `_ReplicaDispatchError` (failover) on failure; feeds the
        replica's breaker and router-side counters.  `request_id` is
        forwarded as ``X-Request-Id`` so the replica's serving plane
        traces under the SAME id — including on failover resubmission.
        `raw_body`/`raw_response` carry the binary page-shipping legs
        through the same breaker/counter discipline."""
        if (replica.breaker is not None
                and not replica.breaker.allow_dispatch()):
            # half-open single-probe discipline (same as batcher/lm):
            # one request at a time rides the re-admission probe; the
            # rest fail over penalty-free instead of piling unbounded
            # traffic — each hanging up to request_timeout_s — onto a
            # replica the breaker has not re-admitted yet
            raise _ReplicaDispatchError(
                f"replica {replica.name} half-open: re-admission probe "
                f"already in flight", replica_fault=False)
        with replica.lock:
            replica.in_flight += 1
        try:
            headers = {}
            if request_id:
                headers["X-Request-Id"] = request_id
            if deadline_ms is not None:
                # binary legs cannot carry deadline_ms in a JSON body:
                # the remaining budget rides the header instead
                headers["X-Deadline-Ms"] = f"{deadline_ms:.0f}"
            try:
                _, payload = self._http(
                    "POST", replica.url + path, body, timeout,
                    headers=headers or None,
                    raw_body=raw_body, raw_response=raw_response)
            except urllib.error.HTTPError as e:
                status = e.code
                try:
                    err_payload = json.loads(e.read() or b"{}")
                except ValueError:
                    err_payload = {}
                detail = err_payload.get("error", "")
                if 400 <= status < 500:
                    raise FleetClientError(
                        detail or f"replica {replica.name} answered "
                                  f"{status}", status=status,
                        retry_after_s=err_payload.get(
                            "retry_after_s")) from e
                # 503/504: alive but unavailable (overload / draining /
                # deadline) — fail over penalty-free.  Any other 5xx is
                # a replica fault and counts toward ejection.
                raise _ReplicaDispatchError(
                    f"replica {replica.name} answered {status}: {detail}",
                    replica_fault=status not in (503, 504)) from e
            except (http.client.HTTPException, OSError, ValueError) as e:
                # connection refused/reset, short read, timeout, or a
                # 2xx answer whose body is not JSON (a misconfigured
                # attached endpoint): the replica is gone, wedged, or
                # answering garbage — a breaker-worthy fault either way
                raise _ReplicaDispatchError(
                    f"replica {replica.name} unusable: "
                    f"{type(e).__name__}: {e}", replica_fault=True) from e
        except FleetClientError:
            # the replica ANSWERED — the payload was the problem.  An
            # answer is liveness evidence: it re-admits a half-open
            # replica (releasing the probe claim) and resets the
            # failure streak, exactly like a 200 would
            if replica.breaker is not None:
                replica.breaker.record_success()
            raise
        except _ReplicaDispatchError as e:
            if replica.breaker is not None:
                if e.replica_fault:
                    replica.breaker.record_failure()
                else:
                    # 503/504: alive-but-unavailable is neither
                    # re-admission evidence nor a fault — just release
                    # any probe claim so the half-open window stays open
                    replica.breaker.abandon_probe()
            with replica.lock:
                if e.replica_fault:
                    replica.failures += 1
            raise
        finally:
            with replica.lock:
                replica.in_flight -= 1
        if replica.breaker is not None:
            replica.breaker.record_success()
        with replica.lock:
            replica.dispatches += 1
        with self._lock:
            self._role_requests[replica.role] = (
                self._role_requests.get(replica.role, 0) + 1)
        return payload

    def _submit(self, path: str, body, key: Optional[str] = None,
                timeout: Optional[float] = None,
                request_id: Optional[str] = None,
                roles: Optional[Sequence[str]] = None,
                session_id: Optional[str] = None):
        """Failover loop: try routable replicas (excluded set grows per
        failure) until one answers or none remain.  Predict is pure, so
        resubmitting a failed dispatch elsewhere is always safe.  The
        whole loop is ONE trace under `request_id` (minted here when the
        caller has none): one span per dispatch attempt plus a
        failover_hop span per resubmission.  `session_id` is noted
        against the replica that ACTUALLY answered — a failover must
        not leave the sticky-session map pointing at a corpse."""
        t0 = time.perf_counter()
        rid = request_id or new_request_id()
        spans: List[Dict] = []

        def finish(status: str, error: Optional[str] = None):
            self.tracer.record(trace(
                rid, "fleet", spans, status=status, path=path,
                failovers=sum(1 for s in spans
                              if s["name"] == "failover_hop") or None,
                error=error))

        # the client's deadline is a TOTAL budget across failovers: each
        # retry forwards only what remains of it, and an exhausted
        # budget is a typed 504 here — not a fresh full-deadline
        # dispatch per attempt
        deadline_ms = (body.get("deadline_ms")
                       if isinstance(body, dict) else None)
        excluded: set = set()
        last: Optional[BaseException] = None
        while True:
            if deadline_ms is not None:
                remaining = deadline_ms - (time.perf_counter() - t0) * 1e3
                if remaining <= 0:
                    self.metrics.record_deadline_missed()
                    self.metrics.record_rejected()
                    finish("timeout", error=str(last) if last else None)
                    raise DeadlineExceededError(
                        f"deadline of {deadline_ms:.0f}ms exhausted "
                        f"after {len(excluded)} failover(s)"
                        + (f" (last failure: {last})" if last else ""))
                body["deadline_ms"] = remaining
            replica = self._pick(frozenset(excluded), key, roles=roles)
            if replica is None:
                break
            ta = time.perf_counter()
            try:
                payload = self._dispatch(replica, path, body, timeout,
                                         request_id=rid)
            except FleetClientError as e:
                # the payload's fault everywhere — no failover, but it
                # is still a typed rejection in the router's ledger:
                # client_balanced (submitted == requests + rejected)
                # must keep holding when some submissions are 4xx
                spans.append(span("dispatch", ta, time.perf_counter(),
                                  replica=replica.name, outcome="4xx"))
                self.metrics.record_rejected()
                finish("client_error", error=str(e))
                raise
            except _ReplicaDispatchError as e:
                tb = time.perf_counter()
                spans.append(span(
                    "dispatch", ta, tb, replica=replica.name,
                    outcome=("fault" if e.replica_fault
                             else "unavailable"), error=str(e)[:200]))
                spans.append(span("failover_hop", tb, tb,
                                  excluded=replica.name))
                excluded.add(replica.name)
                with self._lock:
                    self.failovers += 1
                last = e
                continue
            spans.append(span("dispatch", ta, time.perf_counter(),
                              replica=replica.name, outcome="ok"))
            self.metrics.record_request(time.perf_counter() - t0)
            self._note_session_route(session_id, replica)
            finish("ok")
            return payload
        self.metrics.record_rejected()
        finish("unroutable", error=str(last) if last else None)
        raise ServingUnavailableError(
            "no routable replica" + (f" (last failure: {last})"
                                     if last else ""))

    # ---- client surface ---------------------------------------------------

    def predict_proba(self, x, deadline_s: Optional[float] = None,
                      timeout: Optional[float] = None,
                      request_id: Optional[str] = None,
                      tenant: Optional[str] = None) -> np.ndarray:
        """[n, ...] features -> [n, classes] activations, served by
        whichever healthy replica the router picks (float32 survives the
        JSON hop bit-exactly: float32 -> float64 -> shortest-repr
        round-trip -> float32 is the identity).  `tenant` forwards
        verbatim: the replica's registry owns the vocabulary
        — unknown 400s there, over-quota 429s there, both typed."""
        body: Dict = {"features": np.asarray(x, np.float32).tolist()}
        if deadline_s is not None:
            body["deadline_ms"] = float(deadline_s) * 1e3
        if tenant is not None:
            body["tenant"] = str(tenant)
        payload = self._submit("/model/predict", body, timeout=timeout,
                               request_id=request_id)
        return np.asarray(payload["outputs"], np.float32)

    def predict(self, x, deadline_s: Optional[float] = None,
                timeout: Optional[float] = None,
                request_id: Optional[str] = None,
                tenant: Optional[str] = None) -> np.ndarray:
        return np.argmax(self.predict_proba(x, deadline_s=deadline_s,
                                            timeout=timeout,
                                            request_id=request_id,
                                            tenant=tenant),
                         axis=-1)

    def _lm_affinity_key(self, ids: Sequence[int],
                         session_id: Optional[str]) -> str:
        """The rendezvous key for one LM request: sticky `session_id`
        when the client sent one (a multi-turn chat keeps landing on
        the replica holding its pages — its prompts GROW every turn, so
        prefix hashing alone would eventually re-route it), else the
        prompt's first `affinity_prefix_tokens` tokens."""
        if session_id is not None:
            return f"session:{session_id}"
        return ",".join(map(str, ids[:self.affinity_prefix_tokens]))

    def _note_session_route(self, session_id: Optional[str],
                            replica: Replica) -> None:
        """Router-side sticky-session accounting: a session that lands
        on the same replica as its previous turn is an affinity hit."""
        if session_id is None:
            return
        with self._lock:
            prev = self._session_route.get(session_id)
            if prev is not None:
                self._session_route.move_to_end(session_id)
                if prev == replica.name:
                    self.session_affinity_hits += 1
            self._session_route[session_id] = replica.name
            while len(self._session_route) > self._session_capacity:
                self._session_route.popitem(last=False)

    def _has_role(self, role: str) -> bool:
        with self._lock:
            return any(r.role == role and r.routable()
                       for r in self._replicas)

    def generate_payload(self, prompt_ids: Sequence[int],
                         max_new_tokens: int, temperature: float = 0.0,
                         seed: int = 0, top_k: int = 0, top_p: float = 1.0,
                         beam_size: int = 0,
                         deadline_s: Optional[float] = None,
                         timeout: Optional[float] = None,
                         request_id: Optional[str] = None,
                         session_id: Optional[str] = None,
                         priority: Optional[str] = None,
                         tenant: Optional[str] = None) -> Dict:
        """LM generation with affinity routing and role scheduling.

        Affinity: a sticky `session_id` (when sent) or the first
        `affinity_prefix_tokens` prompt tokens pick the preferred
        DECODE-capable replica via rendezvous hashing, so a shared
        system prompt — or a whole conversation — keeps hitting the
        same replica's prefix cache.  Roles: when
        prefill-role workers exist and the prompt is at least
        `disagg_min_prompt` tokens, the request is split — a prefill
        worker chews the prompt and ships the finished KV pages to the
        decode replica picked up front; short prompts go straight to
        decode workers.  A sticky session spilling off its overloaded
        preferred replica is served by page shipping (prefill on the
        replica holding its radix pages, decode on the spill target)
        instead of a cold recompute.  Every ship failure — integrity,
        dead worker, dry pool — falls back down the ladder to a local
        recompute on a decode worker: zero failed requests by
        construction.  Returns the replica's full JSON answer (`ids`,
        plus `score` on the beam path).  top-k / top-p / beam forward
        to the replica's whole-sequence leg; every mode is seeded and
        deterministic, so failover resubmission stays safe."""
        ids = [int(t) for t in prompt_ids]
        key = self._lm_affinity_key(ids, session_id)
        body: Dict = {"prompt_ids": ids,
                      "max_new_tokens": int(max_new_tokens),
                      "temperature": float(temperature), "seed": int(seed)}
        if session_id is not None:
            body["session_id"] = str(session_id)
        if priority is not None:
            # forwarded verbatim: the replica's admission gate owns the
            # vocabulary, so an unknown class 400s there and propagates
            body["priority"] = str(priority)
        if tenant is not None:
            # same verbatim-forward contract: the replica's
            # tenant registry owns the vocabulary — unknown 400s there,
            # over-quota 429s there, and both propagate typed
            body["tenant"] = str(tenant)
        if int(top_k):
            body["top_k"] = int(top_k)
        if float(top_p) < 1.0:
            body["top_p"] = float(top_p)
        if int(beam_size) > 1:
            body["beam_size"] = int(beam_size)
        if deadline_s is not None:
            body["deadline_ms"] = float(deadline_s) * 1e3
        whole_sequence = (int(top_k) > 0 or float(top_p) < 1.0
                          or int(beam_size) > 1)
        long_prompt = len(ids) >= self.disagg_min_prompt
        if not whole_sequence and long_prompt:
            if self._has_role(ROLE_PREFILL):
                # role split: prefill workers exist for this prompt
                return self._submit_disagg(body, key, timeout=timeout,
                                           request_id=request_id,
                                           session_id=session_id)
            # spill-over candidacy only matters for long prompts on a
            # shipping-capable fleet — short prompts skip the extra
            # pick entirely and go straight to the submit loop
            replica, spilled, preferred = self._pick_decode(key)
            if (spilled and preferred is not None
                    and self._replica_ships(preferred)):
                # sticky-session spill-over: the preferred
                # replica holds this conversation's radix pages but is
                # backed up — prefill THERE (radix-cheap), ship the
                # pages to the spill target instead of recomputing cold
                with self._lock:
                    self.session_spill_ships += 1
                return self._submit_disagg(body, key, timeout=timeout,
                                           request_id=request_id,
                                           session_id=session_id,
                                           prefill_pref=preferred,
                                           decode_pref=replica)
        return self._submit("/lm/generate", body, key=key,
                            timeout=timeout, request_id=request_id,
                            roles=_DECODE_ROLES, session_id=session_id)

    def _pick_decode(self, key: str):
        """The decode-side pick with the spill decision made visible:
        returns (chosen, spilled, preferred) where `spilled` means the
        rendezvous-preferred replica was passed over for load."""
        chosen = self._pick(key=key, roles=_DECODE_ROLES)
        if chosen is None:
            return None, False, None
        with self._lock:
            pool = [r for r in self._replicas
                    if r.routable() and r.role in _DECODE_ROLES]
        if not pool:              # membership raced the pick away
            return chosen, False, None
        rendezvous = max(pool, key=lambda r: self._rendezvous_weight(
            key, r.name))
        spilled = chosen.name != rendezvous.name
        return chosen, spilled, rendezvous

    @staticmethod
    def _replica_ships(replica: Replica) -> bool:
        """Best-effort: can this replica serve /lm/prefill?  Prefill
        workers always can; a both-role replica only when its pool was
        spawned with lm_ship=True — the endpoint answers 400 otherwise
        and the ladder falls back to recompute, so this check is an
        optimization, not a correctness gate."""
        if replica.role == ROLE_PREFILL:
            return True
        srv = getattr(replica.server, "state", None)
        lm = getattr(srv, "lm_server", None) if srv is not None else None
        return bool(getattr(lm, "ship", False)) if lm is not None else True

    def _submit_disagg(self, body: Dict, key: str,
                       timeout: Optional[float] = None,
                       request_id: Optional[str] = None,
                       session_id: Optional[str] = None,
                       prefill_pref: Optional[Replica] = None,
                       decode_pref: Optional[Replica] = None) -> Dict:
        """The disaggregated submit: prefill -> ship -> decode, one
        trace under one X-Request-Id naming the prefill worker, the
        wire hop, and the decode worker.  The failure ladder never
        fails the request: a dead/failing prefill worker resubmits the
        prompt to a peer; no peer (or a rejected/corrupt shipment, or a
        dying decode worker) falls back to a plain /lm/generate on the
        decode pool — recompute, not error."""
        t0 = time.perf_counter()
        rid = request_id or new_request_id()
        spans: List[Dict] = []
        # the client's deadline is a TOTAL budget across the whole
        # prefill -> ship -> decode ladder (same discipline as
        # `_submit`): each leg gets only what remains of it
        deadline_ms = (body.get("deadline_ms")
                       if isinstance(body, dict) else None)

        def _remaining_ms() -> Optional[float]:
            if deadline_ms is None:
                return None
            rem = deadline_ms - (time.perf_counter() - t0) * 1e3
            if rem <= 0:
                self.metrics.record_deadline_missed()
                self.metrics.record_rejected()
                self.tracer.record(trace(
                    rid, "fleet", spans, status="timeout",
                    path="/lm/generate", disagg=True))
                raise DeadlineExceededError(
                    f"deadline of {deadline_ms:.0f}ms exhausted "
                    f"mid-ship")
            return rem

        decode = decode_pref or self._pick(key=key, roles=_DECODE_ROLES)
        if decode is None:
            self.metrics.record_rejected()
            raise ServingUnavailableError(
                "no routable decode-capable replica")
        prefill_body = {k: v for k, v in body.items()
                        if k not in ("top_k", "top_p", "beam_size")}
        excluded: set = set()
        blob = None
        last: Optional[BaseException] = None
        while blob is None:
            rem = _remaining_ms()
            if rem is not None:
                prefill_body["deadline_ms"] = rem
            pre = (prefill_pref
                   if prefill_pref is not None
                   and prefill_pref.name not in excluded
                   and prefill_pref.routable()
                   else self._pick(frozenset(excluded),
                                   roles=_PREFILL_ROLES))
            if pre is None or pre.name == decode.name:
                # no prefill capacity left (or only the decode replica
                # itself): recompute locally on the decode side
                break
            ta = time.perf_counter()
            try:
                blob = self._dispatch(pre, "/lm/prefill", prefill_body,
                                      timeout, request_id=rid,
                                      raw_response=True)
            except FleetClientError as e:
                # the prefill worker ANSWERED 4xx: a 422 is the typed
                # "this worker cannot ship" (kind: page_ship) — fall
                # back to recompute; any other 4xx means the request is
                # bad everywhere (propagate — recomputing would 400 too)
                spans.append(span("dispatch", ta, time.perf_counter(),
                                  replica=pre.name, stage="prefill",
                                  outcome="4xx"))
                if e.status == 422:
                    last = e
                    break
                self.metrics.record_rejected()
                raise
            except _ReplicaDispatchError as e:
                # a dead prefill worker's in-flight prompt resubmits to
                # a peer — the mid-ship-kill acceptance path
                tb = time.perf_counter()
                spans.append(span(
                    "dispatch", ta, tb, replica=pre.name,
                    stage="prefill",
                    outcome=("fault" if e.replica_fault
                             else "unavailable"), error=str(e)[:200]))
                spans.append(span("failover_hop", tb, tb,
                                  excluded=pre.name))
                excluded.add(pre.name)
                with self._lock:
                    self.failovers += 1
                last = e
                continue
            spans.append(span("dispatch", ta, time.perf_counter(),
                              replica=pre.name, stage="prefill",
                              outcome="ok"))
        if blob is not None:
            ts = time.perf_counter()
            try:
                payload = self._dispatch(
                    decode, "/lm/admit_pages", None, timeout,
                    request_id=rid, raw_body=blob,
                    deadline_ms=_remaining_ms())
                td = time.perf_counter()
                spans.append(span("ship", ts, td, bytes=len(blob),
                                  decode=decode.name))
                spans.append(span("dispatch", ts, td,
                                  replica=decode.name, stage="decode",
                                  outcome="ok"))
                with self._lock:
                    self.ships += 1
                self.metrics.record_request(time.perf_counter() - t0)
                self._note_session_route(session_id, decode)
                self.tracer.record(trace(
                    rid, "fleet", spans, status="ok",
                    path="/lm/generate", disagg=True))
                return payload
            except (FleetClientError, _ReplicaDispatchError) as e:
                # rejected shipment (422 integrity/geometry, a pool
                # that cannot admit) or a decode worker dying mid-admit:
                # recompute below — never a failed request
                spans.append(span("dispatch", ts, time.perf_counter(),
                                  replica=decode.name, stage="decode",
                                  outcome="ship_rejected",
                                  error=str(e)[:200]))
                last = e
        # --- recompute ladder: plain generate on the decode pool
        with self._lock:
            self.ship_fallbacks += 1
        spans.append(span("failover_hop", time.perf_counter(),
                          time.perf_counter(), fallback="recompute",
                          error=(str(last)[:200] if last else None)))
        self.tracer.record(trace(rid, "fleet", spans,
                                 status="recompute_fallback",
                                 path="/lm/generate", disagg=True))
        rem = _remaining_ms()
        if rem is not None:
            # hand the recompute only what the ship attempt left over —
            # _submit treats body["deadline_ms"] as a fresh total budget
            body = dict(body, deadline_ms=rem)
        return self._submit("/lm/generate", body, key=key,
                            timeout=timeout, request_id=rid,
                            roles=_DECODE_ROLES, session_id=session_id)

    def open_lm_stream(self, prompt_ids: Sequence[int],
                       max_new_tokens: int, temperature: float = 0.0,
                       seed: int = 0, top_k: int = 0,
                       top_p: float = 1.0, beam_size: int = 0,
                       deadline_s: Optional[float] = None,
                       timeout: Optional[float] = None,
                       request_id: Optional[str] = None,
                       session_id: Optional[str] = None,
                       priority: Optional[str] = None,
                       tenant: Optional[str] = None):
        """Open one SSE token stream against a decode-capable replica
        (affinity-routed like `generate_payload`); returns the raw
        `http.client`-style response object — the caller relays/parses
        the `text/event-stream` bytes and MUST close it (closing also
        records the stream's true duration into the router's request
        latency).  top-k/top-p/beam forward so the replica can answer
        its typed 400 — silently downgrading a sampled stream to
        greedy would serve DIFFERENT generations than the
        single-server surface refuses to.  Failover covers
        connect-time failures only: once events flow, tokens already
        reached the client and a resubmission would replay them — a
        mid-stream death surfaces as a truncated stream."""
        ids = [int(t) for t in prompt_ids]
        key = self._lm_affinity_key(ids, session_id)
        body: Dict = {"prompt_ids": ids,
                      "max_new_tokens": int(max_new_tokens),
                      "temperature": float(temperature),
                      "seed": int(seed), "stream": True}
        if int(top_k):
            body["top_k"] = int(top_k)
        if float(top_p) < 1.0:
            body["top_p"] = float(top_p)
        if int(beam_size) > 1:
            body["beam_size"] = int(beam_size)
        if session_id is not None:
            body["session_id"] = str(session_id)
        if priority is not None:
            body["priority"] = str(priority)
        if tenant is not None:
            body["tenant"] = str(tenant)
        if deadline_s is not None:
            body["deadline_ms"] = float(deadline_s) * 1e3
        rid = request_id or new_request_id()
        excluded: set = set()
        last: Optional[BaseException] = None
        while True:
            replica = self._pick(frozenset(excluded), key,
                                 roles=_DECODE_ROLES)
            if replica is None:
                self.metrics.record_rejected()
                raise ServingUnavailableError(
                    "no routable decode-capable replica for the stream"
                    + (f" (last failure: {last})" if last else ""))
            req = urllib.request.Request(
                replica.url + "/lm/generate",
                data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json",
                         "X-Request-Id": rid})
            # streams feed the SAME replica accounting as _dispatch:
            # in_flight for the stream's whole lifetime (least-loaded
            # and spill decisions must see long-lived streams), breaker
            # verdicts per outcome, dispatches on success — an SSE-heavy
            # fleet must not fly blind
            with replica.lock:
                replica.in_flight += 1
            try:
                resp = urllib.request.urlopen(
                    req, timeout=(timeout if timeout is not None
                                  else self.request_timeout_s))
            except urllib.error.HTTPError as e:
                with replica.lock:
                    replica.in_flight -= 1
                detail = b""
                try:
                    detail = e.read()
                except OSError:
                    pass
                if 400 <= e.code < 500:
                    # an answer is liveness evidence, like _dispatch
                    if replica.breaker is not None:
                        replica.breaker.record_success()
                    raise FleetClientError(
                        detail.decode(errors="replace")
                        or f"replica {replica.name} answered {e.code}",
                        status=e.code) from e
                if replica.breaker is not None:
                    if e.code in (503, 504):
                        replica.breaker.abandon_probe()
                    else:
                        replica.breaker.record_failure()
                if e.code not in (503, 504):
                    with replica.lock:
                        replica.failures += 1
                excluded.add(replica.name)
                with self._lock:
                    self.failovers += 1
                last = e
                continue
            except (http.client.HTTPException, OSError) as e:
                with replica.lock:
                    replica.in_flight -= 1
                if replica.breaker is not None:
                    replica.breaker.record_failure()
                with replica.lock:
                    replica.failures += 1
                excluded.add(replica.name)
                with self._lock:
                    self.failovers += 1
                last = e
                continue
            if replica.breaker is not None:
                replica.breaker.record_success()
            with replica.lock:
                replica.dispatches += 1
            with self._lock:
                self._role_requests[replica.role] = (
                    self._role_requests.get(replica.role, 0) + 1)
            self._note_session_route(session_id, replica)
            # at close (idempotent): release the in-flight claim and
            # record the stream's TRUE duration — recording 0.0 at
            # connect would collapse the fleet's latency percentiles
            # for exactly the TTFT-sensitive traffic streaming exists
            # for
            t_open = time.perf_counter()
            orig_close = resp.close
            recorded = []

            def close_and_record():
                if not recorded:
                    recorded.append(True)
                    with replica.lock:
                        replica.in_flight -= 1
                    self.metrics.record_request(
                        time.perf_counter() - t_open)
                orig_close()

            resp.close = close_and_record
            return resp

    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 top_k: int = 0, top_p: float = 1.0, beam_size: int = 0,
                 deadline_s: Optional[float] = None,
                 timeout: Optional[float] = None,
                 session_id: Optional[str] = None) -> List[int]:
        payload = self.generate_payload(
            prompt_ids, max_new_tokens, temperature=temperature, seed=seed,
            top_k=top_k, top_p=top_p, beam_size=beam_size,
            deadline_s=deadline_s, timeout=timeout,
            session_id=session_id)
        return list(payload["ids"])

    # ---- health: eject -> probe -> re-admit -------------------------------

    def _probe_readyz(self, replica: Replica) -> bool:
        try:
            status, _ = self._http("GET", replica.url + "/readyz",
                                   timeout=self.probe_timeout_s)
            return status == 200
        except (http.client.HTTPException, OSError, ValueError):
            # HTTPError (e.g. a 503 from a draining/broken replica) is
            # an OSError subclass; ValueError covers a 200 whose body is
            # not JSON.  Any failure mode means not ready — and nothing
            # may escape here, or it would kill the health daemon
            return False

    def poll_health_once(self,
                         _async_autoscale: bool = False) -> Dict[str, bool]:
        """One health sweep: probe every in-rotation replica's /readyz.
        A failed probe is a breaker failure (threshold consecutive
        failures eject); a successful probe on a half-open breaker IS
        the re-admission.  Ejected replicas inside their cooldown are
        skipped — the cooldown elapsing re-opens the probe window.

        A green probe on a CLOSED breaker records nothing: /readyz
        succeeding must not erase dispatch-failure evidence, or a
        replica that 500s every dispatch while its readyz stays green
        would never accumulate the threshold consecutive failures and
        never be ejected.  Successful dispatches already reset the
        streak; the probe only votes to re-admit."""
        with self._lock:
            self.health_polls += 1
            replicas = [r for r in self._replicas
                        if r.state == REPLICA_ACTIVE]
        results: Dict[str, bool] = {}
        # probe concurrently: one wedged replica must cost the sweep one
        # probe_timeout_s, not serialize behind every other probe and
        # degrade the whole fleet's detection cadence
        probe = [r for r in replicas
                 if not (r.breaker is not None and r.breaker.rejecting())]
        if probe:                          # skipped: cooldown not elapsed
            with futures.ThreadPoolExecutor(
                    max_workers=min(8, len(probe))) as pool:
                outcomes = list(pool.map(self._probe_readyz, probe))
            for r, ok in zip(probe, outcomes):
                results[r.name] = ok
                if r.breaker is not None:
                    if ok:
                        if r.breaker.state == BREAKER_HALF_OPEN:
                            r.breaker.record_success()
                    else:
                        r.breaker.record_failure()
        if self.autoscale:
            if _async_autoscale:
                self._spawn_autoscale_tick()
            else:
                self.autoscale_tick()
        return results

    def _spawn_autoscale_tick(self) -> None:
        """Run one autoscale decision OFF the health thread: a
        scale-down drains (seconds of grace) and a scale-up warms every
        bucket (seconds of compilation) — neither may stall /readyz
        probing, or a replica dying during the action would go
        undetected for the whole window.  At most one action runs at a
        time; ticks arriving while one is in flight are dropped (the
        next poll re-evaluates from fresh queue depths)."""
        if not self._autoscale_busy.acquire(blocking=False):
            return

        def run():
            try:
                self.autoscale_tick()
            finally:
                self._autoscale_busy.release()

        threading.Thread(target=run, daemon=True,
                         name="fleet-autoscale").start()

    def start_health_loop(self,
                          interval_s: Optional[float] = None) -> None:
        if interval_s is not None:
            self.health_interval_s = float(interval_s)
        if self._health_thread is not None:
            return
        self._stop_health.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="fleet-health")
        self._health_thread.start()

    def _health_loop(self) -> None:
        # the loop dispatches autoscale actions to a side thread so a
        # drain or a standby warmup can never stall /readyz probing;
        # explicit poll_health_once() callers keep the synchronous tick
        while not self._stop_health.wait(self.health_interval_s):
            self.poll_health_once(_async_autoscale=True)

    def stop_health_loop(self) -> None:
        self._stop_health.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
            self._health_thread = None

    # ---- rolling weight swap ----------------------------------------------

    def rolling_swap(self, factory: Optional[Callable[[str], Replica]]
                     = None, grace_s: float = 10.0) -> List[Dict]:
        """Zero-downtime weight swap.  Per active replica, in order:
        spawn a standby with the new weights (the factory warms every
        bucket before returning, so the standby is warm before traffic), attach it, take the old replica out of rotation,
        drain its in-flight work, stop it.  Traffic keeps flowing the
        whole time — at least N replicas are routable at every instant,
        and a request that raced into the draining replica fails over.
        `factory` (when given) becomes the fleet's replica factory, so
        scale-ups after the swap also serve the new weights."""
        if factory is not None:
            self.factory = factory
        if self.factory is None:
            raise ValueError("rolling_swap needs a replica factory")
        with self._lock:
            self._version += 1
            olds = [r for r in self._replicas
                    if r.state == REPLICA_ACTIVE]
        steps = []
        for old in olds:
            standby = self.add_replica()
            drained = self.remove(old, grace_s)
            steps.append({"retired": old.name, "standby": standby.name,
                          "drained": drained})
        with self._lock:
            self.swaps += 1
        return steps

    # ---- queue-depth-driven scaling ---------------------------------------

    def queue_depth_by_role(self) -> Dict[str, int]:
        """Router-side queue-depth proxy split per replica role
        (the `fleet_queue_depth{role}` gauge): the
        summed in-flight of active replicas in each role that has any.
        The split is what lets autoscaling grow prefill and decode
        pools independently — the aggregate number is decode-biased
        because decode requests live for the whole token loop while
        prefill requests come and go."""
        with self._lock:
            out: Dict[str, int] = {}
            for r in self._replicas:
                if r.state == REPLICA_ACTIVE:
                    out[r.role] = out.get(r.role, 0) + r.in_flight
            return out

    def autoscale_tick(self, grace_s: float = 5.0) -> int:
        """One scaling decision from the router-side queue-depth proxy,
        evaluated PER ROLE (mean in-flight per active replica of that
        role) so a prefill backlog grows the prefill pool and a decode
        backlog the decode pool, independently.  An undifferentiated
        fleet (every replica `both`) is one role group — exactly the
        historic fleet-wide behavior.  At most one action per tick
        (roles evaluated in sorted order, scale-up first): +1 scaled
        up, -1 scaled down through graceful drain, 0 nothing."""
        with self._lock:
            active = [r for r in self._replicas
                      if r.state == REPLICA_ACTIVE]
        if not active:
            return 0
        groups: Dict[str, List[Replica]] = {}
        for r in active:
            groups.setdefault(r.role, []).append(r)
        loads = {role: sum(r.in_flight for r in rs) / len(rs)
                 for role, rs in groups.items()}
        if len(active) < self.max_replicas and self.factory is not None:
            for role in sorted(groups):
                if loads[role] > self.scale_up_depth:
                    self.add_replica(
                        role=role if len(groups) > 1 else None)
                    with self._lock:
                        self.scale_ups += 1
                    return 1
        if len(active) > self.min_replicas:
            for role in sorted(groups):
                rs = groups[role]
                # never drain a role's LAST replica while other roles
                # exist — a disaggregated fleet with zero prefill
                # workers silently loses its split
                if len(rs) < 2 and len(groups) > 1:
                    continue
                if loads[role] < self.scale_down_depth:
                    victim = min(rs, key=lambda r: (r.in_flight, r.name))
                    self.remove(victim, grace_s)
                    with self._lock:
                        self.scale_downs += 1
                    return -1
        return 0

    # ---- stats / lifecycle ------------------------------------------------

    def _replica_stats(self, replica: Replica) -> Optional[Dict]:
        try:
            _, payload = self._http("GET", replica.url + "/serving/stats",
                                    timeout=self.probe_timeout_s)
            return payload
        except (http.client.HTTPException, OSError, ValueError):
            return None

    def fleet_stats(self, include_replica_stats: bool = True) -> Dict:
        """The /fleet/stats payload: fleet-level metrics + per-replica
        breakdown (each replica's own /serving/stats inlined), plus the
        aggregated resilience ledger (`check_fleet_ledger`)."""
        with self._lock:
            counters = {"failovers": self.failovers, "swaps": self.swaps,
                        "scale_ups": self.scale_ups,
                        "scale_downs": self.scale_downs,
                        "health_polls": self.health_polls,
                        "weights_version": self._version}
            disagg = {"ships": self.ships,
                      "ship_fallbacks": self.ship_fallbacks,
                      "session_spill_ships": self.session_spill_ships,
                      "session_affinity_hits": self.session_affinity_hits,
                      "role_requests": dict(self._role_requests)}
            replicas = list(self._replicas)
            retired = {"aggregate": dict(self._retired_agg),
                       "lost": self._retired_lost}
        # fan the per-replica /serving/stats fetches out concurrently:
        # sequentially, one slow replica holds up the whole payload for
        # its probe timeout, and N replicas cost N timeouts end-to-end
        fetch = [r for r in replicas
                 if include_replica_stats and r.state != REPLICA_STOPPED]
        stats_by_name: Dict[str, Optional[Dict]] = {}
        if fetch:
            with futures.ThreadPoolExecutor(
                    max_workers=min(8, len(fetch))) as pool:
                for r, payload in zip(
                        fetch, pool.map(self._replica_stats, fetch)):
                    stats_by_name[r.name] = payload
        entries = []
        for r in replicas:
            entry = r.summary()
            if r.name in stats_by_name:
                entry["stats"] = stats_by_name[r.name]
            entries.append(entry)
        fleet = dict(self.metrics.snapshot())
        fleet["replicas_active"] = sum(
            1 for r in replicas if r.state == REPLICA_ACTIVE)
        fleet["replicas_routable"] = sum(
            1 for r in replicas if r.routable())
        fleet.update(counters)
        # role-split queue-depth proxy: the
        # autoscaler's per-role input, exposed so operators can see
        # WHY a role pool grew (the aggregate is decode-biased)
        fleet["queue_depth_by_role"] = self.queue_depth_by_role()
        # fleet-level LM prefix-reuse view: the router's
        # prefix-affinity hashing exists to concentrate shared prompts
        # per replica — this is the number that says whether it worked
        prefix = {"queries": 0, "hits": 0, "tokens_saved": 0}
        for payload in stats_by_name.values():
            lm = (payload or {}).get("lm") or {}
            if lm.get("prefix_queries"):
                prefix["queries"] += int(lm["prefix_queries"])
                prefix["hits"] += int(lm.get("prefix_hits") or 0)
                prefix["tokens_saved"] += int(
                    lm.get("prefix_tokens_saved") or 0)
        if prefix["queries"]:
            prefix["hit_rate"] = round(
                prefix["hits"] / prefix["queries"], 3)
            fleet["lm_prefix"] = prefix
        # fleet-level speculative-decode view: drafted vs
        # accepted across every replica's LM pool — the fleet-wide
        # accept rate is what says speculation is paying for itself
        spec = {"drafted": 0, "accepted": 0, "rounds": 0}
        for payload in stats_by_name.values():
            lm = (payload or {}).get("lm") or {}
            if lm.get("spec_drafted"):
                spec["drafted"] += int(lm["spec_drafted"])
                spec["accepted"] += int(lm.get("spec_accepted") or 0)
                spec["rounds"] += int(lm.get("spec_rounds") or 0)
        if spec["drafted"]:
            spec["accept_rate"] = round(
                spec["accepted"] / spec["drafted"], 3)
            fleet["lm_speculate"] = spec
        # fleet-level disaggregation view: router-side ship /
        # fallback / session counters plus the per-replica pool ship
        # ledgers (pages_shipped, ship_bytes, ship_ms) and replica-side
        # session affinity hits aggregated through /serving/stats
        ship_agg = {"pages_shipped": 0, "ship_bytes": 0, "out": 0,
                    "in": 0}
        sess_hits = 0
        for payload in stats_by_name.values():
            lm = (payload or {}).get("lm") or {}
            shp = lm.get("ship") or {}
            for k in ship_agg:
                ship_agg[k] += int(shp.get(k) or 0)
            sess_hits += int(lm.get("session_affinity_hits") or 0)
        disagg["replica_session_affinity_hits"] = sess_hits
        if ship_agg["out"] or ship_agg["in"]:
            disagg["pool_ship"] = ship_agg
        if (disagg["ships"] or disagg["ship_fallbacks"]
                or disagg["session_affinity_hits"] or sess_hits
                or any(r.role != ROLE_BOTH for r in replicas)):
            fleet["disagg"] = disagg
        # fleet-level overload-survival view: preemption,
        # host-swap, and brownout aggregated across the LM pools —
        # fleet brownout level is the WORST replica's (a fleet is as
        # degraded as its most degraded pool)
        pressure = {"preemptions": 0, "swap_out": 0, "swap_in": 0,
                    "swap_evicted": 0, "swap_corrupt": 0,
                    "brownout_level": 0, "brownout_transitions": 0,
                    "brownout_shed": 0}
        saw_pressure = False
        for payload in stats_by_name.values():
            lm = (payload or {}).get("lm") or {}
            if lm.get("preemptions"):
                pressure["preemptions"] += int(lm["preemptions"])
                saw_pressure = True
            swap = lm.get("swap") or {}
            if swap:
                pressure["swap_out"] += int(swap.get("out") or 0)
                pressure["swap_in"] += int(swap.get("in") or 0)
                pressure["swap_evicted"] += int(
                    swap.get("evicted") or 0)
                pressure["swap_corrupt"] += int(
                    swap.get("corrupt") or 0)
                saw_pressure = True
            br = lm.get("brownout") or {}
            if br:
                pressure["brownout_level"] = max(
                    pressure["brownout_level"], int(br.get("level") or 0))
                pressure["brownout_transitions"] += int(
                    br.get("transitions") or 0)
                pressure["brownout_shed"] += int(br.get("shed") or 0)
                saw_pressure = True
        if saw_pressure:
            fleet["lm_pressure"] = pressure
        # fleet-level tenancy view: per-tenant event totals
        # summed across both planes of every replica, burn rate folded
        # as the MAX across replicas — a tenant is as unhealthy as its
        # worst pool's view of it, and averaging would let one melting
        # replica hide behind nine idle ones
        tenant_agg: Dict[str, Dict] = {}
        for payload in stats_by_name.values():
            for plane in ("classifier", "lm"):
                section = (payload or {}).get(plane) or {}
                for tn, cell in (section.get("tenants") or {}).items():
                    slot = tenant_agg.setdefault(tn, {})
                    for event, v in cell.items():
                        if event == "burn_rate":
                            slot["burn_rate"] = max(
                                float(slot.get("burn_rate") or 0.0),
                                float(v))
                        else:
                            slot[event] = (int(slot.get(event) or 0)
                                           + int(v))
        if tenant_agg:
            fleet["tenants"] = tenant_agg
        out = {"fleet": fleet, "replicas": entries, "retired": retired}
        if include_replica_stats:
            out["ledger"] = check_fleet_ledger(out)
        return out

    def begin_drain(self) -> None:
        for r in self.replicas():
            with self._lock:
                r.state = REPLICA_DRAINING
            r.begin_drain()

    def drain(self, grace_s: float = 5.0) -> bool:
        """Fleet-wide graceful drain: every replica stops admission,
        in-flight work gets the (shared) grace window."""
        self.begin_drain()
        deadline = time.perf_counter() + max(0.0, grace_s)
        drained = True
        for r in self.replicas():
            drained &= r.drain(max(0.0, deadline - time.perf_counter()))
        return drained

    def stop(self) -> None:
        self.stop_health_loop()
        for r in self.replicas():
            r.stop()
        with self._lock:
            self._replicas.clear()


def _fold_plane_counts(agg: Dict, payload: Dict) -> None:
    """Add one replica's /serving/stats ledger counts (both planes)
    into the running aggregate."""
    for plane in ("classifier", "lm"):
        section = payload.get(plane)
        if not section:
            continue
        for k in agg:
            agg[k] += int(section.get(k) or 0)


_RECONCILE_EVENTS = ("requests", "rejected", "shed", "deadline_missed")


def _reconcile_breakdowns(name: str, payload: Dict,
                          failures: List[str]) -> None:
    """Per-replica, per-plane breakdown reconciliation: every accounting site carries its priority-class and
    tenant labels along with the plane total, so within one plane the
    per-class and per-tenant ledgers must each re-add to that plane's
    own counters.  A breakdown that drifts from its total means some
    site bumped a counter without its ride-along (or vice versa) —
    exactly the bug class this check exists to catch.  The breakdown
    sections are fire-once (absent until the plane records a classed /
    tenanted event), so an absent section is vacuously balanced; a
    PRESENT section must account for everything, which is why the
    default priority class and the `default` tenant are real labels
    rather than an untracked remainder."""
    for plane in ("classifier", "lm"):
        section = payload.get(plane)
        if not section:
            continue
        for breakdown in ("priority", "tenants"):
            cells = section.get(breakdown)
            if not cells:
                continue
            for event in _RECONCILE_EVENTS:
                total = int(section.get(event) or 0)
                part = sum(int(c.get(event) or 0)
                           for c in cells.values())
                if part != total:
                    failures.append(
                        f"{name}/{plane}: sum({breakdown}.{event})="
                        f"{part} != {event}={total}")


def check_fleet_ledger(stats: Dict,
                       submitted: Optional[int] = None) -> Dict:
    """Aggregate the per-replica resilience ledgers out of a
    `fleet_stats()` payload and check the cross-layer invariants:

    - every request the fleet answered was answered by exactly ONE
      replica, so `sum(replica requests) == fleet requests` — counting
      replicas the router retired gracefully (rolling swap, scale-down:
      their final counts live in the payload's `retired` aggregate, so
      the invariant keeps holding across membership changes, not just
      for the replicas currently attached);
    - client-side (when `submitted` is passed):
      `submitted == fleet requests + fleet rejected` — a request either
      got an answer or a typed rejection, never silence.

    Replica-side `rejected`/`shed` above the fleet's own counts are the
    failovers: a replica refused or shed work that another replica then
    served.  `balanced` is only asserted when every replica's stats
    were reachable (a killed replica cannot report — `retired.lost`).

    Within each reachable replica's planes, the
    per-class (`priority`) and per-tenant (`tenants`) breakdowns must
    also re-add to the plane's own totals; any drift lands in
    `failures` (naming the replica, plane, and event) and clears
    `balanced` — the /fleet/stats front turns a non-empty `failures`
    list into a typed failure instead of serving corrupt accounting
    with a 200."""
    agg = {"requests": 0, "rejected": 0, "shed": 0, "deadline_missed": 0,
           "poison_isolated": 0}
    retired = stats.get("retired") or {}
    for k, v in (retired.get("aggregate") or {}).items():
        if k in agg:
            agg[k] += int(v or 0)
    reachable = int(retired.get("lost") or 0) == 0
    failures: List[str] = []
    for entry in stats.get("replicas", ()):
        payload = entry.get("stats")
        if payload is None:
            if entry.get("state") != REPLICA_STOPPED:
                reachable = False
            continue
        _fold_plane_counts(agg, payload)
        _reconcile_breakdowns(str(entry.get("name") or "?"), payload,
                              failures)
    fleet = stats.get("fleet", {})
    out = {"aggregate": agg, "replicas_reachable": reachable,
           "fleet_requests": int(fleet.get("requests") or 0),
           "fleet_rejected": int(fleet.get("rejected") or 0),
           "failures": failures}
    out["balanced"] = (reachable and not failures
                       and agg["requests"] == out["fleet_requests"])
    if submitted is not None:
        out["submitted"] = int(submitted)
        out["client_balanced"] = (
            int(submitted) == out["fleet_requests"] + out["fleet_rejected"])
    return out


# ---------------------------------------------------------------------------
# The fleet's own HTTP front


class _FleetHTTPServer(ServingHTTPServer):
    # restart-after-drain socket semantics (SO_REUSEADDR + daemon
    # handler threads) live on the shared base in serving/resilience.py
    pass


class _FleetHandler(ServingHTTPMixin, BaseHTTPRequestHandler):
    # _send/_json/_body/_deadline_s + the typed-failure -> status
    # mapping come from ServingHTTPMixin (serving/resilience.py), shared
    # with ui/server.py's _Handler so the two HTTP contracts cannot
    # drift.

    @property
    def router(self) -> FleetRouter:
        return self.server.fleet_router  # type: ignore[attr-defined]

    def do_GET(self) -> None:  # noqa: N802
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            # Prometheus exposition: fleet-plane serving metrics,
            # per-replica router-side gauges, breaker families
            registry = self.server.obs_registry  # type: ignore[attr-defined]
            self._send(200, EXPOSITION_CONTENT_TYPE,
                       registry.exposition().encode())
            return
        if path == "/trace/recent":
            traces = self.router.tracer.recent()
            if "format=chrome" in query:
                self._json(200, chrome_trace(traces))
            else:
                self._json(200, {"traces": traces,
                                 "recorded": self.router.tracer.recorded})
            return
        if self.path == "/healthz":
            self._json(200, {"ok": True})
        elif self.path == "/readyz":
            draining = self.server.fleet_draining  # type: ignore[attr-defined]
            if draining:
                self._json(503, {"ready": False, "reasons": ["draining"]},
                           headers={"Retry-After": 1})
            elif not self.router.has_routable():
                self._json(503, {"ready": False,
                                 "reasons": ["no routable replica"]},
                           headers={"Retry-After": 1})
            else:
                self._json(200, {"ready": True})
        elif self.path == "/fleet/stats":
            stats = self.router.fleet_stats()
            failures = (stats.get("ledger") or {}).get("failures") or []
            if failures:
                # one re-poll before declaring drift: a snapshot cut
                # between a plane counter and its breakdown ride-along
                # can be off by one for an instant; REAL drift (an
                # accounting site missing its label) survives the retry
                stats = self.router.fleet_stats()
                failures = (stats.get("ledger")
                            or {}).get("failures") or []
            if failures:
                # drifting ledger = typed failure: corrupt
                # accounting must not be served as a healthy 200 — the
                # payload rides along so the operator can see WHERE
                self._json(500, {"error": ("fleet ledger drift: "
                                           + "; ".join(failures)),
                                 "stats": stats})
            else:
                self._json(200, stats)
        elif self.path == "/serving/stats":
            # the cheap fleet-level view (no per-replica HTTP fan-out)
            self._json(200, self.router.fleet_stats(
                include_replica_stats=False))
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        try:
            body = self._body()
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
            return
        try:
            if self.server.fleet_draining:  # type: ignore[attr-defined]
                raise ServingUnavailableError(
                    "fleet is draining: admission stopped")
            self._route_post(body)
        except FleetClientError as e:
            # relay a replica's quota 429 with its Retry-After intact —
            # the bucket deficit was computed where the tokens live
            payload = {"error": str(e)}
            headers = None
            if e.retry_after_s is not None:
                payload["retry_after_s"] = e.retry_after_s
                headers = {"Retry-After": max(1, math.ceil(e.retry_after_s))}
            self._json(e.status, payload, headers=headers)
        except Exception as e:  # noqa: BLE001 — the front must keep serving; unexpected -> 500 once, typed stay 4xx/503
            # typed serving failures map via the shared mixin
            # (UnservableShapeError -> 400, DeadlineExceededError -> 504,
            # overload/unavailable -> 503 + Retry-After); a malformed
            # request (bad deadline, wrong field types) is the client's
            # 400; anything else is the fleet front's own fault: 500
            if self.respond_typed_failure(e):
                return
            if isinstance(e, (ValueError, TypeError)):
                self._json(400, {"error": str(e)})
            else:
                self._json(500, {"error": repr(e)})

    def _route_post(self, body) -> None:
        if self.path == "/model/predict":
            feats = body.get("features")
            if not feats:
                self._json(400, {"error": "features required"})
                return
            probs = self.router.predict_proba(
                feats, deadline_s=self._deadline_s(body),
                request_id=self.request_id(),
                tenant=self._tenant(body))
            self._json(200, {
                "predictions": np.argmax(probs, axis=-1).tolist(),
                "outputs": np.asarray(probs).tolist()})
        elif self.path == "/lm/generate":
            prompt = body.get("prompt_ids")
            if not prompt:
                self._json(400, {"error": "prompt_ids required"})
                return
            session_id = body.get("session_id")
            if session_id is not None:
                session_id = str(session_id)
            if bool(body.get("stream", False)):
                # SSE passthrough: relay the decode replica's event
                # stream byte for byte (TTFT reaches the client through
                # the fleet front exactly as it left the pool)
                self._relay_stream(body, session_id)
                return
            # forward the sampling mode too: silently downgrading a
            # top-k/top-p/beam request to greedy would answer 200 with
            # DIFFERENT generations than the single-server surface
            payload = self.router.generate_payload(
                prompt, int(body.get("max_new_tokens", 32)),
                temperature=float(body.get("temperature", 0.0)),
                seed=int(body.get("seed", 0)) & 0x7FFFFFFF,
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                beam_size=int(body.get("beam_size", 0)),
                deadline_s=self._deadline_s(body),
                request_id=self.request_id(),
                session_id=session_id,
                priority=body.get("priority"),
                tenant=self._tenant(body))
            self._json(200, payload)
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _relay_stream(self, body, session_id) -> None:
        """Relay one replica SSE stream through the fleet front.
        Pre-stream failures (no routable replica, 4xx) still map to
        proper statuses; once bytes flow, a replica death surfaces as a
        truncated stream — tokens the client already has cannot be
        un-sent, so there is no mid-stream failover."""
        resp = self.router.open_lm_stream(
            body.get("prompt_ids"), int(body.get("max_new_tokens", 32)),
            temperature=float(body.get("temperature", 0.0)),
            seed=int(body.get("seed", 0)) & 0x7FFFFFFF,
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            beam_size=int(body.get("beam_size", 0)),
            deadline_s=self._deadline_s(body),
            request_id=self.request_id(), session_id=session_id,
            priority=body.get("priority"), tenant=self._tenant(body))
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            rid = getattr(self, "_request_id", None)
            if rid is not None:
                self.send_header("X-Request-Id", rid)
            self.end_headers()
            try:
                while True:
                    # read1: hand over whatever bytes are available —
                    # a full read(n) would buffer events and destroy
                    # the TTFT the stream exists to surface
                    chunk = (resp.read1(512) if hasattr(resp, "read1")
                             else resp.read(512))
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    self.wfile.flush()
            except (http.client.HTTPException, OSError):
                # client went away (BrokenPipe/reset) OR the replica
                # read failed mid-stream (timeout, short read).  The
                # SSE headers are already on the wire, so the ONLY
                # valid move is to stop relaying — answering again
                # would append a second HTTP response into the
                # half-delivered event stream.  Closing resp (finally)
                # propagates the disconnect to the replica, which
                # abandons the lane.
                pass
        finally:
            resp.close()


class FleetServer:
    """The fleet's HTTP front: `FleetServer(router, port=0).start()`;
    `.url` for clients; `.drain()` for the SIGTERM path; `.stop()` to
    halt (stops the router, its health loop and every replica)."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 8080):
        self.router = router
        self._server = _FleetHTTPServer((host, port), _FleetHandler)
        self._server.fleet_router = router  # type: ignore[attr-defined]
        self._server.fleet_draining = False  # type: ignore[attr-defined]
        # the fleet front's /metrics: fleet-plane serving metrics +
        # per-replica router-side samples
        self.registry = MetricsRegistry()
        router.metrics.register_into(self.registry, plane="fleet")
        self.registry.register_collector(self._fleet_samples)
        self.registry.gauge(
            "server_uptime_seconds", "seconds since server construction",
            fn=lambda: self.registry.uptime_s)
        self._server.obs_registry = self.registry  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="fleet-front")

    def _fleet_samples(self):
        """Collector: router counters + per-replica router-side gauges
        (sampled at scrape time, no HTTP fan-out — the replicas publish
        their own planes on their own /metrics)."""
        router = self.router
        with router._lock:
            counters = (("fleet_failovers_total", "counter",
                         "failed dispatch attempts that moved on",
                         router.failovers),
                        ("fleet_swaps_total", "counter",
                         "completed rolling swaps", router.swaps),
                        ("fleet_scale_ups_total", "counter",
                         "autoscale scale-ups", router.scale_ups),
                        ("fleet_scale_downs_total", "counter",
                         "autoscale scale-downs", router.scale_downs),
                        ("fleet_health_polls_total", "counter",
                         "health sweeps", router.health_polls),
                        ("fleet_weights_version", "gauge",
                         "current rolling-swap weights version",
                         router._version),
                        ("fleet_ships_total", "counter",
                         "KV page shipments routed prefill->decode",
                         router.ships),
                        ("fleet_ship_fallbacks_total", "counter",
                         "shipments that fell back to local recompute",
                         router.ship_fallbacks),
                        ("fleet_session_spill_ships_total", "counter",
                         "sticky-session spill-overs served by shipping",
                         router.session_spill_ships),
                        ("fleet_session_affinity_hits_total", "counter",
                         "session requests routed to their previous "
                         "replica", router.session_affinity_hits))
            role_counts = dict(router._role_requests)
        from deeplearning4j_tpu_torch.serving.metrics import _BREAKER_VALUES

        for name, kind, help, value in counters:
            yield (name, kind, help, {}, float(value))
        for role, n in sorted(role_counts.items()):
            yield ("fleet_role_requests_total", "counter",
                   "successful dispatches by replica role",
                   {"role": role}, float(n))
        # per-role queue-depth gauge: the
        # autoscaler's split input, scrapeable
        for role, depth in sorted(router.queue_depth_by_role().items()):
            yield ("fleet_queue_depth", "gauge",
                   "router-side in-flight requests by replica role",
                   {"role": role}, float(depth))
        for r in router.replicas():
            labels = {"replica": r.name}
            with r.lock:
                samples = (("fleet_replica_in_flight", "gauge",
                            "router-side in-flight requests",
                            r.in_flight),
                           ("fleet_replica_dispatches_total", "counter",
                            "successful dispatches via the router",
                            r.dispatches),
                           ("fleet_replica_failures_total", "counter",
                            "replica-fault dispatch failures",
                            r.failures),
                           ("fleet_replica_ejections_total", "counter",
                            "breaker ejections", r.ejections),
                           ("fleet_replica_readmissions_total", "counter",
                            "breaker re-admissions", r.readmissions))
            for name, kind, help, value in samples:
                yield (name, kind, help, dict(labels), float(value))
            state = r.breaker.state if r.breaker is not None else "closed"
            yield ("fleet_replica_breaker_state", "gauge",
                   "replica breaker (0 closed, 1 open, 2 half_open)",
                   dict(labels), float(_BREAKER_VALUES.get(state, 0)))

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "FleetServer":
        self._thread.start()
        return self

    def begin_drain(self) -> None:
        """Stop admission at the front (new requests 503, /readyz flips)
        and on every replica; queued + in-flight work keeps running."""
        self._server.fleet_draining = True  # type: ignore[attr-defined]
        self.router.begin_drain()

    def drain(self, grace_s: float = 5.0) -> bool:
        """Fleet-wide graceful drain; the front keeps answering
        /healthz, /readyz and /fleet/stats throughout."""
        self._server.fleet_draining = True  # type: ignore[attr-defined]
        return self.router.drain(grace_s)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.router.stop()


__all__ = [
    "FleetClientError",
    "FleetRouter",
    "FleetServer",
    "REPLICA_ACTIVE",
    "REPLICA_DRAINING",
    "REPLICA_STOPPED",
    "ROLE_BOTH",
    "ROLE_DECODE",
    "ROLE_PREFILL",
    "ROLES",
    "Replica",
    "check_fleet_ledger",
    "spawn_local_replica",
]
