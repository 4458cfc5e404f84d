"""Multi-tenant traffic shaping and SLO policy for the LM pool
(counterpart of `deeplearning4j_tpu.serving.tenancy`).  Stdlib only.

- `TenantSpec` / `TenantRegistry`: the per-tenant policy record (WFQ
  weight, token-rate quota and burst, SLO latency target) and the open
  registry of them.  `TenantRegistry.normalize` is the gate: None maps
  to the built-in ``default`` tenant (unmetered, weight 1, no SLO), an
  unknown tenant is the client's ValueError (400) naming the registered
  vocabulary.
- `TokenBucketMeter`: per-tenant token buckets with tokens-in / out
  ledgers.  Admission charges the request's token cost; an empty bucket
  is a `TenantQuotaError` whose ``retry_after_s`` is the bucket's own
  refill time for the deficit.  Recent refusals mark a tenant over
  quota for victim selection.
- `FairQueueClock`: weighted-fair queuing as virtual finish times,
  ``vft = max(v_now, tenant_last_finish) + cost / weight``; the pool's
  queue sorts by ``(priority rank, vft, enqueued)``, so priority always
  dominates and with one tenant the order is the FIFO.
- `SLOTracker`: per-tenant latency windows reduced to a burn rate (the
  share of recent requests over target divided by the error budget).
  `TenantRegistry.badness` orders preemption and shed victims by
  (over quota, burn rate).

Every method that reads the clock takes ``now=``, so tests drive time.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

# the typed 429 lives in the resilience taxonomy (one
# respond_typed_failure mapping serves both HTTP fronts); re-exported
# here so tenancy callers import one module
from deeplearning4j_tpu_torch.serving.resilience import TenantQuotaError

# The built-in tenant every request without a tenant label belongs to.
# Unmetered, weight 1.0, no SLO target: pre-tenancy clients keep their
# exact admission behavior (no quota 429s, FIFO within their class).
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's policy record.

    ``weight`` is the WFQ share within a priority class (2.0 drains
    twice as fast as 1.0 when both are backlogged).  ``rate`` is the
    token-rate quota in tokens/second (0 = unmetered); ``burst`` is
    the bucket capacity (default: 4 seconds of rate, so short spikes
    ride through while sustained floods meter down to ``rate``).
    ``slo_ms`` is the per-request latency target (0 = no SLO) and
    ``slo_budget`` the tolerated fraction of requests over target —
    the denominator of the burn rate."""

    name: str
    weight: float = 1.0
    rate: float = 0.0
    burst: float = 0.0
    slo_ms: float = 0.0
    slo_budget: float = 0.05

    def __post_init__(self):
        if not self.name or not str(self.name).strip():
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got "
                f"{self.weight}")
        if self.rate < 0:
            raise ValueError(
                f"tenant {self.name!r}: rate must be >= 0 tokens/s, "
                f"got {self.rate}")
        if self.burst < 0:
            raise ValueError(
                f"tenant {self.name!r}: burst must be >= 0 tokens, "
                f"got {self.burst}")
        if self.slo_ms < 0:
            raise ValueError(
                f"tenant {self.name!r}: slo_ms must be >= 0, got "
                f"{self.slo_ms}")
        if not 0 < self.slo_budget <= 1:
            raise ValueError(
                f"tenant {self.name!r}: slo_budget must be in (0, 1], "
                f"got {self.slo_budget}")

    @property
    def capacity(self) -> float:
        """Bucket capacity in tokens: explicit burst, else 4s of rate."""
        if self.rate <= 0:
            return 0.0
        return self.burst if self.burst > 0 else 4.0 * self.rate

    @property
    def metered(self) -> bool:
        return self.rate > 0


class TenantRegistry:
    """The open tenant vocabulary plus its runtime policy state.

    Construction takes specs (or plain dicts); the built-in ``default``
    tenant is always present so a registry-less deployment and an
    empty ``-tenants {}`` behave identically.  The registry composes
    the three runtime pieces — meter, WFQ clock, SLO tracker — so the
    pool wires ONE object through admission, victim selection, and
    stats.  Mutation discipline matches the pool: admission-path calls
    run under the server's condition lock; the meter carries its own
    small lock because ledger reads come from other threads."""

    def __init__(self, specs: Optional[Iterable] = None):
        self._specs: Dict[str, TenantSpec] = {}
        self.add(TenantSpec(DEFAULT_TENANT))
        for spec in specs or ():
            self.add(spec if isinstance(spec, TenantSpec)
                     else TenantSpec(**dict(spec)))
        self.meter = TokenBucketMeter(self)
        self.wfq = FairQueueClock(self)
        self.slo = SLOTracker(self)

    @classmethod
    def from_json(cls, text: str) -> "TenantRegistry":
        """Parse the ``serve -tenants`` JSON knob:
        ``{"name": {"weight": 4, "rate": 200, "slo_ms": 250}, ...}``.
        Field validation is `TenantSpec`'s; a non-object payload or
        non-object entry is a ValueError (the CLI's SystemExit)."""
        try:
            payload = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"tenants JSON does not parse: {e}") from e
        if not isinstance(payload, dict):
            raise ValueError(
                f"tenants JSON must be an object mapping tenant name "
                f"-> spec fields, got {type(payload).__name__}")
        specs = []
        for name, fields in payload.items():
            if not isinstance(fields, dict):
                raise ValueError(
                    f"tenant {name!r}: spec must be an object, got "
                    f"{type(fields).__name__}")
            specs.append(TenantSpec(name=str(name), **fields))
        return cls(specs)

    @classmethod
    def coerce(cls, tenants) -> Optional["TenantRegistry"]:
        """The ONE constructor-argument contract every plane shares:
        None stays None (tenancy off — zero overhead), a registry
        passes through, a dict of specs or a JSON string builds one."""
        if tenants is None or isinstance(tenants, TenantRegistry):
            return tenants
        if isinstance(tenants, str):
            return cls.from_json(tenants)
        if isinstance(tenants, dict):
            return cls(TenantSpec(name=str(n), **dict(f))
                       for n, f in tenants.items())
        return cls(tenants)

    def add(self, spec: TenantSpec) -> None:
        self._specs[spec.name] = spec

    def names(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    def spec(self, tenant: str) -> TenantSpec:
        return self._specs[tenant]

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._specs

    def normalize(self, tenant: Optional[str]) -> str:
        """THE tenant-validation gate, shared by the HTTP fronts (as
        400s) and the pools (as ValueErrors).  None means the client
        sent nothing: the built-in default tenant — a pre-tenancy
        caller must keep its exact behavior, not silently inherit
        someone's quota."""
        if tenant is None:
            return DEFAULT_TENANT
        t = str(tenant)
        if t not in self._specs:
            raise ValueError(
                f"unknown tenant {t!r} (registered: "
                f"{sorted(self._specs)})")
        return t

    # ---- victim selection (brownout L3/L4 integration) --------------------

    def badness(self, tenant: str,
                now: Optional[float] = None) -> Tuple[int, float]:
        """Sort key for preemption/shed victim ordering: larger =
        worse = taken from first.  (over_quota, burn_rate) — a tenant
        currently hitting its quota outranks any burn rate, matching
        the docs table.  `now` is injectable for tests."""
        t = tenant if tenant in self._specs else DEFAULT_TENANT
        return (1 if self.meter.over_quota(t, now=now) else 0,
                self.slo.burn_rate(t))

    def compliant(self, tenant: str,
                  now: Optional[float] = None) -> bool:
        """A tenant inside its quota and not burning SLO budget.  The
        ladder's rungs must never take from a compliant tenant while a
        non-compliant one has lanes/admissions to give."""
        over, burn = self.badness(tenant, now=now)
        return not over and burn <= 1.0

    def any_offender(self, now: Optional[float] = None) -> bool:
        """True when some tenant is currently non-compliant — the
        predicate that switches the L3/L4 rungs from the global
        behavior to offender-first selection."""
        return any(not self.compliant(t, now=now) for t in self._specs)

    def stats(self) -> Dict:
        """Per-tenant policy + runtime numbers for /serving/stats
        (plain ints/floats, JSON-clean)."""
        out: Dict = {}
        for name, spec in self._specs.items():
            entry: Dict = {"weight": spec.weight}
            if spec.metered:
                entry.update({"rate": spec.rate,
                              "burst": spec.capacity})
            if spec.slo_ms > 0:
                entry.update({"slo_ms": spec.slo_ms,
                              "slo_budget": spec.slo_budget,
                              "burn_rate": round(
                                  self.slo.burn_rate(name), 3)})
            entry.update(self.meter.ledger(name))
            out[name] = entry
        return out


class TokenBucketMeter:
    """Per-tenant token buckets + tokens-in/out ledgers.

    One bucket per metered tenant: capacity = the spec's burst,
    refill = ``rate`` tokens/second, charged at admission with the
    request's token cost.  `charge` raises `TenantQuotaError` with a
    retry derived from the bucket's own refill — the seconds until the
    deficit refills at ``rate``, so the 429's Retry-After is honest by
    construction.  Thread-safe under its own lock (the LM pool charges
    under the server lock; ledgers are read from other threads)."""

    def __init__(self, registry: TenantRegistry):
        self._registry = registry
        self._lock = threading.Lock()
        self._tokens: Dict[str, float] = {}
        self._stamp: Dict[str, float] = {}
        self._throttled_at: Dict[str, float] = {}
        # ledgers: admitted token cost in, generated/served tokens out,
        # admissions and quota refusals — per tenant
        self.tokens_in: Dict[str, int] = collections.defaultdict(int)
        self.tokens_out: Dict[str, int] = collections.defaultdict(int)
        self.admitted: Dict[str, int] = collections.defaultdict(int)
        self.throttled: Dict[str, int] = collections.defaultdict(int)

    def _refill_locked(self, tenant: str, spec: TenantSpec,
                       now: float) -> float:
        cap = spec.capacity
        tokens = self._tokens.get(tenant, cap)
        last = self._stamp.get(tenant, now)
        tokens = min(cap, tokens + (now - last) * spec.rate)
        self._tokens[tenant] = tokens
        self._stamp[tenant] = now
        return tokens

    def charge(self, tenant: str, cost: int,
               now: Optional[float] = None) -> None:
        """Admit `cost` tokens for `tenant` or raise `TenantQuotaError`
        whose retry_after_s is the bucket's own refill time for the
        deficit.  Unmetered tenants always pass (ledgers still count)."""
        now = time.monotonic() if now is None else now
        cost = max(1, int(cost))
        spec = self._registry.spec(
            tenant if tenant in self._registry else DEFAULT_TENANT)
        with self._lock:
            if not spec.metered:
                self.tokens_in[tenant] += cost
                self.admitted[tenant] += 1
                return
            tokens = self._refill_locked(tenant, spec, now)
            if tokens >= cost:
                self._tokens[tenant] = tokens - cost
                self.tokens_in[tenant] += cost
                self.admitted[tenant] += 1
                return
            self.throttled[tenant] += 1
            self._throttled_at[tenant] = now
            deficit = cost - tokens
            retry = deficit / spec.rate
        raise TenantQuotaError(
            f"tenant {tenant!r} over token-rate quota: {cost} tokens "
            f"requested, {tokens:.0f} in the bucket (rate "
            f"{spec.rate:g}/s); retry in {retry:.2f}s",
            retry_after_s=retry)

    def record_out(self, tenant: str, n: int) -> None:
        with self._lock:
            self.tokens_out[tenant] += int(n)

    def over_quota(self, tenant: str,
                   window_s: float = 5.0,
                   now: Optional[float] = None) -> bool:
        """True when `tenant` was refused for quota within `window_s`
        (or its bucket is currently empty) — the offender signal the
        ladder's victim selection reads.  Unmetered tenants are never
        over quota."""
        spec = self._registry.spec(
            tenant if tenant in self._registry else DEFAULT_TENANT)
        if not spec.metered:
            return False
        now = time.monotonic() if now is None else now
        with self._lock:
            at = self._throttled_at.get(tenant)
            if at is not None and now - at <= window_s:
                return True
            return self._refill_locked(tenant, spec, now) < 1.0

    def ledger(self, tenant: str) -> Dict:
        with self._lock:
            return {"tokens_in": self.tokens_in.get(tenant, 0),
                    "tokens_out": self.tokens_out.get(tenant, 0),
                    "admitted": self.admitted.get(tenant, 0),
                    "throttled": self.throttled.get(tenant, 0)}


class FairQueueClock:
    """Weighted-fair queuing as virtual finish times.

    `stamp(tenant, cost)` returns the request's vft; the queue sorts
    by (priority rank, vft, enqueued).  `advance(vft)` moves the
    virtual clock when the pool services a request, so a tenant idle
    for a while re-enters at v_now instead of with banked credit.
    Single-mutator: the pool calls both under its condition lock."""

    def __init__(self, registry: TenantRegistry):
        self._registry = registry
        self.vclock = 0.0
        self._last_finish: Dict[str, float] = {}
        self.stamps = 0

    def stamp(self, tenant: str, cost: int) -> float:
        spec = self._registry.spec(
            tenant if tenant in self._registry else DEFAULT_TENANT)
        start = max(self.vclock, self._last_finish.get(tenant, 0.0))
        vft = start + max(1, int(cost)) / spec.weight
        self._last_finish[tenant] = vft
        self.stamps += 1
        return vft

    def advance(self, vft: float) -> None:
        if vft > self.vclock:
            self.vclock = vft


class SLOTracker:
    """Per-tenant latency windows -> SLO burn rate.

    `record(tenant, latency_s)` appends to a bounded window;
    `burn_rate(tenant)` is the window's over-target fraction divided
    by the spec's error budget.  0.0 for tenants without an SLO (they
    cannot be selected as burn-rate victims — only quota makes them
    offenders).  Single-mutator like the clock (pool lock)."""

    def __init__(self, registry: TenantRegistry, window: int = 256):
        self._registry = registry
        self._window = int(window)
        self._lat: Dict[str, collections.deque] = {}

    def record(self, tenant: str, latency_s: float) -> None:
        dq = self._lat.get(tenant)
        if dq is None:
            dq = self._lat[tenant] = collections.deque(
                maxlen=self._window)
        dq.append(float(latency_s))

    def burn_rate(self, tenant: str) -> float:
        spec = self._registry.spec(
            tenant if tenant in self._registry else DEFAULT_TENANT)
        if spec.slo_ms <= 0:
            return 0.0
        dq = self._lat.get(tenant)
        if not dq:
            return 0.0
        target = spec.slo_ms / 1e3
        over = sum(1 for v in dq if v > target)
        return (over / len(dq)) / spec.slo_budget


__all__ = [
    "DEFAULT_TENANT",
    "FairQueueClock",
    "SLOTracker",
    "TenantQuotaError",
    "TenantRegistry",
    "TenantSpec",
    "TokenBucketMeter",
]
