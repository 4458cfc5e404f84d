"""Serving-plane typed failures, the circuit breaker and the shared HTTP
mechanics (counterpart of `deeplearning4j_tpu.serving.resilience`).

Every way a request can fail for a reason that is not the client's
payload gets a typed exception the HTTP layer maps to its status code
(`ServingHTTPMixin.respond_typed_failure`): overload, an open breaker
and draining are 503 with ``Retry-After``, a tenant over its quota is
429 with ``Retry-After`` from its bucket's refill, a missed deadline is
504, an unservable shape 400.  Payload errors stay ``ValueError`` (400).
`CircuitBreaker` turns "every dispatch is failing" into fast 503s
instead of a queue of doomed work.  Stdlib only.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Callable, Optional


class ServingError(RuntimeError):
    """Base class for serving-plane failures that are the *server's*
    condition, not the request payload (those stay ValueError -> 400)."""


class ServingOverloadError(ServingError):
    """Admission refused: the queue is at `max_queue_depth`.  Maps to
    HTTP 503 with a `Retry-After` hint — the client should back off,
    not the server buffer unboundedly."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class CircuitOpenError(ServingOverloadError):
    """Admission refused because the circuit breaker is open: recent
    dispatches failed wholesale, so queueing more work only builds a
    backlog of doomed requests.  503 + Retry-After(remaining cooldown)."""


class ServingUnavailableError(ServingError):
    """The serving worker is stopped or draining — the request was (or
    would be) abandoned without dispatch.  503: a load balancer should
    route elsewhere."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class TenantQuotaError(ServingError):
    """Admission refused because the request's TENANT is over its
    token-rate quota — raised by the tenancy meter BEFORE
    the shared admission gate, so one flooding tenant's refusals never
    consume the queue bound every tenant shares.  Maps to HTTP 429 +
    Retry-After; ``retry_after_s`` is derived from the tenant's own
    token-bucket refill (deficit / rate), never a constant — a client
    backing off exactly as told finds tokens waiting.  Distinct from
    `ServingOverloadError` (503) on purpose: 503 means the SERVER is
    out of capacity (retry elsewhere), 429 means THIS CLIENT is out of
    budget (slow down — a failover retry would be refused identically
    on every replica sharing the registry)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceededError(ServingError, TimeoutError):
    """The request's deadline passed before (or while) it could be
    served; expired work is shed *before* dispatch so timed-out clients
    stop costing device time.  Subclasses TimeoutError so existing
    ``except TimeoutError`` clients keep working; HTTP maps it to 504."""


class UnservableShapeError(ServingError, ValueError):
    """The request's dispatch shape falls outside the warmed bucket
    ladder (the compile-count guard refused to mint program #N+1).  This
    is the *client's* payload shape, not a server fault, so it also
    subclasses ValueError and the HTTP layer maps it to 400 — never a
    500.  Replaces the untyped ``RuntimeError`` the guard used to raise
    (``ServingError`` keeps it a RuntimeError subclass for
    backward-compatible ``except`` clauses)."""


# Breaker states (the closed vocabulary /serving/stats and tests use):
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure circuit breaker for the dispatch path.

    - CLOSED: dispatches flow; `failure_threshold` *consecutive*
      whole-dispatch failures trip it OPEN.
    - OPEN: admission fast-fails (`CircuitOpenError`) and `/readyz`
      reports not-ready; after `cooldown_s` the next dispatch attempt
      is admitted as the half-open probe.
    - HALF_OPEN: exactly one probe dispatch is in flight; its success
      closes the breaker, its failure re-opens it (fresh cooldown).

    Thread-safe; `clock` is injectable so tests drive the cooldown
    without wall-clock sleeps.  `on_transition(state)` fires on every
    state change (the metrics hook).
    """

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str], None]] = None):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got "
                             f"{failure_threshold}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._listeners = [] if on_transition is None else [on_transition]
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._opens = 0

    # ---- internal ---------------------------------------------------------

    def add_listener(self, fn: Callable[[str], None]) -> None:
        """Subscribe to state transitions (idempotent per callable) —
        how the serving metrics mirror `breaker_state` without claiming
        exclusive ownership of a caller-supplied breaker."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def _set_state_locked(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        if state == BREAKER_OPEN:
            self._opens += 1
        for fn in self._listeners:
            fn(state)

    # ---- reading ----------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            # the cooldown elapsing IS the open -> half-open transition;
            # commit it here (firing on_transition) so readiness and the
            # stats ledger agree without waiting for the next dispatch
            if (self._state == BREAKER_OPEN
                    and self._clock() - self._opened_at >= self.cooldown_s):
                self._set_state_locked(BREAKER_HALF_OPEN)
            return self._state

    @property
    def opens(self) -> int:
        """How many times the breaker has tripped open (monotonic)."""
        with self._lock:
            return self._opens

    def retry_after_s(self) -> float:
        """Remaining cooldown (>= a small floor) — the Retry-After hint."""
        with self._lock:
            if self._state != BREAKER_OPEN:
                return 0.05
            remaining = self.cooldown_s - (self._clock() - self._opened_at)
            return max(0.05, remaining)

    # ---- admission / dispatch gates ---------------------------------------

    def rejecting(self) -> bool:
        """True while admission should fast-fail: OPEN inside the
        cooldown window.  After the cooldown, admission resumes so a
        queued request can become the half-open probe."""
        with self._lock:
            return (self._state == BREAKER_OPEN
                    and self._clock() - self._opened_at < self.cooldown_s)

    def allow_dispatch(self) -> bool:
        """Gate one dispatch attempt.  CLOSED: always.  OPEN: only once
        the cooldown elapsed, transitioning to HALF_OPEN and claiming
        the probe.  HALF_OPEN: only if no probe is already in flight."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self._set_state_locked(BREAKER_HALF_OPEN)
                self._probe_in_flight = True
                return True
            # HALF_OPEN
            if self._probe_in_flight:
                return False
            self._probe_in_flight = True
            return True

    def abandon_probe(self) -> None:
        """Release a probe claim WITHOUT a verdict: the probed target
        answered alive-but-unavailable (503 draining/overload, 504
        deadline) — neither re-admission evidence nor a fault.  Keeps
        the half-open window open for the next probe instead of wedging
        it shut behind an in-flight claim that will never resolve."""
        with self._lock:
            self._probe_in_flight = False

    # ---- outcome recording ------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probe_in_flight = False
            self._set_state_locked(BREAKER_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            probe_failed = self._state == BREAKER_HALF_OPEN
            if probe_failed or self._consecutive >= self.failure_threshold:
                self._probe_in_flight = False
                self._opened_at = self._clock()
                # re-opening from HALF_OPEN must count as a fresh open
                if self._state == BREAKER_HALF_OPEN:
                    self._state = BREAKER_CLOSED  # force the transition
                self._set_state_locked(BREAKER_OPEN)


def check_admission(*, accepting: bool,
                    breaker: Optional[CircuitBreaker] = None,
                    queue_depth: int, max_queue_depth: Optional[int],
                    metrics, retry_after_s: Callable[[], float],
                    what: str = "serving") -> None:
    """THE admission gate of `ContinuousLMServer` (call with the
    owner's lock held).
    Checks in blast-radius order — draining, breaker, queue bound —
    raising the matching typed error and counting the rejection.
    `retry_after_s` is a thunk so the backlog estimate is only computed
    when a rejection actually happens."""
    if not accepting:
        metrics.record_rejected()
        raise ServingUnavailableError(
            f"{what} is draining: admission stopped")
    if breaker is not None and breaker.rejecting():
        metrics.record_rejected()
        raise CircuitOpenError(
            f"circuit breaker open: recent {what} dispatches failed "
            f"wholesale; backing off",
            retry_after_s=breaker.retry_after_s())
    if max_queue_depth is not None and queue_depth >= max_queue_depth:
        metrics.record_rejected()
        raise ServingOverloadError(
            f"{what} queue full ({queue_depth} >= max_queue_depth "
            f"{max_queue_depth})",
            retry_after_s=retry_after_s())


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with restart-after-drain semantics made
    explicit (`ui/server.py`'s `_UiHTTPServer`): SO_REUSEADDR so a drained-and-stopped server's port can be re-bound
    by its replacement immediately (the rolling-swap / restart path must
    not wait out TIME_WAIT), and daemon handler threads so a wedged
    client connection cannot hold the process open.  The listen backlog
    is 128 connections, not socketserver's 5: a burst of concurrent
    clients (a fleet front under a storm of 32, the router's fan-out to
    a replica) must queue for a handler thread, not be reset."""

    allow_reuse_address = True
    daemon_threads = True
    request_queue_size = 128


class ServingHTTPMixin:
    """Shared HTTP mechanics of the serving front — `ui/server.py`'s
    `_Handler` mixes this into its `BaseHTTPRequestHandler`.  One copy
    of the JSON response plumbing, the `X-Request-Id` round trip, the
    `deadline_ms`/`X-Deadline-Ms` deadline parse, the tenant parse, and
    the typed-failure -> status mapping this module's taxonomy promises:
    a new typed error added here is mapped once, in
    `respond_typed_failure`.

    Stays stdlib-only (json/math) like the rest of the module; the
    handler attributes used (`send_response`, `send_header`,
    `end_headers`, `wfile`, `rfile`, `headers`) are
    `BaseHTTPRequestHandler`'s."""

    def log_message(self, fmt, *args):  # noqa: D102 — silence stderr
        pass

    def request_id(self) -> str:
        """The request's ``X-Request-Id``: taken from the incoming
        header when the client (or an upstream router) set one,
        minted otherwise.  Stored so `_send` echoes it on the response —
        the client always learns the id its trace is filed under."""
        rid = getattr(self, "_request_id", None)
        if rid is None:
            rid = self.headers.get("X-Request-Id")
            if not rid:
                from deeplearning4j_tpu_torch.obs.trace import new_request_id

                rid = new_request_id()
            self._request_id = str(rid)[:64]
        return self._request_id

    def _send(self, code: int, ctype: str, data: bytes,
              headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        rid = getattr(self, "_request_id", None)
        if rid is not None:
            self.send_header("X-Request-Id", rid)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, code: int, payload,
              headers: Optional[dict] = None) -> None:
        self._send(code, "application/json", json.dumps(payload).encode(),
                   headers=headers)

    def _body(self):
        """Parse the JSON request body ({} when empty).  Raises
        ValueError/JSONDecodeError on malformed JSON — the caller maps
        it to 400."""
        length = int(self.headers.get("Content-Length", 0))
        if not length:
            return {}
        return json.loads(self.rfile.read(length))

    def _deadline_s(self, body) -> Optional[float]:
        """Per-request deadline from the `deadline_ms` body field or the
        `X-Deadline-Ms` header (body wins); None = no deadline.  A
        malformed value is a client error (ValueError -> 400)."""
        raw = None
        if isinstance(body, dict) and body.get("deadline_ms") is not None:
            raw = body["deadline_ms"]
        elif self.headers.get("X-Deadline-Ms"):
            raw = self.headers["X-Deadline-Ms"]
        if raw is None:
            return None
        ms = float(raw)
        if not math.isfinite(ms) or ms <= 0:
            raise ValueError(f"deadline_ms must be a positive finite "
                             f"number of milliseconds, got {raw!r}")
        return ms / 1e3

    def _tenant(self, body) -> Optional[str]:
        """Per-request tenant identity: the JSON ``tenant`` field
        wins, the ``X-Tenant`` header is the no-body-change fallback.
        Returns None when the client named no tenant (-> the default
        tenant downstream); a malformed value is the client's 400.
        UNKNOWN-tenant validation happens against the serving plane's
        registry (`TenantRegistry.normalize`), so the 400 names the
        registered vocabulary."""
        tn = body.get("tenant") if isinstance(body, dict) else None
        if tn is None:
            tn = self.headers.get("X-Tenant")
        if tn is None:
            return None
        if not isinstance(tn, (str, int)):
            raise ValueError(
                f"tenant must be a string, got {type(tn).__name__}")
        tn = str(tn)
        if not 0 < len(tn) <= 128:
            raise ValueError("tenant must be 1..128 characters")
        return tn

    def respond_typed_failure(self, e: BaseException) -> bool:
        """Map this module's typed serving failures to their promised
        status codes and answer the request; returns False (no response
        written) for anything else so the caller applies its own
        fallback policy.  Order matters: `UnservableShapeError` is a
        ValueError and `DeadlineExceededError` a TimeoutError, so they
        are matched before any broader clauses a caller might add."""
        if isinstance(e, UnservableShapeError):
            # the request's shape falls outside the warmed bucket ladder
            # — the client's payload, not a server fault: 400, never 500
            self._json(400, {"error": str(e)})
            return True
        if isinstance(e, DeadlineExceededError):
            # the request's deadline passed before it could be served
            self._json(504, {"error": str(e)})
            return True
        if isinstance(e, TenantQuotaError):
            # the request's TENANT is over its token-rate quota: 429 +
            # Retry-After from the bucket's own refill —
            # matched before the 503 clause because this is the
            # client's budget, not the server's capacity
            retry_after = max(1, math.ceil(
                getattr(e, "retry_after_s", 1.0)))
            self._json(429, {"error": str(e),
                             "retry_after_s": retry_after},
                       headers={"Retry-After": retry_after})
            return True
        if isinstance(e, (ServingOverloadError, ServingUnavailableError)):
            # admission refused (queue full / breaker open / draining):
            # 503 + Retry-After so well-behaved clients back off
            retry_after = max(1, math.ceil(
                getattr(e, "retry_after_s", 1.0)))
            self._json(503, {"error": str(e),
                             "retry_after_s": retry_after},
                       headers={"Retry-After": retry_after})
            return True
        return False


__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "CircuitBreaker",
    "CircuitOpenError",
    "DeadlineExceededError",
    "ServingError",
    "ServingHTTPMixin",
    "ServingHTTPServer",
    "ServingOverloadError",
    "ServingUnavailableError",
    "TenantQuotaError",
    "UnservableShapeError",
    "check_admission",
]
