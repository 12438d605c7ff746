"""One retry policy for the data plane, and the per-peer circuit breaker
every client funnel consults (the port's copy of
`seaweedfs_tpu/util/retry.py`).

* **retry_call**: capped exponential backoff with full jitter (delay ~
  U(0, min(cap, base * 2^(attempt-1)))), only for idempotent work (the
  caller declares it), each re-issue drawing one token of a per-process
  **retry budget**, so a dying dependency costs bounded extra load.  An
  attempt whose backoff would outlive the request's deadline is refused
  (`util/deadline`): the caller gets the budget verdict at once.

* **per-peer circuit breaker**: `breaker_threshold()` consecutive
  transport failures open a peer (calls fail fast with BreakerOpen);
  after `breaker_cooldown()` one half-open probe is let through, and its
  verdict closes or re-opens the breaker.  The pooled HTTP client, the
  shell's scatter planner (`peer_available`) and the EC reader consult it.

Knobs (env, read at each call; the breaker's defaults are the module's
`BREAKER_THRESHOLD` and `BREAKER_COOLDOWN`):

  SEAWEEDFS_TPU_RETRY_MAX_ATTEMPTS   total attempts per call (3)
  SEAWEEDFS_TPU_RETRY_BASE_MS        first backoff ceiling (50)
  SEAWEEDFS_TPU_RETRY_CAP_MS         backoff ceiling (2000)
  SEAWEEDFS_TPU_RETRY_BUDGET         retry-token bucket size (64)
  SEAWEEDFS_TPU_RETRY_BUDGET_REFILL  tokens refilled per second (4)
  SEAWEEDFS_TPU_BREAKER_THRESHOLD    consecutive failures to trip (5)
  SEAWEEDFS_TPU_BREAKER_COOLDOWN_MS  open time before a probe (2000)

Metrics in `stats.PROCESS`: `retry_attempts_total{site}`,
`retry_budget_remaining`, `retry_budget_exhausted_total`,
`peer_breaker_state{peer}`, `peer_breaker_trips_total{peer}`; each
retry's backoff is a `retry.<site>` span on the active trace.  The
budget and the breakers are per process.
"""

from __future__ import annotations

import os
import random
import threading
import time

from . import wlog

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

BREAKER_THRESHOLD = 5
BREAKER_COOLDOWN = 2.0


class BreakerOpen(OSError):
    """Fail-fast refusal: the peer's breaker is open.  An OSError, so
    transport-failure handling applies; catch it to re-plan instead."""

    def __init__(self, peer: str, retry_after: float):
        super().__init__(f"breaker open for peer {peer} "
                         f"(retry in {retry_after:.1f}s)")
        self.peer = peer
        self.retry_after = retry_after


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def max_attempts() -> int:
    return max(1, _env_int("SEAWEEDFS_TPU_RETRY_MAX_ATTEMPTS", 3))


def backoff_base() -> float:
    return _env_float("SEAWEEDFS_TPU_RETRY_BASE_MS", 50.0) / 1e3


def backoff_cap() -> float:
    return _env_float("SEAWEEDFS_TPU_RETRY_CAP_MS", 2000.0) / 1e3


def breaker_threshold() -> int:
    return max(1, _env_int("SEAWEEDFS_TPU_BREAKER_THRESHOLD",
                           BREAKER_THRESHOLD))


def breaker_cooldown() -> float:
    return _env_float("SEAWEEDFS_TPU_BREAKER_COOLDOWN_MS",
                      BREAKER_COOLDOWN * 1e3) / 1e3


def backoff_delay(attempt: int, base: "float | None" = None,
                  cap: "float | None" = None,
                  rng: "random.Random | None" = None) -> float:
    """Full-jitter delay before retry number `attempt` (1-based)."""
    base = backoff_base() if base is None else base
    cap = backoff_cap() if cap is None else cap
    ceiling = min(cap, base * (2 ** max(attempt - 1, 0)))
    return (rng or random).uniform(0, ceiling)


# -- the per-process retry budget (a token bucket) --------------------------

class _Budget:
    def __init__(self):
        self._lock = threading.Lock()
        self._tokens: "float | None" = None
        self._stamp = 0.0

    def _capacity(self) -> float:
        return float(max(0, _env_int("SEAWEEDFS_TPU_RETRY_BUDGET", 64)))

    def _refill_rate(self) -> float:
        return max(0.0,
                   _env_float("SEAWEEDFS_TPU_RETRY_BUDGET_REFILL", 4.0))

    def take(self) -> bool:
        now = time.monotonic()
        cap = self._capacity()
        with self._lock:
            if self._tokens is None:
                self._tokens = cap
            else:
                self._tokens = min(
                    cap, self._tokens +
                    (now - self._stamp) * self._refill_rate())
            self._stamp = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def remaining(self) -> float:
        with self._lock:
            return self._capacity() if self._tokens is None \
                else self._tokens

    def reset(self) -> None:
        with self._lock:
            self._tokens = None
            self._stamp = 0.0


_budget = _Budget()


def budget_take() -> bool:
    ok = _budget.take()
    if not ok:
        _metrics().counter_add(
            "retry_budget_exhausted_total", 1.0,
            help_text="retries refused by the process retry budget")
    _metrics().gauge_set(
        "retry_budget_remaining", _budget.remaining(),
        help_text="retry tokens left in the process budget")
    return ok


def budget_remaining() -> float:
    return _budget.remaining()


# -- the per-peer circuit breaker --------------------------------------------

class _Breaker:
    __slots__ = ("state", "failures", "opened_at", "probing",
                 "probe_started", "trips", "last_error")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.probing = False
        self.probe_started = 0.0
        self.trips = 0
        self.last_error = ""


_breakers: "dict[str, _Breaker]" = {}
_lock = threading.Lock()


def _gauge_state(peer: str, state: str) -> None:
    _metrics().gauge_set(
        "peer_breaker_state", _STATE_GAUGE[state],
        help_text="per-peer circuit state (0 closed, 1 half-open, "
                  "2 open)", peer=peer)


def _probe_ttl() -> float:
    """How long a half-open probe may stay unresolved before another
    caller reclaims its slot."""
    return max(breaker_cooldown() * 2, 120.0)


def check_peer(peer: str) -> None:
    """Raise BreakerOpen while the peer is open with cooldown left; past
    the cooldown admit this caller as the one half-open probe.  A no-op
    for closed or unknown peers."""
    if not peer:
        return
    transitioned = False
    with _lock:
        b = _breakers.get(peer)
        if b is None or b.state == CLOSED:
            return
        now = time.monotonic()
        if b.state == OPEN:
            wait = b.opened_at + breaker_cooldown() - now
            if wait > 0:
                raise BreakerOpen(peer, wait)
            b.state = HALF_OPEN
            b.probing, b.probe_started = True, now
            transitioned = True
        elif b.probing:
            # one probe at a time; a probe whose caller vanished without
            # a verdict is reclaimed after the TTL
            if now - b.probe_started <= _probe_ttl():
                raise BreakerOpen(peer, breaker_cooldown())
            b.probe_started = now
        else:
            b.probing, b.probe_started = True, now
    if transitioned:
        _gauge_state(peer, HALF_OPEN)


def probe_release(peer: str) -> None:
    """Give back a half-open probe slot without a verdict: the call
    failed for a reason that says nothing of the peer."""
    if not peer:
        return
    with _lock:
        b = _breakers.get(peer)
        if b is not None and b.probing:
            b.probing = False


def record_success(peer: str) -> None:
    if not peer:
        return
    with _lock:
        b = _breakers.get(peer)
        if b is None:
            return
        changed = b.state != CLOSED
        b.state, b.failures, b.probing, b.last_error = CLOSED, 0, False, ""
    if changed:
        _gauge_state(peer, CLOSED)


def record_failure(peer: str, error: str = "") -> None:
    """One transport failure.  The breaker opens at the threshold, and a
    failure once the cooldown has passed (a failed probe) opens it for
    another cooldown."""
    if not peer:
        return
    tripped = None
    with _lock:
        b = _breakers.setdefault(peer, _Breaker())
        b.failures += 1
        b.probing = False
        if error:
            b.last_error = error[:200]
        now = time.monotonic()
        probe_failed = b.state == HALF_OPEN or (
            b.state == OPEN and now >= b.opened_at + breaker_cooldown())
        if probe_failed or b.failures >= breaker_threshold():
            if b.state != OPEN or probe_failed:
                b.trips += 1
                tripped = (b.failures, b.last_error)
            b.state, b.opened_at = OPEN, now
    if tripped is not None:
        _gauge_state(peer, OPEN)
        _metrics().counter_add(
            "peer_breaker_trips_total", 1.0,
            help_text="breaker close->open transitions", peer=peer)
        wlog.warning(f"peer breaker OPEN for {peer} after {tripped[0]} "
                     f"consecutive failures"
                     + (f" (last: {tripped[1]})" if tripped[1] else ""))


def peer_state(peer: str) -> str:
    with _lock:
        b = _breakers.get(peer)
        if b is None:
            return CLOSED
        if b.state == OPEN and \
                time.monotonic() >= b.opened_at + breaker_cooldown():
            return HALF_OPEN  # a probe would be admitted
        return b.state


def peer_available(peer: str) -> bool:
    """False only while the peer's breaker is open with cooldown left
    (a half-open peer is worth a probe)."""
    return peer_state(peer) != OPEN


def health_snapshot() -> "dict[str, dict]":
    """Every peer whose breaker is not closed, or has tripped or failed,
    for `GET /debug/health`."""
    with _lock:
        peers = {p: (b.failures, b.trips, b.last_error)
                 for p, b in _breakers.items()
                 if b.state != CLOSED or b.failures or b.trips}
    return {p: {"state": peer_state(p), "consecutiveFailures": n,
                "trips": trips, "lastError": err}
            for p, (n, trips, err) in sorted(peers.items())}


def reset(peer: "str | None" = None) -> None:
    """Forget breaker state, and refill the budget when `peer` is None."""
    with _lock:
        if peer is None:
            _breakers.clear()
        else:
            _breakers.pop(peer, None)
    if peer is None:
        _budget.reset()


# -- the one retry loop --------------------------------------------------------

def _metrics():
    from .. import stats
    return stats.PROCESS


def _note_retry(site: str, peer: str, attempt: int, error: str,
                delay: float) -> None:
    _metrics().counter_add(
        "retry_attempts_total", 1.0,
        help_text="re-issued attempts after a transport failure",
        site=site or "?")
    from .. import tracing
    tracing.emit_span(
        f"retry.{site or 'call'}", time.time(), delay,
        attrs={"attempt": attempt, "peer": peer, "error": error[:160]})


def _deterministic(e: BaseException) -> bool:
    """A failure that a re-issue cannot change: a TLS certificate
    verdict (configuration, not weather)."""
    import ssl
    return isinstance(e, ssl.SSLCertVerificationError)


def retry_call(fn, site: str = "", peer: str = "",
               idempotent: bool = True, attempts: "int | None" = None,
               base: "float | None" = None, cap: "float | None" = None,
               retry_on: tuple = (OSError,)):
    """Run `fn()` under the policy: the peer's breaker before every
    attempt (BreakerOpen is raised, never retried), each transport
    outcome recorded, and only idempotent work re-issued, one budget
    token a re-issue.  A spent deadline is raised as DeadlineExceeded
    and never charged to the peer; a retry whose backoff plus the least
    useful timeout would outlive the deadline is refused the same way.
    `fn` must be safe to call `attempts` times."""
    from . import deadline as _deadline
    attempts = max_attempts() if attempts is None else max(1, attempts)
    last: "BaseException | None" = None
    for attempt in range(1, attempts + 1):
        check_peer(peer)
        try:
            result = fn()
        except BreakerOpen:
            raise
        except _deadline.DeadlineExceeded:
            probe_release(peer)
            raise
        except retry_on as e:
            if _deterministic(e):
                probe_release(peer)
                raise
            rem0 = _deadline.remaining()
            if rem0 is not None and rem0 <= 0.0:
                # the attempt lost to the budget, whose cap set its
                # socket timeout: no verdict on the peer
                probe_release(peer)
                _deadline.note_exceeded(site or "retry")
                raise _deadline.DeadlineExceeded(site or "retry") from e
            record_failure(peer, repr(e))
            last = e
            if not idempotent or attempt >= attempts:
                raise
            delay = backoff_delay(attempt, base, cap)
            rem = _deadline.remaining()
            if rem is not None and delay + _deadline.MIN_TIMEOUT > rem:
                # a doomed attempt: no budget would be left to dial
                _deadline.note_exceeded(site or "retry")
                raise _deadline.DeadlineExceeded(site or "retry") from e
            if not budget_take():
                raise
            _note_retry(site, peer, attempt, repr(e), delay)
            time.sleep(delay)
            continue
        except BaseException:
            # not a transport failure: no verdict, but a held probe
            # slot goes back
            probe_release(peer)
            raise
        record_success(peer)
        return result
    raise last  # pragma: no cover — the loop returns or raises
