"""Per-request deadlines: one budget across every hop (the port's copy of
`seaweedfs_tpu/util/deadline.py`).

A slow or wedged peer must cost a request its budget, not each hop's own
fixed timeout.  The vocabulary:

* a `Deadline` (a monotonic expiry) rides a contextvar, set at the HTTP
  server's ingress (`server/httpd.py`) from the caller's
  `X-Weed-Deadline-Ms` header (the milliseconds left when the request
  was sent) or the operator default `SEAWEEDFS_TPU_DEADLINE_DEFAULT_MS`
  (0, the default: no deadline unless the caller sends one);
* every outbound hop forwards the remaining budget in the same header
  (`stamp_headers`, applied by the port's HTTP client) and derives its
  socket timeout from it (`io_timeout`), so the budget only shrinks
  from hop to hop;
* a spent budget fails fast: `io_timeout` raises `DeadlineExceeded` (an
  OSError, so transport-failure handling applies) before the dial, and
  the server answers 504 with `Retry-After` before its handler runs.

Contextvars do not follow worker threads: code that fans a request out
onto threads captures `get()` and re-binds it there with `use(...)`, as
it re-binds the request's stage track with `profiling.use_track`.

Metrics on `stats.PROCESS`: `deadline_exceeded_total{site}` counts each
fail-fast, `deadline_remaining_seconds{site}` is the budget left at each
ingress (a shrinking profile from hop to hop is the plane working).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
import time

from .. import stats

# remaining budget in whole milliseconds when the request left the
# sender (the only clock both ends share is a duration)
HEADER = "X-Weed-Deadline-Ms"

# the least useful socket timeout: a derived timeout is floored here
MIN_TIMEOUT = 0.05


class DeadlineExceeded(OSError):
    """The request's budget is spent.  An OSError so that transport
    failure handling applies; a retry can never change the verdict, as
    a budget only shrinks."""

    def __init__(self, site: str = ""):
        super().__init__(
            f"request deadline exceeded{f' at {site}' if site else ''}")
        self.site = site


class Deadline:
    """A monotonic expiry; `budget` keeps the grant at ingress."""

    __slots__ = ("expires_at", "budget")

    def __init__(self, budget_s: float):
        self.budget = max(float(budget_s), 0.0)
        self.expires_at = time.monotonic() + self.budget

    def remaining(self) -> float:
        return max(0.0, self.expires_at - time.monotonic())

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def header_value(self) -> str:
        """The remaining budget as the header's value, whole ms rounded
        down: the receiver never thinks it has more time than the
        sender."""
        return str(int(self.remaining() * 1e3))


_current: "contextvars.ContextVar[Deadline | None]" = \
    contextvars.ContextVar("weed_deadline", default=None)


def get() -> "Deadline | None":
    return _current.get()


def remaining() -> "float | None":
    """Seconds left, or None when no deadline is armed."""
    d = _current.get()
    return None if d is None else d.remaining()


@contextlib.contextmanager
def use(deadline: "Deadline | None"):
    """Bind a captured deadline on another thread (a fan-out's workers).
    Always sets, None included: a pooled thread would otherwise keep
    the previous request's deadline."""
    token = _current.set(deadline)
    try:
        yield deadline
    finally:
        _current.reset(token)


@contextlib.contextmanager
def scope(budget_s: float):
    """A fresh deadline for a local operation (tests, tools)."""
    token = _current.set(Deadline(budget_s))
    try:
        yield _current.get()
    finally:
        _current.reset(token)


def default_budget() -> float:
    """The budget ingress grants a request that brought none, in seconds
    (`SEAWEEDFS_TPU_DEADLINE_DEFAULT_MS`; 0, the default, grants none)."""
    try:
        ms = float(os.environ.get(
            "SEAWEEDFS_TPU_DEADLINE_DEFAULT_MS", "") or 0.0)
    except ValueError:
        ms = 0.0
    if not math.isfinite(ms):
        ms = 0.0
    return max(ms, 0.0) / 1e3


def parse_header(value: "str | None") -> "Deadline | None":
    """The header's value as a Deadline; None when it is absent or
    malformed (the request then runs without one).  A negative budget
    is a spent one."""
    if not value:
        return None
    try:
        ms = float(value)
    except ValueError:
        return None
    if not math.isfinite(ms):
        return None
    if ms < 0:
        ms = 0.0
    return Deadline(ms / 1e3)


def adopt(header_value: "str | None", site: str = "",
          allow_default: bool = True) -> "Deadline | None":
    """Ingress: bind the caller's budget, else the operator default
    (unless `allow_default` is False: the `/admin/` and `/debug/` routes,
    whose bulk work may outlive any default), always resetting the
    contextvar, since handler threads serve one request after another.
    Observes the remaining budget at this hop when one is bound."""
    d = parse_header(header_value)
    if d is None and allow_default:
        budget = default_budget()
        if budget > 0:
            d = Deadline(budget)
    _current.set(d)
    if d is not None:
        stats.PROCESS.histogram_observe(
            "deadline_remaining_seconds", d.remaining(),
            help_text="request budget remaining at ingress, per hop",
            site=site or "?")
    return d


def stamp_headers(headers: dict) -> dict:
    """`headers` with the remaining budget added (a header the caller
    set wins); `headers` itself when no deadline is armed."""
    d = _current.get()
    if d is None or HEADER in headers:
        return headers
    headers = dict(headers)
    headers[HEADER] = d.header_value()
    return headers


def io_timeout(default: float, site: str = "") -> float:
    """A socket timeout from the remaining budget: min(default,
    remaining), floored at MIN_TIMEOUT; `default` when no deadline is
    armed.  A spent budget raises DeadlineExceeded, counted at `site`,
    before the dial."""
    d = _current.get()
    if d is None:
        return default
    rem = d.remaining()
    if rem <= 0.0:
        note_exceeded(site)
        raise DeadlineExceeded(site)
    return min(default, max(rem, MIN_TIMEOUT))


def reraise_if_expired(site: str) -> None:
    """For a transport failure's handler: when the armed budget is spent,
    the failure is the budget's verdict (a budget-capped timeout on a
    healthy peer), so count it and raise DeadlineExceeded rather than
    mark the peer failed.  A no-op otherwise."""
    d = _current.get()
    if d is not None and d.expired():
        note_exceeded(site)
        raise DeadlineExceeded(site) from None


def note_exceeded(site: str) -> None:
    stats.PROCESS.counter_add(
        "deadline_exceeded_total", 1.0,
        help_text="requests/hops refused because the budget was spent",
        site=site or "?")


def expired_response(site: str) -> "tuple[int, tuple]":
    """A server's answer to a request that arrived past its budget: 504
    with `Retry-After: 1` before any handler work."""
    note_exceeded(site)
    body = b'{"error": "deadline exceeded before dispatch"}'
    return 504, (body, {"Retry-After": "1",
                        "Content-Type": "application/json"})


def handler_exceeded_response() -> "tuple[int, tuple]":
    """A server's answer when the budget ran out inside the handler (an
    outbound hop's `io_timeout` raised and counted it): 504, not 500."""
    body = b'{"error": "deadline exceeded"}'
    return 504, (body, {"Retry-After": "1",
                        "Content-Type": "application/json"})
