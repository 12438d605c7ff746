"""QoS plane: per-tenant admission control + foreground/background
priority (the port's copy of `seaweedfs_tpu/qos.py`).

The north star is sustained mixed traffic from many tenants, and
arXiv:1709.05365's core finding is that background EC maintenance
disproportionately hurts foreground tail latency in online-EC stores.
The SOSP Cake/Retro line gives the standard remedy shape: per-tenant
token buckets at the front door plus feedback throttling of background
work off a foreground latency signal.  This module is both halves:

* **AdmissionController** — per-tenant token buckets enforced as httpd
  middleware at the S3 gateway, the filer, and the volume admin plane.
  A tenant is the S3 access key (parsed from the SigV4 `Credential=`),
  the bearer principal on the admin plane, an explicit `X-Tenant` tag
  (internal load tools), or `anonymous`.  Two dimensions per tenant:
  request rate (req/s with a burst ceiling) and in-flight request
  bytes (Content-Length summed over admitted, unfinished requests).
  Over-limit requests are REJECTED with 503 + `Retry-After` — bounded
  backpressure at the edge, never an unbounded server-side queue.

* **FeedbackThrottle** — the background/foreground priority tier.  A
  watcher samples each registered role's `request_seconds` histogram
  (httpd's middleware metric) and, in the port, the
  `plane_request_seconds` histogram that the native planes' record
  drains feed (`profiling.PlaneRecordSink`): a needle GET served by the
  volume's read plane never reaches the Python front, and a throttle
  that read only `request_seconds` would never see the default
  foreground.  It computes the p99 of the traffic that arrived since
  the last sample, counts it (`qos_foreground_samples_total{source}`),
  and compares it to the configured SLO.  While foreground p99 is over the SLO the throttle
  doubles an inter-window pace (up to a cap) that the EC pipelines
  consult per window — `ShardSink` pushes and `ShardSource` slice
  fetches — so encode/rebuild degrade to a trickle instead of
  competing with user traffic; when p99 recovers the pace halves back
  to zero.

Configuration comes from a `[qos]` section in the same TOML file as
security.toml (see `load_qos_toml`) and can be changed at runtime via
`POST /debug/qos` on any role (server/debug.py).  Unconfigured, the
whole plane is inert: admission admits everything without touching a
bucket and `ec_pace` is a no-op.

Env knobs (all optional; TOML/runtime win over env):

  SEAWEEDFS_TPU_QOS_SLO_P99_MS        foreground p99 SLO (0 = off)
  SEAWEEDFS_TPU_QOS_CHECK_MS          throttle sample interval (1000)
  SEAWEEDFS_TPU_QOS_PACE_MIN_MS       first downshift pace (25)
  SEAWEEDFS_TPU_QOS_PACE_MAX_MS      pace ceiling / "paused" (2000)

Controllers, the throttle and its pace are per process: every sibling
of a `filer -workers N` fleet installs its own.

Observability: `qos_admitted_total{tenant,role}`,
`qos_rejected_total{tenant,role,reason}`, `qos_inflight_bytes{tenant}`,
`qos_ec_pace_ms`, `qos_ec_paced_total{kind}`,
`qos_foreground_p99_seconds` and `qos_foreground_samples_total{source}` in the shared stats.PROCESS registry every
role's /metrics appends.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from .util.hedge import LatencyTracker as _LatencyTracker
from .util import wlog


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# -- configuration ---------------------------------------------------------

@dataclass
class TenantLimit:
    """Limits for one tenant (0 = unlimited on that dimension)."""

    rps: float = 0.0            # sustained request rate
    burst: float = 0.0          # bucket depth; defaults to max(rps, 1)
    inflight_mb: float = 0.0    # concurrent request payload bytes

    def to_json(self) -> dict:
        return {"rps": self.rps, "burst": self.burst,
                "inflightMb": self.inflight_mb}

    @classmethod
    def from_json(cls, d: dict) -> "TenantLimit":
        lim = cls(rps=float(d.get("rps", 0.0)),
                  burst=float(d.get("burst", 0.0)),
                  inflight_mb=float(d.get("inflightMb",
                                          d.get("inflight_mb", 0.0))))
        if lim.rps < 0 or lim.burst < 0 or lim.inflight_mb < 0:
            # same fail-loud contract as load_qos_toml: a sign slip in
            # a runtime lever call must 400, not silently run the
            # tenant unlimited (TokenBucket clamps negatives to the
            # unlimited dimension)
            raise ValueError("qos limits must be >= 0")
        return lim


@dataclass
class QosConfig:
    """The `[qos]` TOML surface + runtime lever state."""

    enabled: bool = False
    default: "TenantLimit | None" = None      # applies to any tenant
    tenants: dict = field(default_factory=dict)  # name -> TenantLimit
    slo_p99_ms: float = 0.0                   # 0 = throttle off
    check_interval_ms: float = 1000.0
    pace_min_ms: float = 25.0
    pace_max_ms: float = 2000.0

    def limit_for(self, tenant: str) -> "TenantLimit | None":
        return self.tenants.get(tenant) or self.default

    def to_json(self) -> dict:
        return {
            "enabled": self.enabled,
            "default": self.default.to_json() if self.default else None,
            "tenants": {t: lim.to_json()
                        for t, lim in sorted(self.tenants.items())},
            "sloP99Ms": self.slo_p99_ms,
            "checkIntervalMs": self.check_interval_ms,
            "paceMinMs": self.pace_min_ms,
            "paceMaxMs": self.pace_max_ms,
        }


def load_qos_toml(path: str) -> "QosConfig | None":
    """Parse the `[qos]` section of a security.toml-style file:

        [qos]
        enabled = true
        slo_p99_ms = 200          # foreground SLO for the EC throttle
        [qos.default]             # any tenant without an override
        rps = 200
        burst = 400
        inflight_mb = 64
        [qos.tenants.noisy]       # per-tenant override (access key /
        rps = 10                  # principal name)
        burst = 10

    Returns None when the file has no [qos] section (callers keep the
    process default).  Malformed limits raise ValueError — a typo'd
    QoS config must fail at boot, not silently run unlimited."""
    try:
        import tomllib
    except ModuleNotFoundError:      # py<3.11: the tomli backport
        import tomli as tomllib
    with open(path, "rb") as f:
        t = tomllib.load(f)
    q = t.get("qos")
    if not q:
        return None

    def _limit(d: dict, where: str) -> TenantLimit:
        lim = TenantLimit(rps=float(d.get("rps", 0.0)),
                          burst=float(d.get("burst", 0.0)),
                          inflight_mb=float(d.get("inflight_mb", 0.0)))
        if lim.rps < 0 or lim.burst < 0 or lim.inflight_mb < 0:
            raise ValueError(f"[qos] {where}: limits must be >= 0")
        return lim

    cfg = QosConfig(
        enabled=bool(q.get("enabled", True)),
        slo_p99_ms=float(q.get("slo_p99_ms", 0.0)),
        check_interval_ms=float(q.get("check_interval_ms", 1000.0)),
        pace_min_ms=float(q.get("pace_min_ms", 25.0)),
        pace_max_ms=float(q.get("pace_max_ms", 2000.0)),
    )
    if q.get("default"):
        cfg.default = _limit(q["default"], "default")
    for name, d in (q.get("tenants") or {}).items():
        cfg.tenants[str(name)] = _limit(d, f"tenants.{name}")
    return cfg


# -- token bucket ----------------------------------------------------------

class TokenBucket:
    """Monotonic-clock token bucket.  `try_take` never blocks: it
    returns 0.0 on success or the seconds until enough tokens refill —
    the `Retry-After` the rejection carries, so a well-behaved client
    retries exactly when a token exists instead of hammering."""

    def __init__(self, rate: float, burst: float):
        # configured values kept verbatim: the admission controller
        # compares THESE against the live TenantLimit to decide
        # whether the bucket is stale — comparing the clamped values
        # would recreate the bucket (full of tokens) on every admit
        # for any config the clamp rewrites, e.g. burst in (0, 1)
        self.cfg_rate = float(rate)
        self.cfg_burst = float(burst)
        self.rate = max(self.cfg_rate, 0.0)
        self.burst = max(self.cfg_burst or max(self.rate, 1.0), 1.0)
        self._tokens = self.burst
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> float:
        if self.rate <= 0:
            return 0.0               # unlimited dimension
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp)
                               * self.rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate


# -- admission controller --------------------------------------------------

class RejectInfo:
    """One admission verdict: why + when to retry."""

    __slots__ = ("reason", "retry_after")

    def __init__(self, reason: str, retry_after: float):
        self.reason = reason
        self.retry_after = max(retry_after, 0.0)


class AdmissionController:
    """Per-tenant rate + in-flight-bytes admission.  One instance per
    process (module singleton below), shared by every role's listener
    — a tenant hammering the S3 gateway spends the same bucket its
    filer traffic does."""

    def __init__(self, config: "QosConfig | None" = None):
        self._lock = threading.Lock()
        self._config = config or QosConfig()
        self._buckets: dict[str, TokenBucket] = {}
        self._inflight: dict[str, int] = {}

    # -- config ------------------------------------------------------

    def configure(self, config: QosConfig) -> None:
        with self._lock:
            self._config = config
            self._buckets.clear()    # new rates take effect at once

    def config(self) -> QosConfig:
        with self._lock:
            return self._config

    def set_tenant(self, tenant: str,
                   limit: "TenantLimit | None") -> None:
        """Runtime lever: install/replace (or remove, with None) one
        tenant's limits.  `default` / `*` targets the default limit."""
        with self._lock:
            if tenant in ("default", "*"):
                self._config.default = limit
            elif limit is None:
                self._config.tenants.pop(tenant, None)
            else:
                self._config.tenants[tenant] = limit
            self._buckets.pop(tenant, None)
            if limit is not None:
                self._config.enabled = True

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._config.enabled = bool(enabled)

    # -- admission ---------------------------------------------------

    def admit(self, tenant: str, nbytes: int = 0):
        """Returns (release, reject).  reject is None when admitted;
        release is a zero-arg callable the server runs when the
        request finishes (always callable, possibly a no-op)."""
        with self._lock:
            cfg = self._config
            if not cfg.enabled:
                return _NOOP, None
            limit = cfg.limit_for(tenant)
            if limit is None:
                return _NOOP, None
            bucket = self._buckets.get(tenant)
            if bucket is None or bucket.cfg_rate != limit.rps or \
                    bucket.cfg_burst != limit.burst:
                bucket = self._buckets[tenant] = TokenBucket(
                    limit.rps, limit.burst)
            max_bytes = int(limit.inflight_mb * (1 << 20))
            cur = self._inflight.get(tenant, 0)
            if max_bytes and nbytes > 0 and \
                    cur + nbytes > max_bytes:
                # in-flight bytes over the cap: Retry-After is a hint
                # (completion, not refill, frees bytes) — 1s keeps
                # well-behaved clients from busy-looping
                return _NOOP, RejectInfo("inflight_bytes", 1.0)
            wait = bucket.try_take(1.0)
            if wait > 0.0:
                return _NOOP, RejectInfo("rate", wait)
            if nbytes > 0:
                release = self._reserve_locked(tenant, nbytes)
                _gauge_inflight(tenant, cur + nbytes)
                return release, None
            return _NOOP, None

    def _reserve_locked(self, tenant: str, nbytes: int):
        """Record `nbytes` in flight (caller holds self._lock) and
        return the idempotent release closure — the ONE copy of the
        reservation bookkeeping shared by admit (request bodies) and
        admit_bytes (response bodies)."""
        self._inflight[tenant] = \
            self._inflight.get(tenant, 0) + nbytes
        released = [False]

        def release():
            with self._lock:
                if released[0]:
                    return
                released[0] = True
                left = self._inflight.get(tenant, 0) - nbytes
                if left > 0:
                    self._inflight[tenant] = left
                else:
                    self._inflight.pop(tenant, None)
            _gauge_inflight(tenant, self.inflight_of(tenant))
        return release

    def admit_bytes(self, tenant: str, nbytes: int):
        """In-flight-bytes-only admission for RESPONSE payloads (the
        read path's half of the accounting: admission at the edge
        meters request bodies via Content-Length, but a GET carries
        its bytes in the RESPONSE — a hot-cache stampede would
        otherwise ride the rate bucket alone and evade the byte
        dimension entirely).  No rate token is spent: the request
        already paid one at admission.  Returns (release, reject)."""
        with self._lock:
            cfg = self._config
            if not cfg.enabled or nbytes <= 0:
                return _NOOP, None
            limit = cfg.limit_for(tenant)
            if limit is None or not limit.inflight_mb:
                return _NOOP, None
            max_bytes = int(limit.inflight_mb * (1 << 20))
            cur = self._inflight.get(tenant, 0)
            if cur + nbytes > max_bytes:
                return _NOOP, RejectInfo("inflight_bytes", 1.0)
            release = self._reserve_locked(tenant, nbytes)
        _gauge_inflight(tenant, cur + nbytes)
        return release, None

    def inflight_of(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"config": self._config.to_json(),
                    "inflightBytes": dict(self._inflight)}


def _NOOP() -> None:
    return None


def _gauge_inflight(tenant: str, value: int) -> None:
    from . import stats
    stats.PROCESS.gauge_set(
        "qos_inflight_bytes", float(value),
        help_text="admitted request bytes still in flight",
        tenant=tenant)


# -- tenant extraction -----------------------------------------------------

def tenant_of(req) -> str:
    """Best-effort tenant identity for accounting/limiting — NOT an
    authentication verdict (the gateway's SigV4/JWT verification still
    decides access; a forged access key here only burns the forger's
    chosen bucket).  Order: SigV4 access key (header then presigned
    query), explicit X-Tenant tag, bearer-JWT principal, anonymous."""
    auth = req.headers.get("Authorization", "") or ""
    if auth.startswith("AWS4-HMAC-SHA256"):
        # "AWS4-HMAC-SHA256 Credential=AK/date/region/s3/aws4_request,
        #  SignedHeaders=..., Signature=..."
        i = auth.find("Credential=")
        if i >= 0:
            ak = auth[i + len("Credential="):].split("/", 1)[0]
            ak = ak.split(",", 1)[0].strip()
            if ak:
                return ak
    cred = req.query.get("X-Amz-Credential", "")
    if cred:
        ak = cred.split("/", 1)[0].strip()
        if ak:
            return ak
    tag = req.headers.get("X-Tenant", "")
    if tag:
        return tag[:64]
    if auth[:7].upper() == "BEARER ":
        # decode (NOT verify) the claims for an accounting identity;
        # signature checks stay with the role's guard
        try:
            import base64
            import json as _json
            payload = auth[7:].split(".")[1]
            claims = _json.loads(base64.urlsafe_b64decode(
                payload + "=" * (-len(payload) % 4)))
            if claims.get("admin"):
                return "admin"
            who = claims.get("principal") or claims.get("sub") or ""
            if who:
                return str(who)[:64]
        except (ValueError, IndexError, TypeError):
            pass
    return "anonymous"


# -- brownout shedding (the deadline plane's admission hook) ---------------
#
# A request that arrives with less budget than this server currently
# needs to serve anything is already lost: admitting it spends a
# handler thread, store reads and downstream hops on work the client
# will have abandoned by the time the response is written.  Admission
# therefore consults the arriving request's deadline (util/deadline)
# against the MEDIAN of recent request service latencies — the
# "current queue latency" signal, fed by the release callback
# admission already hands the server fronts — and sheds unmeetable
# work with 503 + Retry-After (reason "brownout") BEFORE a rate token
# or byte reservation is spent.  Only deadline-carrying requests can
# brown out; everything else is admitted exactly as before.
#
# A windowed median, not a mean/EWMA: the release samples cover the
# response write, so one front serves a MIX of millisecond point
# requests and multi-second bulk transfers, and a mean would let a
# minority of bulk samples shed fast deadline-carrying reads that
# would comfortably finish.  The median only moves once bulk traffic
# is the MAJORITY of the window — at which point a small-budget
# request genuinely faces that queue.  (A mostly-bulk front that also
# serves point reads is still mis-estimated; `_FACTOR` tunes the
# sensitivity down and `BROWNOUT=0` is the kill switch.)
#
#   SEAWEEDFS_TPU_BROWNOUT=0         kill switch (default on)
#   SEAWEEDFS_TPU_BROWNOUT_FACTOR    shed when remaining < median * f
#                                    (default 1.0)

# the same ring-quantile the hedge threshold runs on (one
# implementation to tune), window 64 / warmup 20 / q=0.5
_brownout_tracker = _LatencyTracker(size=64, min_samples=20)


def brownout_enabled() -> bool:
    return os.environ.get("SEAWEEDFS_TPU_BROWNOUT", "1") \
        not in ("0", "false")


# the autopilot's override of the environment's factor (None: the
# env's value, the baseline); set only through its actuator
_brownout_factor_override: "float | None" = None


def set_brownout_factor(f: "float | None") -> None:
    global _brownout_factor_override
    _brownout_factor_override = None if f is None else max(0.0, float(f))


def effective_brownout_factor() -> float:
    return _brownout_factor()


def _brownout_factor() -> float:
    if _brownout_factor_override is not None:
        return _brownout_factor_override
    return max(0.0, _env_float("SEAWEEDFS_TPU_BROWNOUT_FACTOR", 1.0))


def note_latency(seconds: float) -> None:
    """Feed one completed request's service latency into the brownout
    estimator (called from the admission release path — covers
    handler + response write)."""
    _brownout_tracker.note(seconds)


def brownout_estimate() -> float:
    """Expected service latency for a request admitted NOW (windowed
    median; the sort costs 64 floats and only runs for
    deadline-carrying arrivals); 0.0 until enough traffic has been
    seen to estimate anything (a cold server must not shed its first
    requests on noise)."""
    return _brownout_tracker.quantile(0.5) or 0.0


def _brownout_reset() -> None:
    _brownout_tracker.reset()
    set_brownout_factor(None)


# exempt from admission on every role: the observability/debug plane
# must stay reachable from a throttled cluster (the runtime QoS lever
# itself rides /debug), and /status is every poller's liveness probe
_EXEMPT_PREFIXES = ("/debug/", "/metrics", "/status", "/healthz")


def install(http, role: str, path_prefix: str = "") -> None:
    """Wire admission into one listener as httpd middleware (the
    `HttpServer.admission` hook).  `path_prefix` scopes enforcement
    (the volume server passes "/admin/" so the tenant plane governs
    its maintenance endpoints while foreground needle traffic is
    protected by the EC throttle instead)."""
    ctl = controller()

    def admission(req):
        path = req.path
        if path.startswith(_EXEMPT_PREFIXES):
            return None, None
        if path_prefix and not path.startswith(path_prefix):
            return None, None
        from . import stats
        from .util import deadline as _deadline
        tenant = tenant_of(req)
        # brownout: a deadline-carrying request whose remaining budget
        # cannot cover the current expected service latency is shed
        # BEFORE any token/byte accounting (already-expired budgets
        # belong to the fronts' 504 path, not this 503)
        d = _deadline.get()
        if d is not None and brownout_enabled():
            est = brownout_estimate() * _brownout_factor()
            rem = d.remaining()
            if est > 0.0 and 0.0 < rem < est:
                stats.PROCESS.counter_add(
                    "qos_rejected_total", 1.0,
                    help_text="requests rejected by QoS admission",
                    tenant=tenant, role=role, reason="brownout")
                # the flight recorder's record of a shed request must
                # say WHY it was shed (verdict "shed" alone names the
                # mechanism, not the cause)
                from . import profiling
                profiling.flight_note(
                    "qosReject",
                    {"reason": "brownout", "tenant": tenant,
                     "estimateMs": round(est * 1e3, 2),
                     "remainingMs": round(rem * 1e3, 2)})
                retry_after = max(1, int(est + 0.999))
                body = (b'{"error": "qos: request budget below '
                        b'current service latency (brownout)"}')
                return (503, (body,
                              {"Retry-After": str(retry_after),
                               "Content-Type": "application/json"})), \
                    None
        nbytes = int(req.headers.get("Content-Length") or 0)
        release, reject = ctl.admit(tenant, nbytes)
        if reject is None:
            stats.PROCESS.counter_add(
                "qos_admitted_total", 1.0,
                help_text="requests admitted by QoS",
                tenant=tenant, role=role)
            # the release callback doubles as the brownout
            # estimator's latency feed: it runs on the server fronts'
            # response finally path, so the sample covers handler
            # execution AND the response write
            t0 = time.monotonic()

            def _release_and_note(_inner=release):
                note_latency(time.monotonic() - t0)
                if _inner is not _NOOP:
                    _inner()
            return None, _release_and_note
        stats.PROCESS.counter_add(
            "qos_rejected_total", 1.0,
            help_text="requests rejected by QoS admission",
            tenant=tenant, role=role, reason=reject.reason)
        from . import profiling
        profiling.flight_note(
            "qosReject", {"reason": reject.reason, "tenant": tenant})
        retry_after = max(1, int(reject.retry_after + 0.999))
        body = (b'{"error": "qos: tenant over ' +
                reject.reason.encode() + b' limit"}')
        return (503, (body, {"Retry-After": str(retry_after),
                             "Content-Type": "application/json"})), \
            None

    http.admission = admission


class MeteredBody:
    """File-like response body that runs a release callback when the
    server finishes streaming it (httpd closes file-like payloads on
    the response-write finally path) — how charge_response's in-flight
    bytes stay held for exactly the duration of the response write."""

    def __init__(self, data: bytes, release):
        self._data = data
        self._pos = 0
        self._release = release

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = len(self._data) - self._pos
        out = self._data[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def close(self) -> None:
        rel, self._release = self._release, None
        if rel is not None:
            rel()


def charge_response(req, nbytes: int, role: str):
    """Response-side in-flight-byte accounting for data-plane reads
    (volume needle GETs, filer file GETs): charge the tenant's
    in-flight-bytes bucket for the RESPONSE size, so a stampede of
    concurrent large reads — cache hits included — is bounded by the
    same dimension uploads are.  Returns (release, deny): deny is a
    ready 503 response tuple when the tenant is over budget; release
    must run when the response has been written (wrap the body in
    MeteredBody, or call it on the buffered path).  Zero-cost when QoS
    is unconfigured or the tenant has no byte limit."""
    ctl = controller()
    release, reject = ctl.admit_bytes(tenant_of(req), int(nbytes))
    if reject is None:
        # None release = unmetered (QoS off / no byte limit): callers
        # skip the MeteredBody wrap entirely
        return (None if release is _NOOP else release), None
    from . import stats
    stats.PROCESS.counter_add(
        "qos_rejected_total", 1.0,
        help_text="requests rejected by QoS admission",
        tenant=tenant_of(req), role=role, reason="read_bytes")
    retry_after = max(1, int(reject.retry_after + 0.999))
    body = b'{"error": "qos: tenant over inflight_bytes limit"}'
    return _NOOP, (503, (body, {"Retry-After": str(retry_after),
                                "Content-Type": "application/json"}))


# -- foreground p99 + feedback throttle ------------------------------------

def histogram_p99(buckets, counts, q: float = 0.99) -> float:
    """Quantile estimate from a cumulative-free histogram snapshot:
    `counts[i]` observations fell in (prev_le, buckets[i]]; the last
    slot is +Inf.  Linear interpolation inside the winning bucket; the
    +Inf bucket reports its lower edge (can't interpolate to
    infinity)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    lower = 0.0
    for le, n in zip(buckets, counts[:-1]):
        cum += n
        if cum >= target:
            frac = 1.0 - (cum - target) / n if n else 1.0
            return lower + (le - lower) * frac
        lower = le
    return float(buckets[-1]) if buckets else 0.0


class FeedbackThrottle:
    """Watches foreground `request_seconds` p99 across registered
    sources and turns SLO violations into an EC window pace.

    States: pace 0.0 (healthy) → pace_min on first violation →
    doubling per violating sample up to pace_max ("paused" — one
    window per pace_max interval) → halving per healthy sample back
    to 0.  Multiplicative both ways: recovery is fast but not
    instant, so an oscillating p99 doesn't square-wave the EC jobs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: list = []     # (label, callable -> snap|None)
        self._last: dict[str, tuple] = {}   # label -> counts tuple
        self._pace = 0.0
        self._p99 = 0.0
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()

    # -- sources -----------------------------------------------------

    def add_metrics(self, label: str, metrics,
                    names: "tuple[str, ...]" = ("request_seconds",)
                    ) -> None:
        """A local registry (stats.Metrics) as a foreground source: the
        histograms `names`, merged across their label sets and with
        each other (they share `stats.DEFAULT_BUCKETS`)."""
        with self._lock:
            self._sources = [s for s in self._sources
                             if s[0] != label] + \
                [(label,
                  lambda m=metrics, n=tuple(names): _merged(m, n))]

    def add_scrape(self, label: str, url: str) -> None:
        """A remote role's /metrics as a foreground source (the
        worker's EC jobs watch the volume servers they hammer)."""
        with self._lock:
            self._sources = [s for s in self._sources
                             if s[0] != label] + \
                [(label, lambda u=url: _scrape_request_seconds(u))]

    def remove_source(self, label: str) -> None:
        with self._lock:
            self._sources = [s for s in self._sources
                             if s[0] != label]
            self._last.pop(label, None)

    # -- sampling ----------------------------------------------------

    def sample_now(self) -> float:
        """One sampling step: worst per-source p99 of the traffic
        since the previous sample; updates the pace.  Called by the
        watcher thread, and directly by tests (deterministic)."""
        cfg = current()
        slo = cfg.slo_p99_ms / 1e3
        with self._lock:
            sources = list(self._sources)
        snaps = []
        for label, fn in sources:
            try:
                snap = fn()
            except (OSError, ValueError, KeyError, TypeError):
                continue    # a dead remote source must not kill the
            if snap:        # watcher; it just contributes nothing
                snaps.append((label, snap))
        worst = 0.0
        from . import stats
        with self._lock:
            seen = []
            for label, snap in snaps:
                counts = tuple(snap["counts"])
                prev = self._last.get(label)
                self._last[label] = counts
                if prev is None or len(prev) != len(counts):
                    continue
                delta = [max(c - p, 0)
                         for c, p in zip(counts, prev)]
                if sum(delta) <= 0:
                    continue
                seen.append((label, sum(delta)))
                worst = max(worst,
                            histogram_p99(snap["buckets"], delta))
            self._p99 = worst
            if slo <= 0:
                self._pace = 0.0
            elif worst > slo:
                self._pace = min(max(self._pace * 2,
                                     cfg.pace_min_ms / 1e3),
                                 cfg.pace_max_ms / 1e3)
            else:
                self._pace = 0.0 if self._pace <= \
                    cfg.pace_min_ms / 1e3 else self._pace / 2
            pace = self._pace
        for label, n in seen:
            stats.PROCESS.counter_add(
                "qos_foreground_samples_total", float(n),
                help_text="foreground requests the QoS throttle's p99 "
                          "was computed over", source=label)
        stats.PROCESS.gauge_set(
            "qos_foreground_p99_seconds", worst,
            help_text="worst per-role request_seconds p99 over the "
                      "last QoS sample window")
        stats.PROCESS.gauge_set(
            "qos_ec_pace_ms", pace * 1e3,
            help_text="current background EC inter-window pace")
        return pace

    def pace(self) -> float:
        with self._lock:
            return self._pace

    def p99(self) -> float:
        with self._lock:
            return self._p99

    def set_pace(self, pace_s: float) -> None:
        """Runtime lever / tests: force the pace directly."""
        with self._lock:
            self._pace = max(float(pace_s), 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"paceMs": self._pace * 1e3,
                    "lastP99Ms": self._p99 * 1e3,
                    "sources": [label for label, _ in self._sources],
                    "running": self._thread is not None and
                    self._thread.is_alive()}

    # -- watcher -----------------------------------------------------

    def maybe_start(self) -> None:
        """Start the sampling thread if the SLO is configured and it
        isn't running.  Idempotent; cheap enough to call from every
        role constructor."""
        if current().slo_p99_ms <= 0:
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="qos-feedback-throttle")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(
                max(current().check_interval_ms, 50.0) / 1e3):
            try:
                self.sample_now()
            except Exception as e:   # noqa: BLE001 — the throttle is
                # advisory; it must never die, only report
                wlog.warning("qos throttle sample failed: %s", e,
                             component="qos")


def _merged(metrics, names: "tuple[str, ...]") -> "dict | None":
    """The histograms `names` of one registry merged into one snapshot;
    a histogram whose buckets differ from the first found is skipped."""
    out = None
    for name in names:
        h = metrics.histogram_merged(name)
        if h is None:
            continue
        if out is None:
            out = h
        elif tuple(out["buckets"]) == tuple(h["buckets"]):
            out["counts"] = [a + b for a, b in zip(out["counts"],
                                                   h["counts"])]
            out["sum"] += h["sum"]
            out["count"] += h["count"]
    return out


def _scrape_request_seconds(url: str) -> "dict | None":
    """Cumulative request_seconds bucket counts from a remote role's
    /metrics (merged across method/code label sets)."""
    from .server.httpd import http_bytes
    status, body, _ = http_bytes("GET", f"{url}/metrics", timeout=5)
    if status != 200:
        return None
    by_le: dict[float, float] = {}
    for line in body.decode(errors="replace").splitlines():
        if "_request_seconds_bucket{" not in line:
            continue
        head, _, value = line.rpartition(" ")
        i = head.find('le="')
        if i < 0:
            continue
        le_s = head[i + 4:head.find('"', i + 4)]
        le = float("inf") if le_s == "+Inf" else float(le_s)
        try:
            by_le[le] = by_le.get(le, 0.0) + float(value)
        except ValueError:
            continue
    if not by_le:
        return None
    les = sorted(k for k in by_le if k != float("inf"))
    # cumulative -> per-bucket
    counts, prev = [], 0.0
    for le in les:
        counts.append(by_le[le] - prev)
        prev = by_le[le]
    counts.append(by_le.get(float("inf"), prev) - prev)
    return {"buckets": tuple(les), "counts": counts}


# -- process singletons + the EC pipelines' hook ---------------------------

_controller = AdmissionController()
_throttle = FeedbackThrottle()


def controller() -> AdmissionController:
    return _controller


def throttle() -> FeedbackThrottle:
    return _throttle


def current() -> QosConfig:
    return _controller.config()


def anonymous_limited() -> bool:
    """True when admission is on with a default limit, which binds the
    `anonymous` tenant: the configuration under which the filer's native
    planes stand down.  They hand every tenant-tagged request (an
    `X-Tenant` tag, an `Authorization`) to the Python front, where
    admission runs, but serve anonymous ones themselves."""
    cfg = current()
    return bool(cfg.enabled and cfg.default is not None)


def configure(config: "QosConfig | None") -> None:
    """Install a new process QoS config (None resets to inert)."""
    _controller.configure(config or QosConfig())
    _throttle.maybe_start()


def reset() -> None:
    """Back to the inert boot state (test isolation, like
    faults.reset): config cleared, pace zeroed, sample history
    dropped.  Registered sources stay — live servers own those."""
    _controller.configure(QosConfig())
    _throttle.stop()
    with _throttle._lock:
        _throttle._pace = 0.0
        _throttle._p99 = 0.0
        _throttle._last.clear()
    _brownout_reset()


def _env_default_config() -> None:
    slo = _env_float("SEAWEEDFS_TPU_QOS_SLO_P99_MS", 0.0)
    if slo > 0:
        cfg = _controller.config()
        cfg.slo_p99_ms = slo
        cfg.check_interval_ms = _env_float(
            "SEAWEEDFS_TPU_QOS_CHECK_MS", cfg.check_interval_ms)
        cfg.pace_min_ms = _env_float(
            "SEAWEEDFS_TPU_QOS_PACE_MIN_MS", cfg.pace_min_ms)
        cfg.pace_max_ms = _env_float(
            "SEAWEEDFS_TPU_QOS_PACE_MAX_MS", cfg.pace_max_ms)


def ec_pace(kind: str) -> float:
    """The background pipelines' per-window hook (ShardSink sends,
    ShardSource slice fetches): sleeps the current pace, counting the
    downshift.  Unconfigured cost: one lock round, no sleep."""
    pace = _throttle.pace()
    if pace <= 0.0:
        return 0.0
    from . import stats
    stats.PROCESS.counter_add(
        "qos_ec_paced_total", 1.0,
        help_text="background EC windows delayed by the QoS throttle",
        kind=kind)
    time.sleep(pace)
    return pace


_watch_lock = threading.Lock()
_watch_refs: "dict[str, int]" = {}   # url -> concurrent watcher count


class remote_slo_watch:
    """Context manager for background jobs running OUTSIDE the serving
    processes (the maintenance worker): watch the named peers'
    /metrics for the job's duration so the feedback loop closes even
    though the worker holds no foreground histogram of its own.

    Sources are refcounted per url: a worker running concurrent jobs
    (max_concurrent > 1) whose url lists overlap must not have one
    job's exit remove a scrape source another job still needs."""

    def __init__(self, urls):
        self.urls = [u for u in dict.fromkeys(urls) if u]
        self._added: list = []

    def __enter__(self):
        if current().slo_p99_ms > 0:
            with _watch_lock:
                for u in self.urls:
                    _watch_refs[u] = _watch_refs.get(u, 0) + 1
                    self._added.append(u)
                    _throttle.add_scrape(f"remote:{u}", u)
            _throttle.maybe_start()
        return self

    def __exit__(self, *exc):
        with _watch_lock:
            for u in self._added:
                n = _watch_refs.get(u, 1) - 1
                if n <= 0:
                    _watch_refs.pop(u, None)
                    _throttle.remove_source(f"remote:{u}")
                else:
                    _watch_refs[u] = n
            self._added = []
        return False


_env_default_config()
