"""Failpoint plane: named fault-injection sites on every role (the
port's copy of `seaweedfs_tpu/faults.py`; one spec and one seed fire the
same sequence in both packages).

Sites are plain dotted strings, passed to `fire(site, key=...)` at the
instrumented call site.  The compiled-in sites:

  httpd.pool.connect       client pool: dialing a fresh connection
  httpd.pool.request       client pool: before each request attempt
  httpd.stream.chunk       http_stream_request: per sent window
  httpd.relay.chunk        http_relay: per relayed chunk
  httpd.download.chunk     http_download: per received chunk
  volume.shard_write.recv  scatter receiver: per received chunk
  volume.receive_file.recv receive_file: per received chunk
  volume.shard_read.serve  shard_read: before serving the range
  volume.read.serve        volume data path: before a needle GET is
                           answered (cache included); the key carries
                           the serving replica's url, so `match`
                           wedges exactly one replica
  volume.write.serve       volume data path: before a needle write
  ec.rebuild.slice         RemoteShardSource: per fetched window
  ec.encode.window         RemoteShardSink: per pushed window
  master.heartbeat         volume server: before each heartbeat POST
  master.lookup            master: /dir/lookup handler entry
  filer.entry.put          filer: before persisting an entry
  filer.chunk.fetch        filer: before a chunk view is resolved on
                           the read path (cache included)

The reference's `rpc.stub.call` site is not compiled in: the port has no
gRPC stubs.

Actions:

  error     raise FaultInjected (an OSError) at the site
  delay     sleep `ms` milliseconds, then continue
  truncate  return the "truncate" directive: the site ends its stream
            early (fewer bytes than promised, clean framing)
  drop      return the "drop" directive: the site severs the
            connection mid-body (dirty close, no terminal chunk)

Arms fire with probability `p` (default 1.0) from a per-arm
`random.Random(seed)`, at most `n` times (default unlimited), and only
when `match` (if set) is a substring of the site's `key` argument.

Arming:

  * environment: SEAWEEDFS_TPU_FAULTS="site=action,k=v,k=v;site2=..."
    parsed at import (every role inherits it from its launcher);
    SEAWEEDFS_TPU_FAULTS_SEED is the seed of arms that name none;
  * runtime: POST /debug/faults on any role (server/debug.py), body
    {"spec": "..."} or {"site":..., "action":..., ...} or
    {"clear": true}.

Arms, trigger counts and the seed are per process.  Every trigger adds
to `faults_triggered_total{site,action}` in `stats.PROCESS`.
"""

from __future__ import annotations

import os
import random
import threading
import time

ACTIONS = ("error", "delay", "truncate", "drop")


class FaultInjected(OSError):
    """Raised at an armed `error` site.  An OSError subclass so every
    transport-failure handler (retry, failover, unwind) treats it
    exactly like the real network fault it stands in for."""


class _Arm:
    def __init__(self, site: str, action: str, p: float = 1.0,
                 n: "int | None" = None, ms: float = 0.0,
                 seed: "int | None" = None, match: str = ""):
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; "
                             f"use one of {ACTIONS}")
        self.site = site
        self.action = action
        self.p = min(max(float(p), 0.0), 1.0)
        self.n = None if n is None else int(n)
        self.ms = float(ms)
        self.match = match
        if seed is None:
            seed = _default_seed()
        self.seed = seed
        self._rng = random.Random(seed)

    def should_fire(self, key: str) -> bool:
        if self.n is not None and self.n <= 0:
            return False
        if self.match and self.match not in key:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        if self.n is not None:
            self.n -= 1
        return True

    def describe(self) -> dict:
        return {"site": self.site, "action": self.action, "p": self.p,
                "n": self.n, "ms": self.ms, "match": self.match,
                "seed": self.seed}


_lock = threading.Lock()
_arms: "dict[str, list[_Arm]]" = {}
_triggered: "dict[str, int]" = {}


def _default_seed() -> int:
    try:
        return int(os.environ.get("SEAWEEDFS_TPU_FAULTS_SEED", "") or 0)
    except ValueError:
        return 0


def arm(site: str, action: str, p: float = 1.0,
        n: "int | None" = None, ms: float = 0.0,
        seed: "int | None" = None, match: str = "") -> None:
    a = _Arm(site, action, p=p, n=n, ms=ms, seed=seed, match=match)
    with _lock:
        _arms.setdefault(site, []).append(a)


def disarm(site: "str | None" = None) -> None:
    with _lock:
        if site is None:
            _arms.clear()
        else:
            _arms.pop(site, None)


def reset() -> None:
    """Disarm everything and zero the trigger counts (test isolation)."""
    with _lock:
        _arms.clear()
        _triggered.clear()


def parse_spec(spec: str) -> "list[_Arm]":
    """`site=action[,k=v...]` entries separated by `;`.  Keys: p, n,
    ms, seed, match (`,` separates options so a `match` value may
    hold a host:port).  Malformed entries raise ValueError — a chaos
    run with a typo'd fault spec must fail loudly, not run
    fault-free."""
    arms: list[_Arm] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        site, eq, rest = entry.partition("=")
        if not eq or not site.strip():
            raise ValueError(f"bad fault entry {entry!r}: "
                             f"want site=action[,k=v...]")
        parts = rest.split(",")
        action = parts[0].strip()
        kw: dict = {}
        for kv in parts[1:]:
            k, eq2, v = kv.partition("=")
            k = k.strip()
            if not eq2 or k not in ("p", "n", "ms", "seed", "match"):
                raise ValueError(f"bad fault option {kv!r} in {entry!r}")
            if k == "match":
                kw[k] = v.strip()
            elif k in ("p", "ms"):
                kw[k] = float(v)
            else:
                kw[k] = int(v)
        arms.append(_Arm(site.strip(), action, **kw))
    return arms


def arm_spec(spec: str) -> int:
    """Parse and arm a spec string; returns the number of arms added."""
    arms = parse_spec(spec)
    with _lock:
        for a in arms:
            _arms.setdefault(a.site, []).append(a)
    return len(arms)


def fire(site: str, key: str = "") -> "str | None":
    """The instrumented call site's hook.  Returns None (continue),
    or a directive string ("truncate" / "drop") the site interprets;
    raises FaultInjected for `error` arms; sleeps for `delay` arms.
    Unarmed sites cost one dict lookup under a lock."""
    with _lock:
        arms = _arms.get(site)
        if not arms:
            return None
        hit = None
        for a in arms:
            if a.should_fire(key):
                hit = a
                break
        if hit is None:
            return None
        _triggered[site] = _triggered.get(site, 0) + 1
        action, ms = hit.action, hit.ms
    _count_metric(site, action)
    if action == "delay":
        time.sleep(ms / 1e3)
        return None
    if action == "error":
        raise FaultInjected(
            f"fault injected at {site}" + (f" ({key})" if key else ""))
    return action


def _count_metric(site: str, action: str) -> None:
    from . import stats
    stats.PROCESS.counter_add(
        "faults_triggered_total", 1.0,
        help_text="armed failpoint triggers", site=site, action=action)


def armed() -> "list[dict]":
    with _lock:
        return [a.describe() for arms in _arms.values() for a in arms]


def triggered() -> "dict[str, int]":
    with _lock:
        return dict(_triggered)


def _arm_from_env() -> None:
    spec = os.environ.get("SEAWEEDFS_TPU_FAULTS", "")
    if spec:
        arm_spec(spec)


_arm_from_env()
