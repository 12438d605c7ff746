"""Distributed lock manager, hosted by the filer
(weed/cluster/lock_manager/distributed_lock_manager.go, lock_manager.go);
the port's copy of `seaweedfs_tpu/cluster/lock_manager.py`.

Semantics follow the reference:
- Lock(key, ttl, owner, token) grants a fresh renew-token, or RENEWS
  when the presented token matches the live lock, or steals only when
  the previous lock expired.  A mismatched token on a live lock is a
  conflict naming the current owner.
- Unlock requires the token (a crashed holder's lock simply expires).
- Ring placement: each lock key hashes onto the sorted member list;
  a non-owner answers `movedTo` and the client re-dials, exactly the
  reference's CalculateTargetServer shape.  With a single filer the
  ring is {self} and every lock is local.

Consumers: shell and maintenance flows may lock arbitrary keys (the
JAX package's MQ broker wraps partition takeover in one).
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid


def normalize_address(addr: str) -> str:
    """Canonicalize a ring-member address: membership is
    compared by string, so `localhost:8888` vs `127.0.0.1:8888` spelled
    differently across -lockPeers lists would make the owning filer
    fail its own `target == self` check and bounce every acquire
    through movedTo redirects until the client times out.

    Deliberately NO DNS here: resolution is per-host state (a resolver
    blip or split-horizon DNS on one filer would silently diverge the
    member lists and break lock mutual exclusion — worse than the
    redirect loop this fixes).  Only deterministic rewrites: lowercase,
    strip scheme / trailing slash, and the loopback aliases every host
    agrees on."""
    a = addr.strip().lower()
    if "://" in a:
        a = a.split("://", 1)[1]
    a = a.rstrip("/")
    if a.startswith("["):             # [v6]:port or bare [v6]
        host, _, rest = a.partition("]")
        host, port = host[1:], rest.lstrip(":")
    elif a.count(":") > 1:            # bare IPv6, no port
        host, port = a, ""
    else:
        host, _, port = a.rpartition(":")
        if not host:                  # bare hostname/IPv4, no port
            host, port = a, ""
    # only the NAME alias collapses; ::1 stays a v6 address — mapping
    # it to 127.0.0.1 would advertise a dial target a socket bound
    # only to v6 loopback does not accept
    if host in ("localhost", "ip4-localhost"):
        host = "127.0.0.1"
    elif ":" in host:                 # keep v6 hosts bracketed so the
        host = f"[{host}]"            # port separator stays parseable
    return f"{host}:{port}" if port else host


class LockManager:
    """Server-side lock table (one per filer)."""

    def __init__(self, host: str = ""):
        self.host = host
        self._lock = threading.Lock()
        # key -> (owner, token, expires_at_monotonic)
        self._locks: dict[str, tuple[str, str, float]] = {}
        self.members: list[str] = [host] if host else []

    # -- ring placement -------------------------------------------------

    def target_server(self, key: str) -> str:
        """distributed_lock_manager.go:151 CalculateTargetServer."""
        members = sorted(m for m in self.members if m)
        if not members or len(members) == 1:
            return self.host
        h = int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:8], "big")
        return members[h % len(members)]

    # -- lock table -----------------------------------------------------

    def acquire(self, key: str, owner: str, ttl_sec: float,
                token: str = "") -> "tuple[str, float] | str":
        """Returns (renew_token, expires_at_epoch) on success, or the
        current owner string on conflict."""
        now = time.monotonic()
        with self._lock:
            cur = self._locks.get(key)
            if cur is not None and cur[2] > now:
                cur_owner, cur_token, _ = cur
                if token and token == cur_token:
                    pass  # renewal by the live holder
                else:
                    return cur_owner
            new_token = token if (cur and token == cur[1]) \
                else uuid.uuid4().hex
            self._locks[key] = (owner, new_token, now + ttl_sec)
            return new_token, time.time() + ttl_sec

    def release(self, key: str, token: str) -> bool:
        with self._lock:
            cur = self._locks.get(key)
            if cur is None:
                return True  # already gone (expired)
            if cur[1] != token:
                return False
            del self._locks[key]
            return True

    def find_owner(self, key: str) -> "str | None":
        now = time.monotonic()
        with self._lock:
            cur = self._locks.get(key)
            if cur is None or cur[2] <= now:
                return None
            return cur[0]

    def all_locks(self) -> "list[dict]":
        now = time.monotonic()
        with self._lock:
            return [{"key": k, "owner": o,
                     "ttlRemainingSec": round(exp - now, 2)}
                    for k, (o, _t, exp) in self._locks.items()
                    if exp > now]


class ClusterLock:
    """Client-side lock handle with background renewal
    (wdclient's LiveLock analog, cluster/lock_client.go): acquire
    blocks (with timeout), a renew thread keeps the lock alive at
    ttl/3 cadence, release stops it.  Usable as a context manager.
    Follows `movedTo` redirects across the filer ring."""

    def __init__(self, filer: str, key: str, owner: str,
                 ttl_sec: float = 10.0):
        self.filer = filer
        self.key = key
        self.owner = owner
        self.ttl = ttl_sec
        self._token = ""
        self._stop = threading.Event()
        self._renewer: threading.Thread | None = None
        # set when the lock is CONFIRMED taken by someone else; a
        # holder in a long critical section can check is_held()
        self.lost = threading.Event()

    def _call(self, path: str, payload: dict) -> dict:
        from ..server.httpd import http_json
        target = self.filer
        for _ in range(3):  # ring redirects
            r = http_json("POST", f"{target}{path}", payload, timeout=10)
            moved = r.get("movedTo")
            if moved and moved != target:
                target = moved
                continue
            return r
        return r

    def _try_acquire(self) -> str:
        """One acquire/renew attempt: "ok", "conflict" (someone else
        holds it — authoritative), or "transient" (server error /
        unreachable: retry within the TTL, the lock may still be
        ours)."""
        try:
            r = self._call("/admin/locks/acquire", {
                "key": self.key, "owner": self.owner,
                "ttlSec": self.ttl, "renewToken": self._token})
        except OSError:
            return "transient"
        if "renewToken" in r:
            self._token = r["renewToken"]
            return "ok"
        # http_json returns HTTP error bodies as dicts, never raising:
        # only an explicit "locked" conflict is an authoritative loss
        if r.get("error") == "locked":
            return "conflict"
        return "transient"

    def is_held(self) -> bool:
        return bool(self._token) and not self.lost.is_set()

    def acquire(self, timeout: float = 30.0) -> "ClusterLock":
        deadline = time.monotonic() + timeout
        while True:
            if self._try_acquire() == "ok":
                break
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"lock {self.key}: held by another owner")
            time.sleep(min(0.2, self.ttl / 10))
        self.lost.clear()
        self._stop.clear()
        self._renewer = threading.Thread(target=self._renew_loop,
                                         daemon=True)
        self._renewer.start()
        return self

    def _renew_loop(self) -> None:
        while not self._stop.wait(self.ttl / 3):
            if self._try_acquire() == "conflict":
                # someone else holds it now — surface the loss; the
                # holder's critical section checks is_held().
                # Transient errors keep retrying at ttl/3 cadence: the
                # server-side lock is still ours until TTL expiry.
                self.lost.set()
                return

    def release(self) -> None:
        self._stop.set()
        if self._renewer is not None:
            self._renewer.join(timeout=1)
        if self._token:
            try:
                self._call("/admin/locks/release",
                           {"key": self.key, "renewToken": self._token})
            except OSError:
                pass  # expires on its own
            self._token = ""

    def __enter__(self) -> "ClusterLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()
