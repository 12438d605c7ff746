"""The port's lock ring on the CPU, against the JAX package's
(`seaweedfs_tpu/cluster/lock_manager.py` and the filer's
`/admin/locks/*` routes).  Tolerance: exact equality of answers (renew
tokens and expiry stamps are minted per process and compared by
presence); inputs seeded with numpy.

- `normalize_address` and the ring's `target_server` give the same
  answers over seeded spellings, keys and member lists;
- `LockManager` answers a seeded script of acquires, renewals,
  conflicts, releases and expiries as the JAX one does;
- two port filers with `-lockPeers A,B`: a key taken through either
  filer is refused (423, naming the owner) through the other, whichever
  member the ring gives it, released, and taken again; the JAX filers
  answer the same script the same way; `locks_held` counts them;
- `ClusterLock` renews past its TTL and follows `movedTo`, on either
  package's filers;
- a ring that does not name the filer is refused by both packages.
"""

import json
import socket
import time

import numpy as np
import pytest

from seaweedfs_tpu.cluster import ClusterLock as RefClusterLock
from seaweedfs_tpu.cluster import LockManager as RefLockManager
from seaweedfs_tpu.cluster.lock_manager import \
    normalize_address as ref_normalize
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu_torch.cluster import ClusterLock, LockManager
from seaweedfs_tpu_torch.cluster.lock_manager import normalize_address
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json

from test_torch_profiling import stop_background_probes

MASTER = "127.0.0.1:1"           # never dialed: the lock routes only

SPELLINGS = ["LOCALHOST:8888", "127.0.0.1:8888", "http://127.0.0.1:8888/",
             "https://Host.Example:1/", "::1", "[::1]", "[::1]:8888",
             "[2001:db8::2]:88", "2001:db8::2", "ip4-localhost:9",
             "localhost", "10.0.0.1", " 10.0.0.1:5 "]


def test_normalize_address_matches():
    assert [normalize_address(a) for a in SPELLINGS] == \
        [ref_normalize(a) for a in SPELLINGS]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_targets_match(seed):
    rng = np.random.default_rng(seed)
    members = [f"10.0.{int(rng.integers(0, 9))}.{i}:{8888 + i}"
               for i in range(int(rng.integers(1, 6)))]
    port, ref = LockManager(members[0]), RefLockManager(members[0])
    port.members, ref.members = list(members), list(members)
    keys = [f"k{int(rng.integers(0, 1 << 30))}" for _ in range(300)]
    assert [port.target_server(k) for k in keys] == \
        [ref.target_server(k) for k in keys]


def _manager_script(lm, clock) -> list:
    out = []

    def tok(r):
        return ("token", r[0] != "", r[1] > 0) if isinstance(r, tuple) \
            else r
    a = lm.acquire("k", "alice", 5)
    out.append(tok(a))
    out.append(lm.acquire("k", "bob", 5))
    out.append(tok(lm.acquire("k", "alice", 5, a[0])))     # renewal
    out.append(lm.acquire("k", "alice", 5, a[0])[0] == a[0])
    out.append(lm.acquire("k", "bob", 5, "stolen-token"))
    out.append(lm.find_owner("k"))
    out.append(lm.release("k", "wrong"))
    out.append([(x["key"], x["owner"]) for x in lm.all_locks()])
    out.append(lm.release("k", a[0]))
    out.append(lm.release("k", a[0]))          # gone already
    b = lm.acquire("short", "carol", 1)
    clock[0] += 2.0                            # past carol's TTL
    out.append(lm.find_owner("short"))
    out.append(tok(lm.acquire("short", "dave", 5)))   # steal expired
    out.append(lm.release("short", b[0]))
    out.append([(x["key"], x["owner"]) for x in lm.all_locks()])
    return out


def test_lock_manager_answers_match(monkeypatch):
    import seaweedfs_tpu.cluster.lock_manager as ref_mod
    import seaweedfs_tpu_torch.cluster.lock_manager as mod
    out = []
    for m, cls in ((mod, LockManager), (ref_mod, RefLockManager)):
        clock = [1000.0]
        monkeypatch.setattr(m.time, "monotonic", lambda c=clock: c[0])
        out.append(_manager_script(cls("me:1"), clock))
    assert out[0] == out[1]


def _free_ports(n: int) -> list:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.fixture(scope="module")
def rings():
    """Two filers a package, `-lockPeers` naming both (spelled with
    `localhost`, which each normalizes to its own 127.0.0.1)."""
    out = {}
    made = []
    try:
        for kind, cls in (("port", FilerServer), ("jax", RefFilerServer)):
            for _ in range(5):
                ports = _free_ports(2)
                peers = [f"localhost:{p}" for p in ports]
                pair = []
                try:
                    for p in ports:
                        pair.append(cls(MASTER, port=p,
                                        lock_peers=peers).start())
                    break
                except OSError:     # a port taken since: choose again
                    for fs in pair:
                        fs.stop()
            made += pair
            out[kind] = pair
        yield out
    finally:
        for fs in made:
            fs.stop()
        stop_background_probes()


def _post(url, path, body):
    st, data, _ = http_bytes("POST", f"{url}{path}",
                             json.dumps(body).encode(),
                             {"Content-Type": "application/json"})
    return st, json.loads(data or b"{}")


def _ring_script(a, b) -> list:
    """Keys owned by A and by B, each taken through its owner and asked
    for through the other."""
    out = []
    by_owner = {}
    for i in range(64):
        key = f"key-{i}"
        by_owner.setdefault(a.lock_manager.target_server(key), key)
    assert len(by_owner) == 2
    for owner in sorted(by_owner):
        key = by_owner[owner]
        home = a if a._ring_self == owner else b
        other = b if home is a else a
        st, r = _post(other.url, "/admin/locks/acquire",
                      {"key": key, "owner": "x", "ttlSec": 30})
        out.append((st, r.get("movedTo") == owner))
        st, r = _post(home.url, "/admin/locks/acquire",
                      {"key": key, "owner": "x", "ttlSec": 30})
        token = r.get("renewToken")
        out.append((st, bool(token)))
        st, r = _post(home.url, "/admin/locks/acquire",
                      {"key": key, "owner": "y", "ttlSec": 30})
        out.append((st, r))
        out.append(_post(home.url, "/admin/locks/release",
                         {"key": key, "renewToken": "nope"}))
        out.append([(x["key"], x["owner"]) for x in http_json(
            "GET", f"{home.url}/admin/locks/list")["locks"]])
        out.append(_post(home.url, "/admin/locks/release",
                         {"key": key, "renewToken": token}))
    out.append(_post(a.url, "/admin/locks/acquire", {"owner": "x"}))
    return out


def test_the_ring_answers_as_the_jax_ring(rings):
    got = {k: _ring_script(*pair) for k, pair in rings.items()}
    assert got["port"] == got["jax"]
    assert (423, {"error": "locked", "owner": "x"}) in got["port"]


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_a_lock_through_a_is_refused_through_b(rings, kind):
    """ClusterLock, the port's on either package's ring: taken through
    A, a second owner through B waits and is refused (the ring sends it
    to the owner), the holder's renewals outlive the TTL, and once
    released B's owner takes it."""
    a, b = rings[kind]
    held = ClusterLock(a.url, "ring/lock", "owner-a", ttl_sec=1.0).acquire()
    try:
        time.sleep(1.6)                    # past one TTL: renewed
        assert held.is_held()
        with pytest.raises(TimeoutError):
            ClusterLock(b.url, "ring/lock", "owner-b",
                        ttl_sec=1.0).acquire(timeout=0.6)
        home = a if a.lock_manager.target_server("ring/lock") == \
            a._ring_self else b
        text = http_bytes("GET", f"{home.url}/metrics")[1].decode()
        assert "\nfiler_locks_held 1.0\n" in text
    finally:
        held.release()
    other = RefClusterLock(b.url, "ring/lock", "owner-b",
                           ttl_sec=1.0).acquire(timeout=5)
    other.release()


def test_a_ring_without_this_filer_is_refused():
    for cls in (FilerServer, RefFilerServer):
        with pytest.raises(ValueError, match="is not in -lockPeers"):
            cls(MASTER, lock_peers=["localhost:1", "127.0.0.1:2"])
