"""The port's follow stream, against the JAX package's: the master's
`server/location_hub.py` and `/cluster/watch` (with the heartbeat's
publish), `wdclient.MasterFollower`, `operation.enable_follow` /
`disable_follow` / `lookup`, and the filer's use of the pushed map.
Tolerance: exact equality (events, cursors, vid maps, RPC counts).

- on the same seeded publish and poll sequence, the port's hub answers
  `events_since` and `cursor` as the JAX hub does;
- the JAX follower follows a port master and the port's follower a JAX
  master, each to the same vid map as the other package's follower;
- a node that leaves the port master's views (3 missed pulses) leaves
  the followers' maps, and comes back when it heartbeats again;
- the port's filer follows its master: its reads resolve from the
  pushed map with no `/dir/lookup` RPC (tests/test_cluster_locks.py's
  follower case), and `enable_follow` is refcounted.
"""

import os
import time

import numpy as np
import pytest

from seaweedfs_tpu import wdclient as ref_wdclient
from seaweedfs_tpu.server import location_hub as ref_hub
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu_torch import operation, wdclient
from seaweedfs_tpu_torch.server import location_hub
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.topology import iter_volume_list_volumes


def _wait(cond, what: str, timeout: float = 15.0) -> None:
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out: {what}"
        time.sleep(0.05)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_hub_answers_as_the_reference(seed):
    rng = np.random.default_rng([18, seed])
    cap = int(rng.integers(2, 9))
    port, ref = location_hub.LocationHub(cap), ref_hub.LocationHub(cap)
    assert port.cursor == ref.cursor == 0
    assert port.events_since(0) == ref.events_since(0)
    for step in range(200):
        if rng.random() < 0.5:
            ev = {"url": f"n{step}", "newVids": [int(rng.integers(1, 50))]}
            port.publish(dict(ev))
            ref.publish(dict(ev))
        since = int(rng.integers(-1, port.cursor + 2))
        assert port.events_since(since) == ref.events_since(since), \
            (step, since)
        assert port.cursor == ref.cursor


def test_a_poll_waits_for_the_next_event():
    hub = location_hub.LocationHub()
    t0 = time.monotonic()
    assert hub.events_since(0, timeout=0.2) == ([], 0, False)
    assert time.monotonic() - t0 >= 0.15
    import threading
    threading.Timer(0.1, hub.publish, args=({"url": "a"},)).start()
    events, cursor, lagged = hub.events_since(0, timeout=5)
    assert events == [{"url": "a"}] and cursor == 1 and not lagged


def _maps(followers, vids) -> list:
    return [{v: sorted(loc["url"] for loc in (f.get_locations(v) or []))
             for v in vids} for f in followers]


def _followers_agree(followers, vids, want_urls) -> bool:
    maps = _maps(followers, vids)
    return all(m == maps[0] for m in maps) and \
        all(maps[0][v] for v in vids) and \
        {u for v in vids for u in maps[0][v]} <= set(want_urls)


def test_both_followers_follow_a_port_master(tmp_path):
    master = MasterServer(pulse_seconds=1.0).start()
    servers = [VolumeServer([str(tmp_path / f"v{i}")], device="cpu",
                            master=master.url, pulse_seconds=0.2).start()
               for i in range(2)]
    followers = [wdclient.MasterFollower(master.url, poll_timeout=2.0),
                 ref_wdclient.MasterFollower(master.url, poll_timeout=2.0)]
    for f in followers:
        f.start()
    try:
        assert all(f.wait_synced(5) for f in followers)
        vids = sorted({int(operation.assign(
            master.url, collection=f"c{i}").fid.split(",")[0])
            for i in range(3)})
        urls = [s.url for s in servers]
        _wait(lambda: _followers_agree(followers, vids, urls),
              "both followers hold the grown volumes")
        assert followers[1].leader == master.url
        # each pushed map is the master's own lookup
        for v in vids:
            want = sorted(loc["url"] for loc in operation.lookup(
                master.url, v, use_cache=False))
            assert _maps(followers, [v])[0][v] == want
        # a node that misses 3 pulses leaves both maps; back on its
        # first heartbeat
        gone = servers[0]
        held = [v for v in vids if gone.store.find_volume(v) is not None]
        assert held
        gone._hb_stop.set()
        _wait(lambda: all(gone.url not in u
                          for m in _maps(followers, held)
                          for u in m.values()),
              "the departed node leaves the maps", timeout=10)
        assert followers[0].events >= 2
        gone._hb_stop.clear()
        gone._heartbeat_once()
        _wait(lambda: all(gone.url in m[v] for m in _maps(followers, held)
                          for v in held), "the node comes back")
    finally:
        for f in followers:
            f.stop()
        for s in servers:
            s.stop()
        master.stop()


def test_both_followers_follow_a_jax_master(tmp_path):
    master = RefMaster(volume_size_limit_mb=8).start()
    vs = RefServer([str(tmp_path / "v0")], master.url,
                   pulse_seconds=0.3).start()
    followers = [wdclient.MasterFollower(master.url, poll_timeout=2.0),
                 ref_wdclient.MasterFollower(master.url, poll_timeout=2.0)]
    for f in followers:
        f.start()
    try:
        assert all(f.wait_synced(5) for f in followers)
        vids = sorted({int(operation.assign(
            master.url, collection=f"j{i}").fid.split(",")[0])
            for i in range(2)})
        _wait(lambda: _followers_agree(followers, vids, [vs.url]),
              "both followers hold the JAX master's volumes")
        assert followers[0].leader == followers[1].leader == master.url
        assert followers[0].target == master.url
    finally:
        for f in followers:
            f.stop()
        vs.stop()
        master.stop()


def test_enable_follow_is_refcounted(tmp_path):
    master = MasterServer(pulse_seconds=1.0).start()
    try:
        operation.enable_follow(master.url)
        f = operation.follower(master.url)
        operation.enable_follow(master.url)
        assert operation.follower(master.url) is f
        operation.disable_follow(master.url)
        assert operation.follower(master.url) is f
        operation.disable_follow(master.url)
        assert operation.follower(master.url) is None
        assert f._stop.is_set()
    finally:
        master.stop()


def _lookup_rpcs(master_url: str) -> float:
    """The master's count of `/dir/lookup` requests (its /metrics)."""
    text = http_bytes("GET", f"{master_url}/metrics")[1].decode()
    for line in text.splitlines():
        if line.startswith('master_route_requests_total{path="/dir/lookup"}'):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_a_filer_reads_from_the_pushed_map(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE", "0")
    master = MasterServer(pulse_seconds=1.0).start()
    vs = VolumeServer([str(tmp_path / "v0")], device="cpu",
                      master=master.url, pulse_seconds=0.2).start()
    fs = FilerServer(master.url, store_path=str(tmp_path / "filer.db"),
                     collection="follow").start()
    try:
        f = operation.follower(master.url)
        assert f is not None and f.wait_synced(5)
        bodies = {f"/d/f{i}": os.urandom(1000 + i) for i in range(12)}
        for path, body in bodies.items():
            st, _, _ = http_bytes("PUT", f"{fs.url}{path}", body)
            assert st == 201
        vids = {v["id"] for _, v in iter_volume_list_volumes(
            http_json("GET", f"{master.url}/vol/list"))}
        assert vids
        _wait(lambda: all(f.get_locations(v) for v in vids),
              "the follower holds the filer's volumes")
        lookups = _lookup_rpcs(master.url)
        served = vs.read_plane.served() + vs.uds_server.served
        for path, body in bodies.items():
            st, got, _ = http_bytes("GET", f"{fs.url}{path}")
            assert st == 200 and got == body
        assert vs.read_plane.served() + vs.uds_server.served > served
        assert _lookup_rpcs(master.url) == lookups
    finally:
        fs.stop()
        vs.stop()
        master.stop()
    assert operation.follower(master.url) is None
