"""The port's write path on the CPU, against the JAX package's.
Tolerance: exact equality (ids, placements, bytes, JSON answers).

- the file-id sequencers, and the topology's write placement
  (`writable_volumes`, `pick_for_write`, `plan_growth`) fed the same
  heartbeats, with `random` seeded alike for the growth's tie-break;
- the same `POST`/`PUT` of a needle to a port volume server and a JAX
  one: the same answers (201, `unchanged`, a bad cookie, an unknown or
  read-only volume) and a byte-identical `.dat` and `.idx`;
- the JAX client verbs (`assign`, `upload`, `read`, `delete`,
  `submit`) against the port's cluster, and the port's against the JAX
  cluster;
- the master's growth: an empty cluster grows on the first assign,
  concurrent assigns grow one set between them, a refused allocation
  is rolled back, a volume over the size limit stops being picked;
- replication `001` and `010` on every replica, and no ack when a
  replica is gone; `count=N` ranges and the keys `assign_and_upload`
  derives from them; `run_benchmark`'s answer;
- a fill through the front door, the detected EC job on the CPU codec,
  every fid read back, and the shards equal to the JAX package's
  `write_ec_files` on a copy of the filled `.dat`;
- `master -defaultReplication`, `volume -max -dataCenter -rack`,
  `upload`, `download` and `benchmark` on the command line.

Needles of 1-64 KiB, volume limits of 1-2 MiB.  Volume servers pulse
every `PULSE` seconds; masters drop a server after 3 x `MASTER_PULSE`.
"""

import json
import os
import random
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu import benchmark as ref_benchmark
from seaweedfs_tpu import operation as ref_operation
from seaweedfs_tpu import sequence as ref_sequence
from seaweedfs_tpu.server import master_server as ref_master_mod
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.ec_context import (
    ECContext as RefContext)
from seaweedfs_tpu.topology.topology import Topology as RefTopology
from seaweedfs_tpu_torch import benchmark, operation, sequence
from seaweedfs_tpu_torch.plugin import (AdminServer, EcEncodeHandler,
                                        EcRebuildHandler, PluginWorker)
from seaweedfs_tpu_torch.server import master_server as master_mod
from seaweedfs_tpu_torch.server.httpd import HttpServer, http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage import idx, types
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.topology import iter_volume_list_volumes
from seaweedfs_tpu_torch.topology.topology import Topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PULSE = 0.2
MASTER_PULSE = 1.0


def _wait(cond, what: str, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


class Cluster:
    """A master and volume servers in this process, of the port ("port")
    or of the JAX package ("ref"); `racks` gives each server's rack."""

    def __init__(self, tmp_path, kind: str = "port",
                 racks=("r1", "r1", "r2"), size_limit_mb: int = 64,
                 max_volumes: int = 8, default_replication: str = "000",
                 master_pulse: float = MASTER_PULSE):
        self.made = []
        mcls = MasterServer if kind == "port" else RefMaster
        self.master = self._start(mcls(
            volume_size_limit_mb=size_limit_mb,
            default_replication=default_replication,
            pulse_seconds=master_pulse))
        self.url = self.master.url
        self.dirs, self.servers = [], []
        for i, rack in enumerate(racks):
            d = str(tmp_path / f"{kind}{i}")
            os.makedirs(d)
            if kind == "port":
                vs = VolumeServer([d], device="cpu", master=self.url,
                                  pulse_seconds=PULSE, rack=rack,
                                  max_volume_count=max_volumes)
            else:
                vs = RefServer([d], self.url, pulse_seconds=PULSE,
                               rack=rack, max_volume_count=max_volumes)
            self.servers.append(self._start(vs))
            self.dirs.append(d)
        _wait(lambda: len(self.get("/cluster/status").get(
            "dataNodes", [])) == len(racks), "servers registered")

    def _start(self, server):
        server.start()
        self.made.append(server)
        return server

    def stop(self, server) -> None:
        server.stop()
        self.made.remove(server)

    def close(self) -> None:
        for s in reversed(self.made):
            s.stop()

    def get(self, path: str) -> dict:
        return http_json("GET", f"{self.url}{path}", timeout=10)

    def volumes(self) -> "dict[int, list[dict]]":
        """vid -> the /vol/list entries of its replicas."""
        out: dict[int, list[dict]] = {}
        for _node, v in iter_volume_list_volumes(self.get("/vol/list")):
            out.setdefault(v["id"], []).append(v)
        return out

    def dir_of(self, url: str) -> str:
        return self.dirs[[s.url for s in self.servers].index(url)]


def _records(d: str, vid: int, collection: str = "") -> dict:
    """key -> the live needle record of volume vid in directory d."""
    base = os.path.join(d, (f"{collection}_" if collection else "") +
                        str(vid))
    dat = _read(base + ".dat")
    out = {}
    for key, (off, size) in idx.live_entries(_read(base + ".idx")).items():
        start = types.to_actual_offset(off)
        out[key] = Needle.from_bytes(dat[start:], types.CURRENT_VERSION,
                                     expected_size=size)
    return out


def _same_needle(a: Needle, b: Needle) -> bool:
    """Equal records up to AppendAtNs, which each replica stamps."""
    fields = ("cookie", "id", "size", "data", "flags", "name", "mime",
              "last_modified", "ttl", "checksum")
    return all(getattr(a, f) == getattr(b, f) for f in fields)


# --- sequencers ---------------------------------------------------------------

def test_memory_sequencer_matches_reference():
    port, ref = sequence.MemorySequencer(), ref_sequence.MemorySequencer()
    assert port.reserves_ranges is ref.reserves_ranges is True
    rng = np.random.default_rng(0)
    for _ in range(200):
        if rng.integers(2):
            count = int(rng.integers(1, 20))
            assert port.next_file_id(count) == ref.next_file_id(count)
        else:
            # around the boundary: seen == the counter must bump it
            seen = port.peek() + int(rng.integers(-3, 4))
            port.set_max(seen)
            ref.set_max(seen)
        assert port.peek() == ref.peek()
    s = sequence.MemorySequencer(10)
    s.set_max(10)
    assert s.next_file_id() == 11
    s.set_max(5)
    assert s.next_file_id(3) == 12 and s.peek() == 15


def test_snowflake_sequencer_matches_reference(monkeypatch):
    port, ref = sequence.SnowflakeSequencer(7), \
        ref_sequence.SnowflakeSequencer(7)
    assert port.reserves_ranges is ref.reserves_ranges is False
    # three ids a millisecond, then a jump
    clock = [1.7e9 + (i // 3) / 1000 for i in range(30)] + [1.8e9]
    ids = []
    for seq in (port, ref):
        ticks = iter(clock)
        monkeypatch.setattr(sequence.time, "time", lambda: next(ticks))
        ids.append([seq.next_file_id() for _ in clock])
    assert ids[0] == ids[1]
    assert ids[0] == sorted(set(ids[0]))
    assert {(i >> 12) & 1023 for i in ids[0]} == {7}
    port.set_max(1 << 62)
    for cls in (sequence.SnowflakeSequencer, ref_sequence.SnowflakeSequencer):
        with pytest.raises(ValueError):
            cls(1024)


# --- write placement ----------------------------------------------------------

def _heartbeats() -> "list[dict]":
    def vol(vid, col="", rp=0, size=100, ro=False, ttl=0):
        return {"id": vid, "collection": col, "size": size,
                "replicaPlacement": rp, "readOnly": ro, "ttl": ttl}
    return [
        {"ip": "10.0.0.1", "port": 1, "dataCenter": "dc1", "rack": "r1",
         "maxVolumeCount": 8, "volumes": [
             vol(1), vol(2, rp=1), vol(3, col="pics"), vol(4, ro=True),
             vol(5, size=5000), vol(6, ttl=0x0305), vol(11)]},
        {"ip": "10.0.0.2", "port": 2, "dataCenter": "dc1", "rack": "r1",
         "maxVolumeCount": 4, "volumes": [vol(2, rp=1), vol(12, rp=1)]},
        {"ip": "10.0.0.3", "port": 3, "dataCenter": "dc1", "rack": "r2",
         "maxVolumeCount": 6, "volumes": [vol(7, rp=10), vol(13)]},
        {"ip": "10.0.0.4", "port": 4, "dataCenter": "dc2", "rack": "r1",
         "maxVolumeCount": 3, "volumes": [vol(7, rp=10), vol(8, rp=100)]},
        {"ip": "10.0.0.5", "port": 5, "dataCenter": "dc1", "rack": "r2",
         "maxVolumeCount": 8, "volumes": [vol(9), vol(8, rp=100)]},
        {"ip": "10.0.0.6", "port": 6, "dataCenter": "dc2", "rack": "r3",
         "maxVolumeCount": 2, "volumes": [vol(14), vol(15)]},
    ]


def _answer(fn):
    """A call's result, or its exception's type and message."""
    try:
        return fn()
    except LookupError as e:
        return (type(e).__name__, str(e))


def test_write_placement_matches_reference():
    topos = [cls(volume_size_limit=1000, pulse_seconds=1.0)
             for cls in (Topology, RefTopology)]
    for t in topos:
        for hb in _heartbeats():
            t.register_heartbeat(hb)
        t.mark_dead("10.0.0.5:5")   # its volumes leave the writable set

    def urls(groups):
        return sorted((vid, [n.url for n in nodes]) for vid, nodes in groups)
    for spec in [("", "", 0), ("", "000", 0), ("", "001", 0),
                 ("", "010", 0), ("", "100", 0), ("pics", "", 0),
                 ("", "", 0x0305), ("none", "", 0)]:
        got = [urls(t.writable_volumes(*spec)) for t in topos]
        assert got[0] == got[1], spec
    for spec in [("", ""), ("", "001"), ("none", "")]:
        picks = [[_answer(lambda: (lambda p: (p[0], [n.url for n in p[1]]))(
            t.pick_for_write(*spec))) for _ in range(9)] for t in topos]
        assert picks[0] == picks[1], spec
    for rep in ("000", "001", "010", "100", "011", "110", "002", "200"):
        for exclude in (None, {"10.0.0.1:1"}, {"10.0.0.3:3", "10.0.0.2:2"}):
            for seed in range(4):
                plans = []
                for t in topos:
                    random.seed(seed)
                    plans.append(_answer(lambda: [
                        n.url for n in t.plan_growth(rep, exclude=exclude)]))
                assert plans[0] == plans[1], (rep, exclude, seed)
    assert [t.next_volume_id() for t in topos] == [16, 16]
    for rep in ("", "000", "001", "011", "200", "x"):
        assert master_mod._growth_plan(rep) == ref_master_mod._growth_plan(rep)


# --- a needle POST against the JAX volume server --------------------------------

@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages' volumes stamp AppendAtNs from one fixed clock, so
    that two servers write byte-identical records."""
    def stamp(self):
        self.last_append_at_ns = max(1_700_000_000_000_000_000,
                                     self.last_append_at_ns + 1)
        return self.last_append_at_ns
    monkeypatch.setattr(port_volume.Volume, "_next_append_at_ns", stamp)
    monkeypatch.setattr(ref_volume.Volume, "_next_append_at_ns", stamp)


def test_post_writes_the_reference_needle_record(tmp_path, fixed_clock):
    master = MasterServer(pulse_seconds=MASTER_PULSE).start()
    dirs = [str(tmp_path / "port"), str(tmp_path / "ref")]
    port = VolumeServer([dirs[0]], device="cpu", master=master.url,
                        pulse_seconds=PULSE).start()
    ref = RefServer([dirs[1]], master.url, pulse_seconds=PULSE).start()
    try:
        def both(method, path, body=None, headers=None, payload=None):
            out = []
            for vs in (port, ref):
                if payload is not None:
                    out.append(http_json(method, f"{vs.url}{path}", payload,
                                         timeout=30))
                else:
                    st, data, _ = http_bytes(method, f"{vs.url}{path}", body,
                                             headers=headers, timeout=30)
                    out.append((st, json.loads(data)))
            assert out[0] == out[1], (method, path, out)
            return out[0]
        for vid, col, ttl in ((7, "", ""), (8, "t", "5m")):
            assert both("POST", "/admin/allocate_volume", payload={
                "volumeId": vid, "collection": col, "replication": "000",
                "ttl": ttl}) == {}
        rng = np.random.default_rng(11)
        fid = lambda vid, key, cookie: str(  # noqa: E731
            types.FileId(vid, key, cookie))
        bodies = {k: rng.bytes(int(rng.integers(1 << 10, 64 << 10)))
                  for k in range(1, 7)}
        ts = "?ts=1700000000"
        assert both("POST", f"/{fid(7, 1, 0xAB)}{ts}&name=a.png", bodies[1],
                    {"Content-Type": "image/png"}) == (201, {
                        "name": "a.png", "size": len(bodies[1]),
                        "eTag": _etag(bodies[1]), "unchanged": False})
        both("PUT", f"/{fid(7, 2, 0xCD)}{ts}", bodies[2],
             {"Content-Type": "application/octet-stream"})
        both("POST", f"/{fid(8, 3, 0xEF)}{ts}&name=t.bin", bodies[3])
        # a re-POST of the same needle is unchanged
        st, r = both("POST", f"/{fid(7, 1, 0xAB)}{ts}&name=a.png", bodies[1],
                     {"Content-Type": "image/png"})
        assert st == 201 and r["unchanged"] is True
        # an overwrite must bring the needle's cookie
        st, r = both("POST", f"/{fid(7, 1, 0x99)}{ts}", bodies[4])
        assert st == 500 and "cookie" in r["error"]
        assert both("POST", f"/{fid(7, 1, 0xAB)}{ts}", bodies[4])[0] == 201
        assert both("POST", f"/{fid(99, 5, 1)}{ts}", bodies[5])[0] == 404
        both("POST", "/admin/set_readonly",
             payload={"volumeId": 7, "readOnly": True})
        assert both("POST", f"/{fid(7, 6, 1)}{ts}", bodies[6])[0] == 409
        for name in ("7.dat", "7.idx", "t_8.dat", "t_8.idx"):
            assert _read(os.path.join(dirs[0], name)) == \
                _read(os.path.join(dirs[1], name)), name
        assert _records(dirs[0], 8, "t")[3].ttl.to_u32() != 0
        # what the port wrote reads back through both
        for vs in (port, ref):
            st, data, hdrs = http_bytes("GET", f"{vs.url}/{fid(7, 2, 0xCD)}")
            assert (st, data) == (200, bodies[2])
    finally:
        port.stop()
        ref.stop()
        master.stop()


def _etag(data: bytes) -> str:
    n = Needle(cookie=1, id=1, data=data)
    n.to_bytes()   # computes the checksum
    return n.etag()


# --- cross-wire ---------------------------------------------------------------

@pytest.mark.parametrize("cluster_kind,client", [
    ("port", ref_operation), ("ref", operation)],
    ids=["jax-client-on-port", "port-client-on-jax"])
def test_client_verbs_cross_wire(tmp_path, cluster_kind, client):
    c = Cluster(tmp_path, cluster_kind, racks=("r1", "r1"))
    try:
        rng = np.random.default_rng(3)
        a = client.assign(c.url, collection="x")
        body = rng.bytes(5000)
        r = client.upload(a.url, a.fid, body, name="n.bin", mime="text/plain")
        assert r["size"] == len(body) and r["name"] == "n.bin"
        assert client.read(c.url, a.fid) == body
        assert client.read(c.url, a.fid, offset=10, size=20) == body[10:30]
        fids = {client.submit(c.url, rng.bytes(n), replication="001"): n
                for n in (1000, 2000, 3000)}
        for fid in fids:
            vid = int(fid.split(",")[0])
            assert len(client.lookup(c.url, vid)) == 2
            assert len(client.read(c.url, fid)) == fids[fid]
        client.delete(c.url, a.fid)
        with pytest.raises(RuntimeError):
            client.read(c.url, a.fid)
        client.delete(c.url, a.fid)   # all 404: already gone
        with pytest.raises(client.UploadError) as e:
            client.upload(c.servers[0].url, "99,0100000001", b"x")
        assert e.value.status == 404
    finally:
        c.close()


# --- growth -------------------------------------------------------------------

def test_empty_cluster_grows_on_first_assign(tmp_path):
    c = Cluster(tmp_path, racks=("r1", "r1"), max_volumes=64)
    try:
        assert c.volumes() == {}
        a = operation.assign(c.url)
        # 7 for one copy, capped at one per 16 free slots: 128 // 16 = 8
        assert len(c.volumes()) == 7
        assert int(a.fid.split(",")[0]) in c.volumes()
        assert operation.assign(c.url, replication="001").count == 1
        grown = {vid: len(vs) for vid, vs in c.volumes().items()}
        # 121 free slots left: 121 // (16 x 2 copies) = 3 sets of 001
        assert sorted(grown.values()) == [1] * 7 + [2] * 3, grown
        r = http_json("POST", f"{c.url}/vol/grow",
                      {"collection": "g", "count": 2})
        assert len(r["volumeIds"]) == 2
    finally:
        c.close()


def test_concurrent_assigns_grow_one_set(tmp_path):
    c = Cluster(tmp_path, racks=("r1", "r1"))
    try:
        go = threading.Barrier(8)
        out = []

        def one():
            go.wait(timeout=10)
            out.append(operation.assign(c.url, collection="c"))
        threads = [threading.Thread(target=one) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert len(out) == 8
        assert len(c.volumes()) == 1   # 16 free slots: one volume a round
        assert {a.fid.split(",")[0] for a in out} == \
            {str(vid) for vid in c.volumes()}
        keys = [types.parse_file_id(a.fid).key for a in out]
        assert len(set(keys)) == 8
    finally:
        c.close()


def test_refused_allocation_is_rolled_back(tmp_path):
    """Under 001, the node with the most free slots takes the first
    copy; the next refuses, so the first is rolled back and the set is
    planned again without the refuser."""
    c = Cluster(tmp_path, racks=("r1", "r1"), master_pulse=5.0)
    for vs, slots in zip(c.servers, (8, 6)):
        for loc in vs.store.locations:
            loc.max_volume_count = slots
        vs._heartbeat_once()
    stub = HttpServer()
    stub.route("POST", "/admin/allocate_volume",
               lambda req: (500, {"error": "disk full"}))
    stub.start()
    try:
        http_json("POST", f"{c.url}/heartbeat", {
            "ip": "127.0.0.1", "port": stub.port, "rack": "r1",
            "maxVolumeCount": 7, "volumes": []})
        a = operation.assign(c.url, replication="001")
        vid = int(a.fid.split(",")[0])
        assert vid == 2
        assert {v["id"] for v in c.volumes()[2]} == {2} and \
            len(c.volumes()[2]) == 2
        assert 1 not in c.volumes()
        assert not any(os.path.exists(os.path.join(d, "1.dat"))
                       for d in c.dirs)
        assert os.path.exists(os.path.join(c.dirs[0], "2.dat")) and \
            os.path.exists(os.path.join(c.dirs[1], "2.dat"))
    finally:
        stub.stop()
        c.close()


def test_full_volume_stops_being_picked(tmp_path):
    c = Cluster(tmp_path, racks=("r1",), size_limit_mb=1)
    try:
        rng = np.random.default_rng(5)
        first = operation.assign(c.url)
        vid = int(first.fid.split(",")[0])
        operation.upload(first.url, first.fid, rng.bytes(60 << 10))
        for _ in range(18):
            a = operation.assign(c.url)
            assert int(a.fid.split(",")[0]) == vid
            operation.upload(a.url, a.fid, rng.bytes(60 << 10))

        def moved():
            a = operation.assign(c.url)
            operation.upload(a.url, a.fid, rng.bytes(1 << 10))
            return int(a.fid.split(",")[0]) != vid
        _wait(moved, "an assign past the full volume")
        assert c.volumes()[vid][0]["size"] >= 1 << 20
    finally:
        c.close()


# --- replication --------------------------------------------------------------

def test_replication_writes_every_replica_and_needs_them(tmp_path):
    c = Cluster(tmp_path)
    try:
        rng = np.random.default_rng(8)
        acked = {}
        for rep in ("001", "010"):
            for _ in range(6):
                body = rng.bytes(int(rng.integers(1 << 10, 64 << 10)))
                a, r = operation.assign_and_upload(
                    c.url, body, name="r.bin", mime="text/x", replication=rep)
                acked[a.fid] = (rep, body, r["eTag"])
        for fid, (rep, body, etag) in acked.items():
            f = types.parse_file_id(fid)
            locs = [loc["url"] for loc in operation.lookup(c.url,
                                                           f.volume_id)]
            assert len(locs) == 2
            racks = {c.servers[[s.url for s in c.servers].index(u)].rack
                     for u in locs}
            assert len(racks) == (1 if rep == "001" else 2), (rep, locs)
            recs = [_records(c.dir_of(u), f.volume_id)[f.key] for u in locs]
            assert recs[0].data == body and recs[0].etag() == etag
            assert _same_needle(*recs), fid
            for u in locs:
                assert http_bytes("GET", f"{u}/{fid}")[:2] == (200, body)
        # the second holder of a 001 volume goes away
        fid = next(f for f, v in acked.items() if v[0] == "001")
        f = types.parse_file_id(fid)
        a = operation.assign(c.url, replication="001")
        vid = int(a.fid.split(",")[0])
        holders = [loc["url"] for loc in operation.lookup(c.url, vid)]
        second = next(s for s in c.servers
                      if s.url in holders and s.url != a.url)
        c.stop(second)
        st, body, _ = http_bytes("POST", f"{a.url}/{a.fid}", b"no ack")
        assert st == 500 and json.loads(body)["error"].startswith(
            "replication: "), body
        _wait(lambda: second.url not in
              c.get("/cluster/status")["dataNodes"], "master drops it")
        st, body, _ = http_bytes("POST", f"{a.url}/{a.fid}", b"no ack")
        assert st == 500 and "copy count [2]" in json.loads(body)["error"]
        # no volume of the stopped holder is handed out: its volumes
        # lack a copy, and no same-rack pair is left to grow one
        with pytest.raises(RuntimeError, match="not enough same-rack"):
            operation.assign(c.url, replication="001")
    finally:
        c.close()


# --- count ranges, assign batching, the benchmark ------------------------------

def test_count_ranges_and_derived_keys(tmp_path, monkeypatch):
    c = Cluster(tmp_path, racks=("r1",))
    try:
        a = operation.assign(c.url, count=5)
        b = operation.assign(c.url)
        assert a.count == 5
        assert types.parse_file_id(b.fid).key == \
            types.parse_file_id(a.fid).key + 5
        # the window cache derives what the JAX one derives
        caches = (operation._AssignCache(), ref_operation._AssignCache())
        got = []
        for cache, cls in zip(caches, (operation.Assignment,
                                       ref_operation.Assignment)):
            cache.put("s", cls(a.fid, a.url, a.public_url, 5))
            got.append([(x.fid, x.count) for x in
                        iter(lambda: cache.take("s"), None)])
        assert got[0] == got[1] and len(got[0]) == 4
        monkeypatch.setenv("SEAWEEDFS_TPU_ASSIGN_BATCH", "4")
        assert operation.assign_batch_size() == \
            ref_operation.assign_batch_size() == 4
        fids = [operation.submit(c.url, b"k" * 100, collection="w")
                for _ in range(6)]
        keys = [types.parse_file_id(f).key for f in fids]
        assert keys[1:4] == [keys[0] + 1, keys[0] + 2, keys[0] + 3]
        assert len({types.parse_file_id(f).cookie for f in fids[:4]}) == 1
        for f in fids:
            assert operation.read(c.url, f) == b"k" * 100
    finally:
        c.close()
    # a clock-derived sequencer reserves no range: the master grants 1
    m = MasterServer()
    m.sequencer = sequence.SnowflakeSequencer()
    m.start()
    vs = VolumeServer([str(tmp_path / "sf")], device="cpu", master=m.url,
                      pulse_seconds=PULSE).start()
    try:
        a = operation.assign(m.url, count=5)
        assert a.count == 1 and \
            (types.parse_file_id(a.fid).key >> 12) & 1023 == 1
    finally:
        vs.stop()
        m.stop()


def test_run_benchmark_answers_as_reference(tmp_path):
    c = Cluster(tmp_path, racks=("r1", "r1"))
    try:
        port = benchmark.run_benchmark(c.url, 200, 1024, 4)
        ref = ref_benchmark.run_benchmark(c.url, 50, 1024, 4)
        assert [list(r) for r in port] == [list(r) for r in ref]
        assert [r["op"] for r in port] == ["write", "read"]
        assert [r["requests"] for r in port] == [200, 200]
        assert benchmark._percentile([1, 2, 3, 4], 50) == \
            ref_benchmark._percentile([1, 2, 3, 4], 50)
    finally:
        c.close()


# --- fill -> detection -> EC job -> reads -------------------------------------

def test_fill_encode_and_read_back(tmp_path, monkeypatch):
    import torch

    from seaweedfs_tpu_torch.storage.erasure_coding import ec_context
    monkeypatch.setattr(ec_context, "DEVICE_BATCH_SIZE", 1 << 20)
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    c = Cluster(tmp_path, size_limit_mb=2)
    admin = worker = None
    try:
        admin = AdminServer(c.url, detection_interval=3600).start()
        worker = PluginWorker(admin.url, c.url, str(tmp_path / "worker"),
                              [EcEncodeHandler(device="cpu"),
                               EcRebuildHandler()], poll_wait=1.0).start()
        rng = np.random.default_rng(21)
        first = int(operation.assign(c.url, collection="fill")
                    .fid.split(",")[0])
        payloads = {}
        while int(operation.assign(c.url, collection="fill")
                  .fid.split(",")[0]) == first:
            body = rng.bytes(int(rng.integers(1 << 10, 64 << 10)))
            payloads[operation.submit(c.url, body, collection="fill")] = body
        filled = {f: b for f, b in payloads.items()
                  if int(f.split(",")[0]) == first}
        holder = c.dir_of(operation.lookup(c.url, first)[0]["url"])
        ref_dir = tmp_path / "ref"
        ref_dir.mkdir()
        for ext in (".dat", ".idx"):
            shutil.copy(os.path.join(holder, f"fill_{first}{ext}"),
                        ref_dir / f"fill_{first}{ext}")
        base = str(ref_dir / f"fill_{first}")
        ref_encoder.write_sorted_file_from_idx(base)
        ref_encoder.write_ec_files(base, RefContext(backend="cpu"))

        _wait(lambda: http_json(
            "POST", f"{admin.url}/maintenance/trigger_detection")["asked"],
              "a detecting worker registered")
        jobs = []
        _wait(lambda: jobs.extend(
            j for j in http_json("GET", f"{admin.url}/maintenance/queue")[
                "jobs"] if j["jobType"] == "erasure_coding") or jobs,
              "detection proposes the encode")
        jid = jobs[0]["jobId"]
        _wait(lambda: http_json(
            "GET", f"{admin.url}/maintenance/job?id={jid}")["status"] in (
                "done", "failed"), "the job ends", timeout=60)
        job = http_json("GET", f"{admin.url}/maintenance/job?id={jid}")
        assert job["status"] == "done" and \
            job["params"]["volumeId"] == first, job
        shards = {}
        for d in c.dirs:
            for name in os.listdir(d):
                m = re.fullmatch(rf"fill_{first}\.ec(\d\d)", name)
                if m:
                    shards[int(m.group(1))] = _read(os.path.join(d, name))
        assert sorted(shards) == list(range(14))
        for sid, data in shards.items():
            assert data == _read(f"{base}.ec{sid:02d}"), sid
        for fid, body in payloads.items():
            assert operation.read(c.url, fid) == body, fid
        assert len(filled) > 10
    finally:
        if worker is not None:
            worker.stop()
        if admin is not None:
            admin.stop()
        c.close()
        torch.set_num_threads(threads)


# --- the command line ---------------------------------------------------------

def _start(args, tmp_path, name):
    p = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                         stdout=subprocess.PIPE, stderr=open(
                             tmp_path / f"{name}.log", "w"),
                         text=True, cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=REPO))
    line = p.stdout.readline()
    m = re.fullmatch(r".* listening on (\S+:\d+)\n", line)
    assert m, (line, _read(tmp_path / f"{name}.log"))
    return p, m.group(1)


def test_write_commands(tmp_path):
    procs = []
    try:
        p, murl = _start(["master", "-port", "0",
                          "-defaultReplication", "001"], tmp_path, "master")
        procs.append(p)
        for i in range(2):
            d = tmp_path / f"v{i}"
            d.mkdir()
            p, _ = _start(["volume", "-dir", str(d), "-port", "0",
                           "-mserver", murl, "-max", "3",
                           "-dataCenter", "dc9", "-rack", "r9"],
                          tmp_path, f"v{i}")
            procs.append(p)
        _wait(lambda: len(http_json("GET", f"{murl}/cluster/status")[
            "dataNodes"]) == 2, "volume servers registered", timeout=30)
        nodes = http_json("GET", f"{murl}/vol/list")["dataCenters"][
            "dc9"]["racks"]["r9"]["nodes"]
        assert [n["maxVolumeCount"] for n in nodes] == [3, 3]
        src = tmp_path / "up.bin"
        src.write_bytes(np.random.default_rng(1).bytes(30_000))

        def cli(*args):
            out = subprocess.run(
                [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                capture_output=True, timeout=120, cwd=str(tmp_path),
                env=dict(os.environ, PYTHONPATH=REPO))
            assert out.returncode == 0, out.stderr
            return out.stdout
        fid = cli("upload", "-master", murl, str(src)).decode().strip()
        assert re.fullmatch(r"\d+,[0-9a-f]+", fid), fid
        assert cli("download", "-master", murl, fid) == src.read_bytes()
        locs = operation.lookup(murl, int(fid.split(",")[0]))
        assert len(locs) == 2   # -defaultReplication 001
        lines = cli("benchmark", "-master", murl, "-n", "40", "-c",
                    "2").decode().splitlines()
        stats = [json.loads(line) for line in lines]
        assert [s["op"] for s in stats] == ["write", "read"]
        assert [s["requests"] for s in stats] == [40, 40]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            assert p.wait(timeout=30) == 0
            p.stdout.close()
