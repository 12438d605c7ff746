"""The port's needle data plane on the CPU, against the JAX package's:
the native write and read planes (`server/write_plane.py`,
`server/read_plane.py`), the volume's native attachment
(`storage/volume.py`) and the client funnel (`operation.py`).
Tolerance: exact equality (records, shards, bytes, counts).

- a record the write plane appends is byte-identical to the port's
  Python-written twin and the JAX package's (AppendAtNs set to 0);
- the same seeded uploads through a JAX cluster and a port cluster read
  back equal through each read plane, each HTTP port and each package's
  `operation.read`;
- overwrites, named and mimed uploads and replicated volumes fall back
  to Python with its full semantics; deletes after a native write;
- a read-only freeze detaches the plane, a thaw attaches it again;
- `/status` and `/metrics` show the planes;
- an undrained native tail is indexed at the next open, and after a
  SIGKILL every acked write reads back;
- `ec.encode` of a volume filled through the write plane gives the
  shards and `.ecx` of the same needles written through Python (CPU
  codec);
- the heartbeat's `maxFileKey` and sizes count undrained appends.
"""

import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu import operation as ref_operation
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu_torch import operation
from seaweedfs_tpu_torch.server import write_plane as wp_mod
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import ECContext
from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
from seaweedfs_tpu_torch.storage.volume import Volume

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the planes")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS = 1722800000


def _wait(cond, what: str, timeout: float = 15.0) -> None:
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out: {what}"
        time.sleep(0.02)


def _payload(i: int, n: int) -> bytes:
    return np.random.default_rng([7, i]).bytes(n)


class PortCluster:
    def __init__(self, tmp, servers: int = 1, replication: str = "000",
                 racks=None):
        self.master = MasterServer(volume_size_limit_mb=64,
                                   default_replication=replication,
                                   pulse_seconds=1.0).start()
        self.url = self.master.url
        self.servers = []
        for i in range(servers):
            d = os.path.join(str(tmp), f"v{i}")
            os.makedirs(d, exist_ok=True)
            self.servers.append(VolumeServer(
                [d], device="cpu", master=self.url, pulse_seconds=0.2,
                rack=(racks or ["r1"] * servers)[i]).start())
        _wait(lambda: len(http_json("GET", f"{self.url}/cluster/status")
                          .get("dataNodes", [])) == servers,
              "servers registered")

    def server_of(self, fid: str) -> VolumeServer:
        vid = types.parse_file_id(fid).volume_id
        return next(s for s in self.servers
                    if s.store.find_volume(vid) is not None)

    def close(self):
        for s in self.servers:
            s.stop()
        self.master.stop()


@pytest.fixture
def cluster(tmp_path):
    c = PortCluster(tmp_path)
    yield c
    c.close()


def _raw_record(v, key: int) -> bytes:
    got = v.nm.get(key)
    with open(v.file_name(".dat"), "rb") as f:
        f.seek(types.to_actual_offset(got[0]))
        return f.read(get_actual_size(got[1], v.version))


@pytest.mark.parametrize("n", [1, 251 * 7, 70_001])
def test_a_native_record_is_the_python_records_twin(cluster, tmp_path, n):
    vs = cluster.servers[0]
    a = operation.assign(cluster.url)
    payload = _payload(n, n)
    st, body, _ = http_bytes(
        "POST", f"127.0.0.1:{vs.write_plane.port}/{a.fid}?ts={TS}", payload)
    assert st == 201, body
    fid = types.parse_file_id(a.fid)
    v = vs.store.find_volume(fid.volume_id)
    v.drain_native()
    raw = _raw_record(v, fid.key)
    native_n = Needle.from_bytes(raw, v.version,
                                 expected_size=v.nm.get(fid.key)[1])
    assert native_n.to_bytes(v.version) == raw
    # the port's Python write of the same needle
    os.makedirs(tmp_path / "port_twin")
    pv = Volume(str(tmp_path / "port_twin"), 99)
    pn = Needle(cookie=fid.cookie, id=fid.key, data=payload)
    pn.set_last_modified(TS)
    pv.write_needle(pn)
    port_twin = Needle.from_bytes(_raw_record(pv, fid.key), pv.version,
                                  expected_size=pv.nm.get(fid.key)[1])
    pv.close()
    # and the JAX package's
    os.makedirs(tmp_path / "ref_twin")
    rv = ref_volume.Volume(str(tmp_path / "ref_twin"), 99)
    rn = RefNeedle(cookie=fid.cookie, id=fid.key, data=payload)
    rn.set_last_modified(TS)
    rv.write_needle(rn)
    got = rv.nm.get(fid.key)
    with open(rv.file_name(".dat"), "rb") as f:
        f.seek(types.to_actual_offset(got[0]))
        ref_raw = f.read(get_actual_size(got[1], rv.version))
    rv.close()
    ref_twin = Needle.from_bytes(ref_raw, v.version, expected_size=got[1])
    for n_ in (native_n, port_twin, ref_twin):
        n_.append_at_ns = 0
    assert native_n.to_bytes(v.version) == port_twin.to_bytes(v.version) \
        == ref_twin.to_bytes(v.version)
    # the plane's answer carries the record's ETag
    assert f'"eTag":"{native_n.etag()}"' in body.decode()


def test_seeded_uploads_read_back_equal_in_both_packages(tmp_path):
    port = PortCluster(tmp_path / "port")
    ref_master = RefMaster(volume_size_limit_mb=64).start()
    os.makedirs(tmp_path / "ref")
    ref_vs = RefServer([str(tmp_path / "ref")], ref_master.url,
                       pulse_seconds=0.2).start()
    try:
        assert ref_vs.write_plane is not None and ref_vs.read_plane
        vs = port.servers[0]
        sizes = [1, 1024, 4096, 65_537, 300_000]
        fids = {"port": [], "ref": []}
        for i, n in enumerate(sizes * 3):
            fids["port"].append((operation.submit(port.url, _payload(i, n)),
                                 _payload(i, n)))
            fids["ref"].append((ref_operation.submit(ref_master.url,
                                                     _payload(i, n)),
                                _payload(i, n)))
        assert vs.write_plane.requests() == len(fids["port"])
        assert ref_vs.write_plane.requests() == len(fids["ref"])
        for kind, server, murl in (("port", vs, port.url),
                                   ("ref", ref_vs, ref_master.url)):
            for fid, want in fids[kind]:
                _wait(lambda: http_bytes(
                    "GET", f"127.0.0.1:{server.read_plane.port}/{fid}"
                )[0] == 200, f"{kind} {fid} registered")
                for url in (f"127.0.0.1:{server.read_plane.port}",
                            server.url):
                    st, body, _ = http_bytes("GET", f"{url}/{fid}")
                    assert st == 200 and body == want, (kind, url, fid)
                assert operation.read(murl, fid) == want
                assert ref_operation.read(murl, fid) == want
        # the port's reads went through its read plane
        assert vs.read_plane.served() >= 3 * len(fids["port"])
    finally:
        ref_vs.stop()
        ref_master.stop()
        port.close()


def test_what_the_plane_does_not_own_falls_back_to_python(tmp_path):
    c = PortCluster(tmp_path, servers=2, racks=["r1", "r1"])
    try:
        a = operation.assign(c.url)
        vs = c.server_of(a.fid)
        wp = vs.write_plane
        before = wp.requests(), wp.fallbacks()
        assert operation.upload(a.url, a.fid, b"first")["size"] == 5
        assert wp.requests() == before[0] + 1
        rp_url = f"127.0.0.1:{vs.read_plane.port}/{a.fid}"
        _wait(lambda: http_bytes("GET", rp_url)[1] == b"first",
              "the native write registered")
        # an overwrite of a key the plane has seen: 404 on the plane,
        # the Python port's cookie and dedup rules
        st, _, _ = http_bytes(
            "POST", f"127.0.0.1:{wp.port}/{a.fid}", b"second")
        assert st == 404 and wp.fallbacks() == before[1] + 1
        r = operation.upload(a.url, a.fid, b"second")
        assert r["size"] == 6 and not r["unchanged"]
        # the acked overwrite is what the read plane serves at once
        assert http_bytes("GET", rp_url)[:2] == (200, b"second")
        # a named overwrite is not plain: the plane drops the needle
        r = operation.upload(a.url, a.fid, b"third", name="t.txt")
        assert http_bytes("GET", rp_url)[0] == 404
        assert operation.read(c.url, a.fid) == b"third"
        fid = types.parse_file_id(a.fid)
        bad = types.FileId(fid.volume_id, fid.key, fid.cookie ^ 1)
        with pytest.raises(operation.UploadError):
            operation.upload(a.url, str(bad), b"fourth")
        assert operation.read(c.url, a.fid) == b"third"
        assert operation.upload(a.url, a.fid, b"third",
                                name="t.txt")["unchanged"]
        # named and mimed uploads go to Python, never to the plane
        n0 = wp.requests()
        b = operation.assign(c.url)
        operation.upload(b.url, b.fid, b"named", name="n.txt")
        m = operation.assign(c.url)
        operation.upload(m.url, m.fid, b"mimed", mime="text/plain")
        assert wp.requests() == n0
        st, body, hdrs = http_bytes("GET", f"{b.url}/{b.fid}")
        assert body == b"named"
        st, body, hdrs = http_bytes("GET", f"{m.url}/{m.fid}")
        assert body == b"mimed" and hdrs["Content-Type"] == "text/plain"
        v = vs.store.find_volume(types.parse_file_id(b.fid).volume_id)
        assert v.read_needle(types.parse_file_id(b.fid).key).name == \
            b"n.txt"
        # a replicated volume is never attached: both copies by Python
        fid = operation.submit(c.url, b"replicated", replication="001")
        vid = types.parse_file_id(fid).volume_id
        holders = [s for s in c.servers if s.store.find_volume(vid)]
        assert len(holders) == 2
        for s in holders:
            assert s.store.find_volume(vid)._wp is None
            st, body, _ = http_bytes("GET", f"{s.url}/{fid}")
            assert body == b"replicated"
        assert sum(s.write_plane.requests() for s in c.servers) == \
            before[0] + 1
    finally:
        c.close()


def test_deletes_after_a_native_write(cluster):
    vs = cluster.servers[0]
    fids = [operation.submit(cluster.url, _payload(i, 2000))
            for i in range(6)]
    # the plane counts a request after its client has the ack
    _wait(lambda: vs.write_plane.requests() >= 6, "6 native writes")
    assert vs.write_plane.requests() == 6
    for fid in fids:
        _wait(lambda: operation._read_via_read_plane(
            [{"url": vs.url}], fid) is not None, "registered")
    # deleted while still in the plane's journal, and after its drain
    operation.delete(cluster.url, fids[0])
    vs._wp_tick()
    operation.delete(cluster.url, fids[1])
    for fid in fids[:2]:
        st, _, _ = http_bytes("GET", f"{vs.url}/{fid}")
        assert st == 404
        st, _, _ = http_bytes(
            "GET", f"127.0.0.1:{vs.read_plane.port}/{fid}")
        assert st == 404
        with pytest.raises(RuntimeError):
            operation.read(cluster.url, fid)
    for i, fid in enumerate(fids[2:], 2):
        assert operation.read(cluster.url, fid) == _payload(i, 2000)
    v = vs.store.find_volume(types.parse_file_id(fids[0]).volume_id)
    assert v.deleted_count() == 2 and v.file_count() == 6


def test_a_freeze_detaches_and_a_thaw_attaches(cluster):
    vs = cluster.servers[0]
    fid = operation.submit(cluster.url, b"before")
    vid = types.parse_file_id(fid).volume_id
    v = vs.store.find_volume(vid)
    assert v._wp is vs.write_plane
    http_json("POST", f"{vs.url}/admin/set_readonly",
              {"volumeId": vid, "readOnly": True})
    assert v._wp is None and v.read_only
    # a frozen volume refuses the plane, and Python refuses the write
    a = types.parse_file_id(fid)
    nxt = str(types.FileId(vid, a.key + 1000, a.cookie))
    st, _, _ = http_bytes(
        "POST", f"127.0.0.1:{vs.write_plane.port}/{nxt}", b"frozen")
    assert st == 404
    with pytest.raises(operation.UploadError) as e:
        operation.upload(vs.url, nxt, b"frozen")
    assert e.value.status == 409
    http_json("POST", f"{vs.url}/admin/set_readonly",
              {"volumeId": vid, "readOnly": False})
    assert v._wp is vs.write_plane
    # the client remembers the frozen plane's 404 for 2 s a volume
    operation._plane_vid_misses().clear()
    n0 = vs.write_plane.requests()
    assert operation.upload(vs.url, nxt, b"thawed")["size"] == 6
    assert vs.write_plane.requests() == n0 + 1
    assert operation.read(cluster.url, nxt) == b"thawed"
    assert operation.read(cluster.url, fid) == b"before"


def test_status_and_metrics_show_the_planes(cluster, monkeypatch):
    vs = cluster.servers[0]
    st = http_json("GET", f"{vs.url}/status")
    assert st["readPlanePort"] == vs.read_plane.port > 0
    assert st["writePlanePort"] == vs.write_plane.port > 0
    for i in range(3):
        fid = operation.submit(cluster.url, _payload(i, 100))
        assert operation.read(cluster.url, fid) == _payload(i, 100)
    _, body, _ = http_bytes("GET", f"{vs.url}/metrics")
    text = body.decode()
    assert "volume_server_write_plane_requests_total 3" in text
    assert "volume_server_write_plane_fallbacks_total 0" in text
    assert 'volume_server_write_plane_ack_seconds_bucket{le="+Inf"} 3' \
        in text
    assert "volume_server_write_plane_ack_seconds_count 3" in text
    assert "volume_server_read_plane_requests_total" in text
    # SEAWEEDFS_TPU_WRITE_PLANE=0 turns the write plane off
    monkeypatch.setenv("SEAWEEDFS_TPU_WRITE_PLANE", "0")
    d = os.path.join(os.path.dirname(vs.store.locations[0].directory), "x")
    off = VolumeServer([d], device="cpu").start()
    try:
        st = http_json("GET", f"{off.url}/status")
        assert st["writePlanePort"] == 0 and st["readPlanePort"] > 0
        assert "write_plane" not in http_bytes(
            "GET", f"{off.url}/metrics")[1].decode()
    finally:
        off.stop()


def test_an_undrained_native_tail_is_indexed_at_open(tmp_path):
    """The plane acked, its journal never reached the .idx (no drain):
    the next open replays the .dat tail."""
    os.makedirs(tmp_path / "v")
    v = Volume(str(tmp_path / "v"), 5)
    wp = wp_mod.WritePlane()           # no pump: nothing is drained
    try:
        pn = Needle(cookie=0x1234, id=1, data=b"python")
        pn.set_last_modified(TS)
        v.write_needle(pn)
        assert v.attach_native(wp)
        for key in range(2, 8):
            st, body, _ = http_bytes(
                "POST", f"127.0.0.1:{wp.port}/5,{key:x}00001234",
                _payload(key, 3000))
            assert st == 201, body
        assert wp.pending(5) == 6
        # the process dies here: the .idx holds the Python write only
        with open(v.file_name(".idx"), "rb") as f:
            assert len(f.read()) == 16
        reopened = Volume(str(tmp_path / "v"), 5)
        for key in range(2, 8):
            assert reopened.read_needle(key).data == _payload(key, 3000)
        assert reopened.read_needle(1).data == b"python"
        assert reopened.file_count() == 7 and reopened.max_file_key() == 7
        # idempotent: a second open finds nothing to add
        reopened.close()
        again = Volume(str(tmp_path / "v"), 5)
        assert again.file_count() == 7
        again.close()
    finally:
        wp.remove_volume(5)
        wp.stop()


def test_a_torn_tail_is_not_indexed(tmp_path):
    os.makedirs(tmp_path / "v")
    v = Volume(str(tmp_path / "v"), 6)
    for key in (1, 2):
        v.write_needle(Needle(cookie=1, id=key, data=_payload(key, 500)))
    v.close()
    rec = Needle(cookie=1, id=3, data=_payload(3, 500)).to_bytes(
        types.CURRENT_VERSION)
    with open(os.path.join(tmp_path, "v", "6.dat"), "ab") as f:
        f.write(rec[:-20])                 # half a record
    again = Volume(str(tmp_path / "v"), 6)
    assert again.file_count() == 2 and again.nm.get(3) is None
    again.close()


def test_a_decoded_volume_keeps_its_deletes(tmp_path):
    """An `.idx` decoded from an `.ecx` is in key order, so its last put
    need not be the furthest record: the tail replay starts past the
    furthest put, or it would index a needle the `.ecj` deleted."""
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_decoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import (
        EcVolume)
    d = tmp_path / "v"
    os.makedirs(d)
    v = Volume(str(d), 8)
    for key in (9, 3, 1):               # appended out of key order
        v.write_needle(Needle(cookie=1, id=key, data=_payload(key, 4000)))
    v.close()
    base = str(d / "8")
    ctx = ECContext(10, 4, "", 8, device="cpu")
    ec_encoder.write_sorted_file_from_idx(base)
    ec_encoder.write_ec_files(base, ctx)
    ec_encoder.save_ec_volume_info(base, ctx, os.path.getsize(base + ".dat"),
                                   types.CURRENT_VERSION)
    ev = EcVolume(str(d), 8)
    ev.delete_needle(3)                 # between the two live records
    ev.close()
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    ec_decoder.write_dat_file(
        base, ec_decoder.find_dat_file_size(base, base),
        [f"{base}.ec{i:02d}" for i in range(10)])
    ec_decoder.write_idx_file_from_ec_index(base)
    decoded = Volume(str(d), 8)
    try:
        with pytest.raises(KeyError):   # not found: deleted before decode
            decoded.read_needle(3)
        for key in (1, 9):
            assert decoded.read_needle(key).data == _payload(key, 4000)
        assert decoded.file_count() == 2
    finally:
        decoded.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _volume_proc(d: str, port: int, master: str) -> subprocess.Popen:
    p = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume", "-dir", d,
         "-port", str(port), "-mserver", master, "-device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert "listening" in p.stdout.readline()
    return p


def test_every_acked_write_survives_a_sigkill(tmp_path):
    master = MasterServer(volume_size_limit_mb=64,
                          pulse_seconds=1.0).start()
    d = str(tmp_path / "v")
    port = _free_port()
    proc = _volume_proc(d, port, master.url)
    try:
        acked = [(operation.submit(master.url, _payload(i, 5000)), i)
                 for i in range(40)]
        url = f"127.0.0.1:{port}"
        assert http_json("GET", f"{url}/status")["writePlanePort"] > 0
        proc.send_signal(signal.SIGKILL)
        proc.wait(10)
        proc = _volume_proc(d, port, master.url)
        operation._invalidate_status(url)
        for fid, i in acked:
            st, body, _ = http_bytes("GET", f"{url}/{fid}")
            assert st == 200 and body == _payload(i, 5000), fid
            assert operation.read(master.url, fid) == _payload(i, 5000)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(20)
        master.stop()


def _needles_of(dat_path: str) -> list:
    """The records of a .dat in append order."""
    return [n for n, _ in ref_volume.walk_dat(dat_path)]


def test_ec_encode_of_a_native_fill_equals_the_python_fill(cluster,
                                                           tmp_path):
    vs = cluster.servers[0]
    fids = [operation.submit(cluster.url, _payload(i, 1000 + 997 * i))
            for i in range(60)]
    assert vs.write_plane.requests() == 60
    vid = types.parse_file_id(fids[0]).volume_id
    assert {types.parse_file_id(f).volume_id for f in fids} == {vid}
    v = vs.store.find_volume(vid)
    dat = v.file_name(".dat")
    http_json("POST", f"{vs.url}/admin/set_readonly",
              {"volumeId": vid, "readOnly": True})
    r = http_json("POST", f"{vs.url}/admin/ec/generate", {"volumeId": vid})
    assert "error" not in r, r
    base = v.file_name("")
    # the same needles written through Python, each at its record's clock
    os.makedirs(tmp_path / "twin")
    twin = Volume(str(tmp_path / "twin"), vid)
    for rn in _needles_of(dat):
        n = Needle(cookie=rn.cookie, id=rn.id, data=rn.data)
        n.set_last_modified(rn.last_modified)
        twin._next_append_at_ns = lambda ns=rn.append_at_ns: ns
        twin.write_needle(n)
    twin.sync()
    with open(dat, "rb") as a, open(twin.file_name(".dat"), "rb") as b:
        assert a.read() == b.read()
    tbase = twin.file_name("")
    twin.close()
    ec_encoder.write_sorted_file_from_idx(tbase)
    ec_encoder.write_ec_files(tbase, ECContext(10, 4, "", vid,
                                               device="cpu"))
    for ext in [".ecx"] + [f".ec{i:02d}" for i in range(14)]:
        with open(base + ext, "rb") as a, open(tbase + ext, "rb") as b:
            assert a.read() == b.read(), ext


def test_the_heartbeat_counts_undrained_appends(tmp_path, monkeypatch):
    monkeypatch.setattr(wp_mod.WritePlane, "_pump_loop",
                        lambda self: None)
    c = PortCluster(tmp_path)
    try:
        vs = c.servers[0]
        fids = [operation.submit(c.url, _payload(i, 4000))
                for i in range(10)]
        vid = types.parse_file_id(fids[0]).volume_id
        v = vs.store.find_volume(vid)
        top = max(types.parse_file_id(f).key for f in fids)
        assert vs.write_plane.pending(vid) == 10
        assert v.max_file_key() < top     # the map has not seen them
        vs._heartbeat_once()
        assert vs.write_plane.pending(vid) == 0
        vols = {vv["id"]: vv for vv in
                vs.store.collect_heartbeat()["volumes"]}
        assert vols[vid]["fileCount"] == 10
        assert vols[vid]["size"] == os.path.getsize(v.file_name(".dat"))
        assert vs.store.collect_heartbeat()["maxFileKey"] == top
        # the master's next key is past every native write
        a = operation.assign(c.url)
        assert types.parse_file_id(a.fid).key > top
    finally:
        c.close()
