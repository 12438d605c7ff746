"""The port's cluster pieces on the CPU, against the JAX package's where
it has them.  Tolerance: exact equality (bytes, and JSON values up to
the named fields).

- `Store.collect_heartbeat` against the reference's for the same
  directories;
- the port's master against the reference's `MasterServer`, fed the
  same heartbeats: `/vol/list`, `/dir/lookup`, `/dir/ec_lookup` and
  `/cluster/status` agree, and a node that stops pulsing leaves both
  live sets after 3 pulses;
- the volume server's master link and routes: heartbeats, a rebuild
  that asks the master for survivors (and rebuilds locally with the
  master down), `/admin/volume_file` ranges and refusals,
  `delete_volume` / `unmount_volume` / `mount_volume`, `/admin/ec/copy`
  and `/admin/ec/to_volume`;
- the command line (`master`, `volume -mserver`, `shell`), and the
  master and shell loading without torch, JAX or the JAX package.

Every server start and poll has its own deadline.
"""

import os
import re
import select
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu_torch import topology
from seaweedfs_tpu_torch.server.httpd import (http_bytes, http_download,
                                              http_json, http_relay)
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util import retry

from test_torch_cluster_shell import MASTER_PULSE, PULSE, TOTAL, VID, _read, golden  # noqa: F401,E501
from test_torch_cluster_shell import small_sizes  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(cond, what: str, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def _place(d, files, keys) -> None:
    """Golden files (`.dat`, shard ids, sidecars) into directory d."""
    os.makedirs(d, exist_ok=True)
    for key in keys:
        name = f"{VID}.ec{key:02d}" if isinstance(key, int) \
            else f"{VID}{key}"
        with open(os.path.join(d, name), "wb") as f:
            f.write(files[key])


@pytest.fixture
def dirs(golden, tmp_path):
    """Three directories: a normal volume with a deleted needle and a
    second collection's volume; EC shards 0-6; EC shards 0 and 7-13 (a
    store mounts at start only the EC volumes whose .ec00 it holds)."""
    a, b, c = (str(tmp_path / n) for n in "abc")
    os.makedirs(a)
    v = Volume(a, 5, collection="pics")
    rng = np.random.default_rng(2)
    for nid in range(1, 9):
        v.write_needle(Needle(cookie=nid, id=nid * 7,
                              data=rng.bytes(1000 * nid)))
    v.nm.delete(21)
    v.close()
    _place(a, golden, [".dat", ".idx"])
    _place(b, golden, list(range(7)) + [".ecx", ".vif"])
    _place(c, golden, [0] + list(range(7, TOTAL)) + [".ecx", ".vif"])
    return [a, b, c]


def test_collect_heartbeat_matches_reference(dirs):
    for i, d in enumerate(dirs):
        port = Store([d], ip="127.0.0.1", port=9000 + i)
        ref = RefStore([d], ip="127.0.0.1", port=9000 + i)
        try:
            got, want = port.collect_heartbeat(), ref.collect_heartbeat()
            assert got == want, d
        finally:
            port.close()
            ref.close()
    hb = Store([dirs[0]]).collect_heartbeat()
    vols = {v["id"]: v for v in hb["volumes"]}
    assert vols[5]["collection"] == "pics"
    assert vols[5]["deleteCount"] == 1 and vols[5]["fileCount"] == 8
    assert hb["maxFileKey"] >= 56


def test_master_matches_reference_master(dirs):
    hbs = []
    for i, d in enumerate(dirs):
        s = Store([d], ip="127.0.0.1", port=9100 + i)
        hbs.append(s.collect_heartbeat())
        s.close()
    hbs[1]["rack"] = "r2"
    masters = [MasterServer(pulse_seconds=PULSE).start(),
               RefMaster(pulse_seconds=PULSE).start()]
    try:
        def pulse(which):
            for hb in which:
                for m in masters:
                    r = http_json("POST", f"{m.url}/heartbeat", hb,
                                  timeout=10)
                    assert r["volumeSizeLimit"] == 1024 << 20, r
        pulse(hbs)
        port, ref = ({p: http_json("GET", f"{m.url}{p}", timeout=10)
                      for p in ("/vol/list", f"/dir/lookup?volumeId={VID}",
                                "/dir/lookup?volumeId=5",
                                "/dir/lookup?volumeId=77",
                                f"/dir/ec_lookup?volumeId={VID}",
                                "/dir/ec_lookup?volumeId=5",
                                "/cluster/status")}
                     for m in masters)
        for p in port:
            if p != "/cluster/status":
                assert port[p] == ref[p], p
        urls = [f"127.0.0.1:{9100 + i}" for i in range(3)]
        assert port[f"/dir/ec_lookup?volumeId={VID}"]["shardIdLocations"] \
            == [{"url": urls[1], "shardIds": list(range(7))},
                {"url": urls[2], "shardIds": [0] + list(range(7, TOTAL))}]
        st_port, st_ref = port["/cluster/status"], ref["/cluster/status"]
        # the same keys (the port's adds its heartbeat count, whether
        # its leader has heard every server, and the volume-id bound of
        # its log); the leader fields name each master itself
        assert set(st_port) - {"heartbeats", "topologyWarm"} == set(st_ref)
        assert set(st_port["raft"]) - {"maxVolumeIdBound"} == \
            set(st_ref["raft"])
        assert st_port["raft"]["persistent"] == st_ref["raft"]["persistent"]
        assert st_port["heartbeats"] == 3
        for k in ("dataNodes", "volumeSizeLimit", "isLeader"):
            assert st_port[k] == st_ref[k], k
        assert st_port["leader"] == masters[0].url

        # node 2 stops pulsing: both live sets lose it after 3 pulses
        t_stop = time.monotonic()
        while time.monotonic() - t_stop < 4.5 * PULSE:
            pulse(hbs[:2])
            time.sleep(PULSE / 2)
        for m in masters:
            st = http_json("GET", f"{m.url}/cluster/status", timeout=10)
            assert st["dataNodes"] == urls[:2], m
        # the port's master also drops it from its lookups and tree (the
        # reference server's UnRegisterDataNode); the JAX package's
        # keeps serving the silent node's shards
        got = http_json("GET", f"{masters[0].url}/dir/ec_lookup?"
                        f"volumeId={VID}", timeout=10)
        assert got["shardIdLocations"] == [
            {"url": urls[1], "shardIds": list(range(7))}]
        tree = http_json("GET", f"{masters[0].url}/vol/list", timeout=10)
        assert [n["url"] for n in topology.iter_volume_list_nodes(tree)] \
            == urls[:2]
        # and a pulse brings it back
        pulse(hbs[2:])
        got = http_json("GET", f"{masters[0].url}/dir/ec_lookup?"
                        f"volumeId={VID}", timeout=10)
        assert len(got["shardIdLocations"]) == 2
    finally:
        for m in masters:
            m.stop()


def test_topology_deadline_and_pulse_back():
    topo = topology.Topology(pulse_seconds=0.05)
    for port, sids in ((1, [0, 1]), (2, [2])):
        topo.register_heartbeat({
            "ip": "127.0.0.1", "port": port, "volumes": [{"id": 4}],
            "ecShards": [{"id": VID, "ecIndexBits":
                          sum(1 << s for s in sids)}]})
    time.sleep(0.2)     # past 3 pulses: node 1 goes silent, node 2 pulses
    topo.register_heartbeat({
        "ip": "127.0.0.1", "port": 2, "volumes": [{"id": 4}],
        "ecShards": [{"id": VID, "ecIndexBits": 1 << 2}]})
    assert [n.url for n in topo.alive_nodes()] == ["127.0.0.1:2"]
    assert topo.lookup_ec_shards(VID) == {"127.0.0.1:2": [2]}
    assert topo.lookup(4) == [{"url": "127.0.0.1:2",
                               "publicUrl": "127.0.0.1:2"}]
    topo.register_heartbeat({"ip": "127.0.0.1", "port": 1})
    assert topo.lookup_ec_shards(VID) == {"127.0.0.1:2": [2]}
    assert len(topo.alive_nodes()) == 2
    assert topo.to_volume_list()["maxVolumeId"] == 4


def test_admin_lease():
    m = MasterServer().start()
    try:
        r = http_json("POST", f"{m.url}/cluster/lease_admin_token",
                      {"previousToken": 0, "lockName": "admin"}, timeout=10)
        token = r["token"]
        assert r["lockTsNs"] > 0
        r2 = http_json("POST", f"{m.url}/cluster/lease_admin_token",
                       {"previousToken": 0, "lockName": "other"},
                       timeout=10)
        assert r2["error"] == "already locked" and \
            r2["lockHolder"] == "admin"
        r3 = http_json("POST", f"{m.url}/cluster/lease_admin_token",
                       {"previousToken": token}, timeout=10)
        assert r3["token"] != token  # a renewal
        assert http_json("POST", f"{m.url}/cluster/release_admin_token",
                         {}, timeout=10) == {}
        assert "token" in http_json(
            "POST", f"{m.url}/cluster/lease_admin_token",
            {"previousToken": 0}, timeout=10)
    finally:
        m.stop()


@pytest.fixture
def cluster(tmp_path):
    """start(dirs) -> (port master, port volume servers on the CPU
    codec, heartbeating every PULSE); all stopped at teardown.  The
    master expects a pulse every MASTER_PULSE, the margin a live server
    needs under load (see test_torch_cluster_shell)."""
    made = []
    master = MasterServer(pulse_seconds=MASTER_PULSE).start()
    made.append(master)

    def start(dir_list):
        out = [VolumeServer([d], device="cpu", master=master.url,
                            pulse_seconds=PULSE).start() for d in dir_list]
        made.extend(out)
        _wait(lambda: len(http_json("GET", f"{master.url}/cluster/status",
                                    timeout=10)["dataNodes"]) ==
              len(made) - 1, "servers registered")
        return out

    start.master = master
    yield start
    for s in reversed(made):
        s.stop()


def _ec_lookup(master) -> "dict[str, list[int]]":
    return topology.fetch_ec_shard_locations(master.url, VID)


def test_rebuild_asks_master_then_rebuilds_locally(golden, cluster,
                                                   tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _place(a, golden, list(range(10)) + [".ecx", ".vif"])
    _place(b, golden, [10, 11, ".ecx", ".vif"])
    sa, sb = cluster([a, b])
    for vs, sids in ((sa, list(range(10))), (sb, [10, 11])):
        r = http_json("POST", f"{vs.url}/admin/ec/mount",
                      {"volumeId": VID, "shardIds": sids}, timeout=10)
        assert r == {"shardIds": sids}
    master = cluster.master
    # the mount route pulses at once: the master knows both servers
    assert _ec_lookup(master) == {sa.url: list(range(10)),
                                  sb.url: [10, 11]}
    # no shardLocations: b streams its 8 missing survivors from a,
    # found through the master
    r = http_json("POST", f"{sb.url}/admin/ec/rebuild",
                  {"volumeId": VID}, timeout=60)
    assert r["rebuiltShardIds"] == [12, 13], r
    assert sa.url in r["telemetry"]["bytesFetchedBySource"], r
    for sid in (12, 13):
        assert _read(os.path.join(b, f"{VID}.ec{sid:02d}")) == golden[sid]
    # the master down: a rebuilds from its own 10 shards
    master.stop()
    r = http_json("POST", f"{sa.url}/admin/ec/rebuild",
                  {"volumeId": VID}, timeout=60)
    assert r["rebuiltShardIds"] == [10, 11, 12, 13], r
    assert sb.url not in r["telemetry"]["bytesFetchedBySource"], r
    for sid in (10, 11, 12, 13):
        assert _read(os.path.join(a, f"{VID}.ec{sid:02d}")) == golden[sid]


@pytest.mark.parametrize("offset,size", [(0, None), (0, 1000),
                                         (123_457, 50_000),
                                         (5 << 20, 9 << 20),
                                         (100 << 20, 10)])
def test_volume_file_ranges(golden, cluster, tmp_path, offset, size):
    a = str(tmp_path / "a")
    _place(a, golden, [".dat", ".idx", 3])
    (vs,) = cluster([a])
    q = f"{vs.url}/admin/volume_file?volumeId={VID}&ext=.dat" \
        f"&offset={offset}" + ("" if size is None else f"&size={size}")
    st, body, hdrs = http_bytes("GET", q, timeout=10)
    want = golden[".dat"][offset:None if size is None else offset + size]
    assert st == 200 and body == want
    assert int(hdrs["Content-Length"]) == len(want)


def test_volume_file_refusals(golden, cluster, tmp_path):
    a = str(tmp_path / "a")
    _place(a, golden, [".dat", ".idx", 3])
    (vs,) = cluster([a])
    base = f"{vs.url}/admin/volume_file?volumeId={VID}"
    st, body, _ = http_bytes("GET", base + "&ext=.ec03", timeout=10)
    assert st == 200 and body == golden[3]
    assert http_bytes("GET", base + "&ext=.ec04", timeout=10)[0] == 404
    assert http_bytes("GET", f"{vs.url}/admin/volume_file?volumeId=9"
                      "&ext=.dat", timeout=10)[0] == 404
    for bad in ("&ext=/../../etc/passwd", "&ext=.dat&collection=../x",
                "&ext=.exe"):
        st, body, _ = http_bytes("GET", base + bad, timeout=10)
        assert st == 400 and b"unacceptable" in body, bad


def test_delete_unmount_mount_volume(golden, cluster, tmp_path):
    a = str(tmp_path / "a")
    _place(a, golden, [".dat", ".idx"])
    link = str(tmp_path / "elsewhere.dat")
    os.link(os.path.join(a, f"{VID}.dat"), link)
    (vs,) = cluster([a])
    master = cluster.master

    def listed():
        return [v["id"] for n in topology.iter_volume_list_nodes(
            http_json("GET", f"{master.url}/vol/list", timeout=10))
            for v in n["volumes"]]
    assert listed() == [VID]
    assert http_json("POST", f"{vs.url}/admin/unmount_volume",
                     {"volumeId": VID}, timeout=10) == {}
    assert vs.store.find_volume(VID) is None and listed() == []
    assert http_json("POST", f"{vs.url}/admin/mount_volume",
                     {"volumeId": VID}, timeout=10) == {}
    assert vs.store.find_volume(VID) is not None and listed() == [VID]
    v = vs.store.find_volume(VID)
    assert http_json("POST", f"{vs.url}/admin/delete_volume",
                     {"volumeId": VID}, timeout=10) == {}
    assert v._dat.closed and v.nm._idx_file is None   # closed first
    assert os.listdir(a) == [] and vs.store.find_volume(VID) is None
    assert listed() == []  # the route pulsed at once
    assert http_json("GET", f"{master.url}/dir/lookup?volumeId={VID}",
                     timeout=10)["error"] == "volume not found"
    # only this directory's link went
    assert _read(link) == golden[".dat"]
    r = http_json("POST", f"{vs.url}/admin/delete_volume",
                  {"volumeId": VID}, timeout=10)
    assert "not found" in r["error"]


def test_ec_copy_and_to_volume(golden, cluster, tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _place(a, golden, list(range(5)) + [".ecx", ".vif"])
    _place(b, golden, list(range(5, TOTAL)) + [".ecx", ".vif"])
    sa, sb = cluster([a, b])
    r = http_json("POST", f"{sa.url}/admin/ec/copy",
                  {"volumeId": VID, "shardIds": [5, 6, 7, 8, 9],
                   "sourceDataNode": sb.url, "copyEcjFile": True},
                  timeout=30)
    assert r == {}, r
    for sid in range(10):
        assert _read(os.path.join(a, f"{VID}.ec{sid:02d}")) == golden[sid]
    assert not [n for n in os.listdir(a) if ".download." in n]
    r = http_json("POST", f"{sa.url}/admin/ec/copy",
                  {"volumeId": VID, "shardIds": [3],
                   "sourceDataNode": sb.url}, timeout=30)
    assert "copy .ec03" in r["error"] and "404" in r["error"]
    assert http_json("POST", f"{sa.url}/admin/ec/to_volume",
                     {"volumeId": VID}, timeout=30) == {}
    for ext in (".dat", ".idx"):
        assert _read(os.path.join(a, f"{VID}{ext}")) == golden[ext]
    assert sa.store.find_volume(VID) is not None
    assert sa.store.find_ec_volume(VID) is None
    assert http_json("GET", f"{cluster.master.url}/dir/lookup?"
                     f"volumeId={VID}", timeout=10)["locations"] == \
        [{"url": sa.url, "publicUrl": sa.url}]


def test_http_download_and_relay(golden, cluster, tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _place(a, golden, [".dat", ".idx"])
    sa, sb = cluster([a, b])
    src = f"{sa.url}/admin/volume_file?volumeId={VID}&ext=.dat"
    dest = str(tmp_path / "pulled.dat")
    st, _ = http_download(src, dest, chunk_size=1 << 20)
    assert st == 200 and _read(dest) == golden[".dat"]
    st, _ = http_download(src.replace(".dat", ".ecx"), dest)
    assert st == 404 and _read(dest) == golden[".dat"]  # left untouched
    r = http_relay(src, "POST", f"{sb.url}/admin/receive_file?"
                   f"volumeId={VID}&ext=.dat", chunk_size=1 << 20)
    assert r[:2] == (200, 200)
    assert _read(os.path.join(b, f"{VID}.dat")) == golden[".dat"]
    assert http_relay(src.replace(".dat", ".ecx"), "POST",
                      f"{sb.url}/admin/receive_file?volumeId={VID}"
                      "&ext=.ecx") == (404, 0, b"")


def test_breaker_opens_and_half_opens(monkeypatch):
    monkeypatch.setattr(retry, "BREAKER_THRESHOLD", 2)
    monkeypatch.setattr(retry, "BREAKER_COOLDOWN", 0.1)
    peer = "127.0.0.1:1"
    retry.reset()
    try:
        retry.record_failure(peer)
        assert retry.peer_available(peer)
        retry.record_failure(peer)
        assert not retry.peer_available(peer)
        time.sleep(0.15)
        assert retry.peer_state(peer) == retry.HALF_OPEN
        retry.record_failure(peer)    # the probe failed: open again
        assert not retry.peer_available(peer)
        retry.record_success(peer)
        assert retry.peer_state(peer) == retry.CLOSED
    finally:
        retry.reset()


def _popen(args, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=cwd)


def _first_line(proc, role: str) -> str:
    """The url of a server's `... listening on` line (60 s)."""
    ready, _, _ = select.select([proc.stdout], [], [], 60)
    line = proc.stdout.readline() if ready else ""
    m = re.fullmatch(rf"{role} server listening on (\S+:\d+)\n", line)
    assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
    return m.group(1)


def test_command_line_cluster(golden, tmp_path):
    """`master`, a `volume -mserver` registered through its heartbeat,
    and a `shell` one-shot, as subprocesses."""
    d = str(tmp_path / "v")
    _place(d, golden, [".dat", ".idx"])
    procs = [_popen(["master", "-port", "0"], str(tmp_path))]
    try:
        murl = _first_line(procs[0], "master")
        procs.append(_popen(["volume", "-dir", d, "-port", "0",
                             "-mserver", murl, "-device", "cpu"],
                            str(tmp_path)))
        vurl = _first_line(procs[1], "volume")
        _wait(lambda: http_json("GET", f"{murl}/dir/lookup?volumeId={VID}",
                                timeout=10).get("locations") ==
              [{"url": vurl, "publicUrl": vurl}], "volume registered", 30)
        out = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
             "-master", murl, "lock; ec.rebuild; unlock"],
            capture_output=True, text=True, timeout=60,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        assert out.stdout == "locked\nno ec volumes\nunlocked\n"
        for p in procs:
            p.terminate()
        for p in procs:
            assert p.wait(timeout=20) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
            p.stdout.close()
            p.stderr.close()


def test_volume_device_cuda_without_a_card_fails(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
         "-dir", str(tmp_path), "-port", "0", "-device", "cuda"],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "listening" not in out.stdout


def test_master_and_shell_load_without_torch_or_jax():
    code = (
        "import sys\n"
        "import seaweedfs_tpu_torch.server.master_server\n"
        "import seaweedfs_tpu_torch.shell\n"
        "import seaweedfs_tpu_torch.operation\n"
        "import seaweedfs_tpu_torch.topology\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'seaweedfs_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout == "[]\n"
