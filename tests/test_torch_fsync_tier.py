"""The port's `-fsync` tier and the volume's group commit, against the
JAX package's: `storage/volume.py` (the `CommitBarrier` at site
`volume.needle`, `fsync`), `storage/store.py` (`fsync` to every volume),
the write plane's epoch handshake (`server/write_plane.py`,
`native.wp_wait_epoch`/`wp_epoch_done`) and `volume -fsync`.
Tolerance: exact equality (bytes, counts), and the ordering of an ack
after its fsync.

- the same seeded needles through a port `Volume(fsync=True)` and a JAX
  one give equal `.dat` and `.idx` bytes;
- with `os.fsync` counted and blocked, no write or delete returns before
  its fsync, in either package, and concurrent writers share fsyncs;
- acked writes and deletes are durable across a reopen; an unchanged
  write skips the barrier (tests/test_group_commit.py's volume cases);
- the native write plane parks an ack on an `-fsync` volume until the
  handshake has run the volume's barrier (tests/test_write_plane.py's
  handshake case, in both packages);
- a plane that cannot run the handshake is refused the volume, which
  stays on the Python path, and the refusal is counted;
- a `volume -fsync` process SIGKILLed after its acks reads every one
  back from both replicas.
"""

import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

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
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the planes")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (port_volume.Volume, Needle),
            "jax": (ref_volume.Volume, RefNeedle)}


def _payload(i: int, n: int) -> bytes:
    return np.random.default_rng([14, i]).bytes(n)


def _wait(cond, what: str, timeout: float = 15.0) -> None:
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out: {what}"
        time.sleep(0.02)


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages stamp AppendAtNs from one clock, so their records
    are byte-identical."""
    def stamp(self):
        self.last_append_at_ns = max(1_700_000_000_000_000_000,
                                     self.last_append_at_ns + 1)
        return self.last_append_at_ns
    monkeypatch.setattr(port_volume.Volume, "_next_append_at_ns", stamp)
    monkeypatch.setattr(ref_volume.Volume, "_next_append_at_ns", stamp)


class _Fsyncs:
    """os.fsync counted, and blocked while `gate` is clear."""

    def __init__(self, monkeypatch, delay: float = 0.0):
        self.calls = 0
        self.returned = 0
        self.gate = threading.Event()
        self.gate.set()
        self._lock = threading.Lock()
        real = os.fsync

        def fsync(fd):
            with self._lock:
                self.calls += 1
            self.gate.wait(30)
            if delay:
                time.sleep(delay)
            real(fd)
            with self._lock:
                self.returned += 1
        monkeypatch.setattr(os, "fsync", fsync)


# -- the volume ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_an_fsync_volume_writes_the_reference_bytes(tmp_path, fixed_clock,
                                                    seed):
    rng = np.random.default_rng([14, seed])
    ops = []
    for i in range(40):
        key = int(rng.integers(1, 30))
        kind = rng.choice(["write", "write", "write", "delete", "again"])
        ops.append((kind, key, int(rng.integers(0, 9000))))
    files = {}
    for name, (vol_cls, needle_cls) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        v = vol_cls(str(d), 7, fsync=True)
        last = {}
        for kind, key, n in ops:
            if kind == "delete":
                v.delete_needle(needle_cls(cookie=0x55, id=key))
                last.pop(key, None)
                continue
            data = last[key] if kind == "again" and key in last \
                else _payload(seed * 1000 + key, n)
            nd = needle_cls(cookie=0x55, id=key, data=data)
            nd.set_last_modified(1722800000)
            v.write_needle(nd)
            last[key] = data
        files[name] = tuple(open(v.file_name(ext), "rb").read()
                            for ext in (".dat", ".idx"))
        v.close()
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_no_write_or_delete_returns_before_its_fsync(tmp_path, monkeypatch,
                                                     pkg):
    vol_cls, needle_cls = PACKAGES[pkg]
    v = vol_cls(str(tmp_path), 3, fsync=True)
    f = _Fsyncs(monkeypatch)
    for op in ("write", "delete"):
        f.gate.clear()
        done = threading.Event()

        def act():
            if op == "write":
                v.write_needle(needle_cls(cookie=1, id=9, data=b"d" * 100))
            else:
                v.delete_needle(needle_cls(cookie=1, id=9))
            done.set()
        calls = f.calls
        t = threading.Thread(target=act)
        t.start()
        _wait(lambda: f.calls > calls, f"the {op}'s fsync")
        time.sleep(0.2)
        assert not done.is_set(), f"the {op} returned before its fsync"
        f.gate.set()
        t.join(10)
        assert done.is_set() and f.returned == f.calls
    v.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_concurrent_writers_share_fsyncs(tmp_path, monkeypatch, pkg):
    vol_cls, needle_cls = PACKAGES[pkg]
    v = vol_cls(str(tmp_path), 4, fsync=True)
    f = _Fsyncs(monkeypatch, delay=0.003)
    writers, each = 8, 20

    def wr(i):
        for j in range(each):
            v.write_needle(needle_cls(cookie=2, id=i * 100 + j + 1,
                                      data=_payload(i * 100 + j, 300)))
    ts = [threading.Thread(target=wr, args=(i,)) for i in range(writers)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert 0 < f.calls < writers * each
    assert v._barrier.committed == writers * each
    assert v._barrier.flushes == f.calls
    # every ack is on the file: a fresh volume over it, the first open
    v2 = vol_cls(str(tmp_path), 4)
    for i in range(writers):
        for j in range(each):
            assert v2.read_needle(i * 100 + j + 1).data == \
                _payload(i * 100 + j, 300)
    v2.close()
    v.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_delete_is_durable_through_the_barrier(tmp_path, pkg):
    vol_cls, needle_cls = PACKAGES[pkg]
    v = vol_cls(str(tmp_path), 5, fsync=True)
    v.write_needle(needle_cls(cookie=3, id=1, data=b"x" * 64))
    assert v.delete_needle(needle_cls(cookie=3, id=1)) > 0
    v2 = vol_cls(str(tmp_path), 5)
    with pytest.raises(KeyError):
        v2.read_needle(1)
    v2.close()
    v.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_an_unchanged_write_skips_the_barrier(tmp_path, monkeypatch, pkg):
    vol_cls, needle_cls = PACKAGES[pkg]
    v = vol_cls(str(tmp_path), 6, fsync=True)
    f = _Fsyncs(monkeypatch)
    v.write_needle(needle_cls(cookie=4, id=1, data=b"y" * 64))
    before = (v._barrier.committed, f.calls)
    _, _, unchanged = v.write_needle(needle_cls(cookie=4, id=1,
                                                data=b"y" * 64))
    assert unchanged
    assert (v._barrier.committed, f.calls) == before
    v.close()


def test_the_default_tier_flushes_without_fsync(tmp_path, monkeypatch):
    v = port_volume.Volume(str(tmp_path), 8)
    f = _Fsyncs(monkeypatch)
    v.write_needle(Needle(cookie=5, id=1, data=b"z" * 64))
    assert not v.fsync and f.calls == 0 and v._barrier.flushes == 1
    v2 = port_volume.Volume(str(tmp_path), 8)
    assert v2.read_needle(1).data == b"z" * 64
    v2.close()
    v.close()


def test_the_store_gives_every_volume_its_tier(tmp_path):
    st = Store([str(tmp_path)], fsync=True)
    st.add_volume(1)
    st.add_volume(2, replication="001")
    st.unmount_volume(2)
    st.mount_volume(2)
    st.close()
    st = Store([str(tmp_path)], fsync=True)        # loaded at start
    assert all(st.find_volume(v).fsync for v in (1, 2))
    st.close()
    st = Store([str(tmp_path)])
    assert not any(st.find_volume(v).fsync for v in (1, 2))
    st.close()


# -- the write plane's epoch handshake ------------------------------------

def _wp_post(vs, fid: str, body: bytes, port=None):
    port = port or vs.write_plane.port
    return http_bytes("POST", f"127.0.0.1:{port}/{fid}", body, timeout=30)


@needs_gxx
def test_the_epoch_handshake_acks_after_the_barrier(tmp_path, monkeypatch):
    master = MasterServer(volume_size_limit_mb=32,
                          pulse_seconds=1.0).start()
    vs = VolumeServer([str(tmp_path / "v0")], device="cpu",
                      master=master.url, pulse_seconds=0.2,
                      fsync=True).start()
    try:
        a = operation.assign(master.url)
        fid = types.parse_file_id(a.fid)
        v = vs.store.find_volume(fid.volume_id)
        assert v.fsync and v._wp is vs.write_plane
        f = _Fsyncs(monkeypatch)
        f.gate.clear()
        got = []
        t = threading.Thread(target=lambda: got.append(
            _wp_post(vs, a.fid, b"platter-durable")))
        t.start()
        _wait(lambda: f.calls > 0, "the epoch's fsync")
        time.sleep(0.2)
        assert not got, "the native ack came before its fsync"
        f.gate.set()
        t.join(10)
        assert got[0][0] == 201
        assert vs.write_plane.requests() == 1
        assert vs.write_plane.epochs >= 1 and v._barrier.flushes >= 1
        st, body, _ = http_bytes("GET", f"{vs.url}/{a.fid}")
        assert st == 200 and body == b"platter-durable"
        text = http_bytes("GET", f"{vs.url}/metrics")[1].decode()
        assert "volume_server_write_plane_epochs_total" in text
        assert "seaweedfs_tpu_volume_fsyncs_total" in text
    finally:
        vs.stop()
        master.stop()


@needs_gxx
def test_the_reference_handshake_acks_the_same_write(tmp_path):
    """The JAX server's handshake on the same write: both packages ack
    201 with one barrier flush or more, and store the same bytes."""
    answers = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        if name == "port":
            master = MasterServer(volume_size_limit_mb=32).start()
            vs = VolumeServer([str(d)], device="cpu", master=master.url,
                              pulse_seconds=0.2, fsync=True).start()
        else:
            master = RefMaster(volume_size_limit_mb=32).start()
            vs = RefServer([str(d)], master.url, pulse_seconds=0.2,
                           fsync=True).start()
        try:
            _wait(lambda: http_json(
                "GET", f"{master.url}/dir/assign").get("fid"),
                "a writable volume")
            a = operation.assign(master.url)
            st, _, _ = _wp_post(vs, a.fid, _payload(1, 4096))
            fid = types.parse_file_id(a.fid)
            v = vs.store.find_volume(fid.volume_id)
            answers[name] = (st, v.fsync, v._barrier.flushes >= 1,
                             http_bytes("GET", f"{vs.url}/{a.fid}")[1])
        finally:
            vs.stop()
            master.stop()
    assert answers["port"] == answers["jax"] == \
        (201, True, True, _payload(1, 4096))


@needs_gxx
def test_a_plane_without_the_handshake_is_refused_the_volume(
        tmp_path, monkeypatch):
    monkeypatch.setattr(wp_mod.WritePlane, "can_handshake",
                        lambda self: False)
    master = MasterServer(volume_size_limit_mb=32,
                          pulse_seconds=1.0).start()
    vs = VolumeServer([str(tmp_path / "v0")], device="cpu",
                      master=master.url, pulse_seconds=0.2,
                      fsync=True).start()
    try:
        a = operation.assign(master.url)
        v = vs.store.find_volume(types.parse_file_id(a.fid).volume_id)
        assert v._wp is None and vs.write_plane.fsync_refused >= 1
        st, _, _ = _wp_post(vs, a.fid, b"refused")
        assert st == 404
        # the client's fallback: the Python path, fsynced
        before = v._barrier.flushes
        assert operation.upload(a.url, a.fid, b"python path")["size"] == 11
        assert v._barrier.flushes == before + 1
        text = http_bytes("GET", f"{vs.url}/metrics")[1].decode()
        assert "volume_server_write_plane_fsync_refused_total " \
            f"{vs.write_plane.fsync_refused}" in text
    finally:
        vs.stop()
        master.stop()


@needs_gxx
def test_a_plane_with_no_epoch_callback_refuses_fsync_volumes(tmp_path):
    plane = wp_mod.WritePlane("127.0.0.1")            # no on_epoch
    try:
        v = port_volume.Volume(str(tmp_path), 1, fsync=True)
        assert not plane.can_handshake()
        assert not v.attach_native(plane)
        assert plane.fsync_refused == 1 and v._wp is None
        w = port_volume.Volume(str(tmp_path), 2)       # the default tier
        assert w.attach_native(plane)
        w.close()
        v.close()
    finally:
        plane.stop()


# -- a volume -fsync process killed after its acks --------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _volume_proc(d: str, port: int, master: str) -> subprocess.Popen:
    p = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume", "-dir", d,
         "-port", str(port), "-mserver", master, "-device", "cpu",
         "-fsync"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert "listening" in p.stdout.readline()
    return p


@needs_gxx
def test_every_acked_write_survives_a_sigkill_on_both_replicas(tmp_path):
    master = MasterServer(volume_size_limit_mb=64, pulse_seconds=1.0,
                          default_replication="001").start()
    ports = [_free_port() for _ in range(2)]
    dirs = [str(tmp_path / f"v{i}") for i in range(2)]
    procs = [_volume_proc(d, p, master.url) for d, p in zip(dirs, ports)]
    try:
        _wait(lambda: len(http_json("GET", f"{master.url}/cluster/status")
                          ["dataNodes"]) == 2, "two servers")
        acked = [(operation.submit(master.url, _payload(i, 3000 + i)), i)
                 for i in range(30)]
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(10)
        procs[0] = _volume_proc(dirs[0], ports[0], master.url)
        for p in ports:
            operation._invalidate_status(f"127.0.0.1:{p}")
        for fid, i in acked:
            for p in ports:
                st, body, _ = http_bytes("GET", f"127.0.0.1:{p}/{fid}")
                assert st == 200 and body == _payload(i, 3000 + i), fid
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
            p.wait(20)
        master.stop()
