"""The port's UDS zero-copy read plane, against the JAX package's:
`server/uds_reader.py` (`UdsNeedleServer`, `uds_read_needle`) and the
client's UDS step in `operation.py` (`_uds_read_one`, `_read_via_uds`).
Tolerance: exact equality (wire bytes, needles, branches).

- the same needles in a port store and a JAX store: each package's
  server sends the same bytes for every request (a record, a missing
  key, a missing volume, a malformed line), and each package's client
  reads the other's server to the same needle;
- a cookie mismatch, and a compressed, chunk-manifest or TTL'd needle,
  take the JAX client's branch in the port's client; a server without
  the volume is not asked again for 2 s (the port's own rule);
- a record larger than the socket's send buffer arrives whole (C6);
- the port's client keeps one connection a thread and server;
- the port's `operation.read` on a same-host server whose read plane
  misses is served over UDS, which warms the read plane for the next
  read (tests/test_util_uds.py's UDS case).
"""

import json
import os
import shutil
import socket
import time

import numpy as np
import pytest

from seaweedfs_tpu import operation as ref_operation
from seaweedfs_tpu.server import uds_reader as ref_uds
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu.storage.ttl import read_ttl as ref_read_ttl
from seaweedfs_tpu_torch import operation
from seaweedfs_tpu_torch.server import uds_reader
from seaweedfs_tpu_torch.server.httpd import http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.ttl import read_ttl

VID = 3
COOKIE = 0x1234ABCD
# key -> (size, how): plain needles of three sizes, then the shapes whose
# meaning lives on the server
NEEDLES = {1: (1, "plain"), 2: (4096, "plain"), 3: (70_001, "plain"),
           4: (900, "compressed"), 5: (900, "chunked"), 6: (900, "ttl")}


def _payload(i: int, n: int) -> bytes:
    return np.random.default_rng([15, i]).bytes(n)


def _wait(cond, what: str, timeout: float = 10.0) -> None:
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out: {what}"
        time.sleep(0.01)


@pytest.fixture
def fixed_clock(monkeypatch):
    def stamp(self):
        self.last_append_at_ns = max(1_700_000_000_000_000_000,
                                     self.last_append_at_ns + 1)
        return self.last_append_at_ns
    monkeypatch.setattr(port_volume.Volume, "_next_append_at_ns", stamp)
    monkeypatch.setattr(ref_volume.Volume, "_next_append_at_ns", stamp)


def _fill(store, needle_cls, ttl_fn) -> None:
    store.add_volume(VID)
    v = store.find_volume(VID)
    for key, (n, how) in NEEDLES.items():
        nd = needle_cls(cookie=COOKIE, id=key, data=_payload(key, n))
        nd.set_last_modified(1722800000)
        if how == "compressed":
            nd.flags |= port_needle.FLAG_IS_COMPRESSED
        elif how == "chunked":
            nd.flags |= port_needle.FLAG_IS_CHUNK_MANIFEST
        elif how == "ttl":
            nd.set_ttl(ttl_fn("3d"))
        v.write_needle(nd)


@pytest.fixture
def servers(tmp_path, fixed_clock):
    """A port and a JAX UDS server over stores of the same needles."""
    out = {}
    stores = []
    for name, store_cls, needle_cls, ttl_fn, mod in (
            ("port", Store, port_needle.Needle, read_ttl, uds_reader),
            ("jax", RefStore, RefNeedle, ref_read_ttl, ref_uds)):
        d = tmp_path / name
        d.mkdir()
        st = store_cls([str(d)])
        _fill(st, needle_cls, ttl_fn)
        stores.append(st)
        out[name] = mod.UdsNeedleServer(
            st, str(tmp_path / f"{name}.sock")).start()
    yield out
    for srv in out.values():
        srv.stop()
    for st in stores:
        st.close()


def _exchange(path: str, line: bytes) -> bytes:
    """Everything a server sends for one request line (it keeps the
    connection open, so read until a second of quiet)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(path)
        s.sendall(line)
        s.settimeout(1.0)
        out = b""
        while True:
            try:
                chunk = s.recv(1 << 20)
            except socket.timeout:
                return out
            if not chunk:
                return out
            out += chunk
            if out.startswith(b'{"error"') and out.endswith(b"\n"):
                return out
            head, _, rest = out.partition(b"\n")
            if _ and "size" in json.loads(head) and \
                    len(rest) >= json.loads(head)["size"]:
                return out


@pytest.mark.parametrize("line", [
    *[json.dumps({"volumeId": VID, "key": k}).encode() + b"\n"
      for k in NEEDLES],
    json.dumps({"volumeId": VID, "key": 999}).encode() + b"\n",
    json.dumps({"volumeId": 77, "key": 1}).encode() + b"\n",
    b'{"volumeId": 3}\n', b"not json\n"],
    ids=[*(f"key{k}" for k in NEEDLES), "missing_key", "missing_volume",
         "no_key", "malformed"])
def test_both_servers_send_the_same_bytes(servers, line):
    got = {name: _exchange(srv.sock_path, line)
           for name, srv in servers.items()}
    assert got["port"] == got["jax"] and got["port"]


@pytest.mark.parametrize("key", list(NEEDLES))
def test_each_client_reads_the_others_server(servers, key):
    a = ref_uds.uds_read_needle(servers["port"].sock_path, VID, key)
    b = uds_reader.uds_read_needle(servers["jax"].sock_path, VID, key)
    assert (a.cookie, a.id, bytes(a.data), a.flags) == \
        (b.cookie, b.id, bytes(b.data), b.flags) == \
        (COOKIE, key, _payload(key, NEEDLES[key][0]), a.flags)
    with pytest.raises(LookupError):
        uds_reader.uds_read_needle(servers["jax"].sock_path, VID, 999)
    with pytest.raises(LookupError):
        ref_uds.uds_read_needle(servers["port"].sock_path, VID, 999)


@pytest.mark.parametrize("key,cookie", [
    *[(k, COOKIE) for k in NEEDLES], (1, COOKIE ^ 1), (999, COOKIE)],
    ids=[*(f"{NEEDLES[k][1]}{k}" for k in NEEDLES), "cookie_mismatch",
         "missing"])
def test_the_client_takes_the_reference_branch(servers, monkeypatch, key,
                                               cookie):
    monkeypatch.setattr(operation, "_uds_path_for",
                        lambda url: servers["port"].sock_path)
    monkeypatch.setattr(ref_operation, "_uds_path_for",
                        lambda url: servers["jax"].sock_path)
    loc = {"url": "127.0.0.1:1"}
    port = operation._uds_read_one(loc, VID, key, cookie)
    ref = ref_operation._uds_read_one(loc, VID, key, cookie)
    assert port == ref
    assert operation._read_via_uds([loc, loc], VID, key, cookie) == \
        ref_operation._read_via_uds([loc, loc], VID, key, cookie)
    if NEEDLES.get(key, (0, ""))[1] == "plain" and cookie == COOKIE:
        assert port == (_payload(key, NEEDLES[key][0]), False)
    elif key in NEEDLES and cookie == COOKIE:
        assert port == (None, True)      # the HTTP port must serve it
    else:
        assert port == (None, False)     # the next location or plane


def test_a_thread_keeps_one_connection_a_server(tmp_path, fixed_clock):
    """The port's client reads on one kept connection a thread and
    socket; a miss leaves it usable; the server's stop ends it, and the
    next read on a new server at the path dials afresh."""
    st = Store([str(tmp_path / "s")])
    _fill(st, port_needle.Needle, read_ttl)
    path = str(tmp_path / "k.sock")
    srv = uds_reader.UdsNeedleServer(st, path).start()
    try:
        for key in (1, 2, 999, 3, 1):
            try:
                uds_reader.uds_read_needle(path, VID, key)
            except LookupError:
                assert key == 999
        _wait(lambda: srv.served == 4, "4 records counted")
        assert len(srv._conns) == 1
        srv.stop()
        srv = uds_reader.UdsNeedleServer(st, path).start()
        assert bytes(uds_reader.uds_read_needle(path, VID, 2).data) == \
            _payload(2, NEEDLES[2][0])
        _wait(lambda: srv.served == 1, "1 record counted")
        assert len(srv._conns) == 1
    finally:
        srv.stop()
        st.close()


def _slow_reader(path: str, key: int) -> "tuple[int, int]":
    """(record size announced, bytes received) for a reader that asks,
    then waits 0.3 s before it reads: the server's first sendfile fills
    the socket's buffer and the rest must wait for room."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(path)
        s.sendall(json.dumps({"volumeId": VID, "key": key}).encode()
                  + b"\n")
        time.sleep(0.3)
        s.settimeout(10.0)
        f = s.makefile("rb")
        total = int(json.loads(f.readline(4096))["size"])
        return total, len(f.read(total))


@pytest.mark.parametrize("size", [300_000, 2_000_000, 4 << 20])
def test_a_record_past_the_socket_buffer_is_sent_whole(tmp_path, size):
    """The port's server waits for room in the socket; the JAX server's
    sendfile fails once the buffer is full (a short read, and its client
    falls back to HTTP): the port's fault list's C6."""
    data = _payload(size, size)
    srvs = {}
    for name, store_cls, needle_cls, mod in (
            ("port", Store, port_needle.Needle, uds_reader),
            ("jax", RefStore, RefNeedle, ref_uds)):
        st = store_cls([str(tmp_path / name)])
        st.add_volume(VID)
        st.find_volume(VID).write_needle(needle_cls(cookie=COOKIE, id=1,
                                                    data=data))
        srvs[name] = (st, mod.UdsNeedleServer(
            st, str(tmp_path / f"{name}.sock")).start())
    try:
        port_sock, jax_sock = (srvs[k][1].sock_path for k in ("port", "jax"))
        for client in (uds_reader, ref_uds):
            assert bytes(client.uds_read_needle(port_sock, VID, 1).data) \
                == data
        total, got = _slow_reader(port_sock, 1)
        assert got == total > size
        total, got = _slow_reader(jax_sock, 1)
        assert got < total
    finally:
        for st, srv in srvs.values():
            srv.stop()
            st.close()


def test_a_volume_the_server_lacks_is_not_asked_again_for_2_s(
        servers, monkeypatch):
    """A server that holds no normal volume `vid` (an EC volume, say)
    is skipped for 2 s; a missing key of a volume it holds is not."""
    monkeypatch.setattr(operation, "_uds_path_for",
                        lambda url: servers["port"].sock_path)
    calls = []
    real = uds_reader.uds_read_needle

    def counted(*a, **kw):
        calls.append(a[1:3])
        return real(*a, **kw)
    monkeypatch.setattr(operation, "uds_read_needle", counted)
    operation._uds_vid_misses().clear()
    loc = {"url": "127.0.0.1:1"}
    for _ in range(3):
        assert operation._uds_read_one(loc, 77, 1, COOKIE) == (None, False)
        assert operation._uds_read_one(loc, VID, 999, COOKIE) == \
            (None, False)
    assert calls == [(77, 1)] + [(VID, 999)] * 3
    operation._uds_vid_misses()[("127.0.0.1:1", 77)] = 0.0
    assert operation._uds_read_one(loc, VID, 1, COOKIE)[0] == \
        _payload(1, NEEDLES[1][0])
    operation._uds_read_one(loc, 77, 1, COOKIE)
    assert calls[-1] == (77, 1)          # asked again once it expired


def test_a_path_this_host_cannot_reach_reads_over_http(monkeypatch):
    monkeypatch.setattr(operation, "_server_status",
                        lambda url: {"udsPath": "/nonexistent/uds.sock"})
    assert operation._uds_path_for("127.0.0.1:1") is None
    assert operation._uds_read_one({"url": "127.0.0.1:1"}, 1, 1, 1) == \
        (None, False)


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no g++ to build the planes")
def test_a_read_plane_miss_is_served_over_uds_and_warms_the_plane(
        tmp_path):
    master = MasterServer(pulse_seconds=1.0).start()
    vs = VolumeServer([str(tmp_path / "v0")], device="cpu",
                      master=master.url, pulse_seconds=0.2).start()
    try:
        # a server of an earlier test may have had this port: forget
        # what either client remembers of it
        operation._invalidate_status(vs.url)
        ref_operation._invalidate_status(vs.url)
        st = http_json("GET", f"{vs.url}/status")
        assert st["udsPath"] == vs.uds_server.sock_path
        assert os.path.exists(st["udsPath"])
        blob = _payload(99, 128 * 1024)
        fid = operation.submit(master.url, blob)
        f = types.parse_file_id(fid)
        vs._wp_tick()
        rp0, uds0 = vs.read_plane.served(), vs.uds_server.served

        def served(rp: int, uds: int) -> None:
            # a server counts a read after its client has the bytes
            _wait(lambda: (vs.read_plane.served() - rp0,
                           vs.uds_server.served - uds0) == (rp, uds),
                  f"{rp} read plane and {uds} UDS reads")
        # the read plane holds the needle: it serves the read
        assert operation.read(master.url, fid) == blob
        served(1, 0)
        # it misses now (after any pump tick still registering the
        # native append has ended): UDS serves, and registers it again
        time.sleep(0.2)
        vs.read_plane.delete_needle(f.volume_id, f.key)
        assert operation.read(master.url, fid) == blob
        served(1, 1)
        assert operation.read(master.url, fid) == blob
        served(2, 1)
        # the JAX client's UDS step finds the port's socket by /status
        assert ref_operation._read_via_uds(
            [{"url": vs.url}], f.volume_id, f.key, f.cookie) == blob
        served(2, 2)
        # a TTL'd needle's meaning lives on the server: HTTP serves it
        a = operation.assign(master.url)
        operation.upload(a.url, a.fid, b"short-lived")
        v = vs.store.find_volume(types.parse_file_id(a.fid).volume_id)
        uds = vs.uds_server.served
        tf = types.parse_file_id(a.fid)
        n = port_needle.Needle(cookie=tf.cookie, id=tf.key + 1,
                               data=b"ttl")
        n.set_ttl(read_ttl("3d"))
        v.write_needle(n)
        ttl_fid = str(types.FileId(tf.volume_id, tf.key + 1, tf.cookie))
        assert operation.read(master.url, ttl_fid) == b"ttl"
        _wait(lambda: vs.uds_server.served == uds + 1,
              "the TTL'd needle's UDS try")       # tried, then HTTP
        text = operation.http_bytes("GET", f"{vs.url}/metrics")[1].decode()
        assert f"volume_server_uds_reads_total {uds + 1}" in text
    finally:
        vs.stop()
        master.stop()
