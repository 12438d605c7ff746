"""The port's native filer read plane (`native/filer_read_plane.cc`,
`server/filer_read_plane_native.py`) against the JAX package's.

A port cluster with a port filer and a JAX cluster with a JAX filer
(one volume server each, in this process) take the same requests, with
bodies made from numpy seeds; each case's transcript (statuses, bodies
held to their seeded bytes, the headers the plane frames) must be the
same for both:
- a warm read through the plane is byte-identical to the Python front;
- what the plane does not own (ranges, unknown paths, conditional and
  authorized requests, directories) falls back with its 404 body;
- an entry with a TTL never enters the plane;
- an overwrite or a delete is never served stale;
- `/status` advertises the port and the lever arms and disarms it;
  `/metrics` carries its counters;
- negative reads are counted.
Two more cases, the port's alone: after `ec.encode` moves a warm file's
volume into EC shards, the plane's registration is stale, every read
falls back and returns the same bytes, and the file is not registered
again (one stale miss each); and the volume read plane
answers requests pipelined behind a needle whose transfer filled the
socket (the filer's read plane pipelines its fetches).  Skips where g++
cannot build the plane.
"""

import http.client
import os
import re
import shutil
import socket
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu_torch import operation
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json

from test_torch_write_path import Cluster, _wait

OCTET = {"Content-Type": "application/octet-stream"}
FALLBACK = b'{"error":"read plane fallback"}'

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="needs g++ to build the plane")


def _blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def trios(tmp_path_factory):
    """kind -> (filer server, cluster): the filers over `:memory:`
    stores, so the read plane runs without the meta plane, as the JAX
    package's read-plane tests run it."""
    saved = os.environ.pop("SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE", None)
    made, out = [], {}
    try:
        for kind, cls in (("port", FilerServer), ("ref", RefFilerServer)):
            c = Cluster(tmp_path_factory.mktemp(f"frp_{kind}"), kind,
                        racks=("r1",))
            made.append(c)
            fs = cls(c.url).start()
            made.append(fs)
            if fs.native_read is None:
                pytest.skip(f"the {kind} native read plane did not build")
            out[kind] = fs
        yield out
    finally:
        for m in reversed(made):
            (m.close if isinstance(m, Cluster) else m.stop)()
        if saved is not None:
            os.environ["SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE"] = saved


def _plane_get(port: int, path: str, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("GET", path, headers=headers or {})
        r = c.getresponse()
        return r.status, r.read(), r
    finally:
        c.close()


def _warm(fs, path: str, want: bytes, retries: int = 100):
    """The client's side of the fallback contract until the plane serves
    `path`: a plane GET, and on its 404 the same GET on the Python port
    (which fills the plane)."""
    for _ in range(retries):
        st, body, r = _plane_get(fs.native_read.port, path)
        if st == 200:
            return body, r
        st2, body2, _ = http_bytes("GET", f"{fs.url}{path}")
        assert (st2, body2 == want) == (200, True)
        time.sleep(0.05)
    raise AssertionError(f"the plane never served {path}")


def _put(fs, path, body, headers=OCTET):
    assert http_bytes("PUT", f"{fs.url}{path}", body, headers)[0] == 201


def _each(trios, case):
    got = {kind: case(fs) for kind, fs in trios.items()}
    assert got["port"] == got["ref"], got
    return got["port"]


def test_warm_read_byte_parity(trios):
    def case(fs):
        body = _blob(1, 257_123)
        _put(fs, "/rp/parity.bin", body, {"Content-Type": "text/x-parity"})
        st, pybody, pyhdr = http_bytes("GET", f"{fs.url}/rp/parity.bin")
        got, resp = _warm(fs, "/rp/parity.bin", body)
        return [st, pybody == body, got == body,
                resp.getheader("Content-Type"), pyhdr["Content-Type"],
                resp.getheader("Content-Length"), pyhdr["Content-Length"],
                fs.native_read.requests() >= 1]
    out = _each(trios, case)
    assert out[:3] == [200, True, True] and out[3] == out[4] == \
        "text/x-parity" and out[5] == out[6] == "257123" and out[7]


def test_ineligible_requests_fall_back(trios):
    def case(fs):
        body = _blob(2, 10_000)
        _put(fs, "/rp/fb.bin", body)
        _warm(fs, "/rp/fb.bin", body)
        out = []
        for path, hdrs in (("/rp/fb.bin", {"Range": "bytes=0-99"}),
                           ("/rp/never-written.bin", None),
                           ("/rp/fb.bin", {"If-None-Match": '"x"'}),
                           ("/rp/fb.bin", {"Authorization": "Bearer t"}),
                           ("/rp/", None)):
            st, fb, _ = _plane_get(fs.native_read.port, path, hdrs)
            out.append((path, st, fb))
        st, part, _ = http_bytes("GET", f"{fs.url}/rp/fb.bin",
                                 headers={"Range": "bytes=0-99"})
        return out + [(st, part == body[:100])]
    out = _each(trios, case)
    assert all(st == 404 and fb == FALLBACK for _p, st, fb in out[:-1])
    assert out[-1] == (206, True)


def test_ttl_entries_never_enter_the_plane(trios):
    def case(fs):
        body = _blob(3, 3000)
        _put(fs, "/rp/ttl.bin", body)
        # no HTTP knob sets a TTL: stamp it through the filer, whose
        # update event drops any fill the PUT raced in
        fs.filer.update_attrs("/rp/ttl.bin", ttl_sec=60)
        out = []
        for _ in range(5):
            st, got, _ = http_bytes("GET", f"{fs.url}/rp/ttl.bin")
            st2, fb, _ = _plane_get(fs.native_read.port, "/rp/ttl.bin")
            out.append((st, got == body, st2, fb))
            time.sleep(0.05)
        return out
    assert set(_each(trios, case)) == {(200, True, 404, FALLBACK)}


def test_overwrite_coherence_never_serves_stale(trios):
    def case(fs):
        cur = _blob(4, 50_000)
        _put(fs, "/rp/coh.bin", cur)
        _warm(fs, "/rp/coh.bin", cur)
        out = []
        for cycle in range(12):
            cur = _blob(100 + cycle, 50_000 + cycle)
            _put(fs, "/rp/coh.bin", cur)
            # at once after the ack: a fallback or the NEW bytes
            for _ in range(3):
                st, got, _ = _plane_get(fs.native_read.port, "/rp/coh.bin")
                assert (st == 200 and got == cur) or \
                    (st == 404 and got == FALLBACK), \
                    f"cycle {cycle}: the plane served stale bytes"
            got, _ = _warm(fs, "/rp/coh.bin", cur)
            out.append(got == cur)
        return out
    assert _each(trios, case) == [True] * 12


def test_delete_coherence(trios):
    def case(fs):
        body = _blob(5, 20_000)
        _put(fs, "/rp/del.bin", body)
        _warm(fs, "/rp/del.bin", body)
        st = http_bytes("DELETE", f"{fs.url}/rp/del.bin")[0]
        st2, got, _ = _plane_get(fs.native_read.port, "/rp/del.bin")
        return [st, st2, got, http_bytes("GET", f"{fs.url}/rp/del.bin")[0]]
    assert _each(trios, case) == [204, 404, FALLBACK, 404]


def test_status_lever_and_metrics(trios):
    def case(fs):
        nr = fs.native_read
        out = [http_json("GET", f"{fs.url}/status")["readPlanePort"] ==
               nr.port]
        body = _blob(6, 4096)
        _put(fs, "/rp/lever.bin", body)
        _warm(fs, "/rp/lever.bin", body)
        out.append(http_json("POST", f"{fs.url}/debug/read_plane",
                             {"native": "off"})["armed"])
        out.append(http_json("GET", f"{fs.url}/status")["readPlanePort"])
        out.append(_plane_get(nr.port, "/rp/lever.bin")[:2])
        out.append(http_bytes("GET", f"{fs.url}/rp/lever.bin")[1] == body)
        out.append(http_json("POST", f"{fs.url}/debug/read_plane",
                             {"native": "on"})["armed"])
        out.append(_warm(fs, "/rp/lever.bin", body)[0] == body)
        text = http_bytes("GET", f"{fs.url}/metrics")[1].decode()
        for name in ("filer_read_plane_native_requests_total",
                     'filer_read_plane_native_stage_seconds_total'
                     '{stage="fetch"}',
                     "filer_read_plane_native_response_seconds_bucket",
                     "filer_read_plane_native_entries"):
            out.append(name in text)
        return out
    assert _each(trios, case) == [True, False, 0, (404, FALLBACK), True,
                                  True, True, True, True, True, True]


def test_negative_read_counter(trios):
    def case(fs):
        sts = [http_bytes("GET", f"{fs.url}/rp/absent-forever.bin")[0]
               for _ in range(3)]
        text = http_bytes("GET", f"{fs.url}/metrics")[1].decode()
        total = sum(float(ln.rsplit(" ", 1)[1])
                    for ln in text.splitlines()
                    if "filer_read_negative_total" in ln and
                    not ln.startswith("#"))
        return [sts, total >= 3]
    assert _each(trios, case) == [[404, 404, 404], True]


def test_a_warm_file_whose_volume_was_encoded_falls_back(tmp_path,
                                                         monkeypatch):
    """The plane's registration of a file names its volume's read plane;
    once ec.encode turned the volume into shards, that plane answers 404,
    the filer's plane counts a stale miss and falls back, and the Python
    port reads the same bytes from the EC volume: no 404 to the client,
    never stale bytes.  The replay does not register the file again: a
    volume the master serves as EC shards gets no fill, so each file
    costs one stale miss over the two passes."""
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.shell.commands import run_script
    monkeypatch.delenv("SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE",
                       raising=False)
    monkeypatch.setenv("SEAWEEDFS_TPU_READ_CACHE_MB", "0")
    c = Cluster(tmp_path, "port", racks=("r1", "r1", "r2", "r2"),
                size_limit_mb=4)
    fs = FilerServer(c.url, store_path=str(tmp_path / "filer.db"),
                     collection="ecr").start()
    try:
        if fs.native_read is None:
            pytest.skip("the native read plane did not build")
        files = {f"/ecr/f{i:02d}": _blob(300 + i, 1024 + 37 * i)
                 for i in range(12)}
        for path, body in files.items():
            _put(fs, path, body)
        for path, body in files.items():
            assert _warm(fs, path, body)[0] == body
        vids = sorted(c.volumes())
        out = run_script(CommandEnv(c.url),
                         "lock; ec.encode -collection=ecr; unlock")
        assert out[1].count("scatter-encoded 14 shards") == len(vids), out
        _wait(lambda: not c.volumes(), "the encoded volumes left")
        operation._vid_cache = operation.VidCache()
        before = fs.native_read.stats()
        for _ in range(2):
            for path, body in files.items():
                st, got, _ = _plane_get(fs.native_read.port, path)
                assert st in (200, 404), (path, st)
                if st == 200:
                    assert got == body, f"{path}: stale bytes"
                else:
                    assert got == FALLBACK
                    st, got, _ = http_bytes("GET", f"{fs.url}{path}")
                    assert (st, got == body) == (200, True), path
            _wait(lambda: fs.native_read._fills.empty(),
                  "the fills drained")
        after = fs.native_read.stats()
        assert after["stale_misses"] - before["stale_misses"] == len(files)
    finally:
        fs.stop()
        c.close()


def _read_responses(sock, n: int, timeout: float = 20.0) -> list:
    """`n` HTTP responses off `sock`, framed by Content-Length: [(status,
    body)], as many as arrived before `timeout`."""
    buf, out = b"", []
    end = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < end:
        head, sep, rest = buf.partition(b"\r\n\r\n")
        if sep:
            clen = int(re.search(rb"Content-Length: (\d+)", head)[1])
            if len(rest) >= clen:
                out.append((int(head.split()[1]), rest[:clen]))
                buf = rest[clen:]
                continue
        sock.settimeout(max(0.01, end - time.monotonic()))
        try:
            data = sock.recv(1 << 20)
        except socket.timeout:
            break
        if not data:
            break
        buf += data
    return out


def test_the_volume_read_plane_answers_requests_pipelined_behind_a_transfer(
        tmp_path):
    """The filer's read plane pipelines its fetches on a few connections
    to each volume read plane.  A request pipelined behind a needle whose
    transfer filled the socket is answered once that transfer ends (a
    volume read plane that looked for requests only when more bytes
    arrived left it waiting until the client's timeout)."""
    c = Cluster(tmp_path, "port", racks=("r1",))
    try:
        big, small = _blob(7, 2 << 20), _blob(8, 1000)
        fids = []
        for body in (big, small):
            a, _ = operation.assign_and_upload(c.url, body)
            fids.append(a.fid)
        url = a.url
        port = http_json("GET", f"{url}/status")["readPlanePort"]
        for fid, body in zip(fids, (big, small)):
            _wait(lambda: operation._read_via_read_plane(
                [{"url": url}], fid) == body or
                operation.read(c.url, fid) is None, "the plane serves it")
        sock = socket.create_connection(("127.0.0.1", port))
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 65536)
            order = [fids[0], fids[1], fids[1], fids[0], fids[1]]
            sock.sendall(b"".join(
                f"GET /{f} HTTP/1.1\r\nHost: x\r\n\r\n".encode()
                for f in order))
            time.sleep(0.3)        # the first transfer fills the socket
            got = _read_responses(sock, len(order))
        finally:
            sock.close()
        want = {fids[0]: big, fids[1]: small}
        assert [(st, body == want[f]) for (st, body), f in
                zip(got, order)] == [(200, True)] * len(order), \
            f"{len(got)} of {len(order)} pipelined answers arrived"
    finally:
        c.close()
