"""The port's asyncio front (`server/async_front.py`) against the JAX
package's.

The bodies of `tests/test_async_front.py` run on a port filer served by
the front (`SEAWEEDFS_TPU_ASYNC_FRONT=filer`), its source executed with
the servers and the client imported from the port; the QoS admission
test stays out (the port has no QoS).  Then the same raw requests go
through the JAX front and the port's, and give the same status and body.
"""

import os
import re
import socket
import time
import types

import pytest

from seaweedfs_tpu.server.filer_server import FilerServer as RefFiler
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefVolume
from test_torch_profiling import stop_background_probes
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

HERE = os.path.dirname(os.path.abspath(__file__))
PULSE = 0.2

_PORTED = ("seaweedfs_tpu.server.httpd",
           "seaweedfs_tpu.server.master_server",
           "seaweedfs_tpu.server.volume_server",
           "seaweedfs_tpu.server.filer_server")


def _load_suite() -> dict:
    """The test functions of tests/test_async_front.py over the port's
    modules (the suite's own fixture is replaced by `cluster` below)."""
    path = os.path.join(HERE, "test_async_front.py")
    with open(path) as f:
        src = f.read()
    for mod in _PORTED:
        src = re.sub(rf"\b{re.escape(mod)}\b",
                     mod.replace("seaweedfs_tpu.", "seaweedfs_tpu_torch.",
                                 1), src)
    src = src.replace("from seaweedfs_tpu import qos",
                      "from seaweedfs_tpu_torch import qos")
    module = types.ModuleType("ported_test_async_front")
    module.__file__ = path
    exec(compile(src, path, "exec"), module.__dict__)
    return {f"test_async_front__{k[5:]}": v
            for k, v in module.__dict__.items()
            if k.startswith("test_") and callable(v)}


globals().update(_load_suite())


def _wait_nodes(master_url: str, n: int) -> None:
    deadline = time.monotonic() + 15
    while len(http_json("GET", f"{master_url}/cluster/status")
              .get("dataNodes", [])) < n:
        assert time.monotonic() < deadline, "volume servers registered"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A port master, volume server and filer, the filer on the asyncio
    front."""
    tmp = tmp_path_factory.mktemp("torch_async_front")
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_ASYNC_FRONT", "filer")
    master = MasterServer(volume_size_limit_mb=128,
                          pulse_seconds=PULSE).start()
    vs = VolumeServer([str(tmp / "v0")], device="cpu", master=master.url,
                      pulse_seconds=PULSE, max_volume_count=16).start()
    _wait_nodes(master.url, 1)
    fl = FilerServer(master.url, store_path=str(tmp / "filer.db")).start()
    try:
        yield master, vs, fl
    finally:
        fl.stop()
        vs.stop()
        master.stop()
        mp.undo()
        stop_background_probes()


def test_the_front_takes_over_the_bound_port_and_stops(tmp_path,
                                                       monkeypatch):
    """The listener the owner bound (and advertised) is the one the
    front serves; a stopped front answers nothing more."""
    monkeypatch.setenv("SEAWEEDFS_TPU_ASYNC_FRONT", "filer")
    fl = FilerServer("127.0.0.1:1", store_path=":memory:")
    port = fl.http.port
    fl.start()
    try:
        assert fl.http._async is not None
        st, body, _ = http_bytes("GET", f"127.0.0.1:{port}/status",
                                 timeout=10)
        assert st == 200 and b"metaPlanePort" in body
        # OPTIONS reaches the filer's dispatch, which answers 405 for
        # a method it does not serve (the threaded front's answer too)
        st, _, _ = http_bytes("OPTIONS", f"127.0.0.1:{port}/x/y",
                              timeout=10)
        assert st == 405
    finally:
        fl.stop()
        stop_background_probes()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()


def test_the_admin_guard_holds_on_the_front(tmp_path, monkeypatch):
    """Under `[admin] key` a `/debug/` path answers 401 without the
    admin JWT on the front too, and 200 with it."""
    from seaweedfs_tpu_torch import security
    monkeypatch.setenv("SEAWEEDFS_TPU_ASYNC_FRONT", "filer")
    security.configure(security.SecurityConfig(admin_key="k" * 16))
    fl = FilerServer("127.0.0.1:1", store_path=":memory:").start()
    try:
        url = f"{fl.url}/debug/vars"
        # a raw request: the port's client would attach the admin JWT
        host, port = fl.url.split(":")
        with socket.create_connection((host, int(port)), timeout=10) as s:
            s.sendall(b"GET /debug/vars HTTP/1.1\r\nHost: x\r\n"
                      b"Connection: close\r\n\r\n")
            head = s.recv(65536).split(b"\r\n")[0]
        assert head.endswith(b"401 Unauthorized"), head
        st, _, _ = http_bytes("GET", url, timeout=10)
        assert st == 200
    finally:
        fl.stop()
        security.configure(None)
        stop_background_probes()


# -- the same raw requests through both packages' fronts --------------------

RAW = [
    b"PUT /cmp/a.txt HTTP/1.1\r\nHost: x\r\nContent-Length: 11\r\n"
    b"Content-Type: text/plain\r\n\r\nhello world",
    b"GET /cmp/a.txt HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET /cmp/a.txt HTTP/1.1\r\nHost: x\r\nRange: bytes=6-10\r\n\r\n",
    b"GET /cmp/a.txt HTTP/1.1\r\nHost: x\r\nRange: bytes=99-\r\n\r\n",
    b"HEAD /cmp/a.txt HTTP/1.1\r\nHost: x\r\n\r\n",
    b"POST /cmp/c.bin HTTP/1.1\r\nHost: x\r\n"
    b"Transfer-Encoding: chunked\r\n\r\n"
    b"5\r\nhello\r\n6\r\n-world\r\n0\r\n\r\n",
    b"GET /cmp/c.bin HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET /cmp/missing HTTP/1.1\r\nHost: x\r\n\r\n",
    b"DELETE /cmp/a.txt HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET /cmp/a.txt HTTP/1.1\r\nHost: x\r\n\r\n",
    b"POST /debug/pprof HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n"
    b"\r\n{}",
    b"POST /debug/slow HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n"
    b"\r\n{}",
]


def _raw(url: str, request: bytes) -> "tuple[int, bytes]":
    """One request on a fresh connection: (status, body)."""
    host, port = url.split(":")
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(request)
        f = s.makefile("rb")
        status = int(f.readline().split()[1])
        length = 0
        while True:
            line = f.readline()
            if line in (b"\r\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            if k.strip().lower() == "content-length":
                length = int(v.strip())
        body = b"" if request.startswith(b"HEAD") else f.read(length)
    return status, body


def test_raw_requests_answer_alike_on_both_fronts(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_ASYNC_FRONT", "filer")
    # the JAX filer's planes stay off: its answers come from its front
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE", "0")
    rm = RefMaster(volume_size_limit_mb=64).start()
    rv = RefVolume([str(tmp_path / "rv")], rm.url,
                   pulse_seconds=PULSE).start()
    pm = MasterServer(volume_size_limit_mb=64, pulse_seconds=PULSE).start()
    pv = VolumeServer([str(tmp_path / "pv")], device="cpu",
                      master=pm.url, pulse_seconds=PULSE).start()
    _wait_nodes(pm.url, 1)
    time.sleep(0.5)
    rf = RefFiler(rm.url, store_path=str(tmp_path / "r.db")).start()
    pf = FilerServer(pm.url, store_path=str(tmp_path / "p.db")).start()
    try:
        assert rf.http._async is not None and pf.http._async is not None
        for req in RAW:
            assert _raw(pf.url, req) == _raw(rf.url, req), req
    finally:
        rf.stop()
        pf.stop()
        rv.stop()
        pv.stop()
        rm.stop()
        pm.stop()
        stop_background_probes()




def _stalled_get_past_a_spent_probe(master_cls, volume_cls, filer_cls,
                                    filer_mod, tmp_path, monkeypatch,
                                    **volume_kw) -> "tuple[bytes, bytes]":
    """(data, body): a 16 MiB file of 128 KiB chunks, and what a GET of
    it brought back.  The front has one pool thread; the GET's client
    holds back after the head, so the response stalls with chunks left
    to fetch, and a probe with `X-Weed-Deadline-Ms: 0` runs on that
    thread in between, which leaves a spent budget there.  The GET has
    no budget of its own."""
    monkeypatch.setenv("SEAWEEDFS_TPU_ASYNC_FRONT", "filer")
    monkeypatch.setenv("SEAWEEDFS_TPU_ASYNC_WORKERS", "1")
    # every view is read from the volume as the body drains
    monkeypatch.setenv("SEAWEEDFS_TPU_READ_CACHE_MB", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE", "0")
    monkeypatch.setattr(filer_mod, "CHUNK_SIZE", 128 << 10)
    master = master_cls(volume_size_limit_mb=64,
                        pulse_seconds=PULSE).start()
    vs = volume_cls([str(tmp_path / "v")], master=master.url,
                    pulse_seconds=PULSE, **volume_kw).start()
    fl = None
    try:
        _wait_nodes(master.url, 1)
        fl = filer_cls(master.url,
                       store_path=str(tmp_path / "f.db")).start()
        data = os.urandom(16 << 20)
        st, _, _ = http_bytes("POST", f"{fl.url}/spent/big.bin", data,
                              timeout=60)
        assert st == 201
        host, port = fl.url.split(":")
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 64 << 10)
            s.settimeout(30)
            s.connect((host, int(port)))
            s.sendall(b"GET /spent/big.bin HTTP/1.1\r\nHost: x\r\n"
                      b"Connection: close\r\n\r\n")
            f = s.makefile("rb")
            assert f.readline().split()[1] == b"200"
            while f.readline() not in (b"\r\n", b""):
                pass
            # the response stalls on the held-back socket: the pool's
            # one thread is free for the probe
            time.sleep(0.5)
            st, _ = _raw(fl.url, b"GET /spent/big.bin HTTP/1.1\r\n"
                         b"Host: x\r\nX-Weed-Deadline-Ms: 0\r\n"
                         b"Connection: close\r\n\r\n")
            assert st == 504
            body = f.read()
        return data, body
    finally:
        if fl is not None:
            fl.stop()
        vs.stop()
        master.stop()
        stop_background_probes()


def test_a_spent_budget_never_cuts_another_requests_body(tmp_path,
                                                         monkeypatch):
    """A streamed GET body is read in its own request's context (C12):
    the chunks fetched after the probe ran still arrive, whole."""
    from seaweedfs_tpu_torch.filer import filer as filer_mod
    data, body = _stalled_get_past_a_spent_probe(
        MasterServer, VolumeServer, FilerServer, filer_mod, tmp_path,
        monkeypatch, device="cpu")
    assert len(body) == len(data) and body == data, len(body)


def test_c12_jax_front_cuts_a_body_under_a_spent_budget(tmp_path,
                                                        monkeypatch):
    """The JAX front reads a streamed body on whatever pool thread is
    free, under the contextvars that thread's last request left: the
    same drive cuts the GET short there (C12; the JAX package keeps
    the fault)."""
    from seaweedfs_tpu.filer import filer as filer_mod
    data, body = _stalled_get_past_a_spent_probe(
        RefMaster, RefVolume, RefFiler, filer_mod, tmp_path, monkeypatch)
    assert len(body) < len(data) and data.startswith(body), len(body)
