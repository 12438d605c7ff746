"""The port's TLS plane (`seaweedfs_tpu_torch/tls.py`, the listeners and
the client calls of `server/httpd.py`) on the CPU, against the JAX
package's.  Tolerance: exact equality (bytes, statuses).

- a port cluster over mTLS: heartbeats, assigns, uploads and reads; a
  plaintext client, a client without a certificate and a client of
  another CA are refused, and counted; a silent client does not stall
  the accept loop;
- certificates minted by either package's `generate_cluster_certs` are
  accepted by the other's contexts, and each package's client works
  against the other's servers over mTLS;
- the pooled keep-alive client on TLS sockets: a socket the server
  closed while it sat idle is replaced before anything is sent on it;
- C7: the JAX volume server keeps its native planes up under `[tls]`
  without a JWT key, so a client without a certificate reads a needle in
  plain text off its read plane; the port's servers start no plane
  under `[tls]`, and its filer keeps its native planes down too.
"""

import socket
import ssl
import threading
import time
import urllib.error
import urllib.request

import pytest

pytest.importorskip(
    "cryptography",
    reason="minting certificates (tls.generate_cluster_certs) needs the "
           "`cryptography` package")

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu import security as ref_security  # noqa: E402
from seaweedfs_tpu import tls as ref_tls  # noqa: E402
from seaweedfs_tpu.server import httpd as ref_httpd  # noqa: E402
from seaweedfs_tpu.server.master_server import (  # noqa: E402
    MasterServer as RefMaster)
from seaweedfs_tpu.server.volume_server import (  # noqa: E402
    VolumeServer as RefServer)
from seaweedfs_tpu_torch import operation, security, stats  # noqa: E402
from seaweedfs_tpu_torch.security import SecurityConfig  # noqa: E402
from seaweedfs_tpu_torch.server import httpd  # noqa: E402
from seaweedfs_tpu_torch.server.httpd import (HttpServer,  # noqa: E402
                                              http_bytes, http_json)
from seaweedfs_tpu_torch.server.master_server import (  # noqa: E402
    MasterServer)
from seaweedfs_tpu_torch.server.volume_server import (  # noqa: E402
    VolumeServer)
from seaweedfs_tpu_torch.tls import (TlsConfig,  # noqa: E402
                                     generate_cluster_certs)

PULSE = 0.2


def _wait(cond, what: str, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """One PKI from each package, and one of a third CA."""
    d = tmp_path_factory.mktemp("pki")
    return {"port": generate_cluster_certs(str(d / "port")),
            "ref": ref_tls.generate_cluster_certs(str(d / "ref")),
            "other": generate_cluster_certs(str(d / "other"))}


def _configure(paths, mtls=True, **kw):
    """Both packages on one TLS configuration (each its own contexts)."""
    security.configure(SecurityConfig(tls=TlsConfig(
        paths["ca"], paths["cert"], paths["key"],
        require_client_cert=mtls), **kw))
    ref_security.configure(ref_security.SecurityConfig(
        tls=ref_tls.TlsConfig(paths["ca"], paths["cert"], paths["key"],
                              require_client_cert=mtls), **kw))


@pytest.fixture(scope="module")
def tls_cluster(pki, tmp_path_factory):
    """A port master and volume server over mTLS, with the port's PKI."""
    _configure(pki["port"])
    d = tmp_path_factory.mktemp("tlsvol")
    master = MasterServer(pulse_seconds=PULSE).start()
    vs = VolumeServer([str(d)], device="cpu", master=master.url,
                      pulse_seconds=PULSE).start()
    _wait(lambda: vs.url in http_json(
        "GET", f"{master.url}/cluster/status")["dataNodes"],
        "heartbeat over mTLS")
    yield master, vs
    vs.stop()
    master.stop()
    security.configure(None)
    ref_security.configure(None)


@pytest.fixture
def reconfigured(tls_cluster, pki):
    """Tests that swap the process configuration put the cluster's back."""
    yield
    _configure(pki["port"])


def test_cluster_over_mtls(tls_cluster):
    master, vs = tls_cluster
    fid = operation.submit(master.url, b"over tls!")
    assert operation.read(master.url, fid) == b"over tls!"
    assert operation.read(master.url, fid, 5, 3) == b"tls"
    operation.delete(master.url, fid)
    st = http_json("GET", f"{master.url}/cluster/status")
    assert vs.url in st["dataNodes"]


def test_plaintext_client_refused(tls_cluster):
    master, vs = tls_cluster
    before = stats.PROCESS.counter_sum("tls_handshake_failures_total")
    for url in (master.url, vs.url):
        with pytest.raises((urllib.error.URLError, ConnectionError,
                            OSError)):
            urllib.request.urlopen(f"http://{url}/status", timeout=5)
    _wait(lambda: stats.PROCESS.counter_sum(
        "tls_handshake_failures_total") >= before + 2,
        "failed handshakes counted")


def test_client_without_cert_refused_mtls(tls_cluster, pki):
    master, _ = tls_cluster
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(pki["port"]["ca"])  # trusts it, no cert
    with pytest.raises((urllib.error.URLError, ssl.SSLError,
                        ConnectionError, OSError)):
        urllib.request.urlopen(f"https://{master.url}/cluster/status",
                               timeout=5, context=ctx).read()


def test_wrong_ca_rejected(tls_cluster, pki):
    master, _ = tls_cluster
    o = pki["other"]
    ctx = TlsConfig(o["ca"], o["cert"], o["key"]).client_context()
    with pytest.raises((urllib.error.URLError, ssl.SSLError,
                        ConnectionError, OSError)):
        urllib.request.urlopen(f"https://{master.url}/cluster/status",
                               timeout=5, context=ctx).read()


def test_silent_client_does_not_stall_accept_loop(tls_cluster):
    master, _ = tls_cluster
    host, port = master.url.split(":")
    silent = socket.create_connection((host, int(port)), timeout=5)
    try:
        t0 = time.monotonic()
        st = http_json("GET", f"{master.url}/cluster/status")
        assert "dataNodes" in st
        assert time.monotonic() - t0 < 5
    finally:
        silent.close()


def test_pool_replaces_a_tls_socket_closed_while_idle(tls_cluster):
    """The pooled client's rule on SSLSockets: a kept-alive socket the
    server severed while it sat idle is replaced before the request is
    sent, so a non-idempotent POST runs exactly once."""
    calls = []
    srv = HttpServer()
    srv.route("POST", "/count",
              lambda req: (calls.append(req.body) or 200, {"n": len(calls)}))
    srv.start()
    try:
        def opened():
            return stats.PROCESS.counter_value(
                "pool_connections_opened_total", peer=srv.url) or 0
        assert http_json("POST", f"{srv.url}/count", {"a": 1})["n"] == 1
        conn = httpd._pool()[("https", srv.url)]
        assert isinstance(conn.sock, ssl.SSLSocket)
        n_open = opened()
        srv._httpd.close_established()      # the server drops it idle
        time.sleep(0.2)
        assert http_json("POST", f"{srv.url}/count", {"a": 2})["n"] == 2
        assert len(calls) == 2
        assert opened() == n_open + 1
        # and a live one is reused
        assert http_json("POST", f"{srv.url}/count", {"a": 3})["n"] == 3
        assert opened() == n_open + 1
    finally:
        srv.stop()


@pytest.mark.parametrize("minted_by", ["port", "ref"])
def test_certs_from_either_package(minted_by, pki):
    """Each package's contexts accept the other's certificates: a server
    context of one and a client context of the other handshake."""
    p = pki[minted_by]
    server_ctx = (TlsConfig if minted_by == "ref" else ref_tls.TlsConfig)(
        p["ca"], p["cert"], p["key"],
        require_client_cert=True).server_context()
    client_ctx = (ref_tls.TlsConfig if minted_by == "ref" else TlsConfig)(
        p["ca"], p["cert"], p["key"]).client_context()
    lsock = socket.create_server(("127.0.0.1", 0))
    got = {}

    def serve():
        c, _ = lsock.accept()
        with server_ctx.wrap_socket(c, server_side=True) as s:
            got["peer"] = s.getpeercert() is not None
            s.sendall(s.recv(5))
    t = threading.Thread(target=serve)
    t.start()
    with socket.create_connection(lsock.getsockname()) as raw:
        with client_ctx.wrap_socket(raw,
                                    server_hostname="127.0.0.1") as s:
            s.sendall(b"hello")
            assert s.recv(5) == b"hello"
    t.join(5)
    lsock.close()
    assert got["peer"]


@pytest.mark.parametrize("ctl", ["port", "ref"])
def test_clients_cross_packages_over_mtls(ctl, pki, tmp_path,
                                          reconfigured):
    """Either package's client on the other's cluster over mTLS, with
    JWT keys too: statuses and bytes the same."""
    _configure(pki["ref"], volume_write_key="w", volume_read_key="r",
               admin_key="a")
    if ctl == "port":
        master = MasterServer(pulse_seconds=PULSE).start()
        vs = VolumeServer([str(tmp_path)], device="cpu", master=master.url,
                          pulse_seconds=PULSE).start()
        client = ref_operation
    else:
        master = RefMaster().start()
        vs = RefServer([str(tmp_path)], master.url,
                       pulse_seconds=PULSE).start()
        client = operation
    try:
        _wait(lambda: vs.url in http_json(
            "GET", f"{master.url}/cluster/status")["dataNodes"],
            "registered over mTLS")
        fid = client.submit(master.url, b"x" * 5000)
        assert client.read(master.url, fid) == b"x" * 5000
        other = operation if client is ref_operation else ref_operation
        assert other.read(master.url, fid) == b"x" * 5000
        client.delete(master.url, fid)
    finally:
        vs.stop()
        master.stop()


# -- C7: the native planes under [tls] -------------------------------------

def _raw_get(addr: str, path: str) -> bytes:
    """One plain-text GET with no certificate: the response's status
    line through its Content-Length body."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=5) as s:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: {addr}\r\n\r\n".encode())
        out = b""
        while b"\r\n\r\n" not in out:
            b = s.recv(65536)
            if not b:
                return out
            out += b
        head, _, body = out.partition(b"\r\n\r\n")
        n = 0
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                n = int(line.split(b":", 1)[1])
        while len(body) < n:
            b = s.recv(65536)
            if not b:
                break
            body += b
        return head + b"\r\n\r\n" + body


def test_c7_jax_planes_serve_plaintext_under_mtls(pki, tmp_path,
                                                  reconfigured):
    """The fault the port repairs: under `[tls] mtls = true` and no JWT
    key, the JAX volume server advertises its read plane in `/status`,
    and a client with no certificate reads a needle off it in plain
    text."""
    _configure(pki["ref"])
    master = RefMaster().start()
    vs = RefServer([str(tmp_path)], master.url, pulse_seconds=PULSE).start()
    try:
        _wait(lambda: vs.url in ref_httpd.http_json(
            "GET", f"{master.url}/cluster/status")["dataNodes"],
            "registered")
        st = ref_httpd.http_json("GET", f"{vs.url}/status")
        if not st.get("readPlanePort"):
            pytest.skip("the JAX read plane did not build here")
        fid = ref_operation.submit(master.url, b"secret-needle")
        addr = f"127.0.0.1:{st['readPlanePort']}"
        body = b""
        for _ in range(100):
            # a Python-port read warms the plane's needle map
            assert ref_operation.read(master.url, fid) == b"secret-needle"
            body = _raw_get(addr, f"/{fid}")
            if body.startswith(b"HTTP/1.1 200"):
                break
            time.sleep(0.05)
        assert body.startswith(b"HTTP/1.1 200")
        assert body.endswith(b"secret-needle")
    finally:
        vs.stop()
        master.stop()


def test_c7_port_planes_stand_down_under_tls(tls_cluster):
    master, vs = tls_cluster
    st = http_json("GET", f"{vs.url}/status")
    assert st.get("readPlanePort", 0) == 0
    assert st.get("writePlanePort", 0) == 0
    assert not st.get("udsPath")
    assert vs.read_plane is None and vs.write_plane is None and \
        vs.uds_server is None
    text = stats.PROCESS.render()
    for plane in ("uds", "read", "write"):
        assert f'volume_server_plane_stood_down_total{{plane="{plane}",' \
               f'reason="tls"}}' in text
    # every needle still reads, over the TLS port
    fid = operation.submit(master.url, b"n" * 100)
    assert operation.read(master.url, fid) == b"n" * 100


def test_c7_port_filer_planes_stand_down_under_tls(tls_cluster, tmp_path):
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    master, _ = tls_cluster
    fs = FilerServer(master.url, store_path=str(tmp_path / "f.db")).start()
    try:
        assert fs.native_meta is None and fs.native_read is None
        st = http_json("GET", f"{fs.url}/status")
        assert st.get("metaPlanePort", 0) == 0
        assert st.get("readPlanePort", 0) == 0
        status, _, _ = http_bytes("PUT", f"{fs.url}/a/b.txt", b"filer-tls")
        assert status == 201
        status, body, _ = http_bytes("GET", f"{fs.url}/a/b.txt")
        assert (status, body) == (200, b"filer-tls")
        text = stats.PROCESS.render()
        for plane in ("meta", "read"):
            assert 'filer_native_plane_stood_down_total{' \
                   f'plane="{plane}",reason="tls"}}' in text
    finally:
        fs.stop()
