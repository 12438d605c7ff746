"""The port's pooled keep-alive client (`server/httpd.py`,
`http_bytes`/`http_json`), the JAX package's `_pooled_request`: one
connection a thread and peer, reused; one re-dial on a socket that died
before the request reached the wire; a POST re-sent only when it
declares `X-Idempotent: 1`; the deadline and trace headers on every
request.  Servers on loopback, in this process."""

import socket
import threading

import pytest

from seaweedfs_tpu_torch import stats, tracing
from seaweedfs_tpu_torch.server import httpd
from seaweedfs_tpu_torch.server.httpd import HttpServer, http_bytes, http_json
from seaweedfs_tpu_torch.util import deadline


def _opened(peer: str) -> float:
    return stats.PROCESS.counter_value("pool_connections_opened_total",
                                       peer=peer) or 0.0


def _echo_server(port: int = 0) -> "tuple[HttpServer, list]":
    """A server that answers every request with the headers it got, and
    records each request's client port."""
    seen: list = []
    srv = HttpServer(port=port)

    def echo(req):
        seen.append(req._handler.client_address[1])
        return 200, {k: v for k, v in req.headers.items()}
    srv.route("GET", "/echo", echo)
    srv.route("POST", "/echo", echo)
    srv.start()
    return srv, seen


@pytest.fixture(autouse=True)
def fresh_pool():
    httpd._thread_pools.__dict__.clear()
    yield
    for conn in getattr(httpd._thread_pools, "conns", {}).values():
        conn.close()
    httpd._thread_pools.__dict__.clear()


def test_requests_reuse_one_connection_a_thread():
    srv, seen = _echo_server()
    try:
        before = _opened(srv.url)
        for _ in range(40):
            assert http_bytes("GET", f"{srv.url}/echo")[0] == 200
            assert "error" not in http_json("POST", f"{srv.url}/echo", {})
        assert len(set(seen)) == 1 and len(seen) == 80
        assert _opened(srv.url) - before == 1

        def worker():
            for _ in range(10):
                http_bytes("GET", f"{srv.url}/echo")
        threads = [threading.Thread(target=worker) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # each thread keeps its own socket to the peer
        assert len(set(seen)) == 4 and len(seen) == 110
        assert _opened(srv.url) - before == 4
    finally:
        srv.stop()


@pytest.mark.parametrize("method,body", [("GET", None), ("POST", b"{}"),
                                         ("POST", None)])
def test_a_restart_between_requests_costs_one_redial(method, body):
    """A socket the peer closed while it sat in the pool is replaced
    before anything is sent, whatever the method: a POST without a body
    goes out in one send, so no failed send would reveal the dead
    socket."""
    srv, seen = _echo_server()
    port = srv.port
    try:
        assert http_bytes(method, f"{srv.url}/echo", body)[0] == 200
        before = _opened(srv.url)
        srv.stop()       # severs the kept-alive connection
        srv, seen = _echo_server(port)
        for _ in range(3):
            st, _, _ = http_bytes(method, f"{srv.url}/echo", body)
            assert st == 200
        assert _opened(srv.url) - before == 1
        assert len(seen) == 3
    finally:
        srv.stop()


class _DropSecond:
    """A raw HTTP/1.1 server that answers the first request of every
    connection and closes the connection, unanswered, on its second:
    a keep-alive socket that dies after the request was sent."""

    def __init__(self):
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.requests: list = []
        self._stop = False
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(conn,),
                             daemon=True).start()

    def _read_request(self, f) -> "str | None":
        line = f.readline()
        if not line:
            return None
        length = 0
        while True:
            h = f.readline()
            if h in (b"\r\n", b""):
                break
            k, _, v = h.decode().partition(":")
            if k.lower() == "content-length":
                length = int(v)
        f.read(length)
        return line.decode().split(" ")[0]

    def _conn(self, conn):
        f = conn.makefile("rb")
        for i in (0, 1):
            method = self._read_request(f)
            if method is None:
                break
            self.requests.append(method)
            if i == 1:
                break
            conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
        f.close()
        conn.close()

    def close(self):
        self._stop = True
        self.sock.close()


@pytest.mark.parametrize("method,headers,resent", [
    ("POST", {}, False),
    ("POST", {"X-Idempotent": "1"}, True),
    ("GET", {}, True),
])
def test_a_socket_dead_after_the_send(method, headers, resent):
    srv = _DropSecond()
    url = f"127.0.0.1:{srv.port}/x"
    try:
        assert http_bytes(method, url, b"a", headers)[:2] == (200, b"ok")
        if resent:
            # the second send died unanswered; it went again, once, on a
            # fresh connection
            assert http_bytes(method, url, b"b", headers)[:2] == \
                (200, b"ok")
            assert srv.requests == [method] * 3
        else:
            with pytest.raises(OSError):
                http_bytes(method, url, b"b", headers)
            assert srv.requests == [method] * 2
    finally:
        srv.close()


def test_deadline_and_trace_headers_reach_the_server():
    srv, _ = _echo_server()
    try:
        token = tracing.set_request_id("pool-test-rid")
        try:
            with deadline.scope(5.0), tracing.span("client"):
                got = http_json("GET", f"{srv.url}/echo")
                tp = tracing.traceparent_header()
            plain = http_json("GET", f"{srv.url}/echo")
        finally:
            tracing.reset_request_id(token)
        assert 0 < int(got[deadline.HEADER]) <= 5000
        assert got[tracing.REQUEST_ID_HEADER] == "pool-test-rid"
        assert got[tracing.HEADER] == tp
        # the same pooled socket carries an unbudgeted request without one
        assert deadline.HEADER not in plain
    finally:
        srv.stop()
