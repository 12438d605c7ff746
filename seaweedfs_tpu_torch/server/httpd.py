"""Threaded HTTP server with (method, path) routing, and the client
calls of the EC paths: the part of `seaweedfs_tpu/server/httpd.py` that
the port's master, volume server, shell, shard sinks and shard sources
use.

Handlers return (status, payload): a dict or list (JSON), bytes, or a
(body, headers) tuple whose body may be a file-like (a `FileSlice`,
sent with sendfile(2), or any reader, closed when the response ends).
Routes match the exact (method, path), then the longest registered path
prefix (`route_prefix`); a request that no route matches goes to the
server's `fallback` when it has one (the volume server's `/<fid>` data
path, the filer's namespace), else answers 404.  A HEAD response
carries the headers of its GET and no body.  Request bodies are read
whole (`body`, `json()`) or a chunk at a time (`stream_body()`,
Content-Length or chunked framing).
The wire formats are the reference's, so servers and clients of either
package talk to each other.

Deadlines (`util/deadline`): each request's budget is adopted at
ingress from its `X-Weed-Deadline-Ms` header, or the operator default
except on `/admin/` and `/debug/`; a request past its budget answers 504
with `Retry-After` before its handler runs, and a handler whose budget
ran out on an outbound hop answers 504 too.  Every client call here
forwards the remaining budget in the same header.

`http_bytes` and `http_json` go over a pooled keep-alive client (one
connection per thread and peer, the JAX package's `_pooled_request`);
the streaming calls keep a connection of their own for the transfer.

Plain HTTP, bound to 127.0.0.1 by default: no TLS, no admin JWT, no QoS
admission and no fault sites (ROADMAP C).
"""

from __future__ import annotations

import http.client
import json
import secrets
import select
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from .. import stats, tracing
from ..util import deadline


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler):
        path, _, query = handler.path.partition("?")
        self.method = handler.command
        self.path = path
        self.remote_ip = handler.client_address[0]
        self._raw_query = query
        self._query: "dict[str, str] | None" = None
        self.headers = handler.headers
        self._handler = handler
        self._body: bytes | None = None

    @property
    def query(self) -> "dict[str, str]":
        """Parsed query parameters (first value of each), blank values
        kept."""
        if self._query is None:
            self._query = {
                k: v[0] for k, v in urllib.parse.parse_qs(
                    self._raw_query, keep_blank_values=True).items()} \
                if self._raw_query else {}
        return self._query

    @property
    def body(self) -> bytes:
        if self._body is None:
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                self._body = b"".join(self._stream_chunked(4 << 20))
            else:
                length = int(self.headers.get("Content-Length") or 0)
                self._body = self._handler.rfile.read(length) \
                    if length else b""
        return self._body

    def json(self) -> dict:
        return json.loads(self.body or b"{}")

    def stream_body(self, chunk_size: int = 4 << 20):
        """Yield the request body in chunks without buffering it whole,
        for Content-Length and chunked framing.  While streaming, the
        connection is marked close-on-response, so a handler that fails
        mid-stream never leaves unread body bytes to be parsed as the
        next request; a clean end clears the mark.  Mutually exclusive
        with touching `.body` first."""
        if self._body is not None:
            if self._body:
                yield self._body
            return
        self._body = b""
        self._handler.close_connection = True
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            yield from self._stream_chunked(chunk_size)
            return
        length = int(self.headers.get("Content-Length") or 0)
        remaining = length
        while remaining > 0:
            chunk = self._handler.rfile.read(min(chunk_size, remaining))
            if not chunk:
                raise IOError(
                    f"short body: {remaining} of {length} bytes missing")
            remaining -= len(chunk)
            yield chunk
        self._handler.close_connection = False

    def _stream_chunked(self, chunk_size: int):
        """Chunk-at-a-time RFC 9112 §7.1 parser: nothing accumulates, so
        a chunked multi-GB upload streams with bounded memory.  Bad
        framing or a body that ends early raises IOError."""
        rfile = self._handler.rfile
        while True:
            size_line = rfile.readline(1024).strip()
            try:
                size = int(size_line.split(b";")[0], 16)
            except ValueError:
                raise IOError(f"malformed chunk framing: "
                              f"{size_line[:64]!r}") from None
            if size == 0:
                while True:  # optional trailers up to the blank line
                    line = rfile.readline(1024)
                    if line in (b"\r\n", b"\n", b""):
                        break
                break
            remaining = size
            while remaining > 0:
                piece = rfile.read(min(chunk_size, remaining))
                if not piece:
                    raise IOError("short chunked body")
                remaining -= len(piece)
                yield piece
            rfile.readline(8)  # CRLF after each chunk
        self._handler.close_connection = False

    def drain(self, max_drain: int = 64 << 20) -> None:
        """Discard any unread body with bounded memory; a chunked or
        oversized unread body closes the connection instead."""
        if self._body is not None:
            return
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        length = int(self.headers.get("Content-Length") or 0)
        if "chunked" in te or length > max_drain:
            self._body = b""
            self._handler.close_connection = True
            return
        remaining = length
        while remaining > 0:
            chunk = self._handler.rfile.read(min(1 << 20, remaining))
            if not chunk:
                self._handler.close_connection = True
                break
            remaining -= len(chunk)
        self._body = b""


Route = Callable[[Request], "tuple[int, object]"]


def normalize_payload(payload) -> "tuple[object, str, dict]":
    """(body or file-like, content type, extra headers) of a handler's
    payload: a dict or list (JSON), bytes, or a (body, headers) tuple."""
    if isinstance(payload, (dict, list)):
        return json.dumps(payload).encode(), "application/json", {}
    if isinstance(payload, tuple):
        body, extra = payload
        extra = dict(extra)
        return body, extra.pop("Content-Type",
                               "application/octet-stream"), extra
    return payload, "application/octet-stream", {}


class FileSlice:
    """A file-like over [current position, + size) of an open file, for
    streamed byte-range responses; closes the file with it."""

    def __init__(self, f, size: int):
        self._f = f
        self._remaining = max(size, 0)

    def read(self, n: int = -1) -> bytes:
        if self._remaining <= 0:
            return b""
        if n < 0 or n > self._remaining:
            n = self._remaining
        chunk = self._f.read(n)
        self._remaining -= len(chunk)
        if not chunk:
            self._remaining = 0
        return chunk

    def close(self) -> None:
        self._f.close()


class HttpServer:
    """Exact (method, path) routes, then the `fallback` route, on the
    stdlib ThreadingHTTPServer, one thread per connection.  Each request
    runs under a server span whose trace id is the caller's X-Request-ID
    (or a fresh one) and whose parent is the caller's X-Trace-Parent,
    and under the deadline its X-Weed-Deadline-Ms grants."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.routes: dict[tuple[str, str], Route] = {}
        # method -> [(prefix, route)], longest prefix first
        self.prefix_routes: dict[str, list[tuple[str, Route]]] = {}
        self.fallback: "Route | None" = None
        self.role = ""
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # small control requests must not wait in Nagle's window
            disable_nagle_algorithm = True

            def _dispatch(self):
                req = Request(self)
                rid = req.headers.get(tracing.REQUEST_ID_HEADER) or \
                    secrets.token_hex(8)
                tracing.set_request_id(rid)
                _, parent = tracing.parse_traceparent(
                    req.headers.get(tracing.HEADER, ""))
                # the budget is bound before anything spends time on
                # the request (always rebinding: handler threads are
                # reused); the maintenance routes get no default budget
                site = outer.role or "server"
                dl = deadline.adopt(
                    req.headers.get(deadline.HEADER), site=site,
                    allow_default=not req.path.startswith(
                        ("/admin/", "/debug/")))
                sp = tracing.start_span(f"{req.method} {req.path}",
                                        role=outer.role, parent=parent,
                                        trace_id=rid)
                if dl is not None:
                    sp.set("deadlineMs", int(dl.remaining() * 1e3))
                status = 0
                body = None
                try:
                    route = outer.routes.get((req.method, req.path)) \
                        or outer._prefix_route(req.method, req.path) \
                        or outer.fallback
                    try:
                        if dl is not None and dl.expired():
                            status, payload = deadline.expired_response(
                                f"{site}.ingress")
                        elif route is None:
                            status, payload = 404, {"error": "not found"}
                        else:
                            status, payload = route(req)
                    except deadline.DeadlineExceeded as e:
                        # the budget ran out on an outbound hop
                        status, payload = \
                            deadline.handler_exceeded_response()
                        sp.set_error(e)
                    except Exception as e:  # noqa: BLE001 — the server
                        # must answer, and the error is the answer
                        status, payload = 500, {"error": str(e)}
                        sp.set_error(e)
                    try:
                        req.drain()
                    except OSError:
                        self.close_connection = True
                    body, ctype, extra = normalize_payload(payload)
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header(tracing.REQUEST_ID_HEADER, rid)
                    for hk, hv in extra.items():
                        self.send_header(hk, hv)
                    if hasattr(body, "read"):
                        # file-like: Content-Length is in `extra`; never
                        # chunked
                        self.end_headers()
                        if req.method != "HEAD":
                            self._send_file(body)
                        return
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    if req.method != "HEAD":
                        self.wfile.write(body)
                finally:
                    if hasattr(body, "close"):
                        body.close()
                    sp.set("status", status)
                    sp.finish()

            def _send_file(self, body) -> None:
                """sendfile(2) for a FileSlice over a real file, a read
                loop otherwise.  A partial sendfile is never retried:
                the connection is closed instead of re-sending bytes."""
                f = getattr(body, "_f", None)
                count = getattr(body, "_remaining", 0)
                if f is not None and count > 0 and hasattr(f, "fileno"):
                    try:
                        self.wfile.flush()
                        # offset defaults to 0, not the file position
                        self.connection.sendfile(f, offset=f.tell(),
                                                 count=count)
                    except (OSError, ValueError):
                        self.close_connection = True
                    return
                while True:
                    chunk = body.read(1 << 20)
                    if not chunk:
                        break
                    self.wfile.write(chunk)

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _dispatch

            def log_message(self, *args):  # quiet
                pass

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True
            # a burst of clients dialing at once (each thread of each
            # client opens its own keep-alive connection) overflows the
            # default backlog of 5, and a dropped SYN waits out a 1 s
            # retransmit
            request_queue_size = 128

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                # established keep-alive connections, so stop() can
                # sever them: shutdown() only ends the accept loop
                self._conns: set = set()
                self._conns_lock = threading.Lock()

            def finish_request(self, request, client_address):
                with self._conns_lock:
                    self._conns.add(request)
                try:
                    super().finish_request(request, client_address)
                finally:
                    with self._conns_lock:
                        self._conns.discard(request)

            def close_established(self):
                with self._conns_lock:
                    conns = list(self._conns)
                for c in conns:
                    try:
                        c.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        c.close()
                    except OSError:
                        pass

            def handle_error(self, request, client_address):
                # a peer dropping the socket mid-response is teardown,
                # not a stack trace
                import sys
                if isinstance(sys.exc_info()[1],
                              (BrokenPipeError, ConnectionResetError,
                               ConnectionAbortedError)):
                    return
                super().handle_error(request, client_address)

        self._httpd = Server((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def route(self, method: str, path: str, fn: Route) -> None:
        self.routes[(method, path)] = fn

    def route_prefix(self, method: str, prefix: str, fn: Route) -> None:
        """Register a handler for every path under `prefix`.  The
        per-method table is kept longest-prefix-first so nested
        prefixes resolve to the most specific handler."""
        table = self.prefix_routes.setdefault(method, [])
        table[:] = [(p, f) for p, f in table if p != prefix]
        table.append((prefix, fn))
        table.sort(key=lambda pf: -len(pf[0]))

    def _prefix_route(self, method: str, path: str) -> "Route | None":
        for prefix, fn in self.prefix_routes.get(method, ()):
            if path.startswith(prefix):
                return fn
        return None

    def start(self) -> None:
        # a short poll keeps stop() from waiting out the default 0.5 s
        self._thread = threading.Thread(
            target=lambda: self._httpd.serve_forever(poll_interval=0.02),
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop accepting, close the listener, and sever established
        connections: a stopped server answers nothing more."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()
        self._httpd.close_established()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"


def parse_range(header: str, total: int
                ) -> "tuple[int, int] | None | str":
    """One shared parser for `Range: bytes=...` (RFC 9110 §14):
    returns (offset, size), None for absent/malformed (serve the full
    body), or "unsatisfiable" for a well-formed range beyond EOF.
    Handles the suffix form bytes=-N (last N bytes)."""
    if not header.startswith("bytes="):
        return None
    spec = header[6:]
    if "," in spec:
        return None            # multipart ranges: serve full body
    lo, dash, hi = spec.partition("-")
    if not dash:
        return None
    try:
        if lo:
            offset = int(lo)
            if offset >= total > 0 or offset < 0:
                return "unsatisfiable"
            stop = min(int(hi) + 1, total) if hi else total
            if stop <= offset:
                return None
            return offset, stop - offset
        if hi:                 # suffix: last N bytes
            size = min(int(hi), total)
            if size <= 0:
                return None    # bytes=-0 / bytes=--5: not a range
            return total - size, size
    except ValueError:
        return None
    return None


# --- client calls ---------------------------------------------------------

def _dial(url: str) -> str:
    """The full URL of a `host:port/path` address (plain http)."""
    return url if url.startswith("http") else "http://" + url


def _connect(url: str, timeout: float
             ) -> "tuple[http.client.HTTPConnection, str]":
    """A fresh connection to the url's host and the request target."""
    parsed = urllib.parse.urlsplit(_dial(url))
    if parsed.scheme != "http":
        raise ValueError(f"{url}: only plain http is supported")
    target = parsed.path or "/"
    if parsed.query:
        target += "?" + parsed.query
    return http.client.HTTPConnection(parsed.netloc,
                                      timeout=timeout), target


def _with_trace(headers: "dict | None") -> dict:
    """The caller's headers plus the active request id and span, so the
    receiver's server span joins the caller's trace, and the remaining
    budget of the active deadline, so the receiver cannot out-wait the
    caller."""
    headers = dict(deadline.stamp_headers(headers or {}))
    rid = tracing.get_request_id()
    if rid:
        headers.setdefault(tracing.REQUEST_ID_HEADER, rid)
    tp = tracing.traceparent_header()
    if tp:
        headers.setdefault(tracing.HEADER, tp)
    return headers


# --- the pooled keep-alive client ----------------------------------------
#
# A fresh connection a call costs the TCP setup on every 1 KiB needle; the
# reference's Go client keeps connections alive.  The pool is per thread
# (no lock on the request's path) and keyed by scheme and netloc.  A
# request is re-sent once, on a fresh connection, only when a reused
# socket died before the request reached the wire: one the peer closed
# while it sat idle in the pool, or one whose send failed.  When the
# response is lost after the send, only an idempotent request is re-sent
# (RFC 9110's methods, or a POST that declares `X-Idempotent: 1`): the
# server may have run it.

_thread_pools = threading.local()
_IDEMPOTENT = ("GET", "HEAD", "PUT", "DELETE", "OPTIONS")


def _pool() -> dict:
    p = getattr(_thread_pools, "conns", None)
    if p is None:
        p = _thread_pools.conns = {}
    return p


def _peer_closed(sock: socket.socket) -> bool:
    """True when an idle pooled socket is readable: the peer closed it
    (an idle keep-alive connection has nothing else to read)."""
    try:
        return bool(select.select([sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


def _one_pooled_request(method: str, full_url: str, body,
                        headers: dict, timeout: float
                        ) -> "tuple[int, bytes, dict]":
    """One request over the thread's connection to the url's peer:
    (status, body, headers)."""
    parsed = urllib.parse.urlsplit(full_url)
    if parsed.scheme != "http":
        raise ValueError(f"{full_url}: only plain http is supported")
    target = parsed.path or "/"
    if parsed.query:
        target += "?" + parsed.query
    key = (parsed.scheme, parsed.netloc)
    pool = _pool()
    for attempt in (0, 1):
        conn = pool.get(key)
        if conn is not None and (conn.sock is None or
                                 _peer_closed(conn.sock)):
            conn.close()              # closed while idle: nothing sent
            del pool[key]
            conn = None
        reused = conn is not None
        if reused:
            stats.PROCESS.counter_add(
                "pool_connections_reused_total", 1.0,
                help_text="pooled requests served over a kept-alive "
                          "socket", peer=parsed.netloc)
        else:
            stats.PROCESS.counter_add(
                "pool_connections_opened_total", 1.0,
                help_text="fresh sockets dialed by the pooled client",
                peer=parsed.netloc)
            conn = pool[key] = http.client.HTTPConnection(
                parsed.netloc, timeout=timeout)
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        try:
            conn.request(method, target, body=body, headers=headers)
        except (http.client.HTTPException, OSError) as e:
            # the send failed: the request never ran
            conn.close()
            pool.pop(key, None)
            if reused and attempt == 0:
                continue
            raise OSError(f"{method} {full_url}: {e!r}") from e
        try:
            resp = conn.getresponse()
            data = resp.read()
        except (http.client.HTTPException, OSError) as e:
            conn.close()
            pool.pop(key, None)
            if attempt == 0 and reused and \
                    isinstance(e, http.client.RemoteDisconnected) and \
                    (method in _IDEMPOTENT or
                     headers.get("X-Idempotent") == "1"):
                continue
            if isinstance(e, OSError):
                raise
            raise OSError(f"{method} {full_url}: {e!r}") from e
        if resp.will_close:
            conn.close()
            pool.pop(key, None)
        return resp.status, data, dict(resp.headers)
    raise OSError("unreachable")  # pragma: no cover


def http_bytes(method: str, url: str, body: bytes | None = None,
               headers: dict | None = None, timeout: float = 60.0
               ) -> "tuple[int, bytes, dict]":
    """One request over the pooled keep-alive client: (status, body,
    headers).  Transport failures raise OSError."""
    return _one_pooled_request(method, _dial(url), body,
                               _with_trace(headers), timeout)


def http_json(method: str, url: str, payload: dict | None = None,
              timeout: float = 30.0, headers: dict | None = None) -> dict:
    """JSON request; a non-2xx response returns its parsed body with an
    "error" key (callers check for it, as for a gRPC status)."""
    data = json.dumps(payload).encode() if payload is not None else None
    headers = dict(headers or {})
    if data:
        headers.setdefault("Content-Type", "application/json")
    status, body, _ = http_bytes(method, url, data, headers, timeout)
    try:
        parsed = json.loads(body or b"{}")
    except ValueError:
        parsed = {"error": body.decode(errors="replace")}
    if status >= 300 and isinstance(parsed, dict):
        parsed.setdefault("error", f"HTTP {status}")
    return parsed


def http_open_stream(url: str, headers: dict | None = None,
                     timeout: float = 60.0
                     ) -> "tuple[http.client.HTTPConnection, http.client.HTTPResponse]":
    """A GET whose response body the caller reads incrementally
    (`resp.readinto`); the caller checks the status and closes the
    connection.  A whole streamed rebuild costs one such request per
    survivor."""
    conn, target = _connect(url, timeout)
    try:
        conn.request("GET", target, headers=_with_trace(headers))
        return conn, conn.getresponse()
    except (OSError, http.client.HTTPException) as e:
        conn.close()
        if isinstance(e, OSError):
            raise
        raise OSError(f"GET {url}: {e!r}") from e


def http_stream_request(method: str, url: str, chunks,
                        headers: dict | None = None,
                        timeout: float = 60.0) -> "tuple[int, bytes]":
    """Send an iterable of byte windows as ONE chunked request body (the
    producer side of `Request.stream_body`): the request is on the wire
    from the first window, with bounded memory.  A producer exception
    tears the connection down mid-body, so the receiver sees a short
    chunked stream and errors, never a clean truncated upload.  Returns
    (status, body)."""
    conn, target = _connect(url, timeout)
    try:
        # framing by hand: http.client's encode_chunked concatenates
        # header + chunk + trailer into a fresh buffer per window; three
        # sends straight off the caller's memoryview copy nothing
        conn.putrequest(method, target, skip_accept_encoding=True)
        for hk, hv in _with_trace(headers).items():
            conn.putheader(hk, hv)
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        if conn.sock is not None:
            # small size-line sends between multi-MB payload sends must
            # not wait behind delayed ACKs
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        it = iter(chunks)
        while True:
            # a producer error propagates from here, and the finally
            # tears the connection down mid-body
            chunk = next(it, None)
            try:
                if chunk is None:
                    conn.send(b"0\r\n\r\n")
                    break
                if len(chunk):
                    conn.send(b"%X\r\n" % len(chunk))
                    conn.send(chunk)
                    conn.send(b"\r\n")
            except OSError:
                # the receiver may have rejected the upload mid-body
                # (4xx/5xx and close): its verdict, if readable, is the
                # root cause
                try:
                    resp = conn.getresponse()
                    return resp.status, resp.read()
                except (OSError, http.client.HTTPException):
                    pass
                raise
        resp = conn.getresponse()
        return resp.status, resp.read()
    except http.client.HTTPException as e:
        raise OSError(f"{method} {url}: {e!r}") from e
    finally:
        conn.close()


def http_download(url: str, dest_path: str, headers: dict | None = None,
                  timeout: float = 60.0, chunk_size: int = 4 << 20
                  ) -> "tuple[int, dict]":
    """GET `url` into `dest_path` a chunk at a time, never holding the
    file in memory: (status, response headers).  The body lands in a
    sibling temp file renamed into place on success, so a transfer that
    dies midway never leaves a short file at `dest_path`; a non-2xx
    status leaves `dest_path` untouched.  `timeout` bounds each socket
    operation, not the transfer."""
    import os
    import uuid
    conn, target = _connect(url, timeout)
    tmp = f"{dest_path}.download.{uuid.uuid4().hex}"
    try:
        conn.request("GET", target, headers=_with_trace(headers))
        resp = conn.getresponse()
        if resp.status // 100 != 2:
            return resp.status, dict(resp.headers)
        expected = resp.length
        got = 0
        with open(tmp, "wb") as f:
            while True:
                chunk = resp.read(chunk_size)
                if not chunk:
                    break
                f.write(chunk)
                got += len(chunk)
        if expected is not None and got != expected:
            raise OSError(f"download {url}: {got} of {expected} bytes")
        os.replace(tmp, dest_path)
        return resp.status, dict(resp.headers)
    except http.client.HTTPException as e:
        raise OSError(f"GET {url}: {e!r}") from e
    finally:
        conn.close()
        try:
            os.remove(tmp)
        except OSError:
            pass


def http_upload(method: str, url: str, src_path: str,
                headers: dict | None = None, timeout: float = 60.0
                ) -> "tuple[int, bytes, dict]":
    """Send a file as the request body without holding it in memory:
    Content-Length from the file's size, the body read off disk 4 MiB at
    a time (the worker's shard push).  `timeout` bounds each socket
    operation, not the transfer.  Returns (status, body, headers)."""
    import os
    conn, target = _connect(url, timeout)
    conn.blocksize = 4 << 20
    headers = _with_trace(headers)
    headers["Content-Length"] = str(os.path.getsize(src_path))
    try:
        with open(src_path, "rb") as f:
            conn.request(method, target, body=f, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.headers)
    except http.client.HTTPException as e:
        raise OSError(f"{method} {url}: {e!r}") from e
    finally:
        conn.close()


def http_relay(src_url: str, dst_method: str, dst_url: str,
               headers: dict | None = None, timeout: float = 60.0,
               chunk_size: int = 4 << 20) -> "tuple[int, int, bytes]":
    """Stream a GET of `src_url` into a chunked `dst_method dst_url`
    body: the push starts at the first downloaded chunk, and memory
    stays at one chunk.  Returns (src_status, dst_status, dst_body); on
    a non-2xx source the upload never starts (dst_status 0).  A source
    that ends short of its Content-Length raises, so the destination
    sees a broken chunked stream and never a clean short file."""
    src, target = _connect(src_url, timeout)
    try:
        src.request("GET", target, headers=_with_trace(headers))
        resp = src.getresponse()
        if resp.status != 200:
            return resp.status, 0, b""
        expected = resp.length

        def chunks():
            sent = 0
            while True:
                chunk = resp.read(chunk_size)
                if not chunk:
                    if expected is not None and sent != expected:
                        raise OSError(f"relay source {src_url} ended at "
                                      f"{sent} of {expected} bytes")
                    return
                sent += len(chunk)
                yield chunk
        status, body = http_stream_request(dst_method, dst_url, chunks(),
                                           headers=headers,
                                           timeout=timeout)
        return 200, status, body
    except http.client.HTTPException as e:
        raise OSError(f"relay {src_url} -> {dst_url}: {e!r}") from e
    finally:
        src.close()
