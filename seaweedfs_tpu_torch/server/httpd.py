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

Security (`security.py`, `tls.py`): an owner's `guard` runs before the
route and answers 401 for an admin path without the admin JWT.  Under
`[tls]` every listener handshakes in its connection's handler thread
(10 s at most; a failed handshake is counted in
`tls_handshake_failures_total{reason}` and never reaches dispatch),
with mTLS when the configuration asks, and every client call here dials
https with the cluster CA pinned; `_auth_for` attaches the process's
admin JWT to admin paths.  Bound to 127.0.0.1 by default.

QoS (`qos.install`): an owner's `admission` hook runs after a spent
budget's 504 and before the guard, as the reference's does; it answers
503 with `Retry-After` for an over-limit tenant, or admits with a
release that runs on the response's finally path, after the body was
written.

Retries (`util/retry`): `http_bytes` and `http_json` run each request
under `retry_call`, with the peer's breaker consulted before every
attempt; only idempotent requests (RFC 9110's methods, or a POST that
declares `X-Idempotent: 1`) are re-issued, under backoff and the
process's retry budget.  A POST keeps the pool's one rule: it is re-sent
only when it provably never reached the wire.

Fault sites (`faults.py`): `httpd.pool.connect` and `httpd.pool.request`
in the pooled client, `httpd.stream.chunk`, `httpd.relay.chunk` and
`httpd.download.chunk` in the streaming calls.

Observability, the same on both fronts: each request's server span; the
owner's registry (`metrics`) gets `requests_in_flight`,
`request_seconds{method,code}` and, for the requests that draw the CPU
sample (`profiling.cpu_attr_front`), `request_cpu_seconds`; the flight
recorder (`profiling.flight_recorder`) sees every finished request with
its verdict, deadline, stage summary and flight notes.

Fronts: the threaded server, or for the roles `async_front_roles()`
names (`SEAWEEDFS_TPU_ASYNC_FRONT`) the asyncio front
(`async_front.py`), which takes over the listener bound here.  A
`reuse_port` server binds with SO_REUSEPORT, so a pre-fork filer fleet
shares one port.
"""

from __future__ import annotations

import http.client
import json
import os
import select
import socket
import ssl
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from .. import faults, profiling, stats, tracing
from ..util import deadline, request_id, wlog


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
    payload: a dict or list (JSON), bytes or str, or a (body, headers)
    or (body, content type) tuple."""
    if isinstance(payload, (dict, list)):
        return json.dumps(payload).encode(), "application/json", {}
    if isinstance(payload, tuple):
        body, extra = payload
        if isinstance(body, str):
            body = body.encode()
        if not isinstance(extra, dict):
            return body, extra, {}
        extra = dict(extra)
        return body, extra.pop("Content-Type",
                               "application/octet-stream"), extra
    if isinstance(payload, str):
        payload = payload.encode()
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

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 reuse_port: bool = False):
        self.routes: dict[tuple[str, str], Route] = {}
        # method -> [(prefix, route)], longest prefix first
        self.prefix_routes: dict[str, list[tuple[str, Route]]] = {}
        self.fallback: "Route | None" = None
        # the owner's auth hook (security/guard.go Guard): None to go on,
        # or the (status, payload) that answers instead of the route
        self.guard: "Route | None" = None
        # the QoS admission hook (qos.install): None to go on, or
        # (deny_response | None, release | None); release runs once the
        # response was written
        self.admission: "Callable[[Request], tuple] | None" = None
        # the owner's role labels the server spans; its registry, when
        # set, gets requests_in_flight, request_seconds and
        # request_cpu_seconds from this one middleware (either front)
        self.role = ""
        self.metrics = None
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # (method, code) -> pre-resolved observers of the two histograms
        self._req_obs: dict = {}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # small control requests must not wait in Nagle's window
            disable_nagle_algorithm = True

            def _dispatch(self):
                req = Request(self)
                # the caller's request id, or a fresh one (util/
                # request_id): the log lines, the spans and the answer
                # carry it
                rid = request_id.ensure_request_id(
                    req.headers.get(request_id.HEADER))
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
                # the flight recorder: the request's notes dict, and its
                # thread CPU when it draws the attribution sample
                flight_on = profiling.recorder_enabled()
                if flight_on:
                    profiling.arm_flight_notes()
                cpu0 = time.thread_time() \
                    if profiling.cpu_attr_front(dl is not None) else None
                sp = tracing.start_span(f"{req.method} {req.path}",
                                        role=outer.role, parent=parent,
                                        trace_id=rid)
                if dl is not None:
                    sp.set("deadlineMs", int(dl.remaining() * 1e3))
                status = 0
                body = None
                verdict = "ok"
                release = None
                outer._enter()
                try:
                    status, payload, verdict, release = \
                        outer._answer(req, dl, sp)
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
                    _run_release(release)
                    sp.set("status", status)
                    sp.finish()
                    # this thread's CPU for the request, response write
                    # included; None when it drew no sample
                    cpu = (time.thread_time() - cpu0) \
                        if cpu0 is not None else None
                    outer._leave(req.method, status, sp, cpu)
                    # the finished track's summary is taken whether or
                    # not the recorder is armed, so a reused thread never
                    # hands it to a later request
                    summary = profiling.take_last_summary()
                    if flight_on:
                        outer._observe(req, status, sp, cpu, verdict,
                                       rid, dl, summary,
                                       profiling.take_flight_notes())

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

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = \
                do_OPTIONS = _dispatch
            do_PATCH = _dispatch    # TUS resumable uploads
            # WebDAV verbs (server/webdav_server.py)
            do_PROPFIND = do_MKCOL = do_MOVE = do_COPY = _dispatch

            def log_message(self, *args):  # quiet
                pass

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True
            # a pre-fork filer fleet binds one port in every sibling
            reuse_port = False

            def server_bind(self):
                if self.reuse_port:
                    self.socket.setsockopt(socket.SOL_SOCKET,
                                           socket.SO_REUSEPORT, 1)
                super().server_bind()

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
                self.ssl_context: "ssl.SSLContext | None" = None

            def finish_request(self, request, client_address):
                # the TLS handshake runs here, in the connection's own
                # handler thread: in the accept loop one silent client
                # would stall every other.  The raw socket is tracked
                # before the handshake, so stop() severs a connection
                # parked in it too.
                raw = request
                with self._conns_lock:
                    self._conns.add(raw)
                try:
                    if self.ssl_context is not None:
                        try:
                            request.settimeout(HANDSHAKE_TIMEOUT)
                            request = self.ssl_context.wrap_socket(
                                request, server_side=True)
                            request.settimeout(None)
                        except (ssl.SSLError, OSError) as e:
                            stats.PROCESS.counter_add(
                                "tls_handshake_failures_total", 1.0,
                                help_text="inbound TLS handshakes that "
                                          "never completed",
                                reason=type(e).__name__)
                            try:
                                request.close()
                            except OSError:
                                pass
                            return
                        with self._conns_lock:
                            self._conns.discard(raw)
                            self._conns.add(request)
                    super().finish_request(request, client_address)
                finally:
                    with self._conns_lock:
                        self._conns.discard(request)
                        self._conns.discard(raw)

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

        Server.reuse_port = bool(reuse_port)
        self._httpd = Server((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None
        self._async = None   # the asyncio front, when selected (start)

    # -- the middleware both fronts share ---------------------------------

    def _answer(self, req, dl, sp) -> "tuple[int, object, str, object]":
        """(status, payload, verdict, release) of a request: a spent
        budget answers 504 before anything else, then QoS admission (503
        for an over-limit tenant), then the guard, then the route
        (exact, prefix, fallback).  A budget that runs out on an
        outbound hop answers 504, any other error 500.  `release` is the
        admission's, for the front to run once the response is
        written."""
        route = self.routes.get((req.method, req.path)) \
            or self._prefix_route(req.method, req.path) or self.fallback
        release = None
        try:
            if dl is not None and dl.expired():
                return (*deadline.expired_response(
                    f"{self.role or 'server'}.ingress"), "deadline",
                    None)
            if self.admission is not None:
                throttled, release = self.admission(req)
                if throttled is not None:
                    return (*throttled, "shed", None)
            if self.guard is not None and \
                    (denied := self.guard(req)) is not None:
                return (*denied, "ok", release)
            if route is None:
                return 404, {"error": "not found"}, "ok", release
            return (*route(req), "ok", release)
        except deadline.DeadlineExceeded as e:
            sp.set_error(e)
            return (*deadline.handler_exceeded_response(), "deadline",
                    release)
        except Exception as e:  # noqa: BLE001 — the server must answer,
            # and the error is the answer
            sp.set_error(e)
            return 500, {"error": str(e)}, "error", release

    def _enter(self) -> None:
        with self._inflight_lock:
            self._inflight += 1
            inflight = self._inflight
        if self.metrics is not None:
            self.metrics.gauge_set(
                "requests_in_flight", inflight,
                help_text="requests currently being handled")

    def _leave_unanswered(self) -> None:
        """A request that never reached its handler's answer (the
        connection died first): the in-flight gauge only."""
        with self._inflight_lock:
            self._inflight -= 1
            inflight = self._inflight
        if self.metrics is not None:
            self.metrics.gauge_set("requests_in_flight", inflight)

    def _leave(self, method: str, status: int, sp,
               cpu: "float | None") -> None:
        """The request is answered: the in-flight gauge, its wall into
        request_seconds and its sampled CPU into request_cpu_seconds."""
        with self._inflight_lock:
            self._inflight -= 1
            inflight = self._inflight
        if self.metrics is None:
            return
        self.metrics.gauge_set("requests_in_flight", inflight)
        cell = (method, status)
        obs = self._req_obs.get(cell)
        if obs is None:
            obs = self._req_obs[cell] = (
                self.metrics.observer(
                    "request_seconds",
                    help_text="HTTP request handling latency",
                    method=method, code=str(status)),
                self.metrics.observer(
                    "request_cpu_seconds",
                    buckets=profiling.STAGE_BUCKETS,
                    help_text="handler-thread CPU per request "
                              "(thread_time, sampled — see SEAWEEDFS_"
                              "TPU_CPU_SAMPLE); request_seconds minus "
                              "this is GIL/lock/IO wait",
                    method=method, code=str(status)))
        obs[0](sp.duration)
        if cpu is not None:
            obs[1](cpu)

    def _observe(self, req, status: int, sp, cpu: "float | None",
                 verdict: str, rid: str, dl, summary, notes) -> None:
        """Feed the finished request to the flight recorder, after the
        server span finished (the capture pulls the trace's spans)."""
        dl_doc = None
        if dl is not None:
            dl_doc = {"budgetMs": int(dl.budget * 1e3),
                      "remainingMs": int(dl.remaining() * 1e3)}
        try:
            profiling.flight_recorder().observe(
                role=self.role or "server", method=req.method,
                path=req.path, status=status, wall_s=sp.duration,
                cpu_s=cpu, verdict=verdict, trace_id=rid,
                deadline=dl_doc, stages=summary, notes=notes)
        except Exception as e:  # noqa: BLE001 — observability must
            # never break a reply
            wlog.warning("flight capture failed: %s", e,
                         component="profiling")

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
        tls = _tls_config()
        if self.role and self.role in async_front_roles():
            # the asyncio front (async_front.py): one event loop for
            # every connection of this role, the same routes, guard,
            # spans and metrics; it takes over the bound listener, so
            # the advertised port stays the port served
            from .async_front import AsyncFront
            self._async = AsyncFront(
                self, ssl_context=(tls.server_context()
                                   if tls is not None else None))
            self._async.start(self._httpd.socket)
            return
        if tls is not None:
            self._httpd.ssl_context = tls.server_context()
        # a short poll keeps stop() from waiting out the default 0.5 s
        self._thread = threading.Thread(
            target=lambda: self._httpd.serve_forever(poll_interval=0.02),
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop accepting, close the listener, and sever established
        connections: a stopped server answers nothing more."""
        front, self._async = self._async, None
        if front is not None:
            front.stop()
            self._httpd.server_close()   # the shared socket
            return
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()
        self._httpd.close_established()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"


def _run_release(release) -> None:
    """Run an admission's release; accounting never breaks a reply."""
    if release is None:
        return
    try:
        release()
    except Exception as e:  # noqa: BLE001
        wlog.warning("qos release failed: %s", e, component="qos")


def async_front_roles() -> "set[str]":
    """The roles served by the asyncio front (SEAWEEDFS_TPU_ASYNC_FRONT):
    "1" or "true" selects the filer; a comma list names roles ("filer,
    s3"); empty or "0" keeps every role on the threaded server."""
    v = os.environ.get("SEAWEEDFS_TPU_ASYNC_FRONT", "").strip().lower()
    if v in ("", "0", "false"):
        return set()
    if v in ("1", "true"):
        return {"filer"}
    return {r.strip() for r in v.split(",") if r.strip()}


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

# a peer that opens a connection and sends nothing holds its handler
# thread this long at most
HANDSHAKE_TIMEOUT = 10.0


def _tls_config():
    from .. import security
    return security.current().tls


def _dial(url: str) -> "tuple[str, ssl.SSLContext | None]":
    """(full URL, client SSL context) of a `host:port/path` address:
    https with the cluster CA pinned when the TLS plane is on, plain
    http otherwise."""
    tls = _tls_config()
    if url.startswith("http"):
        return url, (tls.client_context() if tls is not None and
                     url.startswith("https") else None)
    if tls is not None:
        return "https://" + url, tls.client_context()
    return "http://" + url, None


def _new_connection(parsed, ctx: "ssl.SSLContext | None",
                    timeout: float) -> http.client.HTTPConnection:
    if parsed.scheme == "https":
        return http.client.HTTPSConnection(parsed.netloc, timeout=timeout,
                                           context=ctx)
    if parsed.scheme != "http":
        raise ValueError(f"{parsed.geturl()}: unsupported scheme")
    return http.client.HTTPConnection(parsed.netloc, timeout=timeout)


def _connect(url: str, timeout: float
             ) -> "tuple[http.client.HTTPConnection, str]":
    """A fresh connection to the url's host and the request target."""
    full, ctx = _dial(url)
    parsed = urllib.parse.urlsplit(full)
    target = parsed.path or "/"
    if parsed.query:
        target += "?" + parsed.query
    return _new_connection(parsed, ctx, timeout), target


def is_admin_path(path: str) -> bool:
    """The admin and maintenance plane: `/admin/*`, the master's grow,
    lock and raft routes, `/debug/*` and heartbeats (gRPC-only surfaces
    in the reference, gated there by its credentials)."""
    return path.startswith(("/admin/", "/cluster/raft/",
                            "/debug/")) or path in (
        "/vol/grow", "/cluster/lease_admin_token",
        "/cluster/release_admin_token", "/heartbeat")


def admin_guard(req: Request, sec=None):
    """The admin plane's gate (guard.go: the whitelist, then the admin
    JWT), for an owner's `guard`: 401 on an admin path that fails
    `sec` (the process's `security.current()` when None)."""
    if not is_admin_path(req.path):
        return None
    if sec is None:
        from .. import security
        sec = security.current()
    err = sec.check_admin(req.query, req.headers, req.remote_ip)
    return (401, {"error": err}) if err else None


def _auth_for(url: str, headers: "dict | None") -> dict:
    """The caller's headers plus the process's admin JWT on an admin
    path (the reference's gRPC dial applying the global security
    configuration), unless the caller set its own Authorization."""
    from .. import security
    sec = security.current()
    if not sec.admin_key:
        return headers or {}
    path = urllib.parse.urlsplit(
        url if url.startswith("http") else "http://" + url).path
    if not is_admin_path(path):
        return headers or {}
    headers = dict(headers or {})
    headers.setdefault("Authorization", f"Bearer {sec.admin_jwt()}")
    return headers


def _with_trace(headers: "dict | None", url: str = "") -> dict:
    """The caller's headers plus the admin JWT where the path needs it,
    the active request id and span, so the receiver's server span joins
    the caller's trace, and the remaining budget of the active deadline,
    so the receiver cannot out-wait the caller."""
    headers = dict(deadline.stamp_headers(_auth_for(url, headers)))
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
    """True when an idle pooled socket is readable, or a TLS socket
    holds decrypted bytes: the peer closed it or sent a close_notify (an
    idle keep-alive connection has nothing else to read).  Either way
    the socket is replaced before anything is sent on it."""
    try:
        if isinstance(sock, ssl.SSLSocket) and sock.pending():
            return True
        return bool(select.select([sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


def _one_pooled_request(method: str, full_url: str, body,
                        headers: dict, timeout: float,
                        ctx: "ssl.SSLContext | None" = None
                        ) -> "tuple[int, bytes, dict]":
    """One request over the thread's connection to the url's peer:
    (status, body, headers).  Under TLS each pooled socket is an
    SSLSocket made with `ctx`."""
    parsed = urllib.parse.urlsplit(full_url)
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
            faults.fire("httpd.pool.connect", key=parsed.netloc)
            stats.PROCESS.counter_add(
                "pool_connections_opened_total", 1.0,
                help_text="fresh sockets dialed by the pooled client",
                peer=parsed.netloc)
            conn = pool[key] = _new_connection(parsed, ctx, timeout)
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        try:
            faults.fire("httpd.pool.request",
                        key=f"{parsed.netloc}{target}")
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
    headers), under `retry.retry_call` (the peer's breaker, and for
    idempotent requests backoff and the retry budget).  Each attempt
    stamps the budget remaining then.  Transport failures raise
    OSError (BreakerOpen for a peer whose breaker is open)."""
    from ..util import retry
    full, ctx = _dial(url)
    idempotent = method in _IDEMPOTENT or \
        (headers or {}).get("X-Idempotent") == "1"

    def attempt():
        return _one_pooled_request(method, full, body,
                                   _with_trace(headers, url), timeout, ctx)

    return retry.retry_call(attempt, site="httpd.pool",
                            peer=urllib.parse.urlsplit(full).netloc,
                            idempotent=idempotent)


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
        conn.request("GET", target, headers=_with_trace(headers, url))
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
        for hk, hv in _with_trace(headers, url).items():
            conn.putheader(hk, hv)
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        if conn.sock is not None:
            # small size-line sends between multi-MB payload sends must
            # not wait behind delayed ACKs
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        fault_key = f"{conn.host}:{conn.port}{target}"
        it = iter(chunks)
        while True:
            # a producer error propagates from here, and the finally
            # tears the connection down mid-body
            chunk = next(it, None)
            try:
                if chunk is not None:
                    directive = faults.fire("httpd.stream.chunk",
                                            key=fault_key)
                    if directive == "truncate":
                        # end the stream early but cleanly: the commit
                        # handshake must catch the short body
                        chunk = None
                    elif directive == "drop":
                        conn.sock.close()
                        raise OSError(
                            f"stream to {url}: fault-injected drop")
                if chunk is None:
                    conn.send(b"0\r\n\r\n")
                    break
                if len(chunk):
                    conn.send(b"%X\r\n" % len(chunk))
                    conn.send(chunk)
                    conn.send(b"\r\n")
            except faults.FaultInjected:
                # an armed error stands in for the wire dying, not for
                # the receiver answering: no verdict probe (it would
                # wait on a receiver that still wants chunks)
                raise
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
        conn.request("GET", target, headers=_with_trace(headers, url))
        resp = conn.getresponse()
        if resp.status // 100 != 2:
            return resp.status, dict(resp.headers)
        expected = resp.length
        got = 0
        fault_key = f"{conn.host}:{conn.port}{target}"
        with open(tmp, "wb") as f:
            while True:
                if faults.fire("httpd.download.chunk",
                               key=fault_key) is not None:
                    # truncate and drop both mean the source died
                    # mid-body: never rename a short file into place
                    raise OSError(f"download {url}: fault-injected "
                                  f"mid-body failure")
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
    headers = _with_trace(headers, url)
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
        src.request("GET", target, headers=_with_trace(headers, src_url))
        resp = src.getresponse()
        if resp.status != 200:
            return resp.status, 0, b""
        expected = resp.length

        def chunks():
            sent = 0
            while True:
                directive = faults.fire("httpd.relay.chunk", key=dst_url)
                if directive is not None:
                    # the source died mid-body: raising keeps the rule
                    # that the destination never sees a clean short file
                    if directive == "drop":
                        resp.close()
                    raise OSError(f"relay {src_url}: fault-injected "
                                  f"{directive} at {sent} bytes")
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
