"""The asyncio front of a role's HTTP listener (the port's copy of
`seaweedfs_tpu/server/async_front.py`).

The threaded server (httpd.py) spends a thread a connection; this front
multiplexes every connection of a role on one event loop.  The framing
(request line, headers, body, response write) runs on the loop; the
handlers, which are synchronous (sqlite, pooled-client hops), run on a
bounded pool (`SEAWEEDFS_TPU_ASYNC_WORKERS`, 16).  Everything observable
is the owner HttpServer's: its route tables and prefix routes, its
guard (`admin_guard`), the deadline plane, tracing and the request id,
`requests_in_flight`, `request_seconds` and `request_cpu_seconds`, the
flight recorder, the `(body, headers)` and `(body, content type)`
payload forms and any method (OPTIONS included), and under `[tls]` the
server context, and its QoS `admission` hook (`qos.install`), whose
release runs once the response was written.
`SEAWEEDFS_TPU_ASYNC_FRONT=filer` (or `1`) selects it for the filer
(`httpd.async_front_roles`); the threaded server stays the default.

Handler-facing requests duck-type httpd.Request: `.method`, `.path`,
`.query`, `.headers` (case-insensitive), `.body` (read on the loop
before dispatch, so a large chunked body lands in memory whole),
`.json()`, `.stream_body()`, `.drain()`, `.remote_ip` and a
`._handler.close_connection` flag a handler may set to close the
connection after its response.  A handler must never run on the loop.
"""

from __future__ import annotations

import asyncio
import contextvars
import http.client
import json
import os
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

from .. import profiling, tracing
from ..util import deadline, request_id
from .httpd import HANDSHAKE_TIMEOUT, _run_release, normalize_payload

_MAX_HEADER = 64 << 10


class _Headers:
    """A case-insensitive header map that keeps the original spellings
    (the part of email.Message the handlers use)."""

    __slots__ = ("_d",)

    def __init__(self):
        self._d: dict = {}

    def add(self, k: str, v: str) -> None:
        lk = k.lower()
        if lk in self._d:
            # a repeated header is comma-joined (RFC 9110 §5.2)
            self._d[lk] = (self._d[lk][0], self._d[lk][1] + ", " + v)
        else:
            self._d[lk] = (k, v)

    def get(self, k: str, default=None):
        t = self._d.get(k.lower())
        return t[1] if t is not None else default

    def __getitem__(self, k: str):
        t = self._d.get(k.lower())
        if t is None:
            raise KeyError(k)
        return t[1]

    def __contains__(self, k) -> bool:
        return isinstance(k, str) and k.lower() in self._d

    def __iter__(self):
        for orig, _v in self._d.values():
            yield orig

    def keys(self):
        return [orig for orig, _v in self._d.values()]

    def values(self):
        return [v for _o, v in self._d.values()]

    def items(self):
        return [(orig, v) for orig, v in self._d.values()]


class _HandlerShim:
    """`req._handler.close_connection`, which handlers set to close the
    connection after the response; the front honours it."""

    __slots__ = ("close_connection",)

    def __init__(self):
        self.close_connection = False


class AsyncRequest:
    """httpd.Request's surface over a request the loop read whole."""

    __slots__ = ("method", "path", "remote_ip", "headers", "_raw_query",
                 "_query", "_body", "_handler")

    def __init__(self, method: str, target: str, headers: _Headers,
                 body: bytes, remote_ip: str):
        path, _, query = target.partition("?")
        if path[:4] == "http" and "://" in path[:8]:
            rest = path.split("://", 1)[1]
            slash = rest.find("/")
            path = rest[slash:] if slash >= 0 else "/"
        self.method = method
        self.path = path
        self.remote_ip = remote_ip
        self.headers = headers
        self._raw_query = query
        self._query = None
        self._body = body
        self._handler = _HandlerShim()

    @property
    def query(self) -> dict:
        if self._query is None:
            self._query = {
                k: v[0] for k, v in urllib.parse.parse_qs(
                    self._raw_query, keep_blank_values=True).items()} \
                if self._raw_query else {}
        return self._query

    @property
    def body(self) -> bytes:
        return self._body

    def json(self) -> dict:
        return json.loads(self._body or b"{}")

    def stream_body(self, chunk_size: int = 4 << 20):
        # the loop has the body already: it comes as one chunk, as
        # httpd.Request.stream_body gives a body read before
        if self._body:
            yield self._body

    def drain(self, max_drain: int = 64 << 20) -> None:
        pass   # nothing unread: the loop consumed the framing


class AsyncFront:
    """One event loop and a bounded handler pool serving an HttpServer's
    routes."""

    def __init__(self, owner, ssl_context=None):
        self.owner = owner
        self.ssl_context = ssl_context
        self._loop: "asyncio.AbstractEventLoop | None" = None
        self._server = None
        self._thread: "threading.Thread | None" = None
        self._transports: set = set()
        try:
            workers = max(1, int(os.environ.get(
                "SEAWEEDFS_TPU_ASYNC_WORKERS", "") or 16))
        except ValueError:
            workers = 16
        self._pool = ThreadPoolExecutor(
            max_workers=workers,
            thread_name_prefix=f"async-{owner.role or 'front'}")
        self._ready = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self, sock) -> None:
        """Serve on the already-bound listening socket `sock`."""
        self._thread = threading.Thread(
            target=self._run, args=(sock,), daemon=True,
            name=f"async-front-{self.owner.role or 'front'}")
        self._thread.start()
        self._ready.wait(timeout=10)

    def _run(self, sock) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def _serve():
            sock.setblocking(False)
            kw = {}
            if self.ssl_context is not None:
                kw["ssl_handshake_timeout"] = HANDSHAKE_TIMEOUT
            self._server = await asyncio.start_server(
                self._handle_conn, sock=sock, ssl=self.ssl_context,
                limit=_MAX_HEADER, **kw)
            self._ready.set()

        loop.run_until_complete(_serve())
        try:
            loop.run_forever()
        finally:
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            except RuntimeError:
                pass
            loop.close()

    def stop(self) -> None:
        """Stop accepting, close every connection, end the loop."""
        loop = self._loop
        if loop is None:
            self._pool.shutdown(wait=False)
            return

        def _shutdown():
            if self._server is not None:
                self._server.close()
            for tr in list(self._transports):
                try:
                    tr.close()
                except (OSError, RuntimeError):
                    pass   # the transport is gone already
            loop.stop()

        try:
            loop.call_soon_threadsafe(_shutdown)
        except RuntimeError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=False)

    # -- connections -------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._transports.add(writer.transport)
        peer = writer.get_extra_info("peername") or ("", 0)
        remote_ip = peer[0] if isinstance(peer, tuple) else ""
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError):
                    return
                lines = head[:-4].decode("latin-1").split("\r\n")
                try:
                    method, target, _version = lines[0].split(" ", 2)
                except ValueError:
                    return
                headers = _Headers()
                for line in lines[1:]:
                    k, sep, v = line.partition(":")
                    if sep:
                        headers.add(k.strip(), v.strip())
                try:
                    body = await self._read_body(reader, headers)
                except (ValueError, asyncio.IncompleteReadError):
                    return
                req = AsyncRequest(method, target, headers, body,
                                   remote_ip)
                keep = await self._dispatch(req, writer)
                if not keep or req._handler.close_connection or \
                        (headers.get("Connection") or "").lower() == \
                        "close":
                    return
        except (ConnectionError, TimeoutError, OSError):
            pass
        finally:
            self._transports.discard(writer.transport)
            try:
                writer.close()
            except (OSError, RuntimeError):
                pass   # the transport is gone already

    async def _read_body(self, reader: asyncio.StreamReader,
                         headers: _Headers) -> bytes:
        te = (headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            out = bytearray()
            while True:
                line = await reader.readline()
                size = int(line.split(b";")[0], 16)   # ValueError: bad
                if size == 0:
                    while True:   # optional trailers to the blank line
                        t = await reader.readline()
                        if t in (b"\r\n", b"\n", b""):
                            break
                    break
                out += await reader.readexactly(size)
                await reader.readexactly(2)
            return bytes(out)
        length = int(headers.get("Content-Length") or 0)
        if length:
            return await reader.readexactly(length)
        return b""

    # -- dispatch ----------------------------------------------------------

    def _sync_process(self, req: AsyncRequest):
        """Everything between the framing and the response write, on a
        pool thread, in the threaded server's order: the request id, the
        deadline (504 for a spent budget before anything else), the
        server span, QoS admission, the guard, the route.  It runs inside the request's
        own context (`_dispatch`), so the deadline, request id, flight
        notes and stage track it binds are the request's alone; the
        flight-recorder material comes back with the answer."""
        outer = self.owner
        rid = request_id.ensure_request_id(
            req.headers.get(request_id.HEADER))
        dl = deadline.adopt(req.headers.get(deadline.HEADER),
                            site=outer.role or "server",
                            allow_default=not req.path.startswith(
                                ("/admin/", "/debug/")))
        flight_on = profiling.recorder_enabled()
        if flight_on:
            profiling.arm_flight_notes()
        cpu0 = time.thread_time() \
            if profiling.cpu_attr_front(dl is not None) else None
        _, parent = tracing.parse_traceparent(
            req.headers.get(tracing.HEADER, ""))
        sp = tracing.start_span(f"{req.method} {req.path}",
                                role=outer.role, parent=parent,
                                trace_id=rid)
        if dl is not None:
            sp.set("deadlineMs", int(dl.remaining() * 1e3))
        status, payload, verdict, release = outer._answer(req, dl, sp)
        # the CPU and the track's summary are taken whether or not the
        # recorder is armed (request_cpu_seconds does not depend on it,
        # and a summary left behind would go to a later request)
        cpu = (time.thread_time() - cpu0) if cpu0 is not None else None
        summary = profiling.take_last_summary()
        flight = None
        if flight_on:
            flight = (verdict, dl, summary, profiling.take_flight_notes())
        return status, payload, sp, rid, cpu, flight, release

    async def _dispatch(self, req: AsyncRequest,
                        writer: asyncio.StreamWriter) -> bool:
        """Answer one request; True to keep the connection."""
        outer = self.owner
        loop = asyncio.get_running_loop()
        outer._enter()
        sp = None
        status = 0
        stream_body = None
        cpu = None
        flight = None
        release = None
        # one context per request, for the handler and for every read of
        # a streamed body: a filer GET fetches its chunks inside `read`,
        # under the request's deadline and notes, not under those that
        # the pool thread's last request left behind
        ctx = contextvars.copy_context()
        try:
            status, payload, sp, rid, cpu, flight, release = \
                await loop.run_in_executor(self._pool, ctx.run,
                                           self._sync_process, req)
            body, ctype, extra = normalize_payload(payload)
            reason = http.client.responses.get(status, "")
            head = [f"HTTP/1.1 {status} {reason}",
                    f"Content-Type: {ctype}",
                    f"{tracing.REQUEST_ID_HEADER}: {rid}"]
            for hk, hv in extra.items():
                head.append(f"{hk}: {hv}")
            if hasattr(body, "read"):
                # a file-like body carries its Content-Length in `extra`
                # and is never chunked (the threaded server's rule)
                stream_body = body
                writer.write(("\r\n".join(head) + "\r\n\r\n")
                             .encode("latin-1"))
                if req.method != "HEAD":
                    while True:
                        chunk = await loop.run_in_executor(
                            self._pool, ctx.run, stream_body.read, 1 << 20)
                        if not chunk:
                            break
                        writer.write(chunk)
                        await writer.drain()
                await writer.drain()
                return True
            if "Content-Length" not in extra:
                head.append(f"Content-Length: {len(body)}")
            writer.write(("\r\n".join(head) + "\r\n\r\n")
                         .encode("latin-1"))
            if req.method != "HEAD":
                writer.write(body)
            await writer.drain()
            return True
        except (ConnectionError, TimeoutError, OSError):
            return False
        finally:
            if stream_body is not None:
                try:
                    stream_body.close()
                except OSError:
                    pass
            _run_release(release)
            if sp is not None:
                sp.set("status", status)
                sp.finish()
                # the wall covers the response write; the CPU is the
                # pool thread's handler share (the loop's framing is the
                # front's, not the request's)
                outer._leave(req.method, status, sp, cpu)
                if flight is not None:
                    verdict, dl, summary, notes = flight
                    outer._observe(req, status, sp, cpu, verdict, rid,
                                   dl, summary, notes)
            else:
                outer._leave_unanswered()
