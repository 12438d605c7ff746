"""Encode outputs: where freshly encoded shard slices go
(`seaweedfs_tpu/storage/erasure_coding/shard_sink.py`).

A ShardSink is one shard's ordered byte stream.  The local sink writes a
`.ecNN` file on this node; the remote sink streams the shard to its
placement target as ONE long chunked `/admin/ec/shard_write` request on
a send thread of its own, behind a bounded in-flight queue of recycled
windows.  Shards placed elsewhere never touch the source's disks
(scatter-encode).

Commit protocol (no partial stripe is ever visible): the receiver
streams the shard into a `.scatter.<uploadId>` temp file with a running
CRC32 and registers it unmounted; only a `shard_write_commit` carrying
the sender's own byte count and CRC renames it to `.ecNN` (and may
mount it).  Any failure leaves an unregistered temp, which the receiver
removes.

Memory is bounded by sinks x (inflight + 1) x window bytes: 16 MiB
windows, 2 in flight, keep a 14-shard scatter under ~0.7 GB.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
import zlib

from ... import faults, qos, tracing


def scatter_window_bytes() -> int:
    """Send window per destination stream (SEAWEEDFS_TPU_EC_SCATTER_
    WINDOW_MB, default 16).  The window never changes output bytes;
    bigger windows amortise chunk framing, smaller ones bound RAM."""
    try:
        mb = int(os.environ.get("SEAWEEDFS_TPU_EC_SCATTER_WINDOW_MB",
                                "16"))
    except ValueError:
        mb = 16
    return max(1, min(mb, 1024)) << 20


def scatter_inflight_depth() -> int:
    """Windows queued ahead per destination stream (SEAWEEDFS_TPU_EC_
    SCATTER_INFLIGHT, default 2), so the send of window k overlaps the
    codec on k+1."""
    try:
        d = int(os.environ.get("SEAWEEDFS_TPU_EC_SCATTER_INFLIGHT", "2"))
    except ValueError:
        d = 2
    return max(1, d)


def _pct(sorted_vals: "list[float]", q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * (len(sorted_vals) - 1)))]


class ScatterStats:
    """Per-encode telemetry: bytes pushed per destination, window send
    latencies, local bytes.  Thread-safe (send threads record
    concurrently); summarised once at the end."""

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes_by_dest: dict[str, int] = {}
        self.local_bytes = 0
        self.latencies: list[float] = []
        self.windows = 0

    def record(self, dest: str, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.bytes_by_dest[dest] = \
                self.bytes_by_dest.get(dest, 0) + nbytes
            self.latencies.append(seconds)
            self.windows += 1

    def record_local(self, nbytes: int) -> None:
        with self._lock:
            self.local_bytes += nbytes

    def snapshot(self) -> "tuple[dict[str, int], list[float], int]":
        with self._lock:
            return (dict(self.bytes_by_dest), list(self.latencies),
                    self.local_bytes)

    def summary(self, volume_bytes: int, wall_seconds: float) -> dict:
        """JSON-able summary; `volume_bytes` is the .dat size.  The
        reference's keys, plus windowP99Ms."""
        with self._lock:
            lats = sorted(self.latencies)
            by_dest = dict(self.bytes_by_dest)
            local = self.local_bytes
        total = sum(by_dest.values())
        wall = max(wall_seconds, 1e-9)
        return {
            "bytesScatteredByDest": by_dest,
            "bytesScatteredTotal": total,
            "localWriteBytes": local,
            "windows": self.windows,
            "windowP50Ms": round(_pct(lats, 0.50) * 1e3, 3),
            "windowP95Ms": round(_pct(lats, 0.95) * 1e3, 3),
            "windowP99Ms": round(_pct(lats, 0.99) * 1e3, 3),
            "wallSeconds": round(wall, 3),
            "scatterGbps": round(total / wall / 1e9, 6),
            "volumeGbps": round(volume_bytes / wall / 1e9, 6),
        }


class ShardSink:
    """One shard's ordered byte stream.

    Lifecycle: write(window)* -> end_stream() -> finish() -> commit();
    abort() on any failure; close() is idempotent and aborts anything
    unfinished, so `with` / close-in-finally is always safe."""

    label = "?"

    def write(self, data) -> None:
        """Append one window (bytes/memoryview).  The buffer may be
        recycled by the caller as soon as write() returns."""
        raise NotImplementedError

    def end_stream(self) -> None:
        """Signal that no more windows are coming, without waiting for
        delivery: call it on every sink, then finish() each, so the
        streams drain concurrently."""

    def finish(self) -> None:
        """End the stream and verify delivery."""

    def commit(self, mount: bool = False) -> None:
        """Make the shard visible at its final name."""

    def abort(self) -> None:
        """Tear the stream down and discard anything staged."""

    def close(self) -> None:
        pass

    def __enter__(self) -> "ShardSink":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class LocalShardSink(ShardSink):
    """A shard file on this node's disks.  `temp=True` (scatter-encode)
    stages to a `.scatter.<id>` sibling renamed on commit, the remote
    sink's nothing-visible-until-commit contract; `temp=False` writes in
    place."""

    label = "local"

    def __init__(self, path: str, temp: bool = False,
                 stats: "ScatterStats | None" = None):
        self.path = path
        self._final = path
        if temp:
            self.path = f"{path}.scatter.{uuid.uuid4().hex}"
        self._stats = stats
        self.file = open(self.path, "wb")
        self.bytes = 0
        self._committed = False
        self._closed = False

    def write(self, data) -> None:
        self.file.write(data)
        n = len(data)
        self.bytes += n
        if self._stats is not None:
            self._stats.record_local(n)

    def finish(self) -> None:
        # flush only: durability comes from the encode pipeline's
        # _OverlappedFlusher, which fdatasyncs every local sink's file
        # on its final stop
        self.file.flush()

    def commit(self, mount: bool = False) -> None:
        self.file.close()
        self._closed = True
        if self.path != self._final:
            os.replace(self.path, self._final)
        self._committed = True

    def abort(self) -> None:
        if not self._closed:
            self.file.close()
            self._closed = True
        if not self._committed:
            try:
                os.remove(self.path)
            except OSError:
                pass

    def close(self) -> None:
        if self._closed:
            return
        if self._committed:
            self.file.close()
            self._closed = True
        else:
            self.abort()


class _SinkAborted(Exception):
    """The sink was aborted while a stage was parked on its queue."""


class RemoteShardSink(ShardSink):
    """One shard streamed to its placement target as a single chunked
    `POST /admin/ec/shard_write`.  A send thread pulls windows off a
    bounded queue (the pipeline's writer blocks when a destination falls
    `scatter_inflight_depth()` windows behind), with recycled send
    buffers.  The sender
    keeps a running CRC32; finish() checks that the receiver saw the
    same byte count and CRC.  The owner commits (the scatter handler's
    one batched commit per destination) and then calls
    mark_committed()."""

    def __init__(self, url: str, vid: int, sid: int,
                 collection: str = "", timeout: float = 600.0):
        self.url = url
        self.vid = vid
        self.sid = sid
        self.collection = collection
        self.label = url
        self.upload_id = uuid.uuid4().hex
        self._timeout = timeout
        self._window = scatter_window_bytes()
        depth = scatter_inflight_depth()
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._pool: "queue.Queue" = queue.Queue()
        for _ in range(depth + 1):
            self._pool.put(None)  # lazy-allocated slots
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._response: dict | None = None
        self._cur: "bytearray | None" = None  # coalescing buffer
        self._fill = 0
        self.bytes = 0
        self.crc = 0
        self._committed = False
        self._finished = False
        self._stats: "ScatterStats | None" = None
        self._truncated = False   # an armed truncate ended the stream
        # the caller's span: the send thread emits one stream span, and
        # contextvars do not follow threading.Thread
        self._trace_ctx = tracing.current_ids()
        self._t = threading.Thread(target=self._send_loop, daemon=True)
        self._t.start()

    def set_stats(self, stats: "ScatterStats | None") -> None:
        self._stats = stats

    # -- producer side (the pipeline's writer stage) --------------------

    def _take_slot(self):
        while True:
            try:
                return self._pool.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set() or self._error is not None:
                    raise self._error or _SinkAborted() from None

    def _put(self, item) -> None:
        while True:
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                if self._stop.is_set() or self._error is not None:
                    raise self._error or _SinkAborted() from None

    def write(self, data) -> None:
        """Coalesces writes up to the send window, so a queue hop, a
        chunk frame and a socket wakeup are paid per window, not per
        pipeline slice."""
        mv = memoryview(data)
        off = 0
        while off < len(mv):
            if self._error is not None:
                raise self._error
            if self._cur is None:
                b = self._take_slot()
                if b is None or len(b) != self._window:
                    b = bytearray(self._window)
                self._cur = b
                self._fill = 0
            take = min(len(mv) - off, self._window - self._fill)
            piece = mv[off:off + take]
            self._cur[self._fill:self._fill + take] = piece
            self.crc = zlib.crc32(piece, self.crc)
            self.bytes += take
            self._fill += take
            off += take
            if self._fill == self._window:
                self._put((self._cur, self._fill))
                self._cur = None

    def _flush_partial(self) -> None:
        if self._cur is not None and self._fill:
            self._put((self._cur, self._fill))
            self._cur = None
            self._fill = 0

    # -- send thread -----------------------------------------------------

    def _chunks(self):
        """The request body: windows off the queue until the None
        sentinel.  Wire time per window (the time the send took, not the
        wait for the codec) is recorded, so a slow codec never shows as
        a slow destination."""
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    raise _SinkAborted() from None
                continue
            if item is None:
                return
            buf, n = item
            # background priority: while the foreground p99 is over its
            # SLO each window waits the throttle's pace before it
            # touches the wire, and the bounded queue pushes back on
            # the staging writer behind it
            qos.ec_pace("encode")
            directive = faults.fire("ec.encode.window", key=self.url)
            if directive == "truncate":
                # end the shard early with clean framing: the receiver
                # banks a short stream, which the send loop reports as
                # this destination's failure (and the commit handshake
                # would refuse)
                self._truncated = True
                self._pool.put(buf)
                return
            if directive == "drop":
                # FaultInjected, so http_stream_request skips the
                # receiver-verdict probe and tears the connection down
                self._pool.put(buf)
                raise faults.FaultInjected(
                    f"shard_write {self.vid}.{self.sid} -> {self.url}: "
                    f"fault-injected drop")
            t0 = time.perf_counter()
            yield memoryview(buf)[:n]
            if self._stats is not None:
                self._stats.record(self.url, n, time.perf_counter() - t0)
            self._pool.put(buf)

    def _send_loop(self) -> None:
        from ...server.httpd import http_stream_request
        span_start = time.time()
        t0 = time.perf_counter()
        failed = False
        try:
            # this thread does not inherit the caller's contextvars:
            # forward its request id and span so the receiver's server
            # span joins the encode's trace
            ctx = self._trace_ctx
            headers = {tracing.REQUEST_ID_HEADER: ctx[0],
                       tracing.HEADER: f"{ctx[0]}-{ctx[1]}"} if ctx else {}
            status, body = http_stream_request(
                "POST",
                f"{self.url}/admin/ec/shard_write?volumeId={self.vid}"
                f"&shardId={self.sid}&collection={self.collection}"
                f"&uploadId={self.upload_id}",
                self._chunks(), headers=headers, timeout=self._timeout)
            try:
                self._response = json.loads(body or b"{}")
            except ValueError:
                self._response = {"error": body[:200].decode(
                    errors="replace")}
            if status != 200 or "error" in self._response:
                raise OSError(
                    f"shard_write {self.vid}.{self.sid} -> {self.url}: "
                    f"HTTP {status} {self._response.get('error', '')}")
            if self._truncated:
                # the armed truncation: this destination's failure now,
                # not a mismatch found at finish()
                raise OSError(
                    f"shard_write {self.vid}.{self.sid} -> {self.url}: "
                    f"stream truncated at "
                    f"{self._response.get('bytes')} bytes")
        except _SinkAborted:
            pass
        except BaseException as e:  # noqa: BLE001 — re-raised by the
            # producer (write/finish): the send thread never dies silently
            failed = True
            self._error = e
        finally:
            # unblock a producer parked on a full queue or empty pool
            self._stop.set()
            self._pool.put(None)
            ctx = self._trace_ctx
            tracing.emit_span(
                f"encode.scatter.{self.sid}", span_start,
                time.perf_counter() - t0,
                role=ctx[2] if ctx else "",
                parent=ctx[1] if ctx else "",
                trace_id=ctx[0] if ctx else "",
                attrs={"shard": self.sid, "dest": self.url,
                       "bytes": self.bytes},
                error=failed)

    # -- completion -------------------------------------------------------

    def end_stream(self) -> None:
        if not self._finished:
            self._flush_partial()
            self._put(None)
            self._finished = True

    def finish(self) -> None:
        self.end_stream()
        self._t.join(timeout=self._timeout)
        if self._t.is_alive():
            self._stop.set()
            raise OSError(
                f"shard_write {self.vid}.{self.sid} -> {self.url}: "
                f"send thread stuck past {self._timeout}s")
        if self._error is not None:
            raise self._error
        r = self._response or {}
        if int(r.get("bytes", -1)) != self.bytes or \
                int(r.get("crc32", -1)) != self.crc:
            raise OSError(
                f"shard_write {self.vid}.{self.sid} -> {self.url}: "
                f"receiver saw {r.get('bytes')} bytes crc "
                f"{r.get('crc32')}, sent {self.bytes} crc {self.crc}")

    def mark_committed(self) -> None:
        """The owner committed this shard out of band; close() must no
        longer abort it."""
        self._committed = True

    def abort(self) -> None:
        from ...server.httpd import http_json
        self._stop.set()
        # drain the queue so a parked producer cannot deadlock, then
        # join the (now aborting) send thread
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._pool.put(None)
        self._t.join(timeout=5)
        try:
            http_json("POST", f"{self.url}/admin/ec/shard_write_abort",
                      {"volumeId": self.vid,
                       "collection": self.collection,
                       "shardId": self.sid,
                       "uploadId": self.upload_id},
                      timeout=10)
        except OSError:
            pass  # the receiver also reaps stale temps on its own

    def close(self) -> None:
        if not self._committed:
            self.abort()
