"""Rebuild inputs: where survivor shard slices come from
(`seaweedfs_tpu/storage/erasure_coding/shard_source.py`).

A ShardSource reads one survivor shard in fixed windows: a local file,
or a remote survivor through ONE ranged `/admin/ec/shard_read` stream
per shard (sendfile on the serving side), read straight into recycled
buffers, with failover across every server that holds the shard.  The
MultiSourceFetcher walks every survivor through the same window
schedule, one prefetching thread per remote source, and feeds the
rebuild's staged pipeline, so fetch, codec and writes overlap.

Memory is bounded by sources x (prefetch depth + 1) x slice bytes: 8 MiB
slices at depth 2 keep a 10-survivor rebuild under ~¼ GB of buffers.
"""

from __future__ import annotations

import os
import queue
import threading
import time

from ... import stats as _stats
from ... import tracing


def rebuild_slice_bytes() -> int:
    """Slice window per survivor stream (SEAWEEDFS_TPU_EC_REBUILD_
    SLICE_MB, default 8).  The window never changes output bytes;
    bigger windows amortise per-window overhead, smaller ones bound
    RAM."""
    try:
        mb = int(os.environ.get("SEAWEEDFS_TPU_EC_REBUILD_SLICE_MB", "8"))
    except ValueError:
        mb = 8
    return max(1, min(mb, 1024)) << 20


def rebuild_prefetch_depth() -> int:
    """Slices queued ahead per survivor stream (SEAWEEDFS_TPU_EC_
    REBUILD_PREFETCH, default 2), so the fetch of slice k+1 overlaps the
    codec on slice k."""
    try:
        d = int(os.environ.get("SEAWEEDFS_TPU_EC_REBUILD_PREFETCH", "2"))
    except ValueError:
        d = 2
    return max(1, d)


class ShardSource:
    """One survivor shard's byte range reader.  `prefetch` marks sources
    worth a fetch thread of their own (remote streams); local files are
    read inline by the pipeline's reader stage."""

    prefetch = False
    label = "?"

    def size(self) -> int:
        raise NotImplementedError

    def read_at(self, pos: int, n: int) -> bytes:
        """Bytes [pos, pos+n) of the shard; short only at EOF (the
        rebuild zero-pads short survivors, ec_encoder.go:258-262)."""
        raise NotImplementedError

    def read_into(self, pos: int, n: int, out) -> int:
        """read_at straight into a writable memoryview (the staging
        buffer row).  Returns bytes filled; short only at EOF."""
        data = self.read_at(pos, n)
        out[:len(data)] = data
        return len(data)

    def iter_slices(self, work: "list[tuple[int, int]]"):
        """Yield the shard's bytes window by window."""
        for pos, n in work:
            yield self.read_at(pos, n)

    def close(self) -> None:
        pass


class LocalShardSource(ShardSource):
    """A shard file on this node's disks."""

    label = "local"

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")

    def size(self) -> int:
        return os.path.getsize(self.path)

    def read_at(self, pos: int, n: int) -> bytes:
        self._f.seek(pos)
        return self._f.read(n)

    def read_into(self, pos: int, n: int, out) -> int:
        self._f.seek(pos)
        return self._f.readinto(out[:n])

    def close(self) -> None:
        self._f.close()


class RemoteShardSource(ShardSource):
    """A survivor mounted on other volume servers, read through ranged
    `/admin/ec/shard_read` (volume_server.proto:101 VolumeEcShardRead)
    with failover across every url that holds it."""

    prefetch = True

    def __init__(self, urls: "list[str]", vid: int, sid: int,
                 timeout: float = 60.0):
        if not urls:
            raise ValueError(f"shard {sid}: no source urls")
        self._urls = list(urls)
        self.vid = vid
        self.sid = sid
        self.label = self._urls[0]
        self._timeout = timeout
        self._size: int | None = None

    def size(self) -> int:
        """The shard size from the first url whose `/admin/ec/info`
        answers."""
        if self._size is None:
            from ...server.httpd import http_json
            last = "no urls"
            for url in self._urls:
                try:
                    r = http_json(
                        "GET", f"{url}/admin/ec/info?volumeId={self.vid}",
                        timeout=10)
                except OSError as e:
                    last = repr(e)
                    continue
                if "error" not in r:
                    self._size = int(r.get("shardSize", 0))
                    return self._size
                last = r["error"]
            raise OSError(
                f"shard {self.vid}.{self.sid}: size lookup failed on "
                f"{self._urls}: {last}")
        return self._size

    def _path(self, pos: int, n: int) -> str:
        return (f"/admin/ec/shard_read?volumeId={self.vid}"
                f"&shardId={self.sid}&offset={pos}&size={n}")

    def read_at(self, pos: int, n: int) -> bytes:
        from ...server.httpd import http_bytes
        last = "no urls"
        for url in self._urls:
            try:
                status, body, _ = http_bytes(
                    "GET", url + self._path(pos, n), timeout=self._timeout)
            except OSError as e:
                last = repr(e)
                self._count_failover(url)
                continue
            if status == 200 and len(body) <= n:
                self.label = url
                return body     # short only at EOF: the pipeline pads
            last = f"HTTP {status} ({len(body)} bytes)"
            self._count_failover(url)
        raise OSError(
            f"shard {self.vid}.{self.sid} slice @{pos}+{n}: every "
            f"source failed, last: {last}")

    # -- the sequential streaming plan ---------------------------------

    def _open_stream(self, url: str, pos: int, n: int):
        """One ranged GET covering [pos, pos+n), read incrementally: a
        whole rebuild costs one request per source.  Returns (conn,
        resp, promised), `promised` being the Content-Length the server
        committed to: fewer delivered bytes mean a dead donor, not a
        short shard."""
        from ...server.httpd import http_open_stream
        conn, resp = http_open_stream(url + self._path(pos, n),
                                      timeout=self._timeout)
        if resp.status != 200:
            conn.close()
            raise OSError(f"shard_read {url}: HTTP {resp.status}")
        promised = resp.length if resp.length is not None else n
        return conn, resp, promised

    def iter_slices_into(self, work: "list[tuple[int, int]]",
                         take_buf, record=None):
        """Window stream into recycled buffers: `take_buf(n)` hands back
        a writable buffer, each window is read into it straight off the
        socket, and (buffer, filled) pairs are yielded.  A source that
        dies mid-stream is resumed at the current window from the next
        url; windows already yielded stay valid.  `record(label, nbytes,
        seconds)` gets the wire time only (connect + readinto): waiting
        for a buffer is the consumer's backpressure, not donor
        latency."""
        if not work:
            return
        end = work[-1][0] + work[-1][1]
        i = 0
        conn = resp = None
        promised = 0    # bytes the current response committed to
        delivered = 0   # bytes consumed from the current response
        eof = False
        failures = 0
        budget = 2 * len(self._urls)
        buf = None      # held across retries of the SAME window: a
        # fresh pool buffer per retry would strand the old one and
        # starve take_buf into a deadlock
        try:
            while i < len(work):
                pos, n = work[i]
                if eof:
                    yield None, 0
                    i += 1
                    continue
                wire = 0.0
                if resp is None:
                    url = self._urls[failures % len(self._urls)]
                    t0 = time.perf_counter()
                    try:
                        conn, resp, promised = self._open_stream(
                            url, pos, end - pos)
                    except OSError:
                        failures += 1
                        self._count_failover(url)
                        if failures > budget:
                            raise
                        continue
                    wire += time.perf_counter() - t0
                    delivered = 0
                    self.label = url
                # what this response still owes for this window: fewer
                # bytes than `expect` is a dead donor to fail over from,
                # not a short shard (readinto reports a premature clean
                # close as plain EOF)
                expect = min(n, promised - delivered)
                if buf is None:
                    buf = take_buf(n)
                t0 = time.perf_counter()
                try:
                    got = self._read_exact_into(resp, buf, expect)
                    if got < expect:
                        raise OSError(
                            f"shard_read {self.label}: stream truncated "
                            f"at {delivered + got} of {promised} promised "
                            f"bytes")
                except OSError:
                    conn.close()
                    conn = resp = None
                    failures += 1
                    self._count_failover(self.label)
                    if failures > budget:
                        raise
                    continue
                wire += time.perf_counter() - t0
                delivered += got
                failures = 0    # the budget bounds consecutive failures
                if got < n:
                    eof = True  # a short shard: zero-pad from here on
                if record is not None:
                    record(self.label, got, wire)
                yield buf, got
                buf = None      # ownership passed to the consumer
                i += 1
        finally:
            if conn is not None:
                conn.close()

    @staticmethod
    def _count_failover(url: str) -> None:
        _stats.PROCESS.counter_add(
            "ec_read_source_failovers_total", 1.0,
            help_text="EC reads that abandoned a shard source "
                      "(transport failure, short body)",
            peer=url)

    @staticmethod
    def _read_exact_into(resp, buf, n: int) -> int:
        """Fill buf[:n] from the response; short only at EOF."""
        mv = memoryview(buf)
        filled = 0
        while filled < n:
            k = resp.readinto(mv[filled:n])
            if not k:
                break
            filled += k
        return filled


def _pct(sorted_vals: "list[float]", q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * (len(sorted_vals) - 1)))]


class RebuildStats:
    """Per-rebuild telemetry: bytes fetched per source, slice fetch
    latencies.  Thread-safe (prefetch threads record concurrently);
    summarised once at the end."""

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes_by_source: dict[str, int] = {}
        self.latencies: list[float] = []
        self.slices = 0

    def record(self, label: str, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.bytes_by_source[label] = \
                self.bytes_by_source.get(label, 0) + nbytes
            self.latencies.append(seconds)
            self.slices += 1

    def snapshot(self) -> "tuple[dict[str, int], list[float]]":
        with self._lock:
            return dict(self.bytes_by_source), list(self.latencies)

    def summary(self, volume_bytes: int, wall_seconds: float) -> dict:
        """JSON-able summary; `volume_bytes` is the data_shards x
        shard_size volume-equivalent.  The reference's keys, plus
        sliceP99Ms."""
        with self._lock:
            lats = sorted(self.latencies)
            by_source = dict(self.bytes_by_source)
        total = sum(by_source.values())
        wall = max(wall_seconds, 1e-9)
        return {
            "bytesFetchedBySource": by_source,
            "bytesFetchedTotal": total,
            "slices": self.slices,
            "sliceP50Ms": round(_pct(lats, 0.50) * 1e3, 3),
            "sliceP95Ms": round(_pct(lats, 0.95) * 1e3, 3),
            "sliceP99Ms": round(_pct(lats, 0.99) * 1e3, 3),
            "sliceMaxMs": round((lats[-1] if lats else 0.0) * 1e3, 3),
            "wallSeconds": round(wall, 3),
            "fetchGbps": round(total / wall / 1e9, 6),
            "volumeGbps": round(volume_bytes / wall / 1e9, 6),
        }


class _SourceAborted(Exception):
    """The fetcher was closed while a stage was parked on a queue."""


class MultiSourceFetcher:
    """One concurrent slice stream per prefetching source, every source
    on the same schedule (`work`: ordered (pos, n) windows).

    Prefetching sources get a thread filling a bounded queue `depth`
    slices ahead, into a pool of depth + 1 recycled buffers; inline
    sources are read on demand.  `get(item, rows)` must be called in
    schedule order.  A source failure is delivered in band: the worker
    parks the exception in its queue and the next `get` re-raises it,
    so the pipeline aborts instead of rebuilding garbage."""

    def __init__(self, sources: "dict[int, ShardSource]",
                 work: "list[tuple[int, int]]",
                 stats: "RebuildStats | None" = None):
        self.sources = sources
        self.work = work
        self.stats = stats
        self._stop = threading.Event()
        self._queues: dict[int, "queue.Queue"] = {}
        self._pools: dict[int, "queue.Queue"] = {}
        self._threads: list[threading.Thread] = []
        # the caller's span: each prefetch thread emits one stream span,
        # and contextvars do not follow threading.Thread
        self._trace_ctx = tracing.current_ids()
        depth = rebuild_prefetch_depth()
        for sid, src in sources.items():
            if src.prefetch:
                q: "queue.Queue" = queue.Queue(maxsize=depth)
                pool: "queue.Queue" = queue.Queue()
                for _ in range(depth + 1):  # lazy-allocated slots
                    pool.put(None)
                self._queues[sid] = q
                self._pools[sid] = pool
                t = threading.Thread(target=self._fetch_loop,
                                     args=(src, q, pool, sid),
                                     daemon=True)
                self._threads.append(t)
                t.start()

    def _put(self, q: "queue.Queue", item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _fetch_loop(self, src: ShardSource, q: "queue.Queue",
                    pool: "queue.Queue", sid: int) -> None:
        span_start = time.time()
        t0 = time.perf_counter()
        fetched = 0
        failed = False

        def take_buf(n: int):
            """A recycled receive buffer: the hot loop allocates nothing
            after warm-up."""
            while True:
                try:
                    b = pool.get(timeout=0.2)
                    break
                except queue.Empty:
                    if self._stop.is_set():
                        raise _SourceAborted() from None
            if b is None or len(b) < n:
                b = bytearray(n)
            return b

        try:
            if hasattr(src, "iter_slices_into"):
                # the source records its own wire-only latency
                record = self.stats.record if self.stats is not None \
                    else None
                for buf, got in src.iter_slices_into(self.work, take_buf,
                                                     record=record):
                    fetched += got
                    if not self._put(q, (buf, got)):
                        return
                return
            it = iter(src.iter_slices(self.work))
            while True:
                t_read = time.perf_counter()
                try:
                    buf = next(it)
                except StopIteration:
                    return
                fetched += len(buf)
                if self.stats is not None:
                    self.stats.record(src.label, len(buf),
                                      time.perf_counter() - t_read)
                if not self._put(q, (buf, len(buf))):
                    return
        except _SourceAborted:
            pass
        except BaseException as e:  # noqa: BLE001 — re-raised by get()
            failed = True
            self._put(q, e)
        finally:
            ctx = self._trace_ctx
            tracing.emit_span(
                f"rebuild.source.{sid}", span_start,
                time.perf_counter() - t0,
                role=ctx[2] if ctx else "",
                parent=ctx[1] if ctx else "",
                trace_id=ctx[0] if ctx else "",
                attrs={"shard": sid, "source": src.label,
                       "bytes": fetched},
                error=failed)

    def get(self, item: "tuple[int, int]", rows) -> "dict[int, int]":
        """Fill each source's staging row (`rows`: sid -> writable
        memoryview) for this window; returns {sid: bytes filled}.
        Inline sources read straight into their row; a queued window is
        copied out of its receive buffer, which goes back to its
        pool."""
        pos, n = item
        out: dict[int, int] = {}
        for sid, src in self.sources.items():
            row = rows[sid]
            q = self._queues.get(sid)
            if q is None:
                t0 = time.perf_counter()
                got = src.read_into(pos, n, row)
                if self.stats is not None:
                    self.stats.record(src.label, got,
                                      time.perf_counter() - t0)
                out[sid] = got
                continue
            while True:
                try:
                    v = q.get(timeout=0.2)
                    break
                except queue.Empty:
                    if self._stop.is_set():
                        raise _SourceAborted() from None
            if isinstance(v, BaseException):
                raise v
            buf, got = v
            if got:
                row[:got] = memoryview(buf)[:got]
            if isinstance(buf, bytearray):
                self._pools[sid].put(buf)
            out[sid] = got
        return out

    def close(self) -> None:
        self._stop.set()
        for q in self._queues.values():  # unblock parked producers
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for pool in self._pools.values():  # and buffer-starved ones
            pool.put(None)
        for t in self._threads:
            t.join(timeout=5)
        for src in self.sources.values():
            src.close()
