"""The mount op table (weed/mount/weedfs.go + weedfs_*.go op files):
filesystem operations answered from the filer's HTTP API, with a TTL'd
metadata cache invalidated by the filer's metadata-event stream
(mount/meta_cache + SubscribeMetadata in the reference).

Pure Python and kernel-free: `fuse_ctypes.py` adapts this table to
libfuse; tests drive it directly.  The port's copy of
`seaweedfs_tpu/mount/weedfs.py`, over either package's filer.
"""

from __future__ import annotations

import errno
import json
import os
import stat as stat_mod
import threading
import time
import urllib.parse
from dataclasses import dataclass, field

from ..filer.entry import FileChunk
from ..filer.filechunks import total_size
from ..server.httpd import http_bytes, http_json


@dataclass
class _WriteState:
    """One path's open-for-write state: INTERVAL dirty pages (the
    analog of mount/dirty_pages_chunked.go), not a whole-file buffer.

    `pages` is a sorted, non-overlapping list of (start, bytearray)
    intervals; once the buffered total crosses FLUSH_THRESHOLD the
    pages stream to the filer as overlapping chunks (later-wins
    resolution, filer/filechunks.py) and are dropped — memory stays
    bounded for arbitrarily large sequential writes.  `size` is the
    authoritative visible length while open; `trunc_point` is the
    low-water mark of any shrinking truncate since the last flush
    (the server must clip there BEFORE new pages land, or stale
    middle content would reappear)."""
    pages: list = field(default_factory=list)
    size: int = 0
    refs: int = 0
    dirty: bool = False
    truncated: bool = False
    trunc_point: "int | None" = None
    # serializes the NETWORK phase of flushes for this path: a slow
    # snapshot posted after a later flush would win the server-side
    # mtime race and resurrect stale bytes
    flush_lock: threading.Lock = field(default_factory=threading.Lock)

    def buffered(self) -> int:
        return sum(len(b) for _, b in self.pages)

    def covers(self, offset: int, size: int) -> bool:
        """True when one buffered interval spans the whole range (the
        common write-then-read-back pattern — no server round trip
        needed)."""
        for start, buf in self.pages:
            if start <= offset and offset + size <= start + len(buf):
                return True
        return False

    def read_overlay(self, offset: int, size: int) -> bytes:
        out = bytearray(size)
        for start, buf in self.pages:
            lo = max(start, offset)
            hi = min(start + len(buf), offset + size)
            if lo < hi:
                out[lo - offset:hi - offset] = buf[lo - start:hi - start]
        return bytes(out)

    def insert_missing(self, offset: int, data: bytes) -> None:
        """Requeue-after-failed-flush variant of insert: existing
        pages WIN (they hold newer writes made during the failed
        flush) — only the uncovered subranges are reinserted."""
        pos = offset
        end = offset + len(data)
        for start, buf in sorted(self.pages, key=lambda p: p[0]):
            pend = start + len(buf)
            if pend <= pos or start >= end:
                continue
            if pos < start:
                self.insert(pos, data[pos - offset:start - offset])
            pos = max(pos, pend)
        if pos < end:
            self.insert(pos, data[pos - offset:end - offset])

    def insert(self, offset: int, data: bytes) -> None:
        """Merge [offset, offset+len) into the interval list."""
        new_start, new_end = offset, offset + len(data)
        merged = bytearray(data)
        keep = []
        for start, buf in self.pages:
            end = start + len(buf)
            if end < new_start or start > new_end:
                keep.append((start, buf))
                continue
            # overlap/adjacency: splice existing bytes around the new
            if start < new_start:
                merged[0:0] = buf[:new_start - start]
                new_start = start
            if end > new_end:
                merged.extend(buf[new_end - start:])
                new_end = end
        keep.append((new_start, merged))
        keep.sort(key=lambda p: p[0])
        self.pages = keep

    def clip(self, length: int) -> None:
        kept = []
        for start, buf in self.pages:
            if start >= length:
                continue
            if start + len(buf) > length:
                buf = buf[:length - start]
            kept.append((start, buf))
        self.pages = kept


class FuseError(OSError):
    def __init__(self, err: int):
        super().__init__(err, errno.errorcode.get(err, str(err)))
        self.errno = err


class WeedFS:
    """Full op table: lookup/getattr, readdir, open/read, readlink
    (weedfs_attr.go, weedfs_dir_read.go, weedfs_file_read.go) plus the
    write path — create/write/truncate/flush, mkdir/unlink/rmdir,
    rename (weedfs_file_write.go, weedfs_dir_mkrm.go).

    Writes collect as INTERVAL dirty pages per open path
    (mount/dirty_pages_chunked.go): once FLUSH_THRESHOLD bytes are
    buffered they stream to the filer as overlapping chunks via
    /__chunk__/ (later-wins resolution), so arbitrarily large
    sequential writes run in bounded memory; flush/release drains the
    rest and applies any pending truncation."""

    MAX_CACHE_ENTRIES = 16384  # the reference's meta_cache is bounded

    # chunk-cache block size: reads are served from cached 1MB blocks
    # (util/chunk_cache, the reference mount's TieredChunkCache role)
    CHUNK_BLOCK = 1 << 20

    def __init__(self, filer: str, attr_ttl: float = 1.0,
                 follow_events: bool = True,
                 chunk_cache_mb: int = 64,
                 chunk_cache_dir: "str | None" = None,
                 chunk_cache_disk_mb: int = 1024):
        self.filer = filer
        self.attr_ttl = attr_ttl
        self._cache: dict[str, tuple[float, dict | None]] = {}
        self._writes: dict[str, _WriteState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._since_ns = time.time_ns()
        from ..util.chunk_cache import TieredChunkCache
        # without the event stream nothing would ever invalidate
        # cached data blocks — reads must stay always-fresh then
        self.chunk_cache = TieredChunkCache(
            mem_limit=chunk_cache_mb << 20,
            disk_dir=chunk_cache_dir,
            disk_limit=chunk_cache_disk_mb << 20) \
            if chunk_cache_mb > 0 and follow_events else None
        # collection quota (mount.proto Configure; weedfs_quota.go):
        # 0 = unlimited; above it, writes fail ENOSPC based on the
        # filer's cluster statistics, refreshed at most every 5s
        self.collection_capacity = 0
        self._quota_used = 0
        self._quota_checked = 0.0
        self._event_thread: threading.Thread | None = None
        if follow_events:
            self._event_thread = threading.Thread(
                target=self._follow_events, daemon=True)
            self._event_thread.start()

    def close(self) -> None:
        self._stop.set()

    # -- metadata cache (mount/meta_cache) --------------------------------

    def _lookup(self, path: str) -> dict | None:
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(path)
            if hit is not None and now - hit[0] <= self.attr_ttl:
                return hit[1]
        if path == "/":
            entry: dict | None = {"fullPath": "/",
                                  "isDirectory": True,
                                  "attributes": {"mode": 0o755}}
        else:
            st, body, _ = http_bytes(
                "GET", f"{self.filer}/__meta__/lookup?path=" +
                urllib.parse.quote(path))
            if st == 404:
                entry = None
            elif st != 200:
                raise FuseError(errno.EIO)
            else:
                entry = json.loads(body)
        with self._lock:
            if len(self._cache) >= self.MAX_CACHE_ENTRIES:
                # evict expired first; a crawler stat-ing millions of
                # distinct (incl. nonexistent) paths must not grow the
                # mount's memory without bound
                fresh = {p: v for p, v in self._cache.items()
                         if now - v[0] <= self.attr_ttl}
                if len(fresh) >= self.MAX_CACHE_ENTRIES:
                    fresh = dict(sorted(
                        fresh.items(), key=lambda kv: -kv[1][0]
                    )[:self.MAX_CACHE_ENTRIES // 2])
                self._cache = fresh
            self._cache[path] = (now, entry)
        return entry

    def _invalidate(self, path: str) -> None:
        with self._lock:
            self._cache.pop(path, None)
            parent = path.rsplit("/", 1)[0] or "/"
            self._cache.pop(parent, None)
        if self.chunk_cache is not None:
            # a changed file drops all of its cached data blocks —
            # the meta-event subscription (_follow_events) is the only
            # thing standing between the data-block cache and stale
            # reads, so every event path lands here.  (Blocks cached
            # by a PREVIOUS mount process are handled at the cache
            # layer: DiskChunkCache never serves adopted leftovers,
            # because the events that covered them died with the old
            # process.)
            self.chunk_cache.invalidate_path(path)

    def _follow_events(self) -> None:
        """Poll the filer's persistent metadata stream and invalidate
        touched paths (the reference's mount cache invalidation via
        SubscribeMetadata)."""
        while not self._stop.wait(self.attr_ttl / 2):
            try:
                r = http_json(
                    "GET", f"{self.filer}/__meta__/events"
                           f"?sinceNs={self._since_ns}&limit=1000")
            except OSError:
                continue
            for ev in r.get("events", []):
                for side in ("newEntry", "oldEntry"):
                    e = ev.get(side)
                    if e:
                        self._invalidate(e["fullPath"])
                self._since_ns = max(self._since_ns,
                                     int(ev.get("tsNs", 0)))

    # -- ops (weedfs_attr.go GetAttr) -------------------------------------

    @staticmethod
    def _entry_stat(entry: dict) -> dict:
        attrs = entry.get("attributes") or {}
        if entry.get("isDirectory"):
            mode = stat_mod.S_IFDIR | (attrs.get("mode", 0o755) & 0o7777)
            size = 4096
            nlink = 2
        elif attrs.get("symlinkTarget"):
            mode = stat_mod.S_IFLNK | 0o777
            size = len(attrs["symlinkTarget"])
            nlink = 1
        else:
            mode = stat_mod.S_IFREG | (attrs.get("mode", 0o644) & 0o7777)
            # max-extent size, the SAME definition the filer serves
            # bytes by — a summed size diverges on overlapping chunks
            # and makes the kernel clamp reads short
            size = total_size([FileChunk.from_json(c)
                               for c in entry.get("chunks", [])])
            nlink = 1
        return {"st_mode": mode, "st_size": size, "st_nlink": nlink,
                "st_uid": attrs.get("uid", 0),
                "st_gid": attrs.get("gid", 0),
                "st_mtime": float(attrs.get("mtime", 0) or 0),
                "st_ctime": float(attrs.get("crtime", 0) or 0),
                "st_atime": float(attrs.get("mtime", 0) or 0)}

    def getattr(self, path: str) -> dict:
        with self._lock:
            ws = self._writes.get(path)
            open_size = ws.size if ws is not None else None
        entry = self._lookup(path)
        if entry is None:
            raise FuseError(errno.ENOENT)
        st = self._entry_stat(entry)
        if open_size is not None:
            # overlay ONLY the size from the open write state (the
            # kernel stats after each write); mode/uid/gid/timestamps
            # stay the filer entry's truth
            st["st_size"] = open_size
        return st

    def readdir(self, path: str) -> "list[str]":
        entry = self._lookup(path)
        if entry is None:
            raise FuseError(errno.ENOENT)
        if not entry.get("isDirectory"):
            raise FuseError(errno.ENOTDIR)
        names = [".", ".."]
        last = ""
        while True:
            st, body, _ = http_bytes(
                "GET", self.filer +
                urllib.parse.quote(path.rstrip("/") + "/") +
                "?limit=1000&lastFileName=" +
                urllib.parse.quote(last))
            if st != 200:
                raise FuseError(errno.EIO)
            batch = json.loads(body).get("entries", [])
            names += [e["fullPath"].rsplit("/", 1)[-1] for e in batch]
            if len(batch) < 1000:
                return names
            last = batch[-1]["fullPath"].rsplit("/", 1)[-1]

    def open(self, path: str, flags: int = 0) -> int:
        entry = self._lookup(path)
        if entry is None:
            raise FuseError(errno.ENOENT)
        if entry.get("isDirectory"):
            raise FuseError(errno.EISDIR)
        if flags & (os.O_WRONLY | os.O_RDWR):
            # no whole-file seed read: non-TRUNC writes become
            # interval pages overlaid on the server content
            base_size = total_size([
                FileChunk.from_json(c)
                for c in entry.get("chunks", [])])
            with self._lock:
                ws = self._writes.setdefault(path, _WriteState())
                ws.refs += 1
                if ws.refs == 1:
                    ws.size = base_size
                if flags & os.O_TRUNC:
                    ws.pages = []
                    ws.size = 0
                    ws.truncated = ws.dirty = True
                    ws.trunc_point = 0
        return 0

    def read(self, path: str, size: int, offset: int) -> bytes:
        """Ranged read through the filer (weedfs_file_read.go —
        chunk-view resolution happens filer-side), with any open
        write-state's dirty pages overlaid on top (the kernel may
        read back what it just wrote before anything flushed)."""
        if size <= 0:
            return b""
        with self._lock:
            ws = self._writes.get(path)
            if ws is not None:
                size = max(0, min(size, ws.size - offset))
                if size and ws.covers(offset, size):
                    # fully in the dirty pages: no server round trip
                    return ws.read_overlay(offset, size)
                pages = [(s, bytes(b)) for s, b in ws.pages]
                trunc = ws.trunc_point
            else:
                pages = None
        if pages is not None and size == 0:
            return b""
        base = self._ranged_get_cached(path, offset, size)
        if pages is None:
            return base
        out = bytearray(size)            # gaps read as zeros
        out[:len(base)] = base[:size]
        if trunc is not None and trunc < offset + size:
            # a pending shrink: stale server bytes beyond the
            # truncation point must not show through the gaps
            lo = max(0, trunc - offset)
            out[lo:] = b"\x00" * (size - lo)
        for start, buf in pages:
            lo = max(start, offset)
            hi = min(start + len(buf), offset + size)
            if lo < hi:
                out[lo - offset:hi - offset] = \
                    buf[lo - start:hi - start]
        return bytes(out)

    def _ranged_get_cached(self, path: str, offset: int,
                           size: int) -> bytes:
        """Assemble a read from cached 1MB blocks (util/chunk_cache):
        repeated/sequential reads of a hot file hit memory (or the
        disk tier) instead of re-crossing to the filer.  Blocks drop
        when the file changes (the meta-event stream invalidates the
        path's group, same staleness window as the attr cache)."""
        if self.chunk_cache is None:
            return self._ranged_get(path, offset, size)
        B = self.CHUNK_BLOCK
        out = bytearray()
        pos, end = offset, offset + size
        while pos < end:
            bi = pos // B
            key = f"{path}@{bi}"
            block = self.chunk_cache.get(key)
            if block is None:
                block = self._ranged_get(path, bi * B, B)
                if block:
                    self.chunk_cache.set(key, block, group=path)
            lo = pos - bi * B
            want = min(end, (bi + 1) * B) - pos
            piece = block[lo:lo + want]
            out += piece
            if len(piece) < want:
                break  # EOF inside this block
            pos += want
        return bytes(out)

    def _ranged_get(self, path: str, offset: int, size: int) -> bytes:
        st, body, _ = http_bytes(
            "GET", self.filer + urllib.parse.quote(path), None,
            {"Range": f"bytes={offset}-{offset + size - 1}"})
        if st in (200, 206):
            return body if st == 206 else body[offset:offset + size]
        if st == 416:
            return b""                   # beyond EOF: overlay decides
        if st == 404:
            raise FuseError(errno.ENOENT)
        raise FuseError(errno.EIO)

    def readlink(self, path: str) -> str:
        entry = self._lookup(path)
        if entry is None:
            raise FuseError(errno.ENOENT)
        target = (entry.get("attributes") or {}).get("symlinkTarget")
        if not target:
            raise FuseError(errno.EINVAL)
        return target

    # -- write path (weedfs_file_write.go, simplified dirty buffer) -------

    QUOTA_REFRESH_SEC = 5.0

    def _check_quota(self) -> None:
        """ENOSPC once the cluster's used bytes exceed the configured
        collection capacity (weedfs_attr.go:45 IsOverQuota checks on
        every write-side op; usage refreshes like weedfs_quota.go)."""
        if self.collection_capacity <= 0:
            return
        now = time.monotonic()
        if now - self._quota_checked > self.QUOTA_REFRESH_SEC:
            self._quota_checked = now
            try:
                st, body, _ = http_bytes(
                    "GET", f"{self.filer}/__meta__/statistics")
                if st == 200:
                    self._quota_used = \
                        json.loads(body).get("usedSize", 0)
            except OSError:
                pass    # keep the last known usage
        if self._quota_used > self.collection_capacity:
            raise FuseError(errno.ENOSPC)

    def create(self, path: str, mode: int = 0o644) -> int:
        self._check_quota()
        # materialize the (empty) entry at the filer IMMEDIATELY: the
        # write-fsync-rename save pattern and cross-client readdir must
        # see the file while it is still open
        self._put(path, b"")
        if mode:
            self.chmod(path, mode)
        with self._lock:
            ws = self._writes.setdefault(path, _WriteState())
            ws.refs += 1
            if ws.refs == 1:
                ws.pages = []
                ws.size = 0
                ws.dirty = False
        return 0

    def chmod(self, path: str, mode: int) -> None:
        """Persist the mode via the filer's UpdateEntry analog — a
        silent-no-op chmod would claim success while exec bits never
        stick."""
        entry = self._lookup(path)
        if entry is None:
            raise FuseError(errno.ENOENT)
        attrs = dict(entry.get("attributes") or {})
        attrs["mode"] = mode & 0o7777
        self._set_attrs(path, attrs)

    def _set_attrs(self, path: str, attrs: dict) -> None:
        st, _, _ = http_bytes(
            "POST", f"{self.filer}/__meta__/set_attrs",
            json.dumps({"path": path, "attributes": attrs}).encode(),
            {"Content-Type": "application/json"})
        if st != 200:
            raise FuseError(errno.EIO)
        self._invalidate(path)

    # pages stream to the filer once this much is buffered — the
    # bound that makes huge sequential writes O(threshold) memory
    FLUSH_THRESHOLD = 8 * 1024 * 1024

    def write(self, path: str, data: bytes, offset: int) -> int:
        self._check_quota()
        with self._lock:
            ws = self._writes.get(path)
            if ws is None:
                raise FuseError(errno.EBADF)
            ws.insert(offset, data)
            ws.size = max(ws.size, offset + len(data))
            ws.dirty = True
            over = ws.buffered() >= self.FLUSH_THRESHOLD
        if over:
            self._flush_pages(path)
        return len(data)

    def truncate(self, path: str, length: int) -> None:
        with self._lock:
            ws = self._writes.get(path)
            if ws is not None:
                if length < ws.size:
                    ws.clip(length)
                    ws.trunc_point = length if ws.trunc_point is None \
                        else min(ws.trunc_point, length)
                ws.size = length
                ws.truncated = ws.dirty = True
                return
        # truncate without an open handle: server-side clip/extend,
        # no whole-file round trip.  Truncate-to-size is idempotent,
        # so a stale pooled connection may transparently retry
        st, _, _ = http_bytes(
            "POST", f"{self.filer}/__chunk__/" +
            urllib.parse.quote(path).lstrip("/") +
            f"?truncateTo={length}", b"", {"X-Idempotent": "1"})
        if st == 404:
            raise FuseError(errno.ENOENT)
        if st != 200:
            raise FuseError(errno.EIO)
        self._invalidate(path)

    def _chunk_post(self, path: str, offset: int, data: bytes,
                    truncate_to: "int | None" = None) -> None:
        q = f"?offset={offset}"
        if truncate_to is not None:
            q += f"&truncateTo={truncate_to}"
        st, _, _ = http_bytes(
            "POST", f"{self.filer}/__chunk__/" +
            urllib.parse.quote(path).lstrip("/") + q, data)
        if st != 200:
            raise FuseError(errno.EIO)

    def _flush_pages(self, path: str,
                     finalize: bool = False) -> None:
        """Stream buffered intervals to the filer as overlapping
        chunks (the dirty_pages_chunked.go writeback): shrink-clip
        first (stale middle content must not resurface), then the
        pages oldest-offset-first, then — on finalize — grow the
        visible size for pure zero-extensions."""
        with self._lock:
            ws = self._writes.get(path)
        if ws is None:
            return
        # serialize flushes per path: snapshot AND post under the
        # flush lock, so an earlier snapshot can never land after (and
        # thus server-mtime-beat) a later one
        with ws.flush_lock:
            with self._lock:
                pages, ws.pages = ws.pages, []
                trunc, ws.trunc_point = ws.trunc_point, None
                truncated = ws.truncated
                size = ws.size
                if finalize:
                    ws.truncated = False
            try:
                if trunc is not None:
                    self._chunk_post(path, 0, b"", truncate_to=trunc)
                for start, buf in pages:
                    self._chunk_post(path, start, bytes(buf))
                if finalize and truncated:
                    self._chunk_post(path, 0, b"", truncate_to=size)
            except FuseError:
                with self._lock:
                    ws2 = self._writes.get(path)
                    if ws2 is not None:
                        # re-queue for the next attempt; pages written
                        # meanwhile are NEWER and must win
                        for start, buf in pages:
                            ws2.insert_missing(start, bytes(buf))
                        if trunc is not None:
                            ws2.trunc_point = trunc if \
                                ws2.trunc_point is None else \
                                min(ws2.trunc_point, trunc)
                        ws2.truncated = ws2.truncated or truncated
                        ws2.dirty = True
                raise
        self._invalidate(path)

    def flush(self, path: str) -> None:
        """Flush dirty pages iff dirty (the kernel flushes on every
        close() of every dup'd fd — clean flushes must not re-upload
        anything)."""
        with self._lock:
            ws = self._writes.get(path)
            if ws is None or not ws.dirty:
                return
            ws.dirty = False
        self._flush_pages(path, finalize=True)

    def release(self, path: str, writable: bool = True) -> None:
        """`writable` mirrors the closing HANDLE's open mode (from
        fuse_file_info.flags): a read-only close must not decrement the
        write-state refcount — it would destroy a still-open writer's
        buffer."""
        if not writable:
            return
        self.flush(path)
        with self._lock:
            ws = self._writes.get(path)
            if ws is not None:
                ws.refs -= 1
                if ws.refs <= 0:
                    # last writable handle gone: drop the buffer
                    self._writes.pop(path, None)
        self._invalidate(path)

    def _drop_write_state(self, path: str) -> None:
        """After unlink/rename: a stale buffer keyed by the old path
        would resurrect the file on the next flush."""
        with self._lock:
            self._writes.pop(path, None)

    def _put(self, path: str, data: bytes) -> None:
        st, body, _ = http_bytes(
            "PUT", self.filer + urllib.parse.quote(path), data)
        if st not in (200, 201):
            raise FuseError(errno.EIO)
        self._invalidate(path)

    def mkdir(self, path: str, mode: int = 0o755) -> None:
        if self._lookup(path) is not None:
            raise FuseError(errno.EEXIST)
        st, _, _ = http_bytes(
            "PUT", self.filer +
            urllib.parse.quote(path.rstrip("/") + "/"))
        if st not in (200, 201):
            raise FuseError(errno.EIO)
        self._invalidate(path)

    def unlink(self, path: str) -> None:
        entry = self._lookup(path)
        if entry is None:
            raise FuseError(errno.ENOENT)
        if entry.get("isDirectory"):
            raise FuseError(errno.EISDIR)
        st, _, _ = http_bytes(
            "DELETE", self.filer + urllib.parse.quote(path))
        if st not in (200, 204):
            raise FuseError(errno.EIO)
        self._drop_write_state(path)
        self._invalidate(path)

    def rmdir(self, path: str) -> None:
        entry = self._lookup(path)
        if entry is None:
            raise FuseError(errno.ENOENT)
        if not entry.get("isDirectory"):
            raise FuseError(errno.ENOTDIR)
        # NON-recursive delete: the filer's own atomic 409 answers
        # non-empty — a pre-check + recursive=true would let a racing
        # create be silently destroyed
        st, _, _ = http_bytes(
            "DELETE", self.filer + urllib.parse.quote(path))
        if st == 409:
            raise FuseError(errno.ENOTEMPTY)
        if st not in (200, 204):
            raise FuseError(errno.EIO)
        self._invalidate(path)

    def rename(self, old: str, new: str) -> None:
        st, _, _ = http_bytes(
            "POST", f"{self.filer}/__meta__/rename",
            json.dumps({"oldPath": old, "newPath": new}).encode(),
            {"Content-Type": "application/json"})
        if st == 404:
            raise FuseError(errno.ENOENT)
        if st != 200:
            raise FuseError(errno.EIO)
        with self._lock:
            # open write buffers follow the file (or the renamed
            # DIRECTORY'S descendants) to their new names; left behind
            # they would resurrect the old paths on flush
            prefix = old.rstrip("/") + "/"
            for p in list(self._writes):
                if p == old:
                    self._writes[new] = self._writes.pop(p)
                elif p.startswith(prefix):
                    self._writes[new.rstrip("/") + "/" +
                                 p[len(prefix):]] = \
                        self._writes.pop(p)
        self._invalidate(old)
        self._invalidate(new)

    def statfs(self, path: str) -> dict:
        return {"f_bsize": 4096, "f_frsize": 4096,
                "f_blocks": 1 << 30, "f_bfree": 1 << 29,
                "f_bavail": 1 << 29, "f_files": 1 << 20,
                "f_ffree": 1 << 19, "f_namemax": 255}
