"""The Filer: namespace operations over a FilerStore and chunked content
on the volume cluster (weed/filer/filer.go), the port's copy of
`seaweedfs_tpu/filer/filer.py`.

Over a sqlite file or an lsm directory with a metalog dir the meta
plane runs by default (`meta_plane.MetaPlane`): a mutation is acked once
its event clears the metalog barrier, the store is applied behind it,
and reads merge the unapplied overlay over the store (`_store_find`,
`_store_list`).  With `SEAWEEDFS_TPU_FILER_META_PLANE=0`, and over a
store the plane cannot checkpoint, every mutation commits synchronously:
the store first (group-committed, `abstract_sql.AbstractSqlStore`), then
the metadata log (`meta_log.MetaLog`, group-committed too).  Either way
listeners see the event, and the caller gets its answer, only after the
log holds it.  Subscribers resume from their last-seen tsNs and never
silently skip events.

Reads go through the metadata cache (`meta_cache.FilerMetaCache`) and
the chunk-body cache (`util/chunk_cache.TieredChunkCache`); a chunk on
an EC volume is read through the volume servers' EC read path, degraded
reads included, on the host: no filer read launches the GF(2^8) kernel.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Callable

from .. import operation, profiling, stats
from ..util import deadline
from ..util.limiter import bounded_parallel
from .entry import Attributes, Entry, FileChunk, normalize_path
from .filechunks import total_size, view_from_chunks
from .filer_store import FilerStore, MemoryStore
from .meta_log import MetaLog
from ..util import wlog

CHUNK_SIZE = 4 * 1024 * 1024  # filer auto-chunk default (8MB in ref CLI)


class _ViewStream:
    """Lazy file-like over a chunk-view list (Filer.open_read_stream):
    each `read` drains an internal buffer refilled one view at a time;
    gaps between views and short volume reads are zero-filled, so the
    stream always yields exactly `size` bytes (the buffered read_file
    contract, without the whole-body bytearray).  `on_close` runs once,
    when the server is done with the response, also after a client
    hung up mid-body."""

    def __init__(self, filer: "Filer", views, offset: int, size: int,
                 on_close=None):
        self._filer = filer
        self._views = list(views)
        self._vi = 0
        self._pos = offset            # logical file position
        self._end = offset + size
        self._buf = memoryview(b"")
        self._on_close = on_close

    def _refill(self) -> bool:
        """Load the next segment (zero gap or one view's bytes) into
        the buffer.  False at end of range."""
        if self._pos >= self._end:
            return False
        if self._vi < len(self._views):
            v = self._views[self._vi]
            if self._pos < v.logical_offset:
                # gap before the next view: bounded zero block
                n = min(v.logical_offset - self._pos,
                        self._end - self._pos, 1 << 20)
                self._buf = memoryview(bytes(n))
                self._pos += n
                return True
            piece = self._filer._read_view(v)
            if len(piece) < v.size:
                # short volume read: pad to the view's extent so later
                # views stay aligned (read_file leaves zeros the same
                # way)
                piece = piece + bytes(v.size - len(piece))
            self._buf = memoryview(piece)
            self._pos += len(piece)
            self._vi += 1
            return True
        # trailing gap (sparse tail): zeros to the end of the range
        n = min(self._end - self._pos, 1 << 20)
        self._buf = memoryview(bytes(n))
        self._pos += n
        return True

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            parts = []
            while self._buf or self._refill():
                parts.append(bytes(self._buf))
                self._buf = memoryview(b"")
            return b"".join(parts)
        if not self._buf and not self._refill():
            return b""
        if n >= len(self._buf):
            out, self._buf = bytes(self._buf), memoryview(b"")
            return out
        out = bytes(self._buf[:n])
        self._buf = self._buf[n:]
        return out

    def close(self) -> None:
        self._views = []
        self._buf = memoryview(b"")
        cb, self._on_close = self._on_close, None
        if cb is not None:
            cb()


class Filer:
    def __init__(self, master: str, store: FilerStore | None = None,
                 collection: str = "", replication: str = "",
                 meta_log_dir: str | None = None,
                 meta_cache: "bool | None" = None,
                 chunk_cache_dir: "str | None" = None,
                 meta_plane: "bool | None" = None):
        self.master = master
        self.store = store or MemoryStore()
        self.collection = collection
        self.replication = replication
        self._log_lock = threading.Lock()
        # persisted when meta_log_dir is set (filer_notify_append.go);
        # memory-tail-only otherwise (tests, ephemeral filers)
        self.meta_log = MetaLog(meta_log_dir)
        self._listeners: list[Callable[[dict], None]] = []
        # meta plane (meta_plane.py): the metalog is this filer's WAL.
        # Auto-on for a store it can checkpoint (a sqlite file, an lsm
        # directory) with a metalog dir; SEAWEEDFS_TPU_FILER_META_PLANE=0
        # restores the synchronous commit, whose boot replays any
        # unapplied tail a planed run left behind.  Asked for by "1"
        # over a store it cannot run on, the filer refuses rather than
        # commit synchronously under the plane's name.  `meta_plane=False`
        # keeps it off whatever the environment says (the filer server
        # passes it for a remote store, which the plane never runs on,
        # as the JAX filer does).
        from .meta_plane import MetaPlane, meta_plane_enabled, recover_sync
        supported = bool(self.meta_log.dir) and \
            getattr(self.store, "supports_meta_plane", False)
        asked = False if meta_plane is False else meta_plane_enabled()
        if asked and not supported:
            self.meta_log.close()
            raise ValueError(
                "the filer meta plane needs a local store (a sqlite file "
                "or an lsm directory) and a metalog dir; set "
                "SEAWEEDFS_TPU_FILER_META_PLANE=0 for the synchronous "
                "store commit")
        self.meta_plane = MetaPlane(self.store, self.meta_log) \
            if (asked is not False and supported) else None
        if self.meta_plane is None and supported:
            recover_sync(self.meta_log, self.store)
        # metadata cache (meta_cache.py): find/list served from memory,
        # invalidated by this filer's own events synchronously, and by
        # sibling filers' metalog watermark (the plane's follower, with
        # the plane on).  Left unspecified (None),
        # it is on only where a coherence channel exists: a metalog dir
        # (the watermark files live there) or a MemoryStore (no one can
        # share it).  A dir-less Filer over a sqlite FILE could share
        # that file with a process it cannot hear, so it stays uncached
        # unless the caller opts in.
        from .meta_cache import FilerMetaCache, meta_cache_entries
        cap = meta_cache_entries()
        if meta_cache is None:
            meta_cache = bool(meta_log_dir) or \
                isinstance(self.store, MemoryStore)
        self.meta_cache = FilerMetaCache(
            self.meta_log, cap, watermark=self.meta_plane is None) \
            if (meta_cache and cap > 0) else None
        if self.meta_cache is not None:
            self._listeners.append(self.meta_cache.on_event)
        if self.meta_plane is not None:
            self.meta_plane.cache = self.meta_cache
        # hot chunk-body cache on the proxy read path: chunk blobs are
        # immutable per fid (an overwrite mints new fids), so this tier
        # needs no invalidation, only a byte-bounded LRU
        from ..util.chunk_cache import (TieredChunkCache, read_cache_disk,
                                        read_cache_mb)
        mb = read_cache_mb(64)
        self.chunk_cache = TieredChunkCache(
            mem_limit=mb << 20, disk_dir=chunk_cache_dir,
            disk_limit=read_cache_disk()[1] << 20,
            name="filer_chunk") if mb > 0 else None
        # striped per-path locks for chunk-list read-modify-write cycles
        # (append_chunks/truncate_file): two concurrent /__chunk__/ posts
        # must not lose each other's chunks
        self._chunk_stripes = [threading.Lock() for _ in range(64)]
        # known-directory cache: _ensure_parents would otherwise issue
        # one store SELECT per ancestor per write.  Bounded, and cleared
        # wholesale on any directory delete or rename, so staleness can
        # only re-create a directory entry, never lose one.
        self._known_dirs: set[str] = set()
        self._known_dirs_cap = 4096

    def _note_dir(self, path: str) -> None:
        if len(self._known_dirs) >= self._known_dirs_cap:
            self._known_dirs.clear()
        self._known_dirs.add(path)

    def _chunk_lock(self, path: str) -> "threading.Lock":
        return self._chunk_stripes[hash(path) % 64]

    # -- namespace ops ----------------------------------------------------

    _UNKNOWN = object()   # create_entry: "caller didn't pre-fetch"

    def _store_find(self, path: str) -> Entry | None:
        """Overlay-over-store point lookup WITHOUT the meta cache: the
        internal read of every mutation path.  Overlay hits are cloned:
        internal callers mutate entries in place (rename)."""
        mp = self.meta_plane
        if mp is not None:
            from .meta_plane import _OMISS
            hit = mp.lookup(path)
            if hit is not _OMISS:
                return hit.clone() if hit is not None else None
        return self.store.find_entry(path)

    _OV_UNKNOWN = object()

    def _store_list(self, dir_path: str, start_file: str = "",
                    include_start: bool = False, limit: int = 1000,
                    prefix: str = "", overlay=_OV_UNKNOWN) -> list[Entry]:
        """Overlay-merged directory listing WITHOUT the meta cache:
        unapplied creates appear, tombstones hide the store's stale
        rows.  The store is asked for `limit + |overlay(dir)|` rows so
        tombstoned rows cannot shrink a full page.  `overlay` lets a
        caller that already took the dir's overlay pass it in."""
        mp = self.meta_plane
        ov = overlay if overlay is not self._OV_UNKNOWN else (
            mp.overlay_dir(dir_path) if mp is not None else None)
        if not ov:
            return self.store.list_directory_entries(
                dir_path, start_file, include_start, limit, prefix)
        rows = self.store.list_directory_entries(
            dir_path, start_file, include_start, limit + len(ov),
            prefix)
        merged = {e.name: e for e in rows}
        for name, ent in ov.items():
            if prefix and not name.startswith(prefix):
                continue
            if start_file and (name < start_file or (
                    name == start_file and not include_start)):
                continue
            if ent is None:
                merged.pop(name, None)
            else:
                merged[name] = ent.clone()
        return [merged[n] for n in sorted(merged)][:limit]

    def _insert(self, entry: Entry) -> None:
        """The store half of a synchronous commit; with the plane on,
        durability is the metalog barrier inside _notify and the store
        is applied behind it."""
        if self.meta_plane is None:
            self.store.insert_entry(entry)

    def create_entry(self, entry: Entry, create_parents: bool = True,
                     old_entry=_UNKNOWN) -> None:
        """`old_entry` lets a caller that already looked the path up
        (write_file's overwrite check) pass its result through instead
        of paying a second store read for the update-vs-create event
        verdict."""
        entry.full_path = normalize_path(entry.full_path)
        if create_parents:
            self._ensure_parents(entry.full_path)
        mc = self.meta_cache
        tok = mc.fresh_token() if mc is not None and entry.is_directory \
            else None
        old = self._store_find(entry.full_path) \
            if old_entry is self._UNKNOWN else old_entry
        if tok is not None and old is None:
            mc.mark_fresh_dir(entry.full_path, tok)
        self._insert(entry)
        if entry.is_directory:
            self._note_dir(entry.full_path)
        self._notify("update" if old else "create", entry, old)

    def _ensure_parents(self, path: str) -> None:
        parent = path.rsplit("/", 1)[0]
        if not parent or parent == "/":
            return
        if parent in self._known_dirs:
            return
        mc = self.meta_cache
        tok = mc.fresh_token() if mc is not None else None
        if self._store_find(parent) is None:
            e = Entry(parent, is_directory=True,
                      attributes=Attributes(mode=0o770))
            self._ensure_parents(parent)
            if tok is not None:
                mc.mark_fresh_dir(parent, tok)
            self._insert(e)
            self._notify("create", e, None)
        self._note_dir(parent)

    @staticmethod
    def _count_negative(result: str) -> None:
        """filer_read_negative_total{result}: "hit" = absence proven
        without a store SELECT (cached None, negative directory),
        "miss" = the SELECT was paid and came back empty.  Only the
        GET edge counts (count_negative=True)."""
        stats.PROCESS.counter_add(
            "filer_read_negative_total", 1.0,
            help_text="read-edge lookups that found no entry, by "
                      "whether absence was proven without a store "
                      "SELECT",
            result=result)

    def find_entry(self, path: str,
                   count_negative: bool = False) -> Entry | None:
        path = normalize_path(path)
        mp = self.meta_plane
        if mp is not None:
            # coherence point: ingest any sibling event durably appended
            # before this read began (one stat), then let the overlay
            # override cache and store
            mp.catch_up()
            from .meta_plane import _OMISS
            hit = mp.lookup(path)
            if hit is not _OMISS:
                if hit is None and count_negative:
                    self._count_negative("hit")
                return hit.clone() if hit is not None else None
        mc = self.meta_cache
        if mc is None:
            entry = self.store.find_entry(path)
            if entry is None and count_negative:
                self._count_negative("miss")
            return entry
        if mc.known_absent(path):
            # the parent is a tracked fresh directory and this name was
            # never touched: provably no entry, no store SELECT
            if count_negative:
                self._count_negative("hit")
            return None
        from .meta_cache import _MISS
        hit = mc.lookup_entry(path)
        if hit is not _MISS:
            if hit is None and count_negative:
                self._count_negative("hit")
            # callers mutate the returned entry in place (update_attrs,
            # append_chunks): the cached copy stays pristine
            return hit.clone() if hit is not None else None
        token = mc.begin_fill()
        entry = self.store.find_entry(path)
        mc.fill_entry(path,
                      entry.clone() if entry is not None else None,
                      token)
        if entry is None and count_negative:
            self._count_negative("miss")
        return entry

    def delete_entry(self, path: str, recursive: bool = False,
                     delete_chunks: bool = True) -> None:
        path = normalize_path(path)
        entry = self._store_find(path)
        if entry is None:
            return
        if entry.is_directory:
            children = self._store_list(path, limit=2)
            if children and not recursive:
                raise IsADirectoryError(f"{path} not empty")
            self._delete_tree(path, delete_chunks)
        elif delete_chunks:
            self._delete_chunks(entry)
        if self.meta_plane is None:
            self.store.delete_entry(path)
        if entry.is_directory:
            # wholesale, and AFTER the store delete: clearing before it
            # would let a concurrent _note_dir re-cache the doomed path
            # and suppress its re-creation forever
            self._known_dirs.clear()
        self._notify("delete", None, entry)

    def _delete_tree(self, path: str, delete_chunks: bool) -> None:
        while True:
            children = self._store_list(path, limit=1000)
            if not children:
                break
            for child in children:
                if child.is_directory:
                    self._delete_tree(child.full_path, delete_chunks)
                elif delete_chunks:
                    self._delete_chunks(child)
                if self.meta_plane is None:
                    self.store.delete_entry(child.full_path)
                self._notify("delete", None, child)

    def _delete_chunks(self, entry: Entry) -> None:
        for c in entry.chunks:
            try:
                operation.delete(self.master, c.file_id)
            except (OSError, LookupError, RuntimeError):
                pass  # orphan cleanup is a maintenance job

    def list_directory(self, path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1000,
                       prefix: str = "") -> list[Entry]:
        path = normalize_path(path)
        mp = self.meta_plane
        if mp is not None:
            mp.catch_up()
            ov = mp.overlay_dir(path)
            if ov:
                # the unapplied tail touches this directory: serve the
                # overlay-merged listing and skip the cache (while the
                # overlay masks the dir the cache cannot acquire a stale
                # fill, and the event-time epoch bump killed any fill
                # that raced the events)
                return self._store_list(path, start_file,
                                        include_start, limit, prefix,
                                        overlay=ov)
        mc = self.meta_cache
        if mc is None:
            return self.store.list_directory_entries(
                path, start_file, include_start, limit, prefix)
        from .meta_cache import _MISS
        key = (path, start_file, include_start, limit, prefix)
        hit = mc.lookup_list(key)
        if hit is not _MISS:
            return [e.clone() for e in hit]
        token = mc.begin_fill()
        entries = self.store.list_directory_entries(
            path, start_file, include_start, limit, prefix)
        mc.fill_list(key, [e.clone() for e in entries], token)
        return entries

    def update_attrs(self, path: str, **kw) -> None:
        """Attribute-only UpdateEntry (filer.proto UpdateEntry with
        unchanged chunks): mode/uid/gid/mtime patches that content
        writes can't carry."""
        entry = self.find_entry(path)
        if entry is None:
            raise FileNotFoundError(path)
        for k, v in kw.items():
            setattr(entry.attributes, k, v)
        self.create_entry(entry, create_parents=False)

    def rename(self, old_path: str, new_path: str) -> None:
        """Atomic within the store (filer.proto AtomicRenameEntry);
        directories move their whole subtree."""
        old_path = normalize_path(old_path)
        new_path = normalize_path(new_path)
        entry = self._store_find(old_path)
        if entry is None:
            raise FileNotFoundError(old_path)
        self._ensure_parents(new_path)
        if entry.is_directory:
            for child in self._store_list(old_path, limit=1_000_000):
                self.rename(child.full_path,
                            new_path + "/" + child.name)
        old_entry = copy.copy(entry)  # event must carry the OLD path
        entry.full_path = new_path
        if self.meta_plane is None:
            self.store.insert_entry(entry)
            self.store.delete_entry(old_path)
        if entry.is_directory:
            self._known_dirs.clear()   # the old path left the tree
        self._notify("rename", entry, old_entry)

    # -- content IO -------------------------------------------------------

    def write_file(self, path: str, data: bytes, mime: str = "",
                   mode: int = 0o660) -> Entry:
        """Auto-chunking upload
        (server/filer_server_handlers_write_autochunk.go:25): the chunks
        upload through a bounded fan-out on the process-wide pool
        (util/limiter), whose threads keep their keep-alive sockets to
        the volume servers across requests.  The old chunks of an
        overwritten file are deleted only after the new entry is
        committed: a failed commit leaves the old file readable."""
        # contextvars do not follow the pool's threads: each piece
        # re-binds the handler's deadline, so its hops keep deriving
        # their timeouts from this request's shrinking budget, and the
        # handler's stage track, so its assign and upload stages (and
        # their thread CPU) are charged to this request
        dl = deadline.get()
        trk = profiling.current_track()

        def upload_piece(off: int) -> FileChunk:
            piece = data[off:off + CHUNK_SIZE]
            # fresh-assign retry on volume-state races (an ec.encode
            # making the assigned volume read-only mid-write costs a
            # retry, not a 500)
            with deadline.use(dl), profiling.use_track(trk):
                a, r = operation.assign_and_upload(
                    self.master, piece, collection=self.collection,
                    replication=self.replication)
            return FileChunk(a.fid, off, len(piece),
                             r.get("eTag", ""), time.time_ns())

        chunks = bounded_parallel(
            upload_piece, range(0, len(data), CHUNK_SIZE), limit=4)
        if len(chunks) > 1:
            profiling.flight_note("chunks", len(chunks))
        entry = Entry(normalize_path(path), is_directory=False,
                      attributes=Attributes(mime=mime, mode=mode),
                      chunks=chunks)
        with profiling.stage("meta"):
            old = self.find_entry(path)
            self.create_entry(entry, old_entry=old)
        if old is not None and not old.is_directory:
            # volume DELETE round trips, not metadata work
            with profiling.stage("gc"):
                self._delete_chunks(old)
        return entry

    def append_chunks(self, path: str, offset: int, data: bytes,
                      truncate_to: int | None = None) -> Entry:
        """Interval write: upload `data` as chunks at logical `offset`
        and merge them into the entry's chunk list, relying on
        later-wins overlap resolution (filechunks.py), the server half
        of the reference's chunked dirty-page writeback
        (mount/dirty_pages_chunked.go + UpdateEntry).  Creates the entry
        when absent.  `truncate_to` clips the visible length afterwards
        (see truncate_file)."""
        # upload OUTSIDE the path lock (slow), merge under it:
        # concurrent posts to one path must not lose each other's
        # chunk-list updates
        new_chunks = []
        for off in range(0, len(data), CHUNK_SIZE):
            piece = data[off:off + CHUNK_SIZE]
            a, r = operation.assign_and_upload(
                self.master, piece, collection=self.collection,
                replication=self.replication)
            new_chunks.append(
                FileChunk(a.fid, offset + off, len(piece),
                          r.get("eTag", ""), time.time_ns()))
        with self._chunk_lock(path):
            entry = self.find_entry(path)
            if entry is None:
                entry = Entry(normalize_path(path),
                              is_directory=False,
                              attributes=Attributes())
            elif entry.is_directory:
                raise IsADirectoryError(path)
            entry.chunks.extend(new_chunks)
            if truncate_to is not None:
                self._clip_chunks(entry, truncate_to)
            entry.attributes.mtime = time.time()
            self.create_entry(entry)
            return entry

    @staticmethod
    def _clip_chunks(entry: Entry, length: int) -> None:
        """Drop/clip chunk extents beyond `length` (a FileChunk's
        visible size can shrink without rewriting its blob)."""
        kept = []
        for c in entry.chunks:
            if c.offset >= length:
                continue
            if c.offset + c.size > length:
                c.size = length - c.offset
            kept.append(c)
        entry.chunks = kept

    def truncate_file(self, path: str, length: int) -> Entry:
        """Set the visible file length: clip beyond, zero-extend by a
        one-byte sentinel chunk when growing (reads zero-fill gaps,
        but total size is the max chunk extent)."""
        with self._chunk_lock(path):
            entry = self.find_entry(path)
            if entry is None or entry.is_directory:
                raise FileNotFoundError(path)
            current = total_size(entry.chunks)
            if length >= current:
                grow = length > current
            else:
                self._clip_chunks(entry, length)
                entry.attributes.mtime = time.time()
                self.create_entry(entry)
                return entry
        if grow:
            # append_chunks retakes the lock (upload happens outside)
            return self.append_chunks(path, length - 1, b"\x00")
        return entry

    # chunk bodies over this size are never cached whole (a tiny view
    # into a huge chunk must not stage the whole blob through memory);
    # the filer's own chunks are CHUNK_SIZE, so this covers them all
    CHUNK_CACHE_ITEM_MAX = CHUNK_SIZE

    def _read_view(self, view) -> bytes:
        """One ChunkView's bytes, through the hot chunk-body cache when
        the blob is cache-worthy: the WHOLE chunk is fetched once and
        the view sliced out of it, since the next read usually wants
        another slice of the same blob."""
        # an armed fault fires before the cache answers; keyed by the fid
        from .. import faults
        faults.fire("filer.chunk.fetch", key=view.file_id)
        cc = self.chunk_cache
        if cc is not None and 0 < view.chunk_size <= \
                self.CHUNK_CACHE_ITEM_MAX:
            body = cc.get(view.file_id)
            if body is None:
                body = operation.read(self.master, view.file_id)
                cc.set(view.file_id, body)
            return body[view.chunk_offset:view.chunk_offset + view.size]
        # ranged read: fetch only the view's bytes, not the chunk
        return operation.read(self.master, view.file_id,
                              view.chunk_offset, view.size)

    def read_file(self, path: str, offset: int = 0,
                  size: int | None = None) -> bytes:
        """Chunk-resolved ranged read (filer/stream.go:99)."""
        entry = self.find_entry(path)
        if entry is None or entry.is_directory:
            raise FileNotFoundError(path)
        file_size = total_size(entry.chunks)
        if size is None:
            size = file_size - offset
        size = max(0, min(size, file_size - offset))
        if size == 0:
            return b""
        out = bytearray(size)
        for view in view_from_chunks(entry.chunks, offset, size):
            piece = self._read_view(view)
            lo = view.logical_offset - offset
            out[lo:lo + len(piece)] = piece
        return bytes(out)

    def open_read_stream(self, entry: Entry, offset: int, size: int,
                         on_close=None) -> "_ViewStream":
        """File-like over [offset, offset+size) of `entry`'s content:
        views are fetched lazily one at a time as the server drains the
        response, so a multi-GB GET holds at most one chunk in memory
        (gaps read as zeros, as in read_file).  `on_close` runs when
        the server finishes the response."""
        views = view_from_chunks(entry.chunks, offset, size)
        return _ViewStream(self, views, offset, size,
                           on_close=on_close)

    # -- metadata subscription (filer/filer_notify.go) --------------------

    def _notify(self, op: str, new_entry: Entry | None,
                old_entry: Entry | None) -> None:
        if self.meta_plane is not None:
            # WAL path: ONE serialization, durable at the metalog
            # barrier (this is the write's ack point), overlay ingested
            # before any listener runs
            event = self.meta_plane.commit(op, new_entry, old_entry)
        else:
            event = {
                "op": op,
                "tsNs": time.time_ns(),
                "newEntry": new_entry.to_json() if new_entry else None,
                "oldEntry": old_entry.to_json() if old_entry else None,
            }
            # MetaLog stamps (strictly monotonic) and persists BEFORE
            # live listeners see the event, so a listener's recorded
            # tsNs is always replayable after a disconnect
            event = self.meta_log.append(event)
        with self._log_lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(event)
            except Exception as e:  # noqa: BLE001 — listeners are
                # isolated from each other
                wlog.warning(f"filer: meta listener raised: {e!r}",
                             component="filer")

    def subscribe(self, fn: Callable[[dict], None]) -> None:
        with self._log_lock:
            self._listeners.append(fn)

    def events_since(self, ts_ns: int, limit: int = 0) -> list[dict]:
        return self.meta_log.events_since(ts_ns, limit)

    def close(self) -> None:
        """The meta plane first (its final apply leaves the store a
        complete checkpoint on a clean shutdown), then store and log."""
        if self.meta_plane is not None:
            self.meta_plane.close()
        self.store.close()
        self.meta_log.close()
