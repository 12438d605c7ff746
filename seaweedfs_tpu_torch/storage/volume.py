"""Append-only needle volume: `.dat` + `.idx` pair.

The port of `seaweedfs_tpu/storage/volume.py` without its mmap read path
and remote tiers: create or open a volume, cookie-checked writes with a
monotonic AppendAtNs (the JAX volume's answers: size and unchanged, the
volume's TTL on needles without one, read-only refused), reads,
tombstone deletes, the heartbeat's counts, sync, read-only, close and
destroy.  Byte-compatible with the
reference package, so either package reads the other's volumes.  One
process, one writer: a lock serialises appends.  Each acknowledged
write or delete reaches the OS before it returns, through a group
commit (`util/group_commit.CommitBarrier`, site `volume.needle`): the
append happens under the lock, the barrier outside it, and one flush
of the `.dat` and `.idx` covers every writer that appended before it
started.  On the `-fsync` tier (`fsync=True`) that flush also runs
`os.fsync` on the `.dat`, so an acked write survives power loss: one
fsync for each commit window, not for each write.

The native write plane (`server/write_plane.py`) can own the `.dat`
tail (`attach_native`): Python appends then go through the plane's
per-volume mutex, the plane's completed appends are drained into the
needle map before every operation that reads it, and an open replays
the `.dat` records past the `.idx` checkpoint, so a native-acked write
whose index entry never landed is indexed after a crash.

Vacuum (volume_vacuum.go): `compact` copies the live needles to shadow
`.cpd`/`.cpx` files without the volume's lock, over a snapshot of the
needle map taken with every buffered append flushed and the write
plane's journal drained; `commit_compact` replays the `.idx` tail past
the snapshot (`_makeup_diff`: the writes and deletes that landed during
the copy) under the lock, fsyncs the shadows on the `-fsync` tier, and
renames them over the live files, with the compaction revision + 1.
`merge_from` rewrites a read-only volume as the union of its replicas'
records, last write wins; `scrub` re-reads and CRC-checks every live
needle; `walk_dat` scans a `.dat` in append order (the offline `fix`
and `export` tools and the merge).
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading
import time

from .. import profiling, stats
from . import types
from .needle import Needle, get_actual_size, needle_body_length
from .needle_map import NeedleMap
from .replica_placement import ReplicaPlacement
from .super_block import SuperBlock
from .ttl import EMPTY_TTL, TTL
from .volume_info import VolumeInfo, maybe_load_volume_info, save_volume_info
from ..util.group_commit import CommitBarrier


def _records_start(sb: SuperBlock) -> int:
    """The first record's offset: after the superblock and any extra
    blob, rounded up to the 8-byte record alignment."""
    return (sb.block_size() + types.NEEDLE_PADDING_SIZE - 1) // \
        types.NEEDLE_PADDING_SIZE * types.NEEDLE_PADDING_SIZE


def _scan_records(f, version: int, start: int, total: int,
                  check_crc: bool):
    """(needle, offset) of each record of an open `.dat` from `start`,
    in append order, until a truncated tail (or, with `check_crc`, a
    torn record).  A record whose size has the high bit set is a
    deletion wherever it appears: it comes out as the zero-data
    tombstone shape, its size the low 31 bits."""
    offset = start
    while offset + types.NEEDLE_HEADER_SIZE <= total:
        f.seek(offset)
        n = Needle.parse_header(f.read(types.NEEDLE_HEADER_SIZE))
        deleted_mark = n.size < 0
        masked = n.size
        if deleted_mark:
            masked = 0 if types.size_is_tombstone(n.size) \
                else types.size_to_u32(n.size) & 0x7FFFFFFF
        rec_len = get_actual_size(masked, version)
        if offset + rec_len > total:
            return                              # truncated tail
        f.seek(offset)
        buf = f.read(rec_len)
        n = Needle.parse_header(buf)
        n.size = masked
        try:
            n.parse_body(
                buf[types.NEEDLE_HEADER_SIZE:
                    types.NEEDLE_HEADER_SIZE +
                    needle_body_length(masked, version)],
                version, check_crc=check_crc)
        except (ValueError, struct.error):
            if check_crc:
                return                          # torn record
            raise
        if deleted_mark:
            n.data = b""
        yield n, offset
        offset += rec_len


def walk_dat(path: str):
    """Yield (needle, actual_offset) for every record of a `.dat`, live
    writes and tombstones, in append order (storage/volume_checking.go's
    scan; the offline `fix` and `export` tools and `merge_from`).  A
    record with data is a write, a zero-data one a delete tombstone."""
    with open(path, "rb") as f:
        sb = SuperBlock.read_from(f)
        total = os.fstat(f.fileno()).st_size
        yield from _scan_records(f, sb.version, _records_start(sb), total,
                                 check_crc=False)


class NeedleNotFound(KeyError):
    pass


class NeedleDeleted(KeyError):
    pass


class CookieMismatch(ValueError):
    pass


class Volume:
    """One volume on disk: <dir>/<collection_prefix><vid>.{dat,idx,vif}."""

    def __init__(self, directory: str, volume_id: int, collection: str = "",
                 replica_placement: ReplicaPlacement | None = None,
                 ttl: TTL = EMPTY_TTL,
                 version: int = types.CURRENT_VERSION,
                 fsync: bool = False):
        self.dir = directory
        self.id = volume_id
        self.collection = collection
        self.lock = threading.RLock()
        self.last_append_at_ns = 0
        self.read_only = False
        # the -fsync tier: the barrier's flush also fsyncs the .dat
        self.fsync = bool(fsync)
        # the .dat + .idx durability barrier, shared by the writers of a
        # commit window
        self._barrier = CommitBarrier(self._group_commit_flush,
                                      site="volume.needle")
        dat_path = self.file_name(".dat")
        if os.path.exists(dat_path):
            self._dat = open(dat_path, "r+b")
            self.super_block = SuperBlock.read_from(self._dat)
            self._dat.seek(0, os.SEEK_END)
        else:
            self.super_block = SuperBlock(
                version=version,
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl)
            self._dat = open(dat_path, "w+b")
            self._dat.write(self.super_block.to_bytes())
            self._dat.flush()
        self.nm = NeedleMap(self.file_name(".idx"))
        # the native write plane, while it owns the .dat tail, and the
        # native appends indexed since the last drain_native
        self._wp = None
        self._drained: list = []
        self._replay_dat_tail()
        # vacuum state: a compaction between compact() and
        # commit_compact(), and the .idx size at its snapshot
        self._compacting = False
        self._idx_snapshot: "int | None" = None
        self.volume_info = maybe_load_volume_info(self.file_name(".vif")) \
            or VolumeInfo(version=self.super_block.version,
                          replication=str(self.super_block.replica_placement))

    # -- the native write plane (server/write_plane.py) ------------------

    def _replay_dat_tail(self) -> None:
        """Index the `.dat` records past the `.idx` checkpoint (the end of
        its furthest put): a native-acked write is in the `.dat` once write(2)
        returned, before its index entry.  Records that match the map
        are skipped, and the scan stops at the first torn record (a
        length or CRC failure): records are appended in order, so
        nothing valid follows a tear."""
        last = self.nm.furthest_put
        if last is not None:
            start = types.to_actual_offset(last[0]) + \
                get_actual_size(last[1], self.version)
        else:
            start = _records_start(self.super_block)
        total = os.path.getsize(self.file_name(".dat"))
        if start >= total:
            return
        with open(self.file_name(".dat"), "rb") as f:
            for n, offset in _scan_records(f, self.version, start, total,
                                           check_crc=True):
                stored = types.to_stored_offset(offset)
                if n.data and types.size_is_valid(n.size):
                    if self.nm._m.get(n.id) != (stored, n.size):
                        self.nm.put(n.id, stored, n.size)
                elif self.nm.get(n.id) is not None:
                    self.nm.delete(n.id)        # a tombstone record
                if n.append_at_ns > self.last_append_at_ns:
                    self.last_append_at_ns = n.append_at_ns
        self.nm.flush()

    def attach_native(self, wp) -> bool:
        """Hand the `.dat` tail to the native write plane.  False (and
        detached) for volumes whose writes need Python: read-only,
        pre-v3, TTL'd or replicated ones."""
        with self.lock:
            if self._wp is not None:
                return True
            # a compaction's snapshot and diff replay read the .idx: a
            # plane appending to the old .dat would lose its records in
            # the swap (the server offers the volume again after it)
            if self._compacting or \
                    self.read_only or self.version != types.VERSION3 or \
                    bool(self.super_block.ttl) or \
                    self.super_block.replica_placement.byte() or \
                    self.id >= 0x80000000:
                return False
            # the plane appends through its own fd: the buffered tail
            # must be in the file before the plane takes its offset
            self._dat.flush()
            self._dat.seek(0, os.SEEK_END)
            # on the -fsync tier the plane parks each ack until the
            # barrier (fsync included) has run for its epoch: a plane
            # that cannot run that handshake refuses the volume
            if not wp.add_volume(self.id, self.file_name(".dat"),
                                 self._dat.tell(), self.last_append_at_ns,
                                 self.fsync):
                return False
            # every key ever mapped, live or tombstoned, falls back to
            # Python, where the overwrite's cookie and dedup rules are;
            # the plane refuses every write until it is armed
            wp.mark_keys(self.id, self.nm._m.keys())
            if not wp.arm(self.id):
                wp.remove_volume(self.id)
                return False
            self._wp = wp
            return True

    def detach_native(self) -> None:
        """Take the tail back: stop native appends, then drain every
        completed one into the index and flush the `.idx`, so the
        checkpoint is whole before what needed the detach (read-only,
        close) goes on."""
        with self.lock:
            wp = self._wp
            if wp is None:
                return
            self._wp = None
            wp.remove_volume(self.id)
            self._drained += self._apply_native_entries(wp.drain(self.id))
            self.nm.flush()

    def drain_native(self) -> list:
        """Apply completed native appends to the needle map and the
        `.idx` (the pump's tick).  Returns every native append indexed
        since the last call, whichever path indexed it, for the read
        plane."""
        if self._wp is None and not self._drained:
            return []
        with self.lock:
            self._drain_if_pending()
            out, self._drained = self._drained, []
            if out:
                self.nm.flush()
            return out

    def _drain_if_pending(self) -> None:
        """The prologue of every operation that reads the index (the
        caller holds the lock)."""
        wp = self._wp
        if wp is not None and wp.pending(self.id):
            self._drained += self._apply_native_entries(wp.drain(self.id))

    def _apply_native_entries(self, entries: list) -> list:
        for e in entries:
            self.nm.put(e.key, types.to_stored_offset(e.offset), e.size)
            if e.append_ns > self.last_append_at_ns:
                self.last_append_at_ns = e.append_ns
        return entries

    # -- naming (volume.go FileName) -------------------------------------

    def file_name(self, ext: str) -> str:
        name = f"{self.id}{ext}"
        if self.collection:
            name = f"{self.collection}_{name}"
        return os.path.join(self.dir, name)

    @property
    def version(self) -> int:
        return self.super_block.version

    def dat_fd(self) -> int:
        """The `.dat`'s file descriptor, for pread(2) of records that are
        on the file (every acked write is)."""
        return self._dat.fileno()

    def dat_size(self) -> int:
        with self.lock:
            self._dat.seek(0, os.SEEK_END)
            return self._dat.tell()

    # -- stats (the heartbeat's per-volume fields) -----------------------

    def file_count(self) -> int:
        return self.nm.metrics.file_count

    def deleted_count(self) -> int:
        return self.nm.metrics.deleted_count

    def deleted_bytes(self) -> int:
        return self.nm.metrics.deleted_bytes

    def max_file_key(self) -> int:
        """Largest needle id in this volume (volume.go MaxFileKey)."""
        return self.nm.max_key()

    def content_size(self) -> int:
        return self.nm.content_size()

    def garbage_level(self) -> float:
        """volume_vacuum.go:22 garbageLevel: deleted bytes over content."""
        content = self.content_size()
        if content == 0:
            return 0.0
        return self.deleted_bytes() / content

    def configure_replication(self, replication: str) -> None:
        """Rewrite the replica placement in the superblock and the
        volume info (VolumeConfigure)."""
        rp = ReplicaPlacement.from_string(replication)
        with self.lock:
            self.super_block.replica_placement = rp
            pos = self._dat.tell()
            self._dat.seek(0)
            self._dat.write(self.super_block.to_bytes())
            self._dat.flush()
            self._dat.seek(pos)
            self.volume_info.replication = str(rp)

    # -- write path (volume_write.go:112-218) ----------------------------

    def _next_append_at_ns(self) -> int:
        self.last_append_at_ns = max(time.time_ns(),
                                     self.last_append_at_ns + 1)
        return self.last_append_at_ns

    def write_needle(self, n: Needle, check_cookie: bool = True
                     ) -> tuple[int, int, bool]:
        """Returns (actual_offset, size, is_unchanged).

        Cookie semantics follow doWriteRequest (volume_write.go:141): an
        overwrite must present the existing needle's cookie unless
        check_cookie is False, which adopts it.  Under the volume
        server's write track the lock wait, the index lookup and update,
        the append and the barrier's flush are its `lock`, `index`,
        `append` and `flush` stages (`profiling.stage`: no-ops without a
        track)."""
        with profiling.stage("lock"):
            self.lock.acquire()
        try:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read-only")
            if not n.has_ttl() and self.super_block.ttl:
                n.set_ttl(self.super_block.ttl)
            self._drain_if_pending()
            with profiling.stage("index"):
                existing = self.nm.get(n.id)
            if existing is not None:
                old = self._read_at(existing[0], existing[1])
                if old.data == n.data and old.cookie == n.cookie:
                    return types.to_actual_offset(existing[0]), \
                        len(n.data), True
                if n.cookie == 0 and not check_cookie:
                    n.cookie = old.cookie
                if old.cookie != n.cookie:
                    raise CookieMismatch(
                        f"mismatching cookie {n.cookie:x}")
            n.append_at_ns = self._next_append_at_ns()
            with profiling.stage("append"):
                offset = self._append(n)
            if types.size_is_valid(n.size):
                with profiling.stage("index"):
                    self.nm.put(n.id, types.to_stored_offset(offset),
                                n.size)
        finally:
            self.lock.release()
        # ack after the append reaches the OS (and the platter on the
        # -fsync tier), through the barrier it shares with the other
        # writers of its window: a killed process must not lose an
        # acknowledged write
        with profiling.stage("flush"):
            self._barrier.commit()
        return offset, len(n.data), False

    def _group_commit_flush(self) -> None:
        """The barrier's flush (one leader at a time), without the
        volume's lock: the buffered handles serialise each call, so
        writers keep appending while the leader flushes and, on the
        -fsync tier, fsyncs.  A native append is in the file already;
        the fsync of this fd covers it too.  A compaction or merge commit
        may close the handles under the flush: their close flushed what
        was buffered, and on the -fsync tier the flush runs again on the
        new handles (the commit fsynced the shadows it installed).  A
        ValueError with the handles unchanged is a real fault and fails
        the batch."""
        while True:
            dat, nm = self._dat, self.nm
            try:
                dat.flush()
                nm.flush()
                if self.fsync:
                    os.fsync(dat.fileno())
                    stats.PROCESS.counter_add(
                        "volume_fsyncs_total", 1.0,
                        help_text="fsyncs of -fsync volumes' .dat, one a "
                                  "group commit window")
                return
            except ValueError:
                if dat is self._dat and nm is self.nm:
                    raise
                if not self.fsync:
                    return

    def _append(self, n: Needle) -> int:
        wp = self._wp
        if wp is not None:
            # the plane owns the tail: the record goes through its
            # per-volume mutex, so it never interleaves with a native
            # append, and write(2) puts it in the page cache
            off = wp.append(self.id, n.id, n.to_bytes(self.version),
                            n.append_at_ns)
            if off >= 0:
                return off
            # refused (a write error, or a stop racing this append):
            # detach whole, so the plane stops acking and its journal is
            # indexed before Python takes the tail back
            self.detach_native()
        self._dat.seek(0, os.SEEK_END)
        offset = self._dat.tell()
        if offset % types.NEEDLE_PADDING_SIZE != 0:
            # realign like needle_write.go Append does on corrupt tails
            pad = types.NEEDLE_PADDING_SIZE - (
                offset % types.NEEDLE_PADDING_SIZE)
            self._dat.write(b"\x00" * pad)
            offset += pad
        self._dat.write(n.to_bytes(self.version))
        return offset

    def flush(self) -> None:
        """Flush buffered `.dat` appends to the OS file, for readers
        through another fd (the UDS plane's sendfile); near free when
        nothing is pending."""
        with self.lock:
            self._dat.flush()

    def delete_needle(self, n: Needle) -> int:
        """Append a zero-data tombstone record, then tombstone the map
        (volume_write.go:222 doDeleteRequest).  Returns the freed size,
        0 for a needle that is not there."""
        with self.lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read-only")
            self._drain_if_pending()
            existing = self.nm.get(n.id)
            if existing is None:
                return 0
            tomb = Needle(cookie=n.cookie, id=n.id)
            tomb.append_at_ns = self._next_append_at_ns()
            self._append(tomb)
            self.nm.delete(n.id)
        # an acked delete survives as an acked write does
        self._barrier.commit()
        return existing[1]

    # -- read path (volume_read.go:21 readNeedle) ------------------------

    def _read_at(self, stored_offset: int, size: int,
                 check_crc: bool = True) -> Needle:
        offset = types.to_actual_offset(stored_offset)
        length = get_actual_size(size, self.version)
        self._dat.seek(offset)
        buf = self._dat.read(length)
        return Needle.from_bytes(buf, self.version, expected_size=size,
                                 check_crc=check_crc)

    def read_needle(self, needle_id: int, cookie: int | None = None
                    ) -> Needle:
        with self.lock:
            self._drain_if_pending()
            got = self.nm.get(needle_id)
            if got is None:
                raw = self.nm._m.get(needle_id)
                if raw is not None and types.size_is_deleted(raw[1]):
                    raise NeedleDeleted(f"needle {needle_id:x} deleted")
                raise NeedleNotFound(f"needle {needle_id:x} not found")
            n = self._read_at(got[0], got[1])
            if cookie is not None and n.cookie != cookie:
                raise CookieMismatch(
                    f"cookie mismatch for needle {needle_id:x}")
            if n.has_ttl() and n.has_last_modified_date():
                ttl_sec = n.ttl.to_seconds()
                if ttl_sec and n.last_modified + ttl_sec < time.time():
                    raise NeedleNotFound(f"needle {needle_id:x} expired")
            return n

    # -- vacuum (volume_vacuum.go) ---------------------------------------

    def _shadow_super_block(self) -> SuperBlock:
        return SuperBlock(
            version=self.super_block.version,
            replica_placement=self.super_block.replica_placement,
            ttl=self.super_block.ttl,
            compaction_revision=(
                self.super_block.compaction_revision + 1) & 0xFFFF,
            extra=self.super_block.extra)

    @staticmethod
    def _write_shadow_header(dst, sb: SuperBlock) -> None:
        """The superblock, then zeros to the 8-byte record alignment (an
        extra blob of another length would put every record at an
        offset the stored offsets, bytes / 8, cannot express)."""
        dst.write(sb.to_bytes())
        pad = (-dst.tell()) % types.NEEDLE_PADDING_SIZE
        if pad:
            dst.write(b"\x00" * pad)

    def compact(self) -> None:
        """Copy the live needles to shadow `.cpd`/`.cpx`
        (volume_vacuum.go:53 CompactByVolumeData), without the volume's
        lock: writes keep landing in the live files while the copy reads
        a private handle over a snapshot of the needle map, taken with
        the write plane detached and its journal drained, and every
        buffered append and index entry flushed.  `commit_compact`
        replays what landed after the snapshot."""
        cpd, cpx = self.file_name(".cpd"), self.file_name(".cpx")
        with self.lock:
            if self._compacting:
                raise RuntimeError(f"volume {self.id} is already compacting")
            # set before the detach: from here no attach_native succeeds
            self._compacting = True
        try:
            self.detach_native()
            with self.lock:
                # shadows of a crashed compaction: a NeedleMap over a
                # stale .cpx would replay its entries and append after them
                for stale in (cpd, cpx):
                    if os.path.exists(stale):
                        os.remove(stale)
                self._drain_if_pending()
                self._dat.flush()
                self.nm.flush()
                snapshot = sorted(self.nm.items(), key=lambda t: t[1])
                idx_snapshot = os.path.getsize(self.file_name(".idx"))
                dst_sb = self._shadow_super_block()
            dst_nm = NeedleMap(cpx)
            with open(self.file_name(".dat"), "rb") as src, \
                    open(cpd, "wb") as dst:
                self._write_shadow_header(dst, dst_sb)
                for key, stored_off, size in snapshot:
                    n = self._read_at_from(src, stored_off, size)
                    new_off = dst.tell()
                    dst.write(n.to_bytes(self.version))
                    dst_nm.put(key, types.to_stored_offset(new_off), size)
            dst_nm.close()
            with self.lock:
                self._idx_snapshot = idx_snapshot
        except BaseException:
            with self.lock:
                self._compacting = False
            raise

    def _makeup_diff(self) -> int:
        """Replay the writes and deletes that landed after the snapshot
        onto the shadows (volume_vacuum.go:241 makeupDiff); the caller
        holds the lock, and the live `.idx` past the snapshot's size is
        the diff.  Returns the entries replayed."""
        from . import idx as idxmod
        idx_snapshot = self._idx_snapshot
        if idx_snapshot is None:
            return 0
        self._drain_if_pending()
        self._dat.flush()
        self.nm.flush()
        with open(self.file_name(".idx"), "rb") as f:
            f.seek(idx_snapshot)
            tail = f.read()
        self._idx_snapshot = None
        if not tail:
            return 0
        replayed = 0
        cpx_nm = NeedleMap(self.file_name(".cpx"))
        with open(self.file_name(".cpd"), "r+b") as dst:
            dst.seek(0, os.SEEK_END)
            for key, off, size in idxmod.walk_index(tail):
                replayed += 1
                if off == 0 or types.size_is_deleted(size):
                    if cpx_nm.get(key) is not None:
                        cpx_nm.delete(key)
                    continue
                n = self._read_at(off, size)
                new_off = dst.tell()
                dst.write(n.to_bytes(self.version))
                cpx_nm.put(key, types.to_stored_offset(new_off), size)
        cpx_nm.close()
        return replayed

    def commit_compact(self, guard=contextlib.nullcontext) -> int:
        """The diff replay, then the shadows renamed over the live files
        and reopened (volume_vacuum.go:141 CommitCompact).  On the
        -fsync tier the shadows are fsynced first: the acked writes they
        hold were on the platter in the old `.dat`.  `guard()` is entered
        around it, before the volume's lock (the volume server's read
        plane guard).  Returns the `.idx` entries the replay applied."""
        with guard(), self.lock:
            replayed = self._makeup_diff()
            if self.fsync:
                for shadow in (self.file_name(".cpd"),
                               self.file_name(".cpx")):
                    with open(shadow, "rb") as f:
                        os.fsync(f.fileno())
            self._swap_in_shadows()
            self._compacting = False
        return replayed

    def _swap_in_shadows(self) -> None:
        """Close the live handles, rename `.cpd`/`.cpx` over `.dat`/
        `.idx` and reopen them (the caller holds the lock).  Native
        appends indexed before the swap carry old offsets: they are not
        handed to the read plane."""
        self.nm.close()
        self._dat.close()
        os.replace(self.file_name(".cpd"), self.file_name(".dat"))
        os.replace(self.file_name(".cpx"), self.file_name(".idx"))
        self._dat = open(self.file_name(".dat"), "r+b")
        self.super_block = SuperBlock.read_from(self._dat)
        self._dat.seek(0, os.SEEK_END)
        self.nm = NeedleMap(self.file_name(".idx"))
        self._drained = []

    def _read_at_from(self, src, stored_offset: int, size: int) -> Needle:
        """`_read_at` through the caller's handle (the unlocked copy must
        not move the live handle's cursor under the writers)."""
        src.seek(types.to_actual_offset(stored_offset))
        buf = src.read(get_actual_size(size, self.version))
        return Needle.from_bytes(buf, self.version, expected_size=size,
                                 check_crc=True)

    def vacuum(self) -> int:
        self.compact()
        return self.commit_compact()

    def merge_from(self, peer_dat_paths: "list[str]",
                   guard=contextlib.nullcontext) -> int:
        """volume.merge (shell/command_volume_merge.go): this volume's
        records and the peers' `.dat` records in AppendAtNs order, last
        write wins per needle (a newer tombstone deletes), rewritten
        through the shadows and the same swap as a compaction (`guard()`
        around it, as in `commit_compact`).  The volume must be
        read-only.  Returns the live needles."""
        self.detach_native()
        with self.lock:
            if not self.read_only:
                raise PermissionError(
                    f"volume {self.id} must be readonly to merge")
            self._dat.flush()
        records: list = []   # (append_at_ns, seq, needle)
        for path in [self.file_name(".dat")] + list(peer_dat_paths):
            for n, _off in walk_dat(path):
                records.append((n.append_at_ns, len(records), n))
        records.sort(key=lambda t: (t[0], t[1]))
        live: dict = {}
        last_ns: dict = {}
        for _ns, _seq, n in records:
            if n.append_at_ns and last_ns.get(n.id) == n.append_at_ns:
                continue                    # the same record twice
            last_ns[n.id] = n.append_at_ns
            if n.data:
                live[n.id] = n
            else:
                live.pop(n.id, None)        # a tombstone
        cpd, cpx = self.file_name(".cpd"), self.file_name(".cpx")
        with guard(), self.lock:
            for stale in (cpd, cpx):
                if os.path.exists(stale):
                    os.remove(stale)
            dst_nm = NeedleMap(cpx)
            with open(cpd, "wb") as dst:
                self._write_shadow_header(dst, self._shadow_super_block())
                for _id, n in sorted(live.items(),
                                     key=lambda kv: last_ns.get(kv[0], 0)):
                    off = dst.tell()
                    dst.write(n.to_bytes(self.version))
                    dst_nm.put(n.id, types.to_stored_offset(off), n.size)
            dst_nm.close()
            self._idx_snapshot = None
            self._swap_in_shadows()
        return len(live)

    def scrub(self) -> "tuple[int, list[str]]":
        """Read and CRC-check every live needle (volume_grpc_scrub.go).
        Returns (checked, errors).  Each needle is looked up again under
        the lock: a commit in between moves the offsets."""
        errors: list[str] = []
        count = 0
        with self.lock:
            self._drain_if_pending()
            keys = [k for k, _, _ in self.nm.items()]
        for key in keys:
            count += 1
            try:
                with self.lock:
                    got = self.nm.get(key)
                    if got is None:
                        continue            # deleted since
                    self._read_at(got[0], got[1])
            except Exception as e:  # noqa: BLE001 — every error is reported
                errors.append(f"needle {key:x}: {e}")
        return count, errors

    def save_volume_info(self) -> None:
        self.volume_info.version = self.version
        self.volume_info.dat_file_size = self.dat_size()
        save_volume_info(self.file_name(".vif"), self.volume_info)

    # -- lifecycle -------------------------------------------------------

    def sync(self) -> None:
        with self.lock:
            self._drain_if_pending()   # callers read the .idx next
            self._dat.flush()
            os.fsync(self._dat.fileno())
            self.nm.flush()

    def close(self) -> None:
        self.detach_native()
        with self.lock:
            self._dat.flush()
            self._dat.close()
            self.nm.close()

    def destroy(self) -> None:
        """Close the handles, then unlink this volume's files (only the
        names in this directory: a hard link elsewhere keeps its data).
        The `.vif` stays while an EC conversion of the volume is here:
        it records the scheme that rebuild and decode read."""
        self.close()
        exts = [".dat", ".idx", ".cpd", ".cpx"]
        if not (os.path.exists(self.file_name(".ecx")) or
                os.path.exists(self.file_name(".ec00"))):
            exts.append(".vif")
        for ext in exts:
            try:
                os.remove(self.file_name(ext))
            except FileNotFoundError:
                pass
