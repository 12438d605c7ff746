"""Append-only needle volume: `.dat` + `.idx` pair.

The part of `seaweedfs_tpu/storage/volume.py` that the EC and write
paths use: create or open a volume, cookie-checked writes with a
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
"""

from __future__ import annotations

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
from ..util.group_commit import CommitBarrier


class NeedleNotFound(KeyError):
    pass


class NeedleDeleted(KeyError):
    pass


class CookieMismatch(ValueError):
    pass


class Volume:
    """One volume on disk: <dir>/<collection_prefix><vid>.{dat,idx}."""

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
            start = (self.super_block.block_size() +
                     types.NEEDLE_PADDING_SIZE - 1) // \
                types.NEEDLE_PADDING_SIZE * types.NEEDLE_PADDING_SIZE
        total = os.path.getsize(self.file_name(".dat"))
        if start >= total:
            return
        with open(self.file_name(".dat"), "rb") as f:
            offset = start
            while offset + types.NEEDLE_HEADER_SIZE <= total:
                f.seek(offset)
                n = Needle.parse_header(f.read(types.NEEDLE_HEADER_SIZE))
                deleted_mark = n.size < 0
                masked = n.size
                if deleted_mark:
                    masked = 0 if types.size_is_tombstone(n.size) \
                        else types.size_to_u32(n.size) & 0x7FFFFFFF
                rec_len = get_actual_size(masked, self.version)
                if offset + rec_len > total:
                    break                       # truncated tail
                f.seek(offset)
                buf = f.read(rec_len)
                n = Needle.parse_header(buf)
                n.size = masked
                try:
                    n.parse_body(
                        buf[types.NEEDLE_HEADER_SIZE:
                            types.NEEDLE_HEADER_SIZE +
                            needle_body_length(masked, self.version)],
                        self.version, check_crc=True)
                except (ValueError, struct.error):
                    break                       # torn record
                if deleted_mark:
                    n.data = b""
                stored = types.to_stored_offset(offset)
                if n.data and types.size_is_valid(n.size):
                    if self.nm._m.get(n.id) != (stored, n.size):
                        self.nm.put(n.id, stored, n.size)
                elif self.nm.get(n.id) is not None:
                    self.nm.delete(n.id)        # a tombstone record
                if n.append_at_ns > self.last_append_at_ns:
                    self.last_append_at_ns = n.append_at_ns
                offset += rec_len
        self.nm.flush()

    def attach_native(self, wp) -> bool:
        """Hand the `.dat` tail to the native write plane.  False (and
        detached) for volumes whose writes need Python: read-only,
        pre-v3, TTL'd or replicated ones."""
        with self.lock:
            if self._wp is not None:
                return True
            if self.read_only or self.version != types.VERSION3 or \
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
        the fsync of this fd covers it too.  A handle closed under the
        flush fails the batch (the port's volume never swaps its
        handles: no compaction)."""
        self._dat.flush()
        self.nm.flush()
        if self.fsync:
            os.fsync(self._dat.fileno())
            stats.PROCESS.counter_add(
                "volume_fsyncs_total", 1.0,
                help_text="fsyncs of -fsync volumes' .dat, one a group "
                          "commit window")

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
