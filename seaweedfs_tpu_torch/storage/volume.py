"""Append-only needle volume: `.dat` + `.idx` pair.

The part of `seaweedfs_tpu/storage/volume.py` that the EC and write
paths use: create or open a volume, cookie-checked writes with a
monotonic AppendAtNs (the JAX volume's answers: size and unchanged, the
volume's TTL on needles without one, read-only refused), reads,
tombstone deletes, the heartbeat's counts, sync, read-only, close and
destroy.  Byte-compatible with the
reference package, so either package reads the other's volumes.  One
process, one writer: a lock serialises appends, and each acknowledged
write is flushed to the OS before write_needle returns.
"""

from __future__ import annotations

import os
import threading
import time

from . import types
from .needle import Needle, get_actual_size
from .needle_map import NeedleMap
from .replica_placement import ReplicaPlacement
from .super_block import SuperBlock
from .ttl import EMPTY_TTL, TTL


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
                 version: int = types.CURRENT_VERSION):
        self.dir = directory
        self.id = volume_id
        self.collection = collection
        self.lock = threading.RLock()
        self.last_append_at_ns = 0
        self.read_only = False
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

    # -- naming (volume.go FileName) -------------------------------------

    def file_name(self, ext: str) -> str:
        name = f"{self.id}{ext}"
        if self.collection:
            name = f"{self.collection}_{name}"
        return os.path.join(self.dir, name)

    @property
    def version(self) -> int:
        return self.super_block.version

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
        check_cookie is False, which adopts it."""
        with self.lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read-only")
            if not n.has_ttl() and self.super_block.ttl:
                n.set_ttl(self.super_block.ttl)
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
            offset = self._append(n)
            if types.size_is_valid(n.size):
                self.nm.put(n.id, types.to_stored_offset(offset), n.size)
            # ack after the append reaches the OS: a killed process
            # must not lose an acknowledged write
            self._dat.flush()
            self.nm.flush()
        return offset, len(n.data), False

    def _append(self, n: Needle) -> int:
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

    def delete_needle(self, n: Needle) -> int:
        """Append a zero-data tombstone record, then tombstone the map
        (volume_write.go:222 doDeleteRequest).  Returns the freed size,
        0 for a needle that is not there."""
        with self.lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read-only")
            existing = self.nm.get(n.id)
            if existing is None:
                return 0
            tomb = Needle(cookie=n.cookie, id=n.id)
            tomb.append_at_ns = self._next_append_at_ns()
            self._append(tomb)
            self.nm.delete(n.id)
            self._dat.flush()
            self.nm.flush()
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
            self._dat.flush()
            os.fsync(self._dat.fileno())
            self.nm.flush()

    def close(self) -> None:
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
