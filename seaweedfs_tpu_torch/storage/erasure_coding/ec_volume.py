"""Mounted EC volume (weed/storage/erasure_coding/ec_volume.go,
ec_shard.go, ec_volume_delete.go, ec_volume_scrub.go), the port of
`seaweedfs_tpu/storage/erasure_coding/ec_volume.py`.

Holds the locally present shard files of one volume, each open for
positioned reads, and its `.ecx` open for the binary search that locates
a needle.  A delete tombstones the `.ecx` entry in place and journals the
needle id to `.ecj`.  Needles are read through the striping interval
math (`ec_locate`).  Scrub checks the index and the locally present
needles.  The handles are opened when the volume is mounted and released
by `close`: the store closes an EcVolume it replaces or unmounts.
"""

from __future__ import annotations

import errno
import os
import struct
import threading

from .. import idx as idxmod
from .. import types
from ..needle import Needle, get_actual_size
from ..super_block import SuperBlock
from ..volume_info import maybe_load_volume_info
from .ec_context import (DATA_SHARDS_COUNT, ECContext, LARGE_BLOCK_SIZE,
                         PARITY_SHARDS_COUNT, SMALL_BLOCK_SIZE)
from .ec_locate import Interval, locate_data


class NotFoundError(KeyError):
    pass


class EcVolumeShard:
    """One local .ecNN shard file (ec_shard.go).  Shard files are
    immutable once written, so reads are `os.pread` on one descriptor
    with no lock around the read.  The descriptor is closed by the last
    read in flight when `close` comes first, so no read ever lands on a
    descriptor number the process has reused."""

    def __init__(self, shard_id: int, path: str):
        self.shard_id = shard_id
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self.size = os.fstat(self._fd).st_size
        self._lock = threading.Lock()
        self._readers = 0
        self._closed = False

    def read_at(self, offset: int, size: int) -> bytes:
        """Bytes [offset, offset + size), short only at the end of the
        file.  Raises OSError (EBADF) once the shard is closed."""
        with self._lock:
            if self._closed:
                raise OSError(errno.EBADF, f"shard {self.path} closed")
            self._readers += 1
        try:
            return os.pread(self._fd, size, offset)
        finally:
            with self._lock:
                self._readers -= 1
                if self._closed and not self._readers:
                    os.close(self._fd)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if not self._readers:
                os.close(self._fd)


class EcVolume:
    """ec_volume.go:26 EcVolume: a volume mounted as the EC shards this
    node holds.  The scheme comes from `.vif` (RS(10,4) without one)."""

    def __init__(self, directory: str, volume_id: int, collection: str = "",
                 ctx: ECContext | None = None,
                 index_directory: str | None = None):
        self.dir = directory
        self.index_dir = index_directory or directory
        self.id = volume_id
        self.collection = collection
        self.shards: dict[int, EcVolumeShard] = {}
        self.lock = threading.RLock()
        base = self.base_file_name()
        vi = maybe_load_volume_info(self.index_base_file_name() + ".vif") \
            or maybe_load_volume_info(base + ".vif")
        if ctx is None:
            if vi is not None and vi.ec_shard_config is not None and \
                    vi.ec_shard_config.data_shards:
                ctx = ECContext(vi.ec_shard_config.data_shards,
                                vi.ec_shard_config.parity_shards,
                                collection, volume_id)
            else:
                ctx = ECContext(DATA_SHARDS_COUNT, PARITY_SHARDS_COUNT,
                                collection, volume_id)
        self.ctx = ctx
        self.dat_file_size = vi.dat_file_size if vi else 0
        try:
            for sid in range(ctx.total):
                p = base + ctx.to_ext(sid)
                if os.path.exists(p):
                    self.shards[sid] = EcVolumeShard(sid, p)
            ecx = self.index_base_file_name() + ".ecx"
            self._ecx = open(ecx, "r+b") if os.path.exists(ecx) else None
        except OSError:
            self.close()
            raise
        self._ecj_path = self.index_base_file_name() + ".ecj"
        self.version = self._read_version(vi)

    # -- naming ----------------------------------------------------------

    def _name(self, d: str) -> str:
        name = f"{self.id}"
        if self.collection:
            name = f"{self.collection}_{name}"
        return os.path.join(d, name)

    def base_file_name(self) -> str:
        return self._name(self.dir)

    def index_base_file_name(self) -> str:
        return self._name(self.index_dir)

    def _read_version(self, vi) -> int:
        """Version from .vif when recorded (the authoritative source,
        ec_volume.go:84-87), else the superblock at the head of a local
        shard 0, else the current default."""
        if vi is not None and vi.version:
            return vi.version
        shard0 = self.shards.get(0)
        if shard0 is not None:
            return SuperBlock.parse(shard0.read_at(0, 8),
                                    require_extra=False).version
        return types.CURRENT_VERSION

    @property
    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    def shard_size(self) -> int:
        for s in self.shards.values():
            return s.size
        return 0

    # -- .ecx search (ec_volume.go:283-346) -------------------------------

    def locate_needle(self, needle_id: int) -> tuple[int, int, list[Interval]]:
        """LocateEcShardNeedle: returns (actual_offset, size, intervals).
        Raises NotFoundError when absent; a tombstoned entry returns
        size = TOMBSTONE_FILE_SIZE with no intervals."""
        offset, size = self.search_sorted_index(needle_id)
        if types.size_is_deleted(size):
            return types.to_actual_offset(offset), size, []
        intervals = locate_data(
            LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, self.shard_dat_size(),
            types.to_actual_offset(offset),
            get_actual_size(size, self.version),
            self.ctx.data_shards)
        return types.to_actual_offset(offset), size, intervals

    def shard_dat_size(self) -> int:
        """Per-shard logical size for the locate math
        (ec_volume.go:295-308 LocateEcShardNeedleInterval): datFileSize
        from .vif is authoritative; the fallback subtracts 1 from the
        shard file size to disambiguate an exact large-block multiple
        that actually holds small blocks."""
        if self.dat_file_size > 0:
            return self.dat_file_size // self.ctx.data_shards
        return self.shard_size() - 1

    def search_sorted_index(self, needle_id: int,
                            mark_deleted: bool = False
                            ) -> tuple[int, int]:
        """Binary search .ecx (ec_volume.go:319
        SearchNeedleFromSortedIndex).  Returns (stored_offset, size).
        Holds the volume lock: the shared handle's seek/read pairs must
        not interleave across threads."""
        if self._ecx is None:
            raise NotFoundError(f"no .ecx for volume {self.id}")
        with self.lock:
            return self._search_locked(needle_id, mark_deleted)

    def _search_locked(self, needle_id: int, mark_deleted: bool
                       ) -> tuple[int, int]:
        self._ecx.seek(0, os.SEEK_END)
        n_entries = self._ecx.tell() // types.NEEDLE_MAP_ENTRY_SIZE
        lo, hi = 0, n_entries
        while lo < hi:
            mid = (lo + hi) // 2
            self._ecx.seek(mid * types.NEEDLE_MAP_ENTRY_SIZE)
            buf = self._ecx.read(types.NEEDLE_MAP_ENTRY_SIZE)
            key, offset, size = struct.unpack(">QIi", buf)
            if key == needle_id:
                if mark_deleted:
                    self._ecx.seek(mid * types.NEEDLE_MAP_ENTRY_SIZE +
                                   types.NEEDLE_ID_SIZE + types.OFFSET_SIZE)
                    self._ecx.write(struct.pack(
                        ">i", types.TOMBSTONE_FILE_SIZE))
                    self._ecx.flush()
                return offset, size
            if key < needle_id:
                lo = mid + 1
            else:
                hi = mid
        raise NotFoundError(f"needle {needle_id:x} not in ecx")

    # -- delete (ec_volume_delete.go) -------------------------------------

    def delete_needle(self, needle_id: int) -> None:
        """Tombstone in .ecx + append id to .ecj journal
        (ec_volume_delete.go:27 DeleteNeedleFromEcx)."""
        with self.lock:
            try:
                self.search_sorted_index(needle_id, mark_deleted=True)
            except NotFoundError:
                return
            with open(self._ecj_path, "ab") as ecj:
                ecj.write(struct.pack(">Q", needle_id))

    def rebuild_ecx_file(self) -> None:
        """Replay .ecj tombstones into .ecx (ec_volume_delete.go:51)."""
        if not os.path.exists(self._ecj_path):
            return
        with self.lock:
            with open(self._ecj_path, "rb") as ecj:
                while True:
                    b = ecj.read(types.NEEDLE_ID_SIZE)
                    if len(b) != types.NEEDLE_ID_SIZE:
                        break
                    try:
                        self.search_sorted_index(
                            int.from_bytes(b, "big"), mark_deleted=True)
                    except NotFoundError:
                        pass

    # -- reads (local shards only; cross-server reads live in
    #    server/store_ec.py, weed/storage/store_ec.go) --------------------

    def read_needle_with(self, interval_reader, needle_id: int,
                         cookie: int | None = None) -> Needle:
        """Read + decode a needle, fetching each interval through
        `interval_reader` (local shard files here; the server's
        EcReader passes its remote/reconstruct resolver)."""
        _, size, intervals = self.locate_needle(needle_id)
        if types.size_is_deleted(size):
            raise NotFoundError(f"needle {needle_id:x} deleted")
        data = b"".join(interval_reader(iv) for iv in intervals)
        n = Needle.from_bytes(data, self.version, expected_size=size)
        if cookie is not None and n.cookie != cookie:
            raise ValueError(f"cookie mismatch on needle {needle_id:x}")
        return n

    def read_needle_local(self, needle_id: int, cookie: int | None = None
                          ) -> Needle:
        """Read a needle when ALL its intervals are locally present
        (store_ec.go:141 ReadEcShardNeedle, local-only path)."""
        return self.read_needle_with(self.read_interval, needle_id,
                                     cookie=cookie)

    def read_interval(self, iv: Interval) -> bytes:
        sid, off = iv.to_shard_id_and_offset(
            LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, self.ctx.data_shards)
        shard = self.shards.get(sid)
        if shard is None:
            raise NotFoundError(
                f"shard {sid} of volume {self.id} not local")
        return shard.read_at(off, iv.size)

    # -- scrub (ec_volume_scrub.go) ---------------------------------------

    def scrub_index(self) -> tuple[int, list[str]]:
        """:14 ScrubIndex: keys strictly ascending, entries well-formed.
        Returns (entry_count, errors)."""
        if self._ecx is None:
            return 0, [f"no .ecx for volume {self.id}"]
        errors: list[str] = []
        count = 0
        last_key = -1
        for key, _off, _size in self.walk_index():
            count += 1
            if key <= last_key:
                errors.append(
                    f"ecx keys out of order: {key} after {last_key}")
            last_key = key
        if count == 0:
            errors.append(f"zero-size .ecx for volume {self.id}")
        return count, errors

    def scrub_local(self) -> tuple[int, list[int], list[str]]:
        """:27 ScrubLocal: verify every needle whose intervals are
        locally present — chunk bounds, read success, and full-needle
        CRC when no chunk is remote.  Returns (entries, broken_shard_ids,
        errors)."""
        _, errors = self.scrub_index()
        broken: set[int] = set()
        count = 0
        for key, _off, size in self.walk_index():
            count += 1
            if types.size_is_deleted(size):
                continue
            try:
                _, _, intervals = self.locate_needle(key)
            except NotFoundError:
                continue
            has_remote = False
            chunk_failed = False
            data = b""
            for iv in intervals:
                sid, soff = iv.to_shard_id_and_offset(
                    LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE,
                    self.ctx.data_shards)
                shard = self.shards.get(sid)
                if shard is None:
                    has_remote = True
                    continue
                if soff + iv.size > shard.size:
                    broken.add(sid)
                    chunk_failed = True
                    errors.append(
                        f"shard {sid} too short for needle {key:x}")
                    continue
                chunk = shard.read_at(soff, iv.size)
                if len(chunk) != iv.size:
                    broken.add(sid)
                    chunk_failed = True
                    errors.append(
                        f"short read shard {sid} needle {key:x}")
                    continue
                if not has_remote:
                    data += chunk
            # a failed chunk already produced its own precise error; a
            # CRC check on the incomplete byte string would only add a
            # misleading second one
            if not has_remote and not chunk_failed and data:
                try:
                    Needle.from_bytes(data, self.version,
                                      expected_size=size)
                except Exception as e:  # noqa: BLE001 — a corrupt
                    # needle is reported and the scrub goes on
                    errors.append(f"needle {key:x} corrupt: {e}")
        return count, sorted(broken), errors

    # -- info and lifecycle -----------------------------------------------

    def walk_index(self):
        if self._ecx is None:
            return
        with self.lock:
            self._ecx.seek(0)
            buf = self._ecx.read()
        yield from idxmod.walk_index(buf)

    def close(self) -> None:
        for s in self.shards.values():
            s.close()
        ecx = getattr(self, "_ecx", None)
        if ecx is not None:
            ecx.close()

    def destroy(self) -> None:
        self.close()
        base = self.base_file_name()
        for sid in range(self.ctx.total):
            try:
                os.remove(base + self.ctx.to_ext(sid))
            except FileNotFoundError:
                pass
        for ext in (".ecx", ".ecj", ".vif"):
            try:
                os.remove(self.index_base_file_name() + ext)
            except FileNotFoundError:
                pass
