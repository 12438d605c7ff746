"""In-memory needle map: needleId -> (offset, size) per volume, backed by
an append-only .idx file.

The reference's CompactMap (weed/storage/needle_map/compact_map.go) is a
segmented sorted-array map tuned for Go's memory model; in Python a dict
of int -> packed int is both the idiomatic and the fast choice, and the
bulk .idx load is a vectorized numpy pass (storage/idx.py) instead of a
row loop.  Metrics semantics follow weed/storage/needle_map_metric.go:
deletions append a tombstone entry to .idx and subtract live bytes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import idx, types


@dataclass
class MapMetrics:
    file_count: int = 0
    deleted_count: int = 0
    deleted_bytes: int = 0
    maximum_key: int = 0


class NeedleMap:
    """needleId -> (stored_offset, size); size < 0 means deleted."""

    def __init__(self, idx_path: str | None = None):
        self._m: dict[int, tuple[int, int]] = {}
        self.metrics = MapMetrics()
        # the put entry that lies furthest into the .dat: the floor of
        # the .dat-tail replay (storage/volume.py _replay_dat_tail), as
        # every record before its end is indexed.  The furthest, not the
        # last: an .idx rebuilt from an .ecx is in key order.  Tombstone
        # entries do not move it
        self.furthest_put: "tuple[int, int] | None" = None
        self._idx_path = idx_path
        self._idx_file = None
        if idx_path is not None:
            mode = "r+b" if os.path.exists(idx_path) else "w+b"
            self._idx_file = open(idx_path, mode)
            self._load()

    # -- loading ---------------------------------------------------------

    def _load(self) -> None:
        self._idx_file.seek(0)
        buf = self._idx_file.read()
        arr = idx.parse_index(buf)
        m = self.metrics
        # vectorized metrics; the dict replay preserves last-wins order
        for key, offset, size in zip(arr["key"].tolist(),
                                     arr["offset"].tolist(),
                                     arr["size"].tolist()):
            self._apply(key, offset, size)
        if len(arr):
            m.maximum_key = int(arr["key"].max())
        self._idx_file.seek(0, os.SEEK_END)

    def _apply(self, key: int, offset: int, size: int) -> None:
        m = self.metrics
        if not types.size_is_deleted(size):
            if self.furthest_put is None or offset > self.furthest_put[0]:
                self.furthest_put = (offset, size)
            old = self._m.get(key)
            # every put counts a file; an overwrite additionally counts
            # the replaced record as deleted (needle_map_metric.go logPut)
            m.file_count += 1
            if old is not None and types.size_is_valid(old[1]):
                m.deleted_count += 1
                m.deleted_bytes += old[1]
            self._m[key] = (offset, size)
        else:
            old = self._m.get(key)
            if old is not None and types.size_is_valid(old[1]):
                m.deleted_count += 1
                m.deleted_bytes += old[1]
            if old is not None:
                # keep the offset so vacuums can find the tombstoned record
                self._m[key] = (old[0], types.TOMBSTONE_FILE_SIZE)

    # -- mutation --------------------------------------------------------

    def put(self, key: int, stored_offset: int, size: int) -> None:
        self._apply(key, stored_offset, size)
        self.metrics.maximum_key = max(self.metrics.maximum_key, key)
        if self._idx_file is not None:
            self._idx_file.write(idx.entry_bytes(key, stored_offset, size))

    def delete(self, key: int) -> bool:
        """Marks deleted; appends a tombstone .idx entry with offset 0
        (needle_map_memory.go Delete appends size TombstoneFileSize)."""
        old = self._m.get(key)
        if old is None or not types.size_is_valid(old[1]):
            return False
        self._apply(key, old[0], types.TOMBSTONE_FILE_SIZE)
        if self._idx_file is not None:
            self._idx_file.write(
                idx.entry_bytes(key, 0, types.TOMBSTONE_FILE_SIZE))
        return True

    # -- lookup ----------------------------------------------------------

    def get(self, key: int) -> tuple[int, int] | None:
        """Returns (stored_offset, size) for live needles, else None."""
        v = self._m.get(key)
        if v is None or not types.size_is_valid(v[1]):
            return None
        return v

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return self.metrics.file_count - self.metrics.deleted_count

    def items(self):
        for k, (o, s) in self._m.items():
            if types.size_is_valid(s):
                yield k, o, s

    def max_key(self) -> int:
        """Largest needle id ever mapped (0 when empty) — the
        per-volume input to the master's sequencer fencing
        (master.proto Heartbeat.max_file_key).  Reads the monotonic
        metric (maintained by put() and _load()) rather than scanning
        the dict: the heartbeat thread calls this concurrently with
        writer-thread put()s, and iterating the live dict there would
        race a resize."""
        return self.metrics.maximum_key

    def content_size(self) -> int:
        return sum(s for _, _, s in self.items())

    # -- persistence -----------------------------------------------------

    def flush(self) -> None:
        if self._idx_file is not None:
            self._idx_file.flush()

    def close(self) -> None:
        if self._idx_file is not None:
            self._idx_file.flush()
            self._idx_file.close()
            self._idx_file = None

