"""Embedded log-structured filer store, the port's copy of
`seaweedfs_tpu/filer/lsm_store.py` — the LOCAL ordered-KV archetype
(reference: weed/filer/leveldb2/, the filer's DEFAULT store; a
from-scratch LSM-lite rather than a binding).  Its WAL and segment
files are byte for byte the JAX package's, so a store written by either
package opens in the other.

Design (the leveldb shape, miniaturized):
  - a WAL absorbs every mutation (JSON lines, fsync-free append —
    the same durability window as the reference's leveldb WAL with
    sync=false, its default)
  - an in-memory sorted memtable serves reads/scans
  - at MEMTABLE_LIMIT the memtable flushes to an immutable sorted
    segment file and the WAL resets
  - reads consult memtable, then segments newest-first; deletes are
    tombstones
  - when segments pile past COMPACT_AT, everything merges into one
    segment (tombstones dropped)

Keys are entry paths; range scans over the sorted keyspace give
directory listings without touching unrelated subtrees.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import threading

from ..util.group_commit import CommitBarrier
from ..util.skiplist import SkipList
from .entry import Entry
from .filer_store import FilerStore

MEMTABLE_LIMIT = 1000
COMPACT_AT = 4
TOMBSTONE = None          # JSON null marks a delete
_MEM_MISS = object()      # distinguishes "absent" from a tombstone


class LsmTree:
    """Generic ordered str->dict store with WAL + segments."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        # one lock for memtable/WAL/segment state: the store serves
        # concurrent HTTP threads (MemoryStore/SqliteStore lock too)
        self._lock = threading.RLock()
        # ordered memtable (util/skiplist, the reference's
        # weed/util/skiplist role): inserts keep order, so flushes
        # and range scans read it in-order with NO per-call sort
        self._mem = SkipList()
        self._segments: list[tuple[list[str], list]] = []  # old->new
        self._seg_paths: list[str] = []
        self._next_seq = 0
        with self._lock:
            self._recover()
        self._wal = open(self._wal_path, "a")
        # WAL durability is group-committed: writers append under the
        # lock, one barrier leader flushes for the whole window
        self._barrier = CommitBarrier(self._group_commit_flush,
                                      site="filer.lsm_wal")

    def _group_commit_flush(self) -> None:
        with self._lock:
            self._wal.flush()

    @property
    def _wal_path(self) -> str:
        return os.path.join(self.dir, "wal.log")

    def _recover(self) -> None:
        """Caller holds the lock (init-time replay)."""
        names = sorted(n for n in os.listdir(self.dir)
                       if n.endswith(".seg"))
        for name in names:
            path = os.path.join(self.dir, name)
            keys, vals = [], []
            with open(path) as f:
                for line in f:
                    try:
                        k, v = json.loads(line)
                    except ValueError:
                        continue    # torn tail of a crashed flush
                    keys.append(k)
                    vals.append(v)
            self._segments.append((keys, vals))
            self._seg_paths.append(path)
            self._next_seq = max(self._next_seq,
                                 int(name.split(".")[0]) + 1)
        if os.path.exists(self._wal_path):
            with open(self._wal_path) as f:
                for line in f:
                    try:
                        k, v = json.loads(line)
                    except ValueError:
                        continue    # torn tail: drop
                    self._mem.insert(k, v)

    # -- mutations ---------------------------------------------------------

    def put(self, key: str, value: "dict | None") -> None:
        with self._lock:
            self._wal.write(json.dumps([key, value],
                                       separators=(",", ":")) + "\n")
            self._mem.insert(key, value)
            if len(self._mem) >= MEMTABLE_LIMIT:
                self.flush_memtable()
        # ack after the shared WAL barrier (same durability window as
        # the old per-put flush, one flush per commit window)
        self._barrier.commit()

    def put_many(self, pairs: "list[tuple[str, dict | None]]") -> None:
        """Batched put: one WAL write run + ONE barrier for the whole
        batch — the meta plane's applier path (its events already
        cleared the metalog barrier, so this WAL is belt-and-braces
        checkpoint durability, amortized)."""
        if not pairs:
            return
        with self._lock:
            self._wal.write("".join(
                json.dumps([k, v], separators=(",", ":")) + "\n"
                for k, v in pairs))
            for k, v in pairs:
                self._mem.insert(k, v)
            if len(self._mem) >= MEMTABLE_LIMIT:
                self.flush_memtable()
        self._barrier.commit()

    def delete(self, key: str) -> None:
        self.put(key, TOMBSTONE)

    def flush_memtable(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        """Caller holds the lock."""
        if not self._mem:
            return
        seq = self._next_seq
        self._next_seq += 1
        path = os.path.join(self.dir, f"{seq:08d}.seg")
        tmp = path + ".tmp"
        pairs = list(self._mem.items())     # already in key order
        keys = [k for k, _ in pairs]
        with open(tmp, "w") as f:
            for k, v in pairs:
                f.write(json.dumps([k, v],
                                   separators=(",", ":")) + "\n")
            f.flush()  # once a memtable, not a put
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._segments.append((keys, [v for _, v in pairs]))
        self._seg_paths.append(path)
        self._mem = SkipList()
        # the flushed state is durable in the segment: reset the WAL
        self._wal.close()
        os.remove(self._wal_path)
        self._wal = open(self._wal_path, "a")
        if len(self._segments) >= COMPACT_AT:
            self._compact()

    def _compact(self) -> None:
        """Caller holds the lock.  Merge every segment into one,
        newest value wins, tombstones dropped (they have nothing
        older left to shadow).  The merged segment is INSTALLED
        (under a name that sorts newest) before
        the old ones are removed — a crash mid-compaction must leave
        a recoverable superset, never a hole."""
        merged: dict[str, "dict | None"] = {}
        for keys, vals in self._segments:      # old -> new
            for k, v in zip(keys, vals):
                merged[k] = v
        live = {k: v for k, v in merged.items() if v is not TOMBSTONE}
        seq = self._next_seq
        self._next_seq += 1
        path = os.path.join(self.dir, f"{seq:08d}.seg")
        tmp = path + ".tmp"
        keys = sorted(live)
        with open(tmp, "w") as f:
            for k in keys:
                f.write(json.dumps([k, live[k]],
                                   separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)          # durable BEFORE any removal
        for p in self._seg_paths:
            try:
                os.remove(p)
            except OSError:
                pass
        self._segments = [(keys, [live[k] for k in keys])]
        self._seg_paths = [path]

    # -- reads -------------------------------------------------------------

    def get(self, key: str) -> "dict | None":
        with self._lock:
            hit = self._mem.get(key, _MEM_MISS)
            if hit is not _MEM_MISS:
                return hit
            for keys, vals in reversed(self._segments):
                i = bisect.bisect_left(keys, key)
                if i < len(keys) and keys[i] == key:
                    return vals[i]
            return None

    def scan(self, lo: str, hi: str):
        """LAZY merged ordered iteration over [lo, hi): newest layer
        wins, tombstones suppress.  A heap-merge over per-layer
        cursors — a caller that stops after one listing page pays for
        that page, not the whole range (the memtable is bounded by
        MEMTABLE_LIMIT, so its per-call sort is cheap; segments are
        immutable, so index cursors are safe outside the lock)."""
        with self._lock:
            mem = list(self._mem.items(lo, hi))  # in-order, no sort
            segs = list(self._segments)
        # priority 0 = newest (memtable), then segments newest-first
        layers: list[tuple[list, list]] = [
            ([k for k, _ in mem], [v for _, v in mem])]
        layers += [seg for seg in reversed(segs)]
        heap = []
        for pri, (keys, _vals) in enumerate(layers):
            i = bisect.bisect_left(keys, lo)
            if i < len(keys) and keys[i] < hi:
                heap.append((keys[i], pri, i))
        heapq.heapify(heap)
        last_key = None
        while heap:
            key, pri, i = heapq.heappop(heap)
            keys, vals = layers[pri]
            if i + 1 < len(keys) and keys[i + 1] < hi:
                heapq.heappush(heap, (keys[i + 1], pri, i + 1))
            if key == last_key:
                continue        # an older layer's shadowed value
            last_key = key
            if vals[i] is not TOMBSTONE:
                yield key, vals[i]

    def close(self) -> None:
        with self._lock:
            try:
                self._wal.close()
            except OSError:
                pass


class LsmStore(FilerStore):
    """FilerStore over LsmTree (filer/leveldb2/leveldb2_store.go
    shape: one key per entry path, range scans for listings)."""

    supports_meta_plane = True     # durable, local, single-process

    def __init__(self, directory: str):
        self.tree = LsmTree(directory)

    def insert_entry(self, entry: Entry) -> None:
        self.tree.put(entry.full_path, entry.to_json())

    def apply_events(self, records: list) -> None:
        """Meta-plane applier: one WAL batch + one barrier for the
        whole event window (the LSM value is the parsed entry dict the
        WAL line already carries — no re-serialization of the entry
        beyond the tree's own key/value line)."""
        pairs: "list[tuple[str, dict | None]]" = []
        for op, npath, _raw, new, opath in records:
            if npath:
                pairs.append((npath, new))
            if opath and op in ("delete", "rename") and opath != npath:
                pairs.append((opath, TOMBSTONE))
        self.tree.put_many(pairs)

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> "Entry | None":
        if path == "/":
            # the root always exists (same contract as the other
            # stores: clients stat it before anything else)
            return Entry("/", is_directory=True)
        v = self.tree.get(path)
        return Entry.from_json(v) if v is not None else None

    def delete_entry(self, path: str) -> None:
        self.tree.delete(path)

    def delete_folder_children(self, path: str) -> None:
        base = path.rstrip("/")
        for k, _ in list(self.tree.scan(base + "/",
                                        base + "0")):
            self.tree.delete(k)

    def list_directory_entries(self, dir_path: str,
                               start_file: str = "",
                               include_start: bool = False,
                               limit: int = 1000,
                               prefix: str = "") -> "list[Entry]":
        base = dir_path.rstrip("/")
        lo = base + "/" + (prefix or "")
        # exclusive bound: "/"+1 = "0" covers EVERY
        # continuation, incl. astral-plane names a U+FFFF
        # bound would miss
        hi = base + "0"
        out: list[Entry] = []
        for k, v in self.tree.scan(lo, hi):
            name = k[len(base) + 1:]
            if "/" in name:
                continue              # deeper descendant, not a child
            if prefix and not name.startswith(prefix):
                break
            if start_file:
                if name < start_file or (name == start_file and
                                         not include_start):
                    continue
            out.append(Entry.from_json(v))
            if len(out) >= limit:
                break
        return out

    def close(self) -> None:
        self.tree.flush_memtable()
        self.tree.close()
