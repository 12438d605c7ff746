"""Tiered chunk cache (weed/util/chunk_cache/chunk_cache.go): a memory
LRU in front of an optional bounded on-disk tier; the port's copy of
`seaweedfs_tpu/util/chunk_cache.py`: the volume server's hot-needle
cache and the filer's chunk-body cache.

Keys are opaque strings (the volume server's are
"<vid>.g<gen>.<key>.<cookie>"); keys are tracked per group (a needle)
so that a write or a delete invalidates every cached spelling of the
needle at once.

A cache built with `name=` counts its hits, misses, evictions and
invalidations on `stats.PROCESS`, so `/metrics` carries
`seaweedfs_tpu_read_cache_{hits,misses,evictions,invalidations}_total
{cache=...}`, `read_cache_bytes_served_total` and the
`read_cache_bytes{cache=...,tier=...}` occupancy gauges.  Not ported:
the runtime resize of the memory tier (the reference's SLO autopilot
actuator) and the mount's path-named alias of `invalidate_group`.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict

from .. import stats


def read_cache_mb(default: int = 64) -> int:
    """The memory tier of the volume server's hot-needle cache in MiB
    (``SEAWEEDFS_TPU_READ_CACHE_MB``, 0 disables the cache)."""
    try:
        return int(os.environ.get("SEAWEEDFS_TPU_READ_CACHE_MB", "")
                   or default)
    except ValueError:
        return default


def read_cache_disk() -> "tuple[str | None, int]":
    """(dir, limit_mb) for the optional disk tier
    (``SEAWEEDFS_TPU_READ_CACHE_DIR`` / ``_DISK_MB``)."""
    d = os.environ.get("SEAWEEDFS_TPU_READ_CACHE_DIR", "") or None
    try:
        mb = int(os.environ.get("SEAWEEDFS_TPU_READ_CACHE_DISK_MB", "")
                 or 1024)
    except ValueError:
        mb = 1024
    return d, mb


class _CacheMeter:
    """`stats.PROCESS` counters and gauges of one named cache; a None
    name counts nothing."""

    __slots__ = ("name",)

    def __init__(self, name: "str | None"):
        self.name = name

    # the event set is closed: a misspelt `which` raises KeyError
    _COUNTERS = {
        "hits": "read_cache_hits_total",
        "misses": "read_cache_misses_total",
        "evictions": "read_cache_evictions_total",
        "invalidations": "read_cache_invalidations_total",
    }

    def count(self, which: str, n: float = 1.0) -> None:
        if not self.name:
            return
        stats.PROCESS.counter_add(
            self._COUNTERS[which], n,
            help_text=f"hot read-cache {which} (shared tier, "
                      f"util/chunk_cache)", cache=self.name)

    def bytes_served(self, n: int) -> None:
        if not self.name or n <= 0:
            return
        stats.PROCESS.counter_add(
            "read_cache_bytes_served_total", float(n),
            help_text="bytes answered from the hot read cache instead "
                      "of disk/network", cache=self.name)

    def occupancy(self, tier: str, nbytes: int) -> None:
        if not self.name:
            return
        stats.PROCESS.gauge_set(
            "read_cache_bytes", float(nbytes),
            help_text="bytes resident in the hot read cache",
            cache=self.name, tier=tier)


class MemChunkCache:
    """Byte-bounded LRU (chunk_cache_in_memory.go)."""

    def __init__(self, limit_bytes: int = 64 << 20,
                 meter: "_CacheMeter | None" = None):
        self.limit = limit_bytes
        self._m: "OrderedDict[str, bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._meter = meter or _CacheMeter(None)

    def get(self, key: str) -> "bytes | None":
        with self._lock:
            data = self._m.get(key)
            if data is not None:
                self._m.move_to_end(key)
            return data

    def set(self, key: str, data: bytes) -> None:
        if len(data) > self.limit:
            return
        evicted = 0
        with self._lock:
            old = self._m.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._m[key] = data
            self._bytes += len(data)
            while self._bytes > self.limit and self._m:
                _k, v = self._m.popitem(last=False)
                self._bytes -= len(v)
                evicted += 1
            nbytes = self._bytes
        if evicted:
            self._meter.count("evictions", evicted)
        self._meter.occupancy("mem", nbytes)

    def delete(self, key: str) -> None:
        with self._lock:
            old = self._m.pop(key, None)
            if old is not None:
                self._bytes -= len(old)

    def set_limit(self, limit_bytes: int) -> None:
        """Resize (the autopilot's knob): a shrink evicts LRU-first down
        to the new bound at once; a grow raises the bound."""
        evicted = 0
        with self._lock:
            self.limit = max(0, int(limit_bytes))
            while self._bytes > self.limit and self._m:
                _k, v = self._m.popitem(last=False)
                self._bytes -= len(v)
                evicted += 1
            nbytes = self._bytes
        if evicted:
            self._meter.count("evictions", evicted)
        self._meter.occupancy("mem", nbytes)


class DiskChunkCache:
    """Bounded on-disk tier (chunk_cache_on_disk.go, simplified to one
    layer): chunk files under a cache dir, LRU-evicted by in-process
    access order.  A fresh process starts cold: stray files of an
    earlier run count toward the bound (so the dir never outgrows it
    across restarts) but are never served until this process writes
    them again, since the invalidations that covered them died with the
    old process."""

    def __init__(self, dir_path: str, limit_bytes: int = 1 << 30,
                 meter: "_CacheMeter | None" = None):
        self.dir = dir_path
        self.limit = limit_bytes
        os.makedirs(dir_path, exist_ok=True)
        self._lock = threading.Lock()
        self._order: "OrderedDict[str, int]" = OrderedDict()
        self._bytes = 0
        self._meter = meter or _CacheMeter(None)
        # adopted leftovers: eviction fodder only (see class doc)
        self._stale: set[str] = set()
        for name in os.listdir(dir_path):
            p = os.path.join(dir_path, name)
            if os.path.isfile(p):
                sz = os.path.getsize(p)
                self._order[name] = sz
                self._bytes += sz
                self._stale.add(name)
        self._evict_locked()

    def _fname(self, key: str) -> str:
        return hashlib.sha256(key.encode()).hexdigest()[:40]

    def get(self, key: str) -> "bytes | None":
        name = self._fname(key)
        with self._lock:
            if name not in self._order or name in self._stale:
                return None
            self._order.move_to_end(name)
        try:
            with open(os.path.join(self.dir, name), "rb") as f:
                # bound the read to what set() could have written: a
                # file swapped under the cache must not buffer
                # unbounded bytes through this process
                return f.read(self.limit)
        except OSError:
            with self._lock:
                self._bytes -= self._order.pop(name, 0)
            return None

    def set(self, key: str, data: bytes) -> None:
        if len(data) > self.limit:
            return
        name = self._fname(key)
        tmp = os.path.join(self.dir, f".{name}.{os.getpid()}")
        try:
            with open(tmp, "w+b") as f:
                f.write(data)
            os.replace(tmp, os.path.join(self.dir, name))
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return
        with self._lock:
            self._stale.discard(name)
            self._bytes -= self._order.pop(name, 0)
            self._order[name] = len(data)
            self._bytes += len(data)
            self._evict_locked()
            nbytes = self._bytes
        self._meter.occupancy("disk", nbytes)

    def delete(self, key: str) -> None:
        name = self._fname(key)
        with self._lock:
            self._bytes -= self._order.pop(name, 0)
            self._stale.discard(name)
        try:
            os.remove(os.path.join(self.dir, name))
        except OSError:
            pass

    def _evict_locked(self) -> None:
        while self._bytes > self.limit and self._order:
            name, sz = self._order.popitem(last=False)
            self._bytes -= sz
            self._stale.discard(name)
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass


class TieredChunkCache:
    """Memory in front of optional disk (chunk_cache.go
    TieredChunkCache).  Tracks keys per group (the volume server's
    needle), so that a changed needle invalidates all of its keys at
    once.  `name` arms the counters on stats.PROCESS."""

    # bounds on the group index itself: the data tiers evict by bytes,
    # but key-name bookkeeping would otherwise grow with every file
    # ever read
    MAX_GROUPS = 4096
    MAX_KEYS_PER_GROUP = 8192

    def __init__(self, mem_limit: int = 64 << 20,
                 disk_dir: "str | None" = None,
                 disk_limit: int = 1 << 30,
                 name: "str | None" = None):
        self._meter = _CacheMeter(name)
        self.mem = MemChunkCache(mem_limit, meter=self._meter)
        self.disk = DiskChunkCache(disk_dir, disk_limit,
                                   meter=self._meter) \
            if disk_dir else None
        self._groups: "OrderedDict[str, set]" = OrderedDict()
        self._glock = threading.Lock()

    def get(self, key: str) -> "bytes | None":
        data = self.mem.get(key)
        if data is None and self.disk is not None:
            data = self.disk.get(key)
            if data is not None:
                self.mem.set(key, data)  # promote
        if data is None:
            self._meter.count("misses")
        else:
            self._meter.count("hits")
            self._meter.bytes_served(len(data))
        return data

    def set(self, key: str, data: bytes, group: str = "") -> None:
        self.mem.set(key, data)
        if self.disk is not None:
            self.disk.set(key, data)
        if group:
            evict: "list[str]" = []
            with self._glock:
                keys = self._groups.get(group)
                if keys is None:
                    keys = self._groups[group] = set()
                else:
                    self._groups.move_to_end(group)
                keys.add(key)
                # evicted bookkeeping must drop its cached data too,
                # or a group forgotten by the index could serve stale
                # blocks with no way to invalidate them
                if len(keys) > self.MAX_KEYS_PER_GROUP:
                    evict.extend(keys)
                    self._groups.pop(group, None)
                while len(self._groups) > self.MAX_GROUPS:
                    _g, old_keys = self._groups.popitem(last=False)
                    evict.extend(old_keys)
            for k in evict:
                self.mem.delete(k)
                if self.disk is not None:
                    self.disk.delete(k)

    def invalidate_group(self, group: str) -> None:
        with self._glock:
            keys = self._groups.pop(group, set())
        if keys:
            self._meter.count("invalidations", len(keys))
        for key in keys:
            self.mem.delete(key)
            if self.disk is not None:
                self.disk.delete(key)

    # the mount's meta-event follower speaks paths; its group is the path
    invalidate_path = invalidate_group

    def delete(self, key: str) -> None:
        """Point invalidation of one key across both tiers."""
        self.mem.delete(key)
        if self.disk is not None:
            self.disk.delete(key)

    def set_mem_limit(self, limit_bytes: int) -> None:
        """Resize the memory tier (the autopilot's `cache.chunk` and
        `cache.needle`); the disk tier keeps its bound."""
        self.mem.set_limit(limit_bytes)
