"""Filer metadata cache, invalidated by the metalog subscription (the
port's copy of `seaweedfs_tpu/filer/meta_cache.py`).

The filer read path pays a store round-trip per `find`/`list` even for
the hottest paths.  This cache keeps
entry and listing results in memory with TWO coherence mechanisms,
both anchored on the metalog:

* **In-process events** — every mutation this filer performs flows
  through `Filer._notify`, whose listener invalidates the touched
  paths *synchronously after the event is durably appended* and
  advances the processed cursor.  A single-filer deployment therefore
  has exact read-your-writes coherence with per-path granularity.

* **Durable-ts watermark** (the metalog's group-commit watermark,
  published per commit window as `.watermark.<pid>.<seq>` files in the
  shared
  metalog dir) — a SECOND filer over the same store shares the same
  metalog dir by construction, and `MetaLog.foreign_watermark()` is
  the cheap probe "has a SIBLING durably committed since my cache
  fills?".  Fills are stamped with the foreign watermark probed
  *before* the store read; the serve rule `current foreign_watermark
  <= fill stamp` means a write through filer A is visible to filer
  B's *next* read: A's commit advances the watermark past every
  pre-write fill stamp, so B bypasses its cache and reads the store.
  **Never serve an entry older than the watermark from cache.**
  (Sibling timestamps are wall-clock incomparable with our own, which
  is why own events are handled by the synchronous listener and ONLY
  foreign commits ride the watermark.)  First contact with a brand-new
  sibling is bounded by the probe's one-second listdir memo.

With the filer's meta plane on (`watermark=False`), the watermark rule
is off: the plane's log follower turns every sibling commit into a
point invalidation before any read that could observe it.

Fills are guarded by a global epoch so an in-flight fill racing an
invalidation can never resurrect a stale value (classic
fill/invalidate race): `begin_fill` snapshots the epoch *before* the
store read, and the fill lands only if no invalidation intervened.

A filer with no metalog dir over a store it might share has no way to
hear a sibling, so the Filer leaves this cache off for it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from .. import stats
from ..util.chunk_cache import _CacheMeter

_MISS = object()


def _no_watermark() -> int:
    return 0


def meta_cache_entries(default: int = 4096) -> int:
    """``SEAWEEDFS_TPU_FILER_META_CACHE`` — max cached entry lookups
    (0 disables; "force" is the default size)."""
    import os
    raw = os.environ.get("SEAWEEDFS_TPU_FILER_META_CACHE", "")
    if raw in ("", "force"):
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class FilerMetaCache:
    """Bounded LRU over entry lookups + directory listings with the
    watermark/epoch coherence rules described in the module doc."""

    MAX_LISTS = 512

    def __init__(self, meta_log, capacity: int = 4096,
                 name: "str | None" = "filer_meta",
                 watermark: bool = True):
        self._log = meta_log
        # watermark=False: meta-plane mode.  The plane's log follower
        # delivers every sibling commit as a POINT invalidation before
        # any read that could observe it (Filer -> MetaPlane.catch_up on
        # the read path), so the coarse "kill every fill at or before
        # the foreign watermark" rule is neither needed nor wanted: it
        # would void every fill within one sibling commit window.
        self._probe = meta_log.foreign_watermark if watermark \
            else _no_watermark
        self._cap = max(int(capacity), 1)
        self._lock = threading.Lock()
        # path -> (fill_watermark, entry-or-None)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        # (dir, start, include_start, limit, prefix) ->
        #   (fill_watermark, [entries])
        self._lists: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._dir_keys: "dict[str, set]" = {}
        self._epoch = 0
        self._processed = 0     # own-instance event cursor
        self._meter = _CacheMeter(name)
        # negative-directory cache: dir ->
        # (fill_watermark, set-of-child-names-that-might-exist).  The
        # Filer registers a directory here BEFORE its create reaches the
        # store (it is provably empty then, and no one can see it yet),
        # so any child name never added to the set is provably ABSENT
        # and the old-entry store SELECT on its create can be skipped.
        # Every invalidation by the own synchronous listener adds the
        # touched name to its parent's set, and the watermark stamp,
        # probed before the Filer's store check, kills the record on
        # any foreign commit.  (The JAX cache registers from the create
        # event, after the store insert: a writer that found the
        # directory in the store in between could create a child the
        # late record never hears of, and a second create of the same
        # directory reset its set, so an acked file read as absent.)
        self._fresh_dirs: "OrderedDict[str, tuple]" = OrderedDict()
        # sibling events invalidated so far (the fresh-dir guard)
        self._foreign = 0

    # -- fill protocol -----------------------------------------------

    def begin_fill(self) -> "tuple[int, int]":
        """(epoch, foreign watermark) token taken BEFORE the store
        read: the fill is discarded if any invalidation bumps the
        epoch while the store read is in flight, and the value is
        stamped with a foreign watermark that pre-dates the read
        (conservative: a sibling's commit landing mid-read can only
        make the fill look stale, never fresh)."""
        wm = self._probe()
        with self._lock:
            return self._epoch, wm

    @staticmethod
    def _valid(fill_wm: int, probe: int) -> bool:
        # no sibling has durably committed since this fill began; own
        # events never reach the watermark — the synchronous listener
        # already invalidated their paths point-wise
        return probe <= fill_wm

    # -- entries -------------------------------------------------------

    def lookup_entry(self, path: str):
        """Cached entry (or cached None for a known-absent path), or
        the _MISS sentinel.  Callers must clone before mutating."""
        probe = self._probe()
        with self._lock:
            hit = self._entries.get(path)
            if hit is None or not self._valid(hit[0], probe):
                self._meter.count("misses")
                return _MISS
            self._entries.move_to_end(path)
        self._meter.count("hits")
        return hit[1]

    def fill_entry(self, path: str, entry, token) -> None:
        epoch, wm = token
        with self._lock:
            if self._epoch != epoch:
                return           # an invalidation raced the fill
            self._entries[path] = (wm, entry)
            self._entries.move_to_end(path)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)

    # -- negative-directory cache --------------------------------------

    MAX_FRESH_DIRS = 512
    MAX_FRESH_CHILDREN = 65536

    @property
    def capacity(self) -> int:
        return self._cap

    def set_capacity(self, capacity: int) -> None:
        """Resize (the autopilot's `cache.meta`): a shrink drops the
        least recently used entries at once; the fills that stay keep
        their watermarks."""
        with self._lock:
            self._cap = max(int(capacity), 1)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)

    def fresh_token(self) -> "tuple[int, int]":
        """(foreign watermark, sibling-invalidation count), taken BEFORE
        the store read that proves a directory absent."""
        wm = self._probe()
        with self._lock:
            return wm, self._foreign

    def mark_fresh_dir(self, path: str, token: "tuple[int, int]") -> None:
        """`path` is about to be created as a brand-new directory (the
        store had no entry when `token` was taken): track it as provably
        empty except for what we see.  A directory already tracked
        keeps its record: a concurrent create of the same directory
        must not forget the children seen since the first.  A sibling's
        event ingested since the token (a pre-fork fleet's other
        process created the directory and wrote into it) refuses the
        record: its children's invalidations ran before the record
        existed, so it could not learn them."""
        wm, foreign = token
        with self._lock:
            if foreign != self._foreign:
                return
            if path in self._fresh_dirs:
                self._fresh_dirs.move_to_end(path)
                return
            self._fresh_dirs[path] = (wm, set())
            while len(self._fresh_dirs) > self.MAX_FRESH_DIRS:
                self._fresh_dirs.popitem(last=False)

    def known_absent(self, path: str) -> bool:
        """True when `path` provably has no entry: its parent is a
        tracked fresh directory, no commit we could have missed has
        happened since tracking began, and the name was never touched.
        A True return makes the caller skip the old-entry store SELECT
        entirely — the negative-cache fast path on the create-heavy
        workload."""
        parent, _, name = path.rpartition("/")
        parent = parent or "/"
        probe = self._probe()
        with self._lock:
            rec = self._fresh_dirs.get(parent)
            if rec is not None and self._valid(rec[0], probe) \
                    and name not in rec[1]:
                hit = True
            else:
                hit = False
        stats.PROCESS.counter_add(
            "filer_meta_negative_dir_total", 1.0,
            help_text="negative-directory-cache consults on the "
                      "create path (hit = old-entry SELECT skipped)",
            result="hit" if hit else "miss")
        return hit

    def _note_child_locked(self, path: str,
                           keep_own: bool = False) -> None:
        """Any touch of `path` (create/update/delete, own or sibling)
        poisons its name in the parent's fresh-dir set, and drops the
        path's own fresh-dir record (an update, delete or rename of a
        tracked dir means we no longer know it) unless `keep_own`: the
        directory's own fresh create, which the record was made for."""
        if not keep_own:
            self._fresh_dirs.pop(path, None)
        parent, _, name = path.rpartition("/")
        rec = self._fresh_dirs.get(parent or "/")
        if rec is None:
            return
        if len(rec[1]) >= self.MAX_FRESH_CHILDREN:
            self._fresh_dirs.pop(parent or "/", None)
        else:
            rec[1].add(name)

    # -- listings ------------------------------------------------------

    def lookup_list(self, key: tuple):
        probe = self._probe()
        with self._lock:
            hit = self._lists.get(key)
            if hit is None or not self._valid(hit[0], probe):
                self._meter.count("misses")
                return _MISS
            self._lists.move_to_end(key)
        self._meter.count("hits")
        return hit[1]

    def fill_list(self, key: tuple, entries: list, token) -> None:
        epoch, wm = token
        with self._lock:
            if self._epoch != epoch:
                return
            self._lists[key] = (wm, entries)
            self._lists.move_to_end(key)
            self._dir_keys.setdefault(key[0], set()).add(key)
            while len(self._lists) > self.MAX_LISTS:
                old_key, _v = self._lists.popitem(last=False)
                keys = self._dir_keys.get(old_key[0])
                if keys is not None:
                    keys.discard(old_key)
                    if not keys:
                        self._dir_keys.pop(old_key[0], None)

    # -- invalidation --------------------------------------------------

    def invalidate(self, path: str, keep_fresh: bool = False,
                   foreign: bool = False) -> None:
        """Drop one path's entry, its parent's listings, and its own
        listings (when it is a directory); bump the epoch so racing
        fills die.  `keep_fresh` keeps the path's own fresh-dir record
        (its create).  `foreign`: a sibling process's event (the meta
        plane's follower), which also refuses fresh-dir records whose
        token predates it (`mark_fresh_dir`)."""
        parent = path.rsplit("/", 1)[0] or "/"
        with self._lock:
            self._epoch += 1
            if foreign:
                self._foreign += 1
            self._entries.pop(path, None)
            self._note_child_locked(path, keep_own=keep_fresh)
            for d in (parent, path):
                for key in self._dir_keys.pop(d, ()):
                    self._lists.pop(key, None)
        self._meter.count("invalidations")

    def on_event(self, ev: dict) -> None:
        """The Filer._notify listener: runs synchronously after the
        event is durable, so by the time a writer's create/delete call
        returns, no reader can hit the pre-write cache."""
        fresh = ev.get("op") == "create" and not ev.get("oldEntry")
        for side in ("newEntry", "oldEntry"):
            e = ev.get(side)
            if e:
                self.invalidate(e.get("fullPath", ""), keep_fresh=fresh)
        ts = int(ev.get("tsNs", 0))
        with self._lock:
            if ts > self._processed:
                self._processed = ts

    def clear(self) -> None:
        with self._lock:
            self._epoch += 1
            self._entries.clear()
            self._lists.clear()
            self._dir_keys.clear()
            self._fresh_dirs.clear()

    # -- introspection (tests / debug) ---------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "lists": len(self._lists),
                    "freshDirs": len(self._fresh_dirs),
                    "epoch": self._epoch,
                    "processed": self._processed}
