"""The filer meta plane, the port's copy of
`seaweedfs_tpu/filer/meta_plane.py`: the metalog as the filer's
WRITE-AHEAD LOG, the store as an asynchronously maintained CHECKPOINT.

A namespace mutation is acknowledged once its event clears the
metalog's group-commit barrier: already durable (a page-cache write,
the tier of a sqlite WAL commit), already batched.  The sqlite store is
applied *asynchronously*, in batched transactions, by ONE designated
applier (an `flock` on the log dir elects it among the instances that
share the dir).

Reads stay EXACT through an in-memory overlay of the unapplied tail:

* every acked event is ingested into `{path -> entry|tombstone}` (and
  a per-directory name index) before the ack returns;
* `find`/`list` consult overlay-over-store: an entry the applier has
  not reached yet is served from the overlay, a tombstone hides the
  store's stale row, listings merge both;
* sibling writers' events (another filer over the same store, the
  native meta plane) arrive by FOLLOWING the shared log (`_Cursor`):
  `catch_up()` is a cheap stat probe on the read path, and any event
  durably appended before a read began is ingested before that read
  is served; sibling commits reach the meta cache as point
  invalidations;
* overlay entries are evicted once the applier's CHECKPOINT, a
  `(segment, offset)` cursor persisted in the log dir and advanced
  only AFTER the covering store transaction commits, passes their
  position.

Crash safety: the checkpoint is a conservative lower bound of what the
store holds, and replaying the log from any such bound re-applies an
idempotent prefix in file order, so a SIGKILL anywhere between ack and
apply loses nothing (boot replay), and a crash between a store commit
and its checkpoint write merely re-applies a window.  Rotation is
multi-writer racy by nature (a sibling can land a late line in a
segment the cursor already left), so the cursor re-reads left-behind
segments for a grace period and the checkpoint never advances past an
unsealed segment (`_Cursor.safe_pos`).

`SEAWEEDFS_TPU_FILER_META_PLANE=0` is the kill switch restoring the
synchronous store commit; its boot path still replays any unapplied
tail a planed run left behind (`recover_sync`), so flipping the knob
never un-acks history.  The checkpoint file, the lock file and the
log's lines are the JAX package's: either package boots over a log dir
the other left.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from collections import deque

from .. import stats
from ..util.group_commit import GROUP_COMMIT_BATCH_BUCKETS
from .entry import Entry
from .meta_log import LOG_START, _segment_name

_log = logging.getLogger("seaweedfs_tpu_torch.filer")

_OMISS = object()          # lookup(): "the overlay has no opinion"

CHECKPOINT_FILE = "checkpoint"
APPLIER_LOCK_FILE = "applier.lock"
_CKPT_WIDTH = 256
_ROTATE_GRACE_S = 2.0
_APPLY_BATCH_MAX = 4096


def meta_plane_enabled() -> "bool | None":
    """SEAWEEDFS_TPU_FILER_META_PLANE: "0" forces the synchronous
    commit path, "1" forces the plane on (where the store supports
    it), unset = auto (on for durable local stores with a metalog
    dir)."""
    v = os.environ.get("SEAWEEDFS_TPU_FILER_META_PLANE", "")
    if v == "0":
        return False
    if v in ("1", "force"):
        return True
    return None


def plane_interval_s() -> float:
    """SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS — the applier/follower
    tick (default 20ms).  A crash test inflates it to hold the
    ack-to-apply window open under SIGKILL."""
    try:
        ms = int(os.environ.get(
            "SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS", "") or 20)
    except ValueError:
        ms = 20
    return max(1, ms) / 1e3


# -- checkpoint file ------------------------------------------------------

def _encode_ckpt(pos: "tuple[str, str, int]", ts: int) -> bytes:
    body = json.dumps({"day": pos[0], "minute": pos[1],
                       "offset": pos[2], "tsNs": ts},
                      separators=(",", ":"))
    body = f"{body}|{zlib.crc32(body.encode('ascii')) & 0xFFFFFFFF:08x}"
    return body.ljust(_CKPT_WIDTH).encode("ascii")


def _decode_ckpt(data: bytes):
    """(pos, tsNs), or None when torn/invalid — the reader treats a
    torn checkpoint as LOG_START (replay more, never less)."""
    try:
        text = data.decode("ascii").strip()
        body, sep, crc = text.rpartition("|")
        if not sep or \
                int(crc, 16) != zlib.crc32(body.encode("ascii")) & \
                0xFFFFFFFF:
            return None
        d = json.loads(body)
        return ((d["day"], d["minute"], int(d["offset"])),
                int(d.get("tsNs", 0)))
    except (ValueError, KeyError, UnicodeError):
        return None


def read_checkpoint(dir_path: str):
    """(pos, tsNs); (LOG_START, 0) when the file is torn (replay is
    idempotent, so low is the safe direction); None when the plane
    has never run over this log."""
    try:
        with open(os.path.join(dir_path, CHECKPOINT_FILE), "rb") as f:
            data = f.read(_CKPT_WIDTH)
    except OSError:
        return None
    return _decode_ckpt(data) or (LOG_START, 0)


# -- log follower ---------------------------------------------------------

class _Cursor:
    """Follow the metalog segment files from a position, yielding
    parsed events with their end-of-line positions.  Positions are
    `(day, minute, offset)` tuples ordered by plain comparison.

    Rotation: segment choice is per-writer (each picks by its event's
    stamp), so around a minute boundary a sibling can append a LATE
    line to a segment this cursor already left.  Left segments are
    therefore re-read for `_ROTATE_GRACE_S` (late lines are delivered
    out of order — the overlay's position rule makes that safe), and
    `safe_pos()` pins the checkpoint below any unsealed segment so a
    crash can never strand a late-acked line behind the cursor."""

    READ_MAX = 1 << 20

    def __init__(self, dir_path: str, pos: "tuple[str, str, int]",
                 skip_wid: str = "", skip_fn=None):
        self.dir = dir_path
        self.day, self.minute, self.off = pos
        # own-batch extent oracle (MetaLog.own_extent_at): lets the
        # coherence follower jump over bytes this instance appended
        # without a single read syscall
        self._skip_fn = skip_fn
        # [day, minute, offset, grace deadline] per left-behind segment
        self._left: "list[list]" = []
        self._mtime_root = -1
        self._mtime_day = -1
        # coherence cursors pass their own writer id: lines this
        # instance appended are already in the overlay (ingested at
        # ack), so they are skip-scanned by a substring check instead
        # of json-parsed — the wid field sits in the line's fixed
        # header region
        self._skip_marker = f'"wid":"{skip_wid}"' if skip_wid else ""
        self._fh = None              # cached active-segment handle
        self._fh_seg: "tuple[str, str] | None" = None

    def pos(self) -> "tuple[str, str, int]":
        return (self.day, self.minute, self.off)

    def safe_pos(self) -> "tuple[str, str, int]":
        p = self.pos()
        for d, m, off, _dl in self._left:
            p = min(p, (d, m, off))
        return p

    def _seg_path(self, day: str, minute: str) -> str:
        return os.path.join(self.dir, day, minute + ".log")

    def _next_segment(self, day: str, minute: str):
        try:
            days = sorted(
                d for d in os.listdir(self.dir)
                if os.path.isdir(os.path.join(self.dir, d)))
        except OSError:
            return None
        for d in days:
            if day and d < day:
                continue
            try:
                minutes = sorted(
                    m[:-4]
                    for m in os.listdir(os.path.join(self.dir, d))
                    if m.endswith(".log"))
            except OSError:
                continue
            for m in minutes:
                if d == day and m <= minute:
                    continue
                return (d, m)
        return None

    def _active_handle(self, day: str, minute: str):
        """Cached read handle for the cursor's active segment (the
        read-path coherence probe pays no open per poll); non-active
        (grace) segments open transiently."""
        seg = (day, minute)
        if self._fh is not None and self._fh_seg == seg:
            return self._fh, False
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        self._fh = open(self._seg_path(day, minute), "rb")
        self._fh_seg = seg
        return self._fh, False

    def _read_lines(self, day: str, minute: str, off: int,
                    transient: bool = False):
        """Complete lines at `off`: ([(event, raw_new, pos, wid)],
        new_offset).  Unparseable lines (a torn tail later sealed
        over by O_APPEND writers) are skipped but still advance the
        offset, matching events_since's torn-line tolerance; own
        lines (skip_wid) are skip-scanned without parsing."""
        out: list = []
        try:
            if transient:
                f = open(self._seg_path(day, minute), "rb")
            else:
                f, _ = self._active_handle(day, minute)
            try:
                f.seek(off)
                data = f.read(self.READ_MAX)
            finally:
                if transient:
                    f.close()
        except OSError:
            return out, off
        end = data.rfind(b"\n")
        if end < 0:
            return out, off
        line_off = off
        skip = self._skip_marker.encode("ascii") \
            if self._skip_marker else b""
        for raw in data[:end + 1].split(b"\n")[:-1]:
            line_off += len(raw) + 1
            if not raw:
                continue
            if skip and skip in raw[:72]:
                continue     # own line: already ingested at ack time
            try:
                text = raw.decode("utf-8")
                ev = json.loads(text)
            except (ValueError, UnicodeDecodeError):
                continue
            if not isinstance(ev, dict):
                continue
            nl = ev.pop("nl", None)
            wid = ev.pop("wid", "")
            raw_new = None
            if isinstance(nl, int) and 0 < nl <= len(text) - 2:
                # newEntry is the line's LAST value: exactly the bytes
                # the appender serialized once (meta_log.append_raw)
                raw_new = text[-(nl + 1):-1]
            out.append((ev, raw_new, (day, minute, line_off), wid))
        return out, off + end + 1

    def _next_segment_cached(self):
        """`_next_segment` behind a dir-mtime memo: creating a segment
        bumps its parent dir's mtime, so unchanged mtimes mean no
        rotation and the two listdirs are skipped.  Mtimes
        are sampled BEFORE the listing, and the memo advances only
        when the listing finds nothing — a creation racing the
        listing re-checks next call instead of getting lost."""
        try:
            rt = os.stat(self.dir).st_mtime_ns
        except OSError:
            return None
        dt = -1
        if self.day:
            try:
                dt = os.stat(os.path.join(
                    self.dir, self.day)).st_mtime_ns
            except OSError:
                dt = -1
        if rt == self._mtime_root and dt == self._mtime_day:
            return None
        nxt = self._next_segment(self.day or "", self.minute or "")
        if nxt is None:
            self._mtime_root, self._mtime_day = rt, dt
        return nxt

    def poll(self, limit: int = 0) -> list:
        """Drain newly appended events (all of them, or up to
        `limit`), following rotations."""
        now = time.monotonic()
        out: list = []
        kept = []
        for ent in self._left:
            evs, new_off = self._read_lines(ent[0], ent[1], ent[2],
                                            transient=True)
            if new_off != ent[2]:
                out.extend(evs)
                ent[2] = new_off
                ent[3] = now + _ROTATE_GRACE_S  # still warm
                kept.append(ent)
            elif now < ent[3]:
                kept.append(ent)
        self._left = kept
        while not limit or len(out) < limit:
            if not self.day:
                nxt = self._next_segment_cached()
                if nxt is None:
                    break
                self.day, self.minute, self.off = nxt[0], nxt[1], 0
            if self._skip_fn is not None:
                end = self._skip_fn(self.day, self.minute, self.off)
                if end is not None and end > self.off:
                    self.off = end
                    continue
            evs, new_off = self._read_lines(self.day, self.minute,
                                            self.off)
            if new_off != self.off:
                out.extend(evs)
                self.off = new_off
                continue
            nxt = self._next_segment_cached()
            if nxt is None:
                break
            self._left.append([self.day, self.minute, self.off,
                               now + _ROTATE_GRACE_S])
            self.day, self.minute, self.off = nxt[0], nxt[1], 0
        return out

    def probe(self) -> bool:
        """Cheap "is there anything unread?" — one fstat on the
        cached active-segment handle (exact for the common in-segment
        append; fstat skips the path walk, which matters on slow
        network/9p filesystems), with the rotation check gated on the
        WALL-CLOCK segment name: a newer segment than the cursor's
        can only exist once the shared clock's minute has moved past
        it (writers pick segments from their event stamps, and every
        process reads the same host clock), so the steady state under
        write load is pure arithmetic plus ONE fstat.  Own-batch
        extents are consumed first."""
        if self.day:
            if self._skip_fn is not None:
                end = self._skip_fn(self.day, self.minute, self.off)
                if end is not None and end > self.off:
                    self.off = end
            try:
                f, _ = self._active_handle(self.day, self.minute)
                if os.fstat(f.fileno()).st_size > self.off:
                    return True
            except OSError:
                pass
        for d, m, off, _dl in self._left:
            try:
                if os.path.getsize(self._seg_path(d, m)) > off:
                    return True
            except OSError:
                continue
        if self.day and \
                _segment_name(time.time_ns()) == (self.day,
                                                  self.minute):
            return False     # the cursor is ON the live segment
        return self._next_segment_cached() is not None

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


def _records(batch: list) -> "tuple[list, int]":
    """Apply records from cursor events: [(op, new_path, raw_new,
    new_dict, old_path)], plus the batch's max stamp."""
    recs, last_ts = [], 0
    for ev, raw_new, _pos, _wid in batch:
        op = ev.get("op", "")
        new = ev.get("newEntry")
        old = ev.get("oldEntry")
        npath = new.get("fullPath") if isinstance(new, dict) else None
        opath = old.get("fullPath") if isinstance(old, dict) else None
        if npath is None and opath is None:
            continue
        recs.append((op, npath, raw_new, new, opath))
        ts = int(ev.get("tsNs", 0) or 0)
        if ts > last_ts:
            last_ts = ts
    return recs, last_ts


def _note_sub(stage: str, seconds: float) -> None:
    stats.PROCESS.histogram_observe(
        "filer_meta_sub_seconds", seconds, buckets=stats.META_SUB_BUCKETS,
        help_text="filer meta-commit sub-stage wall: serialize (entry "
                  "-> WAL bytes, once), barrier (metalog group-commit = "
                  "the ack), apply (async store transaction, per-event "
                  "share)", stage=stage)


class MetaPlane:
    """One filer instance's half of the WAL/checkpoint protocol: the
    overlay index, the coherence follower, and (when this instance
    holds the applier lock) the batched store applier."""

    def __init__(self, store, meta_log):
        self.store = store
        self.log = meta_log
        self.dir = meta_log.dir
        self.cache = None          # FilerMetaCache, wired by Filer
        # optional tap on the coherence follower: called (outside the
        # overlay/cursor locks) with every batch of SIBLING events the
        # follower ingests — the native planes' wrappers use it to
        # track foreign directory truth (server/meta_plane_native.py,
        # server/filer_read_plane_native.py)
        self.sink = None
        self._interval = plane_interval_s()
        self._olock = threading.Lock()
        # serializes the coherence cursor (probe/poll are single-
        # consumer and syscall-heavy); ALWAYS taken outside _olock,
        # never inside, so overlay lookups and ack-path ingests don't
        # queue behind a sibling drain's file reads
        self._clock = threading.Lock()
        # path -> (pos, tsNs, Entry | None-for-tombstone)
        self._paths: "dict[str, tuple]" = {}
        self._dirs: "dict[str, set]" = {}      # dir -> child names
        self._evq: deque = deque()             # (pos, path) in order
        self._cursor = _Cursor(self.dir, LOG_START)
        self._stop = threading.Event()
        self._holder = False
        self._lockf = None
        self._apply_cursor: "_Cursor | None" = None
        self._ckpt_fd: "int | None" = None
        self._ckpt_pos = LOG_START
        self._ckpt_ts = 0
        self._ckpt_memo: "tuple" = (LOG_START, 0.0)
        self._last_acquire = 0.0
        self.applied = 0

        ckpt = read_checkpoint(self.dir)
        if ckpt is None:
            # first enablement: everything already in the log was
            # committed synchronously by the pre-plane path, so the
            # store has it — anchor the checkpoint at the END, and do
            # it DURABLY before the first WAL-only ack can happen
            pos = self.log.end_pos()
            self._create_checkpoint(pos)
        else:
            pos = ckpt[0]
        self._ckpt_pos = pos
        self._cursor = _Cursor(self.dir, pos, skip_wid=meta_log.wid,
                               skip_fn=meta_log.own_extent_at)
        # boot replay into the overlay, synchronously: events a dead
        # process acked but never applied must be readable before the
        # first request is served (the applier re-applies them to the
        # store in the background)
        self._ingest(self._cursor.poll())
        self._thread = threading.Thread(
            target=self._run, name="filer-meta-plane", daemon=True)
        self._thread.start()

    # -- the ack path ------------------------------------------------

    def commit(self, op: str, new_entry, old_entry) -> dict:
        """Serialize ONCE, clear the WAL barrier (the durability
        point — this IS the ack), ingest into the overlay.  Returns
        the event for the filer's listeners."""
        t0 = time.perf_counter()
        new_dict = new_entry.to_json() if new_entry is not None else None
        old_dict = old_entry.to_json() if old_entry is not None else None
        raw_new = json.dumps(new_dict, separators=(",", ":")) \
            if new_dict is not None else None
        raw_old = json.dumps(old_dict, separators=(",", ":")) \
            if old_dict is not None else None
        t1 = time.perf_counter()
        event, pos = self.log.append_raw(op, new_dict, old_dict,
                                         raw_new, raw_old)
        t2 = time.perf_counter()
        ts = event["tsNs"]
        with self._olock:
            if new_entry is not None and new_entry.full_path != "/":
                self._ingest_locked(new_entry.full_path,
                                    new_entry.clone(), ts, pos)
            if old_entry is not None and op in ("delete", "rename") \
                    and (new_entry is None or
                         old_entry.full_path != new_entry.full_path) \
                    and old_entry.full_path != "/":
                self._ingest_locked(old_entry.full_path, None, ts, pos)
        _note_sub("serialize", t1 - t0)
        _note_sub("barrier", t2 - t1)
        return event

    def _ingest_locked(self, path: str, entry, ts: int,
                       pos: "tuple[str, str, int]") -> bool:
        """File-order-wins by position; STAMP-order-wins on a
        position tie.  Two racing writers to one path that land in
        the same barrier batch share the batch-end cover position and
        reach this ingest in _olock-acquisition order — which is NOT
        event order — so the tie-break must be the stamp (strictly
        monotonic per instance; same-instance is the only way to
        share a batch).  A follower's re-delivery of an
        already-ingested line sits strictly below the ack-time cover
        and stays a no-op."""
        cur = self._paths.get(path)
        if cur is not None and (cur[0] > pos or
                                (cur[0] == pos and cur[1] >= ts)):
            return False
        self._paths[path] = (pos, ts, entry)
        parent, _, name = path.rpartition("/")
        self._dirs.setdefault(parent or "/", set()).add(name)
        self._evq.append((pos, path))
        return True

    # -- reads -------------------------------------------------------

    def _materialize_locked(self, path: str, rec: tuple):
        """Overlay values from SIBLING events are kept as their
        parsed-JSON dicts and turned into Entry objects only when a
        read actually wants them — most overlay records are evicted
        unread, so the per-event Entry construction would be pure
        follower overhead."""
        val = rec[2]
        if type(val) is dict:
            val = Entry.from_json(val)
            self._paths[path] = (rec[0], rec[1], val)
        return val

    def lookup(self, path: str):
        """Entry clone source / tombstone (None) / _OMISS."""
        with self._olock:
            rec = self._paths.get(path)
            if rec is None:
                return _OMISS
            return self._materialize_locked(path, rec)

    def overlay_dir(self, dir_path: str) -> "dict | None":
        """{name: Entry|None} snapshot of this directory's unapplied
        tail, or None when the overlay has nothing for it (the common
        fast path: one dict probe)."""
        base = dir_path.rstrip("/")
        with self._olock:
            names = self._dirs.get(dir_path if dir_path == "/"
                                   else (base or "/"))
            if not names:
                return None
            out = {}
            for n in names:
                p = f"{base}/{n}"
                rec = self._paths.get(p)
                if rec is not None:
                    out[n] = self._materialize_locked(p, rec)
            return out or None

    def catch_up(self) -> None:
        """Read-path coherence: ingest any event durably appended by a
        SIBLING before this read began.  One fstat in the common case
        (`_Cursor.probe`).  Poll and ingest share the cursor lock's
        critical section: a reader that found the cursor clean must be
        able to rely on every polled event being IN the overlay
        already, not in some other thread's hands."""
        if self._stop.is_set():
            return
        inv = None
        evs = None
        with self._clock:
            if self._cursor.probe():
                evs = self._cursor.poll()
                if evs:
                    with self._olock:
                        inv = self._ingest_events_locked(evs)
        self._invalidate(inv)
        self._drain_sink(evs)

    def _ingest(self, batch: list) -> None:
        with self._olock:
            inv = self._ingest_events_locked(batch)
        self._invalidate(inv)
        self._drain_sink(batch)

    def _drain_sink(self, evs) -> None:
        if evs and self.sink is not None:
            try:
                self.sink(evs)
            except Exception as e:  # noqa: BLE001 — the tap is
                # advisory; coherence never depends on it
                _log.warning("meta plane sink: %r", e)

    def _invalidate(self, paths) -> None:
        if paths and self.cache is not None:
            for p in paths:
                self.cache.invalidate(p)

    def _ingest_events_locked(self, batch: list) -> list:
        """Sibling events -> overlay + point cache invalidations (own
        events were ingested at ack time and their cache entries
        invalidated by the filer's listener — the wid check skips the
        redundant Entry.from_json)."""
        inv = []
        own = self.log.wid
        for ev, _raw, pos, wid in batch:
            if wid and wid == own:
                continue
            ts = int(ev.get("tsNs", 0) or 0)
            op = ev.get("op", "")
            new = ev.get("newEntry")
            old = ev.get("oldEntry")
            if isinstance(new, dict) and \
                    isinstance(new.get("fullPath"), str) and \
                    new.get("fullPath") != "/":
                # ingest the parsed dict as-is; Entry materialization
                # is deferred to the first read (_materialize_locked)
                npath = new["fullPath"]
                if self._ingest_locked(npath, new, ts, pos):
                    inv.append(npath)
            if isinstance(old, dict) and op in ("delete", "rename"):
                opath = old.get("fullPath", "/")
                npath = new.get("fullPath") if isinstance(new, dict) \
                    else None
                if opath != "/" and opath != npath and \
                        self._ingest_locked(opath, None, ts, pos):
                    inv.append(opath)
        return inv

    # -- applier -----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.catch_up()
                self._tick_applier()
                self._evict()
            except Exception as e:  # noqa: BLE001 — the plane thread
                _log.warning("meta plane tick: %r", e)  # must survive
                time.sleep(0.2)

    def _try_acquire(self) -> bool:
        import fcntl
        if self._lockf is None:
            self._lockf = open(
                os.path.join(self.dir, APPLIER_LOCK_FILE), "a+")
        try:
            fcntl.flock(self._lockf.fileno(),
                        fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            return False
        return True

    def _tick_applier(self) -> None:
        if not self._holder:
            now = time.monotonic()
            if now - self._last_acquire < 0.25:
                return
            self._last_acquire = now
            if not self._try_acquire():
                return
            self._holder = True
            # fresh holder: apply from the DURABLE checkpoint (a dead
            # sibling's applier may be arbitrarily behind our own
            # coherence cursor)
            ckpt = read_checkpoint(self.dir)
            self._ckpt_pos = ckpt[0] if ckpt else LOG_START
            self._ckpt_ts = ckpt[1] if ckpt else 0
            self._apply_cursor = _Cursor(self.dir, self._ckpt_pos)
        self._apply_pending()

    def _apply_pending(self) -> None:
        cur = self._apply_cursor
        while not self._stop.is_set():
            batch = cur.poll(limit=_APPLY_BATCH_MAX)
            if not batch:
                # grace expiry can move the seal floor forward with no
                # new events; keep the checkpoint honest
                self._advance_checkpoint(cur.safe_pos(), self._ckpt_ts)
                return
            t0 = time.perf_counter()
            recs, last_ts = _records(batch)
            if recs:
                self.store.apply_events(recs)
            wall = time.perf_counter() - t0
            self.applied += len(recs)
            stats.PROCESS.counter_add(
                "meta_plane_applied_total", float(len(recs)),
                help_text="metalog events applied to the filer store "
                          "by the async checkpoint applier")
            stats.PROCESS.histogram_observe(
                "meta_plane_apply_batch", float(max(len(recs), 1)),
                buckets=GROUP_COMMIT_BATCH_BUCKETS,
                help_text="events per async store transaction")
            if recs:
                _note_sub("apply", wall / len(recs))
            self._advance_checkpoint(cur.safe_pos(), last_ts)

    # -- checkpoint --------------------------------------------------

    def _create_checkpoint(self, pos: "tuple[str, str, int]") -> None:
        """First-enablement anchor, O_EXCL so racing sibling boots
        cannot leapfrog each other past events acked in between —
        exactly one anchor wins, the rest adopt it."""
        path = os.path.join(self.dir, CHECKPOINT_FILE)
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                         0o644)
        except FileExistsError:
            ckpt = read_checkpoint(self.dir)
            if ckpt is not None:
                self._ckpt_pos = ckpt[0]
            return
        try:
            os.pwrite(fd, _encode_ckpt(pos, 0), 0)
        finally:
            os.close(fd)

    def _advance_checkpoint(self, pos: "tuple[str, str, int]",
                            ts: int) -> None:
        """Applier-only (this process owns the applier flock, and the
        checkpoint fields are touched by the plane thread alone).
        Written AFTER the covering store commit and monotonic by
        construction — a crash between commit and write re-applies a
        window, never skips one."""
        ts = max(ts, self._ckpt_ts)
        if pos <= self._ckpt_pos and ts <= self._ckpt_ts:
            return
        pos = max(pos, self._ckpt_pos)
        if self._ckpt_fd is None:
            try:
                self._ckpt_fd = os.open(
                    os.path.join(self.dir, CHECKPOINT_FILE),
                    os.O_WRONLY | os.O_CREAT, 0o644)
            except OSError:
                return
        try:
            os.pwrite(self._ckpt_fd, _encode_ckpt(pos, ts), 0)
        except OSError:
            return
        self._ckpt_pos = pos
        self._ckpt_ts = ts

    def _evict_floor(self) -> "tuple[str, str, int]":
        if self._holder:
            return self._ckpt_pos
        now = time.monotonic()
        if now - self._ckpt_memo[1] > 0.05:
            ckpt = read_checkpoint(self.dir)
            self._ckpt_memo = (ckpt[0] if ckpt else LOG_START, now)
        return self._ckpt_memo[0]

    def _evict(self) -> None:
        """Drop overlay entries whose position the checkpoint passed:
        the store commit covering them is durable, so overlay and
        store agree.  No cache invalidation here, by proof rather
        than by accident: while a path is in the overlay, reads
        short-circuit before any cache fill, so the cache cannot
        ACQUIRE a value for it — and the fill that was in flight when
        the path's event arrived died on the event-time epoch bump
        (listener for own events, ingest for siblings).  Re-bumping
        per eviction would kill every in-flight fill at the cluster's
        full event rate — exactly the watermark-storm thrash this
        plane exists to remove."""
        floor = self._evict_floor()
        with self._olock:
            while self._evq and self._evq[0][0] <= floor:
                pos, path = self._evq.popleft()
                rec = self._paths.get(path)
                if rec is None or rec[0] != pos:
                    continue          # superseded by a later event
                del self._paths[path]
                parent, _, name = path.rpartition("/")
                names = self._dirs.get(parent or "/")
                if names is not None:
                    names.discard(name)
                    if not names:
                        self._dirs.pop(parent or "/", None)

    # -- introspection / teardown ------------------------------------

    def snapshot(self) -> dict:
        with self._olock:
            overlay = len(self._paths)
        return {"overlay": overlay, "holder": self._holder,
                "applied": self.applied,
                "checkpointTsNs": self._ckpt_ts}

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        try:
            if not self._holder and self._try_acquire():
                # a stalled/never-elected applier (inflated interval,
                # short-lived instance) still leaves the store a
                # complete checkpoint when it can take the lock now
                self._holder = True
                ckpt = read_checkpoint(self.dir)
                self._ckpt_pos = ckpt[0] if ckpt else LOG_START
                self._ckpt_ts = ckpt[1] if ckpt else 0
                self._apply_cursor = _Cursor(self.dir, self._ckpt_pos)
            if self._holder and self._apply_cursor is not None:
                # clean shutdown leaves the store a COMPLETE
                # checkpoint: apply everything, then advance
                self._stop.clear()
                try:
                    self._apply_pending()
                finally:
                    self._stop.set()
        except Exception as e:  # noqa: BLE001 — teardown must finish
            _log.warning("meta plane final apply: %r", e)
        if self._lockf is not None:
            try:
                self._lockf.close()     # releases the flock
            except OSError:
                pass
            self._lockf = None
        self._holder = False
        self._cursor.close()
        if self._apply_cursor is not None:
            self._apply_cursor.close()
        if self._ckpt_fd is not None:
            try:
                os.close(self._ckpt_fd)
            except OSError:
                pass
            self._ckpt_fd = None


def recover_sync(meta_log, store) -> int:
    """Kill-switch boot replay: with the plane OFF, a checkpoint left
    by a previous planed run may trail WAL-acked events the store
    never saw.  Apply them synchronously (file order, idempotent)
    before serving, and advance the checkpoint.  Returns the number
    of events applied."""
    import fcntl
    d = meta_log.dir
    if not d:
        return 0
    ckpt = read_checkpoint(d)
    if ckpt is None:
        return 0                 # the plane never ran over this log
    lockf = open(os.path.join(d, APPLIER_LOCK_FILE), "a+")
    try:
        # the boot-time tail [checkpoint, end-at-entry) must be in the
        # store BEFORE this filer serves — whoever holds the applier
        # lock (a sibling's recover_sync, or a live plane-ON applier
        # in a mixed fleet) is applying it, so wait for EITHER the
        # lock (holder finished/died: flock releases) or a checkpoint
        # at/past the entry-time log end (holder applied our tail)
        end_at_entry = meta_log.end_pos()
        while True:
            try:
                fcntl.flock(lockf.fileno(),
                            fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                ckpt = read_checkpoint(d)
                if ckpt is not None and ckpt[0] >= end_at_entry:
                    return 0     # the holder covered our tail
                time.sleep(0.05)
        ckpt = read_checkpoint(d) or (LOG_START, 0)
        cur = _Cursor(d, ckpt[0])
        applied, last_ts = 0, ckpt[1]
        fd = None
        try:
            while True:
                batch = cur.poll(limit=_APPLY_BATCH_MAX)
                if not batch:
                    break
                recs, ts = _records(batch)
                if recs:
                    store.apply_events(recs)
                applied += len(recs)
                last_ts = max(last_ts, ts)
                if fd is None:
                    fd = os.open(os.path.join(d, CHECKPOINT_FILE),
                                 os.O_WRONLY | os.O_CREAT, 0o644)
                os.pwrite(fd, _encode_ckpt(cur.safe_pos(), last_ts), 0)
        finally:
            if fd is not None:
                os.close(fd)
        return applied
    finally:
        lockf.close()
