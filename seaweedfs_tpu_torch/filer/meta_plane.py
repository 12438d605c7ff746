"""The synchronous-commit half of the filer meta plane, the port's copy
of the sync path of `seaweedfs_tpu/filer/meta_plane.py`.

With the JAX package's meta plane on, a namespace mutation is acked
once its event clears the metalog barrier, and the store is a
checkpoint applied behind it: a `(segment, offset)` cursor persisted in
the log dir's `checkpoint` file.  The port's filer always commits
synchronously (the store, then the metalog, before the ack).  What it
keeps of the plane is the boot replay: a filer.db and `.metalog` left by
a planed JAX run may hold acked events past the checkpoint, and
`recover_sync` applies them before the filer serves, so switching a
deployment to the port never un-acks history.

`meta_plane_enabled` reads `SEAWEEDFS_TPU_FILER_META_PLANE` as the JAX
package does; the plane itself is not ported (ROADMAP), so the filer
refuses "1" rather than commit synchronously under a plane's name.
"""

from __future__ import annotations

import json
import os
import time
import zlib

from .meta_log import LOG_START

CHECKPOINT_FILE = "checkpoint"
APPLIER_LOCK_FILE = "applier.lock"
_CKPT_WIDTH = 256
_ROTATE_GRACE_S = 2.0
_APPLY_BATCH_MAX = 4096


def meta_plane_enabled() -> "bool | None":
    """SEAWEEDFS_TPU_FILER_META_PLANE: "0" forces the synchronous
    commit path, "1" asks for the plane, unset = the default (the JAX
    package's auto-on; the port's synchronous commit)."""
    v = os.environ.get("SEAWEEDFS_TPU_FILER_META_PLANE", "")
    if v == "0":
        return False
    if v in ("1", "force"):
        return True
    return None


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
    out of order; applying them is idempotent), and
    `safe_pos()` pins the checkpoint below any unsealed segment so a
    crash can never strand a late-acked line behind the cursor."""

    READ_MAX = 1 << 20

    def __init__(self, dir_path: str, pos: "tuple[str, str, int]"):
        self.dir = dir_path
        self.day, self.minute, self.off = pos
        # [day, minute, offset, grace deadline] per left-behind segment
        self._left: "list[list]" = []
        self._mtime_root = -1
        self._mtime_day = -1
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
        """Cached read handle for the cursor's active segment;
        non-active (grace) segments open transiently."""
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
        offset, matching events_since's torn-line tolerance."""
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
        for raw in data[:end + 1].split(b"\n")[:-1]:
            line_off += len(raw) + 1
            if not raw:
                continue
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
