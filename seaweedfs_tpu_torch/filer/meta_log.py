"""Persistent filer metadata log with timestamp replay, the port's copy
of `seaweedfs_tpu/filer/meta_log.py`; its segments and watermark files
are the JAX package's on disk, in both directions.

The reference appends every namespace mutation to segment files under
`/topics/.system/log/<yyyy-mm-dd>/<HH-MM>` and replays them by
timestamp, pruning whole segments by their date/minute names
(weed/filer/filer_notify_read.go CollectLogFileRefs).  Subscribers that
reconnect resume from their last-seen tsNs and never silently skip
events.

This log keeps the same two-level `<yyyy-mm-dd>/<HH-MM>.log` naming,
appending JSON lines to local files under the filer's data dir.  A
bounded in-memory tail keeps the common `events_since(recent)` query
off the disk.  Timestamps are strictly monotonic at append time, so a
`> sinceNs` resume never skips a same-timestamp sibling.

Durability is GROUP-COMMITTED (util/group_commit.py): appenders stamp
and enqueue their line under the stamp lock, then meet at a shared
barrier whose leader lands the whole batch with ONE `os.write` on an
`O_APPEND` fd; every appender returns only after a write that covers
its line.  An acked event survives SIGKILL, a torn tail line is always
an unacked event, and SIBLING instances over one dir (two filers over
one sqlite store) interleave whole batches, never partial lines.

Each instance publishes its durable stamp in a `.watermark.<pid>.p<seq>`
file, which a sibling's metadata cache reads to learn that someone else
committed (`foreign_watermark`).  Readers of either package match the
`.watermark.` prefix; the `p` keeps a port log and a JAX log in one
process (whose `<seq>` counters are their own) from sharing a file.

This log is the filer's WRITE-AHEAD LOG when the meta plane runs
(filer/meta_plane.py): a namespace mutation is acked once its event
clears the barrier, and the store is a checkpoint applied behind it.
`append_raw` composes a line around entry JSON the caller already
serialized, with an `nl` length field that lets the applier slice
those exact bytes back out, and a `wid` that tells a follower its own
lines from a sibling's; it returns the durable position that anchors
the overlay's eviction.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..util.group_commit import CommitBarrier

# per-process instance counter so every MetaLog over a shared dir owns
# a distinct watermark file (two filers in one test process share a
# pid; their logs must not clobber one file)
_WM_SEQ_LOCK = threading.Lock()
_WM_SEQ = [0]


def _format_wm(ts: int) -> str:
    """Fixed-width watermark payload with a mod-97 check suffix: the
    publish path is a single in-place pwrite (not an atomic replace),
    so a sibling's read racing the write could see a torn mix of old
    and new digits — the check digit makes a tear DETECTABLE, and the
    reader treats it conservatively (serve nothing from cache this
    probe) instead of parsing a possibly-LOWER value and serving
    stale metadata."""
    return f"{ts:020d}.{ts % 97:02d}"


def _parse_wm(text: str) -> "int | None":
    """Parse a watermark payload; None = torn/invalid (the reader
    must fail CONSERVATIVE, never low)."""
    text = text.strip()
    if not text:
        return 0
    num, dot, chk = text.partition(".")
    try:
        v = int(num)
        if dot and v % 97 != int(chk):
            return None
        return v
    except ValueError:
        return None


def _segment_name(ts_ns: int) -> "tuple[str, str]":
    """(day, minute) segment names, UTC — filer_notify_read.go:33
    startDate / :53 startHourMinute."""
    t = time.gmtime(ts_ns / 1e9)
    return (f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}",
            f"{t.tm_hour:02d}-{t.tm_min:02d}")


def alloc_writer_identity(dir_path: str) -> "tuple[str, str]":
    """Mint a (wid, watermark_path) pair for an EXTERNAL sibling
    writer over `dir_path` (the native meta plane,
    server/meta_plane_native.py, appends WAL lines as its own writer
    instance), with the same uniqueness
    guarantees a MetaLog gives itself: the
    per-process seq (two writers in one pid must not clobber one
    watermark file) and the random wid suffix (pid recycling must not
    make a follower skip a dead instance's lines as its own).

    The watermark file is pre-created here via the same tmp + atomic
    replace first-publish protocol as MetaLog._write_watermark, seeded
    at 0 (conservative: readers treat it as "nothing durable yet"), so
    the native side's publish path is a bare pwrite from byte one."""
    import binascii
    with _WM_SEQ_LOCK:
        _WM_SEQ[0] += 1
        seq = _WM_SEQ[0]
    wid = (f"{os.getpid()}-{seq}-"
           f"{binascii.hexlify(os.urandom(3)).decode()}")
    wm_path = os.path.join(dir_path, f".watermark.{os.getpid()}.p{seq}")
    os.makedirs(dir_path, exist_ok=True)
    tmp = f"{wm_path}.tmp"
    with open(tmp, "w", encoding="ascii") as f:
        f.write(_format_wm(0))
    os.replace(tmp, wm_path)
    return wid, wm_path


def strip_wal_fields(event: dict) -> dict:
    """Drop the WAL-plumbing fields a persisted line carries (`nl` =
    newEntry length for the applier's byte-reuse slice, `wid` = writer
    instance id) before the event reaches subscribers — the event API
    contract stays {op, tsNs, newEntry, oldEntry}."""
    event.pop("nl", None)
    event.pop("wid", None)
    return event


# a log position: (day, minute, byte offset after the line/batch).
# Tuples compare lexicographically and segment names are zero-padded,
# so plain tuple comparison orders positions across rotations.
LOG_START: "tuple[str, str, int]" = ("", "", 0)


class MetaLog:
    """Append-only metadata event log: strictly-monotonic stamps,
    per-minute segment files (when `dir_path` is set), timestamp replay
    across restart."""

    def __init__(self, dir_path: str | None = None,
                 max_memory_events: int = 10_000):
        self.dir = dir_path
        self._mem: deque[dict] = deque(maxlen=max_memory_events)
        self._lock = threading.Lock()
        self._last_ts = 0
        # stamped-and-buffered lines awaiting the shared barrier, in
        # stamp order (stamping and enqueueing share self._lock)
        self._pending: "list[tuple[int, str]]" = []
        self._open_name: "tuple[str, str] | None" = None
        self._open_fd: "int | None" = None
        # durable position: (day, minute, offset) just past the last
        # batch this instance's barrier landed: append_raw's conservative
        # "my line is at or before here" cover
        self._durable_pos: "tuple[str, str, int]" = LOG_START
        # own-batch extents [(day, minute, start, end)]: each barrier
        # write is ONE contiguous kernel append of only OUR lines, so
        # the meta plane's coherence follower can jump over it by
        # arithmetic instead of reading and skip-scanning bytes it
        # ingested at ack time.  Bounded; overflow just means the
        # follower reads those bytes the slow way.
        self._own_extents: deque = deque(maxlen=4096)
        # highest stamp whose line a barrier has flushed: the memory
        # tail may briefly lead the disk (stamped, queued, pre-flush),
        # and events_since must not serve an event a crash could still
        # lose — a subscriber that recorded its tsNs would silently
        # skip it on resume after replay
        self._durable_ts = 0
        self._barrier = CommitBarrier(self._group_commit_drain,
                                      site="filer.metalog")
        # durable-ts WATERMARK file (the filer metadata cache's
        # cross-instance coherence probe): this instance's group-commit
        # leader stamps `.watermark.<pid>.p<seq>` with its batch's last
        # flushed ts, so a SIBLING MetaLog over the same dir (two
        # filers sharing one sqlite store share its .metalog by
        # construction) can ask "has anyone ELSE durably committed
        # since my cache fills?" with tiny page-cached reads instead
        # of replaying segments.  Own events don't need the file: the
        # owning filer's cache is invalidated synchronously by its
        # event listener.
        self._wm_path: "str | None" = None
        self._wm_fd: "int | None" = None
        self._wm_last = 0
        self._wm_names: "list[str]" = []
        self._wm_listed = 0.0
        # writer instance id, stamped into append_raw's lines so a
        # meta plane's log follower can tell its own events from
        # sibling instances' cheaply
        self.wid = ""
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            self._last_ts = self._scan_last_ts()
            self._durable_ts = self._last_ts
            self._durable_pos = self.end_pos()
            with _WM_SEQ_LOCK:
                _WM_SEQ[0] += 1
                seq = _WM_SEQ[0]
            # random suffix: pid+seq alone can recur across restarts
            # (pid recycling), and a recurring wid would make a new
            # instance's follower skip-scan a DEAD instance's lines
            # as its own
            import binascii
            self.wid = (f"{os.getpid()}-{seq}-"
                        f"{binascii.hexlify(os.urandom(3)).decode()}")
            self._wm_path = os.path.join(
                self.dir, f".watermark.{os.getpid()}.p{seq}")
            # adopt-and-prune: watermark files at or below the scanned
            # history are redundant (the scan read those events); a
            # LIVE sibling's file above the scan is kept verbatim.
            # Only files untouched for a minute are prune candidates:
            # a read-then-remove on an ACTIVE sibling's file could
            # race its atomic advance and delete a value the sibling's
            # monotonic guard won't republish until its next commit.
            now = time.time()
            for name in os.listdir(self.dir):
                if not name.startswith(".watermark."):
                    continue
                p = os.path.join(self.dir, name)
                try:
                    # wall clock: the only clock processes share
                    if now - os.path.getmtime(p) < 60.0:
                        continue
                    with open(p, encoding="ascii") as f:
                        val = _parse_wm(f.read(64))
                    if val is not None and val <= self._last_ts:
                        os.remove(p)
                except (OSError, ValueError):
                    continue

    # -- append -----------------------------------------------------------

    def append(self, event: dict) -> dict:
        """Stamp and persist one event.  The event's tsNs is bumped if
        needed so stamps are strictly increasing even across restarts
        (replay uses `> sinceNs`; two events sharing a stamp would let
        a resumer skip the second).  Returns only after the shared
        group-commit barrier has landed the event's line — an acked
        event survives SIGKILL, exactly like the old per-event flush."""
        with self._lock:
            ts = self._stamp_locked(event)
            self._mem.append(event)
            if self.dir:
                self._pending.append(
                    (ts, json.dumps(event, separators=(",", ":"))))
        if self.dir:
            self._barrier.commit()
        return event

    def _stamp_locked(self, event: dict) -> int:
        ts = int(event.get("tsNs") or time.time_ns())
        if ts <= self._last_ts:
            ts = self._last_ts + 1
        self._last_ts = ts
        event["tsNs"] = ts
        return ts

    def append_raw(self, op: str, new_dict: "dict | None",
                   old_dict: "dict | None", raw_new: "str | None",
                   raw_old: "str | None"
                   ) -> "tuple[dict, tuple[str, str, int]]":
        """WAL fast path (meta plane): the caller already serialized
        the entry payloads ONCE (`raw_new`/`raw_old` are the JSON of
        `new_dict`/`old_dict`), so the line is composed by string
        splice instead of re-serializing, and the `nl` field records
        `len(raw_new)` so the async store applier can slice the exact
        newEntry bytes back out of the line (the store's meta column
        is that same JSON — zero re-serialization end to end).
        newEntry sits LAST in the line, which makes the slice
        `line[-(nl + 1):-1]` — exact regardless of what the payloads
        contain.  Returns (event, cover_pos): the event dict handed to
        listeners (no WAL fields), and a durable log position at or
        after the event's line (the overlay eviction cover)."""
        event = {"op": op, "newEntry": new_dict, "oldEntry": old_dict}
        with self._lock:
            ts = self._stamp_locked(event)
            self._mem.append(event)
            if self.dir:
                rn = raw_new if raw_new is not None else "null"
                ro = raw_old if raw_old is not None else "null"
                line = (f'{{"nl":{len(rn)},"wid":"{self.wid}",'
                        f'"op":"{op}","tsNs":{ts},'
                        f'"oldEntry":{ro},"newEntry":{rn}}}')
                self._pending.append((ts, line))
        if self.dir:
            self._barrier.commit()
            with self._lock:
                pos = self._durable_pos
        else:
            pos = LOG_START
        return event, pos

    def _group_commit_drain(self) -> None:
        """The barrier's designated flush helper: drain every queued
        line and land each segment's run with ONE `os.write` on the
        O_APPEND fd.  Only ever entered by one leader at a time
        (CommitBarrier serializes batches), so the fd needs no lock of
        its own.  A single kernel append per batch is also what makes
        the shared-dir topology safe: sibling processes' batches
        interleave whole, never mid-line."""
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return
        i, n, end_pos = 0, len(batch), None
        while i < n:
            name = _segment_name(batch[i][0])
            j = i
            while j < n and _segment_name(batch[j][0]) == name:
                j += 1
            if name != self._open_name:
                self._rotate(name)
            buf = "".join(line + "\n"
                          for _ts, line in batch[i:j]).encode("utf-8")
            # short writes must FAIL the batch, not ack it: os.write
            # may land fewer bytes (ENOSPC mid-write, RLIMIT_FSIZE)
            # without raising, and this is the filer's WAL ack point —
            # an exception here propagates to every member of the
            # barrier batch (CommitBarrier's error fan-out), so nobody
            # is acked by bytes that never reached the kernel.  A torn
            # partial line left behind is an UNACKED tail, which every
            # reader already tolerates.
            mv = memoryview(buf)
            while mv:
                wrote = os.write(self._open_fd, mv)
                if wrote <= 0:
                    raise OSError(
                        f"metalog WAL append wrote {wrote} of "
                        f"{len(mv)} bytes")
                mv = mv[wrote:]
            # O_APPEND leaves the fd offset at the end of OUR write
            # (later sibling appends don't move it) — the exact cover
            end = os.lseek(self._open_fd, 0, os.SEEK_CUR)
            end_pos = (name[0], name[1], end)
            self._own_extents.append(
                (name[0], name[1], end - len(buf), end))
            i = j
        with self._lock:
            self._durable_ts = max(self._durable_ts, batch[-1][0])
            if end_pos is not None and end_pos > self._durable_pos:
                self._durable_pos = end_pos
        self._write_watermark(batch[-1][0])

    def _write_watermark(self, ts: int) -> None:
        """Publish the durable ts for sibling instances (one tiny
        write per COMMIT WINDOW, not per event).  Barrier leaders are
        serialized per instance, so the monotonic guard needs no
        lock.

        Fast path: one pwrite of a FIXED-WIDTH 20-digit value at
        offset 0 over a kept-open fd, in place of an open and replace
        per commit window.  Fixed width keeps every
        publish byte-for-byte aligned, so a reader never sees mixed
        digit lengths; the first publish still creates the file
        atomically via the tmp+replace path so sibling discovery
        (listdir) never lists a half-created name."""
        if self._wm_path is None or ts <= self._wm_last:
            return
        self._wm_last = ts
        payload = _format_wm(ts).encode("ascii")
        if self._wm_fd is not None:
            try:
                os.pwrite(self._wm_fd, payload, 0)
                return
            except OSError:
                try:
                    os.close(self._wm_fd)
                except OSError:
                    pass
                self._wm_fd = None
        tmp = f"{self._wm_path}.tmp"
        try:
            with open(tmp, "w", encoding="ascii") as f:
                f.write(payload.decode("ascii"))
            os.replace(tmp, self._wm_path)
            self._wm_fd = os.open(self._wm_path, os.O_WRONLY)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def foreign_watermark(self) -> int:
        """Highest timestamp a SIBLING instance over this log dir has
        durably flushed — the filer metadata cache's staleness probe.
        A cache fill stamped before this value may pre-date a foreign
        write, so the serve rule is `current foreign_watermark <=
        fill stamp` ("never serve an entry older than the watermark
        from cache").  Own events never appear here: the owning
        filer's listener invalidates them synchronously.  0 when no
        sibling has ever committed (single-filer fast path: the probe
        is a memoized listdir once a second, no file reads)."""
        if not self.dir:
            return 0
        now = time.monotonic()
        if now - self._wm_listed > 1.0:
            # new sibling instances appear rarely: re-list at most
            # once a second, read the known files on every probe
            own = os.path.basename(self._wm_path or "")
            try:
                self._wm_names = [
                    n for n in os.listdir(self.dir)
                    if n.startswith(".watermark.") and
                    not n.endswith(".tmp") and n != own]
            except OSError:
                self._wm_names = []
            self._wm_listed = now
        best = 0
        for name in self._wm_names:
            try:
                with open(os.path.join(self.dir, name),
                          encoding="ascii") as f:
                    val = _parse_wm(f.read(64))
            except OSError:
                continue
            if val is None:
                # torn read (racing a sibling's in-place pwrite):
                # fail CONSERVATIVE — an impossibly-new watermark
                # makes every cache fill unservable for this probe,
                # which costs one store round-trip, never staleness
                return 1 << 62
            best = max(best, val)
        return best

    def _rotate(self, name: "tuple[str, str]") -> None:
        """Caller is the barrier leader (serialized)."""
        if self._open_fd is not None:
            os.close(self._open_fd)
        day_dir = os.path.join(self.dir, name[0])
        os.makedirs(day_dir, exist_ok=True)
        self._open_fd = os.open(
            os.path.join(day_dir, name[1] + ".log"),
            os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._open_name = name

    def end_pos(self) -> "tuple[str, str, int]":
        """Current end-of-log position (newest segment + size): where
        recover_sync's boot replay must reach before the filer serves,
        and the meta plane's checkpoint on first enablement, when
        everything already in the log was committed synchronously and
        so is in the store."""
        if not self.dir:
            return LOG_START
        try:
            days = sorted((d for d in os.listdir(self.dir)
                           if os.path.isdir(os.path.join(self.dir, d))),
                          reverse=True)
        except OSError:
            return LOG_START
        for day in days:
            day_dir = os.path.join(self.dir, day)
            for minute in sorted(os.listdir(day_dir), reverse=True):
                if not minute.endswith(".log"):
                    continue
                try:
                    size = os.path.getsize(
                        os.path.join(day_dir, minute))
                except OSError:
                    continue
                return (day, minute[:-4], size)
        return LOG_START

    def durable_pos(self) -> "tuple[str, str, int]":
        with self._lock:
            return self._durable_pos

    def own_extent_at(self, day: str, minute: str,
                      off: int) -> "int | None":
        """If an own-batch extent STARTS exactly at (day, minute,
        off), consume every contiguous own extent from there and
        return the final end offset: the coherence follower's
        fast-skip.  None when the next bytes were written by a
        sibling (or the extent record was evicted): read normally."""
        ext = self._own_extents
        end = None
        while ext:
            d, m, start, e = ext[0]
            if (d, m) != (day, minute) or e <= off:
                ext.popleft()       # stale: the follower moved past
                continue
            if start > off:
                break               # a sibling's bytes come first
            off = end = e
            ext.popleft()
        return end

    # -- replay -----------------------------------------------------------

    def events_since(self, ts_ns: int, limit: int = 0) -> list[dict]:
        """All events with tsNs > ts_ns, oldest first.  Served from the
        in-memory tail when it still covers ts_ns; otherwise replayed
        from the persisted segments (pruned by day/minute name like
        CollectLogFileRefs)."""
        with self._lock:
            mem = list(self._mem)
            durable = self._durable_ts
        if self.dir:
            # serve only barrier-flushed events: an event still queued
            # for its flush is not yet acked, and a crash could erase
            # it — mem visibility must imply durability, as it did
            # when append flushed under the lock
            mem = [e for e in mem if e["tsNs"] <= durable]
        if mem and (mem[0]["tsNs"] <= ts_ns or not self.dir):
            out = [e for e in mem if e["tsNs"] > ts_ns]
            return out[:limit] if limit else out
        if not self.dir:
            return []
        # disk replay: lines queued at the barrier are in _mem but may
        # not be in their segments yet — force a barrier so the replay
        # below cannot miss a just-acked sibling
        self._barrier.sync()
        out = []
        start_day, start_min = _segment_name(ts_ns) if ts_ns else ("", "")
        for day in sorted(os.listdir(self.dir)):
            if day < start_day:
                continue
            day_dir = os.path.join(self.dir, day)
            if not os.path.isdir(day_dir):
                continue
            for minute in sorted(os.listdir(day_dir)):
                if day == start_day and minute[:-4] < start_min:
                    continue
                with open(os.path.join(day_dir, minute),
                          encoding="utf-8") as f:
                    for line in f:
                        try:
                            e = json.loads(line)
                        except ValueError:
                            continue  # torn tail write after a crash
                        if e.get("tsNs", 0) > ts_ns:
                            out.append(strip_wal_fields(e))
                            if limit and len(out) >= limit:
                                return out
        return out

    def last_ts(self) -> int:
        with self._lock:
            return self._last_ts

    def _scan_last_ts(self) -> int:
        """Resume the monotonic stamp clock from the newest persisted
        event (so a restarted filer can't stamp below history)."""
        days = sorted((d for d in os.listdir(self.dir)
                       if os.path.isdir(os.path.join(self.dir, d))),
                      reverse=True)
        for day in days:
            day_dir = os.path.join(self.dir, day)
            for minute in sorted(os.listdir(day_dir), reverse=True):
                last = 0
                with open(os.path.join(day_dir, minute),
                          encoding="utf-8") as f:
                    for line in f:
                        try:
                            last = max(last, json.loads(line)
                                       .get("tsNs", 0))
                        except ValueError:
                            continue
                if last:
                    return last
        return 0

    def close(self) -> None:
        if self.dir:
            self._barrier.sync()   # drain queued lines before closing
        # the segment fd is owned by barrier leaders (serialized by
        # the barrier, not by self._lock); after the final sync above
        # no leader is active
        if self._open_fd is not None:
            os.close(self._open_fd)
            self._open_fd = None
            self._open_name = None
        if self._wm_fd is not None:
            try:
                os.close(self._wm_fd)
            except OSError:
                pass
            self._wm_fd = None
