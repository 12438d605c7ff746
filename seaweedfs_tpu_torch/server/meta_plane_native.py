"""The filer's native meta plane (native/meta_plane.cc), the port's copy
of `seaweedfs_tpu/server/meta_plane_native.py`.

The filer's second implementation of the plain-file WRITE surface: a
C++ epoll loop that parses the PUT, uploads the single chunk straight to
the volume write plane (C++ to C++, pipelined persistent connections),
frames the metalog WAL line byte-identically to `MetaLog.append_raw`,
lands the batch with one O_APPEND write per segment run, publishes the
watermark, and acks `201 {"name":..,"size":..}`, with no Python per
request.

By protocol the plane is just another SIBLING WRITER over the shared
metalog dir: it owns a wid and a watermark file minted through
`meta_log.alloc_writer_identity`, and its lines reach the Python meta
plane (overlay follower, flock-elected applier, checkpoint) exactly as
another filer's would.  This wrapper supplies what the C++ loop cannot
cheaply do itself:

* a FEEDER thread that batches master assigns (`count=256`) and pushes
  "addr fid" pairs into the plane's pool;
* DIRECTORY knowledge: the filer's own events (`Filer.subscribe`) and
  the follower's sibling events (`MetaPlane.sink`) mark fresh
  directories native-eligible and every path written elsewhere
  ineligible, so the plane only ever acks op="create" for provably new
  paths;
* the counters and histogram the filer renders on `/metrics`.

Failure contract: construction raises RuntimeError when the library
does not build or start (the filer logs it, counts it, and serves every
write from Python); at run time every ineligible or doomed request
answers the 404 fallback and the client retries on the Python port.
SIGKILL at any instant leaves acked lines durable (the ack is queued
only after write(2) returned) and unacked lines absent or torn; a torn
tail is the WAL's normal crash debris, which the follower and the
applier skip.  The plane's per-request record ring is left undrained.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

from .. import native, operation
from ..filer.meta_log import alloc_writer_identity
from ..storage.types import FileId, parse_needle_id_cookie

# ack latency histogram bucket bounds (meta_plane.cc kLatBuckets), in
# seconds: rendered on /metrics as filer_meta_plane_native_ack_seconds
ACK_BUCKETS_S = (1e-6, 2e-6, 5e-6, 1e-5, 2e-5, 5e-5, 1e-4, 2e-4,
                 5e-4, 1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 1e-1, 1.0)

# feeder targets: refill toward HIGH once the pool drops under LOW.  One
# assign(count=_ASSIGN_N) buys _ASSIGN_N native acks.
_POOL_LOW = 192
_POOL_HIGH = 512
_ASSIGN_N = 256

STATS_KEYS = ("requests", "fallbacks", "fid_misses", "wal_errors",
              "upstream_errors", "parse_ns", "upload_ns", "wal_ns",
              "wal_batches", "wal_lines")


def native_meta_plane_enabled() -> "bool | None":
    """SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE: '0' forces off, '1' forces
    on, unset/other = auto (on when the meta plane is on and the library
    builds)."""
    v = os.environ.get("SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE", "")
    if v == "0":
        return False
    if v == "1":
        return True
    return None


class NativeMetaPlane:
    """One native meta-plane server bound to <host>:<ephemeral>,
    appending into `meta_log_dir` as its own writer instance."""

    def __init__(self, meta_log_dir: str, master: str,
                 host: str = "127.0.0.1", collection: str = "",
                 replication: str = "",
                 feed_interval: float = 0.05):
        self._lib = native.load_meta_plane()
        if self._lib is None:
            raise RuntimeError(
                "native meta plane unavailable: " +
                native.BUILD_INFO.get("meta_plane", {}).get("error", "?"))
        self.wid, self.wm_path = alloc_writer_identity(meta_log_dir)
        port = ctypes.c_int(0)
        self._h = self._lib.mp_start(
            host.encode(), 0, meta_log_dir.encode(),
            self.wid.encode(), self.wm_path.encode(),
            ctypes.byref(port))
        if self._h < 0:
            raise RuntimeError("native meta plane failed to start")
        self.host = host
        self.port = port.value
        self.master = master
        self.collection = collection
        self.replication = replication
        self._stop = threading.Event()
        self._armed = False
        self._feeder = threading.Thread(
            target=self._feed_loop, args=(feed_interval,), daemon=True,
            name="filer-meta-plane-feeder")
        self._feeder.start()

    # -- arming ---------------------------------------------------------

    def arm(self, on: bool = True) -> None:
        """Disarmed, the listener stays up but every request answers the
        404 fallback (clients keep their sockets; Python serves)."""
        self._armed = bool(on)
        self._lib.mp_arm(self._h, 1 if on else 0)

    @property
    def armed(self) -> bool:
        return self._armed

    # -- directory knowledge (the filer's listener and the plane's sink) --

    def mark_dir(self, path: str) -> None:
        """`path` was created fresh (op=create, isDirectory): its direct
        children become native-eligible."""
        try:
            self._lib.mp_mark_dir(self._h, path.encode())
        except (OSError, UnicodeEncodeError):
            pass

    def mark_path(self, path: str) -> None:
        """`path` was written through another route: native writes to it
        fall back from now on (overwrites are Python's)."""
        try:
            self._lib.mp_mark_path(self._h, path.encode())
        except (OSError, UnicodeEncodeError):
            pass

    def clear_dirs(self) -> None:
        """A directory delete or rename anywhere drops all knowledge:
        rare, always safe, as Filer._known_dirs.clear()."""
        self._lib.mp_clear_dirs(self._h)

    def on_event(self, event: dict) -> None:
        """Filer listener (Filer.subscribe): this process's own
        Python-path events.  Knowledge is advisory: a miss costs a
        fallback, never a bad ack."""
        self._learn(event)

    def _learn(self, ev: dict) -> None:
        op = ev.get("op", "")
        new = ev.get("newEntry")
        old = ev.get("oldEntry")
        if op in ("delete", "rename") and (
                (new or {}).get("isDirectory") or
                (old or {}).get("isDirectory")):
            self.clear_dirs()
        if not new:
            return
        path = new.get("fullPath", "")
        if not path:
            return
        if new.get("isDirectory"):
            # only a FRESH create proves the directory empty: an update
            # (old != None) may shadow existing children
            if op == "create" and old is None:
                self.mark_dir(path)
        else:
            self.mark_path(path)

    def on_follower_events(self, events) -> None:
        """MetaPlane.sink: the follower's poll batches, (event, raw_new,
        pos, wid) tuples for every sibling writer's WAL line, this
        plane's own included (mark_path of a name the C++ loop already
        holds is harmless)."""
        for item in events:
            try:
                self._learn(item[0] if isinstance(item, tuple)
                            else item)
            except (AttributeError, TypeError, ValueError):
                pass     # a malformed line: its path stays fallback

    # -- fid feeder -----------------------------------------------------

    def _feed_once(self) -> None:
        level = self._lib.mp_fid_level(self._h)
        if level < 0 or level >= _POOL_LOW or not self._armed:
            return
        lines = []
        while level + len(lines) < _POOL_HIGH:
            a = operation.assign(self.master, count=_ASSIGN_N,
                                 collection=self.collection,
                                 replication=self.replication)
            addr = operation._plane_addr(a.url, "writePlanePort")
            if addr is None:
                return  # no volume plane to pipe into; stay dry
            vid_s, _, kc = a.fid.partition(",")
            key, cookie = parse_needle_id_cookie(kc)
            vid = int(vid_s)
            n = max(1, int(a.count or 1))
            lines.extend(f"{addr} {FileId(vid, key + i, cookie)}"
                         for i in range(n))
        if lines:
            self._lib.mp_feed_fids(
                self._h, ("\n".join(lines) + "\n").encode())

    def _feed_loop(self, interval: float) -> None:
        # exponential backoff on a failed feed: an unreachable master
        # costs a connect attempt every couple of seconds, not twenty a
        # second; success snaps back to the base interval
        wait = interval
        while not self._stop.wait(wait):
            try:
                self._feed_once()
                wait = interval
            except Exception as e:  # noqa: BLE001 — a dead master
                # means a dry pool (= fallbacks), never a dead feeder
                if wait == interval:
                    print(f"filer: meta plane fid feed failed: {e!r}",
                          file=sys.stderr)
                wait = min(max(wait * 2, interval), 2.0)

    # -- telemetry ------------------------------------------------------

    def requests(self) -> int:
        return self._lib.mp_requests(self._h)

    def fid_level(self) -> int:
        return self._lib.mp_fid_level(self._h)

    def stats(self) -> dict:
        out = (ctypes.c_ulonglong * 16)()
        n = self._lib.mp_stats(self._h, out)
        if n <= 0:
            return {k: 0 for k in STATS_KEYS}
        return {k: int(out[i]) for i, k in enumerate(STATS_KEYS)}

    def ack_histogram(self) -> "tuple[list[int], int, float]":
        """(cumulative bucket counts aligned with ACK_BUCKETS_S plus an
        +Inf cell, total count, sum in seconds)."""
        out = (ctypes.c_ulonglong * 20)()
        cells = self._lib.mp_latency(self._h, out)
        if cells <= 0:
            return [], 0, 0.0
        buckets = [int(out[i]) for i in range(cells + 1)]
        return buckets, int(out[cells + 1]), out[cells + 2] / 1e9

    def stop(self) -> None:
        """The feeder first, then the native server: mp_stop frees the
        server, so no wrapper thread may still be inside an mp_* call."""
        if self._h < 0:
            return
        self._stop.set()
        self._feeder.join(timeout=5)
        self._lib.mp_stop(self._h)
        self._h = -1
