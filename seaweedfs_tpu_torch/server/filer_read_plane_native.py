"""The filer's native read plane (native/filer_read_plane.cc), the
port's copy of `seaweedfs_tpu/server/filer_read_plane_native.py`.

The read sibling of server/meta_plane_native.py: a C++ epoll loop that
serves an eligible warm `GET /path` with no Python per request: parse,
C-side entry-map lookup, chunk fetch from the volume's native read plane
over a persistent plane socket, 200 to the client.  Everything else
answers 404 `{"error":"read plane fallback"}` and the client replays it
on the Python filer port.

The C side holds only ADVISORY knowledge: path -> (volume read-plane
addr, fid, size, mime).  This wrapper supplies what the C++ loop cannot
cheaply do itself:

* COHERENCE: every mutation event, the filer's own (`Filer.subscribe`)
  and every sibling writer's (the `MetaPlane.sink` follower tap),
  invalidates the touched paths SYNCHRONOUSLY.  Fills are fenced by the
  plane's generation clock (`begin_fill` token taken before the entry
  was read): a fill that lost a race with a later invalidation is
  refused by the C side, so the map can only under-serve (fallback),
  never serve a pre-overwrite chunk.
* FILLS: a background thread resolves each fill's volume read-plane
  address (vid -> its locations from the follow stream's pushed map, or
  a fresh master lookup where no stream is synced -> the server's
  `/status` readPlanePort, memoized for `_ADDR_TTL_S`) and registers the
  entry.
  Fills come from mutation events (the write told us the geometry) and
  from the Python read path (a warm read that passed the eligibility
  rule registers the path it just served).
* the counters and histogram the filer renders on `/metrics`.

A stale registration (the needle's volume was EC-encoded, or its server
stopped) costs one fallback: the volume's read plane answers 404 for a
volume it no longer holds, or the connection fails, and the C side
drops the entry and answers the fallback body without having promised
any bytes.  The miss also empties the address memo, so the Python
replay's refill resolves its volume afresh, and a volume the master
serves as EC shards gets no fill: its files stay on the Python front.
The plane's per-request record ring is drained by `start_record_drain`
into `plane_stage_seconds{plane="filer_read"}` and the flight recorder.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
import time

from .. import native, operation, security
from .meta_plane_native import note_stood_down
from ..filer.filer import CHUNK_SIZE
from ..util import wlog

# response latency histogram bucket bounds (filer_read_plane.cc
# kLatBuckets), in seconds: rendered on /metrics as
# filer_read_plane_native_response_seconds
RESPONSE_BUCKETS_S = (1e-6, 2e-6, 5e-6, 1e-5, 2e-5, 5e-5, 1e-4, 2e-4,
                      5e-4, 1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 1e-1,
                      1.0)

# the flight ring's label tables
RECORD_STAGES = ("parse", "lookup", "fetch", "send")
RECORD_FALLBACKS = ("none", "ineligible", "unknown_path", "stale",
                    "upstream")

STATS_KEYS = ("requests", "fallbacks", "stale_misses",
              "upstream_errors", "parse_ns", "lookup_ns", "fetch_ns",
              "send_ns")

_ADDR_TTL_S = 10.0      # vid -> read-plane-addr memo lifetime
_FILL_QUEUE_MAX = 4096  # beyond this, fills drop (reads just fall back)


def native_read_plane_enabled() -> "bool | None":
    """SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE: '0' forces off, '1' forces
    on, unset/other = auto (on when the library builds)."""
    v = os.environ.get("SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE", "")
    if v == "0":
        return False
    if v == "1":
        return True
    return None


def _path_bytes_ok(path: str) -> bool:
    """The C side's request-target byte filter: only fill paths the
    plane could be asked for verbatim (printable ASCII, no quote,
    backslash, percent, query or fragment: a percent in the URL means
    the Python front sees a DIFFERENT, decoded path)."""
    return all(0x21 <= ord(ch) <= 0x7E and ch not in '"\\%?#'
               for ch in path)


class NativeReadPlane(native.RecordDrain):
    """One native filer read plane bound to <host>:<ephemeral>, fetching
    chunks from volume read planes located through `master`."""

    # plane label "filer_read": the volume read plane has "read", and
    # the two share stage names
    _REC = ("frp", "filer", "filer_read", "GET")
    RECORD_STAGES = RECORD_STAGES
    RECORD_FALLBACKS = RECORD_FALLBACKS

    def __init__(self, master: str, host: str = "127.0.0.1"):
        self._lib = native.load_filer_read_plane()
        if self._lib is None:
            raise RuntimeError(
                "native read plane unavailable: " +
                native.BUILD_INFO.get("filer_read_plane", {}).get(
                    "error", "?"))
        port = ctypes.c_int(0)
        self._h = self._lib.frp_start(host.encode(), 0,
                                      ctypes.byref(port))
        if self._h < 0:
            raise RuntimeError("native read plane failed to start")
        self.host = host
        self.port = port.value
        self.master = master
        self._armed = False
        self._addr_memo: "dict[int, tuple[str | None, float]]" = {}
        self._misses_seen = 0   # stale + upstream misses the memo saw
        # the servers whose /status gave the memo's addresses
        self._addr_urls: "set[str]" = set()
        self._fills: "queue.Queue" = queue.Queue(_FILL_QUEUE_MAX)
        self._stop_evt = threading.Event()
        self._filler = threading.Thread(target=self._fill_loop,
                                        daemon=True,
                                        name="filer-read-plane-filler")
        self._filler.start()

    # -- arming ---------------------------------------------------------

    def arm(self, on: bool = True) -> None:
        """Disarmed, the listener stays up but every request answers the
        404 fallback (clients keep their sockets; Python serves)."""
        self._armed = bool(on)
        self._lib.frp_arm(self._h, 1 if on else 0)

    @property
    def armed(self) -> bool:
        return self._armed

    # -- coherence (the filer's listener and the plane's sink) ----------

    def begin_fill(self) -> int:
        """Generation token for a warm fill; take it BEFORE reading the
        entry that will be registered: the C side refuses the fill if
        any invalidation of the path lands after this point."""
        return int(self._lib.frp_gen(self._h))

    def invalidate(self, path: str) -> None:
        try:
            self._lib.frp_invalidate(self._h, path.encode())
        except (OSError, UnicodeEncodeError):
            pass

    def on_event(self, event: dict) -> None:
        """Filer listener (Filer.subscribe): this process's own mutation
        events.  The invalidation completes before the write's ack
        returns to the client, so a reader who saw the ack is never
        served pre-mutation bytes; the refill rides the fill queue
        behind its fence token."""
        self._learn(event)

    def _learn(self, ev: dict) -> None:
        new = ev.get("newEntry")
        old = ev.get("oldEntry")
        for side in (new, old):
            p = (side or {}).get("fullPath", "")
            if p:
                self.invalidate(p)
        if not new or new.get("isDirectory") or \
                ev.get("op", "") not in ("create", "update"):
            return
        fill = self._eligible_json(new)
        if fill is None:
            return
        # token AFTER the invalidation above: a later mutation still
        # fences this fill out, an earlier one no longer can
        token = self.begin_fill()
        self._enqueue_fill(new.get("fullPath", ""), fill, token)

    def on_follower_events(self, events) -> None:
        """MetaPlane.sink: the follower's poll batches, (event, raw_new,
        pos, wid) tuples for every sibling writer's WAL line, the native
        meta plane's acks included: that is how a natively written file
        becomes natively readable."""
        for item in events:
            try:
                self._learn(item[0] if isinstance(item, tuple)
                            else item)
            except (AttributeError, TypeError, ValueError):
                pass     # a malformed line: its path stays fallback

    # -- fills ----------------------------------------------------------

    def _eligible_json(self, new: dict) -> "tuple[str, int, str] | None":
        """(fid, size, mime) when the event-JSON entry is servable
        natively: exactly one whole-file plain chunk, no TTL, no symlink,
        no extended attributes."""
        chunks = new.get("chunks") or []
        if len(chunks) != 1:
            return None
        c = chunks[0]
        size = int(c.get("size", 0))
        if int(c.get("offset", 0)) != 0 or size <= 0 or \
                size > CHUNK_SIZE:
            return None
        attrs = new.get("attributes") or {}
        if int(attrs.get("ttlSec", 0) or 0) != 0:
            return None
        if attrs.get("symlinkTarget", ""):
            return None
        if new.get("extended"):
            return None
        fid = c.get("fileId", "")
        if not fid or "," not in fid:
            return None
        return fid, size, attrs.get("mime", "")

    def eligible_entry(self, entry) -> "tuple[str, int, str] | None":
        """The same rule over a live filer Entry (the Python read path's
        warm fill)."""
        if entry.is_directory or len(entry.chunks) != 1:
            return None
        c = entry.chunks[0]
        if c.offset != 0 or c.size <= 0 or c.size > CHUNK_SIZE:
            return None
        a = entry.attributes
        if a.ttl_sec or a.symlink_target or entry.extended:
            return None
        if not c.file_id or "," not in c.file_id:
            return None
        return c.file_id, c.size, a.mime

    def warm_fill(self, path: str, entry, token: int) -> None:
        """Register `path` after the Python front served it; `token` must
        come from begin_fill() BEFORE the entry was looked up."""
        fill = self.eligible_entry(entry)
        if fill is not None:
            self._enqueue_fill(path, fill, token)

    def _enqueue_fill(self, path: str, fill, token: int) -> None:
        if not path or not _path_bytes_ok(path):
            return
        if security.current().volume_read_key:
            # a read-JWT cluster: the plane's bare volume GET would 401,
            # so it holds no entry and every GET falls back
            note_stood_down("read", "jwt")
            return
        try:
            self._fills.put_nowait((path, fill[0], fill[1], fill[2],
                                    token))
        except queue.Full:
            pass  # a dropped fill = fallbacks until re-read, never stale

    def _addr_for_vid(self, vid: int) -> "str | None":
        """The read-plane address of the server holding volume `vid`, or
        None where no volume read plane can serve it: a dead master, a
        volume the master serves as EC shards (the volume read plane
        holds only normal volumes), or no server with a read plane."""
        st = self.stats()
        misses = st["stale_misses"] + st["upstream_errors"]
        if misses != self._misses_seen:
            # a registration proved stale: every address may be, and so
            # may the /status it came from (a restarted server's plane
            # listens on another port)
            self._misses_seen = misses
            self._addr_memo.clear()
            for url in self._addr_urls:
                operation._invalidate_status(url)
            self._addr_urls.clear()
        memo = self._addr_memo
        hit = memo.get(vid)
        now = time.monotonic()
        if hit is not None and hit[1] > now:
            return hit[0]
        addr = None
        try:
            # the pushed map carries no EC shards: ask the master
            ec = operation.master_json(
                self.master, "GET", f"/dir/ec_lookup?volumeId={vid}",
                timeout=5.0)
            if "error" in ec:
                # the pushed map is current (a moved or encoded volume
                # leaves it at its heartbeat); the TTL'd cache is not
                f = operation.follower(self.master)
                locs = f.get_locations(vid) if f is not None else None
                if locs is None:
                    locs = operation.lookup(self.master, vid,
                                            use_cache=False)
                for loc in locs:
                    addr = operation._plane_addr(loc["url"],
                                                 "readPlanePort")
                    if addr is not None:
                        self._addr_urls.add(loc["url"])
                        break
        except (OSError, LookupError, RuntimeError, ValueError):
            addr = None          # a dead master or a lost volume
        if len(memo) > 1024:
            memo.clear()
        memo[vid] = (addr, now + _ADDR_TTL_S)
        return addr

    def _fill_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                item = self._fills.get(timeout=0.2)
            except queue.Empty:
                continue
            path, fid, size, mime, token = item
            try:
                vid = int(fid.partition(",")[0])
                addr = self._addr_for_vid(vid)
                if addr is None:
                    continue  # no volume plane: the path stays fallback
                self._lib.frp_put_entry(
                    self._h, path.encode(), addr.encode(),
                    fid.encode(), (mime or "").encode(),
                    int(size), int(token))
            except Exception as e:  # noqa: BLE001 — the filler must live
                wlog.warning(f"filer: read plane fill failed: {e!r}",
                             component="filer")

    # -- telemetry ------------------------------------------------------

    def requests(self) -> int:
        return self._lib.frp_requests(self._h)

    def entries(self) -> int:
        return max(0, self._lib.frp_entries(self._h))

    def stats(self) -> dict:
        out = (ctypes.c_ulonglong * 8)()
        n = self._lib.frp_stats(self._h, out)
        if n <= 0:
            return {k: 0 for k in STATS_KEYS}
        return {k: int(out[i]) for i, k in enumerate(STATS_KEYS)}

    def response_histogram(self) -> "tuple[list[int], int, float]":
        """(cumulative bucket counts aligned with RESPONSE_BUCKETS_S plus
        an +Inf cell, total count, sum in seconds)."""
        out = (ctypes.c_ulonglong * 20)()
        cells = self._lib.frp_latency(self._h, out)
        if cells <= 0:
            return [], 0, 0.0
        buckets = [int(out[i]) for i in range(cells + 1)]
        return buckets, int(out[cells + 1]), out[cells + 2] / 1e9

    def stop(self) -> None:
        """The filler first, then the native server: frp_stop frees the
        server, so no wrapper thread may still be inside an frp_* call."""
        if self._h < 0:
            return
        self._stop_evt.set()
        self._filler.join(timeout=5)
        self._stop_record_drain()
        self._lib.frp_stop(self._h)
        self._h = -1
