"""The native write plane (`native/write_plane.cc`), the port's copy of
`seaweedfs_tpu/server/write_plane.py`: a C++ epoll loop that receives an
upload, serialises the v3 needle record, appends it to the `.dat` through
its own fd and acks it, with no Python on the request's path.

- While a volume is attached, the plane owns the `.dat` tail.  Python
  appends (overwrites, tombstones, replicated and repair writes) go
  through `append()`, under the same per-volume mutex, so records never
  interleave.
- Completed native appends are journaled; `drain()` hands them back for
  the needle map and the `.idx` (the `.dat` is the log, the `.idx` a
  checkpoint; `Volume._replay_dat_tail` recovers after a crash).
- Anything not plain (a named or mimed upload, an overwrite of a key the
  plane has seen, a volume it does not own) answers 404, and the client
  falls back to the server's HTTP port.
- Durability: on the default tier the plane acks after write(2), so an
  acked record is in the page cache and survives the process being
  killed, the guarantee the Python `write_needle` gives with its
  barrier's flush.  On the `-fsync` tier the plane parks each ack on the
  volume's open flush epoch; the handshake thread (`_epoch_loop`) takes
  the epoch (`wp_wait_epoch`), runs `on_epoch(vid, epoch)` (the volume
  server's: the volume's `CommitBarrier`, whose flush fsyncs the
  `.dat`) and releases the parked acks (`wp_epoch_done`): group commit
  across the language boundary.  A plane without the handshake (no
  `on_epoch`, or a library without `wp_wait_epoch`) refuses `-fsync`
  volumes, which stay on the Python path.
- The plane keeps a ring of per-request records that overwrites its
  oldest entry; the port has no flight recorder to feed, so the ring is
  left undrained (ROADMAP A), which never blocks an ack.
"""

from __future__ import annotations

import array
import ctypes
import sys
import threading
from collections import namedtuple

from .. import native

# bounds of the ack latency histogram (write_plane.cc kLatBuckets), in
# seconds: /metrics renders it as write_plane_ack_seconds
ACK_BUCKETS_S = (1e-6, 2e-6, 5e-6, 1e-5, 2e-5, 5e-5, 1e-4, 2e-4,
                 5e-4, 1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 1e-1, 1.0)

NativeWrite = namedtuple(
    "NativeWrite", "key offset append_ns vid cookie size data_len")


class WritePlane:
    """One native write-plane server bound to <host>:<ephemeral>.
    `on_tick` runs on a pump thread every `TICK_S` seconds (and once
    more at stop) to drain the attached volumes' journals;
    `on_epoch(vid, epoch)` runs on the handshake thread and must make
    the volume's acked bytes as durable as its barrier promises; the
    acks parked on the epoch are released only when it returns."""

    _DRAIN_CAP = 4096
    TICK_S = 0.025
    EPOCH_WAIT_MS = 200

    def __init__(self, host: str = "127.0.0.1", on_tick=None,
                 on_epoch=None):
        self._lib = native.load_write_plane()
        if self._lib is None:
            raise RuntimeError(
                "native write plane unavailable: "
                f"{native.BUILD_INFO['write_plane'].get('error')}")
        port = ctypes.c_int(0)
        self._h = self._lib.wp_start(host.encode(), 0, ctypes.byref(port))
        if self._h < 0:
            raise RuntimeError("write plane failed to start")
        self.host = host
        self.port = port.value
        self._on_tick = on_tick
        self._on_epoch = on_epoch
        self._stop = threading.Event()
        self._threads: "list[threading.Thread]" = []
        self._epoch_lock = threading.Lock()
        self._epoch_started = False
        # epochs released, epochs whose barrier failed, and -fsync
        # volumes refused for want of a handshake
        self.epochs = 0
        self.epoch_failures = 0
        self.fsync_refused = 0
        if on_tick is not None:
            t = threading.Thread(target=self._pump_loop,
                                 name="write-plane-pump", daemon=True)
            t.start()
            self._threads.append(t)

    # -- attachment (called by storage.Volume under its lock) -------------

    def can_handshake(self) -> bool:
        """Whether this plane can run the -fsync tier's epoch handshake:
        the library binds it and the owner gave an `on_epoch`."""
        return self._on_epoch is not None and \
            bool(getattr(self._lib, "epoch_handshake", False))

    def add_volume(self, vid: int, dat_path: str, tail: int,
                   last_append_ns: int, fsync: bool = False) -> bool:
        """Attach a volume's `.dat`.  An -fsync volume needs the epoch
        handshake: without it the plane refuses the volume (logged and
        counted in `fsync_refused`), never attaching it as a volume
        whose acks skip the fsync."""
        if fsync:
            if not self.can_handshake():
                self.fsync_refused += 1
                print(f"write plane: -fsync volume {vid} stays on the "
                      f"Python path: no epoch handshake", file=sys.stderr)
                return False
            # the handshake thread starts with the first -fsync volume
            self._ensure_epoch_thread()
        return self._lib.wp_add_volume(self._h, vid, dat_path.encode(),
                                       tail, last_append_ns,
                                       1 if fsync else 0) == 0

    def _ensure_epoch_thread(self) -> None:
        with self._epoch_lock:
            if self._epoch_started:
                return
            self._epoch_started = True
            t = threading.Thread(target=self._epoch_loop,
                                 name="write-plane-epoch", daemon=True)
            t.start()
            self._threads.append(t)

    def mark_keys(self, vid: int, keys) -> None:
        """Seed the plane's seen-key set (every one falls back to
        Python)."""
        a = array.array("Q", keys)
        if a:
            buf = (ctypes.c_ulonglong * len(a)).from_buffer(a)
            self._lib.wp_mark_keys(self._h, vid, buf, len(a))

    def arm(self, vid: int) -> bool:
        """Open the volume to native writes: strictly after mark_keys, or
        an overwrite could slip past the seen-key check."""
        return self._lib.wp_arm(self._h, vid) == 0

    def remove_volume(self, vid: int) -> None:
        self._lib.wp_remove_volume(self._h, vid)

    def append(self, vid: int, key: int, record: bytes,
               append_ns: int) -> int:
        """Append a serialised record through the plane's tail mutex:
        its byte offset, or -1 (the volume is not attached)."""
        return self._lib.wp_append(self._h, vid, key, record,
                                   len(record), append_ns)

    def drain(self, vid: int) -> "list[NativeWrite]":
        out: list[NativeWrite] = []
        buf = (native.WpEntry * self._DRAIN_CAP)()
        while True:
            n = self._lib.wp_drain(self._h, vid, buf, self._DRAIN_CAP)
            for i in range(n):
                e = buf[i]
                out.append(NativeWrite(e.key, e.offset, e.append_ns,
                                       e.vid, e.cookie, e.size,
                                       e.data_len))
            if n < self._DRAIN_CAP:
                return out

    def pending(self, vid: int) -> int:
        return self._lib.wp_pending(self._h, vid)

    # -- telemetry ----------------------------------------------------------

    def requests(self) -> int:
        return self._lib.wp_requests(self._h)

    def fallbacks(self) -> int:
        return self._lib.wp_fallbacks(self._h)

    def ack_histogram(self) -> "tuple[list[int], int, float]":
        """(cumulative counts at each ACK_BUCKETS_S bound and at +Inf,
        the count, the sum in seconds)."""
        out = (ctypes.c_ulonglong * 20)()
        cells = self._lib.wp_latency(self._h, out)
        return ([int(out[i]) for i in range(cells)], int(out[cells]),
                out[cells + 1] / 1e9)

    # -- the pump -------------------------------------------------------------

    def _pump_loop(self) -> None:
        while not self._stop.wait(self.TICK_S):
            try:
                self._on_tick()
            except Exception:  # noqa: BLE001 — the journal's upkeep
                pass           # must never end the pump
        try:
            self._on_tick()    # what landed since the last tick
        except Exception:  # noqa: BLE001
            pass

    def _epoch_loop(self) -> None:
        """The -fsync handshake: take a volume's flush epoch, run its
        barrier, release the acks parked on it.  An epoch whose barrier
        raised is not released (logged and counted in `epoch_failures`):
        its acks wait for the volume's next epoch, whose barrier covers
        their bytes too, or their client times out unacked.  (The JAX
        plane releases them after a failed barrier.)"""
        vid = ctypes.c_uint(0)
        epoch = ctypes.c_ulonglong(0)
        while not self._stop.is_set():
            if not self._lib.wp_wait_epoch(self._h, self.EPOCH_WAIT_MS,
                                           ctypes.byref(vid),
                                           ctypes.byref(epoch)):
                continue
            try:
                self._on_epoch(vid.value, epoch.value)
            except Exception as e:  # noqa: BLE001 — the loop must live
                self.epoch_failures += 1
                print(f"write plane: epoch flush of volume {vid.value} "
                      f"failed, its acks stay parked: {e!r}",
                      file=sys.stderr)
                continue
            self.epochs += 1
            self._lib.wp_epoch_done(self._h, vid.value, epoch.value)

    def stop(self) -> None:
        """The threads first, then the native server: wp_stop frees it,
        so no thread may still be inside a wp_* call."""
        if self._h < 0:
            return
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._lib.wp_stop(self._h)
        self._h = -1
