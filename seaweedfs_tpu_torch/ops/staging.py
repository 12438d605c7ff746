"""Windowed, double-buffered host->device staging for the encode and
rebuild launches (the counterpart of `seaweedfs_tpu/ops/staging.py`),
for one CUDA device.

A batch ([K, W] packed 32-bit words, 4 GF bytes a word; see rs_torch)
is split into column windows of about `window_bytes()` staged bytes.
The GF apply is column-independent, so window boundaries never change
an output byte.  Three planes run at once:

    host window N+1 --memcpy, h2d--> device   (staging thread, copy stream)
    device window N --kernel, d2h--> pinned   (compute stream)
    pinned window N-1 -------------> sinks    (consumer thread)

For each window the staging thread copies the packed columns into a
pooled page-locked buffer, issues the h2d copy on the copy stream,
records an event and waits for it: that wait fences only the staging
thread, so `h2d_seconds` is the window's memcpy + transfer wall.  The
compute stream waits on the event, launches the kernel, copies the
output into a pooled pinned buffer and records an output event.  The
consumer waits on that event (`d2h_seconds`, and the dispatch-to-fetch
kernel window).  Windows in flight are bounded by a semaphore (default
2).  A window's pinned input goes back to the pool only after its output
event, and its pinned output after the consumer is done with it.

On the CPU the staging thread runs the kernel's plain version in place
of the copy and the launch, so every line of the windowing logic runs in
the CPU tests.

Knobs (the reference's names, so an operator's settings mean the same
in both packages):
  SEAWEEDFS_TPU_H2D_WINDOW_MB   staged bytes per window (default 32;
                                0 disables windowing: one-shot launch)
  SEAWEEDFS_TPU_H2D_INFLIGHT    windows in flight (default 2)

Telemetry: per-window `profiling.device_note`/`kernel_note`, and per
launch the overlap fraction (`profiling.overlap_note`): 0 when the h2d
and consume planes ran serially, 1 when the wall equals the slower
plane alone.  `snapshot()` aggregates every launch since
`reset_aggregate()`.
"""

from __future__ import annotations

import contextlib
import math
import os
import queue
import threading
import time
import weakref

import numpy as np
import torch

from .. import profiling
from . import rs_cuda

DEFAULT_WINDOW_MB = 32.0
DEFAULT_INFLIGHT = 2
# windows are whole multiples of 4 words, so every window's rows start
# 16-byte aligned and the kernel takes its uint4 path
WINDOW_WORD_MULTIPLE = 4


def window_bytes() -> int:
    """Staged bytes per window; 0 disables windowing entirely."""
    raw = os.environ.get("SEAWEEDFS_TPU_H2D_WINDOW_MB", "")
    try:
        mb = float(raw) if raw else DEFAULT_WINDOW_MB
    except ValueError:
        mb = DEFAULT_WINDOW_MB
    return max(0, int(mb * (1 << 20)))


def inflight_depth() -> int:
    try:
        d = int(os.environ.get("SEAWEEDFS_TPU_H2D_INFLIGHT",
                               str(DEFAULT_INFLIGHT)))
    except ValueError:
        d = DEFAULT_INFLIGHT
    return max(1, d)


def plan_windows(k: int, w: int, ndev: int = 1
                 ) -> "list[tuple[int, int, int]]":
    """Column-window schedule over a [k, w] packed-words batch:
    [(w0, real_words, padded_words)] tiling [0, w) in order.  The window
    width targets `window_bytes()` staged bytes, rounded up to a
    multiple of 4 words (and of ndev); padded_words rounds the (possibly
    short) tail window up to a multiple of ndev."""
    wb = window_bytes()
    if wb <= 0 or w == 0:
        return []
    q = math.lcm(WINDOW_WORD_MULTIPLE, ndev)
    win = max(1, wb // (4 * max(k, 1)))
    win = -(-win // q) * q
    out = []
    pos = 0
    while pos < w:
        n = min(win, w - pos)
        out.append((pos, n, -(-n // ndev) * ndev))
        pos += n
    return out


# -- reused host staging buffers ------------------------------------------

class BufferPool:
    """Reused host staging buffers of int32 words (page-locked for CUDA
    launches), bounded in count and bytes across all shapes with FIFO
    eviction: window tails differ per volume, so a per-shape bound
    alone would grow a long-lived worker's pinned memory without end.
    The most recently returned buffers are the likely active shapes;
    the oldest are the stale ones to drop."""

    def __init__(self, max_bufs: int = 8, max_bytes: int = 256 << 20):
        self.max_bufs = max_bufs
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._bufs: "list[tuple[bool, torch.Tensor]]" = []

    def take(self, shape: "tuple[int, int]", pinned: bool) -> torch.Tensor:
        shape = tuple(shape)
        with self._lock:
            for i, (p, b) in enumerate(self._bufs):
                if p == pinned and tuple(b.shape) == shape:
                    return self._bufs.pop(i)[1]
        return torch.empty(shape, dtype=torch.int32, pin_memory=pinned)

    def give(self, buf: torch.Tensor, pinned: bool) -> None:
        with self._lock:
            self._bufs.append((pinned, buf))
            total = self._nbytes()
            while self._bufs and (len(self._bufs) > self.max_bufs or
                                  total > self.max_bytes):
                total -= self._bufs.pop(0)[1].nbytes

    def _nbytes(self) -> int:
        return sum(b.nbytes for _, b in self._bufs)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes()

    def __len__(self) -> int:
        with self._lock:
            return len(self._bufs)


POOL = BufferPool()


# -- per-process staging accounting ---------------------------------------

class StagingStats:
    """One launch's staging ledger (a launch = one parity_lazy /
    apply_matrix_lazy batch)."""

    __slots__ = ("windows", "h2d_bytes", "h2d_seconds", "d2h_bytes",
                 "d2h_seconds", "start", "end", "overlap_fraction",
                 "overlap_numer", "overlap_denom")

    def __init__(self):
        self.windows = 0
        self.h2d_bytes = 0
        self.h2d_seconds = 0.0
        self.d2h_bytes = 0
        self.d2h_seconds = 0.0
        self.start = 0.0
        self.end = 0.0
        self.overlap_fraction = 0.0
        self.overlap_numer = 0.0
        self.overlap_denom = 0.0

    def finish(self) -> None:
        """The overlap fraction: 0 = the h2d plane and the consume plane
        (kernel remainder + d2h wait) ran strictly serially (wall == sum
        of both), 1 = fully overlapped (wall == the slower plane alone).
        numer/denom are kept so the process aggregate can weight
        launches."""
        wall = self.end - self.start
        busy = self.h2d_seconds + self.d2h_seconds
        headroom = busy - max(self.h2d_seconds, self.d2h_seconds)
        if headroom > 1e-9:
            self.overlap_numer = max(0.0, min(busy - wall, headroom))
            self.overlap_denom = headroom
            self.overlap_fraction = self.overlap_numer / headroom
        else:
            self.overlap_numer = self.overlap_denom = 0.0
            self.overlap_fraction = 0.0


_agg_lock = threading.Lock()
_agg = {"launches": 0, "windows": 0, "h2d_bytes": 0,
        "h2d_seconds": 0.0, "d2h_bytes": 0, "d2h_seconds": 0.0,
        "overlap_numer": 0.0, "overlap_denom": 0.0}


def reset_aggregate() -> None:
    with _agg_lock:
        for k in _agg:
            _agg[k] = 0 if isinstance(_agg[k], int) else 0.0


def _note_launch(s: StagingStats) -> None:
    """Fold one finish()ed launch into the process aggregate."""
    with _agg_lock:
        _agg["launches"] += 1
        _agg["windows"] += s.windows
        _agg["h2d_bytes"] += s.h2d_bytes
        _agg["h2d_seconds"] += s.h2d_seconds
        _agg["d2h_bytes"] += s.d2h_bytes
        _agg["d2h_seconds"] += s.d2h_seconds
        _agg["overlap_numer"] += s.overlap_numer
        _agg["overlap_denom"] += s.overlap_denom


def snapshot() -> dict:
    """Aggregate of every windowed launch since the last
    reset_aggregate(): windows staged, achieved staged h2d and d2h GB/s,
    byte-weighted overlap fraction."""
    with _agg_lock:
        a = dict(_agg)
    a["h2d_gbps"] = round(a["h2d_bytes"] / a["h2d_seconds"] / 1e9, 3) \
        if a["h2d_seconds"] > 0 else 0.0
    a["d2h_gbps"] = round(a["d2h_bytes"] / a["d2h_seconds"] / 1e9, 3) \
        if a["d2h_seconds"] > 0 else 0.0
    a["overlap_fraction"] = round(
        a["overlap_numer"] / a["overlap_denom"], 3) \
        if a["overlap_denom"] > 0 else 0.0
    return a


# -- the windowed launch ---------------------------------------------------

class _StagingError(Exception):
    """Internal: the launch was aborted before all windows staged."""


class _Stager:
    """The staging thread's whole world: tables, input batch, streams,
    queues, stats.  A separate object from the consumer-facing
    WindowedLaunch so the running thread holds no reference to the
    handle: a handle dropped unconsumed is collected, its
    weakref.finalize stops the thread on its next 0.2 s tick."""

    def __init__(self, tables: torch.Tensor, flat32: np.ndarray,
                 out_rows: int, device: torch.device, streams):
        self.tables = tables
        self.flat = flat32
        self.rows = out_rows
        self.device = device
        self.copy_stream, self.compute_stream = streams
        self.slots = threading.Semaphore(inflight_depth())
        self.ready: "queue.Queue" = queue.Queue()
        self.stop = threading.Event()
        self.errors: "list[BaseException]" = []
        self.stats = StagingStats()
        self.stats.start = time.perf_counter()

    def run(self, plan) -> None:
        k = self.flat.shape[0]
        cuda = self.device.type == "cuda"
        try:
            # CUDA's current device is per thread, and this thread's
            # starts at 0: the codec's device must be current for the
            # launches and allocations below (see rs_cuda's wrappers)
            with (torch.cuda.device(self.device) if cuda
                  else contextlib.nullcontext()):
                for (w0, n, npad) in plan:
                    while not self.slots.acquire(timeout=0.2):
                        if self.stop.is_set():
                            raise _StagingError()
                    if self.stop.is_set():
                        raise _StagingError()
                    buf = POOL.take((k, npad), pinned=cuda)
                    t0 = time.perf_counter()
                    # pad columns (npad > n) are left dirty: the apply is
                    # column-independent and the consumer cuts them off
                    buf[:, :n].copy_(
                        torch.from_numpy(self.flat[:, w0:w0 + n]))
                    if cuda:
                        with torch.cuda.stream(self.copy_stream):
                            dev = buf.to(self.device, non_blocking=True)
                            staged = torch.cuda.Event()
                            staged.record(self.copy_stream)
                        staged.synchronize()
                    else:
                        dev = buf
                    dt = time.perf_counter() - t0
                    self.stats.windows += 1
                    self.stats.h2d_bytes += buf.nbytes
                    self.stats.h2d_seconds += dt
                    profiling.device_note("h2d", buf.nbytes, dt)
                    t_dispatch = time.perf_counter()
                    if cuda:
                        s = self.compute_stream
                        s.wait_event(staged)
                        # made on the copy stream, read on the compute one
                        dev.record_stream(s)
                        out = rs_cuda.gf_apply_matrix_words(
                            self.tables, dev, stream=s)
                        host = POOL.take((self.rows, npad), pinned=True)
                        with torch.cuda.stream(s):
                            host.copy_(out, non_blocking=True)
                            done = torch.cuda.Event()
                            done.record(s)
                        self.ready.put((w0, n, buf, host, done,
                                        t_dispatch, (dev, out)))
                    else:
                        out = rs_cuda.gf_apply_matrix_words(self.tables,
                                                            dev)
                        self.ready.put((w0, n, buf, out, None, t_dispatch,
                                        ()))
        except _StagingError:
            pass
        except BaseException as e:  # noqa: BLE001 — re-raised by the
            self.errors.append(e)   # consumer
        finally:
            self.ready.put(None)

    def release(self, item) -> None:
        """Give a window's buffers back once the device is done with
        them (its output event)."""
        _w0, _n, buf, host, done, _t, _keep = item
        if done is not None:
            done.synchronize()
        cuda = done is not None
        POOL.give(buf, pinned=cuda)
        if cuda:
            POOL.give(host, pinned=True)


class WindowedLaunch:
    """One double-buffered staged kernel launch over a [K, W] packed
    batch (int32 words), applying `tables` ([R*K*8], on `device`).

    The staging thread starts at once.  `windows()` yields
    `(byte0, uint8[rows, real_bytes])` in order; the fetch of window k
    overlaps the staging of k+1 and k+2 (depth permitting).

    Aliasing contract (as rs_torch's lazy handles): the caller may
    recycle `flat32` only after the last window is consumed or the
    launch is aborted."""

    def __init__(self, tables: torch.Tensor, flat32: np.ndarray,
                 out_rows: int, nbytes: int, device: torch.device,
                 op: str = "encode", streams=(None, None)):
        k, w = flat32.shape
        self._rows = out_rows
        self._nbytes = nbytes
        self._op = op  # telemetry label: "encode" or "rebuild"
        self._consumed = False
        self._closed = False
        self._s = _Stager(tables, flat32, out_rows, device, streams)
        # dropped-handle backstop: the thread references only the _Stager
        weakref.finalize(self, self._s.stop.set)
        self._t = threading.Thread(target=self._s.run,
                                   args=(plan_windows(k, w),),
                                   daemon=True, name="h2d-stager")
        self._t.start()

    @property
    def stats(self) -> StagingStats:
        return self._s.stats

    def windows(self):
        """Yield (byte0, uint8[rows, real_bytes]) in launch order; each
        chunk is valid until the next one is asked for.  Drains every
        window; raises the stager's error, if it died, after the drain.
        """
        if self._consumed:
            raise RuntimeError("WindowedLaunch consumed twice")
        self._consumed = True
        s = self._s
        try:
            while True:
                item = s.ready.get()
                if item is None:
                    break
                w0, n, buf, host, done, t_dispatch, _keep = item
                t0 = time.perf_counter()
                if done is not None:
                    done.synchronize()
                dt = time.perf_counter() - t0
                cuda = done is not None
                POOL.give(buf, pinned=cuda)   # its output event is past
                s.slots.release()
                s.stats.d2h_bytes += host.nbytes
                s.stats.d2h_seconds += dt
                profiling.device_note("d2h", host.nbytes, dt)
                profiling.kernel_note("gf_apply_matrix",
                                      t0 + dt - t_dispatch, host.nbytes)
                byte0 = 4 * w0
                real = min(self._nbytes - byte0, 4 * n)
                try:
                    yield byte0, host.numpy().view(np.uint8).reshape(
                        self._rows, -1)[:, :real]
                finally:
                    if cuda:
                        POOL.give(host, pinned=True)
            if s.errors:
                raise s.errors[0]
            s.stats.end = time.perf_counter()
            s.stats.finish()
            profiling.overlap_note(s.stats.overlap_fraction,
                                   s.stats.windows, op=self._op)
            _note_launch(s.stats)
        finally:
            self._close()

    def materialize(self) -> np.ndarray:
        """Drain every window into one [rows, nbytes] uint8 array."""
        out = np.empty((self._rows, self._nbytes), dtype=np.uint8)
        for byte0, chunk in self.windows():
            out[:, byte0:byte0 + chunk.shape[1]] = chunk
        return out

    def abort(self) -> None:
        """Stop the staging thread and release every window still in
        flight, once the device is done with it (error unwind path)."""
        self._consumed = True
        self._close()

    def _close(self) -> None:
        if self._closed:
            return
        self._closed = True
        s = self._s
        s.stop.set()
        self._t.join(timeout=60)
        while True:
            try:
                item = s.ready.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                s.release(item)
