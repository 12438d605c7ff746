"""Hedged replica reads, the port's copy of `seaweedfs_tpu/util/hedge.py`:
one slow replica must not spend a whole request budget.

When a read has a second location and the request carries a deadline,
the primary fetch runs on a hedge worker; if it has not answered within
a latency threshold and the token budget allows, the same fetch goes to
the second replica and the first success wins (the loser's answer is
dropped).

- The budget: every successful primary read earns
  `SEAWEEDFS_TPU_HEDGE_RATIO` (0.1) of a token, up to
  `SEAWEEDFS_TPU_HEDGE_BURST` (16), and every hedge issued spends one,
  so hedges stay near 10% extra reads however slow the cluster gets.
  The pool starts full.
- The threshold: the p95 of the recent successful primary reads (a ring
  of 128, no verdict under 8), floored at `SEAWEEDFS_TPU_HEDGE_MIN_MS`
  (2 ms).
- Only deadline-carrying requests hedge; `SEAWEEDFS_TPU_HEDGE_READS=0`
  (or `false`) turns hedging off.
- The workers are daemon threads, grown on demand up to
  `SEAWEEDFS_TPU_HEDGE_WORKERS` (64), so a fetch never queues behind
  primaries parked on a wedged replica.
- A primary that fails before the threshold gets the secondary at once
  (with a token), where the JAX hedge returns no result.

`hedges_issued_total` and `hedges_won_total` (`kind="read"`) go to
`stats.PROCESS`, and each hedge issued or won leaves a `hedge` flight
note on the request (`profiling.flight_note`).  `LatencyTracker.
note_many` is the native planes' record drain's feed.  The ratio and the
floor are knobs of the SLO autopilot (autopilot.py): `set_ratio` and
`set_min_threshold_ms` override the environment's values, which stay the
baseline (`None` goes back to it, and so does `reset`).
"""

from __future__ import annotations

import os
import queue
import threading
import time

from .. import stats
from . import deadline as _deadline


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def reads_enabled() -> bool:
    return os.environ.get("SEAWEEDFS_TPU_HEDGE_READS", "1") \
        not in ("0", "false")


# the autopilot's overrides of the environment (None: the env's value);
# set only through its actuators
_min_ms_override: "float | None" = None
_ratio_override: "float | None" = None


def set_min_threshold_ms(ms: "float | None") -> None:
    global _min_ms_override
    _min_ms_override = None if ms is None else max(0.0, float(ms))


def set_ratio(ratio: "float | None") -> None:
    global _ratio_override
    _ratio_override = None if ratio is None else max(0.0, float(ratio))


def effective_ratio() -> float:
    if _ratio_override is not None:
        return _ratio_override
    return max(0.0, _env_float("SEAWEEDFS_TPU_HEDGE_RATIO", 0.1))


def min_threshold() -> float:
    if _min_ms_override is not None:
        return _min_ms_override / 1e3
    return _env_float("SEAWEEDFS_TPU_HEDGE_MIN_MS", 2.0) / 1e3


class LatencyTracker:
    """A quantile over a ring of recent latencies: note() is one lock
    round and a ring write; quantile() sorts the ring only when a
    decision is made."""

    def __init__(self, size: int = 128, min_samples: int = 8):
        self.size = size
        self.min_samples = min_samples
        self._ring: "list[float]" = []
        self._i = 0
        self._lock = threading.Lock()

    def note(self, seconds: float) -> None:
        with self._lock:
            if len(self._ring) < self.size:
                self._ring.append(seconds)
            else:
                self._ring[self._i] = seconds
                self._i = (self._i + 1) % self.size

    def note_many(self, seconds_batch: "list[float]") -> None:
        """`note` for a whole batch in one lock round (the native
        planes' record drain feeds thousands a second); a batch at least
        `size` long becomes the ring."""
        if not seconds_batch:
            return
        with self._lock:
            if len(seconds_batch) >= self.size:
                self._ring = list(seconds_batch[-self.size:])
                self._i = 0
                return
            for s in seconds_batch:
                if len(self._ring) < self.size:
                    self._ring.append(s)
                else:
                    self._ring[self._i] = s
                    self._i = (self._i + 1) % self.size

    def quantile(self, q: float = 0.95) -> "float | None":
        with self._lock:
            if len(self._ring) < self.min_samples:
                return None
            s = sorted(self._ring)
        return s[min(int(len(s) * q), len(s) - 1)]

    def reset(self) -> None:
        with self._lock:
            self._ring = []
            self._i = 0


class _TokenPool:
    """The hedge budget: earned by primary reads, spent by each hedge
    issued.  Starts full: a cold process may hedge its first slow
    read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tokens: "float | None" = None

    def _burst(self) -> float:
        return max(1.0, _env_float("SEAWEEDFS_TPU_HEDGE_BURST", 16.0))

    def earn(self) -> None:
        ratio, burst = effective_ratio(), self._burst()
        with self._lock:
            if self._tokens is None:
                self._tokens = burst
            else:
                self._tokens = min(burst, self._tokens + ratio)

    def take(self) -> bool:
        with self._lock:
            if self._tokens is None:
                self._tokens = self._burst()
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def reset(self) -> None:
        with self._lock:
            self._tokens = None


read_tracker = LatencyTracker()
_tokens = _TokenPool()


def note_primary(seconds: float) -> None:
    """One successful primary read: it feeds the threshold's tracker and
    earns its fraction of a hedge token."""
    read_tracker.note(seconds)
    _tokens.earn()


def take_token() -> bool:
    return _tokens.take()


def read_threshold() -> "float | None":
    """When to fire the hedge: the p95 of recent primary reads, floored;
    None until the tracker has seen enough reads."""
    p95 = read_tracker.quantile(0.95)
    if p95 is None:
        return None
    return max(p95, min_threshold())


def reset() -> None:
    """Forget the latency history, refill the tokens and drop the
    autopilot's overrides back to the environment's baseline (tests)."""
    read_tracker.reset()
    _tokens.reset()
    set_min_threshold_ms(None)
    set_ratio(None)


# -- the hedge workers ---------------------------------------------------
#
# Daemon threads over a SimpleQueue, started on demand up to the cap:
# a deadline-carrying read parks a worker on its primary fetch for up to
# the budget, so a fixed pool would let one wedged replica take every
# worker.  Workers never fall below the tasks outstanding (under the
# cap), so a new task never waits for a worker; idle ones park on the
# queue and keep their pooled sockets.

_work: "queue.SimpleQueue" = queue.SimpleQueue()
_workers_lock = threading.Lock()
_workers_started = 0
_tasks_outstanding = 0      # submitted, not yet finished


def _worker_cap() -> int:
    try:
        return max(2, int(os.environ.get(
            "SEAWEEDFS_TPU_HEDGE_WORKERS", "") or 64))
    except ValueError:
        return 64


def _worker_loop() -> None:
    global _tasks_outstanding
    while True:
        fn = _work.get()
        try:
            fn()
        except BaseException:  # noqa: BLE001 — a task's verdict travels
            pass               # in its own queue; a worker never dies
        finally:
            with _workers_lock:
                _tasks_outstanding -= 1


def _submit(fn) -> None:
    global _workers_started, _tasks_outstanding
    with _workers_lock:
        _tasks_outstanding += 1
        if _workers_started < min(_tasks_outstanding, _worker_cap()):
            threading.Thread(target=_worker_loop, daemon=True,
                             name=f"hedge-{_workers_started}").start()
            _workers_started += 1
    _work.put(fn)


def hedged_fetch(primary, secondary, threshold_s: float, is_success,
                 kind: str = "read"):
    """A first-wins race of two fetch callables: `primary` runs at once
    (on a worker, while this caller watches the clock); with no verdict
    after `threshold_s` and a token to spend, `secondary` runs too.  The
    first result that passes `is_success` wins.  (result or None,
    hedged); None means no success.  The caller's deadline is bound on
    the workers, so their socket timeouts stay within the budget."""
    results: "queue.SimpleQueue" = queue.SimpleQueue()
    d = _deadline.get()

    def run(tag: int, fn):
        def task():
            t0 = time.monotonic()
            try:
                with _deadline.use(d):
                    val = fn()
            except BaseException:  # noqa: BLE001 — raced verdict
                # the verdict only, not the exception: its traceback
                # holds this frame, which holds `results`, and a loser's
                # frames would then wait in a reference cycle for a full
                # collection (tens of ms at hundreds of hedges a second)
                results.put((tag, True, None, time.monotonic() - t0))
            else:
                results.put((tag, False, val, time.monotonic() - t0))
        _submit(task)

    run(0, primary)
    outstanding = 1
    hedged = False
    # the wall guard: the deadline when one is armed, else a generous cap
    # (each fetch carries its own socket timeout)
    rem = d.remaining() if d is not None else 600.0
    end = time.monotonic() + rem

    def hedge() -> bool:
        """Issue the secondary, when the budget has time and a token."""
        nonlocal hedged, outstanding
        if hedged or time.monotonic() >= end or not take_token():
            return False
        hedged = True
        stats.PROCESS.counter_add(
            "hedges_issued_total", 1.0,
            help_text="secondary replica fetches issued past the latency "
                      "threshold", kind=kind)
        # the note rides the caller's context: this loop runs on the
        # request's thread, only the fetches are pooled
        _flight_note("hedge", {
            "kind": kind, "issued": True, "won": False,
            "thresholdMs": round(threshold_s * 1e3, 2)})
        run(1, secondary)
        outstanding += 1
        return True

    while outstanding:
        if not hedged:
            wait = min(threshold_s, end - time.monotonic())
        else:
            wait = end - time.monotonic()
        try:
            tag, failed, val, took = results.get(timeout=max(wait, 0.001))
        except queue.Empty:
            if hedge():
                continue
            if time.monotonic() >= end:
                break       # the budget is spent: the caller fails fast
            continue        # no token: keep waiting on the primary
        outstanding -= 1
        if tag == 0 and not failed and is_success(val):
            note_primary(took)
        if not failed and is_success(val):
            if tag == 1:
                stats.PROCESS.counter_add(
                    "hedges_won_total", 1.0,
                    help_text="hedged fetches that answered first",
                    kind=kind)
                _flight_note("hedge", {
                    "kind": kind, "issued": True, "won": True,
                    "thresholdMs": round(threshold_s * 1e3, 2)})
            return val, hedged
        # the primary failed before the threshold: its replica is down,
        # not slow, so the secondary goes at once (the JAX hedge returns
        # here and leaves the read to the caller's sequential path, which
        # may wait on that replica again)
        hedge()
    return None, hedged


def _flight_note(key: str, value) -> None:
    from .. import profiling
    profiling.flight_note(key, value)
