"""Group commit: one durability barrier shared by concurrent writers (the
port's copy of `seaweedfs_tpu/util/group_commit.py`).

A site pays one flush per request: the filer store's transaction commit,
the metadata log's segment append.  `CommitBarrier` turns each such
site into leader/follower group commit:

* a writer buffers its mutation, then calls `commit()`;
* the first writer to arrive leads the open batch; later arrivals join
  it as followers and block;
* the leader waits for the previous batch's flush (batches are strictly
  serial, and that wait is the gather window: batch N+1 fills while
  batch N flushes), closes its batch, runs the flush once and wakes
  every member;
* every member returns only after a flush that started after its
  mutation was buffered, so the ack means what a flush per write means.

A lone writer leads a batch of one and flushes at once.  An optional
linger (`SEAWEEDFS_TPU_GROUP_COMMIT_MAX_WAIT_US`, default 0) lets a
leader that already has company hold its batch open for stragglers.

A flush failure reaches every member of the failed batch: no writer is
acked by a barrier that did not land.

Knobs (env):
  SEAWEEDFS_TPU_GROUP_COMMIT              "0": commit() == flush()
  SEAWEEDFS_TPU_GROUP_COMMIT_MAX_WAIT_US  leader linger for a batch of
                                          two or more (0)
  SEAWEEDFS_TPU_GROUP_COMMIT_MAX_BATCH    the linger stops at this size
                                          (64)

Every flushed batch lands `group_commit_batch_size{site}` and every
writer's wait `group_commit_wait_seconds{site}` on `stats.PROCESS`.
"""

from __future__ import annotations

import os
import threading
import time

from .. import stats

GROUP_COMMIT_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
                              128.0)
GROUP_COMMIT_WAIT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                             0.005, 0.01, 0.025, 0.05, 0.1, 0.25)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def enabled() -> bool:
    """SEAWEEDFS_TPU_GROUP_COMMIT=0 reverts every site to a flush per
    write."""
    return os.environ.get("SEAWEEDFS_TPU_GROUP_COMMIT", "1") != "0"


def max_wait_s() -> float:
    """The leader's linger in seconds (from the _MAX_WAIT_US knob)."""
    return max(0, _env_int(
        "SEAWEEDFS_TPU_GROUP_COMMIT_MAX_WAIT_US", 0)) / 1e6


def max_batch() -> int:
    return max(1, _env_int("SEAWEEDFS_TPU_GROUP_COMMIT_MAX_BATCH", 64))


class _Batch:
    """One commit window: members joined, a leader claimed, one flush
    verdict shared by all."""

    __slots__ = ("members", "claimed", "done", "error")

    def __init__(self):
        self.members = 0
        self.claimed = False
        self.done = threading.Event()
        self.error: "BaseException | None" = None


class CommitBarrier:
    """Leader/follower group commit around one flush callable.

    `flush` must make everything buffered at its call durable
    (`file.flush()`, `conn.commit()`).  One thread at a time calls it
    (batches are serialized on an internal lock), and it may take the
    site's own lock."""

    def __init__(self, flush, site: str = ""):
        self._flush = flush
        self.site = site
        self._lock = threading.Lock()        # guards _batch
        self._flush_lock = threading.Lock()  # serializes batch flushes
        self._batch = _Batch()
        # cumulative counts for cheap snapshots (tests, /debug)
        self.flushes = 0
        self.committed = 0

    def commit(self) -> int:
        """Block until a flush that started after this call covers the
        caller's buffered work.  Returns the batch size when this caller
        led the flush, 0 when it rode another leader's.  Raises the
        flush's exception (shared by the whole batch)."""
        if not enabled():
            # a flush per write, still one flusher at a time: sites like
            # MetaLog._group_commit_drain mutate state that concurrent
            # flushes would race on
            with self._flush_lock:
                self._flush()
            return 1
        t0 = time.perf_counter()
        with self._lock:
            batch = self._batch
            batch.members += 1
            lead = not batch.claimed
            if lead:
                batch.claimed = True
        if not lead:
            batch.done.wait()
            self._note_wait(time.perf_counter() - t0)
            if batch.error is not None:
                raise batch.error
            return 0
        # leader: wait out the previous batch's flush; members pile into
        # this batch meanwhile
        with self._flush_lock:
            linger = max_wait_s()
            if linger > 0:
                self._linger(batch, linger)
            with self._lock:
                # close the window: later arrivals wait for the next
                # barrier, whose flush also starts after their mutation
                self._batch = _Batch()
                n = batch.members
            try:
                self._flush()
            except BaseException as e:
                batch.error = e
                raise
            finally:
                batch.done.set()
                self._note_flush(n, time.perf_counter() - t0)
        return n

    def sync(self) -> None:
        """Force a barrier now (a reader that must see persisted state,
        a close): an empty member's commit()."""
        self.commit()

    def _linger(self, batch: _Batch, seconds: float) -> None:
        """Hold a batch that already has company open for stragglers; a
        batch of one never lingers."""
        deadline = time.perf_counter() + seconds
        cap = max_batch()
        while True:
            with self._lock:
                n = batch.members
            if n <= 1 or n >= cap:
                return
            left = deadline - time.perf_counter()
            if left <= 0:
                return
            time.sleep(min(left, 0.0002))

    def _note_wait(self, seconds: float) -> None:
        stats.PROCESS.histogram_observe(
            "group_commit_wait_seconds", seconds,
            buckets=GROUP_COMMIT_WAIT_BUCKETS,
            help_text="time a writer waited on the shared durability "
                      "barrier", site=self.site or "?")

    def _note_flush(self, n: int, leader_seconds: float) -> None:
        self.flushes += 1
        self.committed += n
        stats.PROCESS.histogram_observe(
            "group_commit_batch_size", float(n),
            buckets=GROUP_COMMIT_BATCH_BUCKETS,
            help_text="writers covered per shared durability barrier "
                      "(mean batch = sum/count)", site=self.site or "?")
        self._note_wait(leader_seconds)
