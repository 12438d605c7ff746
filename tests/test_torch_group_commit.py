"""The port's group commit (`util/group_commit.CommitBarrier`) and bounded
fan-out (`util/limiter.bounded_parallel`), held against the JAX
package's: the same scenario runs over both implementations and must
give the same answers.

- a lone writer leads a batch of one and flushes at once;
- concurrent writers share flushes, and every commit returns only after
  a flush that started after it;
- a flush error reaches every member of its batch, and the next batch
  flushes again;
- flushes never overlap, with the kill switch too;
- `group_commit_batch_size` / `_wait_seconds` land per site;
- `bounded_parallel` keeps order, bounds concurrency, re-raises, and
  runs on one pool whose threads outlive a call (the JAX package's
  `persistent=True`, the mode its filer uses).
"""

import functools
import threading
import time

import pytest

from seaweedfs_tpu.util import group_commit as ref_group_commit
from seaweedfs_tpu.util import limiter as ref_limiter
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.util import group_commit, limiter

BARRIERS = {"port": group_commit.CommitBarrier,
            "jax": ref_group_commit.CommitBarrier}
FANOUTS = {"port": limiter.bounded_parallel,
           "jax": functools.partial(ref_limiter.bounded_parallel,
                                    persistent=True)}


def _run_threads(fn, n: int, timeout: float = 30.0) -> None:
    ts = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a writer hung"


def _until(cond, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.001)


@pytest.mark.parametrize("impl", sorted(BARRIERS))
def test_single_writer_leads_a_batch_of_one(impl):
    calls = []
    b = BARRIERS[impl](lambda: calls.append(1), site="t")
    assert [b.commit() for _ in range(5)] == [1] * 5
    assert len(calls) == 5 and b.flushes == 5 and b.committed == 5


@pytest.mark.parametrize("impl", sorted(BARRIERS))
def test_concurrent_commits_share_flushes_and_ack_after_their_flush(impl):
    """Each commit returns only after a flush that STARTED after the
    commit was called (the ack contract of a flush per write)."""
    starts: list = []
    ends: list = []
    lock = threading.Lock()

    def slow_flush():
        t = time.monotonic()
        time.sleep(0.004)
        with lock:
            starts.append(t)
            ends.append(time.monotonic())

    b = BARRIERS[impl](slow_flush, site="t")
    bad = []

    def writer(_i):
        for _ in range(10):
            called = time.monotonic()
            b.commit()
            with lock:
                covered = any(s >= called and e <= time.monotonic()
                              for s, e in zip(starts, ends))
            if not covered:
                bad.append(called)

    _run_threads(writer, 8)
    assert bad == []
    assert b.committed == 80
    assert 1 <= b.flushes < 80


@pytest.mark.parametrize("impl", sorted(BARRIERS))
def test_flush_error_reaches_every_member_of_its_batch(impl):
    gate = threading.Event()
    state = {"n": 0}

    def flush():
        state["n"] += 1
        if state["n"] == 1:
            gate.wait(5)          # hold batch 1 while batch 2 gathers
            return
        if state["n"] == 2:
            raise OSError("disk full")

    b = BARRIERS[impl](flush, site="t")
    first = threading.Thread(target=b.commit)
    first.start()
    _until(lambda: state["n"] == 1)  # the first leader is in its flush
    results: dict = {}

    def member(i):
        try:
            b.commit()
            results[i] = "ok"
        except OSError as e:
            results[i] = str(e)

    ts = [threading.Thread(target=member, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    _until(lambda: b._batch.members == 6)  # all six joined batch 2
    gate.set()
    for t in ts + [first]:
        t.join(10)
    assert results == {i: "disk full" for i in range(6)}
    assert b.commit() == 1        # the barrier flushes again afterwards


@pytest.mark.parametrize("switch", ["1", "0"], ids=["grouped", "kill_switch"])
@pytest.mark.parametrize("impl", sorted(BARRIERS))
def test_flushes_never_overlap(impl, switch, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_GROUP_COMMIT", switch)
    active = [0]
    overlaps = []
    lock = threading.Lock()

    def flush():
        with lock:
            active[0] += 1
            if active[0] > 1:
                overlaps.append(active[0])
        time.sleep(0.0005)
        with lock:
            active[0] -= 1

    b = BARRIERS[impl](flush, site="t")
    _run_threads(lambda _i: [b.commit() for _ in range(20)], 6)
    assert overlaps == []
    if switch == "0":
        assert b.flushes == 0 and b.committed == 0  # the per-write arm


def test_batch_metrics_land_per_site():
    b = group_commit.CommitBarrier(lambda: None, site="port.test")
    for _ in range(3):
        b.commit()
    size = stats.PROCESS.histogram_merged("group_commit_batch_size")
    assert size is not None and size["count"] >= 3
    text = stats.PROCESS.render()
    assert 'seaweedfs_tpu_group_commit_batch_size_count{site="port.test"} 3' \
        in text
    assert 'group_commit_wait_seconds_count{site="port.test"} 3' in text


@pytest.mark.parametrize("impl", sorted(FANOUTS))
def test_bounded_parallel_keeps_order_and_its_bound(impl):
    live = [0]
    peak = [0]
    lock = threading.Lock()

    def fn(x):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.002)
        with lock:
            live[0] -= 1
        return x * x

    out = FANOUTS[impl](fn, range(40), limit=3)
    assert out == [x * x for x in range(40)]
    assert 1 < peak[0] <= 3
    assert FANOUTS[impl](fn, [7], limit=3) == [49]
    with pytest.raises(ValueError):
        FANOUTS[impl](lambda x: int("nope") if x == 5 else x, range(9),
                      limit=2)


def test_fanout_reuses_its_threads():
    """The shared pool's threads outlive a call: the pooled HTTP client
    keeps its sockets per thread, so a fan-out must not mint threads."""
    seen: set = set()

    def who(_x):
        time.sleep(0.001)
        return threading.get_ident()

    for _ in range(5):
        seen.update(limiter.bounded_parallel(who, range(8), limit=4))
    assert threading.get_ident() not in seen
    assert len(seen) <= limiter._SHARED_WORKERS
    assert limiter.shared_pool() is limiter.shared_pool()
