"""The port's hedged replica reads, against the JAX package's:
`util/hedge.py` (`LatencyTracker`, the token pool, `read_threshold`,
`note_primary`, `hedged_fetch` and its workers) and the hedged step of
`operation.read` (`_maybe_hedged_read`).  Tolerance: exact equality of
quantiles, thresholds, token verdicts and fetch results; the budget
cases hold a read's wall to its deadline.

- on the same seeded latency sequences, the tracker's quantiles, the
  token pool's verdicts and `read_threshold` equal the JAX module's;
- `hedged_fetch` in both packages: a fast primary is not hedged, the
  first success wins and is counted, a slow primary beats a failing
  hedge, two failures give None, the token budget bounds the hedges, the
  deadline rides onto the workers, and the pool grows past parked
  primaries (tests/test_deadline.py's hedge cases); the port's losing
  leg is freed by reference counting, with no cycle for the collector;
- a cluster read under a deadline meets its budget past a stalled
  replica with hedging on and misses it with hedging off
  (tests/test_chaos_cluster.py scenarios 8; the port has no fault
  sites, so the test stalls the replica's handler itself).
"""

import gc
import os
import threading
import time
import weakref

import numpy as np
import pytest

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.util import deadline as ref_deadline
from seaweedfs_tpu.util import hedge as ref_hedge
from seaweedfs_tpu_torch import operation, stats
from seaweedfs_tpu_torch.server.httpd import http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.util import deadline, hedge

MODS = {"port": (hedge, deadline, stats), "jax": (ref_hedge, ref_deadline,
                                                  ref_stats)}


@pytest.fixture(autouse=True)
def _fresh_hedge():
    hedge.reset()
    ref_hedge.reset()
    yield
    hedge.reset()
    ref_hedge.reset()


def _latencies(seed: int, n: int) -> "list[float]":
    rng = np.random.default_rng([16, seed])
    lat = rng.lognormal(-6.0, 0.8, n)
    lat[rng.random(n) < 0.03] *= 50           # a tail of stalls
    return [float(x) for x in lat]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_tracker_and_threshold_equal_the_reference(seed, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_HEDGE_MIN_MS", str(1 + seed))
    port, ref = hedge.LatencyTracker(), ref_hedge.LatencyTracker()
    for i, x in enumerate(_latencies(seed, 300)):
        port.note(x)
        ref.note(x)
        hedge.note_primary(x)
        ref_hedge.note_primary(x)
        for q in (0.5, 0.9, 0.95, 0.99):
            assert port.quantile(q) == ref.quantile(q), (i, q)
        assert hedge.read_threshold() == ref_hedge.read_threshold(), i
    assert port.quantile() is not None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_token_pool_equals_the_reference(seed, monkeypatch):
    rng = np.random.default_rng([17, seed])
    monkeypatch.setenv("SEAWEEDFS_TPU_HEDGE_BURST", str(int(
        rng.integers(1, 6))))
    monkeypatch.setenv("SEAWEEDFS_TPU_HEDGE_RATIO", str(float(
        rng.choice([0.0, 0.1, 0.25, 0.5]))))
    verdicts = {"port": [], "jax": []}
    for op in rng.integers(0, 3, 400):
        for name, (mod, _, _) in MODS.items():
            if op:
                mod.note_primary(0.001)
            else:
                verdicts[name].append(mod.take_token())
    assert verdicts["port"] == verdicts["jax"]
    assert True in verdicts["port"]


def _counter(mod_stats, name: str) -> float:
    total = 0.0
    for line in mod_stats.PROCESS.render().splitlines():
        if line.startswith(name):
            total += float(line.rsplit(" ", 1)[1])
    return total


@pytest.mark.parametrize("pkg", list(MODS))
def test_a_fast_primary_is_not_hedged(pkg):
    mod = MODS[pkg][0]
    assert mod.hedged_fetch(lambda: "quick", lambda: "never", 0.5,
                            lambda r: True) == ("quick", False)


@pytest.mark.parametrize("pkg", list(MODS))
def test_the_first_success_wins_and_is_counted(pkg):
    mod, _, st = MODS[pkg]
    before = _counter(st, "seaweedfs_tpu_hedges_won_total")
    issued = _counter(st, "seaweedfs_tpu_hedges_issued_total")

    def slow():
        time.sleep(0.4)
        return "slow"
    assert mod.hedged_fetch(slow, lambda: "fast", 0.02,
                            lambda r: True) == ("fast", True)
    assert _counter(st, "seaweedfs_tpu_hedges_won_total") == before + 1
    assert _counter(st, "seaweedfs_tpu_hedges_issued_total") == issued + 1


@pytest.mark.parametrize("pkg", list(MODS))
def test_a_slow_primary_beats_a_failing_hedge(pkg):
    mod = MODS[pkg][0]

    def slowish():
        time.sleep(0.1)
        return "primary"

    def bad():
        raise OSError("replica down")
    assert mod.hedged_fetch(slowish, bad, 0.02, lambda r: True) == \
        ("primary", True)


@pytest.mark.parametrize("pkg", list(MODS))
def test_two_failures_give_none(pkg):
    mod = MODS[pkg][0]

    def bad():
        raise OSError("down")
    assert mod.hedged_fetch(bad, bad, 0.01, lambda r: True)[0] is None


def test_a_failed_primary_fails_over_at_once():
    """The port hedges a primary that fails before the threshold at once;
    the JAX hedge gives up and returns no result."""
    def down():
        raise OSError("replica down")
    t0 = time.monotonic()
    assert hedge.hedged_fetch(down, lambda: "second", 5.0,
                              lambda r: True) == ("second", True)
    assert time.monotonic() - t0 < 1.0
    assert ref_hedge.hedged_fetch(down, lambda: "second", 5.0,
                                  lambda r: True) == (None, False)


class _Marker:
    pass


def test_a_losing_leg_is_freed_without_the_cycle_collector(monkeypatch):
    """The port's hedge keeps a failed leg's verdict, not its exception:
    the exception's traceback holds the leg's frames, and through the
    worker's frame the result queue that holds the exception, so every
    loser would wait in a reference cycle for a full collection (the
    JAX hedge keeps the exception)."""
    monkeypatch.setenv("SEAWEEDFS_TPU_HEDGE_BURST", "64")
    hedge.reset()
    refs = []

    def parked_then_failed():
        marker = _Marker()
        refs.append(weakref.ref(marker))
        time.sleep(0.03)
        raise TimeoutError("the primary's budget ran out")
    gc.collect()
    gc.disable()
    try:
        for _ in range(8):
            with deadline.scope(2.0):
                assert hedge.hedged_fetch(
                    parked_then_failed, lambda: "second", 0.002,
                    lambda r: True) == ("second", True)
        end = time.monotonic() + 5.0
        while any(r() is not None for r in refs):
            assert time.monotonic() < end, "a loser's frame outlived it"
            time.sleep(0.01)
    finally:
        gc.enable()
    assert len(refs) == 8


@pytest.mark.parametrize("pkg", list(MODS))
def test_the_token_budget_bounds_the_hedges(pkg, monkeypatch):
    mod, _, st = MODS[pkg]
    monkeypatch.setenv("SEAWEEDFS_TPU_HEDGE_BURST", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_HEDGE_RATIO", "0")
    mod.reset()
    before = _counter(st, "seaweedfs_tpu_hedges_issued_total")

    def slow():
        time.sleep(0.06)
        return "slow"
    assert mod.hedged_fetch(slow, lambda: "fast", 0.01,
                            lambda r: True) == ("fast", True)
    assert mod.hedged_fetch(slow, lambda: "fast", 0.01,
                            lambda r: True) == ("slow", False)
    assert _counter(st, "seaweedfs_tpu_hedges_issued_total") == before + 1


@pytest.mark.parametrize("pkg", list(MODS))
def test_the_deadline_rides_onto_the_workers(pkg):
    mod, dl, _ = MODS[pkg]
    seen = []

    def probe():
        seen.append(dl.remaining())
        return "ok"
    with dl.scope(0.5):
        val, _ = mod.hedged_fetch(probe, probe, 0.5, lambda r: True)
    assert val == "ok" and seen and seen[0] is not None and seen[0] <= 0.5


@pytest.mark.parametrize("pkg", list(MODS))
def test_the_pool_grows_past_parked_primaries(pkg):
    mod = MODS[pkg][0]
    park = threading.Event()

    def parked_fn():
        park.wait(5.0)
    try:
        for _ in range(6):
            mod._submit(parked_fn)
        done = threading.Event()
        t0 = time.monotonic()
        mod._submit(done.set)
        assert done.wait(1.0), "a submit queued behind parked workers"
        assert time.monotonic() - t0 < 1.0
        assert mod._workers_started >= 7
    finally:
        park.set()


# -- a stalled replica, hedged and not ------------------------------------

class _Cluster:
    """A port master and two volume servers; reads of 001 volumes have
    two locations.  The planes are parked (the client's status cache
    says none), so reads reach the HTTP port, where the test stalls
    one server's needle handler."""

    def __init__(self, tmp):
        self.master = MasterServer(pulse_seconds=1.0,
                                   default_replication="001").start()
        self.url = self.master.url
        self.servers = [VolumeServer([os.path.join(str(tmp), f"v{i}")],
                                     device="cpu", master=self.url,
                                     pulse_seconds=0.2).start()
                        for i in range(2)]
        end = time.monotonic() + 15
        while len(http_json("GET", f"{self.url}/cluster/status")
                  ["dataNodes"]) < 2:
            assert time.monotonic() < end
            time.sleep(0.05)
        for vs in self.servers:
            with operation._status_lock:
                operation._status_cache[vs.url] = {}

    def stall(self, url: str, seconds: float):
        vs = next(s for s in self.servers if s.url == url)
        real = vs._get_needle
        hits = []

        def slow(fid, rng=""):
            hits.append(fid)
            time.sleep(seconds)
            return real(fid, rng)
        vs._get_needle = slow
        return hits

    def close(self):
        for vs in self.servers:
            with operation._status_lock:
                operation._status_cache.pop(vs.url, None)
            vs.stop()
        self.master.stop()


@pytest.fixture
def stalled(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_HEDGE_MIN_MS", "5")
    c = _Cluster(tmp_path)
    blobs = {operation.submit(c.url, os.urandom(2048) + bytes([i])): None
             for i in range(6)}
    for fid in blobs:
        blobs[fid] = operation.read(c.url, fid)
    # the stalled replica: the first location of every fid
    fid0 = next(iter(blobs))
    locs = operation.lookup(c.url, int(fid0.split(",")[0]))
    assert len(locs) == 2, "replication 001 gives two locations"
    yield c, blobs, locs[0]["url"]
    c.close()


def test_a_hedged_read_meets_its_budget_past_a_stalled_replica(stalled):
    c, blobs, slow_url = stalled
    # warm the tracker and earn tokens with reads that carry no deadline
    for _ in range(4):
        for fid, data in blobs.items():
            assert operation.read(c.url, fid) == data
    assert hedge.read_threshold() is not None
    targets = [f for f in blobs if operation.lookup(
        c.url, int(f.split(",")[0]))[0]["url"] == slow_url]
    assert targets
    hits = c.stall(slow_url, 2.0)
    won = _counter(stats, "seaweedfs_tpu_hedges_won_total")
    budget = 1.2
    walls = []
    for fid in targets[:4] * 2:
        with deadline.scope(budget):
            t0 = time.monotonic()
            assert operation.read(c.url, fid) == blobs[fid]
            walls.append(time.monotonic() - t0)
    assert max(walls) < budget, walls
    assert hits, "the stall never ran"
    assert _counter(stats, "seaweedfs_tpu_hedges_won_total") > won


def test_an_unhedged_read_misses_its_budget(stalled, monkeypatch):
    c, blobs, slow_url = stalled
    monkeypatch.setenv("SEAWEEDFS_TPU_HEDGE_READS", "0")
    for _ in range(4):
        for fid, data in blobs.items():
            assert operation.read(c.url, fid) == data
    fid = next(f for f in blobs if operation.lookup(
        c.url, int(f.split(",")[0]))[0]["url"] == slow_url)
    c.stall(slow_url, 2.0)
    budget = 1.2
    with deadline.scope(3.0):
        t0 = time.monotonic()
        assert operation.read(c.url, fid) == blobs[fid]
        took = time.monotonic() - t0
    assert took > budget, f"the unhedged read took {took:.2f} s"
