"""The port's failpoint plane (`seaweedfs_tpu_torch/faults.py`) and retry
policy (`seaweedfs_tpu_torch/util/retry.py`) held against the JAX
package's on the same inputs, made from a numpy seed: `parse_spec` on a
list of specs (malformed ones included), the same seeded `fire`
sequence, the backoff's bounds and values, the budget, and `retry_call`
(idempotent work re-issued, a POST never, an exhausted budget and an
open breaker failing fast, a spent deadline never retried).  Then the
sites of the port's HTTP client on a bare listener: the pooled client
carried through an armed `httpd.pool.request` error, and the streaming
calls' truncate, drop and error directives.  Tolerance: exact equality.
"""

import random
import ssl
import time

import numpy as np
import pytest

from seaweedfs_tpu import faults as ref_faults
from seaweedfs_tpu.util import retry as ref_retry
from seaweedfs_tpu_torch import faults, stats
from seaweedfs_tpu_torch.server.debug import install_debug_routes
from seaweedfs_tpu_torch.server.httpd import (
    HttpServer, http_bytes, http_download, http_json, http_relay,
    http_stream_request)
from seaweedfs_tpu_torch.util import deadline, retry

BOTH_FAULTS = (faults, ref_faults)


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_RETRY_BASE_MS", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_RETRY_CAP_MS", "5")
    for m in (faults, ref_faults):
        m.reset()
    for m in (retry, ref_retry):
        m.reset()
    yield
    for m in (faults, ref_faults):
        m.reset()
    for m in (retry, ref_retry):
        m.reset()


# -- faults: parsing and firing ---------------------------------------------------

SPECS = [
    "volume.read.serve=delay,ms=200,match=127.0.0.1:8080",
    "ec.encode.window=drop,n=1,match=127.0.0.1:9;master.lookup=error,n=2",
    " httpd.pool.request=error,p=0.3,n=6,seed=7 ; ",
    "volume.shard_read.serve=truncate,n=1",
    "a=error,p=2.5",
    "",
    "bogus-entry-no-equals",
    "x=explode",
    "x=error,q=1",
    "x=error,n=two",
    "=error",
    "x=delay,ms",
]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_parse_spec_matches(i):
    out = []
    for m in BOTH_FAULTS:
        try:
            out.append([a.describe() for a in m.parse_spec(SPECS[i])])
        except ValueError:
            out.append("ValueError")
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", range(5))
def test_seeded_fire_sequence_matches(seed):
    rng = np.random.default_rng(seed)
    spec = (f"s.one=truncate,p={rng.uniform(0.1, 0.9):.3f},seed={seed};"
            f"s.one=drop,p=0.5,n={int(rng.integers(1, 20))},seed={seed + 1},"
            f"match=peer{int(rng.integers(0, 3))};"
            f"s.two=delay,ms=0,p=0.2,seed={seed + 2}")
    for m in BOTH_FAULTS:
        assert m.arm_spec(spec) == 3
    keys = [f"peer{int(k)}" for k in rng.integers(0, 3, 300)]
    sites = [("s.one", "s.two")[int(k)] for k in rng.integers(0, 2, 300)]
    seqs = [[m.fire(s, key=k) for s, k in zip(sites, keys)]
            for m in BOTH_FAULTS]
    assert seqs[0] == seqs[1]
    assert faults.triggered() == ref_faults.triggered()
    assert faults.armed() == ref_faults.armed()


def test_default_seed_and_env_arming_match(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_FAULTS_SEED", "42")
    monkeypatch.setenv("SEAWEEDFS_TPU_FAULTS",
                       "q.site=truncate,p=0.5;r.site=error,n=1")
    for m in BOTH_FAULTS:
        m._arm_from_env()
    seqs = [[m.fire("q.site") for _ in range(64)] for m in BOTH_FAULTS]
    assert seqs[0] == seqs[1] and "truncate" in seqs[0]
    assert faults.armed() == ref_faults.armed()
    assert faults.armed()[0]["seed"] == 42


def test_error_and_delay_actions():
    faults.arm("e.site", "error", n=1)
    with pytest.raises(faults.FaultInjected) as ei:
        faults.fire("e.site", key="k1")
    assert isinstance(ei.value, OSError) and "(k1)" in str(ei.value)
    assert faults.fire("e.site") is None          # n spent
    faults.arm("d.site", "delay", ms=30)
    t0 = time.monotonic()
    assert faults.fire("d.site") is None
    assert time.monotonic() - t0 >= 0.03
    assert stats.PROCESS.counter_sum("faults_triggered_total",
                                     site="d.site", action="delay") >= 1
    faults.disarm("d.site")
    assert [a["site"] for a in faults.armed()] == ["e.site"]
    with pytest.raises(ValueError):
        faults.arm("x", "explode")


# -- backoff and budget ------------------------------------------------------------

@pytest.mark.parametrize("attempt", [1, 2, 3, 4, 8])
def test_backoff_delay_bounds_and_values(attempt):
    base, cap = 0.05, 0.3
    ceiling = min(cap, base * 2 ** (attempt - 1))
    a, b = random.Random(attempt), random.Random(attempt)
    for _ in range(200):
        d = retry.backoff_delay(attempt, base, cap, a)
        assert 0.0 <= d <= ceiling
        assert d == ref_retry.backoff_delay(attempt, base, cap, b)


def test_budget_matches_and_refills(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_RETRY_BUDGET", "3")
    monkeypatch.setenv("SEAWEEDFS_TPU_RETRY_BUDGET_REFILL", "0")
    out = [[m.budget_take() for _ in range(5)] + [m.budget_remaining()]
           for m in (retry, ref_retry)]
    assert out[0] == out[1] == [True, True, True, False, False, 0.0]
    assert stats.PROCESS.gauge_value("retry_budget_remaining") == 0.0
    retry.reset()
    assert retry.budget_remaining() == 3.0


# -- retry_call --------------------------------------------------------------------

class _Flaky:
    def __init__(self, fails: int, exc=OSError):
        self.fails = fails
        self.calls = 0
        self.exc = exc

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc("flaky")
        return "ok"


@pytest.mark.parametrize("mod", ["port", "ref"])
def test_idempotent_work_is_reissued(mod):
    m = retry if mod == "port" else ref_retry
    fn = _Flaky(2)
    assert m.retry_call(fn, site="unit", peer="p:1") == "ok"
    assert fn.calls == 3
    assert m.peer_state("p:1") == m.CLOSED


@pytest.mark.parametrize("mod", ["port", "ref"])
def test_post_is_never_reissued(mod):
    m = retry if mod == "port" else ref_retry
    fn = _Flaky(1)
    with pytest.raises(OSError):
        m.retry_call(fn, site="unit", peer="p:2", idempotent=False)
    assert fn.calls == 1


def test_exhausted_budget_fails_fast(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_RETRY_BUDGET", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_RETRY_BUDGET_REFILL", "0")
    calls = []
    for m in (retry, ref_retry):
        fn = _Flaky(10)
        with pytest.raises(OSError):
            m.retry_call(fn, site="unit", peer="")
        first = fn.calls
        fn = _Flaky(10)
        with pytest.raises(OSError):
            m.retry_call(fn, site="unit", peer="")
        calls.append((first, fn.calls))
    assert calls[0] == calls[1] == (2, 1)
    assert stats.PROCESS.counter_sum("retry_budget_exhausted_total") >= 1


def test_open_breaker_fails_fast_and_admits_one_probe(monkeypatch):
    monkeypatch.setattr(retry, "BREAKER_THRESHOLD", 2)
    monkeypatch.setattr(retry, "BREAKER_COOLDOWN", 0.05)
    peer = "p:3"
    retry.record_failure(peer, "x")
    retry.record_failure(peer, "x")
    fn = _Flaky(0)
    with pytest.raises(retry.BreakerOpen):
        retry.retry_call(fn, peer=peer)
    assert fn.calls == 0
    time.sleep(0.06)
    retry.check_peer(peer)                 # this caller is the probe
    with pytest.raises(retry.BreakerOpen):
        retry.check_peer(peer)             # one probe at a time
    retry.probe_release(peer)              # no verdict: slot back
    assert retry.retry_call(fn, peer=peer) == "ok"
    assert retry.peer_state(peer) == retry.CLOSED
    snap = retry.health_snapshot()
    assert snap[peer]["trips"] == 1 and snap[peer]["state"] == "closed"


@pytest.mark.parametrize("mod", ["port", "ref"])
def test_spent_deadline_is_not_retried(mod):
    m = retry if mod == "port" else ref_retry
    from seaweedfs_tpu.util import deadline as ref_deadline
    dl = deadline if mod == "port" else ref_deadline
    fn = _Flaky(5, exc=dl.DeadlineExceeded)
    with pytest.raises(dl.DeadlineExceeded):
        m.retry_call(fn, site="unit", peer="p:4")
    assert fn.calls == 1
    assert m.peer_state("p:4") == m.CLOSED


def test_doomed_attempt_is_refused_under_a_deadline(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_RETRY_BASE_MS", "500")
    monkeypatch.setenv("SEAWEEDFS_TPU_RETRY_CAP_MS", "500")
    monkeypatch.setattr(retry, "backoff_delay", lambda *a: 0.5)
    fn = _Flaky(5)
    with deadline.scope(0.2):
        with pytest.raises(deadline.DeadlineExceeded):
            retry.retry_call(fn, site="unit", peer="p:5")
    assert fn.calls == 1
    assert retry.budget_remaining() == 64.0      # no token spent


def test_certificate_verdict_is_not_retried():
    fn = _Flaky(5, exc=ssl.SSLCertVerificationError)
    with pytest.raises(ssl.SSLCertVerificationError):
        retry.retry_call(fn, site="unit", peer="p:6")
    assert fn.calls == 1


# -- the HTTP client's sites on a bare listener ------------------------------------------

@pytest.fixture(scope="module")
def server():
    http = HttpServer()
    got = {}

    def sink(req):
        n = 0
        try:
            for chunk in req.stream_body(1 << 10):
                n += len(chunk)
        except OSError as e:
            got["error"] = str(e)
            raise
        got["bytes"] = n
        return 200, {"bytes": n}

    http.route("GET", "/x", lambda req: (200, {"ok": True}))
    http.route("POST", "/x", lambda req: (200, {"ok": True}))
    http.route("POST", "/sink", sink)
    http.route("GET", "/blob",
               lambda req: (200, (b"b" * (64 << 10), "application/"
                                  "octet-stream")))
    install_debug_routes(http)
    http.start()
    http.got = got
    yield http
    http.stop()


def _retries() -> float:
    return stats.PROCESS.counter_sum("retry_attempts_total",
                                     site="httpd.pool")


def _fresh_pool():
    """This thread's pooled sockets dropped: the next request dials, so
    a failed send is never the pool's inline stale-socket replay."""
    from seaweedfs_tpu_torch.server import httpd
    for conn in httpd._pool().values():
        conn.close()
    httpd._pool().clear()


def test_pooled_get_rides_an_armed_request_error(server):
    _fresh_pool()
    faults.arm_spec(f"httpd.pool.request=error,n=2,match={server.url}/x")
    before = _retries()
    st, body, _ = http_bytes("GET", f"{server.url}/x", timeout=10)
    assert st == 200 and b"ok" in body
    assert _retries() == before + 2
    assert faults.triggered()["httpd.pool.request"] == 2
    assert retry.budget_remaining() < 64


def test_pooled_post_is_not_reissued(server):
    _fresh_pool()
    before = _retries()
    faults.arm_spec(f"httpd.pool.request=error,n=1,match={server.url}/x")
    with pytest.raises(OSError, match="fault injected"):
        http_bytes("POST", f"{server.url}/x", b"{}", timeout=10)
    assert _retries() == before
    # a POST that declares itself idempotent is re-issued
    _fresh_pool()
    faults.arm_spec(f"httpd.pool.request=error,n=1,match={server.url}/x")
    st, _, _ = http_bytes("POST", f"{server.url}/x", b"{}",
                          {"X-Idempotent": "1"}, timeout=10)
    assert st == 200


def test_pool_connect_site_fires_on_a_fresh_dial(server):
    _fresh_pool()
    faults.arm_spec(f"httpd.pool.connect=error,n=1,match={server.url}")
    assert http_json("GET", f"{server.url}/x", timeout=10) == {"ok": True}
    assert faults.triggered()["httpd.pool.connect"] == 1


@pytest.mark.parametrize("directive", ["truncate", "drop", "error"])
def test_stream_chunk_directives(server, directive):
    faults.arm_spec(f"httpd.stream.chunk={directive},n=1,match=/sink")
    server.got.clear()
    chunks = iter([b"a" * 1000, b"b" * 1000, b"c" * 1000])
    if directive == "truncate":
        # a clean early end: the receiver takes a short body
        st, body = http_stream_request("POST", f"{server.url}/sink",
                                       chunks, timeout=10)
        assert st == 200 and server.got["bytes"] == 0
        return
    exc = faults.FaultInjected if directive == "error" else OSError
    with pytest.raises(exc):
        http_stream_request("POST", f"{server.url}/sink", chunks,
                            timeout=10)


def test_download_and_relay_sites_never_leave_a_short_file(server,
                                                           tmp_path):
    dest = tmp_path / "out.bin"
    faults.arm_spec("httpd.download.chunk=truncate,n=1")
    with pytest.raises(OSError):
        http_download(f"{server.url}/blob", str(dest))
    assert not dest.exists() and not list(tmp_path.iterdir())
    assert http_download(f"{server.url}/blob", str(dest))[0] == 200
    assert dest.read_bytes() == b"b" * (64 << 10)
    faults.arm_spec("httpd.relay.chunk=drop,n=1")
    with pytest.raises(OSError):
        http_relay(f"{server.url}/blob", "POST", f"{server.url}/sink")
    assert http_relay(f"{server.url}/blob", "POST",
                      f"{server.url}/sink")[:2] == (200, 200)


def test_debug_faults_lever_and_health(server):
    url = server.url
    r = http_json("POST", f"{url}/debug/faults",
                  {"site": "master.heartbeat", "action": "delay", "ms": 1,
                   "n": 1}, timeout=10)
    assert r["armedCount"] == 1
    listed = http_json("GET", f"{url}/debug/faults", timeout=10)
    assert [a["site"] for a in listed["armed"]] == ["master.heartbeat"]
    r = http_json("POST", f"{url}/debug/faults",
                  {"spec": "a=error,n=1;b=truncate"}, timeout=10)
    assert r["armedCount"] == 2
    r = http_json("POST", f"{url}/debug/faults", {"clear": "a"}, timeout=10)
    assert sorted(a["site"] for a in r["armed"]) == \
        ["b", "master.heartbeat"]
    http_json("POST", f"{url}/debug/faults", {"clear": True}, timeout=10)
    assert http_json("GET", f"{url}/debug/faults",
                     timeout=10)["armed"] == []
    for bad in ({"spec": "bogus-entry-no-equals"}, {"nothing": 1},
                {"site": "x", "action": "explode"}):
        assert "error" in http_json("POST", f"{url}/debug/faults", bad,
                                    timeout=10)
    health = http_json("GET", f"{url}/debug/health", timeout=10)
    assert health["retryBudgetRemaining"] == retry.budget_remaining()
