"""The port's deadline plane (`util/deadline`) on the CPU, held against
the JAX package's `seaweedfs_tpu/util/deadline.py`.  Tolerance: exact
equality of parsed budgets to the microsecond, of statuses and headers;
wall-clock bounds as stated in each test.

- `parse_header`, `adopt` (with and without the operator default),
  `stamp_headers`, `io_timeout` and `reraise_if_expired` give the JAX
  module's answers on the same inputs, and the two 504 answers are the
  same;
- the port's HTTP server answers 504 with `Retry-After` to a spent
  budget before the handler runs, binds a live budget for the handler,
  applies the operator default except on `/admin/` and `/debug/`, and
  answers 504 when the budget runs out on an outbound hop; the client
  forwards what is left of the budget;
- a shard read against a wedged peer (a socket that accepts and never
  answers) and a client read of a wedged location return within the
  budget, not after their 10 s and 60 s timeouts;
- a fan-out's worker threads (`MultiSourceFetcher`) forward the
  caller's budget.
"""

import socket
import threading
import time

import pytest

from seaweedfs_tpu.util import deadline as ref_dl
from seaweedfs_tpu_torch import operation, stats
from seaweedfs_tpu_torch.server import store_ec
from seaweedfs_tpu_torch.server.httpd import HttpServer, http_bytes
from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
    MultiSourceFetcher, RemoteShardSource)
from seaweedfs_tpu_torch.util import deadline as dl


def _budget(d):
    return None if d is None else round(d.budget, 6)


@pytest.mark.parametrize("value", [None, "", "abc", "nan", "inf", "-inf",
                                   "-5", "0", "1", "1500", "2.5", "1e3"])
def test_parse_header_matches_reference(value):
    assert _budget(dl.parse_header(value)) == \
        _budget(ref_dl.parse_header(value))


@pytest.mark.parametrize("header", [None, "250", "garbage"])
@pytest.mark.parametrize("default", ["", "0", "800", "x", "inf"])
@pytest.mark.parametrize("allow_default", [True, False])
def test_adopt_matches_reference(monkeypatch, header, default,
                                 allow_default):
    monkeypatch.setenv("SEAWEEDFS_TPU_DEADLINE_DEFAULT_MS", default)
    got = dl.adopt(header, site="t", allow_default=allow_default)
    want = ref_dl.adopt(header, site="t", allow_default=allow_default)
    try:
        assert _budget(got) == _budget(want)
        assert dl.get() is got and ref_dl.get() is want
    finally:
        dl.adopt(None, allow_default=False)
        ref_dl.adopt(None, allow_default=False)
    assert dl.get() is None


def test_stamp_headers_matches_reference():
    for headers in ({}, {"A": "b"}, {dl.HEADER: "7"}):
        assert dl.stamp_headers(headers) == ref_dl.stamp_headers(headers) \
            == headers
    with dl.scope(5.0), ref_dl.scope(5.0):
        for headers in ({}, {"A": "b"}, {dl.HEADER: "7"}):
            got = dl.stamp_headers(headers)
            want = ref_dl.stamp_headers(headers)
            assert got.keys() == want.keys()
            if dl.HEADER in headers:
                assert got[dl.HEADER] == want[dl.HEADER] == "7"
            else:
                assert 4000 < int(got[dl.HEADER]) <= 5000
                assert abs(int(got[dl.HEADER]) -
                           int(want[dl.HEADER])) <= 5
            assert dl.HEADER not in headers or headers[dl.HEADER] == "7"


def test_io_timeout_and_reraise_match_reference():
    assert dl.io_timeout(3.0, "s") == ref_dl.io_timeout(3.0, "s") == 3.0
    dl.reraise_if_expired("s")
    ref_dl.reraise_if_expired("s")
    with dl.scope(0.5), ref_dl.scope(0.5):
        assert dl.io_timeout(10.0) <= 0.5 and ref_dl.io_timeout(10.0) <= 0.5
        assert dl.io_timeout(0.2) == ref_dl.io_timeout(0.2) == 0.2
        dl.reraise_if_expired("s")
        ref_dl.reraise_if_expired("s")
    with dl.scope(0.01), ref_dl.scope(0.01):
        assert dl.io_timeout(10.0) == ref_dl.io_timeout(10.0) == \
            dl.MIN_TIMEOUT == ref_dl.MIN_TIMEOUT
    before = stats.PROCESS.counter_value("deadline_exceeded_total",
                                         site="t.spent") or 0.0
    with dl.scope(0.0), ref_dl.scope(0.0):
        for mod in (dl, ref_dl):
            with pytest.raises(mod.DeadlineExceeded) as e:
                mod.io_timeout(1.0, "t.spent")
            assert isinstance(e.value, OSError)
            assert e.value.site == "t.spent"
            with pytest.raises(mod.DeadlineExceeded):
                mod.reraise_if_expired("t.spent")
    assert stats.PROCESS.counter_value(
        "deadline_exceeded_total", site="t.spent") == before + 2


def test_responses_match_reference():
    for ours, theirs in ((dl.expired_response("x.ingress"),
                          ref_dl.expired_response("x.ingress")),
                         (dl.handler_exceeded_response(),
                          ref_dl.handler_exceeded_response())):
        assert ours == theirs
        assert ours[0] == 504 and ours[1][1]["Retry-After"] == "1"


def test_use_rebinds_and_restores_on_a_thread():
    seen = []
    with dl.scope(2.0) as d:
        def work():
            seen.append(dl.get())
            with dl.use(d):
                seen.append(dl.get())
            seen.append(dl.get())
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
    assert seen == [None, d, None]


# --- the HTTP server and client ------------------------------------------

@pytest.fixture
def server():
    srv = HttpServer()
    srv.role = "volume"
    calls = []

    def echo(req):
        calls.append((req.path, dl.remaining(),
                      req.headers.get(dl.HEADER)))
        return 200, {"remaining": dl.remaining()}
    srv.route("GET", "/echo", echo)
    srv.route("GET", "/admin/echo", echo)
    srv.start()
    try:
        yield srv, calls
    finally:
        srv.stop()


def test_spent_budget_answers_504_before_the_handler(server):
    srv, calls = server
    before = stats.PROCESS.counter_value("deadline_exceeded_total",
                                         site="volume.ingress") or 0.0
    st, body, hdrs = http_bytes("GET", f"{srv.url}/echo", timeout=10,
                                headers={dl.HEADER: "0"})
    assert (st, hdrs["Retry-After"]) == (504, "1")
    assert b"deadline exceeded" in body
    assert calls == []
    assert stats.PROCESS.counter_value(
        "deadline_exceeded_total", site="volume.ingress") == before + 1
    st, _b, _h = http_bytes("GET", f"{srv.url}/echo", timeout=10,
                            headers={dl.HEADER: "5000"})
    assert st == 200 and len(calls) == 1 and 4.0 < calls[0][1] <= 5.0


def test_operator_default_skips_admin_routes(server, monkeypatch):
    srv, calls = server
    monkeypatch.setenv("SEAWEEDFS_TPU_DEADLINE_DEFAULT_MS", "3000")
    http_bytes("GET", f"{srv.url}/echo", timeout=10)
    http_bytes("GET", f"{srv.url}/admin/echo", timeout=10)
    http_bytes("GET", f"{srv.url}/admin/echo", timeout=10,
               headers={dl.HEADER: "900"})
    assert 2.0 < calls[0][1] <= 3.0
    assert calls[1][1] is None
    assert 0.5 < calls[2][1] <= 0.9


def test_client_forwards_the_remaining_budget(server):
    srv, calls = server
    front = HttpServer()

    def relay(req):
        time.sleep(0.2)
        st, body, _ = http_bytes("GET", f"{srv.url}/echo", timeout=10)
        return st, body
    front.route("GET", "/relay", relay)
    front.start()
    try:
        st, _b, _h = http_bytes("GET", f"{front.url}/relay", timeout=10,
                                headers={dl.HEADER: "2000"})
    finally:
        front.stop()
    assert st == 200
    (_path, remaining, header), = calls
    assert remaining < 1.85 and 1700 < int(header) < 1850


def test_budget_spent_on_an_outbound_hop_answers_504(server):
    srv, _calls = server
    wedged = _Wedged()
    front = HttpServer()

    def hop(req):
        t = dl.io_timeout(60.0, site="test.hop")
        try:
            http_bytes("GET", f"{wedged.url}/x", timeout=t)
        except OSError:
            dl.reraise_if_expired("test.hop")
            raise
        return 200, {}
    front.route("GET", "/hop", hop)
    front.start()
    try:
        t0 = time.monotonic()
        st, _b, hdrs = http_bytes("GET", f"{front.url}/hop", timeout=10,
                                  headers={dl.HEADER: "300"})
        assert time.monotonic() - t0 < 3.0
    finally:
        front.stop()
        wedged.close()
    assert (st, hdrs["Retry-After"]) == (504, "1")


class _Wedged:
    """A peer that accepts connections and never answers."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.url = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self.held = []
        self._t = threading.Thread(target=self._accept, daemon=True)
        self._t.start()

    def _accept(self):
        while True:
            try:
                self.held.append(self.sock.accept()[0])
            except OSError:
                return

    def close(self):
        self.sock.close()
        for c in self.held:
            c.close()


def test_shard_read_of_a_wedged_peer_ends_with_the_budget():
    wedged = _Wedged()
    reader = store_ec.EcReader("", "self:1")
    try:
        t0 = time.monotonic()
        with dl.scope(0.4):
            with pytest.raises(dl.DeadlineExceeded) as e:
                reader._remote_read(wedged.url, 1, 0, 0, 100)
        assert time.monotonic() - t0 < 2.0
        assert e.value.site == "ec.shard_read"
        # the budget's verdict, not the peer's: no failover counted
        assert stats.PROCESS.counter_value(
            "ec_read_source_failovers_total", peer=wedged.url) is None
    finally:
        reader.close()
        wedged.close()


def test_client_read_of_a_wedged_location_ends_with_the_budget(
        monkeypatch):
    wedged = _Wedged()
    monkeypatch.setattr(operation, "lookup",
                        lambda master, vid, use_cache=True:
                        [{"url": wedged.url}])
    try:
        t0 = time.monotonic()
        with dl.scope(0.4):
            with pytest.raises(dl.DeadlineExceeded) as e:
                operation.read("m:1", "3,01637037d6")
        assert time.monotonic() - t0 < 2.0
        assert e.value.site == "volume.read"
    finally:
        wedged.close()


def test_fetcher_threads_forward_the_budget():
    seen = []
    srv = HttpServer()

    def shard_read(req):
        seen.append(req.headers.get(dl.HEADER))
        return 200, bytes(int(req.query["size"]))
    srv.route("GET", "/admin/ec/shard_read", shard_read)
    srv.start()
    try:
        work = [(0, 4096), (4096, 4096)]
        with dl.scope(30.0):
            fetcher = MultiSourceFetcher(
                {2: RemoteShardSource([srv.url], 1, 2)}, work)
            try:
                for item in work:
                    buf = bytearray(item[1])
                    assert fetcher.get(item, rows={2: memoryview(buf)}) \
                        == {2: item[1]}
            finally:
                fetcher.close()
    finally:
        srv.stop()
    assert seen and all(h is not None and 0 < int(h) <= 30_000
                        for h in seen)
