"""The port's push-gateway loop (`seaweedfs_tpu_torch/stats.MetricsPusher`)
and each role's `-metricsAddress` on the CPU, against the JAX package's.
Tolerance: exact equality of the pushed request (method, path, content
type, body) and of each role's push path and printed line.

- one registry pushed by each package's `MetricsPusher` reaches a
  pushgateway stand-in as the same PUT;
- a refused push (nothing listening, then a 500) is counted, logged
  once and retried at the next tick, never fatal: the loop pushes again
  once the gateway answers;
- `master`, `volume`, `filer` and `s3` of both packages with
  `-metricsAddress` pointed at the stand-in print the same line and push
  to the same job, the instance being the role's own address.
"""

import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.parse

import pytest

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.server.httpd import HttpServer
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.util import wlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Gateway:
    """A pushgateway stand-in: every request kept, answered with
    `status` (a list is taken from the front, one a request)."""

    def __init__(self, status=200):
        self.status = status
        self.got: list = []
        self.lock = threading.Lock()
        self.http = HttpServer()
        self.http.fallback = self._take
        self.http.start()

    def _take(self, req):
        with self.lock:
            self.got.append((req.method, req.path,
                             req.headers.get("Content-Type", ""),
                             req.body))
            st = self.status.pop(0) if isinstance(self.status, list) \
                else self.status
        return st, {}

    @property
    def url(self) -> str:
        return self.http.url

    def stop(self) -> None:
        self.http.stop()


@pytest.fixture
def gateway():
    g = Gateway()
    yield g
    g.stop()


def _registry(mod):
    m = mod.Metrics("master")
    m.counter_add("requests_total", 3.0, help_text="requests",
                  method="GET")
    m.counter_add("requests_total", 1.0, help_text="requests",
                  method="POST")
    m.gauge_set("volumes", 7.0, help_text="volumes held")
    m.histogram_observe("latency_seconds", 0.004, help_text="latency")
    return m


def test_the_same_push_from_both_packages(gateway):
    for mod in (stats, ref_stats):
        p = mod.MetricsPusher(_registry(mod), "master", "127.0.0.1:9333",
                              gateway.url, 15)
        assert p.push_once() is True
    port, ref = gateway.got
    assert port == ref
    assert port[:3] == ("PUT", "/metrics/job/master/instance/"
                        + urllib.parse.quote("127.0.0.1:9333"),
                        "text/plain; version=0.0.4")
    assert b'requests_total{method="GET"} 3' in port[3]


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__()
        self.msgs: list = []

    def emit(self, record):
        self.msgs.append(record.getMessage())


def test_a_refused_push_is_logged_and_retried():
    # nothing listens: refused, counted, one warning for the streak
    closed = Gateway()
    closed.stop()
    h = _Warnings()
    wlog._logger.addHandler(h)
    try:
        p = stats.MetricsPusher(stats.Metrics("s3"), "s3", "x",
                                closed.url, 0.05)
        ref = ref_stats.MetricsPusher(ref_stats.Metrics("s3"), "s3", "x",
                                      closed.url, 0.05)
        assert p.push_once() is False and ref.push_once() is False
        assert p.push_once() is False
        assert p.failed == 2 and p.pushed == 0
        assert len([m for m in h.msgs if "metrics push" in m]) == 1
        # a gateway that answers 500 twice, then 200: the loop lives on
        g = Gateway(status=[500, 500])
        try:
            g.status += [200] * 1000
            p = stats.MetricsPusher(stats.Metrics("s3"), "s3", "x", g.url,
                                    0.05).start()
            deadline = time.monotonic() + 15
            while p.pushed < 2:
                assert time.monotonic() < deadline, (p.pushed, p.failed)
                time.sleep(0.02)
            p.stop()
            assert p.failed == 2 and not p._thread.is_alive()
        finally:
            g.stop()
        assert len([m for m in h.msgs if "metrics push" in m]) == 2
    finally:
        wlog._logger.removeHandler(h)


def _role_argv(role: str, tmp, master: str) -> list:
    return {"master": ["master", "-port", "0"],
            "volume": ["volume", "-port", "0", "-dir", str(tmp),
                       "-mserver", master],
            "filer": ["filer", "-port", "0", "-master", master, "-store",
                      str(tmp / "filer.db")],
            "s3": ["s3", "-port", "0", "-master", master, "-store",
                   str(tmp / "s3.db")]}[role]


JOBS = {"master": "master", "volume": "volume_server", "filer": "filer",
        "s3": "s3"}


@pytest.mark.parametrize("role", ["master", "volume", "filer", "s3"])
def test_each_role_pushes_to_its_gateway(role, tmp_path, gateway):
    master = MasterServer().start()
    got = {}
    try:
        for module in ("seaweedfs_tpu_torch", "seaweedfs_tpu"):
            d = tmp_path / module
            d.mkdir()
            p = subprocess.Popen(
                [sys.executable, "-m", module] +
                _role_argv(role, d, master.url) +
                ["-metricsAddress", gateway.url, "-metricsIntervalSec",
                 "1"], cwd=str(d), stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True,
                env={**os.environ, "JAX_PLATFORMS": "cpu",
                     "PYTHONPATH": REPO})
            try:
                # the JAX roles print the push line before the
                # listening line, the port's after it
                lines = []
                while not (any(ln.startswith("pushing") for ln in lines)
                           and any("listening on" in ln for ln in lines)):
                    ln = p.stdout.readline()
                    assert ln, (module, lines)
                    lines.append(ln)
                listening = [ln for ln in lines if "listening on" in ln]
                url = re.search(r"listening on (\S+:\d+)",
                                listening[0]).group(1)
                path = (f"/metrics/job/{JOBS[role]}/instance/"
                        f"{urllib.parse.quote(url)}")
                deadline = time.monotonic() + 30
                while not any(g[1] == path for g in gateway.got):
                    assert time.monotonic() < deadline, gateway.got
                    time.sleep(0.05)
                got[module] = [ln for ln in lines
                               if ln.startswith("pushing")]
            finally:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                p.stdout.close()
    finally:
        master.stop()
    every = "" if role == "volume" else " every 1s"
    assert got["seaweedfs_tpu_torch"] == got["seaweedfs_tpu"] == [
        f"pushing metrics to {gateway.url}{every}\n"]
