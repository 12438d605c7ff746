"""The port's QoS plane (`seaweedfs_tpu_torch/qos.py`) held against the
JAX package's (`seaweedfs_tpu/qos.py`) on the same inputs, made from a
numpy seed: token-bucket and admission decisions under one stepped
clock, `tenant_of` on the same requests, `load_qos_toml` on the same
files (malformed ones included), `histogram_p99` on seeded buckets, the
feedback throttle's pace sequence for the same histogram snapshots, and
response metering.  Tolerance: exact equality (the retry-after times
and p99s are float expressions evaluated in the same order).

Port-only cases: the native planes' drained walls reach the throttle's
signal (counted), `ec_pace` counts and sleeps, and the CLI loads `[qos]`
from `-securityToml` (a malformed section exits 2).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu import qos as ref_qos
from seaweedfs_tpu import security as ref_security
from seaweedfs_tpu.stats import Metrics as RefMetrics
from seaweedfs_tpu_torch import profiling, qos, stats
from seaweedfs_tpu_torch.stats import Metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = (qos, ref_qos)


@pytest.fixture(autouse=True)
def _isolation():
    for m in BOTH:
        m.throttle().stop()
        m.reset()
    yield
    for m in BOTH:
        m.throttle().stop()
        m.reset()


class _Clock:
    """A stand-in for the `time` module of both qos modules: monotonic()
    is a stepped value, sleep() advances it."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s

    def time(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for m in BOTH:
        monkeypatch.setattr(m, "time", c)
    return c


# -- token buckets and admission under one clock -----------------------------

@pytest.mark.parametrize("rate,burst,seed", [
    (10.0, 2.0, 1), (0.5, 0.5, 2), (3.0, 0.0, 3), (0.0, 0.0, 4),
    (16.0, 3.0, 5)])
def test_token_bucket_decisions_match(clock, rate, burst, seed):
    rng = np.random.default_rng(seed)
    buckets = [m.TokenBucket(rate, burst) for m in BOTH]
    out = [[], []]
    for step in rng.exponential(0.05, 200):
        clock.now += float(step)
        n = float(rng.choice([1.0, 1.0, 2.0, 0.5]))
        for i, b in enumerate(buckets):
            out[i].append(b.try_take(n))
    assert out[0] == out[1]
    assert any(w > 0 for w in out[0]) == (rate > 0)


def _config(m, case: str):
    L = m.TenantLimit
    if case == "tenant":
        return m.QosConfig(enabled=True,
                           tenants={"noisy": L(rps=2, burst=2)})
    if case == "default":
        return m.QosConfig(enabled=True, default=L(rps=1, burst=3))
    if case == "bytes":
        return m.QosConfig(enabled=True, default=L(rps=50, burst=50,
                                                   inflight_mb=1))
    if case == "disabled":
        return m.QosConfig(enabled=False,
                           tenants={"noisy": L(rps=1, burst=1)})
    return m.QosConfig(enabled=True,
                       tenants={"noisy": L(rps=0.5, burst=0.5),
                                "calm": L(rps=5, burst=1)})


@pytest.mark.parametrize("case", ["tenant", "default", "bytes",
                                  "disabled", "subone"])
def test_admission_decisions_match(clock, case):
    rng = np.random.default_rng(
        ["tenant", "default", "bytes", "disabled", "subone"].index(case))
    ctls = [m.AdmissionController(_config(m, case)) for m in BOTH]
    held = [[], []]
    seen = [[], []]
    for _ in range(300):
        clock.now += float(rng.exponential(0.2))
        tenant = str(rng.choice(["noisy", "calm", "anonymous"]))
        nbytes = int(rng.choice([0, 100 << 10, 400 << 10, 900 << 10]))
        release_one = bool(rng.random() < 0.4)
        for i, ctl in enumerate(ctls):
            release, rej = ctl.admit(tenant, nbytes)
            seen[i].append(None if rej is None
                           else (rej.reason, rej.retry_after))
            held[i].append(release)
            if release_one and held[i]:
                held[i].pop(0)()
            seen[i].append(ctl.inflight_of(tenant))
    assert seen[0] == seen[1]
    assert ctls[0].snapshot() == ctls[1].snapshot()


def test_admit_bytes_and_charge_response_match(clock):
    class R:
        headers = {"X-Tenant": "reader"}
        query = {}
    for m in BOTH:
        m.configure(m.QosConfig(enabled=True, tenants={
            "reader": m.TenantLimit(rps=100, inflight_mb=1)}))
    got = []
    for m in BOTH:
        rel1, deny1 = m.charge_response(R, 700 << 10, "volume")
        rel2, deny2 = m.charge_response(R, 700 << 10, "volume")
        body = m.MeteredBody(b"x" * 10, rel1)
        assert body.read(4) == b"xxxx" and body.read() == b"x" * 6
        body.close()
        body.close()                  # a second close releases nothing
        rel3, deny3 = m.charge_response(R, 700 << 10, "volume")
        got.append((deny1 is None, deny2[0], deny2[1][1]["Retry-After"],
                    deny3 is None, m.controller().inflight_of("reader")))
        rel3()
    assert got[0] == got[1] == (True, 503, "1", True, 700 << 10)


# -- tenant_of -------------------------------------------------------------------

class _Req:
    def __init__(self, headers=None, query=None):
        self.headers = headers or {}
        self.query = query or {}


def _requests():
    tok_admin = ref_security.gen_jwt("k", {"admin": True}, 60)
    tok_user = ref_security.gen_jwt("k", {"principal": "alice"}, 60)
    tok_sub = ref_security.gen_jwt("k", {"sub": "bob" * 30}, 60)
    return [
        _Req({"Authorization": "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/"
              "20260803/us-east-1/s3/aws4_request, SignedHeaders=host, "
              "Signature=abc"}),
        _Req({"Authorization": "AWS4-HMAC-SHA256 Credential=,x"}),
        _Req(query={"X-Amz-Credential":
                    "AKPRESIGN/20260803/us-east-1/s3/aws4_request"}),
        _Req({"X-Tenant": "loadgen-7" * 10}),
        _Req({"Authorization": f"Bearer {tok_admin}"}),
        _Req({"Authorization": f"bearer {tok_user}"}),
        _Req({"Authorization": f"Bearer {tok_sub}"}),
        _Req({"Authorization": "Bearer not-a-jwt"}),
        _Req({"Authorization": "Basic dXNlcjpwdw=="}),
        _Req(),
    ]


@pytest.mark.parametrize("i", range(10))
def test_tenant_of_matches(i):
    req = _requests()[i]
    assert qos.tenant_of(req) == ref_qos.tenant_of(req)


# -- load_qos_toml -----------------------------------------------------------------

TOMLS = {
    "full": """[admin]\nkey = "k"\n[qos]\nenabled = true\nslo_p99_ms = 150
pace_max_ms = 500\ncheck_interval_ms = 250\n[qos.default]\nrps = 100
burst = 200\ninflight_mb = 64\n[qos.tenants.noisy]\nrps = 5\nburst = 5\n""",
    "slo_only": "[qos]\nslo_p99_ms = 40\npace_min_ms = 25\n",
    "absent": '[admin]\nkey = "k"\n',
    "disabled": "[qos]\nenabled = false\n[qos.tenants.a]\nrps = 1\n",
    "negative": "[qos]\n[qos.default]\nrps = -3\n",
    "negative_tenant": "[qos]\n[qos.tenants.x]\ninflight_mb = -1\n",
    "bad_number": '[qos]\nslo_p99_ms = "fast"\n',
    "not_toml": "[qos\nrps = 1\n",
}


@pytest.mark.parametrize("name", sorted(TOMLS))
def test_load_qos_toml_matches(tmp_path, name):
    p = tmp_path / "security.toml"
    p.write_text(TOMLS[name])
    results = []
    for m in BOTH:
        try:
            cfg = m.load_qos_toml(str(p))
            results.append(None if cfg is None else cfg.to_json())
        except ValueError as e:
            results.append(type(e).__name__)
    assert results[0] == results[1]


@pytest.mark.parametrize("d", [{"rps": -5}, {"burst": -1},
                               {"inflightMb": -1}, {"rps": 3, "burst": 1,
                                                    "inflight_mb": 2}])
def test_tenant_limit_from_json_matches(d):
    out = []
    for m in BOTH:
        try:
            out.append(m.TenantLimit.from_json(d).to_json())
        except ValueError:
            out.append("ValueError")
    assert out[0] == out[1]


# -- the foreground p99 and the throttle ---------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_histogram_p99_matches_on_seeded_buckets(seed):
    rng = np.random.default_rng(seed)
    buckets = tuple(sorted(float(x) for x in
                           rng.uniform(0.001, 5.0, int(rng.integers(1, 12)))))
    for _ in range(20):
        counts = [int(c) for c in rng.integers(0, 50, len(buckets) + 1)]
        if rng.random() < 0.2:
            counts = [0] * len(counts)
        q = float(rng.choice([0.5, 0.9, 0.99]))
        assert qos.histogram_p99(buckets, counts, q) == \
            ref_qos.histogram_p99(buckets, counts, q)


@pytest.mark.parametrize("seed", range(4))
def test_throttle_pace_sequence_matches(seed):
    """The same cumulative histogram snapshots through both throttles'
    `sample_now` give the same pace and p99 after every sample."""
    rng = np.random.default_rng(100 + seed)
    buckets = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
    for m in BOTH:
        m.controller().configure(m.QosConfig(
            enabled=True, slo_p99_ms=float(rng.choice([30, 60])),
            pace_min_ms=25, pace_max_ms=200))
    cum = [0] * (len(buckets) + 1)
    snaps = []
    for _ in range(30):
        slow = rng.random() < 0.5
        for _ in range(int(rng.integers(0, 40))):
            i = int(rng.integers(3 if slow else 0,
                                 len(cum) if slow else 3))
            cum[i] += 1
        snaps.append({"buckets": buckets, "counts": list(cum)})
    throttles = [m.FeedbackThrottle() for m in BOTH]
    box = [None]
    for th in throttles:
        th._sources = [("unit", lambda: box[0])]
    paces = [[], []]
    for snap in snaps:
        box[0] = snap
        for i, th in enumerate(throttles):
            paces[i].append((th.sample_now(), th.p99()))
    assert paces[0] == paces[1]
    assert any(p > 0 for p, _ in paces[0])


def test_local_sources_merge_request_and_plane_histograms():
    m = Metrics("volume_server")
    th = qos.FeedbackThrottle()
    th.add_metrics("unit", m, names=("request_seconds",
                                     "plane_request_seconds"))
    qos.controller().configure(qos.QosConfig(enabled=True, slo_p99_ms=10))
    m.histogram_observe("request_seconds", 0.001, method="GET", code="200")
    th.sample_now()
    for _ in range(50):
        m.histogram_observe("plane_request_seconds", 0.2, plane="read")
    assert th.sample_now() == pytest.approx(0.025)
    assert 0.1 < th.p99() <= 0.25
    before = stats.PROCESS.counter_value("qos_foreground_samples_total",
                                         source="unit") or 0.0
    for _ in range(10):
        m.histogram_observe("request_seconds", 0.001, method="GET",
                            code="200")
    th.sample_now()
    assert stats.PROCESS.counter_value("qos_foreground_samples_total",
                                       source="unit") == before + 10


def test_drained_plane_records_reach_the_throttle():
    """A native plane's drained records land in plane_request_seconds,
    which a volume server's second throttle source reads: a foreground
    served by the read plane alone moves the pace."""
    from seaweedfs_tpu_torch import native
    reg = Metrics("seaweedfs_tpu")
    sink = profiling.PlaneRecordSink(
        "volume", "read", "GET", ("parse", "lookup", "send", "ack"),
        ("none", "method", "bad_request", "not_found"), metrics=reg)
    th = qos.FeedbackThrottle()
    th.add_metrics("planes", reg, names=("plane_request_seconds",))
    qos.controller().configure(qos.QosConfig(enabled=True, slo_p99_ms=50,
                                             pace_min_ms=25))
    th.sample_now()
    buf = (native.PlaneRecord * 64)()
    for i in range(64):
        buf[i].stage_ns[2] = 300_000_000       # 300 ms on the wire
        buf[i].status = 200
    assert sink.feed_buffer(buf, 64) == 64
    assert th.sample_now() == pytest.approx(0.025)
    assert reg.histogram_merged("plane_request_seconds")["count"] == 64


def test_ec_pace_counts_and_sleeps():
    qos.throttle().set_pace(0.03)
    before = stats.PROCESS.counter_value("qos_ec_paced_total",
                                         kind="encode") or 0.0
    t0 = time.monotonic()
    assert qos.ec_pace("encode") == pytest.approx(0.03)
    assert time.monotonic() - t0 >= 0.03
    assert stats.PROCESS.counter_value("qos_ec_paced_total",
                                       kind="encode") == before + 1
    qos.throttle().set_pace(0.0)
    assert qos.ec_pace("encode") == 0.0


def test_remote_slo_watch_refcounts_shared_urls():
    qos.controller().configure(qos.QosConfig(enabled=True, slo_p99_ms=100))
    url = "127.0.0.1:1"
    a = qos.remote_slo_watch([url])
    b = qos.remote_slo_watch([url, "127.0.0.1:2"])
    a.__enter__()
    b.__enter__()
    a.__exit__(None, None, None)
    assert f"remote:{url}" in qos.throttle().snapshot()["sources"]
    b.__exit__(None, None, None)
    labels = qos.throttle().snapshot()["sources"]
    assert f"remote:{url}" not in labels and \
        "remote:127.0.0.1:2" not in labels
    qos.throttle().stop()


def test_scrape_of_a_remote_role_matches_reference():
    from seaweedfs_tpu_torch.server.httpd import HttpServer
    m = RefMetrics("volume_server")
    rng = np.random.default_rng(7)
    for v in rng.exponential(0.05, 300):
        m.histogram_observe("request_seconds", float(v), method="GET",
                            code="200")
    http = HttpServer()
    http.route("GET", "/metrics",
               lambda req: (200, (m.render().encode(), "text/plain")))
    http.start()
    try:
        assert qos._scrape_request_seconds(http.url) == \
            ref_qos._scrape_request_seconds(http.url)
    finally:
        http.stop()


def test_anonymous_limited():
    assert not qos.anonymous_limited()
    qos.configure(qos.QosConfig(enabled=True, slo_p99_ms=100))
    assert not qos.anonymous_limited()
    qos.controller().set_tenant("noisy", qos.TenantLimit(rps=1))
    assert not qos.anonymous_limited()
    qos.controller().set_tenant("*", qos.TenantLimit(rps=1))
    assert qos.anonymous_limited()
    qos.controller().set_enabled(False)
    assert not qos.anonymous_limited()
    qos.throttle().stop()


# -- the CLI ---------------------------------------------------------------------------

def _first_line(proc) -> str:
    line = proc.stdout.readline()
    assert line, proc.stderr.read()
    return line.strip()


def test_security_toml_qos_is_loaded_and_malformed_exits_2(tmp_path):
    from seaweedfs_tpu_torch.server.httpd import http_json
    good = tmp_path / "good.toml"
    good.write_text("[qos]\nslo_p99_ms = 40\n[qos.tenants.noisy]\n"
                    "rps = 2\nburst = 2\n")
    bad = tmp_path / "bad.toml"
    bad.write_text("[qos]\n[qos.tenants.noisy]\nrps = -1\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                        "-securityToml", str(bad), "master", "-port", "0"],
                       capture_output=True, text=True, env=env,
                       timeout=60)
    assert r.returncode == 2 and str(bad) in r.stderr and \
        "limits must be >= 0" in r.stderr
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "-securityToml",
         str(good), "master", "-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = _first_line(proc)
        url = line.rsplit(" ", 1)[-1]
        snap = http_json("GET", f"{url}/debug/qos", timeout=10)
        assert snap["config"]["sloP99Ms"] == 40.0
        assert snap["config"]["tenants"]["noisy"]["rps"] == 2.0
        assert snap["throttle"]["running"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# -- brownout shedding and resize-on-read ------------------------------------------------

@pytest.mark.parametrize("remaining_s", [0.05, 2.0])
def test_brownout_sheds_like_the_reference(remaining_s):
    """After 30 half-second requests, a request whose deadline leaves
    less than the median is shed (503, reason brownout) by both
    admissions; one with more budget is admitted."""
    from seaweedfs_tpu.util import deadline as ref_deadline
    from seaweedfs_tpu_torch.util import deadline
    out = []
    for m, dl in ((qos, deadline), (ref_qos, ref_deadline)):
        class _Fake:
            admission = None
        fake = _Fake()
        m.install(fake, "unit")
        for _ in range(30):
            m.note_latency(0.5)
        req = _Req({"X-Tenant": "t"})
        req.path = "/data"
        with dl.scope(remaining_s):
            deny, release = fake.admission(req)
        if release is not None:
            release()
        out.append(None if deny is None else
                   (deny[0], deny[1][1]["Retry-After"], deny[1][0]))
    assert out[0] == out[1]
    assert (out[0] is not None) == (remaining_s < 0.5)


@pytest.mark.parametrize("mode,w,h", [("", 40, 0), ("", 0, 30),
                                      ("", 25, 25), ("fit", 20, 10),
                                      ("fill", 20, 10), ("", 500, 500)])
def test_resized_matches_reference(mode, w, h):
    import io

    from PIL import Image

    from seaweedfs_tpu import images as ref_images
    from seaweedfs_tpu_torch import images
    rng = np.random.default_rng(w * 31 + h)
    img = Image.fromarray(rng.integers(0, 256, (48, 64, 3),
                                       dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = buf.getvalue()
    got = images.resized(data, "image/png", w, h, mode)
    assert got == ref_images.resized(data, "image/png", w, h, mode)
    assert (got == data) == (w >= 64 or h >= 48 and not w)
    assert images.resized(b"not an image", "image/png", w, h, mode) == \
        b"not an image"
