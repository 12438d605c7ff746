"""The port's observability core (`profiling`, `stats`) against the JAX
package's, on the same seeded inputs: the folded-stack merge and the
Prometheus-text helpers, the stage track's histograms, the flight
recorder's snapshot, the plane-record sink's histograms and the
process-tree sampler; then the background threads (the sampler, the
scheduler probe, the drainers) start and stop cleanly.  Also the C9
repair: the IAM store's group grants fail closed when the policy
translation cannot be imported.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu import profiling as ref_profiling
from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu import native as ref_native
from seaweedfs_tpu_torch import native, profiling, stats


def stop_background_probes() -> None:
    """Stop both packages' scheduler probes (each package's filer and
    volume server start one a process, and neither stops it) and the
    port's sampler, so no thread of a finished test writes into another
    test's registry."""
    profiling.stop_sched_probe()
    profiling.sampler().stop()
    probe = ref_profiling._sched_probe
    if probe is not None:
        probe.stop()
        if probe._thread is not None:
            probe._thread.join(timeout=5)
        ref_profiling._sched_probe = None


@pytest.fixture
def registries(monkeypatch):
    stop_background_probes()
    port = stats.Metrics("seaweedfs_tpu")
    ref = ref_stats.Metrics("seaweedfs_tpu")
    monkeypatch.setattr(stats, "PROCESS", port)
    monkeypatch.setattr(ref_stats, "PROCESS", ref)
    return port, ref


# -- the client half: merge_folded and the Prometheus-text helpers ----------

def _folded_tables(rng) -> list:
    frames = ["a.py:f", "b.py:g", "c.py:h", "d.py:k"]
    tables = []
    for _ in range(4):
        t = {}
        for _ in range(20):
            depth = int(rng.integers(1, 5))
            stack = ";".join(rng.choice(frames, depth))
            t[stack] = t.get(stack, 0) + int(rng.integers(1, 50))
        tables.append(t)
    tables.append({"bad;count": "x", "ok;count": "3"})
    tables.append(None)
    return tables


def test_merge_folded_equals_reference():
    tables = _folded_tables(np.random.default_rng(11))
    assert profiling.merge_folded(tables) == \
        ref_profiling.merge_folded(tables)


def _prom_text(rng) -> str:
    m = ref_stats.Metrics("filer")
    for _ in range(300):
        m.histogram_observe("request_seconds", float(rng.exponential(0.05)),
                            method=str(rng.choice(["GET", "PUT"])),
                            code="200")
    m.counter_add("odd_total", 3.0, path='a "quoted"\nline\\x')
    m.gauge_set("in_flight", 2.0)
    return m.render() + "garbage line\n# comment\nnovalue{a=\"b\"} x\n"


def test_prom_helpers_equal_reference():
    rng = np.random.default_rng(5)
    before_text, after_text = _prom_text(rng), _prom_text(rng)
    for mod in (profiling, ref_profiling):
        assert mod.parse_prom_text(after_text) == \
            ref_profiling.parse_prom_text(after_text)
    pb = profiling.parse_prom_text(before_text)
    pa = profiling.parse_prom_text(after_text)
    for match in (None, {"method": "GET"}, {"method": "nope"}):
        for parsed in (pa, pb):
            assert profiling.prom_histogram(
                parsed, "filer_request_seconds", match) == \
                ref_profiling.prom_histogram(
                    parsed, "filer_request_seconds", match)
        h_after = profiling.prom_histogram(pa, "filer_request_seconds",
                                           match)
        h_before = profiling.prom_histogram(pb, "filer_request_seconds",
                                            match)
        delta = profiling.histogram_delta(h_after, h_before)
        assert delta == ref_profiling.histogram_delta(h_after, h_before)
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert profiling.histogram_quantile(delta, q) == \
                ref_profiling.histogram_quantile(delta, q)
    assert profiling.histogram_delta(None, None) is None
    assert profiling.histogram_quantile(None, 0.5) == 0.0


# -- the stage track ----------------------------------------------------------

def _feed_track(mod, metrics_mod, monkeypatch, cpu: bool):
    """A track fed fixed add() calls; the registry's render."""
    m = metrics_mod.Metrics("filer")
    monkeypatch.setenv("SEAWEEDFS_TPU_CPU_SAMPLE", "1" if cpu else "0")
    with mod.track("write", role="filer", metrics=m) as trk:
        for stage, secs in (("recv", 0.0004), ("assign", 0.003),
                            ("upload", 0.012), ("upload", 0.02),
                            ("meta", 0.0011)):
            trk.add(stage, secs, cpu_seconds=secs / 4)
    return m


def test_stage_track_renders_the_reference_text(monkeypatch):
    """Same add() calls, same `write_stage_seconds` cells; the total is
    the track's own wall, so it is compared by count and bucket set."""
    port = _feed_track(profiling, stats, monkeypatch, cpu=False)
    ref = _feed_track(ref_profiling, ref_stats, monkeypatch, cpu=False)

    def cells(m):
        text = m.render()
        return [line for line in text.splitlines()
                if 'stage="total"' not in line]
    assert cells(port) == cells(ref)
    assert port.histogram_merged("write_stage_seconds")["count"] == \
        ref.histogram_merged("write_stage_seconds")["count"] == 5
    summary = profiling.take_last_summary()
    assert profiling.take_last_summary() is None       # taken once
    assert summary["stages"]["upload"] == {"wallMs": 32.0, "calls": 2}
    assert "cpuMs" not in summary["stages"]["upload"]


def test_stage_track_cpu_cells_equal_reference(monkeypatch):
    port = _feed_track(profiling, stats, monkeypatch, cpu=True)
    ref = _feed_track(ref_profiling, ref_stats, monkeypatch, cpu=True)

    def cpu_cells(m):
        return [line for line in m.render().splitlines()
                if "stage_cpu_seconds" in line and 'stage="total"' not in
                line]
    assert cpu_cells(port) == cpu_cells(ref) != []
    assert profiling.take_last_summary()["stages"]["recv"]["cpuMs"] == 0.1


def test_stage_runs_on_a_pool_thread_with_use_track(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_CPU_SAMPLE", "1")
    m = stats.Metrics("filer")
    with profiling.track("write", metrics=m) as trk:
        def work():
            with profiling.use_track(trk):
                with profiling.stage("upload"):
                    time.sleep(0.01)
            with profiling.stage("lost"):   # no track on this thread
                pass
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert set(trk.stages) == {"upload"}
    assert trk.stages["upload"][0] >= 0.01
    profiling.take_last_summary()


def test_stage_timers_off_make_track_a_noop(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_STAGE_TIMERS", "0")
    with profiling.track("write", metrics=stats.Metrics("x")) as trk:
        assert trk is None
        with profiling.stage("recv"):
            pass


# -- the flight recorder --------------------------------------------------------

def _observe_sequence(mod, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_SLOW_MIN_MS", "5")
    fr = mod.FlightRecorder(size=16)
    fr._now = lambda: 100.0          # one rate window for every capture
    rng = np.random.default_rng(7)
    walls = rng.exponential(0.004, 120).tolist()
    walls[50] = walls[90] = 0.5
    for i, w in enumerate(walls):
        status = 503 if i == 70 else 200
        verdict = "deadline" if i == 80 else "ok"
        fr.observe("filer", "PUT", f"/p/{i}", status, w,
                   cpu_s=w / 3 if i % 2 else None, verdict=verdict,
                   trace_id="", deadline={"budgetMs": 100,
                                          "remainingMs": 20}
                   if i == 80 else None,
                   stages={"totalMs": w * 1e3} if i == 90 else None,
                   notes={"hedge": {"issued": True}} if i == 50 else None)
    snap = fr.snapshot()
    for rec in snap["records"]:
        rec.pop("ts")
    return snap


def test_flight_recorder_snapshot_equals_reference(monkeypatch, registries):
    port_snap = _observe_sequence(profiling, monkeypatch)
    ref_snap = _observe_sequence(ref_profiling, monkeypatch)
    assert port_snap == ref_snap
    assert port_snap["captured"] >= 4
    verdicts = {r["verdict"] for r in port_snap["records"]}
    assert {"slow", "error", "deadline"} <= verdicts
    port, ref = registries
    assert port.render() == ref.render()     # flight_records_total{verdict}


# -- the native planes' record sink ---------------------------------------------

def _record_buffer(lib_native, n: int, seed: int):
    rng = np.random.default_rng(seed)
    buf = (lib_native.PlaneRecord * n)()
    for i in range(n):
        r = buf[i]
        r.rid = f"rid-{i:04d}".encode()
        r.start_unix_ns = 1_700_000_000_000_000_000 + i * 1000
        for k in range(4):
            r.stage_ns[k] = int(rng.integers(0, 3_000_000))
        r.bytes = int(rng.integers(0, 1 << 20))
        r.deadline_ms = -1 if i % 3 else int(rng.integers(0, 500))
        r.status = 500 if i % 17 == 0 else 200
        r.fallback = int(rng.integers(0, 4))
        r.flags = int(rng.integers(0, 4))
    return buf


def test_plane_sink_feed_buffer_equals_reference(registries, monkeypatch):
    """The same PlaneRecord buffer through both sinks gives the same
    stage histograms, record counts and captures."""
    monkeypatch.setenv("SEAWEEDFS_TPU_SLOW_MIN_MS", "2")
    monkeypatch.setattr(profiling, "_recorder",
                        profiling.FlightRecorder(size=64))
    monkeypatch.setattr(ref_profiling, "_recorder",
                        ref_profiling.FlightRecorder(size=64))
    # one pinned clock for both rate caps: a real 1 s window that rolls
    # over between the two sinks on a loaded host splits their captures
    for m in (profiling, ref_profiling):
        m._recorder._now = lambda: 1000.0
    port, ref = registries
    stages = ("parse", "lookup", "send", "ack")
    fbs = ("none", "method", "bad_request", "not_found")
    sinks = (profiling.PlaneRecordSink("volume", "read", "GET", stages,
                                       fbs, metrics=port),
             ref_profiling.PlaneRecordSink("volume", "read", "GET",
                                           stages, fbs, metrics=ref))
    for batch in range(3):
        buf_p = _record_buffer(native, 200, batch)
        buf_r = _record_buffer(ref_native, 200, batch)
        assert bytes(buf_p) == bytes(buf_r)
        assert sinks[0].feed_buffer(buf_p, 200) == \
            sinks[1].feed_buffer(buf_r, 200) == 200
    assert sinks[0].captures == sinks[1].captures > 0
    assert sinks[0].records == sinks[1].records == 600

    def families(m):
        # plane_request_seconds is the port's own (the QoS throttle's
        # plane signal), checked below
        return [line for line in m.render().splitlines()
                if ("plane_" in line or "flight_records" in line)
                and "plane_request_seconds" not in line]
    assert families(port) == families(ref)
    walls = port.histogram_merged("plane_request_seconds")
    assert walls["count"] == 600
    assert ref.histogram_merged("plane_request_seconds") is None
    assert native.plane_record_dtype().itemsize == 112


def test_plane_record_drain_of_a_running_plane(registries):
    """A real read plane's ring, drained by its drainer: a 404 request
    lands in plane_records_total and the stage histograms; stop() runs
    the last pass and ends the thread."""
    from seaweedfs_tpu_torch.server.read_plane import ReadPlane
    try:
        rp = ReadPlane()
    except RuntimeError as e:
        pytest.fail(f"the read plane does not build here: {e}")
    port, _ref = registries
    d = rp.start_record_drain(metrics=port)
    assert rp.start_record_drain() is d               # once
    try:
        import socket
        with socket.create_connection(("127.0.0.1", rp.port),
                                      timeout=5) as s:
            s.sendall(b"GET /9,01637037d6 HTTP/1.1\r\nHost: x\r\n\r\n")
            assert s.recv(4096).split(b" ")[1] == b"404"
        deadline = time.monotonic() + 5
        while not port.counter_value("plane_records_total",
                                     plane="read"):
            assert time.monotonic() < deadline, "the drainer fed nothing"
            profiling.run_scrape_hooks()
            time.sleep(0.05)
    finally:
        rp.stop()
    assert not d._thread.is_alive()
    assert d.drain_now not in profiling._scrape_hooks
    assert rp.drain_records() == []


# -- the process-tree sampler --------------------------------------------------

def test_proc_tree_sample_honours_the_tree_root(monkeypatch):
    import subprocess
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(30)"])
    try:
        deadline = time.monotonic() + 10
        while True:
            got = stats._proc_tree_sample()
            if got[2] >= 2 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert got[2] >= 2                 # this process and the child
        # rooted at the child: its own subtree only, as the reference
        monkeypatch.setenv("SEAWEEDFS_TPU_TREE_ROOT", str(child.pid))
        port = stats._proc_tree_sample()
        ref = ref_stats._proc_tree_sample()
        assert port[2] == ref[2] == 1
        assert abs(port[1] - ref[1]) <= 1 << 22
        # a dead root degrades to this process
        monkeypatch.setenv("SEAWEEDFS_TPU_TREE_ROOT", "999999999")
        assert stats._proc_tree_sample()[2] >= 2
    finally:
        child.kill()
        child.wait()
    text = stats.render_process()
    assert "seaweedfs_tpu_process_tree_procs" in text
    assert "seaweedfs_tpu_process_tree_cpu_seconds" in text


def test_observer_and_batch_observer_equal_reference():
    rng = np.random.default_rng(3)
    vals = rng.exponential(0.2, 500)
    port, ref = stats.Metrics("x"), ref_stats.Metrics("x")
    for m in (port, ref):
        obs = m.observer("h", help_text="h", kind="a")
        for v in vals[:250]:
            obs(float(v))
        m.batch_observer("h", kind="b")(vals[250:])
        m.counter_add("c_total", 2.0, a="1", b="2")
        m.counter_add("c_total", 3.0, a="1", b="3")
    assert port.render() == ref.render()
    assert port.counter_sum("c_total", a="1") == \
        ref.counter_sum("c_total", a="1") == 5.0
    assert port.counter_sum("c_total", b="3") == 3.0


# -- background threads --------------------------------------------------------

class _RecordingStop(threading.Event):
    """A sampler's stop event that records, at each wait, the cost of
    the pass that just ended and the sleep that pass bought."""

    def __init__(self, sampler):
        super().__init__()
        self.sampler = sampler
        self.seen = 0.0
        self.cycles = []

    def wait(self, timeout=None):
        cost = self.sampler.self_seconds - self.seen
        self.seen = self.sampler.self_seconds
        self.cycles.append((cost, timeout))
        return super().wait(timeout)


def test_sampler_round_trip_and_bound():
    """The bound is the construction's: every pass buys a sleep of at
    least its own cost over MAX_OVERHEAD (and the interval), so each
    pass-and-sleep cycle spends at most MAX_OVERHEAD of its wall
    sampling.  It is checked cycle by cycle: the wall ratio over a short
    run also holds the last pass, whose sleep the stop cuts short, and
    on a loaded host a pass's wall includes its waits for the GIL."""
    s = profiling.Sampler()
    s._stop = rec = _RecordingStop(s)
    assert s.start(1000.0)     # the top rate: a pass outruns its budget
    assert not s.start(50.0)                 # an armed sampler is kept
    busy_until = time.monotonic() + 0.3
    while time.monotonic() < busy_until:
        sum(range(1000))
    s.stop()
    snap = s.snapshot(top=3)
    assert not snap["running"] and snap["samples"] > 0
    assert len(snap["folded"]) <= 3
    assert rec.cycles and len(rec.cycles) == snap["samples"]
    for cost, sleep in rec.cycles:
        assert sleep >= 1.0 / 1000.0
        assert cost <= profiling.MAX_OVERHEAD * sleep * (1 + 1e-9), \
            (cost, sleep)
    assert snap["overhead"] == pytest.approx(
        s.self_seconds / snap["elapsedSeconds"], rel=0.01)
    assert s.collapsed().count("\n") == len(s.snapshot()["folded"])
    s.reset()
    assert s.snapshot()["samples"] == 0


def test_sched_probe_starts_once_and_stops(registries, monkeypatch):
    port, _ref = registries
    monkeypatch.setenv("SEAWEEDFS_TPU_SCHED_PROBE_MS", "5")
    p = profiling.maybe_start_sched_probe()
    assert profiling.maybe_start_sched_probe() is p
    deadline = time.monotonic() + 5
    while port.gauge_value("gil_wait_ratio") is None:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    profiling.stop_sched_probe()
    assert not p._thread.is_alive()
    assert profiling._sched_probe is None
    monkeypatch.setenv("SEAWEEDFS_TPU_SCHED_PROBE", "0")
    assert profiling.maybe_start_sched_probe() is None


def test_telemetry_registries_fixture_stops_every_probe(monkeypatch):
    """The repair behind test_torch_telemetry's fixture: both packages'
    probes, running, are stopped, and no `weed-sched-probe` thread is
    left to write into a fresh registry."""
    monkeypatch.setenv("SEAWEEDFS_TPU_SCHED_PROBE_MS", "5")
    profiling.maybe_start_sched_probe()
    ref_profiling.maybe_start_sched_probe()
    stop_background_probes()
    assert profiling._sched_probe is None
    assert ref_profiling._sched_probe is None
    time.sleep(0.05)
    assert not [t for t in threading.enumerate()
                if t.name == "weed-sched-probe" and t.is_alive()]


# -- C9: group grants fail closed ------------------------------------------------

POLICY_RW_DOCS = ('{"Version": "2012-10-17", "Statement": [{"Effect": '
                  '"Allow", "Action": ["s3:GetObject", "s3:PutObject"], '
                  '"Resource": "arn:aws:s3:::docs/*"}]}')
POLICY_R_LOGS = ('{"Version": "2012-10-17", "Statement": [{"Effect": '
                 '"Allow", "Action": ["s3:GetObject"], '
                 '"Resource": "arn:aws:s3:::logs/*"}]}')


def _grouped_store(identity_mod, path):
    store = identity_mod.IdentityStore(str(path))
    store.put(identity_mod.Identity(
        "carol", [identity_mod.Credential("AK1", "SK1")]))
    store.put(identity_mod.Identity(
        "dave", [identity_mod.Credential("AK2", "SK2")]))
    store.put_policy("docs-rw", POLICY_RW_DOCS)
    store.put_policy("logs-r", POLICY_R_LOGS)
    store.put_group("writers", {"name": "writers", "members": ["carol"],
                                "policyNames": ["docs-rw"]})
    store.put_group("readers", {"name": "readers", "members": ["dave"],
                                "policyNames": ["logs-r"]})
    assert store.get("carol").can_do("Write", "docs", "a.txt")
    assert store.get("dave").can_do("Read", "logs", "a.txt")
    return store


def test_c9_port_group_grants_fail_closed(tmp_path, monkeypatch):
    """With the policy translation unimportable, deleting a group (or a
    policy) revokes its grants: the port clears every derived group
    grant instead of keeping the old, broader ones."""
    from seaweedfs_tpu_torch.iam import identity
    store = _grouped_store(identity, tmp_path / "s3.json")
    monkeypatch.setitem(sys.modules,
                        "seaweedfs_tpu_torch.iam.policy_actions", None)
    store.delete_group("writers")
    assert not store.get("carol").can_do("Write", "docs", "a.txt")
    assert not store.get("carol").can_do("Read", "docs", "a.txt")
    # fail closed: the surviving group's grant is dropped too, until
    # the translation is back
    assert not store.get("dave").can_do("Read", "logs", "a.txt")
    monkeypatch.undo()
    store.put_group("readers", {"name": "readers", "members": ["dave"],
                                "policyNames": ["logs-r"]})
    assert store.get("dave").can_do("Read", "logs", "a.txt")
    assert not store.get("carol").can_do("Write", "docs", "a.txt")


def test_c9_jax_group_grants_stay_stale(tmp_path, monkeypatch):
    """The JAX store (which imports the translation from `.iamapi`)
    keeps the deleted group's grant: the fault the port repaired, kept
    in the reference."""
    from seaweedfs_tpu.iam import identity
    store = _grouped_store(identity, tmp_path / "s3.json")
    monkeypatch.setitem(sys.modules, "seaweedfs_tpu.iam.iamapi", None)
    store.delete_group("writers")
    assert store.get("carol").can_do("Write", "docs", "a.txt")
    store.delete_policy("logs-r")
    assert store.get("dave").can_do("Read", "logs", "a.txt")


# -- the other repairs -----------------------------------------------------------

def test_the_master_takes_no_security_config_and_reads_it_late():
    """`MasterServer(security_config=)` is gone (nothing set it); the
    master's guard and its assign tokens read the process's
    configuration when they run."""
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    with pytest.raises(TypeError):
        MasterServer(security_config=None)
    from seaweedfs_tpu_torch import security
    m = MasterServer().start()
    try:
        security.configure(security.SecurityConfig(admin_key="k" * 16))
        import socket
        host, port = m.url.split(":")
        with socket.create_connection((host, int(port)), timeout=10) as s:
            s.sendall(b"POST /vol/grow HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 0\r\nConnection: close\r\n\r\n")
            assert s.recv(4096).split(b" ")[1] == b"401"
    finally:
        security.configure(None)
        m.stop()


class _StubServer:
    """`_read_step`'s server: a url and a hot-needle cache to drop."""
    url = "stub:1"

    def _nc_drop_volume(self, vid):
        pass


def test_read_step_reports_the_measured_launches(monkeypatch):
    """chip_smoke's `_read_step` returns the launches counted during
    its reads (the contract's measured count, not a literal), and fails
    when a read launched the kernel."""
    import chip_smoke
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.server import httpd
    ec = {"seed": 5, "sizes": {1: 100, 2: 300}}
    launch = {"n": 0}

    def fake_get(method, url, timeout=None):
        nid = int(url.rsplit(",", 1)[1][:-8], 16)
        rs_cuda.LAUNCHES += launch["n"]
        return 200, chip_smoke._payload(5, nid, ec["sizes"][nid]), {}

    monkeypatch.setattr(httpd, "http_bytes", fake_get)
    monkeypatch.setattr(rs_cuda, "LAUNCHES", rs_cuda.LAUNCHES)
    got = chip_smoke._read_step(_StubServer(), [1, 2], ec, "stub")
    assert got["kernel_launches"] == 0 and got["needles"] == 2
    launch["n"] = 1
    with pytest.raises(RuntimeError, match="launched the kernel 2 times"):
        chip_smoke._read_step(_StubServer(), [1, 2], ec, "stub")


def test_this_slices_modules_load_without_torch_or_jax():
    """The fleet's processes (the filer, its fronts, the debug routes,
    the shell's views) never import torch, so a sibling can never touch
    the card, nor jax or the JAX package."""
    import json
    import subprocess
    code = (
        "import sys, json\n"
        "import seaweedfs_tpu_torch.__main__\n"
        "import seaweedfs_tpu_torch.server.filer_server\n"
        "import seaweedfs_tpu_torch.server.async_front\n"
        "import seaweedfs_tpu_torch.server.debug\n"
        "import seaweedfs_tpu_torch.profiling\n"
        "import seaweedfs_tpu_torch.shell.commands\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('torch', 'jax', 'jaxlib', 'seaweedfs_tpu'))))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []
