"""Chaos scenarios on an in-process port cluster: armed failpoints
(`faults.py`) driven through the real `POST /debug/faults` lever while
the encode, the rebuild and reads run, on the CPU codec.  Tolerance:
exact byte equality.

A port master and seven port volume servers (`device="cpu"`) share this
process, so they share one fault registry, one retry budget and one QoS
controller with the test (on the card's machine each role is its own
process).  Each scenario mounts a fresh copy of one seeded ~5 MiB volume
and encodes it RS(10,4) with the real 1 MiB small blocks; every shard
written equals the shard the JAX package's pipeline writes for the same
`.dat`.  The scenarios are those of `tests/test_chaos_cluster.py`:
1. a destination dropped mid-scatter: re-planned, nothing on it;
2. a truncated shard stream: the commit handshake refuses it;
3. a donor that truncates mid-rebuild: failed over, the rebuilt shard
   equal to the lost one;
then lookups carried by the pooled client's counted retries, the fault
lever with the bounded budget, the admission middleware with the
`/debug/qos` lever, a paced encode, and C14: the feedback throttle's
view of a foreground that the native read plane serves.
"""

import os
import re
import time

import numpy as np
import pytest

from seaweedfs_tpu import faults as ref_faults
from seaweedfs_tpu import qos as ref_qos
from seaweedfs_tpu.storage.erasure_coding import ec_decoder as ref_decoder
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.ec_context import (
    ECContext as RefContext)
from seaweedfs_tpu.util import retry as ref_retry
from seaweedfs_tpu_torch import faults, operation, qos, stats
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.server.httpd import (http_bytes, http_json,
                                              http_stream_request)
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.erasure_coding import ec_context
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util import retry

from test_torch_profiling import stop_background_probes

TOTAL = 14
NODES = 7
PULSE = 0.2
MASTER_PULSE = 1.0


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """A seeded ~5 MiB volume (.dat/.idx from the port's Volume) and the
    .ecx and 14 shards the JAX package's pipeline writes for it."""
    d = tmp_path_factory.mktemp("chaos_golden")
    v = Volume(str(d), 1)
    rng = np.random.default_rng(17)
    nid = 0
    needles = {}
    while v.dat_size() < 5 << 20:
        nid += 1
        data = rng.bytes(int(rng.integers(1000, 300_000)))
        v.write_needle(Needle(cookie=nid, id=nid, data=data))
        needles[nid] = data
    v.close()
    base = str(d / "1")
    ctx = RefContext(backend="jax")
    ref_encoder.write_sorted_file_from_idx(base)
    ref_encoder.write_ec_files(base, ctx)
    ref_encoder.save_ec_volume_info(
        base, ctx, os.path.getsize(base + ".dat"),
        ref_decoder.read_ec_volume_version(base))
    files = {ext: _read(base + ext) for ext in (".dat", ".idx", ".ecx")}
    files.update({sid: _read(base + f".ec{sid:02d}")
                  for sid in range(TOTAL)})
    files["needles"] = needles
    return files


class Cluster:
    def __init__(self, tmp):
        self.master = MasterServer(volume_size_limit_mb=64,
                                   pulse_seconds=MASTER_PULSE).start()
        self.env = CommandEnv(self.master.url)
        self.servers, self.dirs = [], []
        for i in range(NODES):
            d = str(tmp / f"v{i}")
            os.makedirs(d)
            self.dirs.append(d)
            self.servers.append(VolumeServer(
                [d], device="cpu", master=self.master.url,
                pulse_seconds=PULSE).start())
        self.wait(lambda: len(self.get("/cluster/status")["dataNodes"])
                  == NODES, "cluster up")

    def get(self, path: str) -> dict:
        return http_json("GET", f"{self.master.url}{path}", timeout=10)

    @staticmethod
    def wait(cond, what: str, timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            assert time.monotonic() < deadline, f"timed out: {what}"
            time.sleep(0.05)

    def mount(self, golden, vid: int, i: int = 0) -> str:
        """A copy of the golden volume as `vid` on server i: its url."""
        for ext in (".dat", ".idx"):
            with open(os.path.join(self.dirs[i], f"{vid}{ext}"), "wb") as f:
                f.write(golden[ext])
        url = self.servers[i].url
        r = http_json("POST", f"{url}/admin/mount_volume",
                      {"volumeId": vid}, timeout=10)
        assert "error" not in r, r
        self.wait(lambda: self.get(f"/dir/lookup?volumeId={vid}")
                  .get("locations"), f"volume {vid} listed")
        return url

    def shell(self, line: str) -> str:
        self.env.lock()
        try:
            return run_command(self.env, line)
        finally:
            self.env.unlock()

    def shard_map(self, vid: int) -> "dict[str, list[int]]":
        r = self.get(f"/dir/ec_lookup?volumeId={vid}")
        return {loc["url"]: sorted(loc["shardIds"])
                for loc in r.get("shardIdLocations", [])}

    def check_shards(self, golden, vid: int) -> "dict[int, str]":
        """Every shard of `vid` exactly once on disk, equal to the JAX
        pipeline's, with its .ecx beside it: {sid: dir}."""
        seen = {}
        for d in self.dirs:
            for name in os.listdir(d):
                m = re.fullmatch(rf"{vid}\.ec(\d\d)", name)
                if m:
                    sid = int(m.group(1))
                    assert sid not in seen, (sid, seen[sid], d)
                    seen[sid] = d
                    assert _read(os.path.join(d, name)) == golden[sid], \
                        f"shard {sid} in {d}"
                    assert _read(os.path.join(d, f"{vid}.ecx")) == \
                        golden[".ecx"]
        assert sorted(seen) == list(range(TOTAL))
        return seen

    def assert_no_debris(self) -> None:
        for d in self.dirs:
            left = [n for n in os.listdir(d)
                    if ".scatter." in n or ".recv." in n or
                    n.endswith(".download")]
            assert not left, (d, left)

    def read_back(self, golden, vid: int, sample: int = 6) -> None:
        for nid in sorted(golden["needles"])[:sample]:
            fid = f"{vid},{nid:x}{nid:08x}"
            assert operation.read(self.master.url, fid) == \
                golden["needles"][nid], fid

    def close(self) -> None:
        for vs in self.servers:
            vs.stop()
        self.master.stop()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(ec_context, "DEVICE_BATCH_SIZE", 1 << 20)
    mp.setenv("SEAWEEDFS_TPU_EC_REBUILD_SLICE_MB", "1")
    mp.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "1")
    c = Cluster(tmp_path_factory.mktemp("torch_chaos"))
    yield c
    c.close()
    mp.undo()
    stop_background_probes()
    for m in (qos, ref_qos):
        m.throttle().stop()
        m.reset()


@pytest.fixture(autouse=True)
def _isolate():
    """Every scenario starts fault-free, with closed breakers, a full
    budget and inert QoS, in both packages."""
    def clean():
        for m in (faults, ref_faults):
            m.reset()
        for m in (retry, ref_retry):
            m.reset()
        for m in (qos, ref_qos):
            m.reset()
    clean()
    yield
    clean()


def _arm(url: str, spec: str) -> None:
    r = http_json("POST", f"{url}/debug/faults", {"spec": spec},
                  timeout=10)
    assert "error" not in r, r


def _triggered(url: str) -> dict:
    return http_json("GET", f"{url}/debug/faults", timeout=10)["triggered"]


def _metric(url: str, name: str) -> float:
    st, body, _ = http_bytes("GET", f"{url}/metrics", timeout=10)
    assert st == 200
    total = 0.0
    for line in body.decode().splitlines():
        head, _, value = line.rpartition(" ")
        if line.startswith(name) and head[len(name):][:1] in ("", "{"):
            total += float(value)
    return total


def _victim(cluster, source: str) -> str:
    return next(vs.url for vs in cluster.servers if vs.url != source)


# -- scenario 1: a destination dropped mid-scatter ---------------------------------

def test_scatter_dest_drop_replans_and_completes(cluster, golden):
    vid = 11
    source = cluster.mount(golden, vid)
    victim = _victim(cluster, source)
    _arm(source, f"ec.encode.window=drop,n=1,match={victim}")
    out = cluster.shell(f"ec.encode -volumeId={vid}")
    assert "error" not in out.lower(), out
    cluster.wait(lambda: sorted(s for ids in cluster.shard_map(vid)
                                .values() for s in ids)
                 == list(range(TOTAL)), "every shard listed")
    assert victim not in cluster.shard_map(vid)
    seen = cluster.check_shards(golden, vid)
    assert cluster.dirs[cluster.servers.index(
        next(vs for vs in cluster.servers if vs.url == victim))] \
        not in seen.values()
    cluster.read_back(golden, vid)
    cluster.assert_no_debris()
    assert _triggered(source).get("ec.encode.window", 0) >= 1
    assert _metric(source, "volume_server_ec_scatter_replans_total") >= 1


# -- scenario 2: a truncated shard stream ---------------------------------------------

def test_truncated_shard_stream_never_commits(cluster, golden):
    vid = 12
    source = cluster.mount(golden, vid)
    victim = _victim(cluster, source)
    _arm(source, f"ec.encode.window=truncate,n=1,match={victim}")
    cluster.shell(f"ec.encode -volumeId={vid}")
    cluster.wait(lambda: sorted(s for ids in cluster.shard_map(vid)
                                .values() for s in ids)
                 == list(range(TOTAL)), "every shard listed")
    assert victim not in cluster.shard_map(vid)
    cluster.check_shards(golden, vid)
    cluster.read_back(golden, vid)
    cluster.assert_no_debris()
    assert _triggered(source).get("ec.encode.window", 0) >= 1
    # the handshake itself: a short staged upload committed with the
    # promised count is refused, mounts nothing and keeps nothing
    st, _ = http_stream_request(
        "POST", f"{victim}/admin/ec/shard_write?volumeId=9999&shardId=0"
        f"&collection=&uploadId=abc123chaos", iter([b"x" * 1024]),
        timeout=30)
    assert st == 200
    r = http_json("POST", f"{victim}/admin/ec/shard_write_commit",
                  {"volumeId": 9999, "collection": "",
                   "uploadId": "abc123chaos", "shardId": 0, "crc32": 1,
                   "bytes": 4096, "mount": True}, timeout=30)
    assert "mismatch" in r.get("error", ""), r
    assert "error" in http_json("GET", f"{victim}/admin/ec/info?"
                                "volumeId=9999", timeout=10)
    cluster.assert_no_debris()


# -- scenario 3: a donor that truncates mid-rebuild ------------------------------------

def test_donor_truncation_mid_rebuild_fails_over(cluster, golden):
    vid = 13
    cluster.mount(golden, vid)
    cluster.shell(f"ec.encode -volumeId={vid}")
    cluster.wait(lambda: len(cluster.shard_map(vid)) >= 2, "encoded")
    by_url = cluster.shard_map(vid)
    rebuilder = max(by_url, key=lambda u: len(by_url[u]))
    donor = next(u for u in sorted(by_url) if u != rebuilder)
    lost = by_url[donor][0]
    r = http_json("POST", f"{donor}/admin/ec/delete_shards",
                  {"volumeId": vid, "shardIds": [lost]}, timeout=30)
    assert "error" not in r, r
    cluster.wait(lambda: lost not in cluster.shard_map(vid).get(donor, []),
                 "lost shard unlisted")
    before = stats.PROCESS.counter_sum("ec_read_source_failovers_total")
    # in one process the arm reaches every donor's shard_read
    _arm(rebuilder, "volume.shard_read.serve=truncate,n=1")
    r = http_json("POST", f"{rebuilder}/admin/ec/rebuild",
                  {"volumeId": vid}, timeout=120)
    assert r.get("rebuiltShardIds") == [lost], r
    d = cluster.dirs[[vs.url for vs in cluster.servers].index(rebuilder)]
    assert _read(os.path.join(d, f"{vid}.ec{lost:02d}")) == golden[lost]
    assert _triggered(rebuilder).get("volume.shard_read.serve", 0) == 1
    assert stats.PROCESS.counter_sum(
        "ec_read_source_failovers_total") >= before + 1
    cluster.assert_no_debris()


# -- lookups through counted retries ------------------------------------------------------

def test_lookups_ride_counted_retries(cluster, golden):
    vid = 14
    cluster.mount(golden, vid)
    master = cluster.master.url
    operation._vid_cache._m.clear()
    before = stats.PROCESS.counter_sum("retry_attempts_total",
                                       site="httpd.pool")
    _arm(master, f"httpd.pool.request=error,n=3,match={master}/dir/lookup;"
                 f"master.lookup=delay,ms=100,n=2")
    cluster.read_back(golden, vid, sample=4)
    assert stats.PROCESS.counter_sum(
        "retry_attempts_total", site="httpd.pool") >= before + 1
    trig = _triggered(master)
    assert trig.get("httpd.pool.request") == 3
    assert trig.get("master.lookup", 0) >= 1
    health = http_json("GET", f"{master}/debug/health", timeout=10)
    assert health["retryBudgetRemaining"] < 64
    # a failing lookup is a 500 answer, not a transport failure: the
    # policy does not retry it, and the next lookup succeeds
    faults.reset()
    operation._vid_cache._m.clear()
    _arm(master, "master.lookup=error,n=1")
    with pytest.raises(LookupError):
        operation.lookup(master, vid)
    assert operation.lookup(master, vid)


# -- the fault lever and the bounded budget --------------------------------------------

def test_fault_lever_round_trip_and_budget_bounded(cluster):
    url = cluster.servers[0].url
    r = http_json("POST", f"{url}/debug/faults",
                  {"site": "master.heartbeat", "action": "delay", "ms": 1,
                   "n": 1}, timeout=10)
    assert r.get("armedCount") == 1, r
    cluster.wait(lambda: _triggered(url).get("master.heartbeat", 0) == 1,
                 "heartbeat fault fired", timeout=5)
    http_json("POST", f"{url}/debug/faults", {"clear": True}, timeout=10)
    assert http_json("GET", f"{url}/debug/faults", timeout=10)["armed"] == []
    assert "error" in http_json("POST", f"{url}/debug/faults",
                                {"spec": "bogus-entry-no-equals"},
                                timeout=10)
    assert _metric(url, "seaweedfs_tpu_retry_attempts_total") < 200
    health = http_json("GET", f"{url}/debug/health", timeout=10)
    assert 0 <= health["retryBudgetRemaining"] <= 64


# -- admission on the volume's maintenance plane, and the lever ----------------------------

def test_admission_middleware_and_debug_qos_lever(cluster):
    url = cluster.servers[1].url
    r = http_json("POST", f"{url}/debug/qos",
                  {"tenant": "noisy", "rps": 1, "burst": 1}, timeout=10)
    assert r["config"]["tenants"]["noisy"]["rps"] == 1.0
    tenant = {"X-Tenant": "noisy"}
    codes = [http_bytes("GET", f"{url}/admin/ec/info?volumeId=1",
                        headers=tenant, timeout=10) for _ in range(3)]
    assert [c[0] for c in codes].count(503) >= 1
    shed = next(c for c in codes if c[0] == 503)
    assert int(shed[2]["Retry-After"]) >= 1 and b"qos" in shed[1]
    # the needle data path and the debug plane are outside admission
    assert http_bytes("GET", f"{url}/status", headers=tenant,
                      timeout=10)[0] == 200
    assert http_bytes("GET", f"{url}/1,01", headers=tenant,
                      timeout=10)[0] != 503
    assert _metric(url, "seaweedfs_tpu_qos_rejected_total") >= 1
    r = http_json("POST", f"{url}/debug/qos", {"sloP99Ms": 250,
                                               "paceMs": 5}, timeout=10)
    assert r["config"]["sloP99Ms"] == 250.0
    assert r["throttle"]["paceMs"] == 5.0
    r = http_json("POST", f"{url}/debug/qos", {"clear": True}, timeout=10)
    assert r["config"]["tenants"] == {} and r["throttle"]["paceMs"] == 0.0
    assert "error" in http_json("POST", f"{url}/debug/qos",
                                {"tenant": "x", "rps": -1}, timeout=10)
    qos.throttle().stop()


# -- a paced encode --------------------------------------------------------------------------

def test_paced_encode_is_byte_identical(cluster, golden, monkeypatch):
    """A forced pace delays every window of the scatter, counted once a
    window, and changes no byte and no codec call: the calls of the
    kernel's wrapper equal those of an unpaced encode of the same
    volume."""
    calls = []
    real = rs_cuda.gf_apply_matrix_words

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(rs_cuda, "gf_apply_matrix_words", counting)
    cluster.mount(golden, 15)
    cluster.shell("ec.encode -volumeId=15")
    unpaced = len(calls)
    cluster.check_shards(golden, 15)
    del calls[:]
    cluster.mount(golden, 16)
    paced0 = stats.PROCESS.counter_sum("qos_ec_paced_total", kind="encode")
    qos.throttle().set_pace(0.002)
    try:
        cluster.shell("ec.encode -volumeId=16")
    finally:
        qos.throttle().set_pace(0.0)
    paced = stats.PROCESS.counter_sum("qos_ec_paced_total",
                                      kind="encode") - paced0
    assert len(calls) == unpaced > 0
    # one pace a pushed window: the remote shards' bytes over the
    # sink's window, at least one a remote shard
    assert paced >= TOTAL - 2
    cluster.check_shards(golden, 16)
    cluster.read_back(golden, 16)


# -- C14: the throttle and the native read plane ----------------------------------------------

def _plane_reads(vs, fid: str, n: int):
    """A callable that GETs `fid` n times from the volume's read plane
    (its port asked for now, so the reads touch no Python front)."""
    port = http_json("GET", f"{vs.url}/status", timeout=10).get(
        "readPlanePort")
    assert port, "the volume's read plane is up"
    host = vs.url.rsplit(":", 1)[0]

    def reads():
        for _ in range(n):
            st, _, _ = http_bytes("GET", f"{host}:{port}/{fid}", timeout=10)
            assert st == 200
    return reads


def _throttle_signal(qmod, sources, reads) -> "tuple[float, int]":
    """(p99, requests) that a fresh throttle of `qmod` over `sources`
    computes across `reads()`: its p99, and how many requests its
    sources' histograms gained."""
    def count():
        total = 0
        for _, metrics, names in sources:
            for name in names or ("request_seconds",):
                h = metrics.histogram_merged(name)
                total += h["count"] if h else 0
        return total
    th = qmod.FeedbackThrottle()
    for label, metrics, names in sources:
        if names is None:
            th.add_metrics(label, metrics)
        else:
            th.add_metrics(label, metrics, names=names)
    qmod.controller().configure(qmod.QosConfig(enabled=True,
                                               slo_p99_ms=1000))
    th.sample_now()
    n0 = count()
    reads()
    time.sleep(0.5)                   # past the drainers' 200 ms tick
    from seaweedfs_tpu_torch import profiling
    profiling.run_scrape_hooks()
    th.sample_now()
    return th.p99(), count() - n0


def test_c14_jax_throttle_is_blind_to_the_native_read_plane(tmp_path):
    """The JAX volume server's throttle samples only its Python front's
    request_seconds: needle GETs that its native read plane serves (the
    default) never reach it, so the EC pacing loop cannot close on the
    default foreground."""
    from seaweedfs_tpu import operation as ref_operation
    from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefVS
    m = RefMaster(volume_size_limit_mb=64).start()
    vs = RefVS([str(tmp_path)], m.url, pulse_seconds=0.3).start()
    try:
        Cluster.wait(lambda: http_json("GET", f"{m.url}/cluster/status",
                                       timeout=10)["dataNodes"], "up")
        fid = ref_operation.submit(m.url, b"n" * 1024)
        assert ref_operation.read(m.url, fid) == b"n" * 1024
        _, seen = _throttle_signal(ref_qos,
                                   [("volume", vs.metrics, None)],
                                   _plane_reads(vs, fid, 64))
        assert seen < 8, f"{seen} of 64 plane reads reached the signal"
    finally:
        vs.stop()
        m.stop()
        ref_qos.throttle().stop()
        stop_background_probes()


def test_c14_port_throttle_sees_the_native_read_plane(tmp_path):
    m = MasterServer(volume_size_limit_mb=64).start()
    vs = VolumeServer([str(tmp_path)], device="cpu", master=m.url,
                      pulse_seconds=0.3).start()
    try:
        Cluster.wait(lambda: http_json("GET", f"{m.url}/cluster/status",
                                       timeout=10)["dataNodes"], "up")
        fid = operation.submit(m.url, b"n" * 1024)
        assert operation.read(m.url, fid) == b"n" * 1024
        before = stats.PROCESS.counter_sum("qos_foreground_samples_total",
                                           source="planes")
        p99, seen = _throttle_signal(
            qos, [("volume", vs.role_metrics, None),
                  ("planes", stats.PROCESS, ("plane_request_seconds",))],
            _plane_reads(vs, fid, 64))
        assert p99 > 0.0 and seen >= 64
        assert stats.PROCESS.counter_sum(
            "qos_foreground_samples_total", source="planes") >= before + 64
    finally:
        vs.stop()
        m.stop()
        qos.throttle().stop()
        stop_background_probes()


# -- C15: the filer's native planes and a default limit ------------------------------------

def _limits(qmod):
    """A default limit (it binds the anonymous tenant) and a noisy one."""
    return qmod.QosConfig(enabled=True,
                          default=qmod.TenantLimit(rps=1.0, burst=1.0),
                          tenants={"noisy": qmod.TenantLimit(rps=1.0,
                                                             burst=1.0)})


def test_c15_jax_filer_read_plane_serves_past_a_default_limit(tmp_path):
    """Under a `[qos.default]` limit the JAX filer's native read plane
    still serves anonymous GETs: it hands tenant-tagged requests to the
    Python front, where admission runs, but answers anonymous ones
    itself, so a limit that binds `anonymous` is never applied there."""
    from seaweedfs_tpu.server.filer_server import FilerServer as RefFiler
    from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefVS
    ref_qos.configure(_limits(ref_qos))
    m = RefMaster(volume_size_limit_mb=64).start()
    vs = RefVS([str(tmp_path / "v")], m.url, pulse_seconds=0.3).start()
    fs = None
    try:
        Cluster.wait(lambda: http_json("GET", f"{m.url}/cluster/status",
                                       timeout=10)["dataNodes"], "up")
        fs = RefFiler(m.url, store_path=str(tmp_path / "f.db")).start()
        st, _, _ = http_bytes("PUT", f"{fs.url}/q/f.bin", b"z" * 2048,
                              headers={"X-Tenant": "writer"}, timeout=10)
        assert st in (200, 201)
        port = http_json("GET", f"{fs.url}/status",
                         timeout=10).get("readPlanePort")
        assert port, "the JAX read plane is up"
        served = 0
        deadline = time.monotonic() + 10
        while served < 8 and time.monotonic() < deadline:
            # a tagged GET on the Python front warms the plane's entry
            http_bytes("GET", f"{fs.url}/q/f.bin",
                       headers={"X-Tenant": f"w{served}"}, timeout=10)
            st, body, _ = http_bytes("GET", f"127.0.0.1:{port}/q/f.bin",
                                     timeout=10)
            served += st == 200 and body == b"z" * 2048
        assert served >= 8, "anonymous GETs past the limit on the plane"
        # while the Python front refuses anonymous past its burst
        codes = [http_bytes("GET", f"{fs.url}/q/f.bin", timeout=10)[0]
                 for _ in range(3)]
        assert 503 in codes
    finally:
        if fs is not None:
            fs.stop()
        vs.stop()
        m.stop()
        ref_qos.throttle().stop()
        ref_qos.reset()
        stop_background_probes()


def _port_filer(tmp_path, config):
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    qos.configure(config)
    m = MasterServer(volume_size_limit_mb=64).start()
    vs = VolumeServer([str(tmp_path / "v")], device="cpu", master=m.url,
                      pulse_seconds=0.3).start()
    Cluster.wait(lambda: http_json("GET", f"{m.url}/cluster/status",
                                   timeout=10)["dataNodes"], "up")
    fs = FilerServer(m.url, store_path=str(tmp_path / "f.db")).start()

    def stop():
        fs.stop()
        vs.stop()
        m.stop()
        qos.throttle().stop()
        qos.reset()
        stop_background_probes()
    return fs, stop


def test_c15_port_filer_planes_stand_down_under_a_default_limit(tmp_path):
    before = stats.PROCESS.counter_sum("filer_native_plane_stood_down_total",
                                       reason="qos")
    fs, stop = _port_filer(tmp_path, _limits(qos))
    try:
        assert fs.native_meta is None and fs.native_read is None
        status = http_json("GET", f"{fs.url}/status", timeout=10)
        assert not status.get("readPlanePort") and \
            not status.get("metaPlanePort")
        assert stats.PROCESS.counter_sum(
            "filer_native_plane_stood_down_total",
            reason="qos") == before + 2
        st, _, _ = http_bytes("PUT", f"{fs.url}/q/f.bin", b"z" * 2048,
                              headers={"X-Tenant": "writer"}, timeout=10)
        assert st in (200, 201)
        # in one process the volume's admission shares the controller:
        # the master's allocate_volume spent anonymous's token
        time.sleep(1.1)
        codes = [http_bytes("GET", f"{fs.url}/q/f.bin", timeout=10)[0]
                 for _ in range(4)]
        assert codes[0] == 200 and 503 in codes
        assert stats.PROCESS.counter_sum("qos_rejected_total",
                                         tenant="anonymous", role="filer",
                                         reason="rate") >= 1
    finally:
        stop()


def test_port_filer_planes_stay_up_under_tenant_limits(tmp_path):
    """Tenant limits alone leave the planes up: a tagged request goes to
    the Python front and is refused there, and the anonymous foreground
    rides the planes unlimited."""
    fs, stop = _port_filer(tmp_path, qos.QosConfig(enabled=True, tenants={
        "noisy": qos.TenantLimit(rps=1.0, burst=1.0)}))
    try:
        assert fs.native_read is not None
        st, _, _ = http_bytes("PUT", f"{fs.url}/q/f.bin", b"z" * 2048,
                              timeout=10)
        assert st in (200, 201)
        codes = [http_bytes("GET", f"{fs.url}/q/f.bin",
                            headers={"X-Tenant": "noisy"}, timeout=10)[0]
                 for _ in range(4)]
        assert codes[0] == 200 and 503 in codes
        assert all(http_bytes("GET", f"{fs.url}/q/f.bin", timeout=10)[0]
                   == 200 for _ in range(6))
    finally:
        stop()


def test_resize_on_read_and_metered_needle_gets(cluster):
    """`?width=` resizes a needle on the GET (the reference's hook), and
    a tenant with a byte limit is charged for the response, cache hits
    included, released once it is written."""
    import io

    from PIL import Image

    from seaweedfs_tpu_torch import images
    rng = np.random.default_rng(5)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)) \
        .save(buf, format="PNG")
    png = buf.getvalue()
    a = operation.assign(cluster.master.url)
    operation.upload(a.url, a.fid, png, mime="image/png")
    st, body, hdrs = http_bytes("GET", f"{a.url}/{a.fid}?width=20",
                                timeout=10)
    assert st == 200 and hdrs["Content-Type"] == "image/png"
    assert body == images.resized(png, "image/png", 20, 0) != png
    assert Image.open(io.BytesIO(body)).size == (20, 15)
    qos.controller().set_tenant("reader", qos.TenantLimit(
        rps=100, inflight_mb=len(png) / (1 << 20) * 1.5))
    for _ in range(3):                  # the second and third are hits
        st, got, _ = http_bytes("GET", f"{a.url}/{a.fid}",
                                headers={"X-Tenant": "reader"}, timeout=10)
        assert st == 200 and got == png
    # the server releases the bytes after it wrote the response's last
    # byte, so the release may trail the client's read of it
    deadline = time.monotonic() + 10
    while qos.controller().inflight_of("reader") != 0:
        assert time.monotonic() < deadline, \
            f"{qos.controller().inflight_of('reader')} bytes never released"
        time.sleep(0.01)
