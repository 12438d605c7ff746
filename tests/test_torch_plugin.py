"""The port's maintenance plane (`seaweedfs_tpu_torch/plugin/`) on the
CPU, against the JAX package's.  Tolerance: exact bytes for every shard
and sidecar, equal replies for the admin's rules.

- The port's worker runs a worker-mode encode (found by detection), a
  rebuild (found by detection once a shard server is lost with its
  disk), a batch encode of three volumes and a scatter encode, under:
  the JAX package's admin and master over port volume servers; the
  port's admin and master over port servers; the port's admin and
  master over the JAX package's servers.  The JAX package's worker
  (`EcEncodeHandler(backend="jax")`) runs the same jobs under the
  port's admin.  After each job every shard, `.ecx` and `.vif` equals
  what the JAX package's `write_ec_files` writes for the volume.
- The admin's rules, the port's and the JAX package's admin held to the
  same replies: dedupe, 409 on a batch that overlaps a live job, a
  completion from a worker that does not own the job ignored, a
  stalled job or a dead worker's job requeued, config checked against
  the schema and delivered to detection, state that survives a restart.
- A worker whose job is silent for longer than the admin waits for a
  busy worker keeps the job, under both admins.
- The volume server's `/metrics` after a scatter and a rebuild (the
  telemetry totals it feeds against the JAX server's, and the kernel
  wrappers' launch counts); the opt-in telemetry report, on its own
  and from the master's `-telemetry` flags, the span ingest and the
  adopted trace parent against the JAX package's.
- `admin` and `worker` on the command line, a worker job on a CUDA
  context without a card (failed, nothing left behind), and the plugin
  package loading neither JAX nor the JAX package.

Volumes of 1.5-3.3 MiB with the real 1 MiB small blocks, codec batches
(single and batched) and staging windows of 1 MiB, rebuild slices of
1 MiB; port servers and the port worker run their codec with
`device="cpu"` on one intra-op thread, and the port's batch job goes
through the batched entry on a grid of one CPU device.
Volume servers pulse every `PULSE` seconds; masters drop a server after
3 x `MASTER_PULSE`.
"""

import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu import telemetry as ref_telemetry
from seaweedfs_tpu.parallel import ec_batch as ref_ec_batch
from seaweedfs_tpu.plugin.admin import AdminServer as RefAdmin
from seaweedfs_tpu.plugin.handlers import (
    EcEncodeHandler as RefEncodeHandler)
from seaweedfs_tpu.plugin.handlers import (
    EcRebuildHandler as RefRebuildHandler)
from seaweedfs_tpu.plugin.worker import PluginWorker as RefWorker
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.storage.erasure_coding import ec_decoder as ref_decoder
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.ec_context import (
    ECContext as RefContext)
from seaweedfs_tpu_torch import telemetry
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.parallel import ec_batch, make_mesh
from seaweedfs_tpu_torch.plugin import (AdminServer, EcEncodeHandler,
                                        EcRebuildHandler, PluginWorker)
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.erasure_coding import ec_context
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL = 14
NODES = 5
PULSE = 0.2
MASTER_PULSE = 1.0
SIZE_LIMIT_MB = 64
# volume 1 alone is over FULLNESS x the size limit: detection's job
VOLUMES = {1: 3.3, 2: 1.6, 3: 2.1, 4: 1.5, 5: 2.0}   # MiB of .dat
FULLNESS = 0.045
BATCH = [2, 3, 4]
SCATTER = 5


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Seeded volumes (.dat/.idx from the port's Volume), each with the
    .ecx, .vif and 14 shards the JAX package's pipeline writes: {vid:
    {ext or shard id: bytes}}."""
    d = tmp_path_factory.mktemp("golden")
    rng = np.random.default_rng(23)
    ctx = RefContext(backend="jax")
    out = {}
    for vid, mib in VOLUMES.items():
        v = Volume(str(d), vid)
        nid = 0
        while v.dat_size() < mib * (1 << 20):
            nid += 1
            v.write_needle(Needle(cookie=nid, id=nid, data=rng.bytes(
                int(rng.integers(1000, 200_000)))))
        v.close()
        base = str(d / str(vid))
        ref_encoder.write_sorted_file_from_idx(base)
        ref_encoder.write_ec_files(base, ctx)
        ref_encoder.save_ec_volume_info(
            base, ctx, os.path.getsize(base + ".dat"),
            ref_decoder.read_ec_volume_version(base))
        files = {ext: _read(base + ext)
                 for ext in (".dat", ".idx", ".ecx", ".vif")}
        files.update({sid: _read(base + f".ec{sid:02d}")
                      for sid in range(TOTAL)})
        out[vid] = files
    return out


@pytest.fixture(autouse=True)
def small_sizes(monkeypatch):
    import torch
    monkeypatch.setattr(ec_context, "DEVICE_BATCH_SIZE", 1 << 20)
    monkeypatch.setattr(ec_batch, "DEVICE_BATCH_SIZE", 1 << 20)
    monkeypatch.setattr(ref_ec_batch, "TPU_BATCH_SIZE", 1 << 20)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_REBUILD_SLICE_MB", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "1")
    # the CPU codec works in 1 MiB windows: one intra-op thread keeps
    # parallel test processes from oversubscribing the cores, where each
    # small op's thread team waits on the others
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def batched_calls(monkeypatch):
    """The port's batch encode on a grid of one CPU device, so a CPU
    batch job goes through the batched entry as a card's does; the
    batched launches it makes are counted."""
    import torch
    calls = []
    real = ec_batch.encode_volume_files_batch
    real_apply = rs_cuda.gf_apply_matrix_words_batch

    def counted(*a, **kw):
        calls.append(1)
        return real_apply(*a, **kw)

    def on_cpu_grid(bases, ctx, mesh=None):
        return real(bases, ctx, mesh or make_mesh([torch.device("cpu")]))
    monkeypatch.setattr(ec_batch, "encode_volume_files_batch", on_cpu_grid)
    monkeypatch.setattr(rs_cuda, "gf_apply_matrix_words_batch", counted)
    return calls


class Plane:
    """A master, NODES volume servers, an admin and one worker, all
    in-process on loopback.  `admin`/`master`/`servers`/`worker` name
    the package of each: "ref" (JAX package) or "port".  Server 0 holds
    every volume of `golden` when it starts."""

    def __init__(self, tmp_path, golden, admin: str, master: str,
                 servers: str, worker: str):
        self.kinds = (admin, master, servers, worker)
        self.made = []
        mcls = RefMaster if master == "ref" else MasterServer
        self.master = self._start(mcls(volume_size_limit_mb=SIZE_LIMIT_MB,
                                       pulse_seconds=MASTER_PULSE))
        murl = self.master.url
        self.dirs, self.servers = [], []
        for i in range(NODES):
            d = str(tmp_path / f"v{i}")
            os.makedirs(d)
            if i == 0:
                for vid, files in golden.items():
                    for ext in (".dat", ".idx"):
                        with open(os.path.join(d, f"{vid}{ext}"), "wb") as f:
                            f.write(files[ext])
            if servers == "ref":
                vs = RefServer([d], murl, pulse_seconds=PULSE)
            else:
                vs = VolumeServer([d], device="cpu", master=murl,
                                  pulse_seconds=PULSE)
            self.servers.append(self._start(vs))
            self.dirs.append(d)
        acls = RefAdmin if admin == "ref" else AdminServer
        self.admin = self._start(acls(murl, detection_interval=3600))
        wdir = str(tmp_path / "worker")
        if worker == "ref":
            self.worker = RefWorker(
                self.admin.url, murl, wdir,
                [RefEncodeHandler(backend="jax"), RefRebuildHandler()],
                poll_wait=1.0)
        else:
            self.worker = PluginWorker(
                self.admin.url, murl, wdir,
                [EcEncodeHandler(device="cpu"), EcRebuildHandler()],
                poll_wait=1.0)
        self._start(self.worker)
        _wait(lambda: len(self.nodes()) == NODES and
              set(golden) <= self.normal_volumes(), "cluster up")

    def _start(self, server):
        server.start()
        self.made.append(server)
        return server

    def close(self) -> None:
        for s in reversed(self.made):
            s.stop()

    def get(self, path: str) -> dict:
        return http_json("GET", f"{self.master.url}{path}", timeout=10)

    def nodes(self) -> "list[str]":
        return self.get("/cluster/status")["dataNodes"]

    def normal_volumes(self) -> "set[int]":
        return {v["id"]
                for dc in self.get("/vol/list")["dataCenters"].values()
                for rack in dc["racks"].values()
                for node in rack["nodes"] for v in node["volumes"]}

    def ec_locations(self, vid: int) -> "dict[str, list[int]]":
        r = self.get(f"/dir/ec_lookup?volumeId={vid}")
        return {loc["url"]: loc["shardIds"]
                for loc in r.get("shardIdLocations", [])}

    def admin_call(self, method: str, path: str, payload=None) -> dict:
        return http_json(method, f"{self.admin.url}{path}", payload,
                         timeout=30)

    def run_job(self, submit=None, job_type: str = "") -> dict:
        """Submit a job (or, without `submit`, trigger detection and
        take the new job of `job_type`) and wait for it to end: its
        record."""
        before = {j["jobId"] for j in
                  self.admin_call("GET", "/maintenance/queue")["jobs"]}
        if submit is not None:
            r = self.admin_call("POST", "/maintenance/submit_job", submit)
            assert "jobId" in r, r
            jid = r["jobId"]
        else:
            self.admin_call("POST", "/maintenance/trigger_detection")
            new = []

            def detected():
                new[:] = [j["jobId"] for j in self.admin_call(
                    "GET", "/maintenance/queue")["jobs"]
                    if j["jobId"] not in before and
                    j["jobType"] == job_type]
                return new
            _wait(detected, f"detection proposes {job_type}")
            assert len(new) == 1, new
            jid = new[0]

        def ended():
            return self.admin_call(
                "GET", f"/maintenance/job?id={jid}")["status"] in (
                    "done", "failed")
        _wait(ended, f"job {jid} ends", timeout=120)
        return self.admin_call("GET", f"/maintenance/job?id={jid}")

    def check_shards(self, vid: int, files: dict) -> None:
        """Every shard of vid exactly once across the live servers, as
        the master lists them, equal to the JAX package's, with equal
        sidecars beside it; no original volume left."""
        seen = {}
        for d in self.dirs:
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                m = re.fullmatch(rf"{vid}\.ec(\d\d)", name)
                if m:
                    sid = int(m.group(1))
                    assert sid not in seen, f"shard {sid} in {seen[sid]}, {d}"
                    seen[sid] = d
                    assert _read(os.path.join(d, name)) == files[sid], \
                        (vid, sid, d)
                elif name in (f"{vid}.ecx", f"{vid}.vif"):
                    assert _read(os.path.join(d, name)) == \
                        files[name[len(str(vid)):]], (d, name)
                assert name not in (f"{vid}.dat", f"{vid}.idx"), (d, name)
        assert sorted(seen) == list(range(TOTAL)), (vid, seen)
        _wait(lambda: sorted(s for sids in self.ec_locations(vid).values()
                             for s in sids) == list(range(TOTAL)),
              f"master lists the 14 shards of volume {vid}")
        _wait(lambda: vid not in self.normal_volumes(),
              f"volume {vid} gone from the normal volumes")

    def lose_server(self, vid: int) -> "list[int]":
        """Stop a server other than server 0 that holds shards of vid,
        with its disk, and wait for the master to drop it.  The JAX
        package's master keeps a silent node's shards in its lookups,
        so under it the shards are deleted first."""
        locs = self.ec_locations(vid)
        i = next(i for i, vs in enumerate(self.servers)
                 if i and locs.get(vs.url))
        vs = self.servers[i]
        if self.kinds[1] == "ref":
            r = http_json("POST", f"{vs.url}/admin/ec/delete_shards",
                          {"volumeId": vid, "shardIds": list(range(TOTAL))},
                          timeout=10)
            assert "error" not in r, r
        vs.stop()
        self.made.remove(vs)
        shutil.rmtree(self.dirs[i])
        _wait(lambda: vs.url not in self.nodes() and
              vs.url not in self.ec_locations(vid), "lost server dropped")
        return sorted(locs[vs.url])


@pytest.mark.parametrize("admin,master,servers,worker", [
    ("ref", "ref", "port", "port"),
    ("port", "port", "port", "port"),
    ("port", "port", "ref", "port"),
    ("port", "port", "port", "ref"),
], ids=["ref-admin-over-port-servers", "port-admin-over-port-servers",
        "port-admin-over-ref-servers", "ref-worker-under-port-admin"])
def test_ec_jobs(golden, tmp_path, batched_calls, admin, master, servers,
                 worker):
    plane = Plane(tmp_path, golden, admin, master, servers, worker)
    try:
        # detection finds volume 1 only once the config reaches it
        r = plane.admin_call("POST", "/maintenance/config", {
            "jobType": "erasure_coding",
            "values": {"fullnessRatio": FULLNESS}})
        assert r["values"] == {"fullnessRatio": FULLNESS}, r
        job = plane.run_job(job_type="erasure_coding")
        assert job["status"] == "done", (job["message"], job["trace"])
        assert job["params"]["volumeId"] == 1, job
        assert "encoded on worker" in job["message"], job
        plane.check_shards(1, golden[1])
        events = [t["event"] for t in job["trace"]]
        assert events[0].startswith("detected by"), events
        assert events[-1].startswith("done by"), events

        lost = plane.lose_server(1)
        job = plane.run_job(job_type="ec_rebuild")
        assert job["status"] == "done", (job["message"], job["trace"])
        assert job["params"]["missingShardIds"] == lost, (job, lost)
        assert f"rebuilt shards {lost} on" in job["message"], job
        plane.check_shards(1, golden[1])

        job = plane.run_job({"jobType": "erasure_coding",
                             "params": {"volumeIds": BATCH}})
        assert job["status"] == "done", (job["message"], job["trace"])
        assert "batch of 3 volumes" in job["message"], job
        for vid in BATCH:
            plane.check_shards(vid, golden[vid])
        if worker == "port":
            # one batched launch a step: every volume's 1 MiB row per
            # step, the largest volume's rows
            assert len(batched_calls) == max(
                -(-len(golden[v][".dat"]) // (10 << 20)) for v in BATCH)

        job = plane.run_job({"jobType": "erasure_coding",
                             "params": {"volumeId": SCATTER,
                                        "encodeMode": "scatter"}})
        assert job["status"] == "done", (job["message"], job["trace"])
        assert "scatter-encoded 14 shards" in job["message"], job
        plane.check_shards(SCATTER, golden[SCATTER])
    finally:
        plane.close()


def test_worker_spans_reach_the_admin(golden, tmp_path):
    """A submitted job runs in the submitter's trace: the worker's
    `job:` span and the encode's stage spans come back through the
    completion report and are served by the admin's /debug/traces."""
    plane = Plane(tmp_path, golden, "port", "port", "port", "port")
    try:
        rid = "plugin-trace-test"
        r = http_json("POST", f"{plane.admin.url}/maintenance/submit_job",
                      {"jobType": "erasure_coding",
                       "params": {"volumeId": 1}}, timeout=30,
                      headers={"X-Request-ID": rid})
        _wait(lambda: plane.admin_call(
            "GET", f"/maintenance/job?id={r['jobId']}")["status"] == "done",
            "job done", timeout=120)
        job = plane.admin_call("GET", f"/maintenance/job?id={r['jobId']}")
        assert job["requestId"] == rid
        spans = http_json("GET", f"{plane.admin.url}/debug/traces"
                          f"?request_id={rid}", timeout=10)["spans"]
        names = {s["name"] for s in spans}
        assert "job:erasure_coding" in names, names
        assert {"encode.read", "encode.codec", "encode.write"} <= names
        job_span = next(s for s in spans if s["name"] == "job:erasure_coding")
        assert job_span["role"] == "worker"
        assert job_span["attrs"]["jobId"] == r["jobId"]
        progress = [t["event"] for t in job["trace"]
                    if t["event"].startswith("progress")]
        assert progress == [
            "progress 0.10: marked readonly",
            "progress 0.30: copied volume files",
            "progress 0.60: encoded 14 shards (cpu)",
            "progress 0.80: distributed shards"], progress
    finally:
        plane.close()


def test_worker_job_without_a_card_fails(golden, tmp_path):
    """A worker-mode job on a CUDA context where there is no card ends
    failed before the volume is touched: it stays writable and in place,
    and no shard is written anywhere."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    plane = Plane(tmp_path, golden, "port", "port", "port", "port")
    try:
        plane.worker.handlers["erasure_coding"].device = "cuda"
        job = plane.run_job({"jobType": "erasure_coding",
                             "params": {"volumeId": 1}})
        assert job["status"] == "failed", job
        assert "no CUDA device" in job["message"], job
        assert 1 in plane.normal_volumes()
        vol = plane.servers[0].store.find_volume(1)
        assert vol is not None and not vol.read_only
        for d in plane.dirs + [plane.worker.work_dir]:
            if os.path.isdir(d):
                assert not [n for n in os.listdir(d) if ".ec" in n], d
    finally:
        plane.close()


# --- the admin's rules, each held to the JAX package's admin --------------

ADMINS = {"ref": RefAdmin, "port": AdminServer}


@pytest.fixture(params=["ref", "port"])
def admin_kind(request):
    return request.param


def _call(admin, method, path, payload=None) -> "tuple[int, dict]":
    import json
    body = json.dumps(payload).encode() if payload is not None else None
    status, data, _ = http_bytes(method, f"{admin.url}{path}", body,
                                 {"Content-Type": "application/json"},
                                 timeout=30)
    return status, json.loads(data or b"{}")


def _register(admin, job_types=("erasure_coding",), fields=()):
    return _call(admin, "POST", "/worker/register", {
        "capabilities": [{"jobType": jt, "canDetect": True,
                          "canExecute": True} for jt in job_types],
        "descriptors": [{"jobType": jt, "fields": list(fields)}
                        for jt in job_types],
        "maxConcurrent": 1})[1]["workerId"]


def _poll(admin, wid) -> dict:
    return _call(admin, "POST", "/worker/poll",
                 {"workerId": wid, "waitSeconds": 0.2})[1]


def _proposal(vid, key=None) -> dict:
    return {"jobType": "erasure_coding", "dedupeKey": key or f"ec:{vid}",
            "params": {"volumeId": vid}}


@pytest.fixture
def admin(admin_kind, tmp_path):
    a = ADMINS[admin_kind]("127.0.0.1:1", detection_interval=3600,
                           data_dir=str(tmp_path / "admin")).start()
    yield a
    a.stop()


def test_dedupe_and_batch_conflict(admin):
    wid = _register(admin)
    st, r = _call(admin, "POST", "/worker/detection_result", {
        "workerId": wid, "proposals": [_proposal(7), _proposal(7)]})
    assert st == 200 and len(r["accepted"]) == 1
    first = r["accepted"][0]
    st, r = _call(admin, "POST", "/worker/detection_result", {
        "workerId": wid, "proposals": [_proposal(7)]})
    assert (st, r) == (200, {"accepted": []})
    # a batch that claims volume 7's key conflicts with the live job
    st, r = _call(admin, "POST", "/maintenance/submit_job", {
        "jobType": "erasure_coding", "params": {"volumeIds": [8, 7]}})
    assert st == 409 and r["jobId"] == first and r["deduped"] is True
    assert "(ec:7)" in r["error"]
    st, r = _call(admin, "POST", "/maintenance/submit_job", {
        "jobType": "erasure_coding", "params": {"volumeIds": [8, 9]}})
    assert st == 200
    batch = r["jobId"]
    # and the batch's keys hold off detection of its volumes
    st, r = _call(admin, "POST", "/worker/detection_result", {
        "workerId": wid, "proposals": [_proposal(9)]})
    assert r == {"accepted": []}
    st, r = _call(admin, "POST", "/maintenance/submit_job", {
        "jobType": "vacuum", "params": {}})
    assert st == 400 and "capability" in r["error"]
    queue = _call(admin, "GET", "/maintenance/queue")[1]["jobs"]
    assert [j["jobId"] for j in queue] == [first, batch]
    # a finished job's key is free again
    assert _poll(admin, wid)["jobId"] == first
    _call(admin, "POST", "/worker/complete", {
        "workerId": wid, "jobId": first, "success": True, "message": "ok"})
    st, r = _call(admin, "POST", "/worker/detection_result", {
        "workerId": wid, "proposals": [_proposal(7)]})
    assert len(r["accepted"]) == 1


def test_completion_only_from_the_owner(admin):
    w1, w2 = _register(admin), _register(admin)
    _call(admin, "POST", "/worker/detection_result", {
        "workerId": w1, "proposals": [_proposal(3)]})
    msg = _poll(admin, w1)
    assert msg["type"] == "executeJob"
    jid = msg["jobId"]
    assert _poll(admin, w2) == {"type": "none"}
    st, r = _call(admin, "POST", "/worker/complete", {
        "workerId": w2, "jobId": jid, "success": False, "message": "x"})
    assert (st, r) == (200, {"ignored": True})
    assert _call(admin, "GET", f"/maintenance/job?id={jid}")[1][
        "status"] == "assigned"
    _call(admin, "POST", "/worker/progress", {
        "workerId": w1, "jobId": jid, "progress": 0.5, "message": "half"})
    job = _call(admin, "GET", f"/maintenance/job?id={jid}")[1]
    assert (job["progress"], job["message"]) == (0.5, "half")
    st, r = _call(admin, "POST", "/worker/complete", {
        "workerId": w1, "jobId": jid, "success": True, "message": "fine"})
    assert (st, r) == (200, {})
    job = _call(admin, "GET", f"/maintenance/job?id={jid}")[1]
    assert (job["status"], job["message"], job["progress"]) == \
        ("done", "fine", 1.0)
    st, r = _call(admin, "POST", "/worker/complete", {
        "workerId": w1, "jobId": jid, "success": False, "message": "late"})
    assert r == {"ignored": True}
    assert _call(admin, "GET", f"/maintenance/job?id={jid}")[1][
        "status"] == "done"
    st, r = _call(admin, "GET", "/maintenance/job?id=nope")
    assert st == 404


@pytest.mark.parametrize("lost", ["stalled", "dead worker"])
def test_lost_job_is_requeued(admin, lost):
    w1, w2 = _register(admin), _register(admin)
    _call(admin, "POST", "/worker/detection_result", {
        "workerId": w1, "proposals": [_proposal(4)]})
    jid = _poll(admin, w1)["jobId"]
    if lost == "stalled":
        admin.JOB_STALL_AFTER = 0.0
    else:
        admin.WORKER_DEAD_AFTER = 0.0
    time.sleep(0.01)
    admin._reap_dead_workers()
    job = _call(admin, "GET", f"/maintenance/job?id={jid}")[1]
    assert (job["status"], job["workerId"], job["message"]) == \
        ("pending", "", "requeued: worker lost or stalled")
    assert admin.workers[w1].inflight == 0
    # another worker takes it; the first one's late report is ignored
    admin.JOB_STALL_AFTER = admin.WORKER_DEAD_AFTER = 3600.0
    assert _poll(admin, w2)["jobId"] == jid
    assert _call(admin, "POST", "/worker/complete", {
        "workerId": w1, "jobId": jid, "success": True})[1] == \
        {"ignored": True}


class _SilentHandler(EcEncodeHandler):
    """An encode handler whose job reports once, then nothing for
    longer than the admin waits for a busy worker."""

    def __init__(self, seconds: float):
        super().__init__(device="cpu")
        self.seconds = seconds
        self.runs = 0

    def detect(self, worker):
        return []

    def execute(self, worker, job_id, params):
        self.runs += 1
        worker.report_progress(job_id, 0.3, "copied volume files")
        time.sleep(self.seconds)
        return "encoded"


def test_a_silent_stage_keeps_its_worker(admin_kind, tmp_path):
    """A stage silent for three times the admin's WORKER_DEAD_AFTER (a
    30 GB pull, encode or push): the worker repeats its last report, so
    the job is not requeued, runs once and ends done."""
    a = ADMINS[admin_kind]("127.0.0.1:1", detection_interval=0.1,
                           data_dir=str(tmp_path / "admin"))
    a.WORKER_DEAD_AFTER = 0.5
    a.start()
    handler = _SilentHandler(seconds=1.5)
    w = PluginWorker(a.url, "127.0.0.1:1", str(tmp_path / "w"), [handler],
                     poll_wait=0.2)
    w.KEEPALIVE = 0.2
    w.start()
    try:
        st, r = _call(a, "POST", "/maintenance/submit_job", {
            "jobType": "erasure_coding", "params": {"volumeId": 1}})
        assert st == 200
        _wait(lambda: _call(a, "GET", f"/maintenance/job?id={r['jobId']}")[
            1]["status"] in ("done", "failed"), "job ended", timeout=30)
        job = _call(a, "GET", f"/maintenance/job?id={r['jobId']}")[1]
        events = [t["event"] for t in job["trace"]]
        assert (job["status"], job["message"]) == ("done", "encoded"), events
        assert handler.runs == 1
        assert not [e for e in events if "requeued" in e], events
        if admin_kind == "port":  # the JAX admin keeps no progress trace
            assert "progress 0.30: copied volume files (still running)" \
                in events
    finally:
        w.stop()
        a.stop()


def test_config_reaches_detection(admin):
    fields = [{"name": "fullnessRatio", "type": "float", "default": 0.9},
              {"name": "collectionFilter", "type": "string"},
              {"name": "dataShards", "type": "int"}]
    wid = _register(admin, fields=fields)
    st, r = _call(admin, "POST", "/maintenance/config", {
        "jobType": "vacuum", "values": {}})
    assert st == 404
    st, r = _call(admin, "POST", "/maintenance/config", {
        "jobType": "erasure_coding", "values": {"nope": 1}})
    assert st == 400 and "unknown field" in r["error"]
    st, r = _call(admin, "POST", "/maintenance/config", {
        "jobType": "erasure_coding", "values": {"dataShards": "x"}})
    assert st == 400 and "wants int" in r["error"]
    st, r = _call(admin, "POST", "/maintenance/config", {
        "jobType": "erasure_coding",
        "values": {"fullnessRatio": "0.5", "dataShards": 6}})
    assert (st, r) == (200, {"jobType": "erasure_coding", "values": {
        "fullnessRatio": 0.5, "dataShards": 6}})
    r = _call(admin, "GET", "/maintenance/config")[1]
    assert r["jobTypes"]["erasure_coding"] == {
        "fields": fields,
        "values": {"fullnessRatio": 0.5, "dataShards": 6}}
    assert _call(admin, "POST", "/maintenance/trigger_detection")[1] == \
        {"asked": [wid]}
    assert _poll(admin, wid) == {"type": "runDetection", "config": {
        "erasure_coding": {"fullnessRatio": 0.5, "dataShards": 6}}}
    assert _poll(admin, wid) == {"type": "none"}


def test_state_survives_a_restart(admin_kind, tmp_path):
    data_dir = str(tmp_path / "admin")
    cls = ADMINS[admin_kind]
    a = cls("127.0.0.1:1", detection_interval=3600,
            data_dir=data_dir).start()
    try:
        fields = [{"name": "fullnessRatio", "type": "float"}]
        wid = _register(a, fields=fields)
        _call(a, "POST", "/maintenance/config", {
            "jobType": "erasure_coding", "values": {"fullnessRatio": 0.7}})
        _call(a, "POST", "/worker/detection_result", {
            "workerId": wid, "proposals": [_proposal(1), _proposal(2)]})
        assigned = _poll(a, wid)["jobId"]
        pending = next(j["jobId"] for j in _call(
            a, "GET", "/maintenance/queue")[1]["jobs"] if j["jobId"] !=
            assigned)
    finally:
        a.stop()
    b = cls("127.0.0.1:1", detection_interval=3600,
            data_dir=data_dir).start()
    try:
        jobs = {j["jobId"]: j["status"] for j in
                _call(b, "GET", "/maintenance/queue")[1]["jobs"]}
        # the assignment died with the old process: requeued
        assert jobs == {assigned: "pending", pending: "pending"}
        job = _call(b, "GET", f"/maintenance/job?id={assigned}")[1]
        assert job["trace"][-1]["event"] == "requeued: admin restart"
        assert _call(b, "GET", "/maintenance/config")[1]["jobTypes"] == {
            "erasure_coding": {"fields": fields,
                               "values": {"fullnessRatio": 0.7}}}
        st, r = _call(b, "POST", "/worker/detection_result", {
            "workerId": wid, "proposals": [_proposal(1)]})
        assert r == {"accepted": []}
        st, r = _call(b, "POST", "/maintenance/submit_job", {
            "jobType": "erasure_coding", "params": {"volumeIds": [2]}})
        assert st == 409 and r["jobId"] == pending
    finally:
        b.stop()


# --- the trace plumbing of the worker seam ---------------------------------

def test_ingest_and_adopted_parent_match_the_reference():
    """The admin re-records reported spans as the JAX package's does
    (malformed and already-buffered ones dropped), and a worker adopts a
    job's trace parent and clears it afterwards."""
    from seaweedfs_tpu import tracing as ref_tracing
    from seaweedfs_tpu_torch import tracing
    docs = [{"traceId": "t-ingest", "spanId": "a1", "name": "job:x",
             "durationMs": 2.0, "role": "worker"},
            {"traceId": "t-ingest", "spanId": "a2", "name": "encode.read"},
            {"traceId": "t-ingest", "spanId": "a1", "name": "job:x"},
            {"traceId": "t-ingest", "name": "no span id"},
            "not a span"]
    assert tracing.ingest(docs) == ref_tracing.ingest(docs) == 2
    assert tracing.ingest(docs) == ref_tracing.ingest(docs) == 0
    assert tracing.spans_for("t-ingest") == ref_tracing.spans_for("t-ingest")
    assert [d["parentId"] for d in tracing.spans_for("t-ingest")] == ["", ""]

    tracing.adopt_remote_parent("t-job-span9", role="worker")
    with tracing.span("job:y") as sp:
        pass
    assert (sp.trace_id, sp.parent_id, sp.role) == \
        ("t-job", "span9", "worker")
    tracing.adopt_remote_parent("")
    assert tracing.current_ids() is None
    token = tracing.set_request_id("rid-1")
    tracing.reset_request_id(token)
    assert tracing.get_request_id() == ""


# --- /metrics and the telemetry notes ---------------------------------------

def _metric(text: str, name: str) -> float:
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def test_metrics_and_telemetry_notes(golden, tmp_path):
    """The same scatter and streamed rebuild on three JAX servers and on
    three port servers: the port's telemetry totals move as the JAX
    package's do, and its /metrics counts them."""
    moved = {}
    for kind in ("ref", "port"):
        master = RefMaster(pulse_seconds=MASTER_PULSE).start()
        made = [master]
        try:
            dirs = [str(tmp_path / f"{kind}{i}") for i in range(3)]
            for i, d in enumerate(dirs):
                os.makedirs(d)
                if i == 0:
                    for ext in (".dat", ".idx"):
                        with open(os.path.join(d, f"1{ext}"), "wb") as f:
                            f.write(golden[1][ext])
            if kind == "ref":
                vs = [RefServer([d], master.url, pulse_seconds=PULSE)
                      for d in dirs]
                mod = ref_telemetry
            else:
                vs = [VolumeServer([d], device="cpu") for d in dirs]
                mod = telemetry
            for s in vs:
                made.append(s.start())
            before = (mod.ec_scatter_totals(), mod.ec_rebuild_totals())
            if kind == "port":
                text0 = http_bytes("GET", f"{vs[0].url}/metrics")[1].decode()
            http_json("POST", f"{vs[0].url}/admin/set_readonly",
                      {"volumeId": 1, "readOnly": True}, timeout=10)
            placement = {str(s): vs[s % 3].url for s in range(TOTAL)}
            r = http_json("POST", f"{vs[0].url}/admin/ec/generate",
                          {"volumeId": 1, "placement": placement},
                          timeout=60)
            assert "error" not in r, r
            lost = [s for s in range(TOTAL) if s % 3 == 2]
            r = http_json("POST", f"{vs[2].url}/admin/ec/delete_shards",
                          {"volumeId": 1, "shardIds": lost}, timeout=10)
            locs = {str(s): [vs[s % 3].url] for s in range(TOTAL)
                    if s % 3 == 1}
            r = http_json("POST", f"{vs[0].url}/admin/ec/rebuild",
                          {"volumeId": 1, "mode": "stream",
                           "shardLocations": locs}, timeout=60)
            assert r.get("rebuiltShardIds") == lost, r
            for sid in lost:
                assert _read(os.path.join(dirs[0], f"1.ec{sid:02d}")) == \
                    golden[1][sid]
            after = (mod.ec_scatter_totals(), mod.ec_rebuild_totals())
            moved[kind] = [{k: a[k] - b[k] for k in a}
                           for a, b in zip(after, before)]
            if kind == "port":
                text = http_bytes("GET", f"{vs[0].url}/metrics")[1].decode()
        finally:
            for s in reversed(made):
                s.stop()
    assert moved["port"] == moved["ref"], moved
    assert moved["port"][0]["count"] == 1 == moved["port"][1]["count"]
    assert moved["port"][0]["bytesScattered"] > 0
    for name in ("ec_scatter_encodes_total", "ec_rebuilds_total"):
        full = f"seaweedfs_tpu_{name}"
        assert _metric(text, full) == _metric(text0, full) + 1, name
    # the source keeps its read-only volume: nothing deleted it
    assert _metric(text, "seaweedfs_tpu_volumes") == 1
    assert _metric(text, "seaweedfs_tpu_ec_volumes") == 1
    assert "# TYPE seaweedfs_tpu_ec_rebuild_bytes_fetched_total counter" \
        in text
    # the wrappers' own launch counts (0 here: CPU tensors launch none)
    for entry, n in (("gf_apply_words", rs_cuda.LAUNCHES),
                     ("gf_apply_words_batched", rs_cuda.LAUNCHES_BATCHED)):
        assert f'seaweedfs_tpu_gf_kernel_launches{{entry="{entry}"}} ' \
            f'{float(n)}\n' in text, entry


def test_telemetry_client_reports_as_the_reference(golden, tmp_path):
    """The opt-in reporter collects the cluster's shape as the JAX
    package's does and POSTs it when enabled; disabled, it sends
    nothing and starts no thread."""
    from seaweedfs_tpu.telemetry import TelemetryClient as RefClient
    from seaweedfs_tpu_torch.server.httpd import HttpServer
    got = []
    collector = HttpServer()
    collector.route("POST", "/telemetry",
                    lambda req: (got.append(req.json()), (200, {}))[1])
    made = [collector]
    collector.start()
    try:
        master = MasterServer(pulse_seconds=MASTER_PULSE).start()
        made.append(master)
        d = tmp_path / "v"
        d.mkdir()
        for ext in (".dat", ".idx"):
            (d / f"1{ext}").write_bytes(golden[1][ext])
        made.append(VolumeServer([str(d)], device="cpu", master=master.url,
                                 pulse_seconds=PULSE).start())
        url = f"http://{collector.url}/telemetry"
        port = telemetry.TelemetryClient(url, enabled=True)
        ref = RefClient(url, enabled=True)
        mine, theirs = port.collect(master.url), ref.collect(master.url)
        assert sorted(mine) == sorted(theirs)
        for key in ("clusterId", "masterCount", "serverCount",
                    "volumeCount", "totalSizeBytes"):
            assert mine[key] == theirs[key], key
        assert (mine["serverCount"], mine["volumeCount"]) == (1, 1)
        assert port.send(master.url) is True
        assert sorted(got[0]) == sorted(mine)
        off = telemetry.TelemetryClient(url)
        assert off.send(master.url) is False
        assert off.start(master.url)._thread is None
        assert len(got) == 1
    finally:
        for s in reversed(made):
            s.stop()


# --- the command line and the imports ---------------------------------------

def _popen(argv, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=cwd, env=dict(os.environ, PYTHONPATH=REPO))


def test_admin_and_worker_on_the_command_line(tmp_path):
    """`master`, `admin` and `worker` as subprocesses: their first lines,
    the worker registered with the admin, and a clean SIGTERM."""
    import select
    procs = []

    def first_line(p, pattern):
        ready, _, _ = select.select([p.stdout], [], [], 60)
        line = p.stdout.readline() if ready else ""
        m = re.fullmatch(pattern, line)
        assert m, (line, p.stderr.read() if p.poll() is not None else "")
        return m.group(1)
    try:
        procs.append(_popen(["master", "-port", "0"], str(tmp_path)))
        murl = first_line(procs[-1], r"master server listening on (\S+)\n")
        procs.append(_popen(["admin", "-port", "0", "-master", murl,
                             "-dataDir", str(tmp_path / "a")],
                            str(tmp_path)))
        aurl = first_line(procs[-1], r"admin listening on (\S+:\d+)\n")
        procs.append(_popen(["worker", "-admin", aurl, "-master", murl,
                             "-dir", str(tmp_path / "w"), "-device", "cpu"],
                            str(tmp_path)))
        wid = first_line(procs[-1], rf"worker (\w+) polling {aurl}\n")
        r = http_json("GET", f"{aurl}/maintenance/config", timeout=10)
        # the JAX worker's default capabilities: erasure_coding,vacuum
        assert sorted(r["jobTypes"]) == ["ec_rebuild", "erasure_coding",
                                         "vacuum"]
        assert os.path.exists(tmp_path / "a" / "plugin" / "workers.json")
        assert wid
        # the admin first: its stop ends the worker's long poll
        for p in (procs[1], procs[2], procs[0]):
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=30) == 0, p.stderr.read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
            p.stdout.close()
            p.stderr.close()


def test_master_reports_telemetry_when_asked(tmp_path):
    """`master -telemetry -telemetryUrl` says so on its second line and
    posts a report to the collector at once; without the flags it
    sends nothing."""
    import threading
    from seaweedfs_tpu_torch.server.httpd import HttpServer
    got = []
    collector = HttpServer()
    collector.route("POST", "/telemetry",
                    lambda req: (got.append(req.json()), (200, {}))[1])
    collector.start()
    url = f"http://{collector.url}/telemetry"
    procs = []

    def line(p):
        # a thread, not select: the first readline may buffer both lines
        out = []
        t = threading.Thread(target=lambda: out.append(p.stdout.readline()),
                             daemon=True)
        t.start()
        t.join(60)
        return out[0] if out else ""
    try:
        procs.append(_popen(["master", "-port", "0"], str(tmp_path)))
        assert line(procs[0]).startswith("master server listening on ")
        procs.append(_popen(["master", "-port", "0", "-telemetry",
                             "-telemetryUrl", url], str(tmp_path)))
        assert line(procs[1]).startswith("master server listening on ")
        assert line(procs[1]) == f"telemetry enabled -> {url}\n"
        _wait(lambda: got, "a telemetry report")
        assert got[0]["version"] == telemetry.VERSION
        assert got[0]["serverCount"] == 0
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=30) == 0, p.stderr.read()
        assert len(got) == 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
            p.stdout.close()
            p.stderr.close()
        collector.stop()


def test_plugin_loads_no_jax():
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.plugin\n"
            "import seaweedfs_tpu_torch.plugin.handlers\n"
            "import seaweedfs_tpu_torch.telemetry\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'seaweedfs_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout == "[]\n"
