"""The port's volume maintenance plane on the CPU, against the JAX
package's.  Tolerance: exact equality (proposals, answers, bytes).

- detection: the vacuum, volume balance and EC balance handlers propose
  what the JAX handlers propose for the same `/vol/list` and
  `/cluster/status` answers (seeded topologies);
- execution over an in-process port cluster (a master, 4 volume
  servers, the admin and a worker with the three handlers): a vacuum
  found by detection shrinks the volume and keeps every live needle; a
  volume count skew of 6 and an EC volume whose 14 shards sit on one
  server are balanced;
- the worker's default capabilities are the JAX worker's
  (`erasure_coding,vacuum`), and `vacuum`, `volume_balance`/`balance`
  and `ec_balance` are accepted on the command line;
- `/admin/vacuum_toggle` answers and its 409, as the JAX server's;
- the read plane across the `.dat` swap of a compaction and of a merge
  (C16): needles read through the native read plane during the copy
  and after the commit are the live bytes (the JAX server serves other
  bytes), and the write plane is refused a volume while it compacts;
- on the `-fsync` tier, writes through the write plane and the Python
  port during a vacuum all ack and read back;
- `/admin/vacuum` of a volume an EC generate holds answers 409 (C17; the
  JAX route compacts it under the generate);
- the admin UI: its pages, and a write without the CSRF token or the
  admin key refused.

Needles of 1-40 KB, volumes under 2 MiB; servers pulse every `PULSE`
seconds and masters drop a server after 3 x `MASTER_PULSE`.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.parse

import numpy as np
import pytest

from seaweedfs_tpu.plugin.handlers import balance as ref_balance
from seaweedfs_tpu.plugin.handlers import vacuum as ref_vacuum
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu_torch import operation, security
from seaweedfs_tpu_torch import __main__ as port_main
from seaweedfs_tpu_torch.plugin import (AdminServer, EcBalanceHandler,
                                        PluginWorker, VacuumHandler,
                                        VolumeBalanceHandler)
from seaweedfs_tpu_torch.plugin.handlers import balance as port_balance
from seaweedfs_tpu_torch.plugin.handlers import vacuum as port_vacuum
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.topology import (iter_volume_list_ec_shards,
                                          iter_volume_list_volumes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PULSE = 0.2
MASTER_PULSE = 1.0
needs_gpp = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the planes")


def _wait(cond, what: str, timeout: float = 30.0) -> None:
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out: {what}"
        time.sleep(0.05)


def _payload(i: int, n: int) -> bytes:
    return np.random.default_rng([11, i]).bytes(n)


# --- detection against the JAX handlers ---------------------------------

def _topology(seed: int) -> "tuple[dict, dict]":
    """A seeded /vol/list answer (2 data centers, 3 racks, 6 servers,
    volumes with garbage and read-only ones, EC volumes spread or piled)
    and its /cluster/status."""
    rng = np.random.default_rng(seed)
    urls = [f"127.0.0.1:{8080 + i}" for i in range(6)]
    tree: dict = {"dataCenters": {}}
    vid = 0
    for i, url in enumerate(urls):
        dc = tree["dataCenters"].setdefault(f"dc{i % 2}", {"racks": {}})
        rack = dc["racks"].setdefault(f"r{i % 3}", {"nodes": []})
        vols = []
        for _ in range(int(rng.integers(0, 2 + 3 * (i == 0) * seed % 5))):
            vid += 1
            size = int(rng.integers(1 << 20, 64 << 20))
            # seeds 0 and 3 keep every ratio under the threshold
            top = 0.2 if seed % 3 == 0 else 0.6
            vols.append({"id": vid, "collection": "", "size": size,
                         "fileCount": 10,
                         "deletedByteCount": int(size * rng.uniform(0, top)),
                         "readOnly": bool(rng.integers(0, 5) == 0)})
        ecs = []
        for ev in (100, 101):
            if seed % 3 == 0:        # spread: 2 or 3 shards a server
                sids = [i, i + 6] + ([12 + i - 4] if i >= 4 else [])
                bits = sum(1 << s for s in sids) if ev == 100 else 0
            elif seed % 3 == 1:      # random
                bits = int(rng.integers(0, 1 << 14))
            else:                    # piled on one server
                bits = 0x3FFF if i == 0 and ev == 100 else 0
            if bits:
                ecs.append({"volumeId": ev, "collection": "",
                            "shardBits": bits})
        rack["nodes"].append({"url": url, "volumes": vols,
                              "ecShards": ecs, "maxVolumeCount": 8})
    return tree, {"dataNodes": urls, "leader": "m", "peers": ["m"]}


class _StubWorker:
    master = "127.0.0.1:1"


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["vacuum", "volume_balance", "ec_balance"])
def test_detection_proposes_what_the_jax_handlers_propose(monkeypatch, seed,
                                                          kind):
    vl, status = _topology(seed)

    def fake(master, method, path, *a, **kw):
        return vl if path == "/vol/list" else status
    for mod in (ref_vacuum, port_vacuum, ref_balance, port_balance):
        monkeypatch.setattr(mod, "master_json", fake)
    ref_cls, port_cls = {
        "vacuum": (ref_vacuum.VacuumHandler, port_vacuum.VacuumHandler),
        "volume_balance": (ref_balance.VolumeBalanceHandler,
                           port_balance.VolumeBalanceHandler),
        "ec_balance": (ref_balance.EcBalanceHandler,
                       port_balance.EcBalanceHandler)}[kind]
    ref, port = ref_cls(), port_cls()
    assert port.capability() == ref.capability()
    assert port.descriptor() == ref.descriptor()
    assert port.detect(_StubWorker()) == ref.detect(_StubWorker())


def test_the_topologies_exercise_every_rule(monkeypatch):
    """The seeded topologies above hold proposals and non-proposals of
    each handler (the comparison is not vacuous)."""
    seen = {"vacuum": set(), "volume_balance": set(), "ec_balance": set()}
    for seed in range(6):
        vl, status = _topology(seed)
        fake = (lambda vl, st: lambda m, meth, path, *a, **k:
                vl if path == "/vol/list" else st)(vl, status)
        for mod in (port_vacuum, port_balance):
            monkeypatch.setattr(mod, "master_json", fake)
        for name, h in (("vacuum", VacuumHandler()),
                        ("volume_balance", VolumeBalanceHandler()),
                        ("ec_balance", EcBalanceHandler())):
            seen[name].add(bool(h.detect(_StubWorker())))
    assert all(v == {True, False} for v in seen.values()), seen


# --- the worker's capabilities -------------------------------------------

def test_the_default_capabilities_are_the_jax_workers():
    # both parsers are built inside main(): read the defaults off source
    jax_main = open(os.path.join(REPO, "seaweedfs_tpu", "__main__.py")).read()
    default = re.search(r'wk\.add_argument\("-capabilities", '
                        r'default="([^"]+)"\)', jax_main).group(1)
    port_src = open(os.path.join(REPO, "seaweedfs_tpu_torch",
                                 "__main__.py")).read()
    assert f'wk.add_argument("-capabilities", default="{default}")' \
        in port_src
    got = [h.job_type for h in
           port_main._worker_handlers(default.split(","), "cpu")]
    assert got == ["erasure_coding", "ec_rebuild", "vacuum"]
    every = port_main._worker_handlers(
        ["ec_rebuild", "vacuum", "balance", "ec_balance"], "cpu")
    assert [h.job_type for h in every] == \
        ["ec_rebuild", "vacuum", "volume_balance", "ec_balance"]
    assert [h.job_type for h in port_main._worker_handlers(
        ["volume_balance"], "cpu")] == ["volume_balance"]


def test_a_worker_started_with_no_capabilities_registers_the_defaults(
        tmp_path):
    master = MasterServer(pulse_seconds=MASTER_PULSE).start()
    admin = AdminServer(master.url, detection_interval=3600).start()
    p = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "worker", "-admin",
         admin.url, "-master", master.url, "-dir", str(tmp_path),
         "-device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO)
    try:
        line = p.stdout.readline()
        assert line.startswith("worker ") and "polling" in line, \
            (line, p.stderr.read() if p.poll() is not None else "")
        with admin.lock:
            (w,) = admin.workers.values()
            caps = sorted(c["jobType"] for c in w.capabilities)
        assert caps == ["ec_rebuild", "erasure_coding", "vacuum"]
        for name in ("erasure_coding", "ec_rebuild", "vacuum"):
            assert name in admin.schemas
    finally:
        admin.stop()
        p.terminate()
        assert p.wait(timeout=30) == 0
        p.stdout.close()
        p.stderr.close()
        master.stop()


# --- an in-process port cluster ------------------------------------------

class Cluster:
    def __init__(self, tmp, n: int = 4, limit_mb: int = 64):
        self.master = MasterServer(volume_size_limit_mb=limit_mb,
                                   pulse_seconds=MASTER_PULSE).start()
        self.url = self.master.url
        self.dirs = [os.path.join(str(tmp), f"v{i}") for i in range(n)]
        self.servers = []
        for i, d in enumerate(self.dirs):
            os.makedirs(d)
            self.servers.append(VolumeServer(
                [d], device="cpu", master=self.url, pulse_seconds=PULSE,
                rack=f"r{i % 2}").start())
        _wait(lambda: len(self.get("/cluster/status")["dataNodes"]) == n,
              "servers registered")
        self.admin = None
        self.worker = None
        self.taken: set = set()

    def get(self, path: str) -> dict:
        return http_json("GET", f"{self.url}{path}", timeout=10)

    def start_plane(self, handlers) -> None:
        self.admin = AdminServer(self.url, detection_interval=3600).start()
        self.worker = PluginWorker(self.admin.url, self.url,
                                   os.path.join(self.dirs[0], "..", "w"),
                                   handlers, poll_wait=0.5).start()

    def job(self, job_type: str) -> dict:
        """Trigger detection and wait for the first job of `job_type`
        not waited for before, and for its end."""
        a = self.admin.url
        http_json("POST", f"{a}/maintenance/trigger_detection", {})
        new: list = []
        _wait(lambda: new.extend(
            j["jobId"] for j in http_json(
                "GET", f"{a}/maintenance/queue")["jobs"]
            if j["jobId"] not in self.taken and j["jobType"] == job_type)
            or new, f"a {job_type} job proposed")
        jid = new[0]
        self.taken.add(jid)
        _wait(lambda: http_json("GET", f"{a}/maintenance/job?id={jid}")[
            "status"] in ("done", "failed"), f"job {jid} ends", 120)
        return http_json("GET", f"{a}/maintenance/job?id={jid}")

    def close(self) -> None:
        if self.worker is not None:
            self.admin.stop()
            self.worker.stop()
        for s in self.servers:
            s.stop()
        self.master.stop()

    def counts(self) -> "dict[str, int]":
        out = {s.url: 0 for s in self.servers}
        for n, _v in iter_volume_list_volumes(self.get("/vol/list")):
            out[n["url"]] += 1
        return out


@pytest.fixture
def cluster(tmp_path):
    c = Cluster(tmp_path)
    yield c
    c.close()


def _fill(url: str, vid: int, n: int, seed: int) -> dict:
    """n needles of 1-40 KB written to volume vid on url: {fid: data}."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(1, n + 1):
        fid = f"{vid},{i:x}{i:08x}"
        data = _payload(seed * 1000 + i, int(rng.integers(1000, 40_000)))
        st, body, _ = http_bytes("POST", f"{url}/{fid}", data, timeout=30)
        assert st == 201, (st, body)
        out[fid] = data
    return out


def test_vacuum_and_balances_run_through_the_worker(cluster):
    c = cluster
    c.start_plane([VacuumHandler(), VolumeBalanceHandler(),
                   EcBalanceHandler()])
    s0 = c.servers[0]
    http_json("POST", f"{s0.url}/admin/allocate_volume", {"volumeId": 1},
              timeout=30)
    fids = _fill(s0.url, 1, 60, 1)
    dead = sorted(fids)[::2]
    freed = sum(len(fids[f]) for f in dead)
    for fid in dead:
        st, _, _ = http_bytes("DELETE", f"{s0.url}/{fid}", timeout=30)
        assert st == 202
    v = s0.store.find_volume(1)
    before = v.dat_size()
    s0._heartbeat_once()
    job = c.job("vacuum")
    assert job["status"] == "done", job
    assert "volume 1: vacuumed on 1 servers" in job["message"]
    assert before - v.dat_size() >= 0.95 * freed
    for fid, data in fids.items():
        st, body, _ = http_bytes("GET", f"{s0.url}/{fid}", timeout=30)
        assert (st, body) == ((404, body) if fid in dead else (200, data))

    # six volumes on server 0, none elsewhere: a spread of 6
    for vid in range(2, 7):
        http_json("POST", f"{s0.url}/admin/allocate_volume",
                  {"volumeId": vid}, timeout=30)
    job = c.job("volume_balance")
    assert job["status"] == "done" and "moved" in job["message"], job
    _wait(lambda: max(c.counts().values()) - min(c.counts().values()) <= 2,
          "a spread of at most 2")
    (loc,) = operation.lookup(c.url, 1, use_cache=False)
    for fid, data in fids.items():
        if fid not in dead:
            assert http_bytes("GET", f"{loc['url']}/{fid}")[1] == data

    # an EC volume whose 14 shards all sit on one server
    s1 = c.servers[1]
    http_json("POST", f"{s1.url}/admin/allocate_volume", {"volumeId": 20},
              timeout=30)
    ec_fids = _fill(s1.url, 20, 30, 2)
    http_json("POST", f"{s1.url}/admin/set_readonly", {"volumeId": 20},
              timeout=30)
    r = http_json("POST", f"{s1.url}/admin/ec/generate", {"volumeId": 20},
                  timeout=120)
    assert r.get("shardIds") == list(range(14)), r
    http_json("POST", f"{s1.url}/admin/ec/mount",
              {"volumeId": 20, "shardIds": list(range(14))}, timeout=30)
    http_json("POST", f"{s1.url}/admin/delete_volume", {"volumeId": 20},
              timeout=30)
    _wait(lambda: any(bin(e["shardBits"]).count("1") == 14 for _n, e in
                      iter_volume_list_ec_shards(c.get("/vol/list"))),
          "14 shards on one server")
    job = c.job("ec_balance")
    assert job["status"] == "done", job

    def per_server():
        out: dict = {}
        for n, e in iter_volume_list_ec_shards(c.get("/vol/list")):
            if e["volumeId"] == 20:
                out[n["url"]] = bin(e["shardBits"]).count("1")
        return out
    _wait(lambda: sum(per_server().values()) == 14 and
          max(per_server().values()) <= 4, "at most ceil(14/4) a server")
    for s in c.servers:
        s._nc_drop_volume(20)
    for fid, data in list(ec_fids.items())[:8]:
        assert operation.read(c.url, fid) == data


def test_vacuum_toggle_answers_as_the_jax_server(tmp_path):
    master = MasterServer(pulse_seconds=MASTER_PULSE).start()
    dirs = [str(tmp_path / "port"), str(tmp_path / "ref")]
    port = VolumeServer([dirs[0]], device="cpu").start()
    ref = RefServer([dirs[1]], "").start()
    try:
        answers = []
        for vs in (port, ref):
            http_json("POST", f"{vs.url}/admin/allocate_volume",
                      {"volumeId": 3}, timeout=30)
            got = [http_json("POST", f"{vs.url}/admin/vacuum_toggle",
                             {"enabled": False}, timeout=30)]
            st, body, _ = http_bytes(
                "POST", f"{vs.url}/admin/vacuum",
                json.dumps({"volumeId": 3}).encode(),
                {"Content-Type": "application/json"}, timeout=30)
            got.append((st, json.loads(body)))
            got.append(http_json("POST", f"{vs.url}/admin/vacuum_toggle",
                                 {}, timeout=30))
            r = http_json("POST", f"{vs.url}/admin/vacuum",
                          {"volumeId": 3}, timeout=30)
            got.append(r["garbageRatio"])
            answers.append(got)
        assert answers[0] == answers[1]
        assert answers[0][1][0] == 409
    finally:
        port.stop()
        ref.stop()
        master.stop()


# --- the read plane across the swap (C16) --------------------------------

def _plane_get(vs: VolumeServer, fid: str) -> "tuple[int, bytes]":
    host = vs.url.rsplit(":", 1)[0]
    st, body, _ = http_bytes("GET", f"{host}:{vs.read_plane.port}/{fid}",
                             timeout=30)
    return st, body


@needs_gpp
@pytest.mark.parametrize("how", ["vacuum", "merge"])
def test_c16_port_read_plane_serves_live_bytes_across_the_swap(
        tmp_path, monkeypatch, how):
    """A read through the Python port during the copy re-adds the
    volume to the read plane with an fd on the old `.dat`; after the
    swap, needles registered from the new needle map must not be read
    through it.  Every needle is read through the plane during the copy
    and after the commit (a plane 404 falls back to the Python port,
    which registers the needle, and the plane is asked again)."""
    vs = VolumeServer([str(tmp_path / "v")], device="cpu").start()
    try:
        assert vs.read_plane is not None
        http_json("POST", f"{vs.url}/admin/allocate_volume",
                  {"volumeId": 5}, timeout=30)
        fids = _fill(vs.url, 5, 40, 5)
        for fid in sorted(fids)[:20]:
            http_bytes("DELETE", f"{vs.url}/{fid}", timeout=30)
            fids.pop(fid)
        if how == "merge":
            http_json("POST", f"{vs.url}/admin/set_readonly",
                      {"volumeId": 5}, timeout=30)

        def through_plane(fid):
            st, body = _plane_get(vs, fid)
            if st == 404:
                st, body, _ = http_bytes("GET", f"{vs.url}/{fid}",
                                         timeout=30)
                assert st == 200
                st, body = _plane_get(vs, fid)
            return st, body

        during = []
        original = port_volume.Volume._swap_in_shadows

        early = dict(sorted(fids.items())[::2])

        def swap(self):
            # the copy is done, the swap is next: read half the needles
            # through the plane now (re-adding the volume on the old fd)
            during.extend(through_plane(f) == (200, d)
                          for f, d in early.items())
            return original(self)
        monkeypatch.setattr(port_volume.Volume, "_swap_in_shadows", swap)
        if how == "vacuum":
            r = http_json("POST", f"{vs.url}/admin/vacuum",
                          {"volumeId": 5}, timeout=60)
        else:
            r = http_json("POST", f"{vs.url}/admin/volume/merge",
                          {"volumeId": 5, "peers": []}, timeout=60)
        assert "error" not in r, r
        assert during and all(during)
        # the other half registers now, at new-layout offsets; and
        # needles written after the commit
        if how == "merge":
            http_json("POST", f"{vs.url}/admin/set_readonly",
                      {"volumeId": 5, "readOnly": False}, timeout=30)
        fids.update(_fill(vs.url, 5, 50, 6))
        for fid, data in sorted(fids.items()):
            assert through_plane(fid) == (200, data), fid
        assert vs.read_plane.served() > len(fids)
    finally:
        vs.stop()


@needs_gpp
def test_c16_jax_read_plane_serves_old_dat_bytes_after_a_vacuum(
        tmp_path, monkeypatch):
    """The JAX server drops the volume from its read plane once, before
    the compaction: a read during the copy re-adds it with an fd on the
    old `.dat`, and a needle registered after the swap is then read at
    its new offset in the old file.  Shown: the plane answers 200 with
    other bytes than the needle's."""
    from seaweedfs_tpu.storage import volume as ref_volume
    vs = RefServer([str(tmp_path / "v")], "").start()
    try:
        if vs.read_plane is None:
            pytest.skip("the JAX read plane did not start")
        http_json("POST", f"{vs.url}/admin/allocate_volume",
                  {"volumeId": 5}, timeout=30)
        fids = _fill(vs.url, 5, 40, 5)
        for fid in sorted(fids)[:20]:
            http_bytes("DELETE", f"{vs.url}/{fid}", timeout=30)
            fids.pop(fid)
        host = vs.url.rsplit(":", 1)[0]

        def plane(fid):
            http_bytes("GET", f"{vs.url}/{fid}", timeout=30)   # warms it
            st, body, _ = http_bytes(
                "GET", f"{host}:{vs.read_plane.port}/{fid}", timeout=30)
            return st, body
        early = dict(sorted(fids.items())[::2])
        original = ref_volume.Volume.commit_compact

        def commit(self):
            for f in early:
                plane(f)
            return original(self)
        monkeypatch.setattr(ref_volume.Volume, "commit_compact", commit)
        r = http_json("POST", f"{vs.url}/admin/vacuum", {"volumeId": 5},
                      timeout=60)
        assert "error" not in r, r
        late = {f: plane(f) for f in fids if f not in early}
        wrong = [f for f, (st, body) in late.items()
                 if st == 200 and body != fids[f]]
        assert wrong, "every needle read back right"
    finally:
        vs.stop()


@needs_gpp
def test_c16_port_write_plane_is_refused_while_compacting(tmp_path):
    """A thaw or mount that offers the volume to the write plane in the
    middle of a compaction is refused: native appends to the old `.dat`
    would be lost in the swap."""
    vs = VolumeServer([str(tmp_path / "v")], device="cpu").start()
    try:
        if vs.write_plane is None:
            pytest.skip("no write plane on this host")
        http_json("POST", f"{vs.url}/admin/allocate_volume",
                  {"volumeId": 6}, timeout=30)
        v = vs.store.find_volume(6)
        assert v._wp is not None
        v.compact()
        assert v._wp is None
        assert not v.attach_native(vs.write_plane)
        v.commit_compact()
        assert v.attach_native(vs.write_plane)
    finally:
        vs.stop()


@needs_gpp
def test_fsync_tier_acks_every_write_across_a_vacuum(tmp_path):
    """On the `-fsync` tier, uploads through the write plane (acks parked
    on a flush epoch) and through the Python port (while the plane is
    detached) race a vacuum: every one acks, every one reads back, the
    fsyncs ran, and the plane owns the volume again after."""
    from seaweedfs_tpu_torch import stats
    vs = VolumeServer([str(tmp_path / "v")], device="cpu",
                      fsync=True).start()
    try:
        if vs.write_plane is None or not vs.write_plane.can_handshake():
            pytest.skip("no write plane with the epoch handshake here")
        operation._invalidate_status(vs.url)
        http_json("POST", f"{vs.url}/admin/allocate_volume",
                  {"volumeId": 9}, timeout=30)
        v = vs.store.find_volume(9)
        assert v._wp is not None
        fids = _fill(vs.url, 9, 30, 9)
        for fid in sorted(fids)[:15]:
            http_bytes("DELETE", f"{vs.url}/{fid}", timeout=30)
            fids.pop(fid)
        fsyncs0 = stats.PROCESS.counter_sum("volume_fsyncs_total")
        native0 = vs.write_plane.requests()
        acked: dict = {}
        stop = threading.Event()
        errors: list = []

        def writer(w):
            i = 0
            while not stop.is_set() or i < 20:
                i += 1
                key = 1000 * (w + 1) + i
                fid = f"9,{key:x}{key:08x}"
                data = _payload(key, 700)
                try:
                    operation.upload(vs.url, fid, data)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))
                    return
                acked[fid] = data
        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(3)]
        for th in threads:
            th.start()
        time.sleep(0.2)
        r = http_json("POST", f"{vs.url}/admin/vacuum", {"volumeId": 9},
                      timeout=60)
        stop.set()
        for th in threads:
            th.join(60)
        assert "error" not in r and not errors, (r, errors)
        assert vs.write_plane.requests() > native0
        assert stats.PROCESS.counter_sum("volume_fsyncs_total") > fsyncs0
        vs._wp_tick()
        for fid, data in {**fids, **acked}.items():
            assert http_bytes("GET", f"{vs.url}/{fid}")[1] == data, fid
        assert v._wp is not None           # offered again after the swap
    finally:
        vs.stop()


def test_c17_jax_vacuum_swaps_the_dat_under_an_ec_generate(tmp_path,
                                                           monkeypatch):
    """The JAX route compacts a read-only volume while an EC generate is
    between its `.ecx` (written from the old `.idx`) and its shards (read
    from the `.dat`): the vacuum answers 200 and the `.dat` the encoder
    then reads is the compacted one, whose offsets the `.ecx` does not
    hold."""
    from seaweedfs_tpu.storage.erasure_coding import ec_encoder as ref_enc
    vs = RefServer([str(tmp_path / "v")], "").start()
    try:
        http_json("POST", f"{vs.url}/admin/allocate_volume",
                  {"volumeId": 8}, timeout=30)
        fids = _fill(vs.url, 8, 10, 8)
        for fid in sorted(fids)[:5]:
            http_bytes("DELETE", f"{vs.url}/{fid}", timeout=30)
        http_json("POST", f"{vs.url}/admin/set_readonly", {"volumeId": 8},
                  timeout=30)
        v = vs.store.find_volume(8)
        inside, release = threading.Event(), threading.Event()
        seen = []
        real = ref_enc.write_ec_files

        def slow(base, *a, **kw):
            inside.set()
            release.wait(30)
            seen.append(os.path.getsize(base + ".dat"))
            return real(base, *a, **kw)
        monkeypatch.setattr(ref_enc, "write_ec_files", slow)
        before = v.dat_size()
        t = threading.Thread(target=lambda: http_json(
            "POST", f"{vs.url}/admin/ec/generate", {"volumeId": 8},
            timeout=60))
        t.start()
        assert inside.wait(30)
        r = http_json("POST", f"{vs.url}/admin/vacuum", {"volumeId": 8},
                      timeout=30)
        release.set()
        t.join(60)
        assert "error" not in r
        assert seen == [v.dat_size()] and seen[0] < before
    finally:
        vs.stop()


def test_c17_port_vacuum_refused_while_ec_generate_holds_the_volume(
        tmp_path, monkeypatch):
    """`/admin/vacuum` does not refuse a read-only volume (neither does
    the JAX route); a compaction swapping the `.dat` under an EC generate
    that reads it would encode a mixed volume.  The port holds the volume
    for the generate and answers 409 to a vacuum meanwhile."""
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    vs = VolumeServer([str(tmp_path / "v")], device="cpu").start()
    try:
        http_json("POST", f"{vs.url}/admin/allocate_volume",
                  {"volumeId": 8}, timeout=30)
        _fill(vs.url, 8, 10, 8)
        http_json("POST", f"{vs.url}/admin/set_readonly", {"volumeId": 8},
                  timeout=30)
        inside, release = threading.Event(), threading.Event()
        real = ec_encoder.write_ec_files

        def slow(*a, **kw):
            inside.set()
            release.wait(30)
            return real(*a, **kw)
        monkeypatch.setattr(ec_encoder, "write_ec_files", slow)
        out: list = []
        t = threading.Thread(target=lambda: out.append(http_json(
            "POST", f"{vs.url}/admin/ec/generate", {"volumeId": 8},
            timeout=60)))
        t.start()
        assert inside.wait(30)
        st, body, _ = http_bytes("POST", f"{vs.url}/admin/vacuum",
                                 json.dumps({"volumeId": 8}).encode(),
                                 {"Content-Type": "application/json"},
                                 timeout=30)
        release.set()
        t.join(60)
        assert st == 409 and b"ec.generate" in body, (st, body)
        assert out[0].get("shardIds") == list(range(14)), out
        r = http_json("POST", f"{vs.url}/admin/vacuum", {"volumeId": 8},
                      timeout=30)
        assert "error" not in r, r
    finally:
        vs.stop()


# --- the admin UI --------------------------------------------------------

@pytest.fixture
def ui(tmp_path):
    master = MasterServer(pulse_seconds=MASTER_PULSE).start()
    vs = VolumeServer([str(tmp_path / "v")], device="cpu",
                      master=master.url, pulse_seconds=PULSE).start()
    _wait(lambda: http_json("GET", f"{master.url}/cluster/status")[
        "dataNodes"], "the server registered")
    admin = AdminServer(master.url, detection_interval=3600,
                        data_dir=str(tmp_path / "admin")).start()
    worker = PluginWorker(admin.url, master.url, str(tmp_path / "w"),
                          [VacuumHandler()], poll_wait=0.5).start()
    yield master, vs, admin
    admin.stop()
    worker.stop()
    vs.stop()
    master.stop()


def _csrf(html: str) -> str:
    return re.search(r"name='csrf' value='([0-9a-f]+)'", html).group(1)


def _form(url: str, fields: dict, headers=None):
    return http_bytes("POST", url, urllib.parse.urlencode(fields).encode(),
                      {"Content-Type": "application/x-www-form-urlencoded",
                       **(headers or {})}, timeout=30)


def test_admin_ui_pages(ui):
    master, vs, admin = ui
    http_json("POST", f"{vs.url}/admin/allocate_volume", {"volumeId": 4},
              timeout=30)
    vs._heartbeat_once()
    pages = {}
    for path in ("/", "/ui/volumes", "/ui/ec", "/ui/jobs", "/ui/config"):
        st, body, hdrs = http_bytes("GET", f"{admin.url}{path}", timeout=30)
        assert st == 200 and hdrs["Content-Type"].startswith("text/html"), \
            (path, st)
        pages[path] = body.decode()
    assert vs.url in pages["/ui/volumes"] and ">4<" in pages["/ui/volumes"]
    assert "vacuum" in pages["/ui/config"] and "name='csrf'" in \
        pages["/ui/config"]
    assert "garbageThreshold" in pages["/ui/config"]


def test_admin_ui_writes_need_the_csrf_token(ui):
    master, vs, admin = ui
    html = http_bytes("GET", f"{admin.url}/ui/config", timeout=30)[1].decode()
    token = _csrf(html)
    st, _, _ = _form(f"{admin.url}/ui/config",
                     {"jobType": "vacuum", "garbageThreshold": "0.5"})
    assert st == 403
    st, _, _ = _form(f"{admin.url}/ui/config",
                     {"jobType": "vacuum", "garbageThreshold": "0.5",
                      "csrf": "0" * len(token)})
    assert st == 403
    st, _, hdrs = _form(f"{admin.url}/ui/config",
                        {"jobType": "vacuum", "garbageThreshold": "0.5",
                         "csrf": token})
    assert st == 303 and hdrs.get("Location") == "/ui/config"
    cfg = http_json("GET", f"{admin.url}/maintenance/config", timeout=30)
    assert cfg["jobTypes"]["vacuum"]["values"]["garbageThreshold"] == 0.5
    # persisted: a restarted admin over the same data dir keeps it
    saved = json.load(open(os.path.join(admin.data_dir, "plugin",
                                        "config.json")))
    assert saved["vacuum"]["garbageThreshold"] == 0.5
    st, _, _ = _form(f"{admin.url}/ui/actions", {"action": "detect"})
    assert st == 403
    st, _, hdrs = _form(f"{admin.url}/ui/actions",
                        {"action": "detect", "csrf": token})
    assert st == 303 and hdrs.get("Location") == "/ui/jobs"
    st, body, _ = _form(f"{admin.url}/ui/actions",
                        {"action": "submit", "jobType": "vacuum",
                         "params": json.dumps({"volumeId": 99}),
                         "csrf": token})
    assert st == 303, body
    jobs = http_json("GET", f"{admin.url}/maintenance/queue")["jobs"]
    assert any(j["params"] == {"volumeId": 99} for j in jobs)


def test_admin_ui_writes_need_the_admin_key(tmp_path):
    """Under `[admin] key` a UI write without the admin JWT is refused
    (403, before its CSRF check); with it, the write lands."""
    security.configure(security.SecurityConfig(admin_key="k" * 32))
    try:
        master = MasterServer(pulse_seconds=MASTER_PULSE).start()
        admin = AdminServer(master.url, detection_interval=3600).start()
        try:
            st, body, _ = http_bytes("GET", f"{admin.url}/ui/jobs",
                                     timeout=30)
            assert st == 200
            token = _csrf(body.decode())
            # `_form` goes through http_bytes, which adds this process's
            # admin JWT on admin paths: strip it for the refused case
            bare = {"Authorization": "Bearer x"}
            st, body, _ = _form(f"{admin.url}/ui/actions",
                                {"action": "detect", "csrf": token},
                                headers=bare)
            assert st == 403 and b"admin credentials" in body
            jwt = security.current().admin_jwt()
            st, _, _ = _form(f"{admin.url}/ui/actions",
                             {"action": "detect", "csrf": token},
                             headers={"Authorization": f"Bearer {jwt}"})
            assert st == 303
        finally:
            admin.stop()
            master.stop()
    finally:
        security.configure(None)
