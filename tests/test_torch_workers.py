"""The port's pre-fork filer fleet (`filer -workers N`): the counterpart
of the reference test `test_crash_durability.py::
test_filer_worker_sibling_sigkill_stays_coherent`, on the threaded front
and on the asyncio front.

A fleet of 2 serves one port; a sibling is SIGKILLed mid-load; every
acked entry reads back byte-equal through the shared port at once, the
parent respawns the sibling, and SIGTERM stops the fleet.  Also the
fleet's gates: SO_REUSEPORT, the process-tree root, the meta cache and
the native read plane of a sibling without the meta plane, the
`SEAWEEDFS_TPU_FILER_WORKERS` default and the refusals that stay.  Each
test carries its own deadline.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import HttpServer, http_bytes, \
    http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from test_torch_profiling import stop_background_probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PULSE = 0.2


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """An in-process port master and volume server for the fleets."""
    tmp = tmp_path_factory.mktemp("torch_workers")
    master = MasterServer(volume_size_limit_mb=64,
                          pulse_seconds=PULSE).start()
    vs = VolumeServer([str(tmp / "v0")], device="cpu", master=master.url,
                      pulse_seconds=PULSE, max_volume_count=16).start()
    deadline = time.monotonic() + 15
    while not http_json("GET", f"{master.url}/cluster/status")["dataNodes"]:
        assert time.monotonic() < deadline, "the volume server registered"
        time.sleep(0.05)
    try:
        yield master.url
    finally:
        vs.stop()
        master.stop()
        stop_background_probes()


def _children_of(pid: int) -> "list[int]":
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", "rb") as f:
                parts = f.read().rsplit(b") ", 1)[1].split()
            if int(parts[1]) == pid and parts[0] != b"Z":
                out.append(int(d))
        except (OSError, IndexError, ValueError):
            continue
    return sorted(out)


class Fleet:
    """`python -m seaweedfs_tpu_torch filer ...` as a subprocess: its
    output collected, its url from the listening line."""

    def __init__(self, args: "list[str]", env: "dict | None" = None,
                 deadline: float = 60.0):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))
        self.lines: "list[str]" = []
        self.url = ""
        self._listening = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()
        assert self._listening.wait(deadline), \
            f"no listening line: {''.join(self.lines)[-2000:]}"

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line)
            if "listening on" in line and not self.url:
                self.url = line.strip().rsplit(" ", 1)[1]
                self._listening.set()
        self._listening.set()

    def siblings(self, n: int, deadline: float) -> "list[int]":
        """Poll (never a fixed sleep) until the parent has `n` live
        children that answer on the shared port's process tree."""
        end = time.monotonic() + deadline
        while True:
            kids = _children_of(self.proc.pid)
            if len(kids) >= n and self.tree_procs() >= n + 1:
                return kids
            assert time.monotonic() < end, \
                f"siblings {kids}: {''.join(self.lines)[-2000:]}"
            time.sleep(0.1)

    def tree_procs(self) -> float:
        try:
            st, body, _ = http_bytes("GET", f"{self.url}/metrics",
                                     timeout=10)
        except OSError:
            return 0.0
        for line in body.decode().splitlines():
            if line.startswith("seaweedfs_tpu_process_tree_procs "):
                return float(line.split()[1])
        return 0.0

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


@pytest.mark.parametrize("front", ["threaded", "async"])
def test_sibling_sigkill_keeps_every_acked_entry_and_respawns(
        cluster, tmp_path, front):
    test_deadline = time.monotonic() + 120
    env = {"SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS": "500"}
    if front == "async":
        env["SEAWEEDFS_TPU_ASYNC_FRONT"] = "filer"
    fleet = Fleet(["filer", "-port", "0", "-master", cluster, "-store",
                   str(tmp_path / "filer.db"), "-workers", "2"], env)
    try:
        kids = fleet.siblings(1, deadline=60)
        assert any("pre-forked 1 sibling workers" in line
                   for line in fleet.lines)
        acked: "dict[str, bytes]" = {}
        stop = threading.Event()
        lock = threading.Lock()

        def writer(w: int) -> None:
            i = 0
            while not stop.is_set():
                path = f"/wk/{w}/{i}"
                blob = (f"{w}-{i}-".encode() * 200)[:1024 if i % 2
                                                    else 65536]
                try:
                    st, _, _ = http_bytes(
                        "POST", f"{fleet.url}{path}", blob,
                        {"Content-Type": "application/octet-stream"},
                        timeout=10)
                except OSError:
                    st = 0
                if st == 201:
                    with lock:
                        acked[path] = blob
                i += 1

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.0)                         # load on both processes
        os.kill(kids[0], signal.SIGKILL)        # the sibling, mid-load
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert acked, "no write was acked before the kill"
        missing = []
        for path, blob in acked.items():
            st, body, _ = http_bytes("GET", f"{fleet.url}{path}",
                                     timeout=10)
            if st != 200 or body != blob:
                missing.append((path, st))
        assert not missing, f"acked entries lost: {missing[:5]}"
        # the monitor respawns the sibling (a new pid on the port)
        while True:
            now = _children_of(fleet.proc.pid)
            if now and kids[0] not in now:
                break
            assert time.monotonic() < test_deadline, "no respawn"
            time.sleep(0.2)
        assert any(f"pid={kids[0]} exited" in line for line in fleet.lines)
        respawned = fleet.siblings(1, deadline=60)
        assert kids[0] not in respawned
    finally:
        rc = fleet.stop()
    assert rc == 0
    time.sleep(0.2)
    assert not _children_of(fleet.proc.pid)


def _fleet_siblings(port: int) -> "list[int]":
    """Live `-workers 0` processes serving `port`, whoever their
    parent now is."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            with open(f"/proc/{d}/stat", "rb") as f:
                state = f.read().rsplit(b") ", 1)[1].split()[0]
        except (OSError, IndexError):
            continue
        if (b"seaweedfs_tpu_torch" in argv and b"-workers" in argv
                and argv[argv.index(b"-workers") + 1] == b"0"
                and str(port).encode() in argv and state != b"Z"):
            out.append(int(d))
    return out


def test_sigterm_right_after_a_siblings_death_leaves_no_process(
        cluster, tmp_path):
    """A sibling dies and the parent is stopped before (or while) the
    monitor respawns it: the parent starts no sibling it does not stop,
    so when it exits no process of the fleet is left on the port."""
    test_deadline = time.monotonic() + 120
    fleet = Fleet(["filer", "-port", "0", "-master", cluster, "-store",
                   str(tmp_path / "filer.db"), "-workers", "3"])
    port = int(fleet.url.rsplit(":", 1)[1])
    try:
        kids = fleet.siblings(2, deadline=60)
        os.kill(kids[0], signal.SIGKILL)
        # the monitor looks every 2 s: stop the parent inside that window
        time.sleep(1.9)
    finally:
        rc = fleet.stop()
    assert rc == 0
    while _fleet_siblings(port):
        assert time.monotonic() < test_deadline, \
            f"left running: {_fleet_siblings(port)}"
        time.sleep(0.2)
    # and nothing comes back after the orphan watch's period
    time.sleep(2.5)
    assert not _fleet_siblings(port)


def test_a_sibling_whose_parent_is_gone_exits(cluster, tmp_path):
    """A sibling started after its parent died (a respawn racing the
    parent's end) is re-parented at once: its orphan watch is rooted at
    the pid the parent exported, not at whatever parent it finds, so it
    exits instead of serving on."""
    gone = subprocess.Popen(["true"])
    gone.wait()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "filer", "-port",
         "0", "-master", cluster, "-store", str(tmp_path / "filer.db"),
         "-workers", "0"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env=dict(os.environ, PYTHONPATH=REPO,
                 SEAWEEDFS_TPU_TREE_ROOT=str(gone.pid)))
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("the orphaned sibling kept serving")
    assert rc == 0


def test_the_workers_default_comes_from_the_environment(cluster,
                                                        tmp_path):
    """SEAWEEDFS_TPU_FILER_WORKERS=2 pre-forks without the flag; any
    process's /metrics reports the whole fleet's tree (the parent's pid
    as SEAWEEDFS_TPU_TREE_ROOT)."""
    fleet = Fleet(["filer", "-port", "0", "-master", cluster, "-store",
                   str(tmp_path / "filer.db")],
                  {"SEAWEEDFS_TPU_FILER_WORKERS": "2"})
    try:
        fleet.siblings(1, deadline=60)
        # each scrape lands on one process or the other; all see 2+
        for _ in range(6):
            assert fleet.tree_procs() >= 2
        st, _, _ = http_bytes("PUT", f"{fleet.url}/env/x", b"x" * 100,
                              timeout=10)
        assert st == 201
    finally:
        assert fleet.stop() == 0


def test_a_non_sqlite_store_is_still_refused(cluster, tmp_path):
    """A fleet over a store other than sqlite: as the JAX filer does, the
    filer warns and runs one process (no sibling forked) over the lsm
    store, with its meta plane."""
    fleet = Fleet(["filer", "-port", "0", "-master", cluster, "-storeType",
                   "lsm", "-store", str(tmp_path / "ldb"), "-workers", "4"],
                  {})
    try:
        st, _, _ = http_bytes("PUT", f"{fleet.url}/lsm/x", b"x" * 100,
                              timeout=10)
        assert st == 201
        assert http_bytes("GET", f"{fleet.url}/lsm/x")[1] == b"x" * 100
        time.sleep(0.5)                   # a sibling would be forked now
        assert _children_of(fleet.proc.pid) == []
        assert fleet.tree_procs() == 1
    finally:
        assert fleet.stop() == 0
    out = "".join(fleet.lines)
    assert "running 1 process" in out and "pre-forked" not in out
    assert os.path.isfile(str(tmp_path / "ldb" / "wal.log"))


def test_reuse_port_lets_two_listeners_share_a_port():
    a = HttpServer(reuse_port=True)
    b = HttpServer(port=a.port, reuse_port=True)
    try:
        assert a.port == b.port
    finally:
        a.stop()
        b.stop()
    with pytest.raises(OSError):
        c = HttpServer()
        try:
            HttpServer(port=c.port)
        finally:
            c.stop()


@pytest.mark.parametrize("meta_plane", ["0", ""])
def test_a_siblings_gates_follow_the_meta_plane(tmp_path, monkeypatch,
                                                meta_plane):
    """In a fleet without the meta plane the meta cache is off and the
    native read plane does not start (no event channel covers the
    siblings' writes); with the plane both run, as the JAX filer's."""
    if meta_plane:
        monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE", meta_plane)
    fs = FilerServer("127.0.0.1:1", store_path=str(tmp_path / "f.db"),
                     reuse_port=True)
    try:
        plane_on = fs.filer.meta_plane is not None
        assert plane_on == (meta_plane != "0")
        assert (fs.filer.meta_cache is not None) == plane_on
        if not plane_on:
            assert fs.native_read is None
    finally:
        fs.stop()
        stop_background_probes()


def test_c11_a_siblings_create_refuses_a_racing_fresh_directory(tmp_path):
    """C11: a fleet sibling found a directory absent, then, before it
    recorded the directory as fresh (provably empty but for what it
    sees), ingested another sibling's create of it and of a file in it.
    Those invalidations found no record to poison, so the record made
    after them would have answered the file as absent once the overlay
    let it go.  A sibling's event since the token refuses the record."""
    from seaweedfs_tpu_torch.filer.meta_cache import FilerMetaCache
    from seaweedfs_tpu_torch.filer.meta_log import MetaLog
    mc = FilerMetaCache(MetaLog(str(tmp_path / "log")), 1000,
                        watermark=False)
    tok = mc.fresh_token()                      # the store said: absent
    mc.invalidate("/d", foreign=True)           # the sibling's mkdir
    mc.invalidate("/d/f", foreign=True)         # and its file
    mc.mark_fresh_dir("/d", tok)
    assert not mc.known_absent("/d/f")
    assert not mc.known_absent("/d/g")          # no record: SELECTs
    # the process's own events leave the record as before
    tok = mc.fresh_token()
    mc.invalidate("/e", keep_fresh=True)
    mc.mark_fresh_dir("/e", tok)
    mc.invalidate("/e/f")
    assert not mc.known_absent("/e/f")
    assert mc.known_absent("/e/g")
