"""The port's native filer meta plane (`native/meta_plane.cc`,
`server/meta_plane_native.py`) against the JAX package's.

- WAL lines: a log of mixed native and Python appends, every line
  byte-equal to what the JAX `MetaLog.append_raw` writes for the same
  event, and the log replayed through each package's boot giving the
  same sqlite rows and the bytes that were written;
- a SIGKILL of the filer while the plane acks: every acked create reads
  back equal after a restart with the plane off, an unacked one is
  absent or whole, and the JAX package's boot of the same log gives the
  same rows;
- the 404 fallback and the runtime lever: the same requests to the
  port's filer and to the JAX filer get the same answers;
- a dry fid pool leaves the name retryable, in both packages.

Bodies are made from numpy seeds.  The port's cluster runs in this
process (a master and a volume server with their native planes, the
codec on the CPU); the SIGKILL case runs the filer as a subprocess.
Skips where g++ cannot build the plane.
"""

import json
import os
import re
import shutil
import signal
import sqlite3
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.filer.filer import Filer as RefFiler
from seaweedfs_tpu.filer.filer_store import SqliteStore as RefSqliteStore
from seaweedfs_tpu.filer.meta_log import MetaLog as RefMetaLog
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.server.meta_plane_native import \
    NativeMetaPlane as RefNativeMetaPlane
from seaweedfs_tpu_torch import native, operation
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filer_store import SqliteStore
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.meta_plane_native import NativeMetaPlane

from test_torch_write_path import Cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCTET = {"Content-Type": "application/octet-stream"}

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="needs g++ to build the plane")

# the append_raw framing: the length of newEntry first, newEntry LAST
_LINE_RE = re.compile(
    rb'^\{"nl":(\d+),"wid":"([^"]+)","op":"([a-z]+)","tsNs":(\d+),'
    rb'"oldEntry":')


@pytest.fixture(autouse=True)
def _planes_on(monkeypatch):
    for k in ("SEAWEEDFS_TPU_FILER_META_PLANE",
              "SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE",
              "SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE", "1")


def _blob(seed: int, n: int = 1024) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _native_post(addr: str, path: str, blob: bytes, tries: int = 60) -> int:
    """POST to the plane, retrying its 404 fallback while the plane
    learns the parent directory and the feeder fills its fid pool."""
    st = 0
    for _ in range(tries):
        st = http_bytes("POST", f"{addr}{path}", blob, OCTET, timeout=10)[0]
        if st == 201:
            return st
        time.sleep(0.05)
    return st


def _wal_lines(log_dir: str) -> list:
    out = []
    for root, _dirs, files in sorted(os.walk(log_dir)):
        for name in sorted(files):
            if name.endswith(".log"):
                with open(os.path.join(root, name), "rb") as f:
                    out.extend(ln for ln in f.read().split(b"\n") if ln)
    return out


def _jax_append_raw(tmp: str, line: bytes) -> bytes:
    """The line the JAX `MetaLog.append_raw` writes for the event that
    `line` carries (same writer id, same stamp, same entry bytes)."""
    m = _LINE_RE.match(line)
    assert m, f"line framing mismatch: {line[:80]!r}"
    nl, wid, op, ts = int(m[1]), m[2].decode(), m[3].decode(), int(m[4])
    text = line.decode()
    raw_new = text[-(nl + 1):-1]
    raw_old = text[m.end():len(text) - nl - len(',"newEntry":') - 1]
    new = json.loads(raw_new)
    old = json.loads(raw_old)
    d = os.path.join(tmp, f"jax-{ts}")
    log = RefMetaLog(d)
    log.wid = wid

    def stamp(event, _ts=ts):
        event["tsNs"] = _ts
        return _ts
    log._stamp_locked = stamp
    log.append_raw(op, new, old, raw_new if new is not None else None,
                   raw_old if old is not None else None)
    log.close()
    (got,) = _wal_lines(d)
    return got


def _rows(db: str) -> list:
    con = sqlite3.connect(db)
    try:
        rows = con.execute("SELECT directory, name, meta FROM filemeta "
                           "ORDER BY directory, name").fetchall()
    finally:
        con.close()
    out = []
    for d, n, meta in rows:
        m = json.loads(meta)
        m["attributes"].pop("mtime", None)
        m["attributes"].pop("crtime", None)
        out.append((d, n, m))
    return out


def _copy(db: str, dst: str) -> str:
    os.makedirs(dst)
    out = os.path.join(dst, "filer.db")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            shutil.copy(db + suffix, out + suffix)
    shutil.copytree(db + ".metalog", out + ".metalog")
    return out


def _boot_sync(cls_filer, cls_store, db: str, monkeypatch) -> list:
    """Boot a filer with the kill switch on over `db` (its recover_sync
    applies the tail), close it, and return the rows."""
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE", "0")
    f = cls_filer("127.0.0.1:1", cls_store(db), meta_log_dir=db + ".metalog")
    assert f.meta_plane is None
    f.close()
    monkeypatch.delenv("SEAWEEDFS_TPU_FILER_META_PLANE")
    return _rows(db)


def test_wal_lines_are_the_jax_framing_and_replay_to_one_store(
        tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS", "600000")
    c = Cluster(tmp_path, "port", racks=("r1",))
    db = str(tmp_path / "filer.db")
    fs = FilerServer(c.url, store_path=db).start()
    blobs = {}
    try:
        assert fs.native_meta is not None, native.BUILD_INFO
        u = fs.url
        plane = f"127.0.0.1:{http_json('GET', f'{u}/status')['metaPlanePort']}"
        blobs["/mix/a/seed"] = _blob(1)
        assert http_bytes("POST", f"{u}/mix/a/seed", blobs["/mix/a/seed"],
                          OCTET)[0] == 201
        for i in range(10):
            nb, pb = _blob(100 + i), _blob(200 + i, 700 + i)
            assert _native_post(plane, f"/mix/a/n{i}", nb) == 201
            assert http_bytes("POST", f"{u}/mix/a/p{i}", pb,
                              OCTET)[0] == 201
            blobs[f"/mix/a/n{i}"], blobs[f"/mix/a/p{i}"] = nb, pb
        # an existing name is Python's: the plane falls back
        st, body, _ = http_bytes("POST", f"{plane}/mix/a/seed", b"dup",
                                 OCTET)
        assert (st, body) == (404, b'{"error":"meta plane fallback"}')
        # every entry reads back through the stalled filer (overlay)
        for path, blob in blobs.items():
            assert http_bytes("GET", f"{u}{path}")[1] == blob, path
        assert fs.native_meta.requests() >= 10
        # SIGKILL's twin: the planes and the applier stop, no final apply
        fs.native_meta.stop()
        fs.native_read.stop()
        fs.http.stop()
        mp = fs.filer.meta_plane
        mp._stop.set()
        mp._thread.join(timeout=10)
        fs.filer.store.close()
        lines = _wal_lines(db + ".metalog")
        wids = {}
        for line in lines:
            assert line == _jax_append_raw(str(tmp_path), line), line[:80]
            m = _LINE_RE.match(line)
            wids.setdefault(m[2], []).append(int(m[4]))
        assert len(wids) == 2, "expected a native and a Python writer"
        for stamps in wids.values():
            assert stamps == sorted(set(stamps))
        jax_db = _copy(db, str(tmp_path / "jax"))
        port_rows = _boot_sync(Filer, SqliteStore, db, monkeypatch)
        jax_rows = _boot_sync(RefFiler, RefSqliteStore, jax_db, monkeypatch)
        assert port_rows == jax_rows
        by_path = {(d.rstrip("/") + "/" + n): m for d, n, m in port_rows}
        for path, blob in blobs.items():
            (chunk,) = by_path[path]["chunks"]
            assert operation.read(c.url, chunk["fileId"]) == blob, path
    finally:
        fs.stop()
        c.close()


def _start_filer(args, env):
    p = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "filer"] + args,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=env)
    line = p.stdout.readline()
    assert line.startswith("filer listening on "), line
    return p, line.split()[-1]


def test_acked_native_creates_survive_a_sigkill(tmp_path, monkeypatch):
    c = Cluster(tmp_path, "port", racks=("r1",))
    db = str(tmp_path / "filer.db")
    args = ["-port", "0", "-master", c.url, "-store", db]
    env = {**os.environ, "SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS": "600000"}
    p, u = _start_filer(args, env)
    acked, attempted = {}, {}
    lock = threading.Lock()
    try:
        assert http_bytes("POST", f"{u}/nk/seed", _blob(2), OCTET)[0] == 201
        port = http_json("GET", f"{u}/status")["metaPlanePort"]
        assert port, "the native meta plane did not arm"
        plane = f"127.0.0.1:{port}"
        assert _native_post(plane, "/nk/warm", _blob(3)) == 201
        acked["/nk/warm"] = _blob(3)
        stop = threading.Event()

        def writer(w):
            i = 0
            while not stop.is_set():
                path, blob = f"/nk/w{w}-{i}", _blob(1000 * w + i)
                with lock:
                    attempted[path] = blob
                try:
                    st = http_bytes("POST", f"{plane}{path}", blob, OCTET,
                                    timeout=10)[0]
                except OSError:
                    st = 0
                if st == 201:
                    with lock:
                        acked[path] = blob
                i += 1

        ts = [threading.Thread(target=writer, args=(w,)) for w in range(3)]
        for t in ts:
            t.start()
        time.sleep(1.0)
        p.send_signal(signal.SIGKILL)       # mid-load
        p.wait(10)
        time.sleep(0.2)
        stop.set()
        for t in ts:
            t.join(30)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(10)
    try:
        assert len(acked) > 5, "too few native acks before the kill"
        jax_db = _copy(db, str(tmp_path / "jax"))
        env["SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE"] = "0"
        env.pop("SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS")
        p, u = _start_filer(args, env)
        try:
            assert http_json("GET", f"{u}/status")["metaPlanePort"] == 0
            for path, blob in acked.items():
                st, body, _ = http_bytes("GET", f"{u}{path}")
                assert (st, body == blob) == (200, True), path
            for path, blob in attempted.items():
                st, body, _ = http_bytes("GET", f"{u}{path}")
                assert st == 404 or (st, body) == (200, blob), path
            assert http_bytes("POST", f"{u}/nk/after", b"x", OCTET)[0] == 201
        finally:
            p.send_signal(signal.SIGTERM)
            assert p.wait(30) == 0
        port_rows = [r for r in _rows(db) if r[1] != "after"]
        assert port_rows == _boot_sync(RefFiler, RefSqliteStore, jax_db,
                                       monkeypatch)
    finally:
        c.close()


def _fallback_transcript(fs_url: str, filer, master_url: str) -> list:
    """The fallback contract and the /debug/meta_plane lever, as seen by
    a client: unknown parents fall back and stay absent, a learned parent
    is accepted, a disarmed plane falls back while the Python port
    serves, a re-armed plane accepts again."""
    out = []
    plane = f"127.0.0.1:{http_json('GET', f'{fs_url}/status')['metaPlanePort']}"
    out.append(http_bytes("POST", f"{plane}/fb/x", b"zz", OCTET)[:2])
    out.append(http_bytes("GET", f"{fs_url}/fb/x")[0])
    out.append(http_bytes("POST", f"{fs_url}/fb/seed", b"seed", OCTET)[0])
    out.append(_native_post(plane, "/fb/y", _blob(5)))
    doc = http_json("POST", f"{fs_url}/debug/meta_plane", {"native": "off"})
    out.append(doc["armed"])
    out.append(http_bytes("POST", f"{plane}/fb/z", _blob(6), OCTET)[:2])
    out.append(http_json("GET", f"{fs_url}/status")["metaPlanePort"])
    out.append(http_bytes("POST", f"{fs_url}/fb/z", _blob(7), OCTET)[0])
    out.append(http_json("POST", f"{fs_url}/debug/meta_plane",
                         {"native": "on"})["armed"])
    out.append(_native_post(plane, "/fb/w", _blob(8)))
    for path, seed in (("/fb/y", 5), ("/fb/z", 7), ("/fb/w", 8)):
        st, body, _ = http_bytes("GET", f"{fs_url}{path}")
        out.append((path, st, body == _blob(seed)))
    return out


def test_fallback_and_runtime_disarm_answer_as_the_jax_plane(tmp_path):
    got = {}
    for kind in ("port", "ref"):
        (tmp_path / kind).mkdir()
        c = Cluster(tmp_path / kind, kind, racks=("r1",))
        cls = FilerServer if kind == "port" else RefFilerServer
        fs = cls(c.url, store_path=str(tmp_path / kind / "filer.db")).start()
        try:
            if kind == "ref" and fs.native_meta is None:
                pytest.skip("the JAX native meta plane did not build")
            got[kind] = _fallback_transcript(fs.url, fs.filer, c.url)
        finally:
            fs.stop()
            c.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] == (404, b'{"error":"meta plane fallback"}')
    assert got["port"][3] == 201 and got["port"][6] == 0


def test_a_dry_fid_pool_leaves_the_name_retryable(tmp_path):
    """With no fid in the pool the plane falls back as a fid miss and
    claims nothing: the same name on the plane stays a fid miss, not
    an ineligible name, and a fid arriving stops the misses."""
    got = {}
    for kind, cls in (("port", NativeMetaPlane), ("ref", RefNativeMetaPlane)):
        d = tmp_path / kind
        d.mkdir()
        try:
            plane = cls(str(d), "127.0.0.1:1")
        except RuntimeError:
            pytest.skip(f"the {kind} native meta plane did not build")
        out = []
        try:
            plane.arm(True)
            plane.mark_dir("/rd")
            url = f"127.0.0.1:{plane.port}"
            for _ in range(3):       # master unreachable: the pool stays dry
                out.append(http_bytes("POST", f"{url}/rd/x", b"zz",
                                      OCTET)[:2])
                out.append(plane.stats()["fid_misses"])
            plane._lib.mp_feed_fids(plane._h, b"127.0.0.1:1 3,01637037d6\n")
            # the upstream is unreachable, so the request falls back at
            # the dispatch hop, but not as a fid miss
            out.append(http_bytes("POST", f"{url}/rd/x", b"zz", OCTET)[:2])
            out.append(plane.stats()["fid_misses"])
        finally:
            plane.stop()
        got[kind] = out
    assert got["port"] == got["ref"]
    assert got["port"][1::2] == [1, 2, 3, 3]


def test_a_native_create_is_not_hidden_by_a_cached_absence_or_listing(
        tmp_path, monkeypatch):
    """A create the native plane acked reaches the Python filer only
    through the meta plane's log follower: a negative lookup and a
    listing the filer cached before it (the applier stalled, so the store
    cannot be the channel) must not hide it."""
    monkeypatch.setenv("SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS", "600000")
    c = Cluster(tmp_path, "port", racks=("r1",))
    fs = FilerServer(c.url, store_path=str(tmp_path / "filer.db")).start()
    try:
        assert fs.native_meta is not None, native.BUILD_INFO
        u = fs.url
        plane = f"127.0.0.1:{http_json('GET', f'{u}/status')['metaPlanePort']}"
        assert http_bytes("POST", f"{u}/neg/seed", _blob(20), OCTET)[0] == 201
        assert _native_post(plane, "/neg/warm", _blob(21)) == 201
        for i in range(8):
            path = f"/neg/n{i}"
            assert http_bytes("GET", f"{u}{path}")[0] == 404  # cached None
            before = http_json("GET", f"{u}/neg/")["entries"]  # cached
            assert _native_post(plane, path, _blob(30 + i), tries=1) == 201
            st, body, _ = http_bytes("GET", f"{u}{path}")
            assert (st, body == _blob(30 + i)) == (200, True), path
            after = [e["fullPath"] for e in
                     http_json("GET", f"{u}/neg/")["entries"]]
            assert after == sorted([e["fullPath"] for e in before] + [path])
        assert fs.filer.store.find_entry("/neg/n0") is None  # not applied
    finally:
        fs.stop()
        c.close()
