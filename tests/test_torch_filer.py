"""The port's filer on the CPU, against the JAX package's filer as it runs
with its meta plane off (`SEAWEEDFS_TPU_FILER_META_PLANE=0`), no native
planes, one process.  Tolerance: exact equality of bytes, JSON bodies,
status codes and headers; only fids, `mtime`/`crtime` and `tsNs` are
masked where the two clusters mint their own.  Inputs are seeded with
numpy.

- stores: the store contract over the port's MemoryStore and
  SqliteStore, with the JAX stores' listings; the SQL each dialect
  renders; a `filer.db` (and its `.metalog`) written by either
  package's filer opens in the other's with the same entries and events;
- chunk views: seeded chunk layouts resolve to the same visible
  intervals and views;
- the metalog both ways: segments, watermarks and `append_raw` lines of
  one package read by the other; a tail that a JAX filer with its meta
  plane on left past its checkpoint replayed by the port's boot;
- the meta cache: the fill fence loses to a racing invalidation, a
  sibling's watermark voids older fills, negative entries answer as
  the JAX cache does, and two filers over one store (of either package)
  read each other's writes at once;
- HTTP: the same requests to a port filer over a port cluster and to a
  JAX filer over a JAX cluster give the same answers;
- the clients crosswise, the `fs.*` shell commands against both filers;
- EC: files in an encoded collection read back through the filer,
  direct and with a shard holder stopped, without calling the kernel;
- the command line: `filer` serves `/status` with its native planes'
  ports, refuses what is not ported; `shell -filer ... "fs.ls /d"`
  prints what the JAX shell does.

The meta plane (the JAX filer's default) is held against the JAX package
in tests/test_torch_meta_plane.py, and the native planes in
tests/test_torch_native_meta_plane.py and
tests/test_torch_filer_read_plane.py.

Files of 1 KiB - 9 MiB, volume limits of 4-64 MiB.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.parse

import numpy as np
import pytest

from seaweedfs_tpu import operation as ref_operation
from seaweedfs_tpu.filer import abstract_sql as ref_sql
from seaweedfs_tpu.filer import filechunks as ref_filechunks
from seaweedfs_tpu.filer import meta_plane as ref_meta_plane
from seaweedfs_tpu.filer.client import FilerClient as RefFilerClient
from seaweedfs_tpu.filer.entry import Attributes as RefAttributes
from seaweedfs_tpu.filer.entry import Entry as RefEntry
from seaweedfs_tpu.filer.entry import FileChunk as RefChunk
from seaweedfs_tpu.filer.filer import Filer as RefFiler
from seaweedfs_tpu.filer.filer_store import MemoryStore as RefMemoryStore
from seaweedfs_tpu.filer.filer_store import SqliteStore as RefSqliteStore
from seaweedfs_tpu.filer.meta_cache import _MISS as REF_MISS
from seaweedfs_tpu.filer.meta_cache import FilerMetaCache as RefMetaCache
from seaweedfs_tpu.filer.meta_log import MetaLog as RefMetaLog
from seaweedfs_tpu.filer.meta_log import \
    alloc_writer_identity as ref_alloc_writer_identity
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu_torch import operation, stats
from seaweedfs_tpu_torch.filer import abstract_sql, filechunks, meta_plane
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.filer.entry import Attributes, Entry, FileChunk
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filer_store import MemoryStore, SqliteStore
from seaweedfs_tpu_torch.filer.meta_cache import _MISS, FilerMetaCache
from seaweedfs_tpu_torch.filer.meta_log import MetaLog, alloc_writer_identity
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.shell import CommandEnv, run_command

from test_torch_write_path import Cluster, _wait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASTER = "127.0.0.1:1"           # never dialed: metadata-only filers
MASKED = ("fileId", "mtime", "crtime", "tsNs")

PORT = {"Entry": Entry, "Chunk": FileChunk, "Attributes": Attributes,
        "Filer": Filer, "MemoryStore": MemoryStore,
        "SqliteStore": SqliteStore, "MetaLog": MetaLog,
        "MetaCache": FilerMetaCache, "MISS": _MISS,
        "filechunks": filechunks, "sql": abstract_sql}
JAX = {"Entry": RefEntry, "Chunk": RefChunk, "Attributes": RefAttributes,
       "Filer": RefFiler, "MemoryStore": RefMemoryStore,
       "SqliteStore": RefSqliteStore, "MetaLog": RefMetaLog,
       "MetaCache": RefMetaCache, "MISS": REF_MISS,
       "filechunks": ref_filechunks, "sql": ref_sql}
PKG = {"port": PORT, "jax": JAX}


@pytest.fixture
def sync_commit(monkeypatch):
    """The JAX filer's configuration under test: its meta plane off."""
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE", "0")


def _mask(obj):
    """The JSON with the values clusters mint (fids, clocks) masked."""
    if isinstance(obj, dict):
        return {k: ("*" if k in MASKED else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


# --- stores ----------------------------------------------------------------

def _contract(store, pkg) -> list:
    """tests/test_filer.py's `_exercise_store` shape as a transcript."""
    E = pkg["Entry"]
    out = []
    root = store.find_entry("/")
    out.append(root is not None and root.is_directory)
    store.insert_entry(E("/dir/sub", is_directory=True))
    store.insert_entry(E("/dir/sub/deep.txt"))
    store.delete_folder_children("/dir")
    out.append(store.find_entry("/dir/sub/deep.txt"))
    for name in ("b", "a", "c", "ab", "a%", "a_b", "a\\c"):
        store.insert_entry(E(f"/dir/{name}"))
    out.append(store.find_entry("/dir/a").name)
    out.append(store.find_entry("/dir/zz"))
    for kw in ({}, {"prefix": "a"}, {"prefix": "a%"}, {"prefix": "a_"},
               {"prefix": "a\\"}, {"start_file": "ab"},
               {"start_file": "ab", "include_start": True},
               {"limit": 2}, {"start_file": "a", "prefix": "a", "limit": 3}):
        out.append([e.name for e in store.list_directory_entries(
            "/dir", **kw)])
    store.delete_entry("/dir/a")
    out.append(store.find_entry("/dir/a"))
    store.delete_folder_children("/dir")
    out.append(store.list_directory_entries("/dir"))
    return out


STORES = {"memory": lambda pkg, d: pkg["MemoryStore"](),
          "sqlite_memory": lambda pkg, d: pkg["SqliteStore"](":memory:"),
          "sqlite_file": lambda pkg, d: pkg["SqliteStore"](
              str(d / "filer.db"))}


@pytest.mark.parametrize("kind", sorted(STORES))
def test_store_contract_matches_the_jax_store(kind, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _contract(STORES[kind](PORT, tmp_path / "port"), PORT)
    ref = _contract(STORES[kind](JAX, tmp_path / "jax"), JAX)
    assert port == ref
    assert port[0] is True and port[-1] == []


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_namespace_lists_alike(seed, tmp_path):
    """A seeded namespace (names with LIKE wildcards and escapes) in the
    port's sqlite store and the JAX one: every listing, page and prefix
    query gives the same entries, byte for byte."""
    rng = np.random.default_rng(seed)
    alphabet = list("ab_%\\.x")
    names = sorted({"".join(rng.choice(alphabet, rng.integers(1, 5)))
                    for _ in range(120)})
    stores = {"port": SqliteStore(str(tmp_path / "p.db")),
              "jax": RefSqliteStore(str(tmp_path / "j.db"))}
    for name in names:
        d = f"/d{int(rng.integers(0, 3))}"
        attrs = {"mtime": 1.5, "crtime": 1.25, "mode": int(rng.integers(
            0, 0o777)), "mime": "text/plain"}
        chunks = [{"fileId": f"{int(rng.integers(1, 9))},0{i}abcdef01",
                   "offset": i * 4, "size": 4, "eTag": "e",
                   "mtime": int(rng.integers(1, 1 << 40))}
                  for i in range(int(rng.integers(0, 3)))]
        for kind, pkg in PKG.items():
            stores[kind].insert_entry(pkg["Entry"].from_json(
                {"fullPath": f"{d}/{name}", "attributes": attrs,
                 "chunks": chunks, "extended": {"k": name}}))
    queries = [{}] + [{"prefix": p} for p in ("a", "%", "_", "\\", "x.")] + \
        [{"start_file": s, "limit": int(rng.integers(1, 9)),
          "include_start": bool(rng.integers(2))}
         for s in rng.choice(names, 8)]
    for d in ("/d0", "/d1", "/d2", "/nope"):
        for q in queries:
            got = {k: [json.dumps(e.to_json()) for e in
                       s.list_directory_entries(d, **q)]
                   for k, s in stores.items()}
            assert got["port"] == got["jax"], (d, q)


@pytest.mark.parametrize("dialect", ["SqliteDialect", "MysqlDialect",
                                     "PostgresDialect"])
def test_dialect_sql_matches(dialect):
    port, ref = getattr(abstract_sql, dialect)(), getattr(ref_sql, dialect)()
    assert port.create_table_sql() == ref.create_table_sql()
    for fn in ("upsert_sql", "find_sql", "delete_sql", "delete_tree_sql"):
        assert getattr(port, fn)() == getattr(ref, fn)()
    for inc in (False, True):
        for pre in (False, True):
            assert port.list_sql(inc, pre) == ref.list_sql(inc, pre)
    if dialect != "SqliteDialect":
        with pytest.raises(NotImplementedError, match="client library"):
            port.connect()


def _build_namespace(f, pkg) -> None:
    """Metadata-only mutations through a Filer: creates with implicit
    parents, attributes, chunks, extended keys, an update, a rename of a
    directory, deletes plain and recursive."""
    E, C, A = pkg["Entry"], pkg["Chunk"], pkg["Attributes"]
    rng = np.random.default_rng(7)
    for i in range(12):
        chunks = [C(f"{i + 1},{j:02x}1234abcd", j * 100, 100, f"e{j}",
                    int(rng.integers(1, 1 << 40))) for j in range(i % 3)]
        f.create_entry(E(f"/top/d{i % 3}/f{i:02d}", chunks=chunks,
                         attributes=A(mime="application/x", mode=0o640,
                                      uid=i, gid=2),
                         extended={"i": str(i)}))
    f.create_entry(E("/top/empty", is_directory=True))
    f.update_attrs("/top/d0/f00", mode=0o600)
    f.rename("/top/d1", "/moved/d1")
    f.delete_entry("/top/d2/f05", delete_chunks=False)
    f.delete_entry("/top/d0", recursive=True, delete_chunks=False)


def _tree(f) -> list:
    out = []

    def walk(path):
        for e in f.list_directory(path, limit=10_000):
            out.append(json.dumps(e.to_json()))
            if e.is_directory:
                walk(e.full_path)
    walk("/")
    return out


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_filer_db_and_metalog_open_in_the_other_package(
        writer, reader, tmp_path, sync_commit):
    db = str(tmp_path / "filer.db")
    w = PKG[writer]
    f = w["Filer"](MASTER, w["SqliteStore"](db), meta_log_dir=db + ".metalog")
    _build_namespace(f, w)
    tree, events = _tree(f), f.events_since(0)
    f.close()
    r = PKG[reader]
    g = r["Filer"](MASTER, r["SqliteStore"](db), meta_log_dir=db + ".metalog")
    try:
        assert _tree(g) == tree
        assert len(tree) == 12
        assert g.events_since(0) == events
        assert [e["op"] for e in events].count("rename") == 5
        # the reader's own writes continue the writer's stamp clock
        g.create_entry(r["Entry"]("/after"))
        assert g.events_since(events[-1]["tsNs"])[0]["tsNs"] > \
            events[-1]["tsNs"]
    finally:
        g.close()


# --- chunk views -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_chunk_views_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        layout = [(f"{k},{k:04x}", int(rng.integers(0, 300)),
                   int(rng.integers(1, 90)), int(rng.integers(0, 4)))
                  for k in range(int(rng.integers(0, 9)))]
        off, size = int(rng.integers(0, 350)), int(rng.integers(0, 150))
        got = {}
        for kind, pkg in PKG.items():
            chunks = [pkg["Chunk"](fid, o, n, "", mt)
                      for fid, o, n, mt in layout]
            fc = pkg["filechunks"]
            got[kind] = (
                [vars(v) for v in
                 fc.non_overlapping_visible_intervals(chunks)],
                [vars(v) for v in fc.view_from_chunks(chunks, off, size)],
                fc.total_size(chunks))
        assert got["port"] == got["jax"], (layout, off, size)


# --- the metalog, both directions ------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_metalog_segments_and_watermarks_cross_packages(
        writer, reader, tmp_path):
    d = str(tmp_path / "log")
    r = PKG[reader]["MetaLog"](d)        # a sibling, open before the writes
    w = PKG[writer]["MetaLog"](d)
    assert r.foreign_watermark() == 0
    # stamps around a minute boundary: two segments
    base = 1_800_000_000 * 10**9 - 2 * 10**9
    for i in range(6):
        w.append({"op": "create", "tsNs": base + i * 10**9,
                  "newEntry": {"fullPath": f"/x/{i}"}, "oldEntry": None})
    w.append({"op": "delete", "tsNs": base,           # bumped past history
              "newEntry": None, "oldEntry": {"fullPath": "/x/0"}})
    days = sorted(os.listdir(d))
    segs = sorted(os.path.join(day, m) for day in days
                  if os.path.isdir(os.path.join(d, day))
                  for m in os.listdir(os.path.join(d, day)))
    assert segs == ["2027-01-15/07-59.log", "2027-01-15/08-00.log"]
    mine = w.events_since(0)
    assert [e["tsNs"] for e in mine] == \
        [base + i * 10**9 for i in range(6)] + [base + 5 * 10**9 + 1]
    assert r.events_since(0) == mine
    assert r.events_since(base + 2 * 10**9, limit=2) == mine[3:5]
    r._wm_listed = 0.0                  # past the 1 s listdir memo
    assert r.foreign_watermark() == w.last_ts()
    assert w.foreign_watermark() == 0
    # the reader's own appends continue after the writer's stamps, and
    # the writer sees them as a sibling
    r2 = PKG[reader]["MetaLog"](d)
    e = r2.append({"op": "create", "newEntry": {"fullPath": "/y"},
                   "oldEntry": None, "tsNs": base})
    assert e["tsNs"] == w.last_ts() + 1
    w._wm_listed = 0.0                  # past the 1 s listdir memo
    assert w.foreign_watermark() == e["tsNs"]
    for log in (r, w, r2):
        log.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_append_raw_lines_and_writer_identity(writer, tmp_path):
    """append_raw's WAL lines (with `nl` and `wid`) parse alike in the
    JAX meta plane's log cursor, and a minted writer identity's
    watermark file reads as 0 to a sibling of either package."""
    d = str(tmp_path / "log")
    log = PKG[writer]["MetaLog"](d)
    new = {"fullPath": "/a/é\"x", "isDirectory": False}
    raw = json.dumps(new, separators=(",", ":"))
    ev, pos = log.append_raw("create", new, None, raw, None)
    ev2, pos2 = log.append_raw("delete", None, new, None, raw)
    assert ev["newEntry"] == new and pos2 > pos
    log.close()
    cur = ref_meta_plane._Cursor(d, ref_meta_plane.LOG_START)
    got = cur.poll()
    cur.close()
    assert [(e["op"], e["newEntry"], e["oldEntry"], rn, wid == log.wid)
            for e, rn, _pos, wid in got] == \
        [("create", new, None, raw, True), ("delete", None, new, "null", True)]
    wid, path = (alloc_writer_identity if writer == "port" else
                 ref_alloc_writer_identity)(d)
    assert wid.startswith(f"{os.getpid()}-") and os.path.exists(path)
    for kind in ("port", "jax"):
        # the minted file reads as 0, not as a torn value (1 << 62)
        sib = PKG[kind]["MetaLog"](d)
        assert sib.foreign_watermark() == log.last_ts()
        sib.close()


def _abandon(f):
    """A JAX filer with its meta plane on, stopped as by SIGKILL: the
    plane's thread stops without its final apply."""
    f.meta_plane._stop.set()
    f.meta_plane._thread.join(timeout=10)
    f.store.close()


def test_port_boot_replays_a_jax_planed_tail(tmp_path, monkeypatch):
    db = str(tmp_path / "filer.db")
    monkeypatch.delenv("SEAWEEDFS_TPU_FILER_META_PLANE", raising=False)
    monkeypatch.setenv("SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS", "3600000")
    f = RefFiler(MASTER, RefSqliteStore(db), meta_log_dir=db + ".metalog")
    assert f.meta_plane is not None
    for i in range(12):
        f.create_entry(RefEntry(f"/t/k{i:02d}",
                                attributes=RefAttributes(uid=i)))
    f.delete_entry("/t/k03")
    assert f.store.find_entry("/t/k00") is None    # acked, not applied
    want = _tree(f)
    _abandon(f)
    monkeypatch.delenv("SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS")
    # the port's kill switch: recover_sync applies the tail before serving
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE", "0")
    g = Filer(MASTER, SqliteStore(db), meta_log_dir=db + ".metalog")
    try:
        assert g.store.find_entry("/t/k11") is not None
        assert g.store.find_entry("/t/k03") is None
        assert _tree(g) == want
        ckpt = meta_plane.read_checkpoint(db + ".metalog")
        assert ckpt is not None and ckpt[1] == g.meta_log.last_ts()
    finally:
        g.close()
    # a second boot has nothing left to replay
    log, store = MetaLog(db + ".metalog"), SqliteStore(db)
    assert meta_plane.recover_sync(log, store) == 0
    store.close()
    log.close()


def test_the_meta_plane_is_refused_not_downgraded(tmp_path, monkeypatch):
    """SEAWEEDFS_TPU_FILER_META_PLANE=1 runs the plane over a store file;
    over a store it cannot run on it is refused, never downgraded to the
    synchronous commit (the JAX filer downgrades without a word)."""
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE", "0")
    with pytest.raises(ValueError, match="meta plane needs"):
        Filer(MASTER, SqliteStore(":memory:"))
    with pytest.raises(ValueError, match="meta plane needs"):
        FilerServer(MASTER, store_path=":memory:")
    db = str(tmp_path / "f.db")
    fs = FilerServer(MASTER, store_path=db)
    try:
        assert fs.filer.meta_plane is not None
        fs.filer.create_entry(Entry("/mp/a"))
        assert fs.filer.find_entry("/mp/a") is not None
    finally:
        fs.stop()
    assert SqliteStore(db).find_entry("/mp/a") is not None


# --- the meta cache --------------------------------------------------------

@pytest.mark.parametrize("kind", ["port", "jax"])
def test_meta_cache_fence_and_sibling_watermark(kind, tmp_path):
    pkg = PKG[kind]
    d = str(tmp_path / "log")
    log = pkg["MetaLog"](d)
    mc = pkg["MetaCache"](log, 64, name=None)
    miss = pkg["MISS"]
    tok = mc.begin_fill()
    mc.invalidate("/a/b")                      # races the store read
    mc.fill_entry("/a/b", pkg["Entry"]("/a/b"), tok)
    assert mc.lookup_entry("/a/b") is miss
    tok = mc.begin_fill()
    mc.fill_list(("/a", "", False, 10, ""), [pkg["Entry"]("/a/b")], tok)
    mc.invalidate("/a/c")                      # a child drops the listing
    assert mc.lookup_list(("/a", "", False, 10, "")) is miss
    tok = mc.begin_fill()
    mc.fill_entry("/a/b", None, tok)           # a cached absence
    assert mc.lookup_entry("/a/b") is None
    # a sibling of the OTHER package commits: older fills are void
    other = JAX if kind == "port" else PORT
    sib = other["MetaLog"](d)
    sib.append({"op": "create", "newEntry": {"fullPath": "/s"}})
    log._wm_listed = 0.0                      # past the 1 s listdir memo
    tok = mc.begin_fill()
    mc.fill_entry("/a/b", pkg["Entry"]("/a/b"), tok)
    assert mc.lookup_entry("/a/b") is not miss
    sib.append({"op": "create", "newEntry": {"fullPath": "/s2"}})
    assert mc.lookup_entry("/a/b") is miss
    sib.close()
    log.close()


def test_negative_entries_skip_the_store_only_for_unseen_names(
        tmp_path, monkeypatch, sync_commit):
    """A directory this filer created fresh answers its never-created
    children absent without a store SELECT; a name it saw created,
    deleted or renamed goes to the store; a sibling's commit voids the
    record."""
    db = str(tmp_path / "filer.db")
    f = Filer(MASTER, SqliteStore(db), meta_log_dir=db + ".metalog")
    selects = []
    real = f.store.find_entry
    monkeypatch.setattr(f.store, "find_entry",
                        lambda p: (selects.append(p), real(p))[1])
    try:
        f.create_entry(Entry("/fresh/a"))
        f.create_entry(Entry("/fresh/b"))
        f.delete_entry("/fresh/b")
        f.rename("/fresh/a", "/fresh/c")
        selects.clear()
        for name, want in (("a", None), ("b", None), ("c", "/fresh/c"),
                           ("never", None)):
            got = f.find_entry(f"/fresh/{name}")
            assert (got.full_path if got else None) == want, name
        assert selects == ["/fresh/a", "/fresh/b", "/fresh/c"]
        sib = RefMetaLog(db + ".metalog")
        sib.append({"op": "create", "newEntry": {"fullPath": "/fresh/s"}})
        f.meta_log._wm_listed = 0.0     # past the 1 s listdir memo
        selects.clear()
        assert f.find_entry("/fresh/never2") is None
        assert selects == ["/fresh/never2"]
        sib.close()
    finally:
        f.close()


@pytest.mark.parametrize("trial", range(8))
def test_concurrent_creates_in_a_fresh_directory_stay_visible(
        tmp_path, trial):
    """Writers creating files at once in a directory none of them has
    seen: every acked file is found afterwards.  (The JAX filer loses
    some: its cache tracks a fresh directory from the create event,
    after the store insert, and a second create of the same directory
    resets what the first had seen.)"""
    import sys
    import threading
    db = str(tmp_path / "filer.db")
    f = Filer(MASTER, SqliteStore(db), meta_log_dir=db + ".metalog")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=f.create_entry,
                               args=(Entry(f"/fresh{trial}/n{i:03d}"),))
              for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    try:
        assert [i for i in range(12)
                if f.find_entry(f"/fresh{trial}/n{i:03d}") is None] == []
        assert len(f.list_directory(f"/fresh{trial}")) == 12
    finally:
        f.close()


@pytest.mark.parametrize("a,b", [("port", "port"), ("port", "jax"),
                                 ("jax", "port")])
def test_two_filers_over_one_store_read_each_other_at_once(
        a, b, tmp_path, sync_commit):
    """A write through filer A is fresh through filer B at once, B's
    cache warm with the old state (both over one sqlite file and its
    metalog dir)."""
    db = str(tmp_path / "filer.db")
    fa = PKG[a]["Filer"](MASTER, PKG[a]["SqliteStore"](db),
                         meta_log_dir=db + ".metalog")
    fb = PKG[b]["Filer"](MASTER, PKG[b]["SqliteStore"](db),
                         meta_log_dir=db + ".metalog")
    try:
        fa.create_entry(PKG[a]["Entry"]("/c/seed"))
        time.sleep(1.1)          # B's one-second listdir memo of siblings
        E = PKG[a]["Entry"]
        for i in range(5):
            assert fb.find_entry(f"/c/f{i}") is None           # warm miss
            before = [e.name for e in fb.list_directory("/c")]
            fa.create_entry(E(f"/c/f{i}",
                              attributes=PKG[a]["Attributes"](uid=i)))
            got = fb.find_entry(f"/c/f{i}")
            assert got is not None and got.attributes.uid == i
            assert [e.name for e in fb.list_directory("/c")] == \
                sorted(before + [f"f{i}"])
            fa.update_attrs(f"/c/f{i}", uid=100 + i)
            assert fb.find_entry(f"/c/f{i}").attributes.uid == 100 + i
        fa.delete_entry("/c/f0")
        assert fb.find_entry("/c/f0") is None
        assert fb.meta_cache is not None
    finally:
        fa.close()
        fb.close()


# --- HTTP answers across packages -------------------------------------------

@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """A port cluster with a port filer and a JAX cluster with a JAX filer
    (meta plane and native planes off), two volume servers each."""
    saved = {k: os.environ.get(k) for k in (
        "SEAWEEDFS_TPU_FILER_META_PLANE",
        "SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE")}
    os.environ["SEAWEEDFS_TPU_FILER_META_PLANE"] = "0"
    os.environ["SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE"] = "0"
    made = []
    try:
        out = {}
        for kind in ("port", "jax"):
            tmp = tmp_path_factory.mktemp(f"filer_{kind}")
            c = Cluster(tmp, "port" if kind == "port" else "ref",
                        racks=("r1", "r1"), size_limit_mb=64)
            made.append(c)
            cls = FilerServer if kind == "port" else RefFilerServer
            fs = cls(c.url, store_path=str(tmp / "filer.db")).start()
            made.append(fs)
            out[kind] = (fs.url, c.url, fs)
        yield out
    finally:
        for m in reversed(made):
            (m.close if isinstance(m, Cluster) else m.stop)()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _req(u, method, path, body=None, headers=None):
    route, q, query = path.partition("?")
    st, data, hdrs = http_bytes(
        method, f"{u}{urllib.parse.quote(route)}{q}{query}", body, headers)
    keep = {k: hdrs[k] for k in ("Content-Type", "Content-Length",
                                 "Content-Range") if k in hdrs}
    parsed = data
    if data and hdrs.get("Content-Type") == "application/json":
        # a JSON body's length moves with the masked fids and clocks
        parsed = _mask(json.loads(data))
        keep.pop("Content-Length")
    return [method, path, st, parsed, keep]


def _events(u, since: int, prefix: str) -> list:
    evs = http_json("GET", f"{u}/__meta__/events?sinceNs={since}")["events"]
    out = []
    for e in evs:
        paths = [x["fullPath"] for x in (e.get("newEntry"), e.get("oldEntry"))
                 if x]
        if any(p.startswith(prefix) for p in paths):
            out.append(_mask(e))
    return out


def _last_ts(u) -> int:
    evs = http_json("GET", f"{u}/__meta__/events?sinceNs=0")["events"]
    return evs[-1]["tsNs"] if evs else 0


def case_mkdir(u, m, kind):
    return [_req(u, "PUT", "/mk/d/"), _req(u, "PUT", "/mk/d/e/"),
            _req(u, "PUT", "/mk/d/"), _req(u, "GET", "/mk/"),
            _req(u, "GET", "/mk/d"), _req(u, "HEAD", "/mk/d/e/")]


def case_one_chunk(u, m, kind):
    body = _seeded(1, 1000)
    return [_req(u, "PUT", "/one/a.txt", body, {"Content-Type": "text/x"}),
            _req(u, "GET", "/one/a.txt"), _req(u, "HEAD", "/one/a.txt"),
            _req(u, "POST", "/one/b.bin", b""), _req(u, "GET", "/one/b.bin"),
            _req(u, "GET", "/one/missing"),
            _req(u, "GET", "/__meta__/lookup?path=/one/a.txt")]


def case_multi_chunk(u, m, kind):
    body = _seeded(2, (9 << 20) + 12345)
    out = [_req(u, "POST", "/multi/big.bin", body)]
    st, got, _ = http_bytes("GET", f"{u}/multi/big.bin")
    out.append([st, got == body])
    meta = http_json("GET", f"{u}/__meta__/lookup?path=/multi/big.bin")
    out.append([len(meta["chunks"]), _mask(meta)])
    return out


def case_ranges(u, m, kind):
    body = _seeded(3, (8 << 20) + 777)
    out = [_req(u, "PUT", "/rng/f", body)]
    for r in ("bytes=4194000-4195000", "bytes=0-0", "bytes=-100",
              "bytes=8388000-", "bytes=4194304-8388607",
              "bytes=99999999-", "bytes=abc", "bytes=0-1,5-6", "bytes=5-2"):
        got = _req(u, "GET", "/rng/f", None, {"Range": r})
        if isinstance(got[3], bytes) and len(got[3]) > 64:
            lo = int(got[4]["Content-Range"].split()[1].split("-")[0]) \
                if "Content-Range" in got[4] else 0
            assert got[3] == body[lo:lo + len(got[3])]
            got[3] = len(got[3])
        out.append(got)
    return out


def case_listing(u, m, kind):
    out = [_req(u, "PUT", f"/ls/{n}", n.encode())
           for n in ("b", "a", "c", "ab", "a_b", "a%", "d/x")]
    for q in ("", "?limit=3", "?limit=3&lastFileName=ab", "?prefix=a",
              "?prefix=a&lastFileName=a%25", "?prefix=a_", "?limit=100",
              "?lastFileName=zzz"):
        st, data, _ = http_bytes("GET", f"{u}/ls/{q}")
        out.append([q, st, _mask(json.loads(data))])
    return out


def case_overwrite(u, m, kind):
    op = operation if kind == "port" else ref_operation
    out = [_req(u, "PUT", "/ow/f", _seeded(4, 5 << 20))]
    old = [c["fileId"] for c in http_json(
        "GET", f"{u}/__meta__/lookup?path=/ow/f")["chunks"]]
    since = _last_ts(u)
    out.append(_req(u, "PUT", "/ow/f", _seeded(5, 3000)))
    out.append(_req(u, "GET", "/ow/f"))
    gone = []
    for fid in old:
        try:
            op.read(m, fid)
            gone.append(False)
        except (RuntimeError, OSError, LookupError):
            gone.append(True)
    out.append([len(old), gone])
    out.append(_events(u, since, "/ow/"))
    return out


def case_delete(u, m, kind):
    op = operation if kind == "port" else ref_operation
    out = [_req(u, "PUT", p, _seeded(6, 2000)) for p in
           ("/del/f", "/del/d/x", "/del/d/y/z", "/del/keep/k")]
    kept = http_json("GET", f"{u}/__meta__/lookup?path=/del/keep/k")[
        "chunks"][0]["fileId"]
    since = _last_ts(u)
    out += [_req(u, "DELETE", "/del/f"), _req(u, "GET", "/del/f"),
            _req(u, "DELETE", "/del/d"), _req(u, "DELETE", "/del/missing"),
            _req(u, "DELETE", "/del/d?recursive=true"),
            _req(u, "GET", "/del/"),
            _req(u, "DELETE", "/del/keep?recursive=true&ignoreChunks=true"),
            _req(u, "GET", "/del/keep/k"),
            # a deleted directory comes back when a file is written under
            # it (the known-directory cache was cleared)
            _req(u, "PUT", "/del/d/y/again", b"again"),
            _req(u, "GET", "/del/"), _req(u, "GET", "/del/d/")]
    out.append(op.read(m, kept) == _seeded(6, 2000))
    out.append(_events(u, since, "/del/"))
    return out


def case_chunk_routes(u, m, kind):
    out = []
    for q, body in (("?offset=0", b"0123456789"), ("?offset=5", b"ABCDE"),
                    ("?offset=20", b"tail"), ("?offset=0&truncateTo=7", b""),
                    ("?offset=0&truncateTo=12", b""),
                    ("?offset=2&truncateTo=9", b"zz")):
        st, data, _ = http_bytes("POST", f"{u}/__chunk__/ch/f{q}", body)
        out.append([q, st, json.loads(data)])
        out.append(_req(u, "GET", "/ch/f"))
    http_bytes("PUT", f"{u}/ch/dir/")
    for path, q in (("/__chunk__/ch/dir", "?offset=0"),
                    ("/__chunk__/ch/none", "?truncateTo=3")):
        st, data, _ = http_bytes("POST", f"{u}{path}{q}",
                                 b"x" if "dir" in path else b"")
        out.append([path, st, json.loads(data)])
    out.append(_req(u, "GET", "/__chunk__/ch/f"))
    return out


def case_meta_routes(u, m, kind):
    def post(path, payload):
        st, data, _ = http_bytes("POST", f"{u}{path}",
                                 json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
        return [path, st, _mask(json.loads(data or b"{}"))]
    since = _last_ts(u)
    out = [_req(u, "PUT", "/meta/f", b"hello")]
    out.append(post("/__meta__/rename", {"oldPath": "/meta/f",
                                         "newPath": "/meta/g/h"}))
    out.append(post("/__meta__/rename", {"oldPath": "/meta/f",
                                         "newPath": "/meta/x"}))
    out.append(post("/__meta__/set_attrs", {
        "path": "/meta/g/h", "attributes": {"mode": 384, "uid": 7,
                                            "mime": "text/y"}}))
    out.append(post("/__meta__/set_attrs", {"path": "/meta/none",
                                            "attributes": {}}))
    out.append(post("/__meta__/create", {"path": "/meta/ptr",
                                         "extended": {"remote": "r"}}))
    out.append(post("/__meta__/put_entry", {
        "fullPath": "/meta/full", "attributes": {"mode": 420, "mime": "a/b"},
        "chunks": [], "extended": {"k": "v"}}))
    out.append(post("/__meta__/patch_extended", {"path": "/meta/full",
                                                 "extended": {"k2": "v2"}}))
    out.append(post("/__meta__/patch_extended", {"path": "/meta/none",
                                                 "extended": {}}))
    for p in ("/meta/g/h", "/meta/full", "/meta/ptr", "/meta/f", "/"):
        out.append(_req(u, "GET", f"/__meta__/lookup?path={p}"))
    out.append(_req(u, "GET", "/meta/g/h"))
    out.append(_events(u, since, "/meta/"))
    evs = http_json("GET", f"{u}/__meta__/events?sinceNs={since}&limit=2")
    out.append(len(evs["events"]))
    st = http_json("GET", f"{u}/__meta__/statistics")
    out.append(sorted(st))
    out.append(http_json("GET", f"{u}/status"))
    return out


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_http_answers_match_the_jax_filer(clusters, case):
    got = {kind: CASES[case](u, m, kind)
           for kind, (u, m, _fs) in clusters.items()}
    assert got["port"] == got["jax"]


def test_http_answers_are_what_the_reference_says(clusters):
    """The transcript's own content, on the port: statuses and shapes a
    client relies on (the comparison above holds the rest)."""
    u = clusters["port"][0]
    body = _seeded(8, (4 << 20) + 10)
    assert http_bytes("PUT", f"{u}/own/f", body)[0] == 201
    st, data, h = http_bytes("GET", f"{u}/own/f",
                             headers={"Range": "bytes=4194300-4194309"})
    assert (st, data, h["Content-Range"]) == \
        (206, body[4194300:4194310], f"bytes 4194300-4194309/{len(body)}")
    st, _, h = http_bytes("GET", f"{u}/own/f",
                          headers={"Range": f"bytes={len(body)}-"})
    assert (st, h["Content-Range"]) == (416, f"bytes */{len(body)}")
    assert http_bytes("DELETE", f"{u}/own")[0] == 409
    text = http_bytes("GET", f"{u}/metrics")[1].decode()
    for name in ("filer_meta_log_last_ts_ns",
                 'group_commit_batch_size_count{site="filer.store"}',
                 'group_commit_batch_size_count{site="filer.metalog"}'):
        assert name in text, name


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_filer_db_reopens_in_the_other_filer_with_its_bytes(
        clusters, writer, reader, tmp_path, sync_commit):
    """A filer.db and its .metalog written by one package's filer server
    over its cluster, then served by the other package's filer server
    over the same master: the same listings (to the byte: the same rows),
    the same bodies and the same events."""
    m = clusters[writer][1]
    db = str(tmp_path / "x.db")
    cls = {"port": FilerServer, "jax": RefFilerServer}
    bodies = {"/x/a": _seeded(15, 1000), "/x/b/c": _seeded(16, (9 << 20) + 5),
              "/x/e": b""}
    a = cls[writer](m, store_path=db).start()
    try:
        for path, body in bodies.items():
            assert http_bytes("PUT", f"{a.url}{path}", body)[0] == 201
        http_bytes("DELETE", f"{a.url}/x/e")
        want = [http_bytes("GET", f"{a.url}{d}")[1] for d in ("/x/", "/x/b/")]
        events = http_bytes("GET", f"{a.url}/__meta__/events?sinceNs=0")[1]
    finally:
        a.stop()
    b = cls[reader](m, store_path=db).start()
    try:
        assert [http_bytes("GET", f"{b.url}{d}")[1]
                for d in ("/x/", "/x/b/")] == want
        assert http_bytes("GET", f"{b.url}/__meta__/events?sinceNs=0")[1] \
            == events
        for path, body in bodies.items():
            st, got, _ = http_bytes("GET", f"{b.url}{path}")
            assert (st, got) == ((404, got) if path == "/x/e" else (200, body))
    finally:
        b.stop()


def test_a_failed_overwrite_commit_keeps_the_old_file(clusters, monkeypatch):
    """The old chunks of an overwritten file go only after the new entry
    is committed: a commit that fails leaves the old file readable, in
    both filers."""
    got = {}
    for kind, (u, _m, fs) in clusters.items():
        old = _seeded(13, 6000)
        assert http_bytes("PUT", f"{u}/fail/f", old)[0] == 201
        store = fs.filer.store

        def broken(entry, _real=store.insert_entry):
            raise OSError("store down")
        monkeypatch.setattr(store, "insert_entry", broken)
        st = http_bytes("PUT", f"{u}/fail/f", _seeded(14, 7000))[0]
        monkeypatch.undo()
        got[kind] = (st, http_bytes("GET", f"{u}/fail/f")[1] == old)
    assert got["port"] == got["jax"] == (500, True)


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_view_stream_zero_fills_and_closes_once(kind):
    """`open_read_stream` over a sparse chunk list: gaps and short chunk
    reads come back as zeros, windows of any size add up to the range,
    and `on_close` runs once, as in the JAX stream."""
    pkg = PKG[kind]
    f = pkg["Filer"](MASTER, pkg["MemoryStore"]())
    blobs = {"1,a": b"A" * 10, "2,b": b"B" * 7, "3,c": b"C" * 4}

    def read_view(v):
        return blobs[v.file_id][v.chunk_offset:v.chunk_offset + v.size]
    f._read_view = read_view
    e = pkg["Entry"]("/s", chunks=[pkg["Chunk"]("1,a", 0, 10, "", 1),
                                   pkg["Chunk"]("2,b", 15, 9, "", 2),
                                   pkg["Chunk"]("3,c", 5, 4, "", 3)])
    closed = []
    want = b"AAAAACCCCA" + bytes(5) + b"BBBBBBB" + bytes(2)
    for off, size, step in ((0, 24, 3), (4, 13, 5), (0, 24, -1)):
        s = f.open_read_stream(e, off, size, on_close=lambda: closed.append(1))
        parts = []
        while True:
            b = s.read(step)
            if not b:
                break
            parts.append(b)
            if step < 0:
                break
        s.close()
        s.close()
        assert b"".join(parts) == want[off:off + size]
    assert closed == [1, 1, 1]
    f.close()


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_filer_clients_crosswise(clusters, client, server):
    u = clusters[server][0]
    c = (RefFilerClient if client == "jax" else FilerClient)(
        "http://" + u)
    base = f"/cx_{client}"
    data = _seeded(9, (5 << 20) + 3)
    e = c.write_file(f"{base}/a/f.bin", data, mime="x/y")
    assert e.total_size() == len(data) and len(e.chunks) == 2
    assert c.read_file(f"{base}/a/f.bin") == data
    assert c.read_file(f"{base}/a/f.bin", 4194300, 100) == \
        data[4194300:4194400]
    assert [x.name for x in c.list_directory(base)] == ["a"]
    c.rename(f"{base}/a/f.bin", f"{base}/b/g.bin")
    with pytest.raises(FileNotFoundError):
        c.rename(f"{base}/a/f.bin", f"{base}/zz")
    c.update_attrs(f"{base}/b/g.bin", mode=0o600, uid=3)
    got = c.find_entry(f"{base}/b/g.bin")
    assert (got.attributes.mode, got.attributes.uid) == (0o600, 3)
    assert got.attributes.mime == "x/y"
    E = RefEntry if client == "jax" else Entry
    c.create_entry(E(f"{base}/c/meta", extended={"k": "v"}))
    assert c.find_entry(f"{base}/c/meta").extended == {"k": "v"}
    with pytest.raises(IsADirectoryError):
        c.delete_entry(base)
    c.delete_entry(base, recursive=True)
    assert c.find_entry(f"{base}/b/g.bin") is None
    with pytest.raises(FileNotFoundError):
        c.read_file(f"{base}/b/g.bin")


FS_SCRIPT = ["fs.mkdir /sh/a", "fs.ls /sh", "fs.ls -l /sh/docs",
             "fs.cat /sh/docs/readme", "fs.du /sh", "fs.tree /sh",
             "fs.mv /sh/docs/readme /sh/a/readme", "fs.ls /sh/a",
             "fs.cd /sh/a", "fs.pwd", "fs.cd ..", "fs.pwd",
             "fs.meta /sh/a/readme", "fs.rm -r /sh/docs", "fs.ls /sh",
             "fs.configure"]


def _fs_transcript(run, env, u) -> list:
    http_bytes("PUT", f"{u}/sh/docs/readme", b"read me\n")
    http_bytes("PUT", f"{u}/sh/docs/big", _seeded(10, 5 << 20))
    out = []
    for line in FS_SCRIPT:
        text = run(env, line)
        if line.startswith("fs.meta"):
            text = _mask(json.loads(text))
        elif line == "fs.configure":
            text = text.replace(u, "<filer>")
        out.append(text)
    with pytest.raises(RuntimeError, match="not a directory"):
        run(env, "fs.cd /sh/a/readme")
    return out


@pytest.mark.parametrize("server", ["port", "jax"])
def test_fs_commands_print_what_the_jax_shell_prints(clusters, server):
    u, m, fs = clusters[server]
    port = _fs_transcript(run_command, CommandEnv(m, filer=u), u)
    http_bytes("DELETE", f"{u}/sh?recursive=true")
    ref = _fs_transcript(ref_run_command, RefEnv(m, filer=u), u)
    http_bytes("DELETE", f"{u}/sh?recursive=true")
    assert port == ref
    assert port[1] == "a/\ndocs/"
    assert port[4] == f"{(5 << 20) + 8} bytes, 2 files under /sh"
    with pytest.raises(RuntimeError, match="no filer configured"):
        run_command(CommandEnv(m), "fs.ls /")


# --- EC volumes under the filer, on the CPU codec ---------------------------

def test_filer_reads_an_encoded_collection_direct_and_degraded(
        tmp_path, monkeypatch):
    """Files in a collection that ec.encode turned into EC volumes read
    back byte-identical through the filer, with every shard up and with
    a shard holder stopped (degraded reads on the host codec); the
    kernel's wrappers are not called by any filer read."""
    from seaweedfs_tpu_torch.shell.commands import run_script
    monkeypatch.setenv("SEAWEEDFS_TPU_READ_CACHE_MB", "0")  # no cache hits
    calls = []
    for name in ("gf_apply_matrix_words", "gf_apply_matrix_words_batch"):
        real = getattr(rs_cuda, name)
        monkeypatch.setattr(rs_cuda, name,
                            lambda *a, _r=real, **k: (calls.append(1),
                                                      _r(*a, **k))[1])
    c = Cluster(tmp_path, "port", racks=("r1", "r1", "r2", "r2"),
                size_limit_mb=4)
    fs = FilerServer(c.url, store_path=str(tmp_path / "filer.db"),
                     collection="ecf").start()
    try:
        u = fs.url
        rng = np.random.default_rng(12)
        files = {}
        for i in range(24):
            size = int(rng.choice([1024, 70_000, 600_000, 5 << 20]))
            files[f"/ec/d{i % 4}/f{i:02d}"] = _seeded(100 + i, size)
        for path, body in files.items():
            assert http_bytes("PUT", f"{u}{path}", body)[0] == 201
        vids = sorted(c.volumes())
        assert vids
        env = CommandEnv(c.url)
        out = run_script(env, "lock; ec.encode -collection=ecf; unlock")
        assert out[1].count("scatter-encoded 14 shards") == len(vids), out
        _wait(lambda: not c.volumes(), "the encoded volumes left")
        operation._vid_cache = operation.VidCache()

        def read_all(what):
            calls.clear()
            for path, body in files.items():
                st, got, _ = http_bytes("GET", f"{u}{path}")
                assert (st, got == body) == (200, True), (what, path)
                st, got, _ = http_bytes("GET", f"{u}{path}", headers={
                    "Range": f"bytes=1-{len(body) // 2}"})
                assert got == body[1:len(body) // 2 + 1], (what, path)
            assert calls == [], f"{what}: a filer read called the kernel"
        read_all("direct")
        holders = {}
        for vid in vids:
            for loc in http_json(
                    "GET", f"{c.url}/dir/ec_lookup?volumeId={vid}")[
                    "shardIdLocations"]:
                holders.setdefault(loc["url"], {})[vid] = loc["shardIds"]
        victim = max(holders, key=lambda h: sum(
            1 for sids in holders[h].values() for s in sids if s < 10))
        assert all(len(s) <= 4 for s in holders[victim].values())
        before = stats.PROCESS.counter_sum("ec_degraded_reads_total")
        c.stop(c.servers[[s.url for s in c.servers].index(victim)])
        _wait(lambda: victim not in c.get("/cluster/status")["dataNodes"],
              "the master drops the stopped server", timeout=20)
        operation._vid_cache = operation.VidCache()
        read_all("degraded")
        assert stats.PROCESS.counter_sum("ec_degraded_reads_total") > before
        assert http_json("GET", f"{u}/ec/d1/")["entries"]
    finally:
        fs.stop()
        c.close()


# --- the command line --------------------------------------------------------

def _start(argv, env=None):
    p = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch"] + argv,
                         cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env)
    line = p.stdout.readline()
    return p, line


def test_filer_command_serves_and_stops(tmp_path):
    """The default configuration: the meta plane and both native planes,
    their ports on /status."""
    from seaweedfs_tpu_torch import native
    c = Cluster(tmp_path, "port", racks=("r1",))
    env = {k: v for k, v in os.environ.items() if k not in (
        "SEAWEEDFS_TPU_FILER_META_PLANE",
        "SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE",
        "SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE")}
    p, line = _start(["filer", "-port", "0", "-master", c.url,
                      "-store", str(tmp_path / "filer.db"),
                      "-collection", "cli"], env=env)
    try:
        assert line.startswith("filer listening on 127.0.0.1:"), \
            line + p.stderr.read()
        u = line.split()[-1]
        st = http_json("GET", f"{u}/status")
        assert {k: st[k] for k in ("version", "role")} == {
            "version": "seaweedfs-tpu/0.1", "role": "filer"}
        built = native.load_meta_plane() is not None and \
            native.load_filer_read_plane() is not None
        assert (st["metaPlanePort"] > 0 and st["readPlanePort"] > 0) \
            == built, st
        assert http_bytes("PUT", f"{u}/d/x", b"abc")[0] == 201
        assert http_bytes("GET", f"{u}/d/x")[1] == b"abc"
        assert os.path.isdir(str(tmp_path / "filer.db.metalog"))
    finally:
        p.send_signal(signal.SIGTERM)
        rc = p.wait(30)
        c.close()
    assert rc == 0


@pytest.mark.parametrize("argv,env", [
    (["-metaPlane", "1", "-workers", "2"], {}), (["-storeType", "lsm"], {}),
    (["-workers", "2"], {}),
    (["-workers", "2"], {"SEAWEEDFS_TPU_FILER_META_PLANE": "1"}),
    (["-notification", "log"], {}), (["-lockPeers", "127.0.0.1:1"], {})],
    ids=["metaPlane", "storeType", "workers", "meta_plane_env",
         "notification", "lockPeers"])
def test_filer_command_refuses_what_is_not_ported(argv, env, tmp_path):
    """What the port has not ported is refused with exit 2, the meta
    plane's pre-fork workers included (`-metaPlane 1 -workers 2`)."""
    p = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "filer", "-port", "0",
         "-master", MASTER, "-store", str(tmp_path / "f.db")] + argv,
        cwd=REPO, capture_output=True, text=True, timeout=60,
        env={**os.environ, **env})
    assert p.returncode == 2 and "not ported" in p.stderr, p.stderr
    assert p.stdout == ""


@pytest.mark.parametrize("server", ["port", "jax"])
def test_shell_fs_ls_matches_the_jax_shell(clusters, server):
    u, m, _fs = clusters[server]
    for n in ("b", "a", "sub/x"):
        http_bytes("PUT", f"{u}/cli_d/{n}", b"1")
    outs = []
    for pkg in ("seaweedfs_tpu_torch", "seaweedfs_tpu"):
        p = subprocess.run(
            [sys.executable, "-m", pkg, "shell", "-master", m, "-filer", u,
             "fs.ls /cli_d"], cwd=REPO, capture_output=True, text=True,
            timeout=120)
        assert p.returncode == 0, p.stderr
        outs.append(p.stdout)
    assert outs[0] == outs[1] == "a\nb\nsub/\n"
