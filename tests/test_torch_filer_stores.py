"""The port's other filer stores and its configuration layer on the CPU,
against the JAX package's: the skip list, the lsm store (WAL, memtable,
segments, compaction), the redis store over tests/resp_fake.py (an
external RESP process), the elastic store over tests/elastic_fake.py, the
KV store over both packages' `HttpKVServer`, and `util/config.py` (the
TOML readers and the `WEED_*` environment layer).  Tolerance: exact
equality of transcripts, file bytes and parsed values.  Inputs are seeded
with numpy.

- the store contract (tests/test_filer.py's transcript) gives the same
  answers over each port store and its JAX twin;
- seeded put/delete runs leave byte-identical `wal.log` and `.seg`
  files in both packages' lsm trees, through flushes and compactions,
  and a tree written by either package opens in the other;
- a RESP server or an ES-wire server written by one package's store
  reads the same in the other's;
- a Filer over lsm with its meta plane on (the default over a local
  store) acks at the metalog, checkpoints into the lsm tree, and the
  tree and metalog open in a JAX Filer with the same entries and events;
- the filer server's metalog dirs for remote stores and its refusal of
  lsm over `:memory:` are the JAX filer's.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu.filer import kv_store as ref_kv
from seaweedfs_tpu.filer import lsm_store as ref_lsm
from seaweedfs_tpu.filer.elastic_store import ElasticClient as RefEsClient
from seaweedfs_tpu.filer.elastic_store import \
    ElasticFilerStore as RefEsStore
from seaweedfs_tpu.filer.entry import Entry as RefEntry
from seaweedfs_tpu.filer.filer import Filer as RefFiler
from seaweedfs_tpu.filer.redis_store import RedisFilerStore as RefRedisStore
from seaweedfs_tpu.filer.redis_store import RespClient as RefRespClient
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.util import config as ref_config
from seaweedfs_tpu.util import skiplist as ref_skiplist
from seaweedfs_tpu_torch.filer import kv_store, lsm_store
from seaweedfs_tpu_torch.filer.elastic_store import (ElasticClient,
                                                     ElasticFilerStore)
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.redis_store import (RedisFilerStore,
                                                   RespClient, RespError)
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.util import config, skiplist

from elastic_fake import FakeElastic
from test_torch_filer import JAX, PORT, _contract

HERE = os.path.dirname(os.path.abspath(__file__))
MASTER = "127.0.0.1:1"           # never dialed: metadata-only filers


@pytest.fixture(scope="module")
def resp_port():
    """tests/resp_fake.py as a separate process (the reference's own
    stand-in, unchanged)."""
    proc = subprocess.Popen([sys.executable,
                             os.path.join(HERE, "resp_fake.py"), "0"],
                            stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline().strip()
    assert line.startswith("PORT "), line
    yield int(line.split()[1])
    proc.kill()
    proc.wait(timeout=5)


@pytest.fixture
def es():
    server = FakeElastic().start()
    yield server
    server.stop()


@pytest.fixture
def meta_plane_default(monkeypatch):
    """The filer's default: its meta plane on over a local store."""
    for k in ("SEAWEEDFS_TPU_FILER_META_PLANE",
              "SEAWEEDFS_TPU_FILER_META_CACHE"):
        monkeypatch.delenv(k, raising=False)


# --- the skip list ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skiplist_heights_and_scans_match(seed):
    rng = np.random.default_rng(seed)
    keys = [f"/d{int(rng.integers(0, 4))}/" + "".join(
        rng.choice(list("abcxyz_%"), int(rng.integers(1, 8))))
        for _ in range(400)]
    lists = (skiplist.SkipList(), ref_skiplist.SkipList())
    for i, k in enumerate(keys):
        for sl in lists:
            if i % 7 == 3:
                sl.delete(keys[i // 2])
            else:
                sl.insert(k, i)
    port, ref = lists
    assert [skiplist.SkipList._height_for(k) for k in keys] == \
        [ref_skiplist.SkipList._height_for(k) for k in keys]
    assert list(port.items()) == list(ref.items())
    assert list(port.items("/d1/", "/d2", include_start=False)) == \
        list(ref.items("/d1/", "/d2", include_start=False))
    assert (len(port), port.first(), port._level) == \
        (len(ref), ref.first(), ref._level)


# --- the lsm store --------------------------------------------------------

def _seeded_ops(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    live = []
    for i in range(n):
        r = rng.random()
        if live and r < 0.2:
            ops.append(("delete", live.pop(int(rng.integers(len(live))))))
        elif r < 0.3 and len(live) > 3:
            batch = [(k, {"fullPath": k, "v": i}) for k in
                     rng.choice(live, 3, replace=False).tolist()]
            ops.append(("put_many", batch))
        else:
            k = f"/d{int(rng.integers(0, 5))}/f{int(rng.integers(0, 300))}"
            live.append(k)
            ops.append(("put", (k, {"fullPath": k, "v": i,
                                    "blob": "x" * int(rng.integers(0, 9))})))
    return ops


def _run_ops(tree, ops) -> None:
    for op, arg in ops:
        if op == "delete":
            tree.delete(arg)
        elif op == "put_many":
            tree.put_many(arg)
        else:
            tree.put(*arg)


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("seed,limit,n", [(0, 1000, 300), (1, 37, 400),
                                          (2, 11, 600)])
def test_lsm_files_are_byte_identical(seed, limit, n, tmp_path,
                                      monkeypatch):
    """Seeded puts, batches and deletes: the WAL, every flushed segment
    and every compaction the same bytes in both packages (a memtable of
    11 or 37 keys makes ~50 and ~10 flushes and several compactions)."""
    monkeypatch.setattr(lsm_store, "MEMTABLE_LIMIT", limit)
    monkeypatch.setattr(ref_lsm, "MEMTABLE_LIMIT", limit)
    ops = _seeded_ops(seed, n)
    trees = {"port": lsm_store.LsmTree(str(tmp_path / "port")),
             "jax": ref_lsm.LsmTree(str(tmp_path / "jax"))}
    for t in trees.values():
        _run_ops(t, ops)
    mid = {k: _files(tmp_path / k) for k in trees}
    assert mid["port"] == mid["jax"]
    assert list(trees["port"].scan("/", "0")) == \
        list(trees["jax"].scan("/", "0"))
    for t in trees.values():
        t.flush_memtable()
        t.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    if limit < 1000:
        assert any(n.endswith(".seg") for n in _files(tmp_path / "port"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_an_lsm_tree_opens_in_the_other_package(writer, tmp_path,
                                                monkeypatch):
    """A tree left with segments and an unflushed WAL tail by one package
    reads the same in the other, and the other's next writes keep the
    files identical to the writer's own."""
    for mod in (lsm_store, ref_lsm):
        monkeypatch.setattr(mod, "MEMTABLE_LIMIT", 23)
    mods = {"port": lsm_store, "jax": ref_lsm}
    reader = "jax" if writer == "port" else "port"
    ops = _seeded_ops(5, 300)
    a = mods[writer].LsmTree(str(tmp_path / "a"))
    _run_ops(a, ops[:200])
    a.close()
    b = mods[writer].LsmTree(str(tmp_path / "b"))
    _run_ops(b, ops[:200])
    b.close()
    # a: reopened by the other package; b: by its own writer
    ra = mods[reader].LsmTree(str(tmp_path / "a"))
    rb = mods[writer].LsmTree(str(tmp_path / "b"))
    assert list(ra.scan("/", "0")) == list(rb.scan("/", "0"))
    _run_ops(ra, ops[200:])
    _run_ops(rb, ops[200:])
    assert list(ra.scan("/", "0")) == list(rb.scan("/", "0"))
    ra.close()
    rb.close()
    assert _files(tmp_path / "a") == _files(tmp_path / "b")


STORES = {
    "lsm": lambda pkg, ctx: (lsm_store.LsmStore if pkg is PORT
                             else ref_lsm.LsmStore)(str(ctx["dir"])),
    "redis": lambda pkg, ctx: (RedisFilerStore if pkg is PORT
                               else RefRedisStore)(
        (RespClient if pkg is PORT else RefRespClient)(
            port=ctx["resp"])),
    "elastic": lambda pkg, ctx: (ElasticFilerStore if pkg is PORT
                                 else RefEsStore)(
        (ElasticClient if pkg is PORT else RefEsClient)(
            ctx["es"].address)),
    "kv": lambda pkg, ctx: (kv_store.KVFilerStore if pkg is PORT
                            else ref_kv.KVFilerStore)(
        (kv_store.HttpKVClient if pkg is PORT
         else ref_kv.HttpKVClient)(ctx["kv"].url)),
}


@pytest.mark.parametrize("kind", sorted(STORES))
def test_store_contract_matches_the_jax_store(kind, resp_port, tmp_path):
    """The store contract's transcript over each store, each package on a
    server (or directory) of its own."""
    out = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        es = FakeElastic().start()
        kv = (kv_store.HttpKVServer() if pkg is PORT
              else ref_kv.HttpKVServer()).start()
        RespClient(port=resp_port).call("FLUSHALL")
        try:
            store = STORES[kind](pkg, {"dir": tmp_path / name,
                                       "resp": resp_port, "es": es,
                                       "kv": kv})
            out[name] = _contract(store, pkg)
            store.close()
        finally:
            kv.stop()
            es.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] is True and out["port"][-1] == []


def _seeded_entries(pkg, seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = f"/s{int(rng.integers(0, 3))}"
        chunks = [{"fileId": f"{int(rng.integers(1, 9))},0{j}cafe01",
                   "offset": j * 8, "size": 8, "eTag": "e", "mtime": 7}
                  for j in range(int(rng.integers(0, 3)))]
        out.append(pkg["Entry"].from_json({
            "fullPath": f"{d}/n{i:03d}{'_%'[i % 2]}",
            "attributes": {"mtime": 1.5, "crtime": 1.25, "mode": 420,
                           "mime": "application/x"},
            "chunks": chunks, "extended": {"k": str(i)}}))
    return out


@pytest.mark.parametrize("kind,writer", [
    ("redis", "port"), ("redis", "jax"), ("elastic", "port"),
    ("elastic", "jax"), ("kv", "port"), ("kv", "jax")])
def test_a_remote_store_written_by_one_package_reads_in_the_other(
        kind, writer, resp_port, es):
    """Entries written through one package's store read back entry for
    entry, listing for listing, through the other's on the same server."""
    RespClient(port=resp_port).call("FLUSHALL")
    pkgs = {"port": PORT, "jax": JAX}
    reader = "jax" if writer == "port" else "port"
    kv = kv_store.HttpKVServer().start()
    try:
        ctx = {"resp": resp_port, "es": es, "kv": kv}
        w = STORES[kind](pkgs[writer], ctx)
        r = STORES[kind](pkgs[reader], ctx)
        entries = _seeded_entries(pkgs[writer], 3, 60)
        for e in entries:
            w.insert_entry(e)
        w.delete_entry(entries[4].full_path)
        for e in entries:
            got = r.find_entry(e.full_path)
            if e is entries[4]:
                assert got is None
            else:
                assert json.dumps(got.to_json()) == json.dumps(e.to_json())
        for d in ("/s0", "/s1", "/s2"):
            for q in ({}, {"prefix": "n01"}, {"start_file": "n020_",
                                              "limit": 5}):
                assert [json.dumps(x.to_json()) for x in
                        r.list_directory_entries(d, **q)] == \
                    [json.dumps(x.to_json()) for x in
                     w.list_directory_entries(d, **q)]
    finally:
        kv.stop()


def test_resp_clients_speak_the_same_protocol(resp_port):
    port, ref = RespClient(port=resp_port), RefRespClient(port=resp_port)
    blob = bytes(range(256))
    for c in (port, ref):
        assert c.call("PING") == "PONG"
        assert c.call("SET", "bin", blob) == "OK"
        assert c.call("GET", "bin") == blob
        assert c.call("GET", "missing") is None
    assert port._encode(("ZADD", "k\x00", 0, "n\xff")) == \
        ref._encode(("ZADD", "k\x00", 0, "n\xff"))
    with pytest.raises(RespError):
        port.call("NOSUCHCOMMAND")
    port._sock.close()               # reconnect after a dropped socket
    assert port.call("PING") == "PONG"
    port.close()
    ref.close()


# --- filers over the stores -------------------------------------------------

def test_meta_plane_checkpoints_into_lsm_and_opens_in_jax(
        tmp_path, meta_plane_default):
    """A port Filer over lsm runs its meta plane (acks at the metalog,
    the tree an async checkpoint); closed, its tree and metalog open in
    a JAX Filer with every entry and event, and the other way round."""
    for writer, reader in ((Filer, RefFiler), (RefFiler, Filer)):
        d = tmp_path / writer.__module__.split(".")[0]
        wstore = (lsm_store.LsmStore if writer is Filer
                  else ref_lsm.LsmStore)(str(d / "ldb"))
        f = writer(MASTER, wstore, meta_log_dir=str(d / "ldb.metalog"))
        assert f.meta_plane is not None
        E = Entry if writer is Filer else RefEntry
        for i in range(40):
            f.create_entry(E(f"/m/{i % 4}/e{i:02d}"))
        f.rename("/m/0/e00", "/m/1/moved")
        f.delete_entry("/m/2/e02")
        want = [e.to_json() for e in f.list_directory("/m/1")]
        events = f.events_since(0)
        f.close()
        rstore = (lsm_store.LsmStore if reader is Filer
                  else ref_lsm.LsmStore)(str(d / "ldb"))
        g = reader(MASTER, rstore, meta_log_dir=str(d / "ldb.metalog"))
        try:
            assert [e.to_json() for e in g.list_directory("/m/1")] == want
            assert g.find_entry("/m/2/e02") is None
            assert g.events_since(0) == events
            # the closed writer's checkpoint covered its whole log: the
            # tree alone holds every entry
            assert rstore.find_entry("/m/1/moved") is not None
        finally:
            g.close()


def test_remote_store_filers_keep_the_jax_metalog_dirs(
        resp_port, tmp_path, monkeypatch):
    """Two co-located filers over one RESP server: a metalog dir each,
    named as the JAX filer names it, the meta cache off and no meta
    plane; each log holds its own filer's events only."""
    monkeypatch.chdir(tmp_path)
    addr = f"127.0.0.1:{resp_port}"
    made = []
    try:
        for cls in (FilerServer, FilerServer, RefFilerServer):
            made.append(cls(MASTER, store_path=addr,
                            store_type="redis").start())
        for fs in made:
            assert fs.filer.meta_log.dir == \
                f"filer-redis-127.0.0.1_{resp_port}-p{fs.http.port}.metalog"
            assert fs.filer.meta_plane is None
            assert fs.filer.meta_cache is None
        made[0].filer.create_entry(Entry("/only-a", is_directory=True))
        made[1].filer.create_entry(Entry("/only-b", is_directory=True))
        assert [e["newEntry"]["fullPath"] for e in
                made[0].filer.events_since(0)] == ["/only-a"]
        assert made[1].filer.find_entry("/only-a") is not None
    finally:
        for fs in made:
            fs.stop()


def test_lsm_over_memory_is_refused_and_the_port_released():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    for cls in (FilerServer, RefFilerServer):
        with pytest.raises(ValueError, match="lsm store needs a directory"):
            cls(MASTER, port=port, store_type="lsm", store_path=":memory:")
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))


# --- util/config.py ------------------------------------------------------

TOMLS = [
    ("filer.toml", '[sqlite]\nenabled = false\n[leveldb2]\nenabled = true\n'
                   'dir = "./ldb"\n'),
    ("filer.toml", '[redis2]\nenabled = true\naddress = "r:6379"\n'),
    ("filer.toml", '[elastic7]\nenabled = true\n'
                   'servers = ["http://es:9200", "http://b"]\n'),
    ("filer.toml", '[sqlite]\nenabled = true\ndbFile = "x.db"\n'),
    ("filer.toml", '[rocksdb]\nenabled = false\n'),
    ("notification.toml", '[notification.webhook]\nenabled = true\n'
                          'url = "http://h:1/e"\n'),
    ("notification.toml", '[notification.kafka]\nenabled = true\n'
                          'hosts = ["k:9092"]\ntopic = "t"\n'),
    ("notification.toml", '[notification.log]\nenabled = true\n'),
    ("notification.toml", '[notification.mq]\nenabled = true\n'),
    ("replication.toml", '[sink.backblaze]\nenabled = true\n'
                         'bucket = "b"\n'),
    ("replication.toml", '[sink.local]\nenabled = true\n'
                         'directory = "/bk"\n'),
    ("replication.toml", '[sink.s3]\nenabled = false\n'),
]


@pytest.mark.parametrize("i", range(len(TOMLS)))
def test_toml_readers_match(i, tmp_path, monkeypatch):
    name, text = TOMLS[i]
    monkeypatch.chdir(tmp_path)
    (tmp_path / name).write_text(text)
    assert config.find_toml(name) == ref_config.find_toml(name) == \
        os.path.join(".", name)
    fn = {"filer.toml": "filer_store_from_toml",
          "notification.toml": "notification_from_toml",
          "replication.toml": "replication_sink_from_toml"}[name]
    assert getattr(config, fn)(name) == getattr(ref_config, fn)(name)
    assert config.load_toml(name) == ref_config.load_toml(name)


def test_env_defaults_match():
    def parsers():
        ap = argparse.ArgumentParser()
        sub = ap.add_subparsers(dest="cmd")
        f = sub.add_parser("filer")
        f.add_argument("-port", type=int, default=8888)
        f.add_argument("-storeType", default="sqlite")
        f.add_argument("-ratio", type=float, default=0.5)
        f.add_argument("-fsync", action="store_true")
        s = sub.add_parser("filer.sync")
        s.add_argument("-from", dest="src", default="")
        return ap, sub
    env = {"WEED_FILER_PORT": "9999", "WEED_FILER_STORETYPE": "lsm",
           "WEED_FILER_RATIO": "0.25", "WEED_FILER_FSYNC": "yes",
           "WEED_FILER_SYNC_FROM": "a:1", "WEED_MASTER_PORT": "1"}
    out = []
    for mod in (config, ref_config):
        ap, sub = parsers()
        applied = mod.apply_env_defaults(sub.choices, env)
        out.append((applied, vars(ap.parse_args(["filer"])),
                    vars(ap.parse_args(["filer", "-port", "1"])),
                    vars(ap.parse_args(["filer.sync"]))))
    assert out[0] == out[1]
    assert out[0][1] == {"cmd": "filer", "port": 9999, "storeType": "lsm",
                         "ratio": 0.25, "fsync": True}


@pytest.mark.parametrize("which", ["security", "filer", "notification",
                                   "replication"])
def test_scaffolds_print_the_jax_templates(which):
    """`scaffold -config X` prints the JAX command's template (the filer
    one names the port's own config module; the security one, commented
    in the port's words, holds the same settings)."""
    out = []
    for module in ("seaweedfs_tpu_torch", "seaweedfs_tpu"):
        p = subprocess.run([sys.executable, "-m", module, "scaffold",
                            "-config", which], capture_output=True,
                           text=True, timeout=120, cwd=os.path.dirname(HERE),
                           env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert p.returncode == 0, p.stderr
        out.append(p.stdout.replace("seaweedfs_tpu_torch/", "PKG/")
                   .replace("seaweedfs_tpu/", "PKG/"))
    if which == "security":
        # the port's comments name its own commands: the settings agree
        import tomllib
        assert tomllib.loads(out[0]) == tomllib.loads(out[1])
        return
    assert out[0] == out[1]
