"""The port's filer meta plane (`seaweedfs_tpu_torch/filer/meta_plane.py`)
against the JAX package's (`seaweedfs_tpu/filer/meta_plane.py`): the
metalog as the WAL, the store an asynchronous checkpoint, the overlay,
the follower and the applier.

Every case of tests/test_meta_plane.py but the LSM one, each run through
both packages on the same operation sequence (entries and attributes
made from a numpy seed): the acked results, the overlay-merged finds and
paginated listings, and the final sqlite rows must be equal, with only
`mtime`/`crtime` masked.  Two cases cross the packages: a JAX log with a
lagging checkpoint booted by the port, and a port log with a stalled
applier booted by the JAX package through `recover_sync`; both give the
rows the writer's own package gives.

All in one process: two Filers over one sqlite file and one metalog dir
are the sibling topology.  Waits poll with a deadline.
"""

import json
import os
import shutil
import sqlite3
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.filer import meta_plane as ref_meta_plane
from seaweedfs_tpu.filer.entry import Attributes as RefAttributes
from seaweedfs_tpu.filer.entry import Entry as RefEntry
from seaweedfs_tpu.filer.filer import Filer as RefFiler
from seaweedfs_tpu.filer.filer_store import SqliteStore as RefSqliteStore
from seaweedfs_tpu.filer.meta_log import MetaLog as RefMetaLog
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.filer import meta_plane
from seaweedfs_tpu_torch.filer.entry import Attributes, Entry
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filer_store import SqliteStore

MASTER = "127.0.0.1:1"          # never dialed: metadata-only filers
MASKED = ("mtime", "crtime")

PORT = {"Filer": Filer, "SqliteStore": SqliteStore, "Entry": Entry,
        "Attributes": Attributes, "meta_plane": meta_plane,
        "stats": stats}
JAX = {"Filer": RefFiler, "SqliteStore": RefSqliteStore,
       "Entry": RefEntry, "Attributes": RefAttributes,
       "meta_plane": ref_meta_plane, "stats": ref_stats}


@pytest.fixture(autouse=True)
def _auto_plane(monkeypatch):
    """The default configuration: the plane's switch unset (auto)."""
    monkeypatch.delenv("SEAWEEDFS_TPU_FILER_META_PLANE", raising=False)
    monkeypatch.delenv("SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS",
                       raising=False)


def _filer(P, db, interval_ms=10, **kw):
    os.environ["SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS"] = str(interval_ms)
    try:
        return P["Filer"](MASTER, P["SqliteStore"](db),
                          meta_log_dir=db + ".metalog", **kw)
    finally:
        os.environ.pop("SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS", None)


def _attrs(seed: int) -> dict:
    """Seeded attributes: mode, uid, gid and a mime."""
    r = np.random.default_rng(seed)
    return {"mode": int(r.integers(0o400, 0o777)),
            "uid": int(r.integers(0, 65536)),
            "gid": int(r.integers(0, 65536)),
            "mime": f"x/{int(r.integers(0, 1 << 30)):x}"}


def _entry(P, path, seed=0, **attrs):
    return P["Entry"](path, attributes=P["Attributes"](
        **{**_attrs(seed), **attrs}))


def _mask(d):
    if isinstance(d, dict):
        return {k: ("*" if k in MASKED else _mask(v)) for k, v in d.items()}
    if isinstance(d, list):
        return [_mask(v) for v in d]
    return d


def _row(e):
    return None if e is None else _mask(e.to_json())


def _rows(db: str) -> list:
    """Every row of the sqlite file, its meta JSON masked."""
    con = sqlite3.connect(db)
    try:
        rows = con.execute("SELECT directory, name, meta FROM filemeta "
                           "ORDER BY directory, name").fetchall()
    finally:
        con.close()
    return [(d, n, _mask(json.loads(m))) for d, n, m in rows]


def _wait(cond, timeout=20.0, msg="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _abandon(f):
    """A filer stopped as by SIGKILL: the plane thread stops without its
    final apply, and the instance is dropped."""
    f.meta_plane._stop.set()
    f.meta_plane._thread.join(timeout=10)
    f.store.close()


def _both(case, tmp_path):
    """`case(P, dir)` through each package in a directory of its own:
    the two transcripts must be equal."""
    got = []
    for P, name in ((PORT, "port"), (JAX, "jax")):
        d = tmp_path / name
        d.mkdir()
        got.append(case(P, str(d)))
    assert got[0] == got[1], got
    return got[0]


# -- WAL ack + overlay ----------------------------------------------------

def test_ack_precedes_store_apply_and_reads_stay_exact(tmp_path):
    def case(P, d):
        db = os.path.join(d, "f.db")
        f = _filer(P, db, interval_ms=3600_000)     # the applier stalls
        try:
            for i in range(8):
                f.create_entry(_entry(P, f"/d/x{i}", seed=i))
            assert f.store.find_entry("/d/x0") is None, \
                "store applied synchronously: the WAL ack is a lie"
            out = [_row(f.find_entry("/d/x3")),
                   [_row(e) for e in f.list_directory("/d", limit=50)],
                   f.meta_plane.snapshot()["overlay"] >= 8]
        finally:
            f.close()
        # close() ran the final apply: the store is a complete checkpoint
        return out + [_rows(db)]
    out = _both(case, tmp_path)
    assert len(out[1]) == 8 and out[2]


def test_overlay_merge_tombstones_and_pagination(tmp_path):
    def case(P, d):
        db = os.path.join(d, "f.db")
        f = _filer(P, db)
        try:
            for i in range(10):
                f.create_entry(_entry(P, f"/p/a{i:02d}", seed=10 + i))
            _wait(lambda: f.meta_plane.snapshot()["overlay"] == 0,
                  msg="applier drain")
            f.meta_plane._interval = 3600.0      # stall from here on
            f.delete_entry("/p/a03", delete_chunks=False)
            f.create_entry(_entry(P, "/p/a99", seed=99))
            return [[e.name for e in f.list_directory("/p", limit=10)],
                    [_row(e) for e in f.list_directory(
                        "/p", start_file="a04", limit=3)],
                    [e.name for e in f.list_directory(
                        "/p", start_file="a04", include_start=True,
                        limit=2)],
                    [e.name for e in f.list_directory(
                        "/p", prefix="a9", limit=10)]]
        finally:
            f.close()
    names, page, incl, pref = _both(case, tmp_path)
    assert names == [f"a{i:02d}" for i in range(10) if i != 3] + ["a99"]
    assert [r["fullPath"] for r in page] == ["/p/a05", "/p/a06", "/p/a07"]
    assert incl == ["a04", "a05"] and pref == ["a99"]


def test_rename_and_update_through_overlay(tmp_path):
    def case(P, d):
        db = os.path.join(d, "f.db")
        f = _filer(P, db, interval_ms=3600_000)
        try:
            f.create_entry(_entry(P, "/r/old.txt", seed=3,
                                  mime="text/plain"))
            f.rename("/r/old.txt", "/r/new.txt")
            out = [_row(f.find_entry("/r/old.txt")),
                   _row(f.find_entry("/r/new.txt")),
                   [e.name for e in f.list_directory("/r", limit=10)]]
            f.update_attrs("/r/new.txt", mode=0o600)
            out.append(_row(f.find_entry("/r/new.txt")))
        finally:
            f.close()
        return out + [_rows(db)]
    out = _both(case, tmp_path)
    assert out[0] is None and out[2] == ["new.txt"]
    assert out[3]["attributes"]["mode"] == 0o600


def test_returned_entries_are_isolated_from_overlay(tmp_path):
    def case(P, d):
        f = _filer(P, os.path.join(d, "f.db"), interval_ms=3600_000)
        try:
            f.create_entry(_entry(P, "/iso/file", seed=4))
            got = f.find_entry("/iso/file")
            got.attributes.mode = 0o123
            got.extended["k"] = "v"
            return _row(f.find_entry("/iso/file"))
        finally:
            f.close()
    row = _both(case, tmp_path)
    assert row["attributes"]["mode"] != 0o123 and row["extended"] == {}


# -- crash durability (the in-process SIGKILL twin) -----------------------

def test_boot_replays_acked_tail_past_checkpoint(tmp_path):
    def case(P, d):
        db = os.path.join(d, "f.db")
        f = _filer(P, db, interval_ms=3600_000)
        for i in range(12):
            f.create_entry(_entry(P, f"/t/k{i:02d}", seed=20 + i))
        assert f.store.find_entry("/t/k00") is None
        _abandon(f)
        f2 = _filer(P, db, interval_ms=10)
        try:
            # readable AT ONCE through the boot overlay, before the
            # applier caught up
            out = [_row(f2.find_entry("/t/k11")),
                   len(f2.list_directory("/t", limit=50))]
            _wait(lambda: f2.store.find_entry("/t/k11") is not None,
                  msg="boot apply")
        finally:
            f2.close()
        return out + [_rows(db)]
    out = _both(case, tmp_path)
    assert out[0] is not None and out[1] == 12


def test_kill_switch_boot_replays_unapplied_tail(tmp_path):
    def case(P, d):
        db = os.path.join(d, "f.db")
        f = _filer(P, db, interval_ms=3600_000)
        f.create_entry(_entry(P, "/ks/acked", seed=5))
        assert f.store.find_entry("/ks/acked") is None
        _abandon(f)
        os.environ["SEAWEEDFS_TPU_FILER_META_PLANE"] = "0"
        try:
            f2 = _filer(P, db)
            try:
                assert f2.meta_plane is None
                out = [_row(f2.store.find_entry("/ks/acked")),
                       _row(f2.find_entry("/ks/acked"))]
            finally:
                f2.close()
        finally:
            os.environ.pop("SEAWEEDFS_TPU_FILER_META_PLANE", None)
        return out + [_rows(db)]
    out = _both(case, tmp_path)
    assert out[0] is not None and out[0] == out[1]


def test_checkpoint_is_monotonic_and_torn_reads_fail_low(tmp_path):
    def case(P, d):
        db = os.path.join(d, "f.db")
        log = db + ".metalog"
        mp = P["meta_plane"]
        f = _filer(P, db, interval_ms=5)
        seen = []
        try:
            stop = threading.Event()

            def sample():
                while not stop.is_set():
                    ck = mp.read_checkpoint(log)
                    if ck is not None:
                        seen.append(ck[0])
                    time.sleep(0.005)

            t = threading.Thread(target=sample, daemon=True)
            t.start()
            for i in range(120):
                f.create_entry(_entry(P, f"/m/n{i:03d}", seed=i))
            _wait(lambda: f.meta_plane.snapshot()["overlay"] == 0,
                  msg="drain")
            stop.set()
            t.join(timeout=10)
        finally:
            f.close()
        assert seen and seen == sorted(seen), "checkpoint regressed"
        with open(os.path.join(log, mp.CHECKPOINT_FILE), "r+b") as fh:
            fh.write(b"garbage-without-a-valid-crc")
        torn = mp.read_checkpoint(log)
        f3 = _filer(P, db)
        try:
            out = [torn, _row(f3.find_entry("/m/n000")),
                   _row(f3.find_entry("/m/n119"))]
        finally:
            f3.close()
        return out + [_rows(db)]
    out = _both(case, tmp_path)
    assert tuple(out[0]) == (meta_plane.LOG_START, 0)
    assert out[1] is not None and out[2] is not None


# -- sibling coherence ----------------------------------------------------

def test_write_through_a_read_through_b_immediately_fresh(tmp_path):
    def case(P, d):
        db = os.path.join(d, "f.db")
        a = _filer(P, db, interval_ms=3600_000)
        b = _filer(P, db, interval_ms=3600_000)
        try:
            a.create_entry(_entry(P, "/w/one", seed=6, mime="x/a"))
            out = [_row(b.find_entry("/w/one"))]
            assert b.store.find_entry("/w/one") is None, \
                "the store was the channel: the applier did not stall"
            a.create_entry(_entry(P, "/w/two", seed=7))
            out.append([e.name for e in b.list_directory("/w", limit=10)])
            b.delete_entry("/w/one", delete_chunks=False)
            out.append(_row(a.find_entry("/w/one")))
            e2 = _entry(P, "/w/two", seed=8)
            e2.extended["v"] = "2"
            a.create_entry(e2)
            out.append(_row(b.find_entry("/w/two")))
        finally:
            a.close()
            b.close()
        return out + [_rows(db)]
    one, names, gone, two, _ = _both(case, tmp_path)
    assert one["attributes"]["mime"] == "x/a" and names == ["one", "two"]
    assert gone is None and two["extended"] == {"v": "2"}


def test_single_applier_election_and_takeover(tmp_path):
    def case(P, d):
        db = os.path.join(d, "f.db")
        a = _filer(P, db, interval_ms=5)
        b = _filer(P, db, interval_ms=5)
        try:
            _wait(lambda: a.meta_plane._holder or b.meta_plane._holder,
                  msg="election")
            assert not (a.meta_plane._holder and b.meta_plane._holder), \
                "two appliers elected"
            holder, other = (a, b) if a.meta_plane._holder else (b, a)
            other.create_entry(_entry(P, "/e/pre", seed=9))
            _wait(lambda: other.store.find_entry("/e/pre") is not None,
                  msg="cross-instance apply")
            holder.close()
            other.create_entry(_entry(P, "/e/post", seed=10))
            _wait(lambda: other.meta_plane._holder, msg="takeover")
            _wait(lambda: other.store.find_entry("/e/post") is not None,
                  msg="post-takeover apply")
            out = [_row(other.find_entry("/e/pre")),
                   _row(other.find_entry("/e/post"))]
        finally:
            for f in (a, b):
                try:
                    f.close()
                except Exception:   # the holder closed already
                    pass
        return out + [_rows(db)]
    _both(case, tmp_path)


def test_meta_cache_stays_coherent_across_siblings(tmp_path):
    def case(P, d):
        db = os.path.join(d, "f.db")
        a = _filer(P, db, interval_ms=3600_000)
        b = _filer(P, db, interval_ms=3600_000)
        try:
            assert a.meta_cache is not None and b.meta_cache is not None
            a.create_entry(_entry(P, "/c/hot", seed=11, mime="v1"))
            out = [b.find_entry("/c/hot").attributes.mime]
            a.create_entry(_entry(P, "/c/hot", seed=11, mime="v2"))
            out.append(b.find_entry("/c/hot").attributes.mime)
            # unrelated fills SURVIVE the sibling commit
            b.create_entry(_entry(P, "/c/cold", seed=12))
            b.find_entry("/c/cold")
            before = b.meta_cache.snapshot()["epoch"]
            a.create_entry(_entry(P, "/c/other", seed=13))
            b.find_entry("/c/other")      # ingests the sibling event
            out.append(b.meta_cache.snapshot()["epoch"] - before <= 2)
        finally:
            a.close()
            b.close()
        return out + [_rows(db)]
    out = _both(case, tmp_path)
    assert out[:3] == ["v1", "v2", True]


# -- stores, the kill switch and the metrics ------------------------------

def test_memory_and_ephemeral_stores_stay_synchronous(tmp_path):
    def case(P, d):
        f = P["Filer"](MASTER)
        f2 = P["Filer"](MASTER, P["SqliteStore"](":memory:"),
                        meta_log_dir=os.path.join(d, "ml"))
        out = [f.meta_plane is None, f2.meta_plane is None]
        f2.create_entry(_entry(P, "/s/x", seed=14))
        out.append(_row(f2.store.find_entry("/s/x")))
        f.close()
        f2.close()
        return out
    out = _both(case, tmp_path)
    assert out[0] and out[1] and out[2] is not None


def test_kill_switch_and_plane_produce_identical_state(tmp_path):
    def case(P, d):
        scripts = {}
        for mode, name in (("1", "on"), ("0", "off")):
            os.environ["SEAWEEDFS_TPU_FILER_META_PLANE"] = mode
            try:
                db = os.path.join(d, f"{name}.db")
                f = _filer(P, db)
                assert (f.meta_plane is not None) == (mode == "1")
                f.create_entry(_entry(P, "/s/a", seed=15, mime="t/a"))
                f.create_entry(_entry(P, "/s/b", seed=16))
                f.rename("/s/b", "/s/c")
                f.delete_entry("/s/a", delete_chunks=False)
                f.update_attrs("/s/c", mode=0o640)
                listing = [_row(e) for e in f.list_directory("/s",
                                                             limit=10)]
                ops = [e["op"] for e in f.events_since(0)]
                f.close()
                scripts[name] = (listing, ops, _rows(db))
            finally:
                os.environ.pop("SEAWEEDFS_TPU_FILER_META_PLANE", None)
        assert scripts["on"] == scripts["off"], scripts
        return scripts["on"]
    _both(case, tmp_path)


def test_serialize_once_metrics_present(tmp_path):
    def case(P, d):
        f = _filer(P, os.path.join(d, "f.db"), interval_ms=5)
        try:
            for i in range(5):
                f.create_entry(_entry(P, f"/mx/{i}", seed=i))
            _wait(lambda: f.meta_plane.snapshot()["overlay"] == 0,
                  msg="drain")
        finally:
            f.close()
        text = P["stats"].PROCESS.render()
        return [f'filer_meta_sub_seconds_count{{stage="{stage}"}}' in text
                for stage in ("serialize", "barrier", "apply")] + \
            ["meta_plane_applied_total" in text,
             'meta_plane_apply_batch_bucket{le="1.0"}' in text]
    assert all(_both(case, tmp_path))


# -- across the packages --------------------------------------------------

def _script(P, f):
    """One mutation sequence: creates in two directories, an update, a
    rename and a delete."""
    for i in range(16):
        f.create_entry(_entry(P, f"/x/d{i % 2}/f{i:02d}", seed=40 + i))
    f.update_attrs("/x/d0/f02", uid=7)
    f.rename("/x/d1/f03", "/x/d0/moved")
    f.delete_entry("/x/d1/f05", delete_chunks=False)


def _copy(src_db: str, dst_dir: str) -> str:
    os.makedirs(dst_dir)
    db = os.path.join(dst_dir, "f.db")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(src_db + suffix):
            shutil.copy(src_db + suffix, db + suffix)
    shutil.copytree(src_db + ".metalog", db + ".metalog")
    return db


def test_a_jax_planed_log_with_a_lagging_checkpoint_boots_in_the_port(
        tmp_path):
    """A JAX filer acks through its plane with the applier stalled and
    dies: the port boots over its log, reads the tail at once from the
    overlay, and applies it to the rows the JAX package's own boot gives."""
    db = os.path.join(str(tmp_path), "w", "f.db")
    os.makedirs(os.path.dirname(db))
    f = _filer(JAX, db, interval_ms=3600_000)
    _script(JAX, f)
    assert f.store.find_entry("/x/d0/f00") is None   # acked, not applied
    _abandon(f)
    ref_db = _copy(db, os.path.join(str(tmp_path), "ref"))
    rows = {}
    for P, where in ((PORT, db), (JAX, ref_db)):
        g = _filer(P, where, interval_ms=10)
        try:
            assert g.meta_plane is not None
            seen = [_row(g.find_entry("/x/d0/moved")),
                    [e.name for e in g.list_directory("/x/d1")]]
            _wait(lambda: g.meta_plane.snapshot()["overlay"] == 0,
                  msg="boot apply")
            ck = P["meta_plane"].read_checkpoint(where + ".metalog")
            assert ck[1] == g.meta_log.last_ts()
        finally:
            g.close()
        rows[P is PORT] = (seen, _rows(where))
    assert rows[True] == rows[False]
    assert rows[True][0][0]["attributes"]["uid"] == _attrs(43)["uid"]
    assert "f05" not in rows[True][0][1] and "f03" not in rows[True][0][1]


def test_a_port_planed_log_with_a_stalled_applier_boots_in_the_jax_package(
        tmp_path):
    """The port acks through its plane with the applier stalled and dies:
    the JAX package's kill-switch boot (`recover_sync`) applies the tail
    into the rows the port's own boot gives."""
    db = os.path.join(str(tmp_path), "w", "f.db")
    os.makedirs(os.path.dirname(db))
    f = _filer(PORT, db, interval_ms=3600_000)
    _script(PORT, f)
    assert f.store.find_entry("/x/d0/f00") is None
    _abandon(f)
    port_db = _copy(db, os.path.join(str(tmp_path), "port"))
    os.environ["SEAWEEDFS_TPU_FILER_META_PLANE"] = "0"
    try:
        g = _filer(JAX, db)
        assert g.meta_plane is None
        g.close()
    finally:
        os.environ.pop("SEAWEEDFS_TPU_FILER_META_PLANE", None)
    h = _filer(PORT, port_db, interval_ms=10)
    try:
        _wait(lambda: h.meta_plane.snapshot()["overlay"] == 0,
              msg="port boot apply")
    finally:
        h.close()
    jax_rows, port_rows = _rows(db), _rows(port_db)
    assert jax_rows == port_rows
    names = {(d, n) for d, n, _m in jax_rows}
    assert ("/x/d0", "moved") in names and ("/x/d1", "f05") not in names
    assert len([1 for d, _n, _m in jax_rows if d.startswith("/x/d")]) == 15
    log, store = RefMetaLog(db + ".metalog"), RefSqliteStore(db)
    assert ref_meta_plane.recover_sync(log, store) == 0  # nothing left
    store.close()
    log.close()


@pytest.mark.parametrize("trial", range(4))
def test_concurrent_creates_in_a_fresh_directory_stay_visible(tmp_path,
                                                              trial):
    """The fresh-directory record holds with the plane on: writers
    creating files at once in a directory none of them has seen find
    every acked file afterwards, through the overlay and after the
    applier drained it (the directory is registered before its commit,
    and a later create never resets the record)."""
    import sys
    db = os.path.join(str(tmp_path), "f.db")
    f = _filer(PORT, db)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=f.create_entry,
                               args=(_entry(PORT, f"/fresh{trial}/n{i:03d}",
                                            seed=i),))
              for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    try:
        for when in ("overlay", "applied"):
            assert [i for i in range(12) if f.find_entry(
                f"/fresh{trial}/n{i:03d}") is None] == [], when
            assert len(f.list_directory(f"/fresh{trial}")) == 12, when
            _wait(lambda: f.meta_plane.snapshot()["overlay"] == 0,
                  msg="drain")
    finally:
        f.close()


def test_own_batch_extents_and_the_cache_capacity(tmp_path, monkeypatch):
    """The metalog records each barrier write of its own lines, so the
    follower skips them by arithmetic (`own_extent_at` from the segment's
    start reaches `durable_pos`, and consumes the records); the meta
    cache holds the capacity SEAWEEDFS_TPU_FILER_META_CACHE sets, LRU
    first."""
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_CACHE", "2")

    def case(P, d):
        db = os.path.join(d, "f.db")
        f = _filer(P, db, interval_ms=3600_000)
        try:
            log = f.meta_log
            f.meta_plane._cursor._skip_fn = None   # leave the records
            for i in range(6):
                f.create_entry(_entry(P, f"/ob/f{i}", seed=i))
            day, minute, end = log.durable_pos()
            out = [log.own_extent_at(day, minute, 0) == end,
                   log.own_extent_at(day, minute, 0)]
            mc = f.meta_cache
            for i in range(6):
                mc.fill_entry(f"/ob/f{i}", _entry(P, f"/ob/f{i}", seed=i),
                              mc.begin_fill())
            out += [len(mc._entries), sorted(mc._entries)]
        finally:
            f.close()
        return out
    assert _both(case, tmp_path) == [True, None, 2, ["/ob/f4", "/ob/f5"]]
