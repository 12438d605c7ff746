"""Config 5's read path in the port, on the CPU, held against the JAX
package.  Tolerance: exact equality of bytes, counts and hits.

- `ops/rs_native.ReedSolomonNative` (the port's copy of the GFNI/AVX2
  C++ codec) against the JAX package's numpy `rs_cpu.ReedSolomonCPU` and
  its `rs_native`: parity, verify and reconstruct for RS(10,4) and
  RS(6,3), every loss pattern up to p, odd lengths, the threaded path's
  tail.  The native cases skip only where g++ is missing;
- `util/chunk_cache.TieredChunkCache` against the JAX package's on one
  seeded sequence of get, set, delete and invalidate_group calls, memory
  tier alone and with the disk tier: the same answers, hits, misses,
  evictions and invalidations;
- the volume server's hot-needle cache: a repeated read is a hit, a
  write, a delete and an EC delete invalidate the needle, unmount,
  `delete_shards` and `to_volume` drop the volume's generation, a wrong
  cookie stays a 404, a fill that raced an invalidation never serves the
  stale needle (and a threaded stress of writers and readers ends on the
  last write), and a degraded decode is promoted unless
  `SEAWEEDFS_TPU_DEGRADED_PROMOTE=0`;
- `EcReader` prefers the native codec and counts the engine of every
  rebuilt interval;
- RS(6,3) end to end through a port cluster of 4 servers: the shell's
  `ec.encode -dataShards=6 -parityShards=3` writes shards byte-identical
  to the JAX pipeline's, then degraded reads with the 3 shards of a
  stopped server lost, `ec.rebuild` and `ec.decode`, every needle equal
  to the JAX package's read of the original volume.
"""

import itertools
import os
import shutil
import sys
import threading
import uuid

import numpy as np
import pytest

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.ops import rs_cpu as ref_rs_cpu
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.util import chunk_cache as ref_chunk_cache
from seaweedfs_tpu_torch import native, stats
from seaweedfs_tpu_torch.ops import rs_cpu, rs_native
from seaweedfs_tpu_torch.server import store_ec
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.util import chunk_cache

from test_torch_cluster_shell import VID, Cluster, _read
from test_torch_cluster_shell import small_sizes  # noqa: F401
from test_torch_ec_read import _jax_encode, _lost_intervals, _seeded_volume

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++: the native codec cannot build")

SCHEMES = [(10, 4), (6, 3)]
SCHEME_IDS = ["rs10_4", "rs6_3"]


# --- the native host codec -------------------------------------------------

@needs_gxx
@pytest.mark.parametrize("d,p", SCHEMES, ids=SCHEME_IDS)
def test_native_parity_and_verify_match_reference(d, p):
    from seaweedfs_tpu.ops import rs_native as ref_rs_native
    rng = np.random.default_rng(d)
    port = rs_native.ReedSolomonNative(d, p)
    ref = ref_rs_cpu.ReedSolomonCPU(d, p)
    for n in (1, 63, 64, 1_000_003 % 4097, 65_537):
        data = rng.integers(0, 256, (d, n), dtype=np.uint8)
        want = ref.parity(data)
        assert np.array_equal(port.parity(data), want), n
        if ref_rs_native.available():
            assert np.array_equal(
                ref_rs_native.ReedSolomonNative(d, p).parity(data), want)
        full = np.concatenate([data, want])
        assert np.array_equal(port.encode(full), ref.encode(full))
        assert port.verify(full) and ref.verify(full)
        full[d + n % p, n // 2] ^= 1
        assert not port.verify(full) and not ref.verify(full)
        mat = rng.integers(0, 256, (p, d), dtype=np.uint8)
        assert np.array_equal(port.apply_matrix(mat, data),
                              rs_cpu.ReedSolomonCPU(d, p).apply_matrix(
                                  mat, data))


@needs_gxx
@pytest.mark.parametrize("d,p,lost", [(d, p, n) for d, p in SCHEMES
                                      for n in range(1, p + 1)],
                         ids=[f"rs{d}_{p}-lost{n}" for d, p in SCHEMES
                              for n in range(1, p + 1)])
def test_native_reconstruct_every_loss_matches_reference(d, p, lost):
    """Every pattern of `lost` of the d+p shards, on an odd length, full
    and data-only, against the JAX package's numpy codec."""
    rng = np.random.default_rng(100 * d + lost)
    total = d + p
    port = rs_native.ReedSolomonNative(d, p)
    ref = ref_rs_cpu.ReedSolomonCPU(d, p)
    n = 333
    data = rng.integers(0, 256, (d, n), dtype=np.uint8)
    full = ref.encode(np.concatenate([data, np.zeros((p, n), np.uint8)]))
    for gone in itertools.combinations(range(total), lost):
        present = [i not in gone for i in range(total)]
        damaged = full.copy()
        damaged[list(gone)] = rng.integers(0, 256, (lost, n),
                                           dtype=np.uint8)
        got = port.reconstruct(damaged, present)
        assert np.array_equal(got, full), gone
        assert np.array_equal(got, ref.reconstruct(damaged, present))
        assert np.array_equal(
            port.reconstruct(damaged, present, data_only=True),
            ref.reconstruct(damaged, present, data_only=True)), gone


@needs_gxx
def test_native_threaded_tail_matches_reference():
    """A call large enough to split over threads (one a ~4 MiB), with a
    length that leaves the last thread a ragged tail."""
    rng = np.random.default_rng(7)
    n = (8 << 20) + 4093
    data = rng.integers(0, 256, (6, n), dtype=np.uint8)
    got = rs_native.ReedSolomonNative(6, 3).parity(data)
    want = ref_rs_cpu.ReedSolomonCPU(6, 3).parity(data)
    assert np.array_equal(got[:, -70_000:], want[:, -70_000:])
    assert np.array_equal(got, want)


@needs_gxx
def test_native_builds_and_names_its_tier():
    assert rs_native.available()
    assert rs_native.gf_native_simd() in rs_native.SIMD_TIERS.values()
    path = native.BUILD_INFO["gf_rs"]["path"]
    assert path.startswith(native.BUILD_DIR) and os.path.exists(path)


def test_reader_prefers_native_and_counts_its_engine(monkeypatch):
    reader = store_ec.EcReader("", "self:1")
    try:
        codec = reader._codec(6, 3)
        if rs_native.available():
            assert isinstance(codec, rs_native.ReedSolomonNative)
            assert reader.engine_of(codec) == (
                "native", rs_native.gf_native_simd())
        monkeypatch.setattr(rs_native, "available", lambda: False)
        cpu = reader._codec(4, 2)
        assert isinstance(cpu, rs_cpu.ReedSolomonCPU)
        before = stats.PROCESS.counter_value(
            "ec_degraded_codec_intervals_total", engine="numpy",
            simd="") or 0.0
        reader._note_engine(cpu)
        assert stats.PROCESS.counter_value(
            "ec_degraded_codec_intervals_total", engine="numpy",
            simd="") == before + 1
    finally:
        reader.close()


# --- the tiered cache against the JAX package's ---------------------------

COUNTERS = ("read_cache_hits_total", "read_cache_misses_total",
            "read_cache_evictions_total", "read_cache_invalidations_total")


@pytest.mark.parametrize("disk", [False, True], ids=["mem", "mem_disk"])
def test_tiered_cache_replays_like_reference(tmp_path, disk):
    name = f"t{uuid.uuid4().hex[:8]}"
    kw = dict(mem_limit=6000, disk_limit=12000, name=name)
    port = chunk_cache.TieredChunkCache(
        disk_dir=str(tmp_path / "port") if disk else None, **kw)
    ref = ref_chunk_cache.TieredChunkCache(
        disk_dir=str(tmp_path / "ref") if disk else None, **kw)
    rng = np.random.default_rng(42 + disk)
    keys = [f"k{i}" for i in range(40)]
    for step in range(3000):
        op = rng.integers(0, 10)
        key = keys[rng.integers(0, len(keys))]
        if op < 5:
            assert port.get(key) == ref.get(key), (step, key)
        elif op < 8:
            data = rng.bytes(int(rng.integers(50, 2500)))
            group = f"g{rng.integers(0, 6)}"
            port.set(key, data, group=group)
            ref.set(key, data, group=group)
        elif op < 9:
            port.delete(key)
            ref.delete(key)
        else:
            group = f"g{rng.integers(0, 6)}"
            port.invalidate_group(group)
            ref.invalidate_group(group)
    for key in keys:
        assert port.get(key) == ref.get(key), key
    got = [stats.PROCESS.counter_value(c, cache=name) for c in COUNTERS]
    want = [ref_stats.PROCESS.counter_value(c, cache=name) for c in COUNTERS]
    assert got == want and all(got)


def test_cache_knobs_keep_the_reference_names(monkeypatch):
    for var, value in (("SEAWEEDFS_TPU_READ_CACHE_MB", "0"),
                       ("SEAWEEDFS_TPU_READ_CACHE_DIR", "/x"),
                       ("SEAWEEDFS_TPU_READ_CACHE_DISK_MB", "7")):
        monkeypatch.setenv(var, value)
    assert chunk_cache.read_cache_mb(64) == ref_chunk_cache.read_cache_mb(
        64) == 0
    assert chunk_cache.read_cache_disk() == \
        ref_chunk_cache.read_cache_disk() == ("/x", 7)
    monkeypatch.delenv("SEAWEEDFS_TPU_READ_CACHE_MB")
    assert chunk_cache.read_cache_mb(64) == 64


# --- the volume server's hot-needle cache ---------------------------------

def _count(name: str, **labels) -> float:
    return stats.PROCESS.counter_value(name, **labels) or 0.0


def _hits_misses() -> "tuple[float, float]":
    return (_count("read_cache_hits_total", cache="volume_needle"),
            _count("read_cache_misses_total", cache="volume_needle"))


def _fid(nid: int, cookie: "int | None" = None) -> str:
    return str(types.FileId(VID, nid, nid * 7 + 1 if cookie is None
                            else cookie))


def _get(url: str, nid: int, cookie: "int | None" = None, headers=None):
    return http_bytes("GET", f"{url}/{_fid(nid, cookie)}", timeout=30,
                      headers=headers)


@pytest.fixture
def normal_server(tmp_path):
    """A standalone port server holding volume 1 of seeded needles."""
    d = tmp_path / "v"
    d.mkdir()
    payloads = _seeded_volume(d, target=200_000, lo=100, hi=20_000, seed=3)
    vs = VolumeServer([str(d)], device="cpu").start()
    try:
        yield vs, payloads
    finally:
        vs.stop()


def test_second_read_is_a_hit(normal_server):
    vs, payloads = normal_server
    nid = 5
    h0, m0 = _hits_misses()
    st, body, hdrs = _get(vs.url, nid)
    assert (st, body) == (200, payloads[nid])
    assert _hits_misses() == (h0, m0 + 1)
    st, body2, hdrs2 = _get(vs.url, nid)
    assert (st, body2) == (200, payloads[nid])
    assert hdrs2["Content-Type"] == hdrs["Content-Type"] == "image/png"
    assert _hits_misses() == (h0 + 1, m0 + 1)
    st, part, h = _get(vs.url, nid, headers={"Range": "bytes=3-9"})
    assert (st, part) == (206, payloads[nid][3:10])
    assert h["Content-Range"] == f"bytes 3-9/{len(payloads[nid])}"
    assert _hits_misses() == (h0 + 2, m0 + 1)
    text = http_bytes("GET", f"{vs.url}/metrics")[1].decode()
    assert 'seaweedfs_tpu_read_cache_hits_total{cache="volume_needle"}' \
        in text


def test_wrong_cookie_stays_404_after_a_fill(normal_server):
    vs, payloads = normal_server
    assert _get(vs.url, 3)[1] == payloads[3]
    assert _get(vs.url, 3, cookie=12345)[0] == 404
    assert _get(vs.url, 3)[1] == payloads[3]


@pytest.mark.parametrize("change", ["write", "delete"])
def test_write_and_delete_invalidate_the_needle(normal_server, change):
    vs, payloads = normal_server
    nid = 7
    assert _get(vs.url, nid)[1] == payloads[nid]
    assert _get(vs.url, nid)[1] == payloads[nid]      # cached
    if change == "write":
        st, _b, _h = http_bytes("POST", f"{vs.url}/{_fid(nid)}", b"fresh",
                                timeout=30)
        assert st == 201
        assert _get(vs.url, nid)[1] == b"fresh"
    else:
        st, _b, _h = http_bytes("DELETE", f"{vs.url}/{_fid(nid)}",
                                timeout=30)
        assert st == 202
        assert _get(vs.url, nid)[0] == 404


@pytest.mark.parametrize("route", ["unmount", "delete"])
def test_volume_routes_drop_the_generation(normal_server, route):
    vs, payloads = normal_server
    assert _get(vs.url, 2)[1] == payloads[2]
    gen = vs._nc_gen.get(VID, 0)
    http_json("POST", f"{vs.url}/admin/{route}_volume", {"volumeId": VID},
              timeout=30)
    assert vs._nc_gen[VID] == gen + 1
    assert _get(vs.url, 2)[0] == 404


def test_a_fill_that_raced_an_invalidation_is_dropped(normal_server):
    """A read that began before a write must not cache its needle after
    the write's invalidation: checked before the insert, and again after
    it, for an invalidation that lands inside the insert."""
    vs, payloads = normal_server
    fid = types.parse_file_id(_fid(4))
    stale = Needle(cookie=fid.cookie, id=4, data=b"stale")
    token = vs._nc_epoch
    vs._nc_invalidate_needle(VID, 4)
    vs._nc_put(fid, stale, token)
    assert vs._nc_get(fid) is None
    real_set = vs.needle_cache.set

    def set_then_invalidate(key, data, group=""):
        real_set(key, data, group=group)
        # the write's invalidation wipes the group before the key
        # joined it in a real race; here right after the insert
        with vs._nc_gen_lock:
            vs._nc_epoch += 1
    vs.needle_cache.set = set_then_invalidate
    try:
        vs._nc_put(fid, stale, vs._nc_epoch)
    finally:
        vs.needle_cache.set = real_set
    assert vs._nc_get(fid) is None
    assert _get(vs.url, 4)[1] == payloads[4]


def test_writers_and_readers_end_on_the_last_write(normal_server):
    """Threaded stress (more threads than cores, a short switch
    interval): writers rewrite one needle while readers fill the cache;
    once the writers are done, every read answers the last write."""
    vs, _payloads = normal_server
    nid = 9
    versions = [f"v{i}".encode() * 50 for i in range(40)]
    lock = threading.Lock()
    written = []
    stop = threading.Event()

    def writer(part):
        for body in part:
            with lock:
                st = http_bytes("POST", f"{vs.url}/{_fid(nid)}", body,
                                timeout=30)[0]
                assert st == 201
                written.append(body)

    def reader():
        while not stop.is_set():
            st, body, _ = _get(vs.url, nid)
            assert st == 200 and (body in versions or body == _payloads[nid])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=reader) for _ in range(8)]
        writers = [threading.Thread(target=writer, args=(versions[i::2],))
                   for i in range(2)]
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join(timeout=120)
        stop.set()
        for t in readers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in readers + writers)
    finally:
        sys.setswitchinterval(old)
    for _ in range(3):
        assert _get(vs.url, nid)[1] == written[-1]


@pytest.fixture
def ec_server(tmp_path):
    """A port master and one port server holding volume 1 as an RS(6,3)
    EC volume (all 9 shards local; its needles in the first 1 MiB block
    live on data shard 0)."""
    d = tmp_path / "v"
    d.mkdir()
    payloads = _seeded_volume(d, target=300_000, lo=100, hi=20_000, seed=4)
    master = MasterServer(pulse_seconds=1.0).start()
    vs = VolumeServer([str(d)], device="cpu", master=master.url,
                      pulse_seconds=0.2).start()
    try:
        for path, body in (
                ("/admin/set_readonly", {"volumeId": VID}),
                ("/admin/ec/generate", {"volumeId": VID, "dataShards": 6,
                                        "parityShards": 3}),
                ("/admin/ec/mount", {"volumeId": VID,
                                     "shardIds": list(range(9))}),
                ("/admin/delete_volume", {"volumeId": VID})):
            r = http_json("POST", f"{vs.url}{path}", body, timeout=60)
            assert "error" not in r, (path, r)
        assert vs.store.find_ec_volume(VID) is not None
        yield vs, payloads
    finally:
        vs.stop()
        master.stop()


def test_ec_delete_invalidates_the_needle(ec_server):
    vs, payloads = ec_server
    assert _get(vs.url, 6)[1] == payloads[6]
    h0, _m = _hits_misses()
    assert _get(vs.url, 6)[1] == payloads[6]
    assert _hits_misses()[0] == h0 + 1
    st, _b, _h = http_bytes("DELETE", f"{vs.url}/{_fid(6)}", timeout=30)
    assert st == 202
    assert _get(vs.url, 6)[0] == 404


@pytest.mark.parametrize("route", ["unmount", "delete_shards", "to_volume"])
def test_ec_routes_drop_the_generation(ec_server, route):
    vs, payloads = ec_server
    assert _get(vs.url, 8)[1] == payloads[8]
    gen = vs._nc_gen.get(VID, 0)
    body = {"volumeId": VID}
    if route == "delete_shards":
        body["shardIds"] = [0]
    r = http_json("POST", f"{vs.url}/admin/ec/{route}", body, timeout=60)
    assert "error" not in r, r
    assert vs._nc_gen[VID] == gen + 1
    h0, m0 = _hits_misses()
    st, data, _ = _get(vs.url, 8)
    if route == "unmount":
        assert st == 404
    else:
        # a degraded decode, or the decoded normal volume: a miss
        assert (st, data) == (200, payloads[8])
        assert _hits_misses() == (h0, m0 + 1)


@pytest.mark.parametrize("promote", ["1", "0"], ids=["promote", "no_promote"])
def test_degraded_decode_is_promoted(ec_server, monkeypatch, promote):
    vs, payloads = ec_server
    monkeypatch.setenv("SEAWEEDFS_TPU_DEGRADED_PROMOTE", promote)
    r = http_json("POST", f"{vs.url}/admin/ec/delete_shards",
                  {"volumeId": VID, "shardIds": [0]}, timeout=30)
    assert "error" not in r
    engine = ("native", rs_native.gf_native_simd()) \
        if rs_native.available() else ("numpy", "")
    d0 = _count("ec_degraded_reads_total", vid=VID)
    e0 = _count("ec_degraded_codec_intervals_total", engine=engine[0],
                simd=engine[1])
    h0, m0 = _hits_misses()
    for _ in range(2):
        assert _get(vs.url, 1)[1] == payloads[1]
    reads = 1 if promote == "1" else 2
    assert _count("ec_degraded_reads_total", vid=VID) == d0 + reads
    assert _count("ec_degraded_codec_intervals_total", engine=engine[0],
                  simd=engine[1]) == e0 + reads
    assert _hits_misses() == (h0 + 2 - reads, m0 + reads)


# --- RS(6,3) end to end through a port cluster ----------------------------

def test_rs_6_3_cluster_matches_reference(tmp_path):
    d, p = 6, 3
    vol = tmp_path / "vol"
    vol.mkdir()
    payloads = _seeded_volume(vol, target=3 << 20, lo=1000, hi=300_000,
                              seed=63)
    files = {ext: _read(str(vol / f"{VID}{ext}")) for ext in (".dat", ".idx")}
    # the JAX pipeline's shards and the JAX package's reads of the volume
    ref_dir = tmp_path / "ref"
    shutil.copytree(vol, ref_dir)
    _jax_encode(str(ref_dir / str(VID)), d, p)
    ref_files = {n: _read(str(ref_dir / n)) for n in os.listdir(ref_dir)
                 if ".ec" in n or n.endswith(".vif")}
    rv = RefVolume(str(vol), VID)
    ref_reads = {nid: bytes(rv.read_needle(nid).data) for nid in payloads}
    rv.close()
    assert ref_reads == payloads
    cluster = Cluster(tmp_path, "port", ["port"] * 4, files)
    try:
        out = cluster.shell(f"ec.encode -volumeId={VID} -dataShards={d} "
                            f"-parityShards={p}")
        assert "scatter-encoded 9 shards" in out, out
        locs = cluster.ec_locations()
        assert sorted(s for sids in locs.values() for s in sids) == \
            list(range(d + p))

        def check_shards():
            seen = {}
            for dd, names in cluster.shard_files().items():
                for name, data in names.items():
                    if name in ref_files:   # shards, .ecx, .vif
                        assert data == ref_files[name], (dd, name)
                        seen.setdefault(name, dd)
            assert {f"{VID}.ec{s:02d}" for s in range(d + p)} <= set(seen)
        check_shards()

        def read_all(reader):
            for nid, want in ref_reads.items():
                st, body, _ = _get(reader.url, nid)
                assert (st, body) == (200, want), nid
        # the server holding the most data shards goes away with its disk
        # (3 of the 9 shards); the reader is another holder
        victim = max(locs, key=lambda u: sum(s < d for s in locs[u]))
        assert len(locs[victim]) <= p
        reader = next(vs for vs in cluster.servers
                      if vs.url in locs and vs.url != victim)
        ev = reader.store.find_ec_volume(VID)
        lost = _lost_intervals(ev, payloads, set(locs[victim]))
        assert lost
        cluster.stop_server_with_disk(
            [vs.url for vs in cluster.servers].index(victim))
        d0 = _count("ec_degraded_reads_total", vid=VID)
        read_all(reader)
        assert _count("ec_degraded_reads_total", vid=VID) - d0 == \
            sum(len(v) for v in lost.values())
        h0, _m = _hits_misses()
        read_all(reader)                       # promoted decodes
        assert _count("ec_degraded_reads_total", vid=VID) - d0 == \
            sum(len(v) for v in lost.values())
        assert _hits_misses()[0] - h0 == len(payloads)
        # ec.rebuild: the lost shards again, equal to the JAX pipeline's
        out = cluster.shell(f"ec.rebuild -volumeId={VID}")
        assert f"rebuilt shards {sorted(locs[victim])} on " in out, out
        cluster.wait(lambda: sorted(
            s for sids in cluster.ec_locations().values() for s in sids) ==
            list(range(d + p)), "9 shards listed")
        check_shards()
        for vs in cluster.servers:
            if vs.url != victim and vs.store.find_ec_volume(VID):
                vs.ec_reader.forget(VID)
                vs._nc_drop_volume(VID)
        d1 = _count("ec_degraded_reads_total", vid=VID)
        read_all(reader)
        assert _count("ec_degraded_reads_total", vid=VID) == d1
        # ec.decode: a normal volume again, its .dat the original's
        out = cluster.shell(f"ec.decode -volumeId={VID}")
        assert "decoded to normal volume on " in out, out
        target = next(vs for vs in cluster.servers
                      if vs.url in out and vs.url != victim)
        cluster.wait(lambda: VID in cluster.normal_volumes(),
                     "volume 1 listed again")
        dat = os.path.join(cluster.dirs[cluster.servers.index(target)],
                           f"{VID}.dat")
        assert _read(dat) == files[".dat"]
        read_all(target)
    finally:
        cluster.close()


def test_smoke_read_pass_counters_parse_metrics():
    """chip_smoke.py's read_load phase reads its counters off /metrics
    text: the parser sums a metric's samples over label sets."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    text = ('seaweedfs_tpu_gf_kernel_launches{entry="gf_apply_words"} 3.0\n'
            'seaweedfs_tpu_gf_kernel_launches{entry="b"} 2.0\n'
            'seaweedfs_tpu_ec_degraded_reads_total{vid="1"} 4.0\n'
            'seaweedfs_tpu_deadline_remaining_seconds_sum{site="volume"} '
            '1.5\n')
    assert sum(v for _, v in chip_smoke._samples(
        text, "gf_kernel_launches")) == 5.0
    assert chip_smoke._samples(text, "ec_degraded_reads_total") == \
        [({"vid": "1"}, 4.0)]
    assert chip_smoke._samples(
        text, "deadline_remaining_seconds_sum")[0][1] == 1.5
