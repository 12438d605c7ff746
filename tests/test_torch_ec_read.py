"""The port's EC read path on the CPU, held against the JAX package's.
Tolerance: exact equality of bytes, intervals, index files and output
lines.

- `ec_locate.locate_data` over a grid of shard sizes and offsets at
  block borders, d in {4, 6, 10};
- `ops/rs_cpu.ReedSolomonCPU` (encode, parity, apply_matrix, verify,
  reconstruct with 1..p losses, `data_only` both ways) for RS(10,4),
  RS(6,3) and RS(4,2);
- `EcVolume` over shards the JAX pipeline wrote with shrunk blocks
  (large 4 KiB, small 1 KiB, patched in both packages' encoder,
  decoder, volume and reader): every needle's locate, local read and
  index search; the `.ecx`/`.ecj` bytes after the same deletes;
  `rebuild_ecx_file`; the decoded `.idx`; scrub on clean files and on a
  truncated shard; handles closed by unmount and remount;
- `EcReader` through `GET /<fid>` on port volume servers (the cluster of
  `test_torch_cluster_shell.Cluster`, a ~3 MiB volume with the real
  1 MiB small blocks, scatter-encoded by the port's shell) for the three
  schemes: direct and remote reads, then with a data-shard holder
  stopped the one-shot degraded read, the streamed one (the one-shot
  path made to fail), reads with degraded reads switched off (404), and
  the reader's counters;
- a cluster that mixes port and JAX volume servers: the port's reader
  over JAX shard holders and the JAX reader over port ones, byte-equal
  to each other and to the payloads, before and after a loss;
- `DELETE /<fid>` on an EC volume (404 on every holder, the id in every
  `.ecj`, `ec.decode`'s `.idx` equal to the JAX decoder's) and
  `ec.scrub` against the JAX shell's output;
- `GET`/`HEAD`/`DELETE` on a normal volume (`Range`, cookie mismatch,
  bad fids), answered as the JAX volume server answers.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.ops import rs_cpu as ref_rs_cpu
from seaweedfs_tpu.server import store_ec as ref_store_ec
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.storage import erasure_coding as ref_ec
from seaweedfs_tpu.storage.erasure_coding import ec_decoder as ref_decoder
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding import ec_locate as ref_locate
from seaweedfs_tpu.storage.erasure_coding.ec_context import (
    ECContext as RefContext)
from seaweedfs_tpu.storage.erasure_coding.ec_volume import (
    EcVolume as RefEcVolume)
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ops import rs_cpu
from seaweedfs_tpu_torch.server import store_ec
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage.erasure_coding import (ec_decoder,
                                                        ec_locate,
                                                        ec_volume)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume

from test_torch_cluster_shell import VID, Cluster, _read
from test_torch_cluster_shell import small_sizes  # noqa: F401

SCHEMES = [(10, 4), (6, 3), (4, 2)]
SCHEME_IDS = ["rs10_4", "rs6_3", "rs4_2"]


def _astuples(intervals):
    return [dataclasses.astuple(iv) for iv in intervals]


# --- geometry and codec ---------------------------------------------------

@pytest.mark.parametrize("d", [4, 6, 10])
def test_locate_data_matches_reference(d):
    large, small = 4096, 1024
    for n_large in (0, 1, 3):
        for tail in (1, small - 1, small, 3 * small + 5):
            shard = n_large * large + tail
            dat = d * shard
            borders = {0, 1, large - 1, large, large + 1, small - 1,
                       small, d * large - 1, d * large,
                       n_large * d * large - 1, n_large * d * large,
                       n_large * d * large + small - 1,
                       n_large * d * large + small}
            for off in sorted(b for b in borders if 0 <= b < dat):
                for size in (1, 7, small, small + 1, large + 3,
                             d * large + 11):
                    size = min(size, dat - off)
                    got = ec_locate.locate_data(large, small, shard, off,
                                                size, d)
                    want = ref_locate.locate_data(large, small, shard, off,
                                                  size, d)
                    assert _astuples(got) == _astuples(want), \
                        (n_large, tail, off, size)
                    assert sum(iv.size for iv in got) == size
                    assert [iv.to_shard_id_and_offset(large, small, d)
                            for iv in got] == \
                        [iv.to_shard_id_and_offset(large, small, d)
                         for iv in want]


@pytest.mark.parametrize("d,p", SCHEMES, ids=SCHEME_IDS)
def test_rs_cpu_matches_reference(d, p):
    rng = np.random.default_rng(d * 10 + p)
    port, ref = rs_cpu.ReedSolomonCPU(d, p), ref_rs_cpu.ReedSolomonCPU(d, p)
    shards = np.zeros((d + p, 4099), dtype=np.uint8)
    shards[:d] = rng.integers(0, 256, size=(d, 4099), dtype=np.uint8)
    enc = port.encode(shards)
    assert np.array_equal(enc, ref.encode(shards))
    assert np.array_equal(port.parity(shards[:d]), ref.parity(shards[:d]))
    assert port.verify(enc) and ref.verify(enc)
    bad = enc.copy()
    bad[d, 17] ^= 1
    assert not port.verify(bad)
    mat = rng.integers(0, 256, size=(3, d), dtype=np.uint8)
    assert np.array_equal(port.apply_matrix(mat, enc[:d]),
                          ref.apply_matrix(mat, enc[:d]))
    for n_lost in range(1, p + 1):
        for trial in range(3):
            lost = sorted(rng.choice(d + p, size=n_lost, replace=False))
            present = [i not in lost for i in range(d + p)]
            damaged = enc.copy()
            damaged[lost] = 0
            for data_only in (False, True):
                got = port.reconstruct(damaged, present, data_only=data_only)
                want = ref.reconstruct(damaged, present,
                                       data_only=data_only)
                assert np.array_equal(got, want), (lost, data_only)
                rows = [i for i in range(d + p)
                        if i < d or not data_only or present[i]]
                assert np.array_equal(got[rows], enc[rows]), lost


# --- EcVolume over the JAX pipeline's files --------------------------------

@pytest.fixture
def shrunk_blocks(monkeypatch):
    """Large blocks of 4 KiB and small of 1 KiB in every module of both
    packages that reads them by name, so writer and readers agree."""
    for mod in (ref_ec.ec_encoder, ref_ec.ec_decoder, ref_ec.ec_volume,
                ref_store_ec, ec_volume, store_ec):
        monkeypatch.setattr(mod, "LARGE_BLOCK_SIZE", 4096)
        monkeypatch.setattr(mod, "SMALL_BLOCK_SIZE", 1024)


def _seeded_volume(d, vid=VID, target=60_000, lo=10, hi=3000, seed=0,
                   replica_placement=None) -> "dict[int, bytes]":
    """A volume of seeded needles through the port's Volume; returns the
    payloads by needle id (cookie = id * 7 + 1)."""
    v = Volume(str(d), vid, replica_placement=replica_placement)
    rng = np.random.default_rng(seed)
    payloads = {}
    while v.dat_size() < target:
        nid = len(payloads) + 1
        payloads[nid] = rng.bytes(int(rng.integers(lo, hi)))
        n = Needle(cookie=nid * 7 + 1, id=nid, data=payloads[nid])
        if nid % 5 == 0:
            n.set_mime(b"image/png")
        v.write_needle(n)
    v.close()
    return payloads


def _jax_encode(base: str, d: int, p: int) -> None:
    """.ecx, shards and .vif as the JAX package's volume server writes
    them (its CPU engine)."""
    ctx = RefContext(d, p, backend="cpu")
    ref_encoder.write_sorted_file_from_idx(base)
    ref_encoder.write_ec_files(base, ctx)
    ref_encoder.save_ec_volume_info(base, ctx, os.path.getsize(base + ".dat"),
                                    ref_decoder.read_ec_volume_version(base))


@pytest.fixture(params=SCHEMES, ids=SCHEME_IDS)
def ec_files(request, tmp_path, shrunk_blocks):
    """Two copies of one EC volume written by the JAX pipeline: `port`
    for the port's EcVolume, `ref` for the JAX package's."""
    d, p = request.param
    src = tmp_path / "src"
    src.mkdir()
    payloads = _seeded_volume(src)
    _jax_encode(str(src / str(VID)), d, p)
    for ext in (".dat", ".idx"):   # an EC volume only, as after encode
        os.remove(src / f"{VID}{ext}")
    out = {"payloads": payloads, "scheme": (d, p)}
    for name in ("port", "ref"):
        shutil.copytree(src, tmp_path / name)
        out[name] = str(tmp_path / name)
    return out


def test_ec_volume_reads_match_reference(ec_files):
    ev = ec_volume.EcVolume(ec_files["port"], VID)
    ref = RefEcVolume(ec_files["ref"], VID)
    try:
        assert (ev.ctx.data_shards, ev.ctx.parity_shards) == \
            ec_files["scheme"]
        assert ev.version == ref.version
        assert ev.shard_dat_size() == ref.shard_dat_size()
        for nid, payload in ec_files["payloads"].items():
            got, want = ev.locate_needle(nid), ref.locate_needle(nid)
            assert got[:2] == want[:2]
            assert _astuples(got[2]) == _astuples(want[2])
            assert ev.search_sorted_index(nid) == \
                ref.search_sorted_index(nid)
            n = ev.read_needle_local(nid, cookie=nid * 7 + 1)
            assert n.data == payload == ref.read_needle_local(nid).data
            assert n.mime == (b"image/png" if nid % 5 == 0 else b"")
        with pytest.raises(ValueError, match="cookie"):
            ev.read_needle_local(1, cookie=99)
        with pytest.raises(ec_volume.NotFoundError):
            ev.locate_needle(10 ** 6)
        assert list(ev.walk_index()) == list(ref.walk_index())
    finally:
        ev.close()
        ref.close()


def test_ec_deletes_match_reference(ec_files):
    port_base = os.path.join(ec_files["port"], str(VID))
    ref_base = os.path.join(ec_files["ref"], str(VID))
    ecx_before = _read(port_base + ".ecx")
    ev = ec_volume.EcVolume(ec_files["port"], VID)
    ref = RefEcVolume(ec_files["ref"], VID)
    try:
        for nid in (3, 11, 3, 10 ** 6, 1):
            ev.delete_needle(nid)
            ref.delete_needle(nid)
        for nid in (1, 3, 11):
            assert types.size_is_deleted(ev.locate_needle(nid)[1])
            with pytest.raises(ec_volume.NotFoundError):
                ev.read_needle_local(nid)
        assert ev.read_needle_local(2).data == ec_files["payloads"][2]
    finally:
        ev.close()
        ref.close()
    for ext in (".ecx", ".ecj"):
        assert _read(port_base + ext) == _read(ref_base + ext), ext
    assert _read(port_base + ".ecj") == b"".join(
        n.to_bytes(8, "big") for n in (3, 11, 3, 1))
    ecx_after = _read(port_base + ".ecx")
    # the journal replayed into the index as it was before the deletes
    with open(port_base + ".ecx", "wb") as f:
        f.write(ecx_before)
    with open(ref_base + ".ecx", "wb") as f:
        f.write(ecx_before)
    ev = ec_volume.EcVolume(ec_files["port"], VID)
    ref = RefEcVolume(ec_files["ref"], VID)
    try:
        ev.rebuild_ecx_file()
        ref.rebuild_ecx_file()
    finally:
        ev.close()
        ref.close()
    assert _read(port_base + ".ecx") == ecx_after == _read(ref_base + ".ecx")
    # the decoder's .idx: .ecx entries minus the journal
    ec_decoder.write_idx_file_from_ec_index(port_base)
    ref_decoder.write_idx_file_from_ec_index(ref_base)
    assert _read(port_base + ".idx") == _read(ref_base + ".idx")


def test_ec_scrub_matches_reference(ec_files):
    def both():
        ev = ec_volume.EcVolume(ec_files["port"], VID)
        ref = RefEcVolume(ec_files["ref"], VID)
        try:
            got = (ev.scrub_index(), ev.scrub_local())
            want = (ref.scrub_index(), ref.scrub_local())
        finally:
            ev.close()
            ref.close()
        return got, want
    got, want = both()
    assert got == want
    assert got[1][1:] == ([], []) and got[1][0] == len(ec_files["payloads"])
    # shard 1 cut to half its size in both copies
    for d in (ec_files["port"], ec_files["ref"]):
        path = os.path.join(d, f"{VID}.ec01")
        os.truncate(path, os.path.getsize(path) // 2)
    got, want = both()
    assert got == want
    count, broken, errors = got[1]
    assert broken == [1] and errors
    # one shard gone: its needles are remote, the rest still checked
    for d in (ec_files["port"], ec_files["ref"]):
        os.remove(os.path.join(d, f"{VID}.ec01"))
    got, want = both()
    assert got == want and got[1][1:] == ([], [])


def test_store_reads_and_closes_ec_handles(ec_files):
    """Store.read_needle without a reader reads local needles; unmount
    and remount close the handles they drop, and a remount reads an
    `.ecx` replaced on disk (as `/admin/ec/copy` replaces it)."""
    store = Store([ec_files["port"]])
    try:
        ev = store.find_ec_volume(VID)
        assert store.read_needle(VID, 4).data == ec_files["payloads"][4]
        with pytest.raises(KeyError):
            store.read_needle(VID + 1, 4)
        # a newer .ecx, with needle 4 deleted, lands beside the mount
        other = os.path.join(ec_files["ref"], f"{VID}.ecx")
        ref = RefEcVolume(ec_files["ref"], VID)
        ref.delete_needle(4)
        ref.close()
        os.replace(other, os.path.join(ec_files["port"], f"{VID}.ecx"))
        assert store.read_needle(VID, 4).data == ec_files["payloads"][4]
        ev2 = store.mount_ec_shards(VID, "", [])
        assert ev2 is not ev
        with pytest.raises(OSError):
            ev.shards[0].read_at(0, 8)
        with pytest.raises(KeyError):
            store.read_needle(VID, 4)
        assert store.delete_needle(VID, Needle(id=5)) == 0
        with pytest.raises(KeyError):
            store.read_needle(VID, 5)
        shard0 = ev2.shards[0]
        store.unmount_ec_shards(VID, [0])
        assert 0 not in ev2.shards
        with pytest.raises(OSError):
            shard0.read_at(0, 8)
        store.unmount_ec_shards(VID)
        assert store.find_ec_volume(VID) is None
        with pytest.raises(OSError):
            ev2.shards[1].read_at(0, 8)
    finally:
        store.close()


# --- EcReader over volume servers -------------------------------------------

def test_failed_read_expires_cached_locations(monkeypatch):
    """A failed read of a peer expires the volume's cached locations, so
    the next read asks the master again, also on a host up for less than
    the locations' TTL (`time.monotonic` counts from boot)."""
    import time
    import types as pytypes

    from seaweedfs_tpu_torch import operation
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    lookups = []

    def master_json(master, method, path, payload=None, timeout=30.0,
                    headers=None):
        lookups.append(path)
        return {"shardIdLocations": [{"url": "a:1",
                                      "shardIds": list(range(14))}]}
    monkeypatch.setattr(operation, "master_json", master_json)
    monkeypatch.setattr(store_ec, "time", pytypes.SimpleNamespace(
        monotonic=lambda: 100.0, perf_counter=time.perf_counter))
    reader = store_ec.EcReader("m:1", "self:1")
    ev = pytypes.SimpleNamespace(id=VID, ctx=ECContext(device="cpu"))
    try:
        assert reader._shard_locations(ev)[0] == ["a:1"]
        assert reader._shard_locations(ev)[13] == ["a:1"]
        assert len(lookups) == 1            # 14 of 14: fresh for 37 min
        reader._bust_locations(VID, "a:1")
        assert reader._shard_locations(ev)[0] == ["a:1"]
        assert len(lookups) == 2
        reader.forget(VID)
        reader._shard_locations(ev)
        assert len(lookups) == 3
    finally:
        reader.close()


def _cluster_volume(tmp_path, seed: int) -> "tuple[dict, dict]":
    """A seeded ~3 MiB volume 1 (needles of 1 KB..300 KB): its .dat/.idx
    and payloads."""
    d = tmp_path / "vol"
    d.mkdir()
    payloads = _seeded_volume(d, target=3 << 20, lo=1000, hi=300_000,
                              seed=seed)
    files = {ext: _read(str(d / f"{VID}{ext}")) for ext in (".dat", ".idx")}
    return files, payloads


def _encode(cluster: Cluster, d: int, p: int) -> "dict[str, list[int]]":
    out = cluster.shell(f"ec.encode -volumeId={VID} -dataShards={d} "
                        f"-parityShards={p}")
    assert "scatter-encoded" in out, out
    locs = cluster.ec_locations()
    assert sorted(s for sids in locs.values() for s in sids) == \
        list(range(d + p))
    return locs


def _get(url: str, nid: int, cookie: "int | None" = None,
         headers: "dict | None" = None):
    fid = types.FileId(VID, nid, nid * 7 + 1 if cookie is None else cookie)
    return http_bytes("GET", f"{url}/{fid}", headers=headers, timeout=60)


def _lost_intervals(ev, payloads, lost) -> "dict[int, list[int]]":
    """Needle id -> sizes of its intervals on the lost shards."""
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)
    out = {}
    for nid in payloads:
        sizes = [iv.size for iv in ev.locate_needle(nid)[2]
                 if iv.to_shard_id_and_offset(
                     LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE,
                     ev.ctx.data_shards)[0] in lost]
        if sizes:
            out[nid] = sizes
    return out


def _holder_volume(cluster: Cluster, locs):
    """The mounted EC volume 1 of a server that holds shards of it."""
    return next(vs.store.find_ec_volume(VID) for vs in cluster.servers
                if vs.url in locs)


def _degraded_reads() -> float:
    """The port's degraded-read count for volume 1 in this process."""
    return stats.PROCESS.counter_value("ec_degraded_reads_total",
                                       vid=VID) or 0.0


def _victim(locs, reader_url, lost_needles_of) -> str:
    """The holder (not the reader) whose loss hits the most needles."""
    return max((u for u in locs if u != reader_url),
               key=lambda u: len(lost_needles_of(locs[u])))


@pytest.mark.parametrize("d,p", SCHEMES, ids=SCHEME_IDS)
def test_ec_reads_through_port_servers(tmp_path, monkeypatch, d, p):
    # every read below must reach the EC reader, so the servers run
    # without the hot-needle cache in front of it (which a repeated read
    # would hit; tests/test_torch_read_load.py covers the cache)
    monkeypatch.setenv("SEAWEEDFS_TPU_READ_CACHE_MB", "0")
    files, payloads = _cluster_volume(tmp_path, seed=d)
    cluster = Cluster(tmp_path, "port", ["port"] * 7, files)
    try:
        locs = _encode(cluster, d, p)
        ev = _holder_volume(cluster, locs)
        assert (ev.ctx.data_shards, ev.ctx.parity_shards) == (d, p)

        def lost_of(sids):
            return _lost_intervals(ev, payloads, set(sids))
        # the reader: the holder of the most needles' intervals, so that
        # it reads some needles wholly from its own shards, some wholly
        # from other servers, and some from both
        s0 = next(vs for vs in cluster.servers if vs.url == max(
            locs, key=lambda u: len(lost_of(locs[u]))))
        local = set(locs[s0.url])
        remote = set(range(d + p)) - local
        assert set(payloads) - set(lost_of(remote))
        assert set(payloads) - set(lost_of(local))
        assert set(lost_of(local)) & set(lost_of(remote))
        for nid, payload in payloads.items():
            st, body, hdrs = _get(s0.url, nid)
            assert st == 200 and body == payload, nid
            assert hdrs["Content-Type"] == ("image/png" if nid % 5 == 0
                                            else "application/octet-stream")
        assert _get(s0.url, 1, cookie=5)[0] == 404
        d0 = _degraded_reads()

        victim = _victim(locs, s0.url, lost_of)
        lost = set(locs[victim])
        hit = lost_of(lost)
        assert hit
        cluster.stop_server_with_disk(cluster.servers.index(
            next(vs for vs in cluster.servers if vs.url == victim)))
        f0 = stats.PROCESS.counter_sum("ec_read_source_failovers_total")
        h0 = (stats.PROCESS.histogram_merged("ec_degraded_read_seconds")
              or {"count": 0})["count"]
        # one-shot degraded reads (intervals under the 1 MiB window)
        for nid, payload in payloads.items():
            st, body, _ = _get(s0.url, nid)
            assert st == 200 and body == payload, nid
        n_lost = sum(len(s) for s in hit.values())
        assert _degraded_reads() - d0 == n_lost
        assert stats.PROCESS.counter_value(
            "ec_read_source_failovers_total", peer=victim)
        assert stats.PROCESS.counter_sum(
            "ec_read_source_failovers_total") > f0
        assert stats.PROCESS.histogram_merged(
            "ec_degraded_read_seconds")["count"] - h0 == n_lost
        rendered = stats.PROCESS.render()
        assert "ec_degraded_read_seconds_bucket" in rendered

        # streamed: 4 KiB windows, the one-shot path made to fail
        def boom(self, *a, **k):
            raise AssertionError("one-shot path reached")
        streamed = [nid for nid, sizes in hit.items()
                    if all(s > 4194 for s in sizes)]
        assert streamed
        before = _degraded_reads()
        with monkeypatch.context() as m:
            m.setenv("SEAWEEDFS_TPU_DEGRADED_SLICE_MB", "0.004")
            m.setattr(store_ec.EcReader, "_recover_interval", boom)
            for nid in streamed:
                st, body, _ = _get(s0.url, nid)
                assert st == 200 and body == payloads[nid], nid
        assert _degraded_reads() - before == \
            sum(len(hit[nid]) for nid in streamed)

        # degraded reads switched off: a lost interval is a 404
        monkeypatch.setenv("SEAWEEDFS_TPU_EC_DEGRADED_READS", "0")
        nid = next(iter(hit))
        assert _get(s0.url, nid)[0] == 404
        clean = next(n for n in payloads if n not in hit)
        assert _get(s0.url, clean)[1] == payloads[clean]
    finally:
        cluster.close()


@pytest.mark.parametrize("d,p", SCHEMES, ids=SCHEME_IDS)
def test_ec_reads_across_packages(tmp_path, d, p):
    """Port and JAX volume servers side by side under the port's master:
    each package's reader, over shards the other package holds, returns
    every needle equal to its payload and to the other's read, before
    and after a data-shard holder is lost."""
    files, payloads = _cluster_volume(tmp_path, seed=20 + d)
    kinds = ["port", "ref"] * 3 + ["port"]
    cluster = Cluster(tmp_path, "port", kinds, files)
    try:
        locs = _encode(cluster, d, p)
        # a reader of each package among the holders (a server with no
        # shard of a volume has no EC volume to read from)
        port_s, ref_s = (next(vs for vs, k in zip(cluster.servers, kinds)
                              if k == kind and vs.url in locs)
                         for kind in ("port", "ref"))
        ev = _holder_volume(cluster, locs)

        def lost_of(sids):
            return _lost_intervals(ev, payloads, set(sids))

        def read_all():
            for nid, payload in payloads.items():
                got = [_get(s.url, nid) for s in (port_s, ref_s)]
                assert [g[0] for g in got] == [200, 200], nid
                assert got[0][1] == got[1][1] == payload, nid
        read_all()
        # the holder whose loss hits the most needles, neither reader
        victim = max((u for u in locs if u not in (port_s.url, ref_s.url)),
                     key=lambda u: len(lost_of(locs[u])))
        assert lost_of(locs[victim])
        cluster.stop_server_with_disk(
            [vs.url for vs in cluster.servers].index(victim))
        before = (_degraded_reads(), ref_stats.PROCESS.counter_value(
            "ec_degraded_reads_total", vid=VID) or 0.0)
        # each server's hot-needle cache, so that the reads reach the
        # readers again
        ref_s._nc_drop_volume(VID)
        port_s._nc_drop_volume(VID)
        read_all()
        assert _degraded_reads() > before[0]
        assert ref_stats.PROCESS.counter_value(
            "ec_degraded_reads_total", vid=VID) > before[1]
    finally:
        cluster.close()


def test_ec_delete_decode_and_scrub(tmp_path):
    files, payloads = _cluster_volume(tmp_path, seed=30)
    cluster = Cluster(tmp_path, "port", ["port"] * 7, files)
    ref_env = RefEnv(cluster.master.url)
    try:
        locs = _encode(cluster, 10, 4)
        s0 = cluster.servers[0]
        dead = (2, 9, 17)
        for nid in dead:
            fid = types.FileId(VID, nid, nid * 7 + 1)
            st, body, _ = http_bytes("DELETE", f"{s0.url}/{fid}",
                                     timeout=60)
            assert st == 202, body
        dirs = dict(zip((vs.url for vs in cluster.servers), cluster.dirs))
        ecx = set()
        for url in locs:
            for nid in dead:
                assert _get(url, nid)[0] == 404, (url, nid)
            assert _get(url, 1)[1] == payloads[1]
            base = os.path.join(dirs[url], str(VID))
            assert _read(base + ".ecj") == b"".join(
                n.to_bytes(8, "big") for n in dead), url
            ecx.add(_read(base + ".ecx"))
        assert len(ecx) == 1
        # a delete already done is accepted again, and a retry on a
        # holder answers as the first did
        fid = types.FileId(VID, dead[0], dead[0] * 7 + 1)
        assert http_bytes("DELETE", f"{s0.url}/{fid}", timeout=60)[0] == 202

        # ec.scrub: both shells' lines, for both modes
        for mode in ("local", "index"):
            port_lines = cluster.shell(f"ec.scrub -mode={mode}")
            ref_lines = ref_run_command(ref_env, f"ec.scrub -mode={mode}")
            assert sorted(port_lines.splitlines()) == \
                sorted(ref_lines.splitlines()), mode
            assert len(port_lines.splitlines()) == len(locs)
            assert all(line.endswith(", ok")
                       for line in port_lines.splitlines()), port_lines

        # the JAX decoder's .idx for these files, then ec.decode's
        ref_dir = tmp_path / "refidx"
        ref_dir.mkdir()
        holder = os.path.join(dirs[s0.url], str(VID))
        for ext in (".ecx", ".ecj"):
            shutil.copy(holder + ext, ref_dir / f"{VID}{ext}")
        ref_decoder.write_idx_file_from_ec_index(str(ref_dir / str(VID)))
        out = cluster.shell(f"ec.decode -volumeId={VID}")
        target = out.rsplit(" ", 1)[1]
        assert _read(os.path.join(dirs[target], f"{VID}.idx")) == \
            _read(str(ref_dir / f"{VID}.idx"))
        for nid, payload in payloads.items():
            st, body, _ = _get(target, nid)
            assert (st, body) == ((404, body) if nid in dead
                                  else (200, payload)), nid
    finally:
        cluster.close()


# --- the data path on a normal volume ---------------------------------------

def test_normal_volume_data_path_matches_reference(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    payloads = _seeded_volume(src, target=20_000, lo=10, hi=3000, seed=4)
    dirs = []
    for name in ("port", "ref"):
        shutil.copytree(src, tmp_path / name)
        dirs.append(str(tmp_path / name))
    master = MasterServer(pulse_seconds=1.0).start()
    port = VolumeServer([dirs[0]], device="cpu", master=master.url,
                        pulse_seconds=0.2).start()
    ref = RefServer([dirs[1]], master.url, pulse_seconds=0.2).start()
    try:
        def both(method, path, headers=None):
            out = []
            for vs in (port, ref):
                st, body, hdrs = http_bytes(method, f"{vs.url}{path}",
                                            headers=headers, timeout=30)
                out.append((st, body if st < 300 else b"",
                            hdrs.get("Content-Type", ""),
                            hdrs.get("Content-Range", "")))
            assert out[0] == out[1], (method, path, headers)
            return out[0]

        fid = lambda nid, c=None: str(types.FileId(  # noqa: E731
            VID, nid, nid * 7 + 1 if c is None else c))
        for nid, payload in payloads.items():
            st, body, ctype, _ = both("GET", f"/{fid(nid)}")
            assert st == 200 and body == payload
            assert ctype == ("image/png" if nid % 5 == 0
                             else "application/octet-stream")
        five = payloads[5]
        for rng in ("bytes=0-9", "bytes=5-", "bytes=-7", "bytes=3-3",
                    f"bytes=0-{len(five) + 50}"):
            st, body, _, crange = both("GET", f"/{fid(5)}", {"Range": rng})
            assert st == 206 and crange.endswith(f"/{len(five)}"), rng
        assert both("GET", f"/{fid(5)}", {"Range": "bytes=0-9"})[1] == \
            five[:10]
        assert both("HEAD", f"/{fid(3)}")[:1] == (200,)
        assert http_bytes("HEAD", f"{port.url}/{fid(3)}")[2][
            "Content-Length"] == str(len(payloads[3]))
        for path in (f"/{fid(3, 12345)}", f"/{fid(10 ** 6)}", "/1,zz",
                     "/nonsense", f"/{VID + 7},0100000001"):
            assert both("GET", path)[0] == 404, path
        # a POST is answered as the JAX server answers it
        answers = [http_bytes("POST", f"{vs.url}/{fid(4)}?ts=1700000000",
                              b"x", timeout=30)[:2] for vs in (port, ref)]
        assert answers[0] == answers[1] and answers[0][0] == 201, answers
        # deletes: freed size, then 404; a second delete frees nothing
        for vs in (port, ref):
            st, body, _ = http_bytes("DELETE", f"{vs.url}/{fid(4)}",
                                     timeout=30)
            assert st == 202, body
        assert both("GET", f"/{fid(4)}")[0] == 404
        assert both("GET", f"/{fid(6)}")[1] == payloads[6]
        assert http_json("DELETE", f"{port.url}/{fid(4)}") == {"size": 0}
        # the tombstone .idx entry the JAX volume writes
        assert _read(os.path.join(dirs[0], f"{VID}.idx")) == \
            _read(os.path.join(dirs[1], f"{VID}.idx"))
    finally:
        port.stop()
        ref.stop()
        master.stop()


def test_replicated_volume_delete_reaches_every_replica(tmp_path):
    """A delete on one replica of a replicated volume (placement 001)
    deletes on the other too, found through the master's /dir/lookup;
    the other answers the fan-out as a replica."""
    from seaweedfs_tpu_torch.storage.replica_placement import (
        ReplicaPlacement)
    src = tmp_path / "src"
    src.mkdir()
    payloads = _seeded_volume(src, target=10_000, seed=5,
                              replica_placement=ReplicaPlacement.
                              from_string("001"))
    dirs = []
    for name in ("a", "b"):
        shutil.copytree(src, tmp_path / name)
        dirs.append(str(tmp_path / name))
    master = MasterServer(pulse_seconds=1.0).start()
    servers = [VolumeServer([d], device="cpu", master=master.url,
                            pulse_seconds=0.2).start() for d in dirs]
    try:
        Cluster.wait(lambda: len(http_json(
            "GET", f"{master.url}/dir/lookup?volumeId={VID}",
            timeout=10).get("locations", [])) == 2, "two replicas")
        fid = types.FileId(VID, 3, 3 * 7 + 1)
        st, body, _ = http_bytes("DELETE", f"{servers[0].url}/{fid}",
                                 timeout=30)
        assert st == 202 and b'"size"' in body
        for vs in servers:
            assert http_bytes("GET", f"{vs.url}/{fid}")[0] == 404
            assert _get(vs.url, 2)[1] == payloads[2]
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
