"""The port's remote EC paths on the CPU: scatter-encode to remote shard
servers and the streamed rebuild from remote survivors, through the
port's volume-server routes (`seaweedfs_tpu_torch/server/`), held byte
for byte (tolerance: exact equality) against the JAX package's
`write_ec_files` on the same volume (JAX on the CPU, as
tests/conftest.py pins it).

One seeded volume of ~21 MiB with the real block sizes (three 10 MiB
rows of 1 MiB blocks, so 3 MiB shards), codec batches of 1 MiB a shard
row, 1 MiB staging windows, 1 MiB rebuild slices, and the codec on the
CPU (`device="cpu"`).  Servers are in-process, bound to port 0, and
closed by their fixtures.
"""

import io
import os
import time
import zlib

import numpy as np
import pytest
import torch

from seaweedfs_tpu.storage.erasure_coding import ec_decoder as ref_decoder
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.ec_context import (
    ECContext as RefContext)
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ops import rs_matrix, staging
from seaweedfs_tpu_torch.ops.rs_torch import gf_apply_matrix
from seaweedfs_tpu_torch.server.httpd import (FileSlice, HttpServer,
                                              http_json,
                                              http_stream_request)
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.erasure_coding import (ec_context,
                                                        ec_encoder,
                                                        shard_sink,
                                                        shard_source)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

VID = 1
TOTAL = 14
VOLUME_BYTES = 21 << 20


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """A seeded volume (.dat/.idx written by the port's Volume) and its
    .ecx, .vif and 14 shards from the JAX package's pipeline."""
    d = tmp_path_factory.mktemp("golden")
    v = Volume(str(d), VID)
    rng = np.random.default_rng(7)
    nid = 0
    while v.dat_size() < VOLUME_BYTES:
        nid += 1
        v.write_needle(Needle(cookie=nid, id=nid,
                              data=rng.bytes(int(rng.integers(1000,
                                                              400_000)))))
    v.close()
    base = str(d / str(VID))
    ctx = RefContext(backend="jax")
    ref_encoder.write_sorted_file_from_idx(base)
    ref_encoder.write_ec_files(base, ctx)
    ref_encoder.save_ec_volume_info(
        base, ctx, os.path.getsize(base + ".dat"),
        ref_decoder.read_ec_volume_version(base))
    files = {ext: _read(base + ext) for ext in (".dat", ".idx", ".ecx",
                                                ".vif")}
    files.update({sid: _read(base + f".ec{sid:02d}")
                  for sid in range(TOTAL)})
    assert len(files[0]) == 3 << 20
    return base, files


@pytest.fixture(autouse=True)
def small_sizes(monkeypatch):
    monkeypatch.setattr(ec_context, "DEVICE_BATCH_SIZE", 1 << 20)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_REBUILD_SLICE_MB", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "1")


@pytest.fixture
def servers(tmp_path):
    """start(n) -> n port volume servers (CPU codec), one directory
    each; all stopped at teardown."""
    started = []

    def start(n):
        out = []
        for i in range(len(started), len(started) + n):
            d = tmp_path / f"v{i}"
            d.mkdir()
            out.append(VolumeServer([str(d)], device="cpu").start())
        started.extend(out)
        return out

    yield start
    for vs in started:
        vs.stop()


@pytest.fixture
def fake_server():
    """An HttpServer with custom routes, stopped at teardown."""
    made = []

    def make(routes):
        srv = HttpServer()
        for (method, path), fn in routes.items():
            srv.route(method, path, fn)
        srv.start()
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.stop()


def _dir(vs) -> str:
    return vs.store.locations[0].directory


def place_volume(vs, files) -> None:
    """The golden .dat/.idx into a server's directory, mounted."""
    for ext in (".dat", ".idx"):
        with open(os.path.join(_dir(vs), f"{VID}{ext}"), "wb") as f:
            f.write(files[ext])
    vs.store.locations[0].load_existing()


def place_shards(layout, files) -> None:
    """{server: [shard ids]}: golden shards and sidecars into each
    server's directory, mounted through its own route."""
    for vs, sids in layout.items():
        for key in list(sids) + [".ecx", ".vif"]:
            name = f"{VID}.ec{key:02d}" if isinstance(key, int) \
                else f"{VID}{key}"
            with open(os.path.join(_dir(vs), name), "wb") as f:
                f.write(files[key])
        r = http_json("POST", f"{vs.url}/admin/ec/mount",
                      {"volumeId": VID, "shardIds": list(sids)}, timeout=10)
        assert r == {"shardIds": sorted(sids)}, r


def _leftovers(vs) -> "list[str]":
    return sorted(p for p in os.listdir(_dir(vs))
                  if ".ec" in p or ".scatter." in p)


def _scatter(src, urls, timeout=120):
    r = http_json("POST", f"{src.url}/admin/set_readonly",
                  {"volumeId": VID}, timeout=10)
    assert r == {}, r
    placement = {str(s): urls[s % len(urls)] for s in range(TOTAL)}
    return http_json("POST", f"{src.url}/admin/ec/generate",
                     {"volumeId": VID, "placement": placement},
                     timeout=timeout)


# --- the slice as a whole ---------------------------------------------------

def test_scatter_encode_matches_jax_write_ec_files(golden, servers):
    _, files = golden
    vols = servers(4)
    src = vols[0]
    place_volume(src, files)
    urls = [vs.url for vs in vols]
    before = stats.PROCESS.counter_value("ec_scatter_encodes_total") or 0
    r = _scatter(src, urls)
    assert "error" not in r, r
    assert r["localShardIds"] == [0, 4, 8, 12]
    shard = len(files[0])
    tele = r["telemetry"]
    assert tele["bytesScatteredTotal"] == 10 * shard
    assert tele["localWriteBytes"] == 4 * shard
    assert set(tele["bytesScatteredByDest"]) == set(urls[1:])
    assert stats.PROCESS.counter_value("ec_scatter_encodes_total") == \
        before + 1
    for i, vs in enumerate(vols):
        want = [s for s in range(TOTAL) if s % 4 == i]
        for sid in want:
            assert _read(os.path.join(_dir(vs), f"{VID}.ec{sid:02d}")) == \
                files[sid], f"shard {sid} at {vs.url}"
        for ext in (".ecx", ".vif"):
            assert _read(os.path.join(_dir(vs), f"{VID}{ext}")) == \
                files[ext], (vs.url, ext)
        info = http_json("GET", f"{vs.url}/admin/ec/info?volumeId={VID}",
                         timeout=10)
        assert info["shardIds"] == want and info["shardSize"] == shard
        assert not [p for p in os.listdir(_dir(vs)) if ".scatter." in p]


@pytest.mark.parametrize("lost", [(1, 6), (0, 5, 10, 11)],
                         ids=["lost2", "lost4"])
def test_streamed_rebuild_identical_to_originals(golden, servers, lost):
    """Server 0 rebuilds; the survivors it lacks stream from servers 1-3
    (sid % 4 == server)."""
    _, files = golden
    vols = servers(4)
    layout = {vs: [s for s in range(TOTAL) if s % 4 == i and s not in lost]
              for i, vs in enumerate(vols)}
    place_shards(layout, files)
    locs = {str(s): [vols[s % 4].url] for s in range(TOTAL)
            if s not in lost}
    before = stats.PROCESS.counter_value("ec_rebuilds_total") or 0
    r = http_json("POST", f"{vols[0].url}/admin/ec/rebuild",
                  {"volumeId": VID, "shardLocations": locs}, timeout=120)
    assert "error" not in r, r
    assert stats.PROCESS.counter_value("ec_rebuilds_total") == before + 1
    assert r["rebuiltShardIds"] == list(lost)
    fetched = r["telemetry"]["bytesFetchedBySource"]
    assert len([u for u in fetched if u != "local"]) == 3, fetched
    assert r["telemetry"]["bytesFetchedTotal"] == 10 * len(files[0])
    for sid in lost:
        assert _read(os.path.join(_dir(vols[0]), f"{VID}.ec{sid:02d}")) \
            == files[sid], f"shard {sid}"
    # the staging pool the windowed launches share stays in its bounds
    assert len(staging.POOL) <= staging.POOL.max_bufs
    assert staging.POOL.nbytes <= staging.POOL.max_bytes


# --- slice and window sizes never change bytes -------------------------------

@pytest.mark.parametrize("slice_bytes,window_mb", [
    (64 << 10, "0"), (1 << 20, "0.25"), (3 << 20, "1"), (None, "1")],
    ids=["64k-oneshot", "1m-window256k", "3m-window1m", "batch"])
def test_rebuild_slices_never_change_bytes(golden, servers, tmp_path,
                                           monkeypatch, slice_bytes,
                                           window_mb):
    """Every survivor remote (RemoteShardSource over two servers), any
    slice and staging window: the same bytes."""
    _, files = golden
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", window_mb)
    a, b = servers(2)
    lost = [2, 9, 13]
    place_shards({a: [s for s in range(0, 7) if s not in lost],
                  b: [s for s in range(7, 14) if s not in lost]}, files)
    sources = {s: shard_source.RemoteShardSource(
        [(a if s < 7 else b).url], VID, s)
        for s in range(TOTAL) if s not in lost}
    out = str(tmp_path / "out")
    os.makedirs(out)
    base = os.path.join(out, str(VID))
    stats_ = shard_source.RebuildStats()
    got = ec_encoder.rebuild_from_sources(
        base, ec_context.ECContext(device="cpu"), sources, lost,
        stats=stats_, slice_bytes=slice_bytes)
    assert got == lost
    for sid in lost:
        assert _read(base + f".ec{sid:02d}") == files[sid], sid
    step = ec_encoder.rebuild_step(len(files[0]), ec_context.ECContext(
        device="cpu"), slice_bytes)
    assert stats_.slices == 10 * -(-len(files[0]) // step)


@pytest.mark.parametrize("window_mb,inflight,h2d_mb", [
    ("1", "1", "0.5"), ("3", "2", "0"), ("16", "3", "1")])
def test_scatter_windows_never_change_bytes(golden, servers, monkeypatch,
                                            window_mb, inflight, h2d_mb):
    _, files = golden
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SCATTER_WINDOW_MB", window_mb)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SCATTER_INFLIGHT", inflight)
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", h2d_mb)
    vols = servers(3)
    place_volume(vols[0], files)
    r = _scatter(vols[0], [vs.url for vs in vols])
    assert "error" not in r, r
    # the sinks send whole windows but the last
    per_dest = -(-len(files[0]) // (int(window_mb) << 20))
    remote_shards = sum(1 for s in range(TOTAL) if s % 3)
    assert r["telemetry"]["windows"] == remote_shards * per_dest
    for sid in range(TOTAL):
        assert _read(os.path.join(_dir(vols[sid % 3]),
                                  f"{VID}.ec{sid:02d}")) == files[sid]


# --- failure semantics ------------------------------------------------------

def _truncating_shard_read(data: bytes):
    """A donor that promises the whole range and dies halfway."""
    def serve(req):
        off = int(req.query["offset"])
        n = max(0, min(int(req.query["size"]), len(data) - off))
        req._handler.close_connection = True
        return 200, (FileSlice(io.BytesIO(data[off:off + n // 2]), n // 2),
                     {"Content-Length": str(n)})
    return serve


def test_truncated_shard_read_is_failover_not_eof(golden, servers,
                                                  fake_server):
    _, files = golden
    (good,) = servers(1)
    place_shards({good: [3]}, files)
    dying = fake_server({("GET", "/admin/ec/shard_read"):
                         _truncating_shard_read(files[3])})
    n = len(files[3])
    work = [(pos, min(1 << 20, n - pos)) for pos in range(0, n, 1 << 20)]
    src = shard_source.RemoteShardSource([dying.url], VID, 3, timeout=10)
    with pytest.raises(OSError, match="truncated"):
        list(src.iter_slices_into(work, bytearray))
    # the same stream with a live second holder: failover, exact bytes
    src = shard_source.RemoteShardSource([dying.url, good.url], VID, 3,
                                         timeout=10)
    got = b"".join(bytes(buf[:k]) for buf, k in
                   src.iter_slices_into(work, bytearray))
    assert got == files[3]
    assert src.label == good.url
    # a server that PROMISES fewer bytes (a short shard) is EOF: padded
    out = list(src.iter_slices_into([(n - 100, 100), (n, 100)], bytearray))
    assert [k for _b, k in out] == [100, 0]


def test_scatter_dest_death_aborts_cleanly(golden, servers, fake_server):
    """A destination dying mid-stream aborts the stripe: an error that
    names it, nothing mounted or staged anywhere, the source's .ecx
    gone and its pre-existing .vif restored byte for byte."""
    _, files = golden
    vols = servers(3)
    src = vols[0]
    place_volume(src, files)
    vif = os.path.join(_dir(src), f"{VID}.vif")
    with open(vif, "wb") as f:
        f.write(b'{"version": 3, "replication": "000"}')
    seen = {"bytes": 0}

    def die_mid_stream(req):
        for chunk in req.stream_body():
            seen["bytes"] += len(chunk)
            raise IOError("destination killed mid-scatter")
        return 200, {}

    dying = fake_server({("POST", "/admin/ec/shard_write"): die_mid_stream,
                         ("POST", "/admin/ec/delete_shards"):
                             lambda req: (200, {}),
                         ("POST", "/admin/ec/shard_write_abort"):
                             lambda req: (200, {})})
    r = http_json("POST", f"{src.url}/admin/set_readonly", {"volumeId": VID},
                  timeout=10)
    placement = {str(s): vols[s % 3].url for s in range(TOTAL)}
    placement["13"] = dying.url
    r = http_json("POST", f"{src.url}/admin/ec/generate",
                  {"volumeId": VID, "placement": placement}, timeout=120)
    assert "scatter encode" in r.get("error", ""), r
    assert dying.url in r["failedDests"], r
    assert seen["bytes"] > 0
    for vs in vols:
        info = http_json("GET", f"{vs.url}/admin/ec/info?volumeId={VID}",
                         timeout=10)
        assert "error" in info, (vs.url, info)
        assert _leftovers(vs) == [], (vs.url, _leftovers(vs))
    assert _read(vif) == b'{"version": 3, "replication": "000"}'
    assert src.store.find_volume(VID) is not None
    assert _read(os.path.join(_dir(src), f"{VID}.dat")) == files[".dat"]


def test_rebuild_source_failure_leaves_no_target(golden, servers,
                                                 fake_server):
    """A survivor stream that dies (no other holder) fails the rebuild
    promptly, and no target file is left for a later discovery to take
    for a survivor."""
    _, files = golden
    a, b = servers(2)
    lost = [4]
    place_shards({a: [s for s in range(TOTAL) if s % 2 == 0 and
                      s not in lost],
                  b: [s for s in range(TOTAL) if s % 2]}, files)
    dying = fake_server({("GET", "/admin/ec/shard_read"):
                         _truncating_shard_read(files[1])})
    locs = {str(s): [b.url] for s in range(1, TOTAL, 2)}
    locs["1"] = [dying.url]
    t0 = time.perf_counter()
    r = http_json("POST", f"{a.url}/admin/ec/rebuild",
                  {"volumeId": VID, "shardLocations": locs}, timeout=60)
    assert "truncated" in r.get("error", ""), r
    assert time.perf_counter() - t0 < 30
    assert not os.path.exists(os.path.join(_dir(a), f"{VID}.ec04"))


@pytest.mark.parametrize("wrong", ["crc", "bytes", "sink"])
def test_commit_refuses_crc_or_byte_mismatch(servers, fake_server, wrong):
    """The receiver refuses a commit whose CRC or byte count differs from
    what it staged (and discards the temp); the sender refuses a
    receiver that reports other bytes than it sent."""
    (vs,) = servers(1)
    payload = np.random.default_rng(3).bytes(300_001)
    if wrong == "sink":
        fake = fake_server({
            ("POST", "/admin/ec/shard_write"): lambda req: (200, {
                "bytes": sum(len(c) for c in req.stream_body()),
                "crc32": 12345}),
            ("POST", "/admin/ec/shard_write_abort"):
                lambda req: (200, {})})
        sink = shard_sink.RemoteShardSink(fake.url, VID, 5, timeout=10)
        try:
            sink.write(payload)
            with pytest.raises(OSError, match="crc 12345"):
                sink.finish()
        finally:
            sink.close()
        return
    status, body = http_stream_request(
        "POST", f"{vs.url}/admin/ec/shard_write?volumeId={VID}&shardId=5"
        f"&collection=&uploadId=u1", [payload[:100_000], payload[100_000:]],
        timeout=10)
    assert status == 200
    assert [p for p in os.listdir(_dir(vs)) if ".scatter." in p]
    crc = zlib.crc32(payload)
    commit = {"volumeId": VID, "uploadId": "u1", "shardId": 5,
              "crc32": crc + 1 if wrong == "crc" else crc,
              "bytes": len(payload) - (wrong == "bytes")}
    r = http_json("POST", f"{vs.url}/admin/ec/shard_write_commit", commit,
                  timeout=10)
    assert "upload mismatch" in r.get("error", ""), r
    assert _leftovers(vs) == []
    # the upload is gone: a corrected commit cannot resurrect it
    commit.update(crc32=crc, bytes=len(payload))
    r = http_json("POST", f"{vs.url}/admin/ec/shard_write_commit", commit,
                  timeout=10)
    assert "unknown staged upload" in r.get("error", ""), r


def test_gf_apply_matrix_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mat = rs_matrix.parity_matrix(10, 4)
    data = np.random.default_rng(1).integers(0, 256, (10, 64),
                                             dtype=np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gf_apply_matrix(mat, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gf_apply_matrix(mat, torch.from_numpy(data), device="cuda")
    assert gf_apply_matrix(mat, data, device="cpu").shape == (4, 64)


def test_fetcher_buffers_are_recycled(golden, servers, monkeypatch):
    """A remote source streams into depth + 1 recycled buffers whatever
    the number of slices."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_REBUILD_PREFETCH", "2")
    _, files = golden
    (vs,) = servers(1)
    place_shards({vs: [0]}, files)
    buffers = set()

    class Recording(shard_source.RemoteShardSource):
        def iter_slices_into(self, work, take_buf, record=None):
            for buf, k in super().iter_slices_into(work, take_buf, record):
                buffers.add(id(buf))
                yield buf, k

    n = len(files[0])
    work = [(pos, min(128 << 10, n - pos))
            for pos in range(0, n, 128 << 10)]
    fetcher = shard_source.MultiSourceFetcher(
        {0: Recording([vs.url], VID, 0)}, work)
    row = bytearray(128 << 10)
    got = bytearray()
    try:
        for item in work:
            k = fetcher.get(item, {0: memoryview(row)})[0]
            got += row[:k]
    finally:
        fetcher.close()
    assert bytes(got) == files[0]
    assert len(work) == 24 and 0 < len(buffers) <= 3


def test_copied_survivors_count_as_local(golden, servers):
    """Survivors already on the rebuilder's disk (copied, unmounted) are
    read locally: no shardLocations needed."""
    _, files = golden
    (vs,) = servers(1)
    lost = [3, 12]
    for sid in range(TOTAL):
        if sid not in lost:
            with open(os.path.join(_dir(vs), f"{VID}.ec{sid:02d}"),
                      "wb") as f:
                f.write(files[sid])
    with open(os.path.join(_dir(vs), f"{VID}.vif"), "wb") as f:
        f.write(files[".vif"])
    r = http_json("POST", f"{vs.url}/admin/ec/rebuild", {"volumeId": VID},
                  timeout=60)
    assert r["rebuiltShardIds"] == lost, r
    assert set(r["telemetry"]["bytesFetchedBySource"]) == {"local"}
    for sid in lost:
        assert _read(os.path.join(_dir(vs), f"{VID}.ec{sid:02d}")) == \
            files[sid]
