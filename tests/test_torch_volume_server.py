"""The port's volume server (`seaweedfs_tpu_torch/server/`) across the
wire with the JAX package's, both ways, and its EC routes one by one,
on the CPU.  Tolerance: exact byte equality.

- a port RemoteShardSource (and a port streamed rebuild) reading shards
  a reference VolumeServer serves, and the reverse;
- a port RemoteShardSink committing into a reference receiver, and a
  reference scatter-encode whose destinations are port servers;
- the routes: local generate and rebuild, mount/unmount/delete, info,
  shard_read ranges, receive_file, the refusals, and the `volume`
  command line.

The reference servers run with their MasterServer, as
tests/test_ec_scatter_encode.py starts them.
"""

import os
import re
import select
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.server.master_server import MasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding import shard_source as ref_source
from seaweedfs_tpu.storage.erasure_coding.ec_context import (
    ECContext as RefContext)
from seaweedfs_tpu_torch.server.httpd import (http_bytes, http_json,
                                              http_stream_request)
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.erasure_coding import (ec_context,
                                                        ec_encoder,
                                                        shard_sink,
                                                        shard_source)

from test_torch_remote_ec import (TOTAL, VID, _dir, _read,  # noqa: F401
                                  golden, place_shards, place_volume,
                                  servers, small_sizes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ref_server(tmp_path):
    """A reference MasterServer and one reference VolumeServer; the
    directory is returned so a test can seed files before start()."""
    master = MasterServer(volume_size_limit_mb=64).start()
    made = []

    def start():
        d = tmp_path / f"ref{len(made)}"
        d.mkdir(exist_ok=True)
        vs = RefServer([str(d)], master.url, pulse_seconds=0.3)
        made.append(vs)
        return vs.start()

    def seed_dir():
        d = tmp_path / f"ref{len(made)}"
        d.mkdir(exist_ok=True)
        return str(d)

    start.seed_dir = seed_dir
    yield start
    for vs in made:
        vs.stop()
    master.stop()


def _ref_dir(vs) -> str:
    return vs.store.locations[0].directory


def _seed_ref_shards(ref_server, files, sids):
    """A reference server holding golden shards `sids` (and the
    sidecars), mounted through its own route."""
    d = ref_server.seed_dir()
    for key in list(sids) + [".ecx", ".vif"]:
        name = f"{VID}.ec{key:02d}" if isinstance(key, int) \
            else f"{VID}{key}"
        with open(os.path.join(d, name), "wb") as f:
            f.write(files[key])
    vs = ref_server()
    r = http_json("POST", f"{vs.url}/admin/ec/mount",
                  {"volumeId": VID, "shardIds": list(sids)}, timeout=10)
    assert r.get("shardIds") == sorted(sids), r
    return vs


# --- across the wire ----------------------------------------------------------

def test_port_source_reads_reference_server(golden, ref_server, tmp_path):
    _, files = golden
    lost = [0, 13]
    ref = _seed_ref_shards(ref_server, files,
                           [s for s in range(TOTAL) if s not in lost])
    src = shard_source.RemoteShardSource([ref.url], VID, 5, timeout=10)
    n = len(files[5])
    assert src.size() == n
    assert src.read_at(n - 10, 100) == files[5][-10:]
    work = [(pos, min(700_000, n - pos)) for pos in range(0, n, 700_000)]
    assert b"".join(bytes(b[:k]) for b, k in
                    src.iter_slices_into(work, bytearray)) == files[5]
    # a port streamed rebuild from reference survivors only
    base = str(tmp_path / str(VID))
    sources = {s: shard_source.RemoteShardSource([ref.url], VID, s)
               for s in range(TOTAL) if s not in lost}
    got = ec_encoder.rebuild_from_sources(
        base, ec_context.ECContext(device="cpu"), sources, lost,
        slice_bytes=1 << 20)
    assert got == lost
    for sid in lost:
        assert _read(base + f".ec{sid:02d}") == files[sid]


def test_reference_source_reads_port_server(golden, servers, tmp_path):
    _, files = golden
    lost = [3, 8]
    (port,) = servers(1)
    place_shards({port: [s for s in range(TOTAL) if s not in lost]}, files)
    src = ref_source.RemoteShardSource([port.url], VID, 4)
    n = len(files[4])
    assert src.size() == n
    work = [(pos, min(1 << 20, n - pos)) for pos in range(0, n, 1 << 20)]
    assert b"".join(bytes(b[:k]) for b, k in
                    src.iter_slices_into(work, bytearray)) == files[4]
    base = str(tmp_path / str(VID))
    sources = {s: ref_source.RemoteShardSource([port.url], VID, s)
               for s in range(TOTAL) if s not in lost}
    got = ref_encoder.rebuild_from_sources(
        base, RefContext(backend="cpu"), sources, lost, slice_bytes=1 << 20)
    assert got == lost
    for sid in lost:
        assert _read(base + f".ec{sid:02d}") == files[sid]


def test_port_sink_commits_into_reference_receiver(golden, ref_server,
                                                   monkeypatch):
    _, files = golden
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SCATTER_WINDOW_MB", "1")
    ref = ref_server()
    stats_ = shard_sink.ScatterStats()
    sinks = {}
    for sid in (2, 11):
        sink = shard_sink.RemoteShardSink(ref.url, VID, sid, timeout=30)
        sink.set_stats(stats_)
        data = memoryview(files[sid])
        for off in range(0, len(data), 333_333):   # ragged writes
            sink.write(data[off:off + 333_333])
        sinks[sid] = sink
    for sink in sinks.values():
        sink.end_stream()
    for sink in sinks.values():
        sink.finish()
    for ext in (".ecx", ".vif"):
        st, _b, _h = http_bytes(
            "POST", f"{ref.url}/admin/receive_file?volumeId={VID}"
            f"&collection=&ext={ext}", files[ext], timeout=10)
        assert st == 200
    r = http_json("POST", f"{ref.url}/admin/ec/shard_write_commit",
                  {"volumeId": VID, "collection": "", "mount": True,
                   "commits": [{"uploadId": s.upload_id, "shardId": sid,
                                "crc32": s.crc, "bytes": s.bytes}
                               for sid, s in sinks.items()]}, timeout=10)
    assert r.get("shardIds") == [2, 11], r
    for sink in sinks.values():
        sink.mark_committed()
        sink.close()
    for sid in sinks:
        assert _read(os.path.join(_ref_dir(ref), f"{VID}.ec{sid:02d}")) \
            == files[sid]
    info = http_json("GET", f"{ref.url}/admin/ec/info?volumeId={VID}",
                     timeout=10)
    assert info["shardIds"] == [2, 11]
    assert sum(stats_.snapshot()[0].values()) == 2 * len(files[0])


def test_reference_scatter_into_port_servers(golden, ref_server, servers):
    """The JAX package's scatter-encode with port servers as
    destinations: their shards, sidecars and mounts."""
    _, files = golden
    d = ref_server.seed_dir()
    for ext in (".dat", ".idx"):
        with open(os.path.join(d, f"{VID}{ext}"), "wb") as f:
            f.write(files[ext])
    ref = ref_server()
    ports = servers(2)
    urls = [ref.url] + [p.url for p in ports]
    r = http_json("POST", f"{ref.url}/admin/set_readonly",
                  {"volumeId": VID, "readOnly": True}, timeout=10)
    placement = {str(s): urls[s % 3] for s in range(TOTAL)}
    r = http_json("POST", f"{ref.url}/admin/ec/generate",
                  {"volumeId": VID, "placement": placement}, timeout=120)
    assert "error" not in r, r
    for i, vs in enumerate(ports, start=1):
        want = [s for s in range(TOTAL) if s % 3 == i]
        for sid in want:
            assert _read(os.path.join(_dir(vs), f"{VID}.ec{sid:02d}")) == \
                files[sid], sid
        assert _read(os.path.join(_dir(vs), f"{VID}.ecx")) == files[".ecx"]
        info = http_json("GET", f"{vs.url}/admin/ec/info?volumeId={VID}",
                         timeout=10)
        assert info["shardIds"] == want, info
        assert not [p for p in os.listdir(_dir(vs)) if ".scatter." in p]


# --- the routes -----------------------------------------------------------

def test_generate_local_mount_unmount_delete(golden, servers):
    _, files = golden
    (vs,) = servers(1)
    place_volume(vs, files)
    url = vs.url
    r = http_json("POST", f"{url}/admin/ec/generate", {"volumeId": VID},
                  timeout=60)
    assert "readonly" in r.get("error", ""), r
    assert http_json("POST", f"{url}/admin/set_readonly",
                     {"volumeId": VID}, timeout=10) == {}
    r = http_json("POST", f"{url}/admin/ec/generate", {"volumeId": VID},
                  timeout=120)
    assert r == {"shardIds": list(range(TOTAL))}, r
    for key in list(range(TOTAL)) + [".ecx", ".vif"]:
        name = f"{VID}.ec{key:02d}" if isinstance(key, int) \
            else f"{VID}{key}"
        assert _read(os.path.join(_dir(vs), name)) == files[key], name
    assert http_json("POST", f"{url}/admin/ec/mount",
                     {"volumeId": VID, "shardIds": [0, 1]},
                     timeout=10)["shardIds"] == list(range(TOTAL))
    assert http_json("POST", f"{url}/admin/ec/unmount",
                     {"volumeId": VID, "shardIds": []}, timeout=10) == {}
    assert http_json("POST", f"{url}/admin/ec/unmount",
                     {"volumeId": VID, "shardIds": [0, 13]},
                     timeout=10) == {}
    info = http_json("GET", f"{url}/admin/ec/info?volumeId={VID}",
                     timeout=10)
    assert info["shardIds"] == list(range(1, 13))
    assert info["dataShards"] == 10 and info["parityShards"] == 4
    http_json("POST", f"{url}/admin/ec/delete_shards",
              {"volumeId": VID, "shardIds": list(range(7))}, timeout=10)
    info = http_json("GET", f"{url}/admin/ec/info?volumeId={VID}",
                     timeout=10)
    assert info["shardIds"] == list(range(7, 14))
    http_json("POST", f"{url}/admin/ec/delete_shards",
              {"volumeId": VID, "shardIds": list(range(7, 14))},
              timeout=10)
    assert "error" in http_json(
        "GET", f"{url}/admin/ec/info?volumeId={VID}", timeout=10)
    left = sorted(os.listdir(_dir(vs)))
    assert left == [f"{VID}.dat", f"{VID}.idx"], left


def test_rebuild_local_mode(golden, servers):
    _, files = golden
    (vs,) = servers(1)
    lost = [0, 7, 11, 13]
    place_shards({vs: [s for s in range(TOTAL) if s not in lost]}, files)
    r = http_json("POST", f"{vs.url}/admin/ec/rebuild",
                  {"volumeId": VID, "mode": "local"}, timeout=60)
    assert r == {"rebuiltShardIds": lost, "mode": "local"}, r
    for sid in lost:
        assert _read(os.path.join(_dir(vs), f"{VID}.ec{sid:02d}")) == \
            files[sid]
    # destroy: every shard and sidecar of the mounted volume goes
    vs.store.mount_ec_shards(VID, "", []).destroy()
    assert os.listdir(_dir(vs)) == []


@pytest.mark.parametrize("offset,size", [
    (0, 1 << 20), (12345, 100_000), ((3 << 20) - 10, 100), (3 << 20, 5)])
def test_shard_read_ranges(golden, servers, offset, size):
    _, files = golden
    (vs,) = servers(1)
    place_shards({vs: [6]}, files)
    st, body, headers = http_bytes(
        "GET", f"{vs.url}/admin/ec/shard_read?volumeId={VID}&shardId=6"
        f"&offset={offset}&size={size}", timeout=10)
    assert st == 200
    assert body == files[6][offset:offset + size]
    assert headers["Content-Length"] == str(len(body))
    st, _body, _h = http_bytes(
        "GET", f"{vs.url}/admin/ec/shard_read?volumeId={VID}&shardId=7"
        f"&offset=0&size=10", timeout=10)
    assert st == 404


def test_receive_file_chunked_and_refusals(servers):
    (vs,) = servers(1)
    payload = np.random.default_rng(9).bytes(2_500_000)
    st, body = http_stream_request(
        "POST", f"{vs.url}/admin/receive_file?volumeId={VID}&collection="
        f"&ext=.ecx", [payload[i:i + 65536]
                       for i in range(0, len(payload), 65536)], timeout=10)
    assert st == 200 and b'"bytes": 2500000' in body
    assert _read(os.path.join(_dir(vs), f"{VID}.ecx")) == payload
    for query in ("ext=.sh", "ext=.ecx&collection=../x"):
        st, body, _h = http_bytes(
            "POST", f"{vs.url}/admin/receive_file?volumeId={VID}&{query}",
            b"x", timeout=10)
        assert st == 400, body
    r = http_json("POST", f"{vs.url}/admin/ec/generate",
                  {"volumeId": 99}, timeout=10)
    assert "not found" in r.get("error", ""), r
    assert sorted(os.listdir(_dir(vs))) == [f"{VID}.ecx"]


def test_shard_write_dying_stream_leaves_nothing(servers):
    """A chunked upload whose framing breaks mid-body is refused and its
    temp removed; nothing is registered for a commit."""
    import socket
    (vs,) = servers(1)
    host, port = vs.url.split(":")
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(b"POST /admin/ec/shard_write?volumeId=1&shardId=3"
                  b"&collection=&uploadId=abc HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n"
                  b"10\r\n0123456789abcdef\r\nzz\r\n")
        reply = b""
        while chunk := s.recv(4096):   # the server closes after replying
            reply += chunk
    assert reply.startswith(b"HTTP/1.1 500"), reply
    assert b"malformed chunk" in reply
    deadline = time.monotonic() + 5
    while os.listdir(_dir(vs)) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert os.listdir(_dir(vs)) == []
    r = http_json("POST", f"{vs.url}/admin/ec/shard_write_commit",
                  {"volumeId": 1, "uploadId": "abc", "shardId": 3,
                   "crc32": 0, "bytes": 16}, timeout=10)
    assert "unknown staged upload" in r.get("error", ""), r


def test_codec_on_a_missing_card_fails_the_request(golden, tmp_path):
    """A server left on its default device (the card) answers a generate
    with the card's absence: no silent CPU run, no shard left."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, files = golden
    d = tmp_path / "card"
    d.mkdir()
    vs = VolumeServer([str(d)]).start()
    try:
        place_volume(vs, files)
        http_json("POST", f"{vs.url}/admin/set_readonly", {"volumeId": VID},
                  timeout=10)
        r = http_json("POST", f"{vs.url}/admin/ec/generate",
                      {"volumeId": VID}, timeout=60)
        assert "no CUDA device" in r.get("error", ""), r
        assert sorted(os.listdir(d)) == [f"{VID}.dat", f"{VID}.idx"]
    finally:
        vs.stop()


def test_volume_command_line_starts_serves_and_stops(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
         "-dir", str(tmp_path), "-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path))
    try:
        # the url line, within a deadline (a hung start must not hang
        # the test)
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        line = proc.stdout.readline() if ready else ""
        m = re.fullmatch(r"volume server listening on (\S+:\d+)\n", line)
        assert m, (line, proc.stderr.read() if proc.poll() else "")
        r = http_json("GET", f"{m.group(1)}/admin/ec/info?volumeId=3",
                      timeout=10)
        assert r == {"error": "ec volume 3 not mounted"}
        proc.terminate()
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_concurrent_uploads_and_commits(servers):
    """Sixteen shard uploads and their commits at once on one receiver,
    with a short switch interval: every staged upload is registered and
    committed exactly once, with its own bytes."""
    import threading
    import zlib
    (vs,) = servers(1)
    payloads = {sid: np.random.default_rng(sid).bytes(200_000 + sid)
                for sid in range(16)}
    results = {}

    def upload(sid):
        data = payloads[sid]
        st, _b = http_stream_request(
            "POST", f"{vs.url}/admin/ec/shard_write?volumeId=2&shardId={sid}"
            f"&collection=&uploadId=up{sid}",
            [data[i:i + 50_000] for i in range(0, len(data), 50_000)],
            timeout=30)
        results[sid] = (st, http_json(
            "POST", f"{vs.url}/admin/ec/shard_write_commit",
            {"volumeId": 2, "uploadId": f"up{sid}", "shardId": sid,
             "crc32": zlib.crc32(data), "bytes": len(data)}, timeout=30))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=upload, args=(sid,))
                   for sid in payloads]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for sid, data in payloads.items():
        st, r = results[sid]
        assert st == 200 and r == {"shardIds": [sid], "bytes": len(data)}, r
        assert _read(os.path.join(_dir(vs), f"2.ec{sid:02d}")) == data
    assert vs._pending_shard_writes == {}
