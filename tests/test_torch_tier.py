"""The port's volume tiers (`seaweedfs_tpu_torch/storage/backend.py`, the
tiered and mmap paths of `storage/volume.py` and `store.py`, the volume
server's `/admin/tier_move`, `/admin/tier_fetch` and `/admin/query`, the
five `volume.tier.*` verbs) on the CPU, against the JAX package's.
Tolerance: exact equality (needle bytes, tier objects, shard files, the
servers' answers).

- the JAX suites run on the port (`jax_suite.load_suite`): `test_tier.py`
  whole, `test_query.py::test_volume_query_rpc`,
  `test_shell_singles_r5.py::test_volume_tier_compact_reclaims_remote_space`
  and the two mmap tests of `test_util_l0.py`;
- a volume written alike by both packages (one fixed clock) and tiered
  by each package's volume server: the two tier objects are the `.dat`
  byte for byte, and each tiered volume (its `.vif` `files` entry and its
  object) mounts remote and read-only in the other package's `Store`,
  needle for needle;
- a volume tiered and fetched back by the port's server, encoded on the
  port's codec (the CPU's plain path): `.ecx` and `.ec00`-`.ec13` equal
  the JAX package's for the volume as written;
- `ec.encode` of a still-tiered volume fails as on the JAX server, in
  both modes, without a codec call;
- after `volume.tier.compact`, every read path of the server (the Python
  port, the hot-needle cache, the native read plane, the UDS reader)
  reads the compacted volume's needles whole, remote and fetched back.
"""

import json
import os
import re

import numpy as np
import pytest

from jax_suite import load_suite, port_volume_server
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.shell.commands import CommandEnv as RefEnv
from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.uds_reader import uds_read_needle
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.commands import CommandEnv
from seaweedfs_tpu_torch.storage import backend as port_backend
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.backend import S3BackendStorage
from seaweedfs_tpu_torch.storage.store import Store as PortStore

from test_torch_maintenance import needs_gpp
from test_torch_ec_files import (EXTS, _encode_port, _encode_ref, _read,
                                 patched_blocks)  # noqa: F401
from test_torch_profiling import stop_background_probes
from test_torch_write_path import Cluster, _wait


PORTED = ("seaweedfs_tpu.s3", "seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server",
          "seaweedfs_tpu.server.volume_server", "seaweedfs_tpu.filer",
          "seaweedfs_tpu.shell", "seaweedfs_tpu.storage",
          "seaweedfs_tpu.query")


globals().update(load_suite("test_tier", PORTED, fixtures=("cluster",),
                            overrides={"VolumeServer": port_volume_server}))
globals().update(load_suite(
    "test_util_l0", PORTED,
    only=("test_volume_mmap_read_path",
          "test_volume_mmap_survives_compaction_with_diff_replay")))


# --- across the packages --------------------------------------------------------

AK, SK = "tierkey", "tiersecret"
VID = 7
COOKIE = 0x5EED


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    """The tier: a port S3 gateway over a port filer and cluster of its
    own (the reference's own trick)."""
    tmp = tmp_path_factory.mktemp("target")
    c = Cluster(tmp, "port", racks=("r1",), size_limit_mb=64)
    fs = FilerServer(c.url, store_path=str(tmp / "f.db")).start()
    gw = S3ApiServer(fs.filer, credentials={AK: SK}).start()
    yield gw
    gw.stop()
    fs.stop()
    c.close()
    stop_background_probes()


def _stamp(self):
    self.last_append_at_ns = max(1_700_000_000_000_000_000,
                                 self.last_append_at_ns + 1)
    return self.last_append_at_ns


def _payloads(n: int = 24, seed: int = 22) -> dict:
    rng = np.random.default_rng(seed)
    return {i: rng.integers(0, 256, int(rng.integers(100, 20_000)),
                            dtype=np.uint8).tobytes()
            for i in range(1, n + 1)}


def _write_volume(kind: str, directory: str, payloads: dict) -> None:
    """The same volume in either package, its records stamped by one
    fixed clock: byte-identical `.dat` and `.idx`."""
    vol = (port_volume if kind == "port" else ref_volume).Volume
    nd = (port_needle if kind == "port" else ref_needle).Needle
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vol, "_next_append_at_ns", _stamp)
        v = vol(directory, VID)
        for key, data in payloads.items():
            v.write_needle(nd(cookie=COOKIE, id=key, data=data))
        v.close()


def _object(gw, key: str) -> bytes:
    s = S3BackendStorage("check", gw.url, "tier", AK, SK)
    return s.read_range(key, 0, s.size_of(key))


@pytest.fixture(scope="module")
def tiered(target, tmp_path_factory):
    """The volume written by each package, tiered by that package's
    volume server to `target`, the servers stopped after: {kind: (the
    server's data dir, its tier key, the .dat's bytes before)}."""
    tmp = tmp_path_factory.mktemp("tiered")
    payloads = _payloads()
    out = {}
    for kind in ("port", "ref"):
        c = Cluster(tmp / kind, kind, racks=("r1",), size_limit_mb=64)
        try:
            d, vs = c.dirs[0], c.servers[0]
            _write_volume(kind, d, payloads)
            with open(os.path.join(d, f"{VID}.dat"), "rb") as f:
                before = f.read()
            assert "error" not in http_json(
                "POST", f"{vs.url}/admin/mount_volume", {"volumeId": VID})
            r = http_json("POST", f"{vs.url}/admin/tier_move", {
                "volumeId": VID, "endpoint": target.url, "bucket": "tier",
                "accessKey": AK, "secretKey": SK}, timeout=120)
            assert r["key"] == f"{VID}.{vs.http.port}.dat", r
            assert not os.path.exists(os.path.join(d, f"{VID}.dat"))
            status = http_json("GET", f"{vs.url}/status")
            assert [v["remoteTiered"] for v in status["volumes"]] == [True]
            out[kind] = (d, r["key"], before)
        finally:
            c.close()
    yield payloads, out
    stop_background_probes()


def test_the_tier_object_is_the_volume_in_both_packages(target, tiered):
    payloads, out = tiered
    objects = {k: _object(target, key) for k, (_d, key, _b) in out.items()}
    assert objects["port"] == objects["ref"] == out["port"][2] == \
        out["ref"][2]


@pytest.mark.parametrize("tierer,reader", [("ref", "port"), ("port", "ref")])
def test_a_tiered_volume_mounts_in_the_other_package(target, tiered, tierer,
                                                     reader):
    """The `.vif` `files` entry and the object one package's server left
    open as a remote, read-only volume in the other's `Store`, needle for
    needle; writes are refused there."""
    payloads, out = tiered
    d = out[tierer][0]
    backend = port_backend if reader == "port" else ref_backend
    backend.configure_s3_backend("default", target.url, "tier", AK, SK)
    store_cls = PortStore if reader == "port" else RefStore
    nd = (port_needle if reader == "port" else ref_needle).Needle
    store = store_cls([d])
    try:
        v = store.find_volume(VID)
        assert v is not None and v.is_remote and v.read_only
        for key, data in payloads.items():
            assert store.read_needle(VID, key, cookie=COOKIE).data == data
        hb = store.collect_heartbeat()
        assert [x["remoteTiered"] for x in hb["volumes"]] == [True]
        with pytest.raises(PermissionError):
            store.write_needle(VID, nd(cookie=COOKIE, id=999, data=b"no"))
    finally:
        store.close()


def test_fetched_volume_encodes_to_the_jax_shards(tmp_path, target,
                                                  patched_blocks):
    """A volume tiered and fetched back by the port's server, encoded on
    the port's codec (the CPU's plain path), gives the shards the JAX
    package gives the volume as written."""
    payloads = _payloads(40, seed=23)
    (tmp_path / "ref").mkdir()
    _write_volume("ref", str(tmp_path / "ref"), payloads)
    c = Cluster(tmp_path, "port", racks=("r1",), size_limit_mb=64)
    try:
        d, vs = c.dirs[0], c.servers[0]
        _write_volume("port", d, payloads)
        http_json("POST", f"{vs.url}/admin/mount_volume", {"volumeId": VID})
        r = http_json("POST", f"{vs.url}/admin/tier_move", {
            "volumeId": VID, "endpoint": target.url, "bucket": "tier",
            "accessKey": AK, "secretKey": SK}, timeout=120)
        assert "error" not in r, r
        r = http_json("POST", f"{vs.url}/admin/tier_fetch",
                      {"volumeId": VID}, timeout=120)
        assert "error" not in r, r
        v = vs.store.find_volume(VID)
        assert not v.is_remote and not v.read_only
        http_json("POST", f"{vs.url}/admin/set_readonly", {"volumeId": VID})
        v.sync()
        base = os.path.join(d, str(VID))
        _encode_port(base)
    finally:
        c.close()
    ref_base = str(tmp_path / "ref" / str(VID))
    _encode_ref(ref_base)
    for ext in EXTS:
        if ext == ".vif":
            continue
        assert _read(base + ext) == _read(ref_base + ext), ext
    # the .vif: the same scheme and size; the fetched volume's also keeps
    # its cleared tier binding (`files: []`, as the JAX server leaves it)
    port_vif, ref_vif = (json.loads(_read(b + ".vif"))
                         for b in (base, ref_base))
    for k in ("version", "datFileSize", "ecShardConfig"):
        assert port_vif.get(k) == ref_vif.get(k), k


def _masked(text: str) -> str:
    return re.sub(r"/\S+/\d+\.dat|127\.0\.0\.1:\d+", "X", text)


def test_ec_encode_of_a_tiered_volume_answers_as_the_jax_server(
        tmp_path, target, monkeypatch):
    """`ec.encode` of a volume still on its tier fails with the JAX
    server's error in both modes, and no codec call is made."""
    calls = []
    real = rs_cuda.gf_apply_matrix_words
    monkeypatch.setattr(rs_cuda, "gf_apply_matrix_words",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    answers = {}
    for kind in ("port", "ref"):
        c = Cluster(tmp_path / kind, kind, racks=("r1",), size_limit_mb=64)
        try:
            _write_volume(kind, c.dirs[0], _payloads(8))
            vs = c.servers[0]
            http_json("POST", f"{vs.url}/admin/mount_volume",
                      {"volumeId": VID})
            _wait(lambda: c.get(f"/dir/lookup?volumeId={VID}").get(
                "locations"), "the master lists the volume")
            env = (CommandEnv if kind == "port" else RefEnv)(c.url)
            run = run_command if kind == "port" else ref_run_command
            run(env, "lock")
            run(env, f"volume.tier.upload -volumeId={VID} "
                     f"-endpoint={target.url} -bucket=tier "
                     f"-accessKey={AK} -secretKey={SK}")
            got = []
            for mode in ("", " -mode=local"):
                with pytest.raises(RuntimeError) as e:
                    run(env, f"ec.encode -volumeId={VID}{mode}")
                got.append(_masked(str(e.value)))
            answers[kind] = got
        finally:
            c.close()
    assert answers["port"] == answers["ref"]
    assert "No such file or directory" in answers["port"][0]
    assert calls == []


@needs_gpp
@pytest.mark.parametrize("path", ["http", "cache", "read_plane", "uds"])
def test_reads_after_tier_compact_return_the_compacted_bytes(
        tmp_path, target, path):
    """After `volume.tier.compact` (fetch, vacuum, upload) the volume's
    needles read back whole on each read path of the server, while it is
    remote and once it is fetched back: the Python port with the
    hot-needle cache off, the cache, the native read plane (it owns no
    remote volume: a 404 sends the read to the Python port) and the UDS
    reader.  Every path was warmed on the volume before the compaction,
    so an entry kept across a swap would read the old layout."""
    c = Cluster(tmp_path, "port", racks=("r1",), size_limit_mb=64)
    try:
        vs = c.servers[0]
        if path != "cache":
            vs.needle_cache = None
        payloads = _payloads(30, seed=31)
        http_json("POST", f"{vs.url}/admin/allocate_volume",
                  {"volumeId": VID})
        fids = {}
        for key, data in payloads.items():
            fid = f"{VID},{key:x}{COOKIE:08x}"
            st, body, _ = http_bytes("POST", f"{vs.url}/{fid}", data)
            assert st == 201, body
            fids[fid] = data

        def read(fid):
            if path == "uds":
                return uds_read_needle(vs.uds_server.sock_path, VID,
                                       int(fid.split(",")[1][:-8], 16)).data
            if path == "read_plane":
                host = vs.url.rsplit(":", 1)[0]
                st, body, _ = http_bytes(
                    "GET", f"{host}:{vs.read_plane.port}/{fid}")
                if st == 200:
                    return body
                assert st == 404      # not the plane's: the Python port
            st, body, _ = http_bytes("GET", f"{vs.url}/{fid}")
            assert st == 200, (fid, st)
            return body

        for _ in range(2):            # the second round from warm paths
            assert all(read(f) == d for f, d in fids.items())
        doomed = sorted(fids)[::2]
        for fid in doomed:
            assert http_bytes("DELETE", f"{vs.url}/{fid}")[0] == 202
            fids.pop(fid)
        env = CommandEnv(c.url)
        run_command(env, "lock")
        run_command(env, f"volume.tier.move -volumeId={VID} "
                         f"-endpoint={target.url} -bucket=tier "
                         f"-accessKey={AK} -secretKey={SK}")
        assert all(read(f) == d for f, d in fids.items())
        key = f"{VID}.{vs.http.port}.dat"
        before = len(_object(target, key))
        out = run_command(env, f"volume.tier.compact -volumeId={VID}")
        assert f": {before} -> " in out
        after = len(_object(target, key))
        assert after < before
        v = vs.store.find_volume(VID)
        assert v.is_remote and v.dat_size() == after
        for _ in range(2):
            assert all(read(f) == d for f, d in fids.items())
        run_command(env, f"volume.tier.fetch -volumeId={VID}")
        assert os.path.getsize(os.path.join(c.dirs[0], f"{VID}.dat")) == \
            after
        for _ in range(2):
            assert all(read(f) == d for f, d in fids.items())
        if path == "read_plane":
            assert vs.read_plane.served() > 0
        for fid in doomed:
            assert http_bytes("GET", f"{vs.url}/{fid}")[0] == 404
    finally:
        c.close()


def test_c30_collection_wide_tier_compact_finds_tiered_volumes(tmp_path,
                                                               target):
    """C30: the JAX master keeps no `remoteTiered` of a heartbeat's
    volumes, so `volume.tier.compact` without `-volumeId` finds no tiered
    volume there, whatever its garbage; the port's master lists it, and
    the verb compacts the volume on its tier."""
    out = {}
    for kind in ("port", "ref"):
        c = Cluster(tmp_path / kind, kind, racks=("r1",), size_limit_mb=64)
        try:
            d, vs = c.dirs[0], c.servers[0]
            payloads = _payloads(20, seed=41)
            _write_volume(kind, d, payloads)
            vol = (port_volume if kind == "port" else ref_volume).Volume
            nd = (port_needle if kind == "port" else ref_needle).Needle
            v = vol(d, VID)
            for key in list(payloads)[::2]:
                v.delete_needle(nd(cookie=COOKIE, id=key))
            v.close()
            http_json("POST", f"{vs.url}/admin/mount_volume",
                      {"volumeId": VID})
            _wait(lambda: c.get(f"/dir/lookup?volumeId={VID}").get(
                "locations"), "the master lists the volume")
            env = (CommandEnv if kind == "port" else RefEnv)(c.url)
            run = run_command if kind == "port" else ref_run_command
            run(env, "lock")
            run(env, f"volume.tier.move -volumeId={VID} "
                     f"-endpoint={target.url} -bucket=tier "
                     f"-accessKey={AK} -secretKey={SK}")
            _wait(lambda: any(
                x["id"] == VID and x.get("deletedByteCount")
                for n in c.get("/vol/list")["dataCenters"].values()
                for r in n["racks"].values() for node in r["nodes"]
                for x in node["volumes"]), "the master sees the garbage")
            out[kind] = run(env, "volume.tier.compact -garbageThreshold=0.3")
        finally:
            c.close()
    assert out["ref"] == "no remote volumes above the garbage threshold"
    assert re.fullmatch(rf"volume {VID} on \S+: \d+ -> \d+ bytes remote",
                        out["port"]), out["port"]
    before, after = map(int, re.findall(r"(\d+) (?:->|bytes)",
                                        out["port"]))
    assert after < before
