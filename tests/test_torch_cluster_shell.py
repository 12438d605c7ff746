"""The shell's `ec.encode` / `ec.rebuild` / `ec.decode` over a cluster,
with the port on one side or both, on the CPU.  Tolerance: exact byte
equality.

Each case runs one master, seven volume servers and one shell, all
in-process on loopback:
- the JAX package's shell and master over port volume servers;
- the port's shell and master over the JAX package's volume servers,
  and over port volume servers;
- both shells and masters over a cluster that mixes the two kinds.

Steps: encode volume 1 (`-mode=scatter` or `-mode=local`), stop a shard
server and drop its disk, rebuild (`-mode=stream` or `-mode=copy`),
decode.  After the encode and after the rebuild every shard and sidecar
equals what the JAX package's `write_ec_files` writes for the volume;
the decoded `.dat` and `.idx` equal the originals, and no shard file is
left.  Both shells' output lines have the same shape.

The volume is ~5 MiB, seeded, with the real 1 MiB small blocks (1 MiB
shards); codec batches, staging windows and rebuild slices are 1 MiB,
and port servers run their codec with `device="cpu"`.  Servers pulse
every `PULSE` (0.2 s); the masters expect a pulse every `MASTER_PULSE`
(1 s), so a stopped server drops out of their live sets after 3 s.
That margin is for load: with 7 servers, a master and a shell in one
process beside other test processes, a live server's pulses have come
more than 0.6 s apart, and a master that expected 0.2 s pulses dropped
it mid-command.
"""

import os
import re
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.storage.erasure_coding import ec_decoder as ref_decoder
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.ec_context import (
    ECContext as RefContext)
from seaweedfs_tpu_torch.server.httpd import http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv
from seaweedfs_tpu_torch.shell import run_command as port_run_command
from seaweedfs_tpu_torch.storage.erasure_coding import ec_context
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

VID = 1
TOTAL = 14
PULSE = 0.2
MASTER_PULSE = 1.0
NODES = 7


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """A seeded ~5 MiB volume (.dat/.idx from the port's Volume) and the
    .ecx, .vif and 14 shards the JAX package's pipeline writes for it."""
    d = tmp_path_factory.mktemp("golden")
    v = Volume(str(d), VID)
    rng = np.random.default_rng(11)
    nid = 0
    while v.dat_size() < 5 << 20:
        nid += 1
        v.write_needle(Needle(cookie=nid, id=nid,
                              data=rng.bytes(int(rng.integers(1000,
                                                              300_000)))))
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
    assert len(files[0]) == 1 << 20
    return files


@pytest.fixture(autouse=True)
def small_sizes(monkeypatch):
    monkeypatch.setattr(ec_context, "DEVICE_BATCH_SIZE", 1 << 20)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_REBUILD_SLICE_MB", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "1")


class Cluster:
    """One master (`ctl`: "ref" or "port"), NODES volume servers of the
    kinds in `kinds`, and that side's shell.  Server 0 holds volume 1
    when it starts."""

    def __init__(self, tmp_path, ctl: str, kinds: "list[str]", files):
        self.ctl = ctl
        if ctl == "ref":
            self.master = RefMaster(volume_size_limit_mb=64,
                                    pulse_seconds=MASTER_PULSE).start()
            self.env = RefEnv(self.master.url)
            self.run_command = ref_run_command
        else:
            self.master = MasterServer(volume_size_limit_mb=64,
                                       pulse_seconds=MASTER_PULSE).start()
            self.env = CommandEnv(self.master.url)
            self.run_command = port_run_command
        self.servers = []
        self.dirs = []
        for i, kind in enumerate(kinds):
            d = str(tmp_path / f"{kind}{i}")
            os.makedirs(d)
            if i == 0:
                for ext in (".dat", ".idx"):
                    with open(os.path.join(d, f"{VID}{ext}"), "wb") as f:
                        f.write(files[ext])
            if kind == "ref":
                vs = RefServer([d], self.master.url, pulse_seconds=PULSE)
            else:
                vs = VolumeServer([d], device="cpu", master=self.master.url,
                                  pulse_seconds=PULSE)
            self.servers.append(vs.start())
            self.dirs.append(d)
        self.wait(lambda: len(self.nodes()) == len(kinds) and
                  VID in self.normal_volumes(), "cluster up")

    def get(self, path: str) -> dict:
        return http_json("GET", f"{self.master.url}{path}", timeout=10)

    def nodes(self) -> "list[str]":
        return self.get("/cluster/status")["dataNodes"]

    def normal_volumes(self) -> "set[int]":
        return {v["id"]
                for dc in self.get("/vol/list")["dataCenters"].values()
                for rack in dc["racks"].values()
                for node in rack["nodes"] for v in node["volumes"]}

    def ec_locations(self) -> "dict[str, list[int]]":
        r = self.get(f"/dir/ec_lookup?volumeId={VID}")
        return {loc["url"]: loc["shardIds"]
                for loc in r.get("shardIdLocations", [])}

    @staticmethod
    def wait(cond, what: str, timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            assert time.monotonic() < deadline, f"timed out: {what}"
            time.sleep(0.05)

    def shell(self, line: str) -> str:
        """`lock; <line>; unlock` on this side's shell: the command's
        output."""
        self.env.lock()
        try:
            return self.run_command(self.env, line)
        finally:
            self.env.unlock()

    def stop_server_with_disk(self, i: int) -> None:
        """Server i goes away with its disk.  The JAX package's master
        keeps a silent node's shards in its lookups, so under it the
        shards are deleted first (the server's next pulse reports them
        gone); the port's master drops the node itself."""
        vs = self.servers[i]
        if self.ctl == "ref":
            r = http_json("POST", f"{vs.url}/admin/ec/delete_shards",
                          {"volumeId": VID, "shardIds": list(range(TOTAL))},
                          timeout=10)
            assert "error" not in r, r
        vs.stop()
        shutil.rmtree(self.dirs[i])
        self.wait(lambda: vs.url not in self.nodes() and
                  vs.url not in self.ec_locations(), "stopped server gone")

    def close(self) -> None:
        for vs in self.servers:
            vs.stop()
        self.master.stop()

    def shard_files(self) -> "dict[str, dict]":
        """{dir: {name: bytes}} of every EC file in the live dirs."""
        out = {}
        for d in self.dirs:
            if os.path.isdir(d):
                out[d] = {n: _read(os.path.join(d, n))
                          for n in os.listdir(d) if ".ec" in n or
                          n.endswith(".vif")}
        return out


def _check_shards(cluster: Cluster, files) -> None:
    """Every shard exactly once across the live servers, as the master
    lists them, each equal to the JAX package's, with equal sidecars
    beside it."""
    seen = {}
    for d, names in cluster.shard_files().items():
        for name, data in names.items():
            m = re.fullmatch(rf"{VID}\.ec(\d\d)", name)
            if m:
                sid = int(m.group(1))
                assert sid not in seen, f"shard {sid} in {seen[sid]} and {d}"
                seen[sid] = d
                assert data == files[sid], f"shard {sid} in {d}"
            elif name in (f"{VID}.ecx", f"{VID}.vif"):
                assert data == files[name[len(str(VID)):]], (d, name)
    assert sorted(seen) == list(range(TOTAL))
    listed = sorted(s for sids in cluster.ec_locations().values()
                    for s in sids)
    assert listed == list(range(TOTAL))


def shape(line: str) -> str:
    """An output line with its numbers and host:port addresses blanked:
    what the two shells must agree on."""
    line = re.sub(r"\d+\.\d+\.\d+\.\d+:\d+", "HOST", line)
    return re.sub(r"\d+(?:\.\d+)?(?:e-?\d+)?", "N", line)


SHAPES = {
    "scatter": "volume N: scatter-encoded N shards from HOST to N "
               "destinations, deleted originals [NMB scattered, NMB "
               "local, N GB/s volume-rate, window pN Nms]",
    "local": "volume N: encoded N shards on HOST, moved N shards, "
             "deleted originals",
    "stream": "volume N: rebuilt shards [N, N] on HOST, rebalanced N "
              "[streamed NMB from N sources, N GB/s volume-rate, slice "
              "pN Nms]",
    "copy": "volume N: rebuilt shards [N, N] on HOST, rebalanced N",
    "decode": "volume N: decoded to normal volume on HOST",
}


@pytest.mark.parametrize("ctl,kinds,encode,rebuild", [
    ("ref", ["port"] * NODES, "scatter", "stream"),
    ("ref", ["port"] * NODES, "local", "copy"),
    ("port", ["ref"] * NODES, "scatter", "stream"),
    ("port", ["ref"] * NODES, "local", "copy"),
    ("port", ["port"] * NODES, "scatter", "stream"),
    ("port", ["port"] * NODES, "local", "copy"),
    ("ref", ["port", "ref"] * 3 + ["port"], "scatter", "stream"),
    ("port", ["ref", "port"] * 3 + ["ref"], "scatter", "copy"),
], ids=["ref-over-port-scatter-stream", "ref-over-port-local-copy",
        "port-over-ref-scatter-stream", "port-over-ref-local-copy",
        "port-over-port-scatter-stream", "port-over-port-local-copy",
        "ref-over-mixed-scatter-stream", "port-over-mixed-scatter-copy"])
def test_ec_encode_rebuild_decode(golden, tmp_path, ctl, kinds, encode,
                                  rebuild):
    files = golden
    cluster = Cluster(tmp_path, ctl, kinds, files)
    try:
        out = cluster.shell(f"ec.encode -volumeId={VID} -mode={encode}")
        assert shape(out) == SHAPES[encode], out
        cluster.wait(lambda: VID not in cluster.normal_volumes(),
                     "original volume gone")
        assert cluster.get(f"/dir/lookup?volumeId={VID}")["locations"]
        assert not os.path.exists(os.path.join(cluster.dirs[0],
                                               f"{VID}.dat"))
        _check_shards(cluster, files)

        # a shard holder other than the source, with two shards
        locs = cluster.ec_locations()
        victim = next(i for i, vs in enumerate(cluster.servers)
                      if i and len(locs.get(vs.url, ())) == 2)
        lost = locs[cluster.servers[victim].url]
        cluster.stop_server_with_disk(victim)
        out = cluster.shell(f"ec.rebuild -volumeId={VID} -mode={rebuild}")
        assert shape(out) == SHAPES[rebuild], out
        assert f"rebuilt shards {lost} on" in out, (out, lost)
        _check_shards(cluster, files)

        out = cluster.shell(f"ec.decode -volumeId={VID}")
        assert shape(out) == SHAPES["decode"], out
        target = out.rsplit(" ", 1)[1]
        d = next(d for vs, d in zip(cluster.servers, cluster.dirs)
                 if vs.url == target)
        for ext in (".dat", ".idx"):
            assert _read(os.path.join(d, f"{VID}{ext}")) == files[ext], ext
        assert cluster.get(f"/dir/lookup?volumeId={VID}")["locations"] == \
            [{"url": target, "publicUrl": target}]
        assert not any(n for names in cluster.shard_files().values()
                       for n in names if ".ec" in n)
    finally:
        cluster.close()
