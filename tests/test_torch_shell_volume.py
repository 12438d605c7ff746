"""The port's volume maintenance verbs of the shell on the CPU, against
the JAX package's.  Tolerance: exact equality (move plans, live needle
bytes, output lines where both packages print them).

- every ported verb over an in-process port cluster (a master, 4 volume
  servers on 2 racks, a filer): volume.vacuum, .scrub, .grow, .copy,
  .move, .mark, .unmount, .mount, .delete, .delete.empty,
  .configure.replication, .server.state, .server.leave,
  .vacuum.disable/.enable, .replica.check, .check.disk, .fsck,
  .fix.replication, .merge, .balance, .server.evacuate, collection.list,
  collection.delete, cluster.check, .ps, .status, sleep, ec.balance,
  ec.rebalance.proportional, trace.show, qos.status and qos.set;
- the move plans of volume.balance, ec.balance,
  ec.rebalance.proportional and volume.server.evacuate on seeded
  topologies, equal to the JAX functions' on the same topologies;
- `ec.balance` on racks of 4 and 3 servers leaves 3 shards on a server,
  which the ec_balance detection flags again (C19; the port's rack caps
  give way to the servers' share, so it balances to 2 a server);
- `ec.balance` of an EC volume in a named collection (C20): the JAX
  command pulls its shards under the wrong name and fails;
- volume.fix.replication under a write between its file copies (C18):
  the JAX command copies a writable volume, so the new replica's `.idx`
  names a record its `.dat` lacks; the port freezes the holders first;
- a vacuum between a volume copy's `.dat` and `.idx` pulls (C21): the
  JAX copy mixes the two layouts; the port's copy holds the source
  volume, which the vacuum answers with 409.

Needles of 1-20 KB; servers pulse every `PULSE` seconds and the master
drops a server after 3 x `MASTER_PULSE`.
"""

import copy
import json
import os
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.shell import admin_commands as ref_admin
from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu.shell import fs_commands as ref_fs
from seaweedfs_tpu_torch import operation, qos, tracing
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import (http_bytes, http_json,
                                              http_relay)
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import admin_commands, commands, fs_commands
from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
from seaweedfs_tpu_torch.storage import idx, types
from seaweedfs_tpu_torch.topology import (iter_volume_list_ec_shards,
                                          iter_volume_list_volumes)

PULSE = 0.2
MASTER_PULSE = 1.0


def _wait(cond, what: str, timeout: float = 30.0) -> None:
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out: {what}"
        time.sleep(0.05)


def _payload(i: int, n: int) -> bytes:
    return np.random.default_rng([13, i]).bytes(n)


class Cluster:
    def __init__(self, tmp, n: int = 4, replication: str = "000",
                 filer: bool = False):
        self.master = MasterServer(default_replication=replication,
                                   pulse_seconds=MASTER_PULSE).start()
        self.url = self.master.url
        self.dirs, self.servers = [], []
        for i in range(n):
            self.add_server(os.path.join(str(tmp), f"v{i}"), f"r{i % 2}")
        _wait(lambda: len(self.nodes()) == n, "servers registered")
        self.filer = FilerServer(self.url, store_path=os.path.join(
            str(tmp), "filer.db")).start() if filer else None
        self.env = CommandEnv(self.url,
                              filer=self.filer.url if filer else "")
        run_command(self.env, "lock")

    def add_server(self, d: str, rack: str) -> VolumeServer:
        os.makedirs(d, exist_ok=True)
        vs = VolumeServer([d], device="cpu", master=self.url,
                          pulse_seconds=PULSE, rack=rack).start()
        self.dirs.append(d)
        self.servers.append(vs)
        return vs

    def nodes(self) -> list:
        return http_json("GET", f"{self.url}/cluster/status",
                         timeout=10)["dataNodes"]

    def run(self, line: str) -> str:
        return run_command(self.env, line)

    def by_url(self, url: str) -> VolumeServer:
        return next(s for s in self.servers if s.url == url)

    def locs(self, vid: int) -> list:
        return sorted(loc["url"] for loc in self.env.volume_locations(vid))

    def settle(self) -> None:
        for s in self.servers:
            if not s._hb_stop.is_set():
                s._heartbeat_once()

    def close(self) -> None:
        run_command(self.env, "unlock")
        if self.filer is not None:
            self.filer.stop()
        for s in self.servers:
            s.stop()
        self.master.stop()


@pytest.fixture
def cluster(tmp_path):
    c = Cluster(tmp_path)
    yield c
    c.close()


def _write(c: Cluster, url: str, vid: int, keys, seed: int = 0) -> dict:
    out = {}
    for i in keys:
        fid = f"{vid},{i:x}{i:08x}"
        data = _payload(seed * 10_000 + i, 1000 + 97 * i % 20_000)
        st, body, _ = http_bytes("POST", f"{url}/{fid}", data, timeout=30)
        assert st == 201, (st, body)
        out[fid] = data
    return out


def _alloc(url: str, vid: int, **kw) -> None:
    r = http_json("POST", f"{url}/admin/allocate_volume",
                  {"volumeId": vid, **kw}, timeout=30)
    assert "error" not in r, r


# --- the verbs on a port cluster -----------------------------------------

def test_vacuum_scrub_grow_collections_and_cluster_views(cluster):
    c = cluster
    s0 = c.servers[0]
    _alloc(s0.url, 1)
    fids = _write(c, s0.url, 1, range(1, 31))
    for fid in sorted(fids)[:15]:
        assert http_bytes("DELETE", f"{s0.url}/{fid}")[0] == 202
        fids.pop(fid)
    c.settle()
    before = s0.store.find_volume(1).dat_size()
    assert c.run("volume.vacuum -volumeId=1") == "vacuumed volumes: [1]"
    assert s0.store.find_volume(1).dat_size() < before
    for fid, data in fids.items():
        assert http_bytes("GET", f"{s0.url}/{fid}")[1] == data
    assert c.run("volume.scrub -volumeId=1") == \
        f"volume 1 @ {s0.url}: checked 15, ok"
    out = c.run("volume.grow -collection=pics -count=2")
    assert out.startswith("grew volumes: [")
    c.settle()
    assert "pics: 2 volumes" in c.run("collection.list")
    assert "(default): 1 volumes" in c.run("collection.list")
    assert c.run("collection.delete -collection=pics").startswith(
        "this deletes EVERY volume")
    assert c.run("collection.delete -collection=pics -force").startswith(
        "deleted collection 'pics': volumes [")
    c.settle()
    assert "pics" not in c.run("collection.list")
    assert '"dataNodes"' in c.run("cluster.check")
    assert '"leader"' in c.run("cluster.status")
    ps = c.run("cluster.ps").splitlines()
    assert ps[0] == f"master {c.url} leader (term 0)"
    assert f"volume {s0.url} (1 volumes)" in ps
    state = c.run(f"volume.server.state -node={s0.url}")
    assert state.startswith(f"{s0.url}: version ") and "vol      1" in state
    assert c.run("sleep 0.01") == ""


def test_copy_move_mark_mount_delete(cluster):
    c = cluster
    s0, s1, s2 = c.servers[:3]
    _alloc(s0.url, 2)
    fids = _write(c, s0.url, 2, range(1, 11), seed=2)
    c.settle()
    assert c.run(f"volume.copy -volumeId=2 -target={s1.url}") == \
        f"copied volume 2: {s0.url} -> {s1.url}"
    c.settle()
    assert c.locs(2) == sorted([s0.url, s1.url])
    assert not s0.store.find_volume(2).read_only   # thawed after the copy
    assert c.run(f"volume.move -volumeId=2 -source={s1.url} "
                 f"-target={s2.url}") == \
        f"moved volume 2: {s1.url} -> {s2.url}"
    c.settle()
    assert c.locs(2) == sorted([s0.url, s2.url])
    for fid, data in fids.items():
        assert http_bytes("GET", f"{s2.url}/{fid}")[1] == data
    assert c.run("volume.mark -volumeId=2 -readonly") == \
        "marked volume 2 readonly on 2 servers"
    assert s0.store.find_volume(2).read_only and \
        s2.store.find_volume(2).read_only
    c.run("volume.mark -volumeId=2 -writable")
    assert not s2.store.find_volume(2).read_only
    assert c.run(f"volume.unmount -volumeId=2 -node={s2.url}") == \
        f"unmounted volume 2 on {s2.url}"
    assert s2.store.find_volume(2) is None
    c.run(f"volume.mount -volumeId=2 -node={s2.url}")
    assert s2.store.find_volume(2) is not None
    assert c.run("volume.configure.replication -volumeId=2 "
                 "-replication=001") == \
        "volume 2 replication set to 001 on 2 servers"
    assert str(s2.store.find_volume(2).super_block.replica_placement) \
        == "001"
    _alloc(s1.url, 3)
    c.settle()
    assert c.run("volume.delete.empty") == "deleted 1 empty volumes: [3]"
    assert c.run("volume.delete -volumeId=2") == \
        "deleted volume 2 from 2 servers"
    c.settle()
    assert c.locs(2) == []


def test_vacuum_gate_leave_and_replica_check(cluster):
    c = cluster
    s0, s1, s3 = c.servers[0], c.servers[1], c.servers[3]
    _alloc(s0.url, 4, replication="001")
    _alloc(s1.url, 4, replication="001")
    c.settle()
    fid = next(iter(_write(c, s0.url, 4, [1], seed=4)))
    assert c.run(f"volume.vacuum.disable -node={s0.url}") == \
        "vacuum disabled on 1 server(s)"
    with pytest.raises(RuntimeError, match="vacuum disabled"):
        c.run("volume.vacuum -volumeId=4")
    c.run("volume.vacuum.enable")
    assert c.run("volume.vacuum -volumeId=4") == "vacuumed volumes: [4]"
    assert c.run("volume.replica.check").startswith(
        "checked 1 replicated volumes: 0 divergent")
    key = int(fid.split(",")[1][:-8], 16)
    r = http_json("POST", f"{s1.url}/admin/delete_needle",
                  {"volumeId": 4, "key": key}, timeout=30)
    assert r["freed"] > 0
    assert "volume 4 DIVERGES" in c.run("volume.replica.check")
    assert "1 needles synced" in c.run("volume.check.disk -volumeId=4")
    st, body, _ = http_bytes("GET", f"{s1.url}/{fid}")
    assert st == 200 and body == http_bytes("GET", f"{s0.url}/{fid}")[1]
    out = c.run(f"volume.server.leave -node={s3.url}")
    assert out.startswith(f"{s3.url} left the cluster")
    _wait(lambda: s3.url not in c.nodes(), "the master forgot the server",
          timeout=15)


def test_fix_replication_and_merge(cluster):
    c = cluster
    s0, s1 = c.servers[0], c.servers[1]
    _alloc(s0.url, 5, replication="001")
    c.settle()
    fids = {}
    for i in range(1, 9):     # straight onto the lone replica
        fid = f"5,{i:x}{i:08x}"
        data = _payload(500 + i, 3000)
        assert http_bytes("POST", f"{s0.url}/{fid}?type=replicate",
                          data)[0] == 201
        fids[fid] = data
    c.settle()
    out = c.run("volume.fix.replication")
    c.settle()
    _wait(lambda: len(c.locs(5)) == 2, "two replicas")
    dst = next(u for u in c.locs(5) if u != s0.url)
    assert out == f"fixed replicas: ['5->{dst}']"
    assert not s0.store.find_volume(5).read_only
    assert not c.by_url(dst).store.find_volume(5).read_only
    for fid, data in fids.items():
        assert http_bytes("GET", f"{dst}/{fid}")[1] == data
    assert c.run("volume.fix.replication") == \
        "all volumes sufficiently replicated"
    # diverge: one needle on each replica only, a delete on one only
    a, b = c.locs(5)
    assert http_bytes("POST", f"{a}/5,64{100:08x}?type=replicate",
                      b"only-a")[0] == 201
    assert http_bytes("POST", f"{b}/5,65{101:08x}?type=replicate",
                      b"only-b")[0] == 201
    gone = sorted(fids)[0]
    assert http_bytes("DELETE", f"{b}/{gone}?type=replicate")[0] == 202
    out = c.run("volume.merge -volumeId=5")
    assert out.startswith(f"volume 5: merged 2 replicas ({len(fids) + 1} "
                          f"live needles")
    for url in (a, b):
        assert http_bytes("GET", f"{url}/5,64{100:08x}")[1] == b"only-a"
        assert http_bytes("GET", f"{url}/5,65{101:08x}")[1] == b"only-b"
        assert http_bytes("GET", f"{url}/{gone}")[0] == 404
        assert not c.by_url(url).store.find_volume(5).read_only


def test_balance_and_evacuate(cluster):
    c = cluster
    s0 = c.servers[0]
    data = {}
    for vid in range(10, 16):
        _alloc(s0.url, vid)
        data.update(_write(c, s0.url, vid, [1, 2], seed=vid))
    c.settle()
    assert c.run("volume.balance") == "moved 4 volumes"
    c.settle()
    counts = {s.url: 0 for s in c.servers}
    for n, _v in iter_volume_list_volumes(c.env.volume_list()):
        counts[n["url"]] += 1
    assert sorted(counts.values()) == [1, 1, 2, 2]
    victim = max(counts, key=counts.get)
    out = c.run(f"volume.server.evacuate -node={victim}")
    assert out == f"evacuated 2 volumes, 0 ec shards off {victim}"
    c.settle()
    assert not any(n["url"] == victim for n, _v in
                   iter_volume_list_volumes(c.env.volume_list()))
    for fid, d in data.items():
        assert operation.read(c.url, fid) == d


def test_ec_balance_and_proportional(cluster):
    c = cluster
    s1 = c.servers[1]
    _alloc(s1.url, 20)
    fids = _write(c, s1.url, 20, range(1, 21), seed=20)
    http_json("POST", f"{s1.url}/admin/set_readonly", {"volumeId": 20},
              timeout=30)
    assert http_json("POST", f"{s1.url}/admin/ec/generate",
                     {"volumeId": 20}, timeout=120)["shardIds"] == \
        list(range(14))
    http_json("POST", f"{s1.url}/admin/ec/mount",
              {"volumeId": 20, "shardIds": list(range(14))}, timeout=30)
    http_json("POST", f"{s1.url}/admin/delete_volume", {"volumeId": 20},
              timeout=30)
    c.settle()
    out = c.run("ec.balance")
    moved = int(out.split("moved ")[1].split()[0])
    assert out == f"volume 20: moved {moved} shards" and moved >= 10
    c.settle()
    spread = {}
    for n, e in iter_volume_list_ec_shards(c.env.volume_list()):
        spread[n["url"]] = bin(e["shardBits"]).count("1")
    assert sum(spread.values()) == 14 and max(spread.values()) <= 4
    out = c.run("ec.rebalance.proportional")
    assert out.startswith("proportionally rebalanced: moved ")
    c.settle()
    for s in c.servers:
        s._nc_drop_volume(20)
    for fid, d in list(fids.items())[:6]:
        assert operation.read(c.url, fid) == d


def test_volume_fsck_orphans_and_missing(tmp_path):
    c = Cluster(tmp_path, n=2, filer=True)
    try:
        st, _, _ = http_bytes("PUT", f"{c.filer.url}/data/keep.bin",
                              b"k" * 5000)
        assert st == 201
        orphan = operation.submit(c.url, b"orphan" * 100)
        c.settle()
        out = c.run("volume.fsck")
        assert "orphan needles (no filer reference): 1" in out, out
        assert "MISSING needles (filer references broken): 0" in out
        out = c.run("volume.fsck -reallyDeleteFromVolume -cutoffSeconds=0")
        assert "purged: 1" in out
        (loc,) = operation.lookup(c.url, int(orphan.split(",")[0]))
        assert http_bytes("GET", f"{loc['url']}/{orphan}")[0] == 404
        entry = http_json("GET", f"{c.filer.url}/__meta__/lookup?path="
                                 f"/data/keep.bin", timeout=30)
        chunk = entry["chunks"][0]["fileId"]
        operation.delete(c.url, chunk)
        assert "MISSING needles (filer references broken): 1" in \
            c.run("volume.fsck")
    finally:
        c.close()


def test_trace_show_and_qos_verbs(cluster):
    c = cluster
    s0 = c.servers[0]
    _alloc(s0.url, 30)
    rid = "shelltrace01"
    st, _, _ = http_bytes("POST", f"{s0.url}/30,1{1:08x}", b"x" * 100,
                          {tracing.REQUEST_ID_HEADER: rid})
    assert st == 201
    out = c.run(f"trace.show {rid}")
    # in-process servers share one span ring: any node may report them
    assert out.startswith(f"trace {rid}: 9 span(s)") and \
        "POST /30,100000001  [volume@" in out, out
    assert c.run("trace.show").startswith("usage: trace.show")
    assert "peer health" in c.run(f"trace.show {rid} -health")
    try:
        out = c.run("qos.set -tenant=t1 -rps=5 -burst=7")
        assert out.splitlines()[0] == \
            f"qos updated on {len(c.servers) + 1}/{len(c.servers) + 1} nodes"
        out = c.run("qos.status")
        assert f"{c.url}: enabled=" in out and \
            "  t1: rps=5.0 burst=7.0" in out, out
        assert c.run("qos.set").startswith("usage: qos.set")
        c.run("qos.set -clear")
        assert "t1:" not in c.run("qos.status")
    finally:
        qos.configure(None)


# --- move plans against the JAX functions --------------------------------

class FakeTopology:
    """A cluster that exists only as a /vol/list answer: the balance
    verbs read it and their moves change it."""

    def __init__(self, seed: int, n: int = 6, ec_piled: bool = True,
                 racks: int = 3):
        rng = np.random.default_rng(seed)
        self.nodes: dict = {}
        for i in range(n):
            url = f"127.0.0.1:{9000 + i}"
            self.nodes[url] = {"dc": "dc1", "rack": f"r{i % racks}",
                               "max": 8, "volumes": [], "ec": {}}
        urls = list(self.nodes)
        vid = 0
        for i, url in enumerate(urls):
            for _ in range(int(rng.integers(0, 7 if i < 2 else 3))):
                vid += 1
                self.nodes[url]["volumes"].append(
                    {"id": vid, "collection": "", "size": 1 << 20,
                     "fileCount": 1, "readOnly": False,
                     "replicaPlacement": 0})
        for ev in (100, 101):
            for sid in range(14):
                url = urls[0] if ec_piled and ev == 100 else \
                    urls[int(rng.integers(0, n))]
                self.nodes[url]["ec"].setdefault(ev, set()).add(sid)
        self.moves: list = []

    def volume_list(self) -> dict:
        tree: dict = {"dataCenters": {}}
        for url, nd in self.nodes.items():
            rack = tree["dataCenters"].setdefault(nd["dc"], {"racks": {}})[
                "racks"].setdefault(nd["rack"], {"nodes": []})
            rack["nodes"].append({
                "url": url, "maxVolumeCount": nd["max"],
                "volumes": copy.deepcopy(nd["volumes"]),
                "ecShards": [{"volumeId": v, "id": v, "collection": "",
                              "shardBits": sum(1 << s for s in sids),
                              "ecIndexBits": sum(1 << s for s in sids)}
                             for v, sids in sorted(nd["ec"].items())
                             if sids]})
        return tree

    def volume_locations(self, vid: int) -> list:
        return [{"url": u} for u, nd in self.nodes.items()
                if any(v["id"] == vid for v in nd["volumes"])]

    def ec_locations(self, vid: int) -> dict:
        return {u: sorted(nd["ec"][vid]) for u, nd in self.nodes.items()
                if nd["ec"].get(vid)}

    # the moves, recorded and applied
    def move_volume(self, env, vid, collection, src, dst,
                    delete_source=True):
        self.moves.append(("volume", vid, src, dst))
        v = next(v for v in self.nodes[src]["volumes"] if v["id"] == vid)
        self.nodes[dst]["volumes"].append(copy.deepcopy(v))
        if delete_source:
            self.nodes[src]["volumes"].remove(v)

    def move_shard(self, env, vid, collection, sid, src, dst):
        self.moves.append(("shard", vid, sid, src, dst))
        self.nodes[src]["ec"][vid].discard(sid)
        self.nodes[dst]["ec"].setdefault(vid, set()).add(sid)

    def delete_shards(self, url, vid, collection, sids):
        self.moves.append(("delete", vid, tuple(sids), url))
        self.nodes[url]["ec"][vid] -= set(sids)


def _patch_package(monkeypatch, topo: FakeTopology, mods: dict) -> None:
    cmds = mods["commands"]
    for mod in mods.values():
        for name, fn in (("_move_volume", topo.move_volume),
                         ("_move_shard", topo.move_shard),
                         ("_all_node_urls", lambda env: list(topo.nodes)),
                         ("_ec_shard_locations",
                          lambda env, vid: topo.ec_locations(vid)),
                         ("_ec_volumes", lambda env: {
                             v: None for nd in topo.nodes.values()
                             for v in nd["ec"]})):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)
    monkeypatch.setattr(cmds, "_delete_shards", topo.delete_shards)
    monkeypatch.setattr(cmds, "http_json", lambda *a, **k: {
        "dataShards": 10, "parityShards": 4})
    if hasattr(cmds, "retry"):
        monkeypatch.setattr(cmds.retry, "peer_available", lambda url: True)


class _Env:
    def __init__(self, topo: FakeTopology):
        self.topo = topo
        self.master = "127.0.0.1:1"
        self.filer = ""
        self.admin_token = 1

    def confirm_is_locked(self):
        pass

    def volume_list(self):
        return self.topo.volume_list()

    def volume_locations(self, vid):
        return self.topo.volume_locations(vid)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("verb", ["volume.balance", "ec.balance",
                                  "ec.rebalance.proportional",
                                  "volume.server.evacuate"])
def test_move_plans_equal_the_jax_functions(monkeypatch, verb, seed):
    plans = []
    for mods in ({"commands": ref_commands, "admin": ref_admin,
                  "fs": ref_fs},
                 {"commands": commands, "admin": admin_commands,
                  "fs": fs_commands}):
        topo = FakeTopology(seed, ec_piled=seed % 2 == 0)
        with monkeypatch.context() as m:
            _patch_package(m, topo, mods)
            args = [f"-node={list(topo.nodes)[0]}"] \
                if verb == "volume.server.evacuate" else []
            out = mods["commands"].COMMANDS[verb](_Env(topo), args)
        plans.append((out, topo.moves, topo.volume_list()))
    assert plans[1] == plans[0]
    assert plans[1][1], f"{verb} moved nothing at seed {seed}"


# --- C19: the rack-aware EC balance against its detection rule ----------

@pytest.mark.parametrize("kind", ["jax", "port"])
def test_c19_ec_balance_on_unequal_racks_leaves_what_detection_flags(
        monkeypatch, kind):
    """7 servers on 2 racks (4 and 3), 14 shards of one volume piled on
    one server.  The JAX `ec.balance` caps a rack at ceil(14 / 2) = 7
    shards, so the 3-server rack keeps 3 on one server; the ec_balance
    handler proposes while any server holds more than ceil(14 / 7) = 2,
    so it proposes again after every run.  The port caps the 3-server
    rack at 6 and the other at 8 (`_rack_caps`): 2 shards a server, and
    detection proposes nothing more."""
    from seaweedfs_tpu.plugin.handlers import balance as ref_balance
    from seaweedfs_tpu_torch.plugin.handlers import balance as port_balance
    mods, handler_mod = ({"commands": ref_commands, "admin": ref_admin,
                          "fs": ref_fs}, ref_balance) if kind == "jax" else \
        ({"commands": commands, "admin": admin_commands,
          "fs": fs_commands}, port_balance)
    topo = FakeTopology(0, n=7, racks=2)
    for nd in topo.nodes.values():
        nd["volumes"] = []
        nd["ec"] = {}
    first = next(iter(topo.nodes))
    topo.nodes[first]["ec"][100] = set(range(14))
    _patch_package(monkeypatch, topo, mods)
    mods["commands"].COMMANDS["ec.balance"](_Env(topo), [])
    per_server = sorted(len(topo.ec_locations(100).get(u, []))
                        for u in topo.nodes)
    per_rack: dict = {}
    for u, nd in topo.nodes.items():
        per_rack[nd["rack"]] = per_rack.get(nd["rack"], 0) + \
            len(topo.ec_locations(100).get(u, []))
    monkeypatch.setattr(handler_mod, "master_json", lambda m, meth, path,
                        *a, **k: topo.volume_list() if path == "/vol/list"
                        else {"dataNodes": list(topo.nodes)})

    class W:
        master = "127.0.0.1:1"
    proposals = handler_mod.EcBalanceHandler().detect(W())
    assert sum(per_server) == 14
    if kind == "jax":
        assert per_server[-1] == 3 and proposals != [], per_server
    else:
        assert per_server == [2] * 7, per_server
        assert sorted(per_rack.values()) == [6, 8], per_rack
        assert proposals == []
        # a second run moves nothing
        assert commands.COMMANDS["ec.balance"](_Env(topo), []) == \
            "volume 100: moved 0 shards"


@pytest.mark.parametrize("racks", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("n", [4, 5, 7, 9])
def test_rack_caps_reach_the_detection_rule(monkeypatch, n, racks):
    """Any rack layout: the port's `ec.balance` from 14 shards piled on
    one server leaves no server above ceil(14 / servers), no rack above
    its cap, and no proposal from the ec_balance detection."""
    from seaweedfs_tpu_torch.plugin.handlers import balance as port_balance
    topo = FakeTopology(n, n=n, racks=min(racks, n))
    for nd in topo.nodes.values():
        nd["volumes"] = []
        nd["ec"] = {}
    topo.nodes[list(topo.nodes)[-1]]["ec"][100] = set(range(14))
    _patch_package(monkeypatch, topo, {"commands": commands,
                                       "admin": admin_commands,
                                       "fs": fs_commands})
    commands.COMMANDS["ec.balance"](_Env(topo), [])
    held = {u: len(topo.ec_locations(100).get(u, [])) for u in topo.nodes}
    assert sum(held.values()) == 14
    assert max(held.values()) <= -(-14 // n), held
    monkeypatch.setattr(port_balance, "master_json", lambda m, meth, path,
                        *a, **k: topo.volume_list() if path == "/vol/list"
                        else {"dataNodes": list(topo.nodes)})

    class W:
        master = "127.0.0.1:1"
    assert port_balance.EcBalanceHandler().detect(W()) == []


# --- C18: volume.fix.replication under writes ----------------------------

def _copy_with_a_write_between(src: str, fid: str):
    """A `_copy_volume_files` that acks a write on the source between
    the `.dat` and the `.idx` copies (the status lands in `.late`)."""
    def copy_files(env, vid, collection, s, d):
        for ext in (".dat", ".idx", ".vif"):
            if ext == ".idx":
                copy_files.late = http_bytes(
                    "POST", f"{src}/{fid}?type=replicate",
                    b"late-write" * 50)[0]
            src_status, dst_status, _ = http_relay(
                f"{s}/admin/volume_file?volumeId={vid}"
                f"&collection={collection}&ext={ext}",
                "POST", f"{d}/admin/receive_file?volumeId={vid}"
                f"&collection={collection}&ext={ext}", timeout=60)
            assert ext == ".vif" or (src_status, dst_status) == (200, 200)
    copy_files.late = None
    return copy_files


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_c18_fix_replication_copies_a_consistent_volume(tmp_path,
                                                        monkeypatch, kind):
    """A write lands on the lone replica between the `.dat` and `.idx`
    copies of volume.fix.replication.  The JAX command copies the
    volume writable: the write is acked, and the new replica's `.idx`
    names a record past the end of its `.dat`.  The port freezes the
    holders first: the write is refused (409), and the new replica's
    `.idx` and `.dat` agree."""
    if kind == "jax":
        master = RefMaster(pulse_seconds=MASTER_PULSE).start()
        servers = [RefServer([str(tmp_path / f"v{i}")], master.url,
                             pulse_seconds=PULSE).start() for i in range(2)]
        mods = ref_commands
        from seaweedfs_tpu.shell.commands import CommandEnv as Env
    else:
        master = MasterServer(pulse_seconds=MASTER_PULSE).start()
        servers = [VolumeServer([str(tmp_path / f"v{i}")], device="cpu",
                                master=master.url, pulse_seconds=PULSE
                                ).start() for i in range(2)]
        mods = commands
        Env = CommandEnv
    try:
        src, dst = servers[0], servers[1]
        _alloc(src.url, 7, replication="001")
        for i in range(1, 6):
            assert http_bytes("POST", f"{src.url}/7,{i:x}{i:08x}"
                              "?type=replicate", b"x" * 2000)[0] == 201
        _wait(lambda: len(http_json("GET", f"{master.url}/cluster/status")[
            "dataNodes"]) == 2, "servers registered")
        src._heartbeat_once()
        env = Env(master.url)
        env.lock()
        late_fid = f"7,63{99:08x}"
        copy_files = _copy_with_a_write_between(src.url, late_fid)
        monkeypatch.setattr(mods, "_copy_volume_files", copy_files)
        out = mods.COMMANDS["volume.fix.replication"](env, [])
        env.unlock()
        assert out == f"fixed replicas: ['7->{dst.url}']"
        d = str(tmp_path / "v1")
        dat = open(os.path.join(d, "7.dat"), "rb").read()
        live = idx.live_entries(open(os.path.join(d, "7.idx"), "rb").read())
        past_end = [k for k, (off, size) in live.items()
                    if types.to_actual_offset(off) + size > len(dat)]
        if kind == "jax":
            assert copy_files.late == 201
            assert past_end == [99]
        else:
            assert copy_files.late == 409
            assert past_end == [] and 99 not in live
            assert not src.store.find_volume(7).read_only
    finally:
        for s in servers:
            s.stop()
        master.stop()


# --- C21: a vacuum between a volume copy's `.dat` and `.idx` pulls ------

@pytest.mark.parametrize("kind", ["jax", "port"])
def test_c21_vacuum_between_a_copys_dat_and_idx(tmp_path, monkeypatch,
                                                kind):
    """`_copy_volume_files` (volume.move, .copy, .balance,
    .fix.replication) pulls `.dat`, then `.idx`.  A vacuum of the source
    between the two: the JAX route answers 200, and the copy gets the
    old `.dat` with the compacted `.idx`, so live needles read wrong on
    the destination.  The port's copy holds the source volume: the
    vacuum answers 409, every live needle reads back on the destination,
    and the hold is gone after the copy."""
    if kind == "jax":
        from seaweedfs_tpu.server import httpd as relay_mod
        servers = [RefServer([str(tmp_path / f"v{i}")], "").start()
                   for i in range(2)]
        copy_files = ref_commands._copy_volume_files
    else:
        relay_mod = commands
        servers = [VolumeServer([str(tmp_path / f"v{i}")], device="cpu"
                                ).start() for i in range(2)]
        copy_files = commands._copy_volume_files
    src, dst = servers[0].url, servers[1].url
    try:
        _alloc(src, 7)
        data = {}
        for i in range(1, 31):
            fid = f"7,{i:x}{i:08x}"
            data[fid] = _payload(700 + i, 1000 + 331 * i)
            assert http_bytes("POST", f"{src}/{fid}", data[fid],
                              timeout=30)[0] == 201
        for fid in sorted(data)[::2]:
            assert http_bytes("DELETE", f"{src}/{fid}", timeout=30)[0] \
                in (200, 202)
            del data[fid]
        real = relay_mod.http_relay
        vacuums: list = []

        def relay(src_url, *a, **kw):
            out = real(src_url, *a, **kw)
            if "ext=.dat" in src_url:
                vacuums.append(http_bytes(
                    "POST", f"{src}/admin/vacuum",
                    b'{"volumeId": 7}',
                    {"Content-Type": "application/json"}, timeout=30))
            return out
        monkeypatch.setattr(relay_mod, "http_relay", relay)
        copy_files(None, 7, "", src, dst)
        monkeypatch.setattr(relay_mod, "http_relay", real)
        assert "error" not in http_json(
            "POST", f"{dst}/admin/mount_volume", {"volumeId": 7},
            timeout=30)
        wrong = [fid for fid, body in data.items()
                 if http_bytes("GET", f"{dst}/{fid}", timeout=30)[:2] !=
                 (200, body)]
        (st, body, _), = vacuums
        if kind == "jax":
            assert st == 200, body
            assert wrong, "the mixed copy read back whole"
        else:
            assert st == 409 and b"copy" in body, (st, body)
            assert wrong == []
            r = http_json("POST", f"{src}/admin/vacuum", {"volumeId": 7},
                          timeout=30)
            assert "error" not in r and r["datBytes"] < r["datBytesBefore"]
    finally:
        for s in servers:
            s.stop()


def test_copy_hold_is_a_lease(tmp_path):
    """`/admin/volume/hold`: a second token is refused while a hold
    lasts, the holder renews and releases it, and a lapsed lease frees
    the volume for a vacuum."""
    vs = VolumeServer([str(tmp_path / "v")], device="cpu").start()
    try:
        _alloc(vs.url, 3)

        def hold(token, seconds):
            return http_bytes("POST", f"{vs.url}/admin/volume/hold",
                              json.dumps({"volumeId": 3, "token": token,
                                          "seconds": seconds}).encode(),
                              {"Content-Type": "application/json"},
                              timeout=30)[:2]
        assert hold("a", 60)[0] == 200
        assert hold("a", 60)[0] == 200
        st, body = hold("b", 60)
        assert st == 409 and b"copy" in body
        assert hold("b", 0)[0] == 200        # not b's to release
        assert hold("b", 60)[0] == 409
        assert hold("a", 0)[0] == 200
        assert hold("b", 0.05)[0] == 200
        _wait(lambda: hold("c", 60)[0] == 200, "b's lease lapsed")
        assert hold("c", 0)[0] == 200
        r = http_json("POST", f"{vs.url}/admin/vacuum", {"volumeId": 3},
                      timeout=30)
        assert "error" not in r, r
    finally:
        vs.stop()


# --- C20: ec.balance of a volume in a named collection -------------------

@pytest.mark.parametrize("kind", ["jax", "port"])
def test_c20_ec_balance_moves_shards_under_their_own_collection(tmp_path,
                                                                kind):
    """An EC volume of collection "c" whose 14 shards sit on one of 4
    servers, and `ec.balance` without -collection (as the ec_balance
    handler runs it).  The JAX command moves every volume's shards under
    the flag's collection, "": its first pull asks for `1.ecNN`, which
    is `c_1.ecNN` on disk, and fails.  The port reads each volume's
    collection off its holder and spreads the shards."""
    if kind == "jax":
        master = RefMaster(pulse_seconds=MASTER_PULSE).start()
        servers = [RefServer([str(tmp_path / f"v{i}")], master.url,
                             pulse_seconds=PULSE, rack=f"r{i % 2}").start()
                   for i in range(4)]
        mods = ref_commands
        from seaweedfs_tpu.shell.commands import CommandEnv as Env
    else:
        master = MasterServer(pulse_seconds=MASTER_PULSE).start()
        servers = [VolumeServer([str(tmp_path / f"v{i}")], device="cpu",
                                master=master.url, pulse_seconds=PULSE,
                                rack=f"r{i % 2}").start() for i in range(4)]
        mods = commands
        Env = CommandEnv
    try:
        s0 = servers[0]
        _alloc(s0.url, 1, collection="c")
        for i in range(1, 11):
            assert http_bytes("POST", f"{s0.url}/1,{i:x}{i:08x}",
                              b"y" * 3000)[0] == 201
        http_json("POST", f"{s0.url}/admin/set_readonly", {"volumeId": 1},
                  timeout=30)
        r = http_json("POST", f"{s0.url}/admin/ec/generate",
                      {"volumeId": 1, "collection": "c"}, timeout=120)
        assert "error" not in r, r
        http_json("POST", f"{s0.url}/admin/ec/mount",
                  {"volumeId": 1, "collection": "c",
                   "shardIds": list(range(14))}, timeout=30)
        http_json("POST", f"{s0.url}/admin/delete_volume", {"volumeId": 1},
                  timeout=30)
        _wait(lambda: len(http_json("GET", f"{master.url}/cluster/status")[
            "dataNodes"]) == 4 and any(
            bin(e["shardBits"]).count("1") == 14 for _n, e in
            iter_volume_list_ec_shards(http_json(
                "GET", f"{master.url}/vol/list"))), "14 shards listed")
        env = Env(master.url)
        env.lock()
        try:
            if kind == "jax":
                with pytest.raises(RuntimeError, match=r"pull \.ec\d\d .*404"):
                    mods.COMMANDS["ec.balance"](env, [])
                return
            out = mods.COMMANDS["ec.balance"](env, [])
        finally:
            env.unlock()
        assert out.startswith("volume 1: moved ")
        for s in servers:
            s._heartbeat_once()
        spread = [bin(e["shardBits"]).count("1") for _n, e in
                  iter_volume_list_ec_shards(http_json(
                      "GET", f"{master.url}/vol/list"))]
        assert sum(spread) == 14 and max(spread) <= 4, spread
    finally:
        for s in servers:
            s.stop()
        master.stop()
