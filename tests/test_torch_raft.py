"""The port's raft (server/raft.py) and its master set, on the CPU.

- The log: persistence, snapshot compaction and the torn-tail discard,
  as `tests/test_raft_log.py` holds the JAX package's.
- Cross-reading: the same appends, truncations, compactions and votes
  through the JAX package's `RaftLog`/`RaftNode` and the port's write
  byte-identical `raft.log`, `raft.snap` and `raft.state`, and each
  package loads the other's directory to the same entries, snapshot,
  term, vote and FSM.  Tolerance: exact equality.
- A 3-master port set in process, each test of `tests/test_raft_log.py`
  (the replicated FSM and sequence bound, the kill mid-assign, the full
  restart, the diverged log, the shell verbs, the transfer); the tests of
  `tests/test_master_ha.py` are `tests/test_torch_master_ha.py`.
- `master -peers -mdir` on the command line, and the shell's prompt over
  stdin.
- The faults of ROADMAP C that this slice found (C22, C23): each shown in
  the JAX package and shown absent from the port; so is a deposed
  leader's stale election timer (ROADMAP C28).

Every listener is bound (port 0) before the masters learn the peer list;
every wait is a condition under a deadline.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.raft import RaftLog as RefLog
from seaweedfs_tpu.server.raft import RaftNode as RefNode
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu_torch import faults, operation
from seaweedfs_tpu_torch.server.httpd import http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.raft import RaftLog, RaftNode
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from test_torch_profiling import stop_background_probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAFT_PULSE = 0.15
PULSE = 0.2


def wait_for(cond, what: str, timeout: float = 15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def leader_of(masters, timeout: float = 15.0):
    """The one master holding a lease that every live master names."""
    got = []

    def one():
        up = [m for m in masters if m.raft.lease_valid()]
        if len(up) == 1 and all(m.raft.leader == up[0].url
                                for m in masters):
            got[:] = up
            return True
        return False
    wait_for(one, "one agreed leader", timeout)
    return got[0]


def port_set(n: int, meta_root=None, ports=None, **kw) -> list:
    """n port masters, each listener bound before any learns the peers;
    `ports` rebinds the given ones (a restart), retrying a port another
    process holds for a moment."""
    masters = []
    for i in range(n):
        for attempt in range(50):
            try:
                masters.append(MasterServer(
                    port=ports[i] if ports else 0,
                    raft_pulse_seconds=RAFT_PULSE, volume_size_limit_mb=64,
                    meta_dir=str(meta_root / f"m{i}") if meta_root else None,
                    **kw))
                break
            except OSError:
                if attempt == 49:
                    raise
                time.sleep(0.1)
    peers = [m.url for m in masters]
    for m in masters:
        m.set_peers(peers)
    for m in masters:
        m.start()
    return masters


def stop_all(*groups):
    for group in groups:
        for x in group:
            try:
                x.stop()
            except Exception:   # noqa: BLE001 — already stopped
                pass


def key_of(fid: str) -> int:
    return int(fid.split(",")[1][:-8], 16)


# -- the log ------------------------------------------------------------------

def test_raftlog_persistence_roundtrip(tmp_path):
    d = str(tmp_path / "r")
    log = RaftLog(d)
    log.append([{"index": 1, "term": 1, "key": "a", "value": 1},
                {"index": 2, "term": 1, "key": "b", "value": 2},
                {"index": 3, "term": 2, "key": "a", "value": 3}])
    log.close()
    log2 = RaftLog(d)
    assert log2.last_index() == 3 and log2.last_term() == 2
    assert log2.entry(2)["key"] == "b"
    log2.truncate_from(3)
    log2.append([{"index": 3, "term": 3, "key": "c", "value": 9}])
    log2.close()
    log3 = RaftLog(d)
    assert log3.last_index() == 3 and log3.entry(3)["term"] == 3
    log3.close()


def test_raftlog_snapshot_compaction(tmp_path):
    d = str(tmp_path / "r")
    log = RaftLog(d)
    log.append([{"index": i, "term": 1, "key": "k", "value": i}
                for i in range(1, 11)])
    log.compact(8, {"k": 8})
    assert log.start == 9 and log.last_index() == 10
    assert log.term_at(8) == 1 and log.term_at(3) is None
    log.close()
    log2 = RaftLog(d)
    assert log2.snap_index == 8 and log2.snap_fsm == {"k": 8}
    assert log2.last_index() == 10
    log2.close()


def test_raftlog_torn_tail_discarded_then_appended(tmp_path):
    d = str(tmp_path / "r")
    log = RaftLog(d)
    log.append([{"index": 1, "term": 1, "key": "a", "value": 1}])
    log.close()
    with open(f"{d}/raft.log", "a") as f:
        f.write('{"index": 2, "term": 1, "key"')      # a torn write
    log2 = RaftLog(d)
    assert log2.last_index() == 1
    # the file was rewritten to the prefix: an append survives a replay
    log2.append([{"index": 2, "term": 1, "key": "b", "value": 2}])
    log2.close()
    log3 = RaftLog(d)
    assert log3.last_index() == 2 and log3.entry(2)["key"] == "b"
    log3.close()


# -- cross-reading the JAX package's format --------------------------------

class _Routes:
    """What a RaftNode needs of an HttpServer: somewhere to route."""

    def route(self, method, path, fn):
        pass


def _drive_log(cls, d: str) -> None:
    """The same appends, a conflict's truncation, a compaction and more
    appends, through one package's RaftLog."""
    rng = np.random.default_rng(19)
    log = cls(d)
    log.append([{"index": i, "term": 1 + i // 16, "key": f"k{i % 7}",
                 "value": int(rng.integers(1 << 40))} for i in range(1, 41)])
    log.truncate_from(33)
    log.append([{"index": i, "term": 9, "key": "maxFileKey",
                 "value": i << 20} for i in range(33, 38)])
    fsm = {}
    for i in range(1, 21):
        e = log.entry(i)
        fsm[e["key"]] = e["value"]
    log.compact(20, fsm)
    log.append([{"index": 38, "term": 9, "key": "peers",
                 "value": ["127.0.0.1:1", "127.0.0.1:2"]},
                {"index": 39, "term": 9, "key": "topologyId",
                 "value": "9-0a1b2c3d"}])
    log.close()


def _drive_node(cls, d: str):
    node = cls(_Routes(), "127.0.0.1:1", ["127.0.0.1:2", "127.0.0.1:3"],
               data_dir=d)
    with node._lock:
        node.term = 9
        node.voted_for = "127.0.0.1:2"
        node._persist_state()
    node.stop()


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_raft_files_are_byte_identical_to_the_jax_packages(tmp_path):
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    _drive_log(RefLog, ref)
    _drive_node(RefNode, ref)
    _drive_log(RaftLog, port)
    _drive_node(RaftNode, port)
    for name in ("raft.log", "raft.snap", "raft.state"):
        assert _read(os.path.join(port, name)) == \
            _read(os.path.join(ref, name)), name


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_loads_the_others_raft_dir(tmp_path, writer):
    d = str(tmp_path / writer)
    _drive_log(RefLog if writer == "ref" else RaftLog, d)
    _drive_node(RefNode if writer == "ref" else RaftNode, d)
    nodes = [cls(_Routes(), "127.0.0.1:1", ["127.0.0.1:2", "127.0.0.1:3"],
                 data_dir=d) for cls in (RefNode, RaftNode)]
    try:
        ref, port = nodes
        assert port.log.entries == ref.log.entries
        assert (port.log.snap_index, port.log.snap_term,
                port.log.snap_fsm) == (ref.log.snap_index,
                                       ref.log.snap_term, ref.log.snap_fsm)
        assert (port.term, port.voted_for) == (9, "127.0.0.1:2") == \
            (ref.term, ref.voted_for)
        assert port.fsm == ref.fsm == ref.log.snap_fsm
        # committed to the end, both apply the same FSM
        for n in nodes:
            with n._lock:
                n.commit_index = n.log.last_index()
                n._apply_committed_locked()
        assert port.fsm == ref.fsm
        assert port.fsm["topologyId"] == "9-0a1b2c3d"
        assert port.peers == ref.peers == ["127.0.0.1:1", "127.0.0.1:2"]
        assert port.topology_id == ref.topology_id
    finally:
        stop_all(nodes)


# -- a 3-master port set (tests/test_raft_log.py) -------------------------

@pytest.fixture
def ha3(tmp_path):
    masters = port_set(3, tmp_path)
    seeds = ",".join(m.url for m in masters)
    vols = []
    for i in range(2):
        d = tmp_path / f"v{i}"
        d.mkdir()
        vols.append(VolumeServer([str(d)], device="cpu", master=seeds,
                                 pulse_seconds=PULSE).start())
    leader = leader_of(masters)
    wait_for(lambda: len(leader.topology.alive_nodes()) == 2,
             "both volume servers registered")
    yield masters, vols, seeds, tmp_path
    stop_all(vols, masters)
    stop_background_probes()


def test_replicated_fsm_and_sequence_bound(ha3):
    masters, vols, seeds, _tmp = ha3
    leader = leader_of(masters)
    wait_for(lambda: all(m.raft.fsm_get("topologyId") for m in masters),
             "the replicated topologyId")
    assert len({m.raft.fsm_get("topologyId") for m in masters}) == 1
    assert operation.assign(seeds).fid
    wait_for(lambda: all(int(m.raft.fsm_get("maxFileKey", 0) or 0) > 0
                         for m in masters), "the replicated sequence bound")
    st = http_json("GET", f"{leader.url}/cluster/status")
    assert st["raft"]["persistent"] and st["raft"]["commitIndex"] >= 2
    # the growth's volume id went through the log on every node
    wait_for(lambda: all(int(m.raft.fsm_get("maxVolumeId", 0) or 0) >= 1
                         for m in masters), "the replicated volume id")


def test_kill_leader_mid_assign_no_fid_reuse(ha3):
    masters, vols, seeds, _tmp = ha3
    leader = leader_of(masters)
    keys = set()

    def grab(n, spec):
        for _ in range(n):
            try:
                a = operation.assign(spec)
            except (RuntimeError, OSError):
                time.sleep(0.05)            # the election's window
                continue
            key = key_of(a.fid)
            assert key not in keys, f"key {key} issued twice"
            keys.add(key)

    grab(50, seeds)
    assert len(keys) == 50
    leader.stop()
    survivors = [m for m in masters if m is not leader]
    new = leader_of(survivors)
    assert new is not leader
    deadline = time.monotonic() + 15
    while len(keys) < 90 and time.monotonic() < deadline:
        grab(5, seeds)
    assert len(keys) >= 90
    assert int(new.raft.fsm_get("maxFileKey", 0) or 0) > 0


def test_full_cluster_restart_preserves_identity_and_sequence(ha3):
    masters, vols, seeds, tmp = ha3
    leader_of(masters)
    wait_for(lambda: all(m.raft.fsm_get("topologyId") for m in masters),
             "the replicated topologyId")
    tid = masters[0].raft.fsm_get("topologyId")
    issued = [key_of(operation.assign(seeds).fid) for _ in range(20)]
    vid_bound = int(masters[0].raft.fsm_get("maxVolumeId", 0) or 0)
    # the volume servers first: the set must fence from its logs alone
    stop_all(vols)
    vols.clear()
    ports = [int(m.url.rsplit(":", 1)[1]) for m in masters]
    stop_all(masters)
    masters[:] = port_set(3, tmp, ports=ports)
    leader = leader_of(masters)
    wait_for(lambda: leader.raft.fsm_get("topologyId") is not None,
             "the recovered topologyId")
    assert leader.raft.fsm_get("topologyId") == tid
    assert leader.raft.topology_id == tid
    bound = int(leader.raft.fsm_get("maxFileKey", 0) or 0)
    assert bound > max(issued)
    assert leader.sequencer.peek() > max(issued)
    assert leader.topology.next_volume_id() > vid_bound


def test_diverged_follower_log_repairs(ha3):
    masters, vols, seeds, _tmp = ha3
    leader = leader_of(masters)
    follower = next(m for m in masters if m is not leader)
    for i in range(30):
        assert leader.raft.propose(f"k{i}", i, timeout=5), f"k{i}"
    wait_for(lambda: all(m.raft.fsm_get("k29") == 29 for m in masters),
             "every node applied k29")
    assert follower.raft.fsm_get("k0") == 0
    wait_for(lambda: len({m.raft.log.last_index() for m in masters}) == 1,
             "equal logs")


def test_cluster_raft_shell_commands(ha3):
    masters, vols, seeds, _tmp = ha3
    leader = leader_of(masters)
    env = CommandEnv(seeds)
    ps = run_command(env, "cluster.raft.ps")
    assert leader.url in ps and "commit=" in ps
    wait_for(lambda: "commit={0} applied={0}".format(
        leader.raft.commit_index) in run_command(env, "cluster.raft.ps"),
        "commit = applied")
    out = run_command(env, "cluster.raft.add -server=127.0.0.1:1")
    assert "127.0.0.1:1" in out
    wait_for(lambda: all("127.0.0.1:1" in m.raft.peers for m in masters),
             "the membership replicated")
    # 3 of 4 still make a quorum
    wait_for(lambda: any(m.raft.lease_valid() for m in masters),
             "a lease with 4 members")
    out = run_command(env, "cluster.raft.remove -server=127.0.0.1:1")
    members = [x.strip() for x in out.split(":", 1)[1].split(",")]
    assert "127.0.0.1:1" not in members, out
    with pytest.raises(RuntimeError, match="transfer"):
        run_command(env, f"cluster.raft.remove -server={leader_of(masters).url}")
    # cluster.ps names the real leader and term
    ps = run_command(env, "cluster.ps")
    leader = leader_of(masters)
    assert f"master {leader.url} leader (term {leader.raft.term})" in ps
    assert ps.count(" follower") == 2


def test_leader_transfer_timeout_now_targets_peer(ha3):
    masters, vols, seeds, _tmp = ha3
    leader = leader_of(masters)
    target = next(m for m in masters if m is not leader)
    env = CommandEnv(seeds)
    t0 = time.monotonic()
    out = run_command(env, "cluster.raft.leader.transfer "
                           f"-target={target.url}")
    assert "transferred" in out
    wait_for(lambda: target.raft.is_leader, "the target took over", 5)
    # one round trip, not a 4-8 pulse election; slack for a loaded box
    assert time.monotonic() - t0 < 4.0
    assert sum(m.raft.is_leader for m in masters) == 1
    wait_for(lambda: target.raft.lease_valid(), "the new leader's lease", 5)
    # a mistyped target fails, naming the members
    r = http_json("POST", f"{target.url}/cluster/raft/transfer",
                  {"target": "127.0.0.1:9"})
    assert "not a raft member" in r["error"]


# -- the command line -------------------------------------------------------

def _free_ports(n: int) -> "list[int]":
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO)


def test_master_peers_and_mdir_on_the_command_line(tmp_path):
    """Three `master -peers a,b,c -mdir D` processes elect one leader,
    which the shell's seed list finds; a restart keeps the topology id.
    The ports are chosen before the processes start (a master must know
    its peers), so a start that finds one taken is retried."""
    def start_set():
        for _attempt in range(5):
            ports = _free_ports(3)
            peers = ",".join(f"127.0.0.1:{p}" for p in ports)
            procs = [subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", "master",
                 "-port", str(p), "-peers", peers,
                 "-mdir", str(tmp_path / f"m{i}")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=_env()) for i, p in enumerate(ports)]
            lines = [p.stdout.readline() for p in procs]
            if all("master server listening on" in x for x in lines):
                return procs, peers
            for p in procs:
                p.kill()
                p.wait()
        raise AssertionError(f"no set started: {lines}")

    def status(peers):
        try:        # no leader yet: every member answers "not leader"
            return operation.master_json(peers, "GET", "/cluster/status",
                                         timeout=5)
        except OSError:
            return {}
    procs, peers = start_set()
    try:
        wait_for(lambda: status(peers).get("raft", {}).get(
            "maxFileKeyBound", 0) > 0, "a leader's bootstrap", 20)
        st = status(peers)
        assert st["isLeader"] and st["topologyId"]
        assert sorted(st["peers"]) == sorted(peers.split(","))
        assert st["raft"]["persistent"]
        tid = status(peers)["topologyId"]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            assert p.wait(timeout=30) == 0
            p.stdout.close()
            p.stderr.close()
    assert all(os.path.exists(tmp_path / f"m{i}" / "raft" / "raft.log")
               for i in range(3))
    # a restart on the same -mdir, the same ports where they are free
    ports = [int(x.rsplit(":", 1)[1]) for x in peers.split(",")]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "master", "-port",
         str(p), "-peers", peers, "-mdir", str(tmp_path / f"m{i}")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for i, p in enumerate(ports)]
    try:
        lines = [p.stdout.readline() for p in procs]
        if not all("listening" in x for x in lines):
            pytest.fail(f"a port was taken on the restart: {lines}")
        wait_for(lambda: status(peers).get("topologyId") == tid,
                 "the same topology id", 20)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)
            p.stdout.close()
            p.stderr.close()


def test_shell_prompt_over_stdin():
    m = MasterServer(port=0, raft_pulse_seconds=RAFT_PULSE).start()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
             "-master", m.url],
            input="cluster.raft.ps\n\nno.such.command\n"
                  "cluster.status; cluster.ps\nexit\ncluster.ps\n",
            capture_output=True, text=True, timeout=120, env=_env())
    finally:
        m.stop()
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert out.startswith("> ")
    assert f"leader: {m.url}  term: " in out
    assert "error: unknown command 'no.such.command'" in out
    assert f"master {m.url} leader (term " in out
    assert '"topologyWarm"' in out
    # nothing after `exit` ran
    assert out.count(f"master {m.url} leader") == 1


# -- C22: a volume id issued twice after a restart ------------------------

def _grown(master_url: str, collection: str) -> int:
    r = http_json("POST", f"{master_url}/vol/grow",
                  {"collection": collection, "replication": "000"},
                  timeout=30)
    assert "error" not in r, r
    (vid,) = r["volumeIds"]
    return vid


def _restart_then_grow(tmp_path, make_master, make_server) -> "tuple":
    """Grow vid 1 on server H under a master with a meta dir; stop H and
    the master; restart the master on the same dir and port with only a
    fresh server A heartbeating; grow again.  (vid on H, vid grown)."""
    m = make_master(0)
    port = int(m.url.rsplit(":", 1)[1])
    h = make_server(str(tmp_path / "h"), m.url)
    try:
        wait_for(lambda: len(m.topology.alive_nodes()) == 1, "H registered")
        vid_h = _grown(m.url, "c22")
        assert os.path.exists(tmp_path / "h" / f"c22_{vid_h}.dat")
    finally:
        stop_all([h, m])
    for attempt in range(50):
        try:
            m = make_master(port)
            break
        except OSError:
            if attempt == 49:
                raise
            time.sleep(0.1)
    a = make_server(str(tmp_path / "a"), m.url)
    try:
        wait_for(lambda: len(m.topology.alive_nodes()) == 1, "A registered")
        return vid_h, _grown(m.url, "c22")
    finally:
        stop_all([a, m])
        stop_background_probes()


def test_c22_jax_master_reissues_a_volume_id_after_a_restart(tmp_path):
    """The JAX master counts volume ids from heartbeats alone
    (topology.py:144-147): restarted from its -mdir before the holder of
    the highest vid heartbeats, it grows that vid again on another
    server."""
    for d in ("h", "a"):
        (tmp_path / d).mkdir()
    vid_h, vid_new = _restart_then_grow(
        tmp_path,
        lambda port: RefMaster(port=port, meta_dir=str(tmp_path / "m"),
                               raft_pulse_seconds=RAFT_PULSE).start(),
        lambda d, murl: RefServer([d], murl, pulse_seconds=PULSE).start())
    assert vid_new == vid_h


def test_c22_port_master_commits_volume_ids_through_the_log(tmp_path):
    for d in ("h", "a"):
        (tmp_path / d).mkdir()
    vid_h, vid_new = _restart_then_grow(
        tmp_path,
        lambda port: MasterServer(port=port, meta_dir=str(tmp_path / "m"),
                                  raft_pulse_seconds=RAFT_PULSE).start(),
        lambda d, murl: VolumeServer([d], device="cpu", master=murl,
                                     pulse_seconds=PULSE).start())
    assert vid_new > vid_h


# -- C23: ec.rebuild against a leader that has not heard every server -----

C23_SERVERS = 4


def _ec_volume_on(servers_dirs) -> None:
    """A ~1.5 MiB seeded volume 1 of collection c23 in the first dir."""
    v = Volume(servers_dirs[0], 1, collection="c23")
    rng = np.random.default_rng(23)
    nid = 0
    while v.dat_size() < 3 << 19:
        nid += 1
        v.write_needle(Needle(cookie=nid, id=nid,
                              data=rng.bytes(int(rng.integers(2000,
                                                              90_000)))))
    v.close()


def _shard_files(dirs) -> "dict[str, list]":
    return {d: sorted(n for n in os.listdir(d) if ".ec" in n and
                      n[-2:].isdigit()) for d in dirs}


def _c23_cluster(tmp_path, masters, seeds):
    """Port volume servers over `seeds`, volume 1 encoded across them by
    the port's shell; (servers, dirs, the silent server's index)."""
    dirs = [str(tmp_path / f"s{i}") for i in range(C23_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    _ec_volume_on(dirs)
    servers = [VolumeServer([d], device="cpu", master=seeds,
                            pulse_seconds=PULSE).start() for d in dirs]
    env = CommandEnv(seeds)
    env.WARM_TIMEOUT = 30.0
    wait_for(lambda: len(operation.master_json(
        seeds, "GET", "/cluster/status")["dataNodes"]) == C23_SERVERS,
        "every server registered")
    run_command(env, "lock")
    out = run_command(env, "ec.encode -volumeId=1 -collection=c23")
    run_command(env, "unlock")
    assert "error" not in out.lower(), out
    files = _shard_files(dirs)
    assert sum(len(v) for v in files.values()) == 14
    silent = max(range(C23_SERVERS), key=lambda i: len(files[dirs[i]]))
    assert 1 <= len(files[dirs[silent]]) <= 4
    return servers, dirs, silent


def test_c23_jax_shell_rebuilds_live_shards_on_a_cold_leader(tmp_path):
    """Right after a failover the JAX leader knows only the servers that
    have heartbeated to it, and the JAX shell's ec.rebuild takes a live
    server's shards for missing and rebuilds them elsewhere."""
    masters = [RefMaster(port=0, raft_pulse_seconds=RAFT_PULSE,
                         volume_size_limit_mb=64) for _ in range(3)]
    urls = sorted(m.url for m in masters)
    for m in masters:
        m.raft.peers = list(urls)
    for m in masters:
        m.start()
    seeds = ",".join(urls)
    servers = []
    try:
        leader = leader_of(masters)
        servers, dirs, silent = _c23_cluster(tmp_path, masters, seeds)
        before = _shard_files(dirs)
        # the silent server's heartbeats fail from now on
        faults.arm("master.heartbeat", "error",
                   match=servers[silent].url)
        leader.stop()
        survivors = [m for m in masters if m is not leader]
        new = leader_of(survivors)
        wait_for(lambda: len(new.topology.alive_nodes()) ==
                 C23_SERVERS - 1, "the other servers registered")
        assert servers[silent].url not in \
            [n.url for n in new.topology.alive_nodes()]
        env = RefEnv(seeds)
        ref_run_command(env, "lock")
        out = ref_run_command(env, "ec.rebuild -volumeId=1 -collection=c23")
        ref_run_command(env, "unlock")
        lost = sorted(int(n[-2:]) for n in before[dirs[silent]])
        assert f"rebuilt shards {lost} on " in out, out
        # the silent server still holds them: each is now on two servers
        after = _shard_files(dirs)
        assert sum(len(v) for v in after.values()) == 14 + len(lost)
    finally:
        faults.reset()
        stop_all(servers, masters)
        stop_background_probes()


def test_c23_port_shell_waits_for_a_warm_leader(tmp_path):
    """The port's leader says `topologyWarm` once it has held office for
    two of the servers' pulses, and the shell waits for it: the silent
    server heartbeats in that time, and ec.rebuild finds every shard."""
    masters = port_set(3, pulse_seconds=1.0)
    seeds = ",".join(m.url for m in masters)
    servers = []
    try:
        leader = leader_of(masters)
        servers, dirs, silent = _c23_cluster(tmp_path, masters, seeds)
        before = _shard_files(dirs)
        faults.arm("master.heartbeat", "error",
                   match=servers[silent].url)
        leader.stop()
        survivors = [m for m in masters if m is not leader]
        new = leader_of(survivors)
        wait_for(lambda: len(new.topology.alive_nodes()) ==
                 C23_SERVERS - 1, "the other servers registered")
        st = http_json("GET", f"{new.url}/cluster/status")
        assert not st["topologyWarm"]
        assert servers[silent].url not in st["dataNodes"]
        # the silent server comes back within a pulse, before warm
        faults.reset()
        env = CommandEnv(seeds)
        run_command(env, "lock")
        t0 = time.monotonic()
        out = run_command(env, "ec.rebuild -volumeId=1 -collection=c23")
        waited = time.monotonic() - t0
        run_command(env, "unlock")
        assert out == "volume 1: all 14 shards present", out
        assert waited > 0.2
        assert _shard_files(dirs) == before
    finally:
        faults.reset()
        stop_all(servers, masters)
        stop_background_probes()


class _Vote:
    """A vote request as `_handle_vote` reads it."""

    def __init__(self, body: dict):
        self.body = body

    def json(self) -> dict:
        return self.body


@pytest.mark.parametrize("cls", [RefNode, RaftNode], ids=["jax", "port"])
def test_c28_a_deposed_leader_restarts_its_election_timer(cls):
    """A leader deposed by a successor's vote request that it refuses
    (its own log is longer) is a follower that heard no append for as
    long as it led: the JAX node's timer stays that old, so its next
    pulse stands it for election against the successor; the port's
    restarts at the step-down."""
    node = cls(_Routes(), "127.0.0.1:1", ["127.0.0.1:2", "127.0.0.1:3"])
    try:
        with node._lock:
            node.log.append([{"index": 1, "term": 1, "key": "noop",
                              "value": 1}])
            node.term, node.state = 1, "leader"
            node._last_heard = time.monotonic() - 60.0
        t0 = time.monotonic()
        status, r = node._handle_vote(_Vote({
            "term": 2, "candidate": "127.0.0.1:2", "lastLogIndex": 0,
            "lastLogTerm": 0}))
        assert status == 200 and not r["granted"] and r["term"] == 2
        assert node.state == "follower"
        if cls is RefNode:
            assert node._last_heard < t0 - 59.0
        else:
            assert node._last_heard >= t0
    finally:
        node.stop()
