"""The port's HA master set on the CPU, each test of
`tests/test_master_ha.py` held by the port: the election, the follower's
redirect, the leader's kill and the rejoin, both partition cases, a
single master as its own leader, raft RPCs refused without the admin
JWT, a clock-skewed new leader, and the follow stream's retarget.

Three port masters and three port volume servers (codec on the CPU) run
in process; each listener is bound (port 0) before the masters learn the
peer list.  A partition is made by filtering `server.raft.http_json`.
Every wait is a condition under a deadline.
"""

import time
import urllib.error
import urllib.request

import pytest

from seaweedfs_tpu_torch import operation, security, wdclient
from seaweedfs_tpu_torch.server import raft as raft_mod
from seaweedfs_tpu_torch.server.httpd import http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.raft import RaftNode
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from test_torch_profiling import stop_background_probes
from test_torch_raft import RAFT_PULSE, key_of, leader_of, port_set, \
    stop_all, wait_for


@pytest.fixture
def ha_cluster(tmp_path):
    masters = port_set(3)
    seeds = ",".join(m.url for m in masters)
    servers = []
    for i in range(3):
        d = tmp_path / f"vol{i}"
        d.mkdir()
        servers.append(VolumeServer([str(d)], device="cpu", master=seeds,
                                    pulse_seconds=0.2).start())
    leader = leader_of(masters)
    wait_for(lambda: len(leader.topology.alive_nodes()) == 3,
             "3 volume servers registered")
    yield masters, servers, seeds
    stop_all(servers, masters)
    stop_background_probes()


def _retry(fn, timeout: float = 10.0):
    """fn() until it stops raising the election window's errors."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except (RuntimeError, LookupError, OSError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)


def test_single_leader_elected(ha_cluster):
    masters, _servers, _seeds = ha_cluster
    leader = leader_of(masters)
    assert sum(m.raft.is_leader for m in masters) == 1
    st = http_json("GET", f"{leader.url}/cluster/status")
    assert st["isLeader"] and st["leader"] == leader.url
    assert st["term"] >= 1 and st["topologyId"]


def test_follower_redirects_assign(ha_cluster):
    masters, _servers, _seeds = ha_cluster
    leader = leader_of(masters)
    follower = next(m for m in masters if m is not leader)
    r = http_json("GET", f"{follower.url}/dir/assign")
    assert r.get("error") == "not leader" and r["leader"] == leader.url
    # the client follows the hint, given the follower alone
    a = operation.assign(follower.url)
    assert a.fid and a.url


def test_leader_kill_failover(ha_cluster):
    masters, servers, seeds = ha_cluster
    fid_before = operation.submit(seeds, b"before-failover")
    assert operation.read(seeds, fid_before) == b"before-failover"
    old = leader_of(masters)
    old_tid, old_term = old.raft.topology_id, old.raft.term
    wait_for(lambda: all(http_json("GET", f"{s.url}/status")["topologyId"]
                         == old_tid for s in servers),
             "the servers' topologyId from the first leader")
    old.stop()
    for s in servers:
        s.topology_id = ""          # only the new leader can set it again
    survivors = [m for m in masters if m is not old]
    new = leader_of(survivors)
    # the identity is replicated: a failover keeps it; the term fences
    wait_for(lambda: new.raft.fsm_get("topologyId"), "the topologyId")
    assert new.raft.fsm_get("topologyId") == old_tid == new.raft.topology_id
    assert new.raft.term > old_term
    # each volume server heartbeats to the new leader and hears the epoch
    wait_for(lambda: all(http_json("GET", f"{s.url}/status")["topologyId"]
                         == old_tid for s in servers),
             "the servers' topologyId from the new leader")
    fid_after = _retry(lambda: operation.submit(seeds, b"after-failover"))
    assert key_of(fid_after) > key_of(fid_before)
    assert _retry(lambda: operation.read(seeds, fid_after)) == \
        b"after-failover"
    assert _retry(lambda: operation.read(seeds, fid_before)) == \
        b"before-failover"


def test_stepped_down_leader_rejoins_as_follower(ha_cluster):
    masters, _servers, _seeds = ha_cluster
    leader = leader_of(masters)
    http_json("POST", f"{leader.url}/cluster/raft/append",
              {"term": leader.raft.term + 10, "leader": "127.0.0.1:1",
               "topologyId": "fake"})
    assert not leader.raft.is_leader
    assert leader_of(masters).raft.term > 0


def _partition(monkeypatch, cut):
    """Raft calls between `cut(sender, target)` pairs raise."""
    real = raft_mod.http_json

    def filtered(method, url, payload=None, timeout=30.0, headers=None):
        sender = (payload or {}).get("candidate") or \
            (payload or {}).get("leader")
        how = cut(sender, url.split("/")[0])
        if how == "hang":
            time.sleep(timeout)
            raise ConnectionError("blackholed")
        if how:
            raise ConnectionError("partitioned")
        return real(method, url, payload, timeout, headers)
    monkeypatch.setattr(raft_mod, "http_json", filtered)
    return real


def test_symmetric_partition_at_most_one_side_serves(ha_cluster,
                                                     monkeypatch):
    """The leader cut off from the quorum with both halves alive: its
    lease (3 pulses) is shorter than the least election timeout (4), so
    it refuses assigns before the majority side can elect a successor."""
    masters, _servers, seeds = ha_cluster
    old = leader_of(masters)
    majority = [m for m in masters if m is not old]
    assert RaftNode.LEASE_PULSES * old.raft.pulse < 4 * old.raft.pulse
    minority = {old.url}
    real = _partition(monkeypatch, lambda s, t: s is not None and
                      (s in minority) != (t in minority))
    t0 = time.monotonic()
    first_refusal = first_new_leader = None
    deadline = t0 + 12
    while time.monotonic() < deadline and (first_refusal is None or
                                           first_new_leader is None):
        if first_refusal is None:
            r = http_json("GET", f"{old.url}/dir/assign")
            if r.get("error") == "not leader":
                first_refusal = time.monotonic()
        if first_new_leader is None and any(
                m.raft.is_leader and m.raft.lease_valid() for m in majority):
            first_new_leader = time.monotonic()
        time.sleep(0.02)
    assert first_refusal is not None, "the cut-off leader never refused"
    assert first_new_leader is not None, "the majority elected no one"
    assert first_refusal <= first_new_leader, (
        f"both sides served: refused at {first_refusal - t0:.2f}s, "
        f"elected at {first_new_leader - t0:.2f}s")
    assert http_json("GET", f"{old.url}/dir/assign").get("error") == \
        "not leader"
    monkeypatch.setattr(raft_mod, "http_json", real)
    new = leader_of(masters)
    assert _retry(lambda: operation.assign(seeds)).fid
    assert sum(m.raft.is_leader for m in masters) == 1
    assert new.raft.lease_valid()


def test_leader_keeps_serving_with_one_blackholed_peer(ha_cluster,
                                                       monkeypatch):
    """A leader with 2 of 3 never refuses: the lease refreshes the
    moment a majority acks, not when the round's last call returns."""
    masters, _servers, _seeds = ha_cluster
    leader = leader_of(masters)
    dead = next(m for m in masters if m is not leader)
    # both directions: the cut-off node's rising terms would otherwise
    # depose the leader (an asymmetric partition, another case)
    _partition(monkeypatch, lambda s, t: "hang" if t == dead.url else
               s == dead.url)
    deadline = time.monotonic() + 2.0
    refusals = samples = 0
    while time.monotonic() < deadline:
        r = http_json("GET", f"{leader.url}/dir/assign")
        samples += 1
        refusals += r.get("error") == "not leader"
        time.sleep(0.05)
    assert samples > 20
    assert refusals == 0, f"refused {refusals} of {samples} assigns"
    assert leader.raft.is_leader and leader.raft.lease_valid()


def test_single_master_still_immediate_leader():
    m = MasterServer(raft_pulse_seconds=RAFT_PULSE).start()
    try:
        assert m.raft.is_leader and m.raft.lease_valid()
        st = http_json("GET", f"{m.url}/cluster/status")
        assert st["isLeader"] and st["peers"] == [m.url]
        assert st["raft"]["persistent"] is False
    finally:
        m.stop()


def test_raft_rpcs_rejected_without_admin_jwt():
    """An outsider cannot depose a secured set's leader through the raft
    RPCs: they are admin paths."""
    import json
    security.configure(security.SecurityConfig(admin_key="raft-admin"))
    try:
        m = MasterServer(raft_pulse_seconds=RAFT_PULSE).start()
        try:
            for path, body in (
                    ("append", {"term": 10 ** 9, "leader": "evil:80",
                                "topologyId": "x"}),
                    ("vote", {"term": 10 ** 9, "candidate": "evil:80"}),
                    ("timeout_now", {"term": 10 ** 9})):
                req = urllib.request.Request(
                    f"http://{m.url}/cluster/raft/{path}",
                    data=json.dumps(body).encode(), method="POST",
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=5) as resp:
                        status = resp.status
                except urllib.error.HTTPError as e:
                    status = e.code
                assert status == 401, path
            assert m.raft.is_leader and m.raft.leader == m.url
            assert m.raft.term < 10 ** 9
        finally:
            m.stop()
    finally:
        security.configure(None)


def test_clock_skewed_new_leader_never_reissues_fids(ha_cluster):
    """Every successor's leadership seeds its sequencer as if its clock
    read 1970: no key is issued twice all the same, fenced by the
    committed bound and the heartbeats' maxFileKey."""
    masters, _servers, seeds = ha_cluster
    before = {key_of(operation.submit(seeds, f"pre-{i}".encode()))
              for i in range(25)}
    old = leader_of(masters)
    survivors = [m for m in masters if m is not old]
    for m in survivors:
        def skewed(leading, m=m):
            if leading:
                m.sequencer._counter = 1        # a 1970 clock's seed
                m.hub.publish({"leader": m.url})
        m.raft.on_leadership = skewed
    old.stop()
    new = leader_of(survivors)
    wait_for(lambda: len(new.topology.alive_nodes()) == 3,
             "every server registered again")
    after = []
    deadline = time.monotonic() + 10
    while len(after) < 25 and time.monotonic() < deadline:
        try:
            after.append(key_of(operation.submit(
                seeds, f"post-{len(after)}".encode())))
        except RuntimeError:
            time.sleep(0.1)
    assert len(after) == 25, "writes never recovered"
    assert not before.intersection(after)
    assert min(after) > max(before)


def test_follower_stream_retargets_on_leadership_transfer(ha_cluster):
    """The follow stream re-dials the leader its stream announces: after
    a transfer it polls the new leader's watch, resynced, and feeds the
    operation's leader cache."""
    masters, _servers, seeds = ha_cluster
    old = leader_of(masters)
    f = wdclient.MasterFollower(seeds, poll_timeout=25.0).start()
    try:
        assert f.wait_synced(10)
        wait_for(lambda: f.target == old.url, "the stream on the leader")
        r = http_json("POST", f"{old.url}/cluster/raft/transfer", {})
        assert r.get("transferred"), r
        t0 = time.monotonic()
        new = leader_of(masters)
        assert new is not old
        # the old leader's long poll ends at its step-down: no 25 s wait
        wait_for(lambda: f.target == new.url, "the stream re-targeted", 5)
        assert time.monotonic() - t0 < 5
        assert f.leader == new.url
        assert operation._leader_cache[seeds] == new.url
        assert f.wait_synced(10), "never resynced on the new hub"
        fid = _retry(lambda: operation.submit(seeds, b"post-transfer"))
        vid = int(fid.split(",")[0])
        wait_for(lambda: f.get_locations(vid), "the pushed map's volume")
    finally:
        f.stop()


# -- C24: a leader whose lease lapses behind one blackholed peer ----------

def _blackholed_refusals(mod, masters, monkeypatch) -> "tuple[int, int]":
    """Assigns on the leader for 2 s while one follower hangs every raft
    call to it (and its own are dropped): (refusals, samples)."""
    leader = leader_of(masters)
    dead = next(m for m in masters if m is not leader)
    real = mod.http_json

    def filtered(method, url, payload=None, timeout=30.0, headers=None):
        sender = (payload or {}).get("candidate") or \
            (payload or {}).get("leader")
        if url.split("/")[0] == dead.url:
            time.sleep(timeout)
            raise ConnectionError("blackholed")
        if sender == dead.url:
            raise ConnectionError("blackholed")
        return real(method, url, payload, timeout, headers)
    monkeypatch.setattr(mod, "http_json", filtered)
    refusals = samples = 0
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        r = http_json("GET", f"{leader.url}/dir/assign")
        samples += 1
        refusals += r.get("error") == "not leader"
        time.sleep(0.05)
    monkeypatch.setattr(mod, "http_json", real)
    return refusals, samples


def test_c24_jax_leader_refuses_behind_one_blackholed_peer(monkeypatch):
    """The JAX leader's replication round waits for its slowest peer (the
    call timeout, 0.5 s at least) before the next: at a 0.15 s pulse the
    rounds are 0.65 s apart and the 0.45 s lease lapses between them, so
    a leader that holds 2 of 3 refuses assigns."""
    from seaweedfs_tpu.server import raft as ref_raft
    from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
    masters = [RefMaster(port=0, raft_pulse_seconds=RAFT_PULSE)
               for _ in range(3)]
    urls = sorted(m.url for m in masters)
    for m in masters:
        m.raft.peers = list(urls)
    for m in masters:
        m.start()
    try:
        refusals, samples = _blackholed_refusals(ref_raft, masters,
                                                 monkeypatch)
    finally:
        stop_all(masters)
    assert samples > 20 and refusals > 0


def test_c24_port_leader_serves_behind_one_blackholed_peer(monkeypatch):
    """The port's round returns at a majority, a hung peer keeps one
    append in flight and delays nothing, and the lease runs from the
    newest append a majority acked."""
    masters = port_set(3)
    try:
        refusals, samples = _blackholed_refusals(raft_mod, masters,
                                                 monkeypatch)
    finally:
        stop_all(masters)
    assert samples > 20 and refusals == 0, (refusals, samples)


def test_a_new_leader_answers_lookups_once_warm(ha_cluster):
    """Right after a failover the new leader has not heard every server:
    a lookup it cannot answer is 503 "topology warming" (not 404), and
    a client through the seed list waits it out and gets the
    locations."""
    masters, servers, seeds = ha_cluster
    fid = operation.submit(seeds, b"held")
    vid = int(fid.split(",")[0])
    old = leader_of(masters)
    old.stop()
    survivors = [m for m in masters if m is not old]
    new = leader_of(survivors)
    r = http_json("GET", f"{new.url}/dir/lookup?volumeId=999999")
    assert r.get("error") == "topology warming", r
    locs = operation.lookup(seeds, vid, use_cache=False)
    assert locs and all(loc["url"] in {s.url for s in servers}
                        for loc in locs)
    wait_for(new.topology_warm, "a warm leader", 10)
    r = http_json("GET", f"{new.url}/dir/lookup?volumeId=999999")
    assert r.get("error") == "volume not found", r
    assert operation.read(seeds, fid) == b"held"
