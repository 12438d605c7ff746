"""Master server: the topology registry, file-id assignment with volume
growth, lookups and the admin lock (weed/server/master_server.go,
master_grpc_server_assign.go:49, master_grpc_server_volume.go;
pb/master.proto), the part of `seaweedfs_tpu/server/master_server.py`
that heartbeating volume servers, writers and the shell call, as JSON
over the port's `HttpServer`:

    POST /heartbeat                    <- master.proto:12 SendHeartbeat
    GET  /dir/assign (and POST)        <- master.proto:16 Assign
    GET  /dir/lookup                   <- master.proto:15 LookupVolume
    GET  /dir/ec_lookup                <- master.proto:30 LookupEcVolume
    GET  /dir/status, /vol/list        <- master.proto:28 VolumeList
    POST /vol/grow                     <- VolumeGrow
    GET  /cluster/status
    GET  /cluster/watch                <- master.proto:14 KeepConnected
    POST /cluster/raft/transfer, /cluster/raft/config
                                       <- RaftLeadershipTransfer,
                                          RaftAddServer/RaftRemoveServer
    POST /cluster/raft/{vote,append,timeout_now}   the raft RPCs
    GET  /metrics
    POST /cluster/lease_admin_token    <- master.proto:44 LeaseAdminToken
    POST /cluster/release_admin_token  <- master.proto:46 ReleaseAdminToken

The replies carry the reference's keys.  Under `security.toml` the
assign reply carries the fid's write JWT (`auth`), the admin paths
(heartbeats, `/vol/grow`, the admin token) answer 401 without the admin
JWT, and the master's own calls to volume servers carry it.

Every master runs a `RaftNode` (server/raft.py), as the JAX master does:
alone it is its own leader at start; with `peers` (the `-peers` list,
this master included) the set elects one.  A follower, and a leader whose
lease ran out, answers the leader-only paths (`_LEADER_ONLY`) with 503
`{"error": "not leader", "leader": <hint>}`, which `operation.master_json`
follows.  With `meta_dir` (`-mdir`) the log lives in `<meta_dir>/raft`
in the JAX package's format.  What the log keeps:
- the topology identity (`topologyId`), proposed once by a new set's
  first leader, after a no-op barrier that commits what earlier terms
  left, and kept across failovers and restarts;
- the file-id bound (`maxFileKey`): keys up to it may be issued without
  another log round; the sequencer starts above the committed bound
  before any assign, a new leader floors it at the wall clock in µs as
  well, and each heartbeat's `maxFileKey` floors it too.  An assign tops
  the bound up by `SEQ_CHUNK` off its path once half of it is used;
- the highest volume id issued (`maxVolumeId`), committed before a
  growth allocates it: a new leader, or a set restarted from `-mdir`,
  never grows a vid whose holder has not heartbeated yet (the JAX master
  counts vids from heartbeats alone: ROADMAP C).
`/cluster/status` gives the raft fields of the JAX master, the
heartbeats received (`heartbeats`) and `topologyWarm`: whether this
leader has held office for `WARM_PULSES` of the volume servers' pulse,
so that every live server has heartbeated to it; until then, a leader of
a set answers a lookup it cannot answer 503 "topology warming", which
`operation.master_json` asks again.  The shell waits for it
before a command that moves or rebuilds data (`confirm_is_locked`), so a
leader that has not heard every server yet is never taken to say that a
server's shards are missing.  `/cluster/raft/transfer` hands leadership
to a peer (TimeoutNow) and `/cluster/raft/config` changes the members.
`/metrics` renders the JAX master's gauges (`master_data_nodes`,
`master_volumes_total`, `master_sequence`), `master_request_seconds`
and `master_request_cpu_seconds` (httpd's middleware) and, the port's
own, the requests of each route (`master_route_requests_total{path}`),
with the process registry.  The debug routes (server/debug.py) are
installed too.

`/cluster/watch` is the follow stream's long-poll (the JAX master's, on
a `LocationHub`): `snapshot=1` answers the `/vol/list` tree with the
hub's cursor, `since=C&timeout=T` the location deltas after C.  Each
heartbeat that changes a node's volume or EC-shard set publishes the
delta.  A node that misses 3 pulses leaves every view of the port's
master, so a reaper publishes its departure too (all its vids in
`deletedVids` and `deletedEcVids`), and a node that comes back publishes
everything it holds again.  A new leader publishes `{"leader": url}`; a
master that loses leadership publishes what it knows of the leader, and
again when it hears of a new one, so a follow stream on it re-targets at
once; a cursor of another hub (the `hub` id a snapshot gives, or one
above this hub's) answers `lagged`.  It imports no torch.
"""

from __future__ import annotations

import os
import threading
import time
import uuid

from .. import faults, security, stats
from ..operation import WARMING
from ..sequence import MemorySequencer
from ..storage.replica_placement import ReplicaPlacement
from ..storage.ttl import read_ttl
from ..storage.types import FileId, check_path_fields
from ..topology import Topology
from ..topology.topology import VolumeInfo
from .debug import install_debug_routes
from .httpd import HttpServer, Request, admin_guard, http_json
from .location_hub import LocationHub
from .raft import RaftNode
from ..util import wlog


class _AllocateRefused(Exception):
    """A reachable volume server answered an allocation with an error."""


class MasterServer:
    ADMIN_TOKEN_TTL = 60.0
    # the file-id block leased through the log a checkpoint
    SEQ_CHUNK = 1 << 16
    # a leader's topology is warm after this many volume-server pulses
    # in office
    WARM_PULSES = 2.0

    # every path that reads or changes the topology or the sequence runs
    # on the leader: followers hold no topology (volume servers
    # heartbeat only the leader, as in the reference)
    _LEADER_ONLY = frozenset((
        "/heartbeat", "/dir/assign", "/dir/lookup", "/dir/ec_lookup",
        "/dir/status", "/vol/list", "/vol/grow", "/cluster/status",
        "/cluster/watch", "/cluster/raft/config", "/cluster/raft/transfer",
        "/cluster/lease_admin_token", "/cluster/release_admin_token"))

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 volume_size_limit_mb: int = 1024,
                 default_replication: str = "000",
                 pulse_seconds: float = 1.0,
                 peers: "list[str] | str | None" = None,
                 meta_dir: "str | None" = None,
                 raft_pulse_seconds: float = 0.25):
        self.topology = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds)
        self.sequencer = MemorySequencer()
        self.default_replication = default_replication
        # serialises growth: concurrent assigns that find nothing
        # writable grow one set between them
        self._grow_lock = threading.Lock()
        self.heartbeats = 0
        self._lock = threading.Lock()
        self._admin_token: int | None = None
        self._admin_token_ts = 0.0
        self._admin_lock_name = ""
        self.http = HttpServer(host, port)
        self.http.role = "master"
        self.http.guard = self._guard
        # the follow stream: the deltas published, and each node's
        # volume and EC sets as the stream last told them
        self.hub = LocationHub()
        self._hub_lock = threading.Lock()
        self._published: "dict[str, tuple[dict, set, set]]" = {}
        self._reaper_stop = threading.Event()
        self._reaper: "threading.Thread | None" = None
        self.metrics = stats.Metrics("master")
        self.http.metrics = self.metrics

        def r(method, path, fn):
            self.http.route(method, path, self._counted(path, fn))
        r("POST", "/heartbeat", self._heartbeat)
        r("GET", "/dir/assign", self._assign)
        r("POST", "/dir/assign", self._assign)
        r("GET", "/dir/lookup", self._lookup)
        r("GET", "/dir/ec_lookup", self._ec_lookup)
        r("GET", "/dir/status", self._vol_list)
        r("GET", "/vol/list", self._vol_list)
        r("POST", "/vol/grow", self._vol_grow)
        r("GET", "/cluster/status", self._cluster_status)
        r("GET", "/cluster/watch", self._watch)
        r("GET", "/metrics", self._metrics)
        r("POST", "/cluster/lease_admin_token", self._lease_admin)
        r("POST", "/cluster/release_admin_token", self._release_admin)
        r("POST", "/cluster/raft/transfer", self._raft_transfer)
        r("POST", "/cluster/raft/config", self._raft_config)
        install_debug_routes(self.http)
        if isinstance(peers, str):
            peers = [x.strip() for x in peers.split(",") if x.strip()]
        self.raft = RaftNode(
            self.http, self.http.url, peers,
            pulse_seconds=raft_pulse_seconds,
            on_leadership=self._on_leadership,
            data_dir=os.path.join(meta_dir, "raft") if meta_dir else None,
            on_apply=self._on_raft_apply,
            on_leader=lambda url: self.hub.publish({"leader": url}))
        self._seq_ckpt_lock = threading.Lock()
        self._seq_ckpt_inflight = False
        self._raft_config_lock = threading.Lock()
        # a restart from the log: the committed bounds floor the
        # sequencer and the volume ids before any assign can run
        bound = int(self.raft.fsm_get("maxFileKey", 0) or 0)
        if bound:
            self.sequencer.set_max(bound)
        self.topology.floor_volume_id(
            int(self.raft.fsm_get("maxVolumeId", 0) or 0))

    def set_peers(self, peers: "list[str]") -> None:
        """The raft members, before `start`: a set whose listeners were
        bound on port 0 knows its addresses only once each is built."""
        self.raft.set_peers(list(peers))

    def start(self) -> "MasterServer":
        self.http.start()
        self.raft.start()
        self._reaper = threading.Thread(target=self._reap_loop,
                                        name="master-reaper", daemon=True)
        self._reaper.start()
        return self

    def stop(self) -> None:
        self._reaper_stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout=5)
        # the parked /cluster/watch polls answered, then the listener: no
        # raft RPC is answered once the log closed
        self.hub.close()
        self.http.stop()
        self.raft.stop()

    def _guard(self, req: Request):
        """Followers, and a leader whose lease lapsed, answer the
        leader-only paths with the hint (the HTTP form of the
        reference's leader redirect).  `lease_valid`, not `is_leader`:
        a leader cut off from the quorum refuses before the majority side
        can elect another, so no instant has two sides serving.  Then
        the admin gate."""
        if req.path in self._LEADER_ONLY and not self.raft.lease_valid():
            return 503, {"error": "not leader", "leader": self.raft.leader}
        return admin_guard(req)

    # -- raft: leadership, the log's FSM -------------------------------------

    def _on_leadership(self, leading: bool) -> None:
        if not leading:
            # what this node knows of the leader now, and the watch's
            # long polls end, so a follow stream re-targets at once
            leader = self.raft.leader
            self.hub.publish({"leader": leader} if leader and
                             leader != self.url else
                             {"steppedDown": self.url})
            return
        self.hub.publish({"leader": self.raft.leader or self.url})
        # the no-reuse fences on a failover: the committed bound (it
        # survives a restart of the whole set), a floor at the wall clock
        # in µs (keys a crashed leader issued above an uncommitted
        # bound), and each heartbeat's maxFileKey
        bound = int(self.raft.fsm_get("maxFileKey", 0) or 0)
        self.sequencer.set_max(max(bound, int(time.time() * 1e6)))
        # proposals block on their commit: never on the raft loop thread
        try:
            self.raft._pool.submit(self._leader_proposals)
        except RuntimeError:
            pass            # stopping

    def _leader_proposals(self) -> None:
        """The leadership bootstrap: a no-op barrier (a leader commits
        entries of its own term only, so this commits and applies what
        earlier terms left), then the topology identity if the set has
        none yet, then a fresh sequence bound, synchronously."""
        try:
            self.raft.propose("noop", self.raft.term)
            existing = self.raft.fsm_get("topologyId")
            if existing:
                self.raft.topology_id = str(existing)
            else:
                self.raft.propose("topologyId", self.raft.topology_id)
            self._checkpoint_sequence(sync=True)
        except Exception as e:  # noqa: BLE001 — retried at the next term
            wlog.warning("leader bootstrap incomplete: %s", e,
                         component="master")

    def _on_raft_apply(self, key: str, value) -> None:
        """Committed entries: the bounds floor a follower's sequencer and
        every node's volume ids, so any successor starts above them.  The
        leader's own counter stays below its bound: the bound is the
        block it may issue without another log round (the JAX master
        floors the leader too, so each checkpoint skips the block it
        leased)."""
        try:
            if key == "maxFileKey":
                if not self.raft.is_leader:
                    self.sequencer.set_max(int(value))
            elif key == "maxVolumeId":
                self.topology.floor_volume_id(int(value))
        except (TypeError, ValueError):
            pass

    def _checkpoint_sequence(self, sync: bool = False) -> None:
        """Propose the next sequence bound when the counter nears the
        committed one: `sync` waits for the commit (the bootstrap); the
        assign path tops up off its thread at half a chunk."""
        if not self.sequencer.reserves_ranges:
            return      # a clock-derived sequencer leases no block
        cur = self.sequencer.peek()
        bound = int(self.raft.fsm_get("maxFileKey", 0) or 0)
        if cur + self.SEQ_CHUNK // 2 <= bound:
            return
        target = cur + self.SEQ_CHUNK
        if sync:
            self.raft.propose("maxFileKey", target)
            return
        with self._seq_ckpt_lock:
            if self._seq_ckpt_inflight:
                return
            self._seq_ckpt_inflight = True

        def run():
            try:
                self.raft.propose("maxFileKey", target)
            finally:
                with self._seq_ckpt_lock:
                    self._seq_ckpt_inflight = False
        try:
            self.raft._pool.submit(run)
        except RuntimeError:
            with self._seq_ckpt_lock:
                self._seq_ckpt_inflight = False

    def topology_warm(self) -> bool:
        """Leader for `WARM_PULSES` volume-server pulses at least: every
        live server has heartbeated to it."""
        return self.raft.lease_valid() and \
            time.monotonic() - self.raft.leader_since >= \
            self.WARM_PULSES * self.topology.pulse_seconds

    def _counted(self, path: str, fn):
        def handler(req: Request):
            self.metrics.counter_add(
                "route_requests_total", 1.0, path=path,
                help_text="requests of each route")
            return fn(req)
        return handler

    def _metrics(self, req: Request):
        nodes = self.topology.alive_nodes()
        self.metrics.gauge_set("data_nodes", len(nodes),
                               help_text="alive volume servers")
        self.metrics.gauge_set("volumes_total",
                               sum(len(n.volumes) for n in nodes))
        self.metrics.gauge_set("sequence", self.sequencer.peek())
        return 200, ((self.metrics.render() +
                      stats.render_process()).encode(),
                     {"Content-Type": "text/plain; version=0.0.4"})

    # -- the follow stream (master_server.go KeepConnected) ---------------

    def _publish_node(self, url: str, node) -> None:
        """Publish the change between what the stream last said of `url`
        and `node` (None: the node left every view); the caller holds
        `_hub_lock`."""
        old_loc, old_vids, old_ec = self._published.get(
            url, ({}, set(), set()))
        if node is None:
            new_vids, new_ec, loc = set(), set(), old_loc
        else:
            new_vids, new_ec = set(node.volumes), set(node.ec_shards)
            loc = {"url": url, "publicUrl": node.public_url or url}
        if (new_vids, new_ec) == (old_vids, old_ec):
            return
        if node is None:
            self._published.pop(url, None)
        else:
            self._published[url] = (loc, new_vids, new_ec)
        self.hub.publish({
            "url": url, "publicUrl": loc.get("publicUrl", url),
            "newVids": sorted(new_vids - old_vids),
            "deletedVids": sorted(old_vids - new_vids),
            "newEcVids": sorted(new_ec - old_ec),
            "deletedEcVids": sorted(old_ec - new_ec)})

    def _reap_departed(self) -> None:
        """Publish the departure of every node that left the views (3
        missed pulses, or marked dead) since the stream last spoke of
        it."""
        alive = {n.url for n in self.topology.alive_nodes()}
        with self._hub_lock:
            for url in [u for u in self._published if u not in alive]:
                self._publish_node(url, None)

    def _reap_loop(self) -> None:
        period = max(0.05, self.topology.pulse_seconds / 4)
        while not self._reaper_stop.wait(period):
            self._reap_departed()

    def _watch(self, req: Request):
        """The follow stream's long-poll: `snapshot=1` gives the full
        topology with the cursor read before it (what is published while
        it is built replays on the next poll); `since=<cursor>` waits up
        to `timeout` seconds (at most 55) for the events after it."""
        timeout = min(float(req.query.get("timeout", 25)), 55.0)
        if req.query.get("snapshot") == "1":
            cursor = self.hub.cursor
            return 200, {"events": [], "cursor": cursor,
                         "snapshot": self.topology.to_volume_list(),
                         "leader": self.raft.leader, "hub": self.hub.id}
        since = int(req.query.get("since", 0))
        hub = req.query.get("hub", "")
        if (hub and hub != self.hub.id) or since > self.hub.cursor:
            # a cursor of another master's hub (a redirect after a
            # change of leader): resync from a snapshot
            return 200, {"events": [], "cursor": self.hub.cursor,
                         "lagged": True, "leader": self.raft.leader}
        events, cursor, lagged = self.hub.events_since(since, timeout)
        return 200, {"events": events, "cursor": cursor,
                     "lagged": lagged, "leader": self.raft.leader}

    @property
    def url(self) -> str:
        return self.http.url

    # -- handlers ---------------------------------------------------------

    def _heartbeat(self, req: Request):
        hb = req.json()
        # the sequencer's floor (topology.go FindMaxFileKey): above the
        # largest needle key any reporting server holds
        mfk = int(hb.get("maxFileKey", 0))
        if mfk:
            self.sequencer.set_max(mfk)
        url = f"{hb['ip']}:{hb['port']}"
        with self._hub_lock:
            self.topology.register_heartbeat(hb)
            self._publish_node(url, self.topology.nodes.get(url))
        with self._lock:
            self.heartbeats += 1
        return 200, {"volumeSizeLimit": self.topology.volume_size_limit,
                     "leader": self.raft.leader,
                     "topologyId": self.raft.topology_id}

    def _assign(self, req: Request):
        """master_grpc_server_assign.go:49 Assign + topology.go:322
        PickForWrite, growing volumes when nothing is writable."""
        count = int(req.query.get("count", 1))
        collection = req.query.get("collection", "")
        try:
            # the collection names files on every server this assign
            # can grow onto: reject traversal at the front door
            check_path_fields(collection)
        except ValueError as e:
            return 400, {"error": str(e)}
        replication = req.query.get("replication", self.default_replication)
        ttl = req.query.get("ttl", "")
        ttl_u32 = _ttl_u32(ttl)
        try:
            vid, nodes = self.topology.pick_for_write(
                collection, replication, ttl_u32)
        except LookupError:
            try:
                # grow a set (volume_growth.go findVolumeCount: 7/6/3 by
                # copy count), capped at one a copy per 16 free slots so
                # a small cluster grows one and other collections keep
                # their slots
                free = sum(max(0, n.free_space)
                           for n in self.topology.alive_nodes())
                per_round, copies = _growth_plan(replication)
                n_grow = max(1, min(per_round, free // (16 * copies)))
                self._grow_volume(collection, replication, ttl,
                                  count=n_grow, only_if_unwritable=True)
            except LookupError as e:
                return 500, {"error": f"cannot grow volume: {e}"}
            vid, nodes = self.topology.pick_for_write(
                collection, replication, ttl_u32)
        # a granted count is honest only when the sequencer reserves a
        # contiguous range the client may derive keys from
        if not self.sequencer.reserves_ranges:
            count = 1
        key = self.sequencer.next_file_id(count)
        # top the committed bound up before the counter reaches it, off
        # this thread
        self._checkpoint_sequence()
        cookie = uuid.uuid4().int & 0xFFFFFFFF
        node = nodes[0]
        fid = str(FileId(vid, key, cookie))
        resp = {
            "fid": fid,
            "url": node.url,
            "publicUrl": node.public_url,
            "count": count,
            "replicas": [{"url": n.url, "publicUrl": n.public_url}
                         for n in nodes[1:]],
        }
        # the fid's write token, presented to the volume server
        # (master_grpc_server_assign.go GenJwtForVolumeServer)
        # late-bound: a configure() after construction applies
        auth = security.current().write_jwt(fid)
        if auth:
            resp["auth"] = auth
        return 200, resp

    def _grow_volume(self, collection: str, replication: str, ttl: str,
                     count: int = 1,
                     only_if_unwritable: bool = False) -> list[int]:
        """volume_growth.go: plan targets, then allocate on each
        (AllocateVolume -> /admin/allocate_volume).  A target that
        refuses is left out of the next plan; one that cannot be reached
        is marked dead.  Either way the set's allocations so far are
        rolled back and the volume is planned again, up to 4 times."""
        with self._grow_lock:
            if only_if_unwritable:
                # checked again under the lock: the assigns that found
                # nothing writable together grow one set
                try:
                    self.topology.pick_for_write(
                        collection, replication, _ttl_u32(ttl))
                    return []
                except LookupError:
                    pass
            grown = []
            for _ in range(count):
                last_err: object = None
                excluded: set[str] = set()
                for _attempt in range(4):
                    targets = self.topology.plan_growth(
                        replication, exclude=excluded)
                    vid = self._issue_volume_id()
                    done = []
                    try:
                        for node in targets:
                            r = http_json(
                                "POST", f"{node.url}/admin/allocate_volume",
                                {"volumeId": vid, "collection": collection,
                                 "replication": replication, "ttl": ttl},
                                timeout=10)
                            if "error" in r:
                                # alive but refusing (disk full, perms)
                                excluded.add(node.url)
                                raise _AllocateRefused(
                                    f"{node.url}: {r['error']}")
                            done.append(node)
                            # until the node's heartbeat confirms it
                            with self.topology.lock:
                                node.volumes[vid] = VolumeInfo(
                                    id=vid, collection=collection,
                                    replica_placement=ReplicaPlacement
                                    .from_string(replication or "000")
                                    .byte(),
                                    ttl=_ttl_u32(ttl))
                    except _AllocateRefused as e:
                        self._rollback_allocations(vid, done)
                        last_err = e
                        continue
                    except OSError as e:
                        self._rollback_allocations(vid, done)
                        self.topology.mark_dead(node.url)
                        last_err = e
                        continue
                    grown.append(vid)
                    break
                else:
                    if grown:
                        # free slots ran out mid-set: what grew is
                        # writable, and the assign goes on with it
                        break
                    raise LookupError(f"volume growth failed: {last_err}")
            return grown

    def _issue_volume_id(self) -> int:
        """The next volume id, committed through the log before any
        server allocates it (MaxVolumeIdCommand): above every id issued
        by any leader of the set, heartbeated or not.  The caller holds
        `_grow_lock`."""
        vid = self.topology.next_volume_id()
        if not self.raft.propose("maxVolumeId", vid, timeout=10.0):
            raise LookupError(f"volume id {vid} not committed (not the "
                              f"leader, or no quorum)")
        return vid

    def _rollback_allocations(self, vid: int, done: list) -> None:
        """Undo a partial set: the volumes already created would come
        back with their nodes' next heartbeats and hold a slot each."""
        for n in done:
            with self.topology.lock:
                n.volumes.pop(vid, None)
            for _attempt in range(2):
                try:
                    r = http_json("POST", f"{n.url}/admin/delete_volume",
                                  {"volumeId": vid}, timeout=10)
                except OSError:
                    break   # the node went away: its heartbeat re-adds
                if "error" not in r:
                    break

    def _vol_grow(self, req: Request):
        body = req.json()
        # each target's allocate route checks the collection
        vids = self._grow_volume(
            body.get("collection", ""),
            body.get("replication", self.default_replication),
            body.get("ttl", ""), count=int(body.get("count", 1)))
        return 200, {"volumeIds": vids}

    def _lookup(self, req: Request):
        vid_str = req.query.get("volumeId", "")
        if "," in vid_str:  # a full fid
            vid_str = vid_str.split(",", 1)[0]
        # an armed fault: a master alive but failing its lookups
        faults.fire("master.lookup", key=vid_str)
        locations = self.topology.lookup(int(vid_str))
        if not locations:
            if self._warming():
                return 503, {"volumeId": vid_str, "error": WARMING}
            return 404, {"volumeId": vid_str, "error": "volume not found"}
        return 200, {"volumeId": vid_str, "locations": locations}

    def _warming(self) -> bool:
        """A leader of a set, new in office, that may not have heard
        every server yet: a lookup it cannot answer is asked again
        (`operation.master_json`), not answered "not found"."""
        return len(self.raft.peers) > 1 and not self.topology_warm()

    def _ec_lookup(self, req: Request):
        vid = int(req.query.get("volumeId", "0"))
        shards = self.topology.lookup_ec_shards(vid)
        if not shards:
            if self._warming():
                return 503, {"error": WARMING}
            return 404, {"error": f"ec volume {vid} not found"}
        return 200, {
            "volumeId": vid,
            "shardIdLocations": [
                {"url": url, "shardIds": sids}
                for url, sids in shards.items()],
        }

    def _vol_list(self, req: Request):
        return 200, self.topology.to_volume_list()

    def _cluster_status(self, req: Request):
        raft = self.raft
        return 200, {
            "isLeader": raft.is_leader,
            "leader": raft.leader,
            "peers": raft.peers,
            "term": raft.term,
            "topologyId": raft.topology_id,
            "dataNodes": [n.url for n in self.topology.alive_nodes()],
            "volumeSizeLimit": self.topology.volume_size_limit,
            # the log's view (cluster.raft.ps; RaftListClusterServers)
            "raft": {"commitIndex": raft.commit_index,
                     "appliedIndex": raft.applied_index,
                     "lastLogIndex": raft.log.last_index(),
                     "snapshotIndex": raft.log.snap_index,
                     "maxFileKeyBound":
                         int(raft.fsm_get("maxFileKey", 0) or 0),
                     "maxVolumeIdBound":
                         int(raft.fsm_get("maxVolumeId", 0) or 0),
                     "persistent": bool(raft.data_dir)},
            "heartbeats": self.heartbeats,
            "topologyWarm": self.topology_warm(),
        }

    def _raft_transfer(self, req: Request):
        """cluster.raft.leader.transfer: the leader hands over to the
        peer named `target` (or its most caught-up one) by TimeoutNow,
        and steps down."""
        if not self.raft.is_leader:
            return 400, {"error": "not the leader",
                         "leader": self.raft.leader}
        if len(self.raft.peers) == 1:
            return 400, {"error": "single-master cluster: nothing to "
                                  "transfer to"}
        try:
            target = (req.json() or {}).get("target", "")
        except (ValueError, AttributeError):
            target = ""
        if target and target not in self.raft.peers:
            # a mistyped target fails: never some other node
            return 400, {"error": f"target {target} is not a raft member",
                         "members": self.raft.peers}
        if not self.raft.transfer_leadership(target):
            return 400, {"error": "leadership changed mid-request",
                         "leader": self.raft.leader}
        return 200, {"transferred": True, "leader": self.raft.leader}

    def _raft_config(self, req: Request):
        """Membership through the log (RaftAddServer/RaftRemoveServer):
        one committed peer list that every node takes."""
        b = req.json()
        add = [x.strip() for x in b.get("add", []) if x.strip()]
        remove = [x.strip() for x in b.get("remove", []) if x.strip()]
        if self.raft.self_url in remove:
            return 400, {"error": "remove the leader by first "
                                  "transferring leadership (stop this "
                                  "master; a peer takes over)"}
        if not (add or remove):
            return 200, {"peers": sorted(self.raft.peers)}
        # one change at a time: two from the same base view would each
        # drop the other's member
        with self._raft_config_lock:
            peers = (set(self.raft.peers) | set(add)) - set(remove)
            if not peers:
                return 400, {"error": "refusing empty membership"}
            ok = self.raft.propose("peers", sorted(peers), timeout=10.0)
        if not ok:
            return 503, {"error": "membership change not committed"}
        return 200, {"peers": sorted(peers)}

    # -- admin lock (master.proto:44, shell/command_lock_unlock.go) -------

    def _lease_admin(self, req: Request):
        body = req.json()
        now = time.time()   # lockTsNs is a client-visible wall time
        mono = time.monotonic()
        prev = int(body.get("previousToken", 0) or 0)
        with self._lock:
            expired = mono - self._admin_token_ts > self.ADMIN_TOKEN_TTL
            renewing = self._admin_token is not None and \
                prev == self._admin_token
            if self._admin_token is None or expired or renewing:
                self._admin_token = uuid.uuid4().int & 0x7FFFFFFF
                self._admin_token_ts = mono
                self._admin_lock_name = body.get("lockName", "")
                return 200, {"token": self._admin_token,
                             "lockTsNs": int(now * 1e9)}
            return 409, {"error": "already locked",
                         "lockHolder": self._admin_lock_name}

    def _release_admin(self, req: Request):
        with self._lock:
            self._admin_token = None
            self._admin_token_ts = 0.0
        return 200, {}


def _ttl_u32(ttl: str) -> int:
    return read_ttl(ttl).to_u32() if ttl else 0


def _growth_plan(replication: str) -> "tuple[int, int]":
    """(volumes a growth round, copies a volume) (volume_growth.go:32
    findVolumeCount): 7 unreplicated, 6 for 2 copies, 3 for 3, else 1."""
    try:
        copies = ReplicaPlacement.from_string(
            replication or "000").copy_count()
    except (ValueError, AttributeError):
        return 1, 1
    return {1: 7, 2: 6, 3: 3}.get(copies, 1), copies
