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
    GET  /metrics
    POST /cluster/lease_admin_token    <- master.proto:44 LeaseAdminToken
    POST /cluster/release_admin_token  <- master.proto:46 ReleaseAdminToken

The replies carry the reference's keys.  One node, so it is always the
leader: no raft log or per-fid JWT (ROADMAP).  Without a log, the
file-id sequencer is floored by each heartbeat's `maxFileKey`, so a
master that restarts never issues a key a volume server holds.
`/cluster/status` also counts the heartbeats received (`heartbeats`).
`/metrics` renders the JAX master's gauges (`master_data_nodes`,
`master_volumes_total`, `master_sequence`) and, the port's own, the
requests of each route (`master_route_requests_total{path}`), with the
process registry.

`/cluster/watch` is the follow stream's long-poll (the JAX master's, on
a `LocationHub`): `snapshot=1` answers the `/vol/list` tree with the
hub's cursor, `since=C&timeout=T` the location deltas after C.  Each
heartbeat that changes a node's volume or EC-shard set publishes the
delta.  A node that misses 3 pulses leaves every view of the port's
master, so a reaper publishes its departure too (all its vids in
`deletedVids` and `deletedEcVids`), and a node that comes back publishes
everything it holds again.  It imports no torch.
"""

from __future__ import annotations

import threading
import time
import uuid

from .. import stats
from ..sequence import MemorySequencer
from ..storage.replica_placement import ReplicaPlacement
from ..storage.ttl import read_ttl
from ..storage.types import FileId, check_path_fields
from ..topology import Topology
from ..topology.topology import VolumeInfo
from .httpd import HttpServer, Request, http_json
from .location_hub import LocationHub


class _AllocateRefused(Exception):
    """A reachable volume server answered an allocation with an error."""


class MasterServer:
    ADMIN_TOKEN_TTL = 60.0

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 volume_size_limit_mb: int = 1024,
                 default_replication: str = "000",
                 pulse_seconds: float = 1.0):
        self.topology = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds)
        self.sequencer = MemorySequencer()
        self.default_replication = default_replication
        # serialises growth: concurrent assigns that find nothing
        # writable grow one set between them
        self._grow_lock = threading.Lock()
        self.topology_id = str(uuid.uuid4())
        self.heartbeats = 0
        self._lock = threading.Lock()
        self._admin_token: int | None = None
        self._admin_token_ts = 0.0
        self._admin_lock_name = ""
        self.http = HttpServer(host, port)
        self.http.role = "master"
        # the follow stream: the deltas published, and each node's
        # volume and EC sets as the stream last told them
        self.hub = LocationHub()
        self._hub_lock = threading.Lock()
        self._published: "dict[str, tuple[dict, set, set]]" = {}
        self._reaper_stop = threading.Event()
        self._reaper: "threading.Thread | None" = None
        self.metrics = stats.Metrics("master")

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

    def start(self) -> "MasterServer":
        self.http.start()
        self._reaper = threading.Thread(target=self._reap_loop,
                                        name="master-reaper", daemon=True)
        self._reaper.start()
        return self

    def stop(self) -> None:
        self._reaper_stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout=5)
        self.http.stop()

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
                      stats.PROCESS.render()).encode(),
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
                         "leader": self.url}
        since = int(req.query.get("since", 0))
        events, cursor, lagged = self.hub.events_since(since, timeout)
        return 200, {"events": events, "cursor": cursor,
                     "lagged": lagged, "leader": self.url}

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
                     "leader": self.url,
                     "topologyId": self.topology_id}

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
        cookie = uuid.uuid4().int & 0xFFFFFFFF
        node = nodes[0]
        return 200, {
            "fid": str(FileId(vid, key, cookie)),
            "url": node.url,
            "publicUrl": node.public_url,
            "count": count,
            "replicas": [{"url": n.url, "publicUrl": n.public_url}
                         for n in nodes[1:]],
        }

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
                    vid = self.topology.next_volume_id()
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
        locations = self.topology.lookup(int(vid_str))
        if not locations:
            return 404, {"volumeId": vid_str, "error": "volume not found"}
        return 200, {"volumeId": vid_str, "locations": locations}

    def _ec_lookup(self, req: Request):
        vid = int(req.query.get("volumeId", "0"))
        shards = self.topology.lookup_ec_shards(vid)
        if not shards:
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
        return 200, {
            "isLeader": True,
            "leader": self.url,
            "peers": [self.url],
            "term": 0,
            "topologyId": self.topology_id,
            "dataNodes": [n.url for n in self.topology.alive_nodes()],
            "volumeSizeLimit": self.topology.volume_size_limit,
            # one node, no log
            "raft": {"commitIndex": 0, "appliedIndex": 0,
                     "lastLogIndex": 0, "snapshotIndex": 0,
                     "maxFileKeyBound": 0, "persistent": False},
            "heartbeats": self.heartbeats,
        }

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
