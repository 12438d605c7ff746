"""Master server: the topology registry, lookups and the admin lock that
the EC path uses (weed/server/master_server.go,
master_grpc_server_volume.go; pb/master.proto), the part of
`seaweedfs_tpu/server/master_server.py` that heartbeating volume servers
and the shell's `ec.encode` / `ec.rebuild` / `ec.decode` call, as JSON
over the port's `HttpServer`:

    POST /heartbeat                    <- master.proto:12 SendHeartbeat
    GET  /dir/lookup                   <- master.proto:15 LookupVolume
    GET  /dir/ec_lookup                <- master.proto:30 LookupEcVolume
    GET  /vol/list                     <- master.proto:28 VolumeList
    GET  /cluster/status
    POST /cluster/lease_admin_token    <- master.proto:44 LeaseAdminToken
    POST /cluster/release_admin_token  <- master.proto:46 ReleaseAdminToken

The replies carry the reference's keys.  One node, so it is always the
leader: no raft, no file-id sequencer, no /dir/assign, /vol/grow,
/cluster/watch or /metrics (ROADMAP).  `/cluster/status` also counts the
heartbeats received (`heartbeats`).  It imports no torch.
"""

from __future__ import annotations

import threading
import time
import uuid

from ..topology import Topology
from .httpd import HttpServer, Request


class MasterServer:
    ADMIN_TOKEN_TTL = 60.0

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 volume_size_limit_mb: int = 1024,
                 pulse_seconds: float = 1.0):
        self.topology = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds)
        self.topology_id = str(uuid.uuid4())
        self.heartbeats = 0
        self._lock = threading.Lock()
        self._admin_token: int | None = None
        self._admin_token_ts = 0.0
        self._admin_lock_name = ""
        self.http = HttpServer(host, port)
        self.http.role = "master"
        r = self.http.route
        r("POST", "/heartbeat", self._heartbeat)
        r("GET", "/dir/lookup", self._lookup)
        r("GET", "/dir/ec_lookup", self._ec_lookup)
        r("GET", "/vol/list", self._vol_list)
        r("GET", "/cluster/status", self._cluster_status)
        r("POST", "/cluster/lease_admin_token", self._lease_admin)
        r("POST", "/cluster/release_admin_token", self._release_admin)

    def start(self) -> "MasterServer":
        self.http.start()
        return self

    def stop(self) -> None:
        self.http.stop()

    @property
    def url(self) -> str:
        return self.http.url

    # -- handlers ---------------------------------------------------------

    def _heartbeat(self, req: Request):
        self.topology.register_heartbeat(req.json())
        with self._lock:
            self.heartbeats += 1
        return 200, {"volumeSizeLimit": self.topology.volume_size_limit,
                     "leader": self.url,
                     "topologyId": self.topology_id}

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
