"""The topology tree and the EC shard registry of the master
(weed/topology/topology.go, data_node.go, topology_ec.go:124
RegisterEcShards, :153 LookupEcShards): the part of
`seaweedfs_tpu/topology/topology.py` that the EC path reads.  Heartbeats
register each node's volumes and shards under one lock.

A node that misses 3 pulses is gone from every view: alive_nodes, the
lookups and the /vol/list tree.  That is the reference server's
UnRegisterDataNode when a heartbeat stream breaks
(topology_event_handling.go); the JAX package's copy drops such a node
from alive_nodes only.  Write placement (topology.go:322 PickForWrite,
volume_layout.go's writable lists) and the volume growth plan
(volume_growth.go) serve the master's `/dir/assign`.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from dataclasses import dataclass, field

from ..storage.replica_placement import ReplicaPlacement


@dataclass
class VolumeInfo:
    id: int
    collection: str = ""
    size: int = 0
    file_count: int = 0
    delete_count: int = 0
    deleted_byte_count: int = 0
    read_only: bool = False
    replica_placement: int = 0
    ttl: int = 0
    version: int = 3


@dataclass
class EcShardInfo:
    volume_id: int
    collection: str = ""
    shard_bits: int = 0  # bitmask of shard ids present on the node
    data_shards: int = 10
    parity_shards: int = 4

    @property
    def shard_ids(self) -> list[int]:
        return [s for s in range(32) if self.shard_bits & (1 << s)]


@dataclass
class DataNodeInfo:
    """One volume server (weed/topology/data_node.go)."""

    url: str                  # ip:port, the node's identity
    public_url: str = ""
    data_center: str = "DefaultDataCenter"
    rack: str = "DefaultRack"
    max_volume_count: int = 8
    volumes: dict[int, VolumeInfo] = field(default_factory=dict)
    ec_shards: dict[int, EcShardInfo] = field(default_factory=dict)
    last_seen: float = 0.0

    @property
    def volume_count(self) -> int:
        return len(self.volumes)

    @property
    def free_space(self) -> int:
        return self.max_volume_count - len(self.volumes)


class Topology:
    """weed/topology/topology.go:76."""

    def __init__(self, volume_size_limit: int = 8 * 1024 * 1024 * 1024,
                 pulse_seconds: float = 5.0):
        self.lock = threading.RLock()
        self.nodes: dict[str, DataNodeInfo] = {}
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self._max_volume_id = 0
        self._pick_rr = itertools.count()

    # -- heartbeat registration -------------------------------------------

    def register_heartbeat(self, hb: dict) -> None:
        url = f"{hb['ip']}:{hb['port']}"
        with self.lock:
            node = self.nodes.get(url)
            if node is None:
                node = DataNodeInfo(url=url)
                self.nodes[url] = node
            node.public_url = hb.get("publicUrl", url)
            node.data_center = hb.get("dataCenter") or node.data_center
            node.rack = hb.get("rack") or node.rack
            node.max_volume_count = hb.get("maxVolumeCount",
                                           node.max_volume_count)
            node.last_seen = time.monotonic()
            node.volumes = {
                v["id"]: VolumeInfo(
                    id=v["id"], collection=v.get("collection", ""),
                    size=v.get("size", 0),
                    file_count=v.get("fileCount", 0),
                    delete_count=v.get("deleteCount", 0),
                    deleted_byte_count=v.get("deletedByteCount", 0),
                    read_only=v.get("readOnly", False),
                    replica_placement=v.get("replicaPlacement", 0),
                    ttl=v.get("ttl", 0), version=v.get("version", 3))
                for v in hb.get("volumes", [])}
            node.ec_shards = {
                e["id"]: EcShardInfo(
                    volume_id=e["id"], collection=e.get("collection", ""),
                    shard_bits=e.get("ecIndexBits", 0),
                    data_shards=e.get("dataShards", 10),
                    parity_shards=e.get("parityShards", 4))
                for e in hb.get("ecShards", [])}
            for vid in list(node.volumes) + list(node.ec_shards):
                self._max_volume_id = max(self._max_volume_id, vid)

    def _liveness_deadline(self) -> float:
        # monotonic: a wall-clock step must neither kill nor immortalise
        # the fleet
        return time.monotonic() - 3 * self.pulse_seconds

    def alive_nodes(self) -> list[DataNodeInfo]:
        deadline = self._liveness_deadline()
        with self.lock:
            return [n for n in self.nodes.values()
                    if n.last_seen >= deadline]

    def mark_dead(self, url: str) -> None:
        """Expire a node found unreachable at once (the analog of
        topology_event_handling.go UnRegisterDataNode on a broken
        heartbeat stream), without waiting out the missed pulses.  Its
        next heartbeat brings it back."""
        with self.lock:
            n = self.nodes.get(url)
            if n is not None:
                # -inf, not 0.0: time.monotonic counts from boot
                n.last_seen = float("-inf")

    # -- volume id assignment ---------------------------------------------

    def next_volume_id(self) -> int:
        with self.lock:
            self._max_volume_id += 1
            return self._max_volume_id

    def floor_volume_id(self, vid: int) -> None:
        """Issue no volume id at or below `vid` (the master's committed
        `maxVolumeId`)."""
        with self.lock:
            self._max_volume_id = max(self._max_volume_id, int(vid))

    # -- lookups (master_grpc_server_volume.go LookupVolume,
    #    topology_ec.go:153 LookupEcShards) -------------------------------

    def lookup(self, vid: int) -> list[dict]:
        """All live locations serving volume vid (normal or EC)."""
        out = []
        with self.lock:
            nodes = self.alive_nodes()
            for node in nodes:
                if vid in node.volumes:
                    out.append({"url": node.url,
                                "publicUrl": node.public_url})
            if not out:
                for node in nodes:
                    e = node.ec_shards.get(vid)
                    if e is not None:
                        out.append({"url": node.url,
                                    "publicUrl": node.public_url,
                                    "shardBits": e.shard_bits})
        return out

    def lookup_ec_shards(self, vid: int) -> dict[str, list[int]]:
        """url -> shard ids, live nodes only (topology_ec.go:153)."""
        out: dict[str, list[int]] = {}
        with self.lock:
            for node in self.alive_nodes():
                e = node.ec_shards.get(vid)
                if e is not None:
                    out[node.url] = e.shard_ids
        return out

    # -- write placement (topology.go:322 PickForWrite +
    #    volume_layout.go writable selection) ----------------------------

    def writable_volumes(self, collection: str = "", replication: str = "",
                         ttl_u32: int = 0
                         ) -> list[tuple[int, list[DataNodeInfo]]]:
        """(vid, nodes) groups of (collection, rp, ttl) that are not
        read-only, are under the size limit, sit on live nodes and have
        a full replica set."""
        rp = ReplicaPlacement.from_string(replication or "000")
        want_copies = rp.copy_count()
        by_vid: dict[int, list[DataNodeInfo]] = {}
        deadline = self._liveness_deadline()
        with self.lock:
            for node in self.nodes.values():
                if node.last_seen < deadline:
                    # a disconnected node's volumes leave the writable
                    # set (volume_layout.go SetVolumeUnavailable)
                    continue
                for vid, v in node.volumes.items():
                    if v.collection != collection:
                        continue
                    if replication and v.replica_placement != rp.byte():
                        continue
                    if v.ttl != ttl_u32:
                        continue
                    if v.read_only or v.size >= self.volume_size_limit:
                        continue
                    by_vid.setdefault(vid, []).append(node)
        return [(vid, nodes) for vid, nodes in by_vid.items()
                if len(nodes) >= want_copies]

    def pick_for_write(self, collection: str = "", replication: str = "",
                       ttl_u32: int = 0) -> tuple[int, list[DataNodeInfo]]:
        candidates = self.writable_volumes(collection, replication, ttl_u32)
        if not candidates:
            raise LookupError("no writable volumes")
        # round-robin over sorted vids: clients that take a window of
        # fids an assign (count=N) pin a volume for many writes, and
        # strict rotation keeps the write load even across volumes
        candidates.sort(key=lambda c: c[0])
        return candidates[next(self._pick_rr) % len(candidates)]

    # -- growth (volume_growth.go) ----------------------------------------

    def plan_growth(self, replication: str = "",
                    exclude: set[str] | None = None
                    ) -> list[DataNodeInfo]:
        """Target nodes for a new volume's replica set under the xyz
        placement (volume_growth.go findEmptySlotsForOneVolume,
        simplified: grouped by data centre, then rack, the nodes with
        the most free slots first, ties broken at random).  `exclude`
        drops nodes that just refused an allocation."""
        rp = ReplicaPlacement.from_string(replication or "000")
        alive = [n for n in self.alive_nodes()
                 if n.free_space > 0 and n.url not in (exclude or ())]
        if not alive:
            raise LookupError("no free volume slots in cluster")
        main = max(alive, key=lambda n: (n.free_space, random.random()))
        picked = [main]

        def pick(pool, count, err):
            pool = [n for n in pool if n not in picked and n.free_space > 0]
            if len(pool) < count:
                raise LookupError(err)
            pool.sort(key=lambda n: (-n.free_space, random.random()))
            return pool[:count]

        picked += pick([n for n in alive
                        if n.data_center == main.data_center
                        and n.rack == main.rack],
                       rp.same_rack_count,
                       "not enough same-rack nodes")
        picked += pick([n for n in alive
                        if n.data_center == main.data_center
                        and n.rack != main.rack],
                       rp.diff_rack_count,
                       "not enough cross-rack nodes")
        picked += pick([n for n in alive
                        if n.data_center != main.data_center],
                       rp.diff_data_center_count,
                       "not enough cross-DC nodes")
        return picked

    # -- full cluster snapshot (master_grpc_server_volume.go VolumeList) --

    def to_volume_list(self) -> dict:
        with self.lock:
            dcs: dict[str, dict] = {}
            for node in self.alive_nodes():
                dc = dcs.setdefault(node.data_center, {"racks": {}})
                rack = dc["racks"].setdefault(node.rack, {"nodes": []})
                rack["nodes"].append({
                    "url": node.url,
                    "publicUrl": node.public_url,
                    "maxVolumeCount": node.max_volume_count,
                    "volumes": [{
                        "id": v.id,
                        "collection": v.collection,
                        "size": v.size,
                        "fileCount": v.file_count,
                        "deleteCount": v.delete_count,
                        "deletedByteCount": v.deleted_byte_count,
                        "readOnly": v.read_only,
                        "replicaPlacement": v.replica_placement,
                        "ttl": v.ttl,
                        "version": v.version,
                    } for v in node.volumes.values()],
                    "ecShards": [{
                        "volumeId": e.volume_id,
                        "collection": e.collection,
                        "shardBits": e.shard_bits,
                        "dataShards": e.data_shards,
                        "parityShards": e.parity_shards,
                    } for e in node.ec_shards.values()],
                })
            return {"maxVolumeId": self._max_volume_id,
                    "dataCenters": dcs}
