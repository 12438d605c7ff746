"""The topology tree and the EC shard registry of the master
(weed/topology/topology.go, data_node.go, topology_ec.go:124
RegisterEcShards, :153 LookupEcShards): the part of
`seaweedfs_tpu/topology/topology.py` that the EC path reads.  Heartbeats
register each node's volumes and shards under one lock.

A node that misses 3 pulses is gone from every view: alive_nodes, the
lookups and the /vol/list tree.  That is the reference server's
UnRegisterDataNode when a heartbeat stream breaks
(topology_event_handling.go); the JAX package's copy drops such a node
from alive_nodes only.  Write placement and volume growth are not
ported (the port writes no needles), nor `mark_dead`, which only growth
calls when a volume allocation finds a node unreachable.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


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


class Topology:
    """weed/topology/topology.go:76."""

    def __init__(self, volume_size_limit: int = 8 * 1024 * 1024 * 1024,
                 pulse_seconds: float = 5.0):
        self.lock = threading.RLock()
        self.nodes: dict[str, DataNodeInfo] = {}
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self._max_volume_id = 0

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
