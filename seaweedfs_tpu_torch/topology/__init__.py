"""Cluster metadata: the DC -> rack -> data-node tree and the EC shard
registry (weed/topology), with the walks over a /vol/list tree that the
shell and the rebuild share (`seaweedfs_tpu/topology/__init__.py`)."""

from .topology import DataNodeInfo, Topology  # noqa: F401


def iter_volume_list_nodes(volume_list: dict):
    """Yield node dicts from a /vol/list JSON tree."""
    for dc in volume_list.get("dataCenters", {}).values():
        for rack in dc.get("racks", {}).values():
            yield from rack.get("nodes", [])


def iter_volume_list_volumes(volume_list: dict):
    """Yield (node, volume) pairs."""
    for node in iter_volume_list_nodes(volume_list):
        for v in node.get("volumes", []):
            yield node, v


def iter_volume_list_ec_shards(volume_list: dict):
    for node in iter_volume_list_nodes(volume_list):
        for e in node.get("ecShards", []):
            yield node, e


def fetch_ec_shard_locations(master: str, vid: int
                             ) -> "dict[str, list[int]]":
    """{url: [shard ids]} from the master's /dir/ec_lookup."""
    from ..operation import master_json
    r = master_json(master, "GET", f"/dir/ec_lookup?volumeId={vid}",
                    timeout=30)
    if "error" in r:
        return {}
    return {loc["url"]: loc["shardIds"]
            for loc in r.get("shardIdLocations", [])}


def shard_ids_to_urls(locations: "dict[str, list[int]]"
                      ) -> "dict[str, list[str]]":
    """Invert {url: [sids]} into the {str(sid): [urls]} shape of a
    streamed /admin/ec/rebuild's `shardLocations`."""
    out: dict[str, list[str]] = {}
    for url, sids in locations.items():
        for sid in sids:
            out.setdefault(str(sid), []).append(url)
    return out
