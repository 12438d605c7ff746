"""The volume and cluster administration verbs of the shell (the
counterpart of `seaweedfs_tpu/shell/admin_commands.py`;
weed/shell/command_volume_mount.go, _volume_delete.go,
_volume_configure_replication.go, _volume_mark.go,
_volume_server_evacuate.go, _cluster_ps.go, ...):

    volume.mount -volumeId=N -node=URL     volume.unmount -volumeId=N
    volume.delete -volumeId=N              volume.delete.empty
    volume.mark -volumeId=N -readonly|-writable
    volume.configure.replication -volumeId=N -replication=XYZ
    volume.server.evacuate -node=URL       (volumes and EC shards)
    volume.server.state -node=URL          volume.server.leave -node=URL
    volume.vacuum.disable|enable [-node=URL]
    volume.replica.check                   cluster.ps  cluster.status
    cluster.raft.ps                        cluster.raft.leader.transfer
    cluster.raft.add -server=URL           cluster.raft.remove -server=URL
    volume.tier.upload -volumeId=N -endpoint=E [-bucket=B -accessKey=K
                       -secretKey=S]       volume.tier.download -volumeId=N
    sleep [SECONDS]

The raft verbs speak to the leader of `-master` (a seed list of the HA
set) through `operation.master_json`.  `volume.tier.upload` and
`.download` are the reference's names of `volume.tier.move` and
`.fetch` (`fs_commands`).  The mq verbs are not ported (ROADMAP A5)."""

from __future__ import annotations

import json
import time

from ..operation import master_json
from ..server.httpd import http_json
from .commands import (CommandEnv, _all_node_urls, _ec_shard_locations,
                       _move_shard, _move_volume, _must, _parse_flags,
                       command)


def _flag_true(opts: dict, name: str) -> bool:
    """Go-style boolean flags: presence is true, but an explicit
    -name=false|0|no is false."""
    if name not in opts:
        return False
    return str(opts[name]).lower() not in ("false", "0", "no")


def _vid_locations(env: CommandEnv, vid: int) -> "list[str]":
    return [loc["url"] for loc in env.volume_locations(vid)]


def _one_location(env: CommandEnv, opts: dict, vid: int) -> str:
    node = opts.get("node", "")
    locs = _vid_locations(env, vid)
    if node:
        if locs and node not in locs:
            raise RuntimeError(
                f"volume {vid} is not on {node} (it is on {locs})")
        return node
    if not locs:
        raise RuntimeError(f"volume {vid} has no locations")
    return locs[0]


@command("volume.mount")
def cmd_volume_mount(env: CommandEnv, args: list[str]) -> str:
    """command_volume_mount.go: mount an unmounted volume on a server
    (-volumeId=N -node=host:port).  -node is REQUIRED: the master
    forgets an unmounted volume within one heartbeat pulse, so there
    is no reliable location to infer."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    node = opts.get("node", "")
    if not node:
        raise RuntimeError("volume.mount requires -node=host:port "
                           "(the master does not track unmounted "
                           "volumes)")
    _must(http_json("POST", f"{node}/admin/mount_volume",
                    {"volumeId": vid,
                     "collection": opts.get("collection", "")}, timeout=30),
          f"mount volume {vid} on {node}")
    return f"mounted volume {vid} on {node}"


@command("volume.unmount")
def cmd_volume_unmount(env: CommandEnv, args: list[str]) -> str:
    """command_volume_unmount.go (-volumeId=N [-node=...])."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    node = _one_location(env, opts, vid)
    _must(http_json("POST", f"{node}/admin/unmount_volume",
                    {"volumeId": vid}, timeout=30),
          f"unmount volume {vid} on {node}")
    return f"unmounted volume {vid} on {node}"


@command("volume.delete")
def cmd_volume_delete(env: CommandEnv, args: list[str]) -> str:
    """command_volume_delete.go: delete a volume from every holder
    (-volumeId=N)."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    locs = _vid_locations(env, vid)
    if not locs:
        return f"volume {vid} has no locations"
    for url in locs:
        _must(http_json("POST", f"{url}/admin/delete_volume",
                        {"volumeId": vid}, timeout=30),
              f"delete volume {vid} on {url}")
    return f"deleted volume {vid} from {len(locs)} servers"


@command("volume.delete.empty")
def cmd_volume_delete_empty(env: CommandEnv, args: list[str]) -> str:
    """command_volume_delete_empty.go: delete volumes holding no live
    files (optionally -collection=...)."""
    env.confirm_is_locked()
    from ..topology import iter_volume_list_volumes
    opts = _parse_flags(args)
    collection = opts.get("collection")
    seen: dict[int, dict] = {}
    for _n, v in iter_volume_list_volumes(env.volume_list()):
        seen[v["id"]] = v
    deleted = []
    for vid, v in sorted(seen.items()):
        if collection is not None and \
                v.get("collection", "") != collection:
            continue
        if v.get("fileCount", 0) - v.get("deleteCount", 0) > 0:
            continue
        locs = _vid_locations(env, vid)
        # Quiet-period guard against the check-then-delete race: mark
        # the volume readonly FIRST (blocking new writes), then ask
        # every holder for its actual needle inventory; only a volume
        # that is verifiably empty while unwritable is deleted.  A
        # write that slipped in before the readonly mark is seen by
        # the inventory check; one after it is rejected at the server.
        # Volumes the OPERATOR already froze stay frozen on the
        # not-empty path — only our own quiet-period mark is undone.
        was_readonly = bool(v.get("readOnly", False))
        for url in locs:
            http_json("POST", f"{url}/admin/set_readonly",
                      {"volumeId": vid, "readOnly": True}, timeout=30)
        live_anywhere = False
        for url in locs:
            r = http_json("GET",
                          f"{url}/admin/volume_index?volumeId={vid}",
                    timeout=30)
            if r.get("error") or r.get("entries"):
                live_anywhere = True
                break
        if live_anywhere:
            if not was_readonly:
                for url in locs:  # undo OUR mark only
                    http_json("POST", f"{url}/admin/set_readonly",
                              {"volumeId": vid, "readOnly": False}, timeout=30)
            continue
        for url in locs:
            http_json("POST", f"{url}/admin/delete_volume",
                      {"volumeId": vid}, timeout=30)
        deleted.append(vid)
    return f"deleted {len(deleted)} empty volumes: {deleted}" \
        if deleted else "no empty volumes"


@command("volume.mark")
def cmd_volume_mark(env: CommandEnv, args: list[str]) -> str:
    """command_volume_mark.go: -volumeId=N -readonly|-writable on
    every holder."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    if _flag_true(opts, "readonly"):
        ro = True
    elif _flag_true(opts, "writable") or \
            ("readonly" in opts and not _flag_true(opts, "readonly")):
        ro = False
    else:
        raise RuntimeError("pass -readonly or -writable")
    locs = _vid_locations(env, vid)
    for url in locs:
        _must(http_json("POST", f"{url}/admin/set_readonly",
                        {"volumeId": vid, "readOnly": ro}, timeout=30),
              f"mark volume {vid} on {url}")
    state = "readonly" if ro else "writable"
    return f"marked volume {vid} {state} on {len(locs)} servers"


@command("volume.configure.replication")
def cmd_volume_configure_replication(env: CommandEnv,
                                     args: list[str]) -> str:
    """command_volume_configure_replication.go: rewrite a volume's
    replica placement (-volumeId=N -replication=XYZ) on every
    holder."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    replication = str(opts["replication"])
    if len(replication) != 3 or not replication.isdigit():
        raise RuntimeError("-replication must be 3 digits (e.g. 001)")
    locs = _vid_locations(env, vid)
    if not locs:
        return f"volume {vid} has no locations"
    for url in locs:
        _must(http_json("POST", f"{url}/admin/configure_volume",
                        {"volumeId": vid,
                         "replication": replication}, timeout=30),
              f"configure volume {vid} on {url}")
    return (f"volume {vid} replication set to {replication} on "
            f"{len(locs)} servers")


@command("volume.server.evacuate")
def cmd_volume_server_evacuate(env: CommandEnv,
                               args: list[str]) -> str:
    """command_volume_server_evacuate.go: move every volume AND every
    EC shard off a server (-node=host:port) onto the others.
    Replicated volumes keep their copy count: the victim's copy is
    moved to a server that doesn't already hold the volume (never just
    deleted — that would leave it under-replicated)."""
    env.confirm_is_locked()
    from ..topology import (iter_volume_list_ec_shards,
                            iter_volume_list_volumes)
    opts = _parse_flags(args)
    node = opts["node"]
    others = [u for u in _all_node_urls(env) if u != node]
    if not others:
        return "no other servers to evacuate to"
    vl = env.volume_list()
    victims = []
    ec_victims = []
    per_target: dict[str, int] = {u: 0 for u in others}
    for n, v in iter_volume_list_volumes(vl):
        if n["url"] == node:
            victims.append(v)
        else:
            per_target[n["url"]] = per_target.get(n["url"], 0) + 1
    for n, e in iter_volume_list_ec_shards(vl):
        if n["url"] == node:
            ec_victims.append(e)
    moved = 0
    skipped = []
    for v in victims:
        holders = set(_vid_locations(env, v["id"]))
        candidates = [u for u in others if u not in holders]
        if not candidates:
            skipped.append(v["id"])
            continue
        target = min(candidates, key=lambda u: per_target[u])
        _move_volume(env, v["id"], v.get("collection", ""), node,
                     target)
        per_target[target] += 1
        moved += 1
    ec_moved = 0
    for e in ec_victims:
        vid = e.get("volumeId", e.get("id"))
        bits = e.get("shardBits", 0)
        sids = [s for s in range(32) if bits & (1 << s)]
        for sid in sids:
            holders = _ec_shard_locations(env, vid)
            target = min(others,
                         key=lambda u: len(holders.get(u, [])))
            _move_shard(env, vid, e.get("collection", ""), sid, node,
                        target)
            ec_moved += 1
    out = f"evacuated {moved} volumes, {ec_moved} ec shards off {node}"
    if skipped:
        out += (f"; NOT moved (every other server already holds a "
                f"replica): volumes {skipped}")
    return out


# -- cluster ---------------------------------------------------------

@command("cluster.ps")
def cmd_cluster_ps(env: CommandEnv, args: list[str]) -> str:
    """command_cluster_ps.go: list cluster processes (masters +
    volume servers, with volume counts)."""
    from ..topology import iter_volume_list_volumes
    st = master_json(env.master, "GET", "/cluster/status", timeout=30)
    counts: dict[str, int] = {}
    for n, _v in iter_volume_list_volumes(env.volume_list()):
        counts[n["url"]] = counts.get(n["url"], 0) + 1
    lines = [f"master {st.get('leader', '?')} leader "
             f"(term {st.get('term', '?')})"]
    for peer in st.get("peers", []):
        if peer != st.get("leader"):
            lines.append(f"master {peer} follower")
    for url in st.get("dataNodes", []):
        lines.append(f"volume {url} ({counts.get(url, 0)} volumes)")
    return "\n".join(lines)


@command("cluster.status")
def cmd_cluster_status(env: CommandEnv, args: list[str]) -> str:
    """Raw cluster status JSON (command_cluster_status.go)."""
    return json.dumps(
        master_json(env.master, "GET", "/cluster/status",
            timeout=30), indent=2)


# -- the master set's raft (shell/command_cluster_raft_*.go) ---------------

@command("cluster.raft.ps")
def cmd_cluster_raft_ps(env: CommandEnv, args: list[str]) -> str:
    """command_cluster_raft_ps.go RaftListClusterServers: the members and
    the log's state."""
    st = master_json(env.master, "GET", "/cluster/status", timeout=30)
    _must(st, "cluster status")
    raft = st.get("raft", {})
    lines = [f"leader: {st.get('leader')}  term: {st.get('term')}  "
             f"topologyId: {st.get('topologyId')}"]
    for peer in st.get("peers", []):
        mark = "*" if peer == st.get("leader") else " "
        lines.append(f"  {mark} {peer}")
    lines.append(f"log: commit={raft.get('commitIndex')} "
                 f"applied={raft.get('appliedIndex')} "
                 f"last={raft.get('lastLogIndex')} "
                 f"snapshot={raft.get('snapshotIndex')} "
                 f"persistent={raft.get('persistent')}")
    return "\n".join(lines)


@command("cluster.raft.add")
def cmd_cluster_raft_add(env: CommandEnv, args: list[str]) -> str:
    """command_cluster_raft_add.go RaftAddServer (-server=host:port): a
    master joins the replicated membership."""
    server = _parse_flags(args).get("server", "")
    if not server:
        return "usage: cluster.raft.add -server=host:port"
    r = master_json(env.master, "POST", "/cluster/raft/config",
                    {"add": [server]}, timeout=30)
    _must(r, f"add raft server {server}")
    return f"members: {', '.join(r['peers'])}"


@command("cluster.raft.remove")
def cmd_cluster_raft_remove(env: CommandEnv, args: list[str]) -> str:
    """command_cluster_raft_remove.go RaftRemoveServer
    (-server=host:port)."""
    server = _parse_flags(args).get("server", "")
    if not server:
        return "usage: cluster.raft.remove -server=host:port"
    r = master_json(env.master, "POST", "/cluster/raft/config",
                    {"remove": [server]}, timeout=30)
    _must(r, f"remove raft server {server}")
    return f"members: {', '.join(r['peers'])}"


@command("cluster.raft.leader.transfer")
def cmd_cluster_raft_leader_transfer(env: CommandEnv,
                                     args: list[str]) -> str:
    """command_cluster_raft_leader_transfer.go ([-target=URL]): the
    leader replicates once more, nudges its most caught-up peer (or
    -target) with TimeoutNow and steps down: a handover in one round
    trip, not an election timeout."""
    r = master_json(env.master, "POST", "/cluster/raft/transfer",
                    {"target": _parse_flags(args).get("target", "")},
                    timeout=30)
    _must(r, "leader transfer")
    return "leadership transferred (TimeoutNow nudge sent to the " \
           "successor)"


@command("sleep")
def cmd_sleep(env: CommandEnv, args: list[str]) -> str:
    """command_sleep.go — for scripted `;` sequences."""
    time.sleep(float(args[0]) if args else 1.0)
    return ""


@command("volume.server.state")
def cmd_volume_server_state(env: CommandEnv, args: list[str]) -> str:
    """command_volume_server_status.go (-node=host:port): one server's
    live /status view."""
    opts = _parse_flags(args)
    node = opts.get("node", "")
    if not node:
        return "usage: volume.server.state -node=host:port"
    st = http_json("GET", f"{node}/status", timeout=30)
    _must(st, f"status of {node}")
    vols = st.get("volumes", [])
    ecs = st.get("ecShards", [])
    lines = [f"{node}: version {st.get('version', '?')}, "
             f"{len(vols)}/{st.get('maxVolumeCount', '?')} volumes, "
             f"{len(ecs)} ec volumes, "
             f"maxFileKey {st.get('maxFileKey', 0)}, "
             f"readPlanePort {st.get('readPlanePort', 0)}"]
    for v in vols:
        lines.append(f"  vol {v['id']:6d} {v.get('collection', ''):12s}"
                     f" {v.get('size', 0):>12d}B"
                     f" files={v.get('fileCount', 0)}"
                     f"{' RO' if v.get('readOnly') else ''}")
    return "\n".join(lines)


@command("volume.server.leave")
def cmd_volume_server_leave(env: CommandEnv, args: list[str]) -> str:
    """command_volume_server_leave.go (-node=host:port): the server
    stops heartbeating and the master forgets it after its pulse
    timeout.  Evacuate first (volume.server.evacuate) — volumes on a
    left server are no longer assignable or discoverable."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    node = opts.get("node", "")
    if not node:
        return "usage: volume.server.leave -node=host:port"
    _must(http_json("POST", f"{node}/admin/leave", {}, timeout=30),
          f"leave {node}")
    return f"{node} left the cluster (master forgets it within its " \
           f"pulse timeout)"


@command("volume.vacuum.disable")
def cmd_volume_vacuum_disable(env: CommandEnv, args: list[str]) -> str:
    """command_volume_vacuum_disable.go: gate vacuum during delicate
    maintenance (every node unless -node=)."""
    opts = _parse_flags(args)
    nodes = [opts["node"]] if opts.get("node") \
        else _all_node_urls(env)
    for n in nodes:
        _must(http_json("POST", f"{n}/admin/vacuum_toggle",
                        {"enabled": False},
                  timeout=30), f"disable vacuum on {n}")
    return f"vacuum disabled on {len(nodes)} server(s)"


@command("volume.vacuum.enable")
def cmd_volume_vacuum_enable(env: CommandEnv, args: list[str]) -> str:
    """command_volume_vacuum_enable.go."""
    opts = _parse_flags(args)
    nodes = [opts["node"]] if opts.get("node") \
        else _all_node_urls(env)
    for n in nodes:
        _must(http_json("POST", f"{n}/admin/vacuum_toggle",
                        {"enabled": True},
                  timeout=30), f"enable vacuum on {n}")
    return f"vacuum enabled on {len(nodes)} server(s)"


@command("volume.replica.check")
def cmd_volume_replica_check(env: CommandEnv, args: list[str]) -> str:
    """command_volume_check_disk.go's replica-divergence angle: compare
    every replicated volume's fileCount/deleteCount/size ACROSS its
    replicas via each server's live /status (the master view is
    aggregated and can hide divergence)."""
    per_server: dict[str, dict[int, dict]] = {}
    for url in _all_node_urls(env):
        st = http_json("GET", f"{url}/status", timeout=30)
        if st.get("error"):
            continue
        per_server[url] = {v["id"]: v for v in st.get("volumes", [])}
    by_vid: dict[int, list] = {}
    for url, vols in per_server.items():
        for vid, v in vols.items():
            by_vid.setdefault(vid, []).append((url, v))
    divergent = []
    for vid, replicas in sorted(by_vid.items()):
        if len(replicas) < 2:
            continue
        sigs = {(v.get("fileCount", 0), v.get("deleteCount", 0),
                 v.get("size", 0)) for _u, v in replicas}
        if len(sigs) > 1:
            detail = "; ".join(
                f"{u}: files={v.get('fileCount', 0)} "
                f"deletes={v.get('deleteCount', 0)} "
                f"size={v.get('size', 0)}" for u, v in replicas)
            divergent.append(f"volume {vid} DIVERGES: {detail}")
    checked = sum(1 for r in by_vid.values() if len(r) > 1)
    return "\n".join([f"checked {checked} replicated volumes: "
                      f"{len(divergent)} divergent"] + divergent)


@command("volume.tier.upload")
def cmd_volume_tier_upload(env: CommandEnv, args: list[str]) -> str:
    """command_volume_tier_upload.go: a volume's .dat to an S3-compatible
    tier backend (volume.tier.move's engine)."""
    from .fs_commands import cmd_volume_tier_move
    return cmd_volume_tier_move(env, args)


@command("volume.tier.download")
def cmd_volume_tier_download(env: CommandEnv, args: list[str]) -> str:
    """command_volume_tier_download.go: a tiered volume's .dat back to
    local disk (volume.tier.fetch's engine)."""
    from .fs_commands import cmd_volume_tier_fetch
    return cmd_volume_tier_fetch(env, args)
