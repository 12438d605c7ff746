"""Shell commands (weed/shell/command_*.go): the EC and volume
maintenance verbs and the observability views of
`seaweedfs_tpu/shell/commands.py` (the `fs.*` family and the repair
plane are in `fs_commands.py`, the volume and cluster administration
verbs in `admin_commands.py`).

    lock, unlock, volume.list, cluster.check
    ec.encode   [-volumeId=N | -collection=C] [-mode=scatter|local]
                [-dataShards=10 -parityShards=4]
    ec.rebuild  [-volumeId=N] [-mode=stream|copy]
    ec.decode   -volumeId=N
    ec.scrub    [-mode=local|index]
    ec.balance  [-collection=C]
    volume.vacuum [-volumeId=N]     volume.scrub [-volumeId=N]
    volume.balance                  volume.fix.replication
    volume.copy  -volumeId=N -target=URL [-source=URL]
    volume.move  -volumeId=N -source=URL -target=URL
    volume.grow  [-collection=C] [-replication=XYZ] [-count=1]
    volume.merge -volumeId=N
    collection.list                 collection.delete -collection=C -force
    trace.show  REQUEST_ID [-nodes=...] [-health]
    qos.status  [-nodes=...]
    qos.set     -tenant=AK -rps=N [-burst=N] [-inflightMb=N]
                | -sloP99Ms=N | -clear
    cluster.top      [-interval=2] [-nodes=host:port,...]
    cluster.slow     [-top=5] [-verdict=slow|error|deadline]
                     [-nodes=...] [-clear]
    cluster.profile  [-duration=10] [-hz=100] [-top=25] [-out=FILE]
                     [-nodes=...]

Commands run against a CommandEnv holding the master address and the
cluster admin lock token; the EC commands need the lock
(shell/command_lock_unlock.go).  The output lines keep the reference's
format.  The codec runs on the volume servers: this module does no
device work and imports no torch.
"""

from __future__ import annotations

import json
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

from ..operation import master_json
from ..server.httpd import http_bytes, http_json, http_relay
from ..storage.erasure_coding.ec_context import to_ext
from ..util import retry

COMMANDS: dict[str, "callable"] = {}


def command(name):
    def reg(fn):
        COMMANDS[name] = fn
        fn.command_name = name
        return fn
    return reg


class CommandEnv:
    def __init__(self, master: str, filer: str = ""):
        self.master = master
        self.filer = filer  # host:port for the fs.* family
        self.admin_token: int | None = None

    def require_filer(self) -> str:
        if not self.filer:
            raise RuntimeError(
                "no filer configured; start the shell with -filer or "
                "run `fs.configure -filer=host:port`")
        return self.filer

    # -- admin lock (command_lock_unlock.go) ------------------------------

    def lock(self) -> None:
        r = master_json(self.master, "POST", "/cluster/lease_admin_token",
                        {"previousToken": self.admin_token or 0,
                         "lockName": "admin"}, timeout=30)
        if "token" not in r:
            raise RuntimeError(f"cannot acquire cluster lock: {r}")
        self.admin_token = r["token"]

    def unlock(self) -> None:
        master_json(self.master, "POST", "/cluster/release_admin_token",
                    {"previousToken": self.admin_token or 0}, timeout=30)
        self.admin_token = None

    # how long a command waits for the leader's topology to be warm
    WARM_TIMEOUT = 30.0

    def confirm_is_locked(self) -> None:
        """command_ec_encode.go:104 confirmIsLocked; then the wait for a
        warm topology: a command that moves, deletes or rebuilds data
        acts only on a leader's view that has heard every live server."""
        if self.admin_token is None:
            raise RuntimeError(
                "lock is lost, or it is not locked; run `lock` first")
        self.wait_topology_warm()

    def wait_topology_warm(self, timeout: "float | None" = None) -> None:
        """Wait until the leader's `/cluster/status` says `topologyWarm`
        (a JAX master does not say, and is taken as warm).  A leader new
        in office knows only the servers that heartbeated to it since:
        on that view a live server's shards look missing, and ec.rebuild
        would rebuild them (ROADMAP C)."""
        limit = time.monotonic() + (self.WARM_TIMEOUT if timeout is None
                                    else timeout)
        while True:
            st = master_json(self.master, "GET", "/cluster/status",
                             timeout=30)
            if "error" in st:
                raise RuntimeError(f"cluster status: {st['error']}")
            if st.get("topologyWarm", True):
                return
            if time.monotonic() >= limit:
                raise RuntimeError("the leader's topology is not warm "
                                   f"after {timeout or self.WARM_TIMEOUT} s")
            time.sleep(0.1)

    def master_seeds(self) -> "list[str]":
        """The masters of `-master` (one address or an HA seed list)."""
        return [x.strip() for x in self.master.split(",") if x.strip()]

    def volume_list(self) -> dict:
        return master_json(self.master, "GET", "/vol/list", timeout=30)

    def volume_locations(self, vid: int) -> list[dict]:
        r = master_json(self.master, "GET", f"/dir/lookup?volumeId={vid}",
                        timeout=30)
        return r.get("locations", [])


# --- basic commands ------------------------------------------------------

@command("lock")
def cmd_lock(env: CommandEnv, args: list[str]) -> str:
    env.lock()
    return "locked"


@command("unlock")
def cmd_unlock(env: CommandEnv, args: list[str]) -> str:
    env.unlock()
    return "unlocked"


@command("volume.list")
def cmd_volume_list(env: CommandEnv, args: list[str]) -> str:
    """shell/command_volume_list.go."""
    return json.dumps(env.volume_list(), indent=2)


@command("cluster.check")
def cmd_cluster_check(env: CommandEnv, args: list[str]) -> str:
    r = master_json(env.master, "GET", "/cluster/status", timeout=30)
    return json.dumps(r, indent=2)


@command("volume.vacuum")
def cmd_volume_vacuum(env: CommandEnv, args: list[str]) -> str:
    """shell/command_volume_vacuum.go: compact every volume (or
    -volumeId) on each of its servers."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    target_vid = int(opts["volumeId"]) if "volumeId" in opts else None
    done = []
    for vid, urls in _volumes_by_id(env).items():
        if target_vid is not None and vid != target_vid:
            continue
        for url in urls:
            _must(http_json("POST", f"{url}/admin/vacuum",
                            {"volumeId": vid}, timeout=3600),
                  f"vacuum {vid} on {url}")
        done.append(vid)
    return f"vacuumed volumes: {sorted(done)}"


# --- EC commands (command_ec_encode.go:86) -------------------------------

@command("ec.encode")
def cmd_ec_encode(env: CommandEnv, args: list[str]) -> str:
    """shell/command_ec_encode.go:86 Do, placement-first.

    `-mode=scatter` (the default): plan every shard's destination up
    front, then the source server streams each shard straight to it and
    mounts it there.  `-mode=local`: generate every shard on the source,
    mount them, then move them out with the balance rules."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    mode = opts.get("mode", "scatter")
    if mode not in ("scatter", "local"):
        return f"unknown -mode={mode}; use scatter or local"
    data_shards = int(opts.get("dataShards", 10))
    parity_shards = int(opts.get("parityShards", 4))
    vids = _select_volumes(env, opts)
    if not vids:
        return "no volumes qualify for ec encoding"
    return "\n".join(_do_ec_encode(env, vid, data_shards, parity_shards,
                                   opts, mode) for vid in vids)


def _do_ec_encode(env: CommandEnv, vid: int, data_shards: int,
                  parity_shards: int, opts: dict,
                  mode: str = "scatter") -> str:
    # locations before anything changes (command_ec_encode.go:160-166)
    locations = env.volume_locations(vid)
    if not locations:
        raise RuntimeError(f"volume {vid} has no locations")
    collection = opts.get("collection", "")
    if collection == "ALL":
        # a selection sentinel for the empty collection, never a name
        collection = ""
    total = data_shards + parity_shards
    source = locations[0]["url"]
    # 1. every replica read-only (:250), undone on any later failure:
    # the volume is still the only copy of the data
    marked: list[str] = []
    try:
        for loc in locations:
            _must(http_json("POST", f"{loc['url']}/admin/set_readonly",
                            {"volumeId": vid, "readOnly": True},
                            timeout=30),
                  f"set readonly on {loc['url']}")
            marked.append(loc["url"])
        if mode == "scatter":
            # 2s. placement first, then one scatter generate.  A
            # generate that fails on named destinations (failedDests) is
            # re-planned around them, at most twice; with no candidate
            # left, local mode still completes the encode
            exclude: set = set()
            replans = 0
            while True:
                try:
                    placement = _plan_ec_placement(env, vid, total,
                                                   exclude=exclude)
                except RuntimeError:
                    if not exclude:
                        raise
                    return _do_ec_encode(env, vid, data_shards,
                                         parity_shards, opts, "local")
                r = http_json("POST", f"{source}/admin/ec/generate", {
                    "volumeId": vid, "collection": collection,
                    "dataShards": data_shards,
                    "parityShards": parity_shards,
                    "replan": replans,
                    "placement": {str(s): u
                                  for s, u in placement.items()}},
                    timeout=600.0)
                if "error" not in r:
                    for url in set(placement.values()):
                        retry.record_success(url)
                    break
                failed = [d for d in r.get("failedDests", [])
                          if d != source]
                for url in failed:
                    retry.record_failure(url)
                dropped = set(failed) - exclude
                if replans >= 2 or not dropped:
                    _must(r, f"scatter generate on {source}")
                exclude |= dropped
                replans += 1
            moved = 0
        else:
            # 2. generate on the first replica (:359), 3. mount there
            # (:314): a silent mount failure would let step 5 delete
            # the original with the EC copy unregistered
            _must(http_json("POST", f"{source}/admin/ec/generate", {
                "volumeId": vid, "collection": collection,
                "dataShards": data_shards,
                "parityShards": parity_shards}, timeout=600.0),
                f"generate on {source}")
            _must(http_json("POST", f"{source}/admin/ec/mount", {
                "volumeId": vid, "collection": collection,
                "shardIds": list(range(total))}, timeout=30),
                f"mount ec shards on {source}")
            # 4. spread the shards (EcBalance, :199)
            moved = _balance_ec_volume(env, vid, collection, total)
            r = {}
    except BaseException:
        for url in marked:
            try:
                http_json("POST", f"{url}/admin/set_readonly",
                          {"volumeId": vid, "readOnly": False}, timeout=30)
            except OSError:
                pass
        raise
    # 5. delete the original replicas (:329), only now that every shard
    # is mounted at its destination
    for loc in locations:
        http_json("POST", f"{loc['url']}/admin/delete_volume",
                  {"volumeId": vid}, timeout=30)
    if mode == "scatter":
        tele = r.get("telemetry") or {}
        dests = len(set((r.get("placement") or {}).values())) or 1
        msg = (f"volume {vid}: scatter-encoded {total} shards from "
               f"{source} to {dests} destinations, deleted originals")
        if tele:
            msg += (f" [{tele['bytesScatteredTotal'] >> 20}MB "
                    f"scattered, {tele['localWriteBytes'] >> 20}MB "
                    f"local, {tele['volumeGbps']} GB/s volume-rate, "
                    f"window p95 {tele['windowP95Ms']}ms]")
        return msg
    return (f"volume {vid}: encoded {total} shards on {source}, "
            f"moved {moved} shards, deleted originals")


def _plan_ec_placement(env: CommandEnv, vid: int, total: int,
                       exclude: "frozenset | set" = frozenset()
                       ) -> "dict[int, str]":
    """Shard -> server before the encode, by the rules
    `_balance_ec_volume` applies after it: toward `_rack_caps`
    shards a rack, even counts within a rack, ties broken by placement
    score.  Nodes in `exclude` and nodes whose breaker is open are never
    chosen."""
    nodes = [n for n in _all_node_urls(env)
             if n not in exclude and retry.peer_available(n)]
    if not nodes:
        raise RuntimeError("no alive volume servers to place shards")
    vl = env.volume_list()
    rack_of = _rack_of_nodes(env, vl)
    score = _ec_placement_scores(env, vid, vl)
    racks = sorted({rack_of.get(n, "?") for n in nodes})
    caps = _rack_caps(nodes, rack_of, total)
    rack_load: dict[str, int] = {r: 0 for r in racks}
    node_load: dict[str, int] = {n: 0 for n in nodes}
    placement: dict[int, str] = {}
    for sid in range(total):
        open_racks = [r for r in racks if rack_load[r] < caps[r]] \
            or racks
        rack = min(open_racks, key=lambda r: rack_load[r])
        members = [n for n in nodes if rack_of.get(n, "?") == rack]
        dst = min(members, key=lambda n: (node_load[n], score.get(n, 0)))
        placement[sid] = dst
        rack_load[rack] += 1
        node_load[dst] += 1
    return placement


def _rack_caps(nodes: list[str], rack_of: dict[str, str],
               total: int) -> dict[str, int]:
    """The shards of one EC volume each rack may hold: ceil(total /
    racks), but no more than its servers hold at ceil(total / servers)
    each, and raised evenly where that leaves racks short of `total`.
    On equal racks this is ceil(total / racks), as upstream; on racks
    of unequal size upstream's cap leaves more than ceil(total /
    servers) on a server of the smaller rack, which the ec_balance
    detection then proposes again after every run (ROADMAP C19)."""
    members: dict[str, int] = {}
    for n in nodes:
        r = rack_of.get(n, "?")
        members[r] = members.get(r, 0) + 1
    per_server = -(-total // len(nodes))
    room = {r: m * per_server for r, m in members.items()}
    cap = max(1, -(-total // len(members)))
    while sum(min(room[r], cap) for r in room) < total:
        cap += 1
    return {r: min(room[r], cap) for r in room}


def _rack_of_nodes(env: CommandEnv, vl: "dict | None" = None
                   ) -> dict[str, str]:
    """url -> "dc/rack" from the topology tree."""
    vl = vl if vl is not None else env.volume_list()
    out: dict[str, str] = {}
    for dc_name, dc in vl.get("dataCenters", {}).items():
        for rack_name, rack in dc.get("racks", {}).items():
            for node in rack.get("nodes", []):
                out[node["url"]] = f"{dc_name}/{rack_name}"
    return out


def _ec_placement_scores(env: CommandEnv, vid: int,
                         vl: "dict | None" = None) -> dict[str, int]:
    """Per-node placement score, lower is better
    (command_ec_common.go:1380 diskDistributionScore): shards of this
    volume weigh 100, all EC shards 10, free volume slots subtract."""
    from ..topology import iter_volume_list_ec_shards
    vl = vl if vl is not None else env.volume_list()
    scores: dict[str, int] = {}
    headroom: dict[str, int] = {}
    for dc in vl.get("dataCenters", {}).values():
        for rack in dc.get("racks", {}).values():
            for node in rack.get("nodes", []):
                headroom[node["url"]] = \
                    int(node.get("maxVolumeCount", 8)) - \
                    len(node.get("volumes", []))
                scores[node["url"]] = 0
    for node, e in iter_volume_list_ec_shards(vl):
        cnt = bin(int(e.get("ecIndexBits", 0))).count("1")
        url = node["url"]
        scores[url] = scores.get(url, 0) + cnt * 10
        if e.get("volumeId", e.get("id")) == vid:
            scores[url] += cnt * 100
    return {u: s - headroom.get(u, 0) for u, s in scores.items()}


def _balance_ec_volume(env: CommandEnv, vid: int, collection: str,
                       total: int) -> int:
    """command_ec_common.go:59-124: (1) drop duplicate shard copies,
    (2) spread shards across racks toward `_rack_caps` (total/racks a
    rack on equal racks), (3) even out the counts within each rack.
    Returns the moves made."""
    shard_locs = _ec_shard_locations(env, vid)
    nodes = _all_node_urls(env)
    if not nodes:
        return 0
    rack_of = _rack_of_nodes(env)
    score = _ec_placement_scores(env, vid)
    moved = 0

    # (1) dedupe: keep the first copy of each shard
    owner: dict[int, str] = {}
    for url, sids in sorted(shard_locs.items()):
        for sid in sids:
            if sid in owner:
                _delete_shards(url, vid, collection, [sid])
                moved += 1
            else:
                owner[sid] = url

    def load_by_url() -> dict[str, list[int]]:
        load = {n: [] for n in nodes}
        for sid, url in owner.items():
            load.setdefault(url, []).append(sid)
        return load

    def move(sid: int, src: str, dst: str):
        nonlocal moved
        _move_shard(env, vid, collection, sid, src, dst)
        owner[sid] = dst
        moved += 1

    # (2) across racks, toward `_rack_caps`; only racks with an alive
    # member receive
    racks = sorted({rack_of.get(n, "?") for n in nodes})
    avg_per_rack = max(1, -(-total // max(len(racks), 1)))  # ceil
    caps = _rack_caps(nodes, rack_of, total)

    def rack_load() -> dict[str, list[int]]:
        rl: dict[str, list[int]] = {r: [] for r in racks}
        for sid, url in owner.items():
            rl.setdefault(rack_of.get(url, "?"), []).append(sid)
        return rl
    rl = rack_load()
    for rack in sorted(rl, key=lambda r: -len(rl[r])):
        while len(rl[rack]) > caps.get(rack, avg_per_rack):
            receivable = [r for r in rl if r != rack and
                          len(rl[r]) < caps.get(r, 0)]
            if not receivable:
                break
            dest_rack = min(receivable, key=lambda r: len(rl[r]))
            load = load_by_url()
            dst = min((n for n in nodes
                       if rack_of.get(n, "?") == dest_rack),
                      key=lambda n: (len(load[n]), score.get(n, 0)))
            sid = rl[rack][-1]
            move(sid, owner[sid], dst)
            rl = rack_load()

    # (3) within racks
    for rack in racks:
        members = [n for n in nodes if rack_of.get(n, "?") == rack]
        if not members:
            continue
        load = load_by_url()
        rack_shards = [sid for sid, url in owner.items() if url in members]
        avg = max(1, -(-len(rack_shards) // len(members)))
        for donor in sorted(members, key=lambda n: -len(load[n])):
            while len(load[donor]) > avg:
                recv = min(members, key=lambda n: (len(load[n]),
                                                   score.get(n, 0)))
                if recv == donor or len(load[recv]) + 1 > avg:
                    break
                sid = load[donor][-1]
                move(sid, donor, recv)
                load[donor].remove(sid)
                load[recv].append(sid)
    return moved


def _move_shard(env: CommandEnv, vid: int, collection: str, sid: int,
                source: str, dest: str) -> None:
    """command_ec_common.go:336: copy the shard (with .ecx, and .ecj and
    .vif where present) from source to dest, each file relayed a chunk
    at a time, mount it on dest, then delete it on source."""
    for ext in (to_ext(sid), ".ecx", ".ecj", ".vif"):
        src_status, dst_status, body = http_relay(
            f"{source}/admin/volume_file?volumeId={vid}"
            f"&collection={collection}&ext={ext}",
            "POST", f"{dest}/admin/receive_file?volumeId={vid}"
            f"&collection={collection}&ext={ext}", timeout=600)
        if src_status != 200:
            if ext in (".ecj", ".vif"):
                continue
            raise RuntimeError(
                f"move shard {vid}.{sid}: pull {ext} from {source}: "
                f"{src_status}")
        if dst_status != 200:
            raise RuntimeError(
                f"move shard {vid}.{sid}: push {ext} to {dest}: "
                f"{dst_status} {body[:200]!r}")
    _must(http_json("POST", f"{dest}/admin/ec/mount",
                    {"volumeId": vid, "collection": collection,
                     "shardIds": [sid]}, timeout=30),
          f"mount shard {vid}.{sid} on {dest}")
    _delete_shards(source, vid, collection, [sid])


def _delete_shards(url: str, vid: int, collection: str,
                   sids: list[int]) -> None:
    """The server refreshes its mounted shards and heartbeat itself."""
    http_json("POST", f"{url}/admin/ec/delete_shards",
              {"volumeId": vid, "collection": collection,
               "shardIds": sids}, timeout=30)


@command("ec.decode")
def cmd_ec_decode(env: CommandEnv, args: list[str]) -> str:
    """shell/command_ec_decode.go:64: gather the shards on the server
    holding most of them, decode there to a normal volume, and delete
    the shards everywhere (the target's too: stale `.ecNN` files would
    be taken for survivors later)."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    collection = opts.get("collection", "")
    shard_locs = _ec_shard_locations(env, vid)
    if not shard_locs:
        return f"volume {vid} has no ec shards"
    target = max(shard_locs, key=lambda u: len(shard_locs[u]))
    have = set(shard_locs[target])
    for url, sids in shard_locs.items():
        if url == target:
            continue
        need = [s for s in sids if s not in have]
        if need:
            http_json("POST", f"{target}/admin/ec/copy", {
                "volumeId": vid, "collection": collection,
                "shardIds": need, "sourceDataNode": url,
                "copyEcxFile": False, "copyEcjFile": True,
                "copyVifFile": False}, timeout=30)
            have.update(need)
    r = http_json("POST", f"{target}/admin/ec/to_volume",
                  {"volumeId": vid, "collection": collection},
                  timeout=600.0)
    if "error" in r:
        raise RuntimeError(f"decode: {r['error']}")
    for url, sids in shard_locs.items():
        if url != target:
            _delete_shards(url, vid, collection, sids)
    _delete_shards(target, vid, collection, sorted(have))
    return f"volume {vid}: decoded to normal volume on {target}"


@command("ec.rebuild")
def cmd_ec_rebuild(env: CommandEnv, args: list[str]) -> str:
    """shell/command_ec_rebuild.go:83: rebuild each EC volume's missing
    shards on the node holding most survivors, then re-spread.

    `-mode=stream` (the default): the rebuilder streams remote survivors
    in slice windows straight into the codec.  `-mode=copy`: every
    remote survivor is pulled whole through /admin/ec/copy first."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    mode = opts.get("mode", "stream")
    if mode not in ("stream", "copy"):
        return f"unknown -mode={mode}; use stream or copy"
    vids = ([int(opts["volumeId"])] if "volumeId" in opts
            else list(_ec_volumes(env)))
    out = [_rebuild_one(env, vid, opts.get("collection", ""), mode)
           for vid in vids]
    return "\n".join(out) if out else "no ec volumes"


def _rebuild_one(env: CommandEnv, vid: int, collection: str,
                 mode: str = "stream") -> str:
    shard_locs = _ec_shard_locations(env, vid)
    present = sorted({s for sids in shard_locs.values() for s in sids})
    info = None
    for url in shard_locs:
        r = http_json("GET", f"{url}/admin/ec/info?volumeId={vid}",
                      timeout=30)
        if "error" not in r:
            info = r
            break
    if info is None:
        return f"volume {vid}: no reachable shards"
    total = info["dataShards"] + info["parityShards"]
    missing = [s for s in range(total) if s not in present]
    if not missing:
        return f"volume {vid}: all {total} shards present"
    # the rebuilder holds the most shards: the fewest bytes to pull
    rebuilder = max(shard_locs, key=lambda u: len(shard_locs[u]))
    if mode == "copy":
        # pull the survivors the rebuilder lacks, whole, one source at a
        # time; the sidecars ride once, with the first copy
        have = set(shard_locs[rebuilder])
        sidecars_pending = True
        for url, sids in shard_locs.items():
            if url == rebuilder:
                continue
            need = [s for s in sids if s not in have]
            if need:
                http_json("POST", f"{rebuilder}/admin/ec/copy", {
                    "volumeId": vid, "collection": collection,
                    "shardIds": need, "sourceDataNode": url,
                    "copyEcxFile": sidecars_pending,
                    "copyEcjFile": sidecars_pending,
                    "copyVifFile": sidecars_pending}, timeout=30)
                sidecars_pending = False
                have.update(need)
        r = http_json("POST", f"{rebuilder}/admin/ec/rebuild",
                      {"volumeId": vid, "collection": collection,
                       "mode": "local"}, timeout=30)
    else:
        # the rebuilder range-reads its survivors off their holders:
        # no /admin/ec/copy, nothing staged on its disks
        from ..topology import shard_ids_to_urls
        r = http_json("POST", f"{rebuilder}/admin/ec/rebuild",
                      {"volumeId": vid, "collection": collection,
                       "mode": "stream",
                       "shardLocations": shard_ids_to_urls(shard_locs),
                       "dataShards": info["dataShards"],
                       "parityShards": info["parityShards"]},
                      timeout=600.0)
    if "error" in r:
        raise RuntimeError(f"rebuild: {r['error']}")
    http_json("POST", f"{rebuilder}/admin/ec/mount",
              {"volumeId": vid, "collection": collection,
               "shardIds": r["rebuiltShardIds"]}, timeout=30)
    moved = _balance_ec_volume(env, vid, collection, total)
    msg = (f"volume {vid}: rebuilt shards {r['rebuiltShardIds']} on "
           f"{rebuilder}, rebalanced {moved}")
    tele = r.get("telemetry")
    if tele:
        msg += (f" [streamed {tele['bytesFetchedTotal'] >> 20}MB "
                f"from {len(tele['bytesFetchedBySource'])} sources, "
                f"{tele['volumeGbps']} GB/s volume-rate, "
                f"slice p95 {tele['sliceP95Ms']}ms]")
    return msg


@command("ec.scrub")
def cmd_ec_scrub(env: CommandEnv, args: list[str]) -> str:
    """shell/command_ec_scrub.go:31: every holder of every EC volume
    checks its index (`-mode=index`) or also the needles whose intervals
    it holds (`-mode=local`, the default; :52)."""
    mode = _parse_flags(args).get("mode", "local")
    out = []
    for vid in _ec_volumes(env):
        for url in _ec_shard_locations(env, vid):
            r = http_json("POST", f"{url}/admin/ec/scrub",
                          {"volumeId": vid, "mode": mode}, timeout=30)
            if r.get("error"):
                out.append(f"volume {vid} @ {url}: ERROR {r['error']}")
            else:
                status = "ok" if not r["errors"] else \
                    f"{len(r['errors'])} errors, broken shards " \
                    f"{r['brokenShards']}"
                out.append(f"volume {vid} @ {url}: checked "
                           f"{r['checked']} entries, {status}")
    return "\n".join(out) if out else "no ec volumes"


def _ec_info(env: CommandEnv, vid: int) -> "dict | None":
    """The first holder's `/admin/ec/info` of an EC volume."""
    for url in _ec_shard_locations(env, vid):
        r = http_json("GET", f"{url}/admin/ec/info?volumeId={vid}",
                      timeout=30)
        if "error" not in r:
            return r
    return None


@command("ec.balance")
def cmd_ec_balance(env: CommandEnv, args: list[str]) -> str:
    """shell/command_ec_balance.go: `_balance_ec_volume` on every EC
    volume (of -collection, when given), its shard count and collection
    read off a holder's `/admin/ec/info`.  (The JAX command moves every
    volume's shards under the -collection flag's name, "" without it: a
    volume of another collection fails its first move, ROADMAP C20.)"""
    env.confirm_is_locked()
    want = _parse_flags(args).get("collection")
    out = []
    for vid in _ec_volumes(env):
        info = _ec_info(env, vid) or {}
        collection = info.get("collection", want or "")
        if want is not None and collection != want:
            continue
        total = info.get("dataShards", 10) + info.get("parityShards", 4)
        moved = _balance_ec_volume(env, vid, collection, total)
        out.append(f"volume {vid}: moved {moved} shards")
    return "\n".join(out) if out else "no ec volumes"


# --- volume placement: copy, move, balance, repair ----------------------

# a copy's lease on its source volume, renewed before each file's pull
COPY_HOLD_SECONDS = 600.0


def _copy_volume_files(env: CommandEnv, vid: int, collection: str,
                       src: str, dst: str) -> None:
    """The `.dat`, `.idx` and `.vif` (where present) of a volume from src
    to dst (CopyFile / ReceiveFile, volume_server.proto:69-101), each
    relayed a chunk at a time: the push starts at the first chunk, and
    no file is held whole here.  The source holds the volume for the
    copy (`/admin/volume/hold`), so no vacuum commits between the `.dat`
    and the `.idx` pulls (the JAX command takes no hold: a compaction
    there can give the copy the old `.dat` with the new `.idx`)."""
    token = uuid.uuid4().hex

    def hold(seconds: float) -> dict:
        return http_json("POST", f"{src}/admin/volume/hold",
                         {"volumeId": vid, "token": token,
                          "seconds": seconds}, timeout=30)
    try:
        for ext in (".dat", ".idx", ".vif"):
            _must(hold(COPY_HOLD_SECONDS), f"hold {vid} on {src} for a copy")
            _copy_volume_file(vid, collection, src, dst, ext)
    finally:
        try:
            hold(0)
        except OSError:
            pass


def _copy_volume_file(vid: int, collection: str, src: str, dst: str,
                      ext: str) -> None:
    src_status, dst_status, body = http_relay(
        f"{src}/admin/volume_file?volumeId={vid}"
        f"&collection={collection}&ext={ext}",
        "POST", f"{dst}/admin/receive_file?volumeId={vid}"
        f"&collection={collection}&ext={ext}", timeout=600)
    if src_status != 200:
        if ext == ".vif":
            return
        raise RuntimeError(f"copy {ext} from {src}: {src_status}")
    if dst_status != 200:
        raise RuntimeError(
            f"push {ext} to {dst}: {dst_status} {body[:200]!r}")


def _set_readonly(url: str, vid: int, read_only: bool) -> None:
    _must(http_json("POST", f"{url}/admin/set_readonly",
                    {"volumeId": vid, "readOnly": read_only}, timeout=30),
          f"set readonly={read_only} of {vid} on {url}")


def _move_volume(env: CommandEnv, vid: int, collection: str,
                 src: str, dst: str, delete_source: bool = True) -> None:
    """shell/command_volume_move.go: freeze, copy, mount on dst, then
    delete the source (or thaw it, for a copy)."""
    _set_readonly(src, vid, True)
    _copy_volume_files(env, vid, collection, src, dst)
    _must(http_json("POST", f"{dst}/admin/mount_volume",
                    {"volumeId": vid, "collection": collection}, timeout=30),
          f"mount on {dst}")
    if delete_source:
        _must(http_json("POST", f"{src}/admin/delete_volume",
                        {"volumeId": vid}, timeout=30),
              f"delete source on {src}")
    else:
        _set_readonly(src, vid, False)


@command("volume.balance")
def cmd_volume_balance(env: CommandEnv, args: list[str]) -> str:
    """shell/command_volume_balance.go: move volumes from the fullest
    servers to the emptiest until none holds more than ceil(volumes /
    servers)."""
    env.confirm_is_locked()
    from ..topology import iter_volume_list_volumes
    per_node: dict[str, list[dict]] = {}
    for node, v in iter_volume_list_volumes(env.volume_list()):
        per_node.setdefault(node["url"], []).append(v)
    for url in _all_node_urls(env):
        per_node.setdefault(url, [])
    if not per_node:
        return "no volume servers"
    total = sum(len(v) for v in per_node.values())
    avg = max(1, -(-total // len(per_node)))
    moved = 0
    for donor in sorted(per_node, key=lambda u: -len(per_node[u])):
        while len(per_node[donor]) > avg:
            recv = min(per_node, key=lambda u: len(per_node[u]))
            if recv == donor or len(per_node[recv]) + 1 > avg:
                break
            recv_vids = {v["id"] for v in per_node[recv]}
            movable = [v for v in per_node[donor]
                       if v["id"] not in recv_vids]
            if not movable:
                break
            v = movable[-1]
            _move_volume(env, v["id"], v.get("collection", ""), donor, recv)
            per_node[donor].remove(v)
            per_node[recv].append(v)
            moved += 1
    return f"moved {moved} volumes"


@command("volume.fix.replication")
def cmd_volume_fix_replication(env: CommandEnv, args: list[str]) -> str:
    """shell/command_volume_fix_replication.go: copy each volume with
    fewer replicas than its placement asks for to servers that lack it.
    Every holder is frozen while the files are copied (the JAX command
    copies a writable volume as it is, so its `.idx` may name records
    past the `.dat` it copied) and thawed after, the new copy too."""
    env.confirm_is_locked()
    from ..storage.replica_placement import ReplicaPlacement
    from ..topology import iter_volume_list_volumes
    locations: dict[int, list[str]] = {}
    meta: dict[int, dict] = {}
    for node, v in iter_volume_list_volumes(env.volume_list()):
        locations.setdefault(v["id"], []).append(node["url"])
        meta[v["id"]] = v
    nodes = _all_node_urls(env)
    fixed = []
    for vid, locs in sorted(locations.items()):
        v = meta[vid]
        want = ReplicaPlacement.from_byte(
            v.get("replicaPlacement", 0)).copy_count()
        missing = want - len(locs)
        if missing <= 0:
            continue
        collection = v.get("collection", "")
        writable = not v.get("readOnly", False)
        targets = [n for n in nodes if n not in locs][:missing]
        if not targets:
            continue
        for url in locs:
            _set_readonly(url, vid, True)
        try:
            for dst in targets:
                _copy_volume_files(env, vid, collection, locs[0], dst)
                _must(http_json("POST", f"{dst}/admin/mount_volume",
                                {"volumeId": vid, "collection": collection},
                                timeout=30), f"mount on {dst}")
                if not writable:
                    _set_readonly(dst, vid, True)
                fixed.append(f"{vid}->{dst}")
        finally:
            if writable:
                for url in locs:
                    _set_readonly(url, vid, False)
    return f"fixed replicas: {fixed}" if fixed else \
        "all volumes sufficiently replicated"


@command("volume.scrub")
def cmd_volume_scrub(env: CommandEnv, args: list[str]) -> str:
    """Every needle of every volume (or -volumeId) re-read and
    CRC-checked on each of its servers."""
    opts = _parse_flags(args)
    target = int(opts["volumeId"]) if "volumeId" in opts else None
    out = []
    for vid, urls in sorted(_volumes_by_id(env).items()):
        if target is not None and vid != target:
            continue
        for url in urls:
            r = http_json("POST", f"{url}/admin/scrub", {"volumeId": vid},
                          timeout=600)
            if r.get("error"):
                out.append(f"volume {vid} @ {url}: ERROR {r['error']}")
            else:
                status = "ok" if not r["errors"] else r["errors"][:3]
                out.append(f"volume {vid} @ {url}: checked "
                           f"{r['checked']}, {status}")
    return "\n".join(out) if out else "no volumes"


def _volume_meta(env: CommandEnv, vid: int) -> "dict | None":
    """A volume's /vol/list entry (the lookup gives urls only)."""
    from ..topology import iter_volume_list_volumes
    for _node, v in iter_volume_list_volumes(env.volume_list()):
        if v["id"] == vid:
            return v
    return None


@command("volume.copy")
def cmd_volume_copy(env: CommandEnv, args: list[str]) -> str:
    """shell/command_volume_copy.go: one more copy of a volume on
    -target, through `_move_volume` without the delete."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    dst = opts["target"]
    locs = env.volume_locations(vid)
    if not locs:
        return f"volume {vid} not found"
    src = opts.get("source", locs[0]["url"])
    if any(loc["url"] == dst for loc in locs):
        return f"volume {vid} already on {dst}"
    meta = _volume_meta(env, vid) or {}
    _move_volume(env, vid, meta.get("collection", ""), src, dst,
                 delete_source=False)
    return f"copied volume {vid}: {src} -> {dst}"


@command("volume.move")
def cmd_volume_move(env: CommandEnv, args: list[str]) -> str:
    """shell/command_volume_move.go: freeze, copy to -target, mount,
    delete at -source; readable at every step."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    src, dst = opts["source"], opts["target"]
    if src == dst:
        return "source and target are the same server"
    locs = env.volume_locations(vid)
    if not any(loc["url"] == src for loc in locs):
        return f"volume {vid} is not on {src}"
    collection = (_volume_meta(env, vid) or {}).get("collection", "")
    if any(loc["url"] == dst for loc in locs):
        # the target holds a replica already: drop the source's
        _must(http_json("POST", f"{src}/admin/delete_volume",
                        {"volumeId": vid, "collection": collection},
                        timeout=30), f"delete on {src}")
    else:
        _move_volume(env, vid, collection, src, dst, delete_source=True)
    return f"moved volume {vid}: {src} -> {dst}"


@command("volume.grow")
def cmd_volume_grow(env: CommandEnv, args: list[str]) -> str:
    """shell/command_volume_grow.go: the master's VolumeGrow."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    r = master_json(env.master, "POST", "/vol/grow", {
        "collection": opts.get("collection", ""),
        "replication": opts.get("replication", ""),
        "count": int(opts.get("count", 1))}, timeout=30)
    if "volumeIds" not in r:
        return f"grow failed: {r}"
    return f"grew volumes: {r['volumeIds']}"


@command("collection.list")
def cmd_collection_list(env: CommandEnv, args: list[str]) -> str:
    """shell/command_collection_list.go: each collection's distinct
    volumes."""
    from ..topology import iter_volume_list_volumes
    vols: dict[str, set] = {}
    for _node, v in iter_volume_list_volumes(env.volume_list()):
        vols.setdefault(v.get("collection", ""), set()).add(v["id"])
    return "\n".join(f"{name or '(default)'}: {len(ids)} volumes"
                     for name, ids in sorted(vols.items())) or "no volumes"


@command("collection.delete")
def cmd_collection_delete(env: CommandEnv, args: list[str]) -> str:
    """shell/command_collection_delete.go: every volume and EC volume of
    -collection on every server (the lock and -force needed)."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    name = opts.get("collection", "")
    if not name:
        return "need -collection=<name>"
    if "force" not in opts:
        return ("this deletes EVERY volume of the collection; "
                "re-run with -force")
    from ..topology import iter_volume_list_ec_shards, iter_volume_list_volumes
    vl = env.volume_list()
    deleted = []
    for node, v in list(iter_volume_list_volumes(vl)):
        if v.get("collection", "") != name:
            continue
        _must(http_json("POST", f"{node['url']}/admin/delete_volume",
                        {"volumeId": v["id"], "collection": name},
                        timeout=30), f"delete {v['id']} on {node['url']}")
        deleted.append(v["id"])
    ec_deleted = []
    for node, e in list(iter_volume_list_ec_shards(vl)):
        if e.get("collection", "") != name:
            continue
        shard_ids = [i for i in range(32) if e.get("shardBits", 0) >> i & 1]
        _must(http_json("POST", f"{node['url']}/admin/ec/delete_shards",
                        {"volumeId": e["volumeId"], "collection": name,
                         "shardIds": shard_ids}, timeout=30),
              f"delete ec {e['volumeId']} on {node['url']}")
        ec_deleted.append(e["volumeId"])
    out = f"deleted collection {name!r}: volumes {sorted(set(deleted))}"
    if ec_deleted:
        out += f", ec volumes {sorted(set(ec_deleted))}"
    return out


@command("volume.merge")
def cmd_volume_merge(env: CommandEnv, args: list[str]) -> str:
    """shell/command_volume_merge.go (-volumeId=N): diverged replicas
    merged in AppendAtNs order on the first, which then replaces the
    others: every replica frozen, the merge, the others replaced, the
    writable state restored."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    if "volumeId" not in opts:
        return "usage: volume.merge -volumeId=N"
    vid = int(opts["volumeId"])
    urls = _volumes_by_id(env).get(vid)
    if not urls:
        raise RuntimeError(f"volume {vid} not found")
    meta = _volume_meta(env, vid) or {}
    collection = meta.get("collection", "")
    was_writable = not meta.get("readOnly", False)
    primary, others = urls[0], urls[1:]
    for url in urls:
        _set_readonly(url, vid, True)
    try:
        r = _must(http_json(
            "POST", f"{primary}/admin/volume/merge",
            {"volumeId": vid, "collection": collection, "peers": others},
            timeout=3600), f"merge on {primary}")
        for url in others:
            _must(http_json("POST", f"{url}/admin/delete_volume",
                            {"volumeId": vid}, timeout=30),
                  f"drop stale replica on {url}")
            _copy_volume_files(env, vid, collection, primary, url)
            _must(http_json("POST", f"{url}/admin/mount_volume",
                            {"volumeId": vid, "collection": collection},
                            timeout=30), f"mount merged on {url}")
            _set_readonly(url, vid, True)
    finally:
        if was_writable:
            for url in urls:
                try:
                    http_json("POST", f"{url}/admin/set_readonly",
                              {"volumeId": vid, "readOnly": False},
                              timeout=30)
                except OSError:
                    pass
    return (f"volume {vid}: merged {len(urls)} replicas "
            f"({r['mergedNeedles']} live needles, {r['datBytes']} bytes) "
            f"on {primary}; replaced {len(others)} peer copies")


# --- the observability plane's views (profiling.py, server/debug.py) ----
#
# cluster.top samples every node's /metrics twice and renders the delta;
# cluster.slow merges the flight recorders' rings by trace id;
# cluster.profile arms the sampling profiler everywhere and merges the
# folded stacks.  A node that does not answer is noted and skipped.

def _cluster_debug_nodes(env: CommandEnv) -> list[str]:
    """Every node that may hold spans of a trace: master(s), every
    volume server, and the filer when the shell knows one."""
    r = master_json(env.master, "GET", "/cluster/status", timeout=30)
    nodes = env.master_seeds()
    nodes += [p for p in r.get("peers", []) if p not in nodes]
    nodes += r.get("dataNodes", [])
    if env.filer and env.filer not in nodes:
        nodes.append(env.filer)
    return nodes


def render_trace(spans: "list[dict]") -> str:
    """Time-aligned tree: children indent under their parent, each
    line shows offset from the trace's first span, duration, role@node
    and attrs — one request id becomes a cross-node flame view."""
    if not spans:
        return "no spans found (buffer rolled over, or wrong id?)"
    t0 = min(s["start"] for s in spans)
    by_parent: dict[str, list] = {}
    ids = {s["spanId"] for s in spans}
    for s in spans:
        parent = s.get("parentId") or ""
        if parent not in ids:
            parent = ""          # orphan (parent not collected): root
        by_parent.setdefault(parent, []).append(s)
    lines = [f"trace {spans[0]['traceId']}: {len(spans)} span(s), "
             f"{len({s.get('role') or '?' for s in spans})} role(s)"]

    def walk(parent: str, depth: int) -> None:
        for s in sorted(by_parent.get(parent, []),
                        key=lambda x: x["start"]):
            off = (s["start"] - t0) * 1e3
            attrs = s.get("attrs") or {}
            extra = " ".join(f"{k}={v}" for k, v in attrs.items())
            mark = " ERROR" if s.get("error") else ""
            lines.append(
                f"{'  ' * depth}+{off:8.1f}ms {s['name']}  "
                f"[{s.get('role') or '?'}@{s.get('node', '?')}] "
                f"{s['durationMs']}ms{mark}"
                + (f"  {extra}" if extra else ""))
            walk(s["spanId"], depth + 1)

    walk("", 0)
    return "\n".join(lines)


def collect_trace(env: CommandEnv, request_id: str,
                  extra_nodes: "list[str] | None" = None) -> "list[dict]":
    """Every node's `/debug/traces?request_id=` merged (deduped by span
    id; a node that does not answer adds nothing).  The fan-out runs
    under a fresh request id, so it is not traced into the trace it
    reads."""
    import secrets

    from .. import tracing
    token = tracing.set_request_id(secrets.token_hex(8))
    try:
        nodes = _cluster_debug_nodes(env)
    finally:
        tracing.reset_request_id(token)
    for n in extra_nodes or []:
        if n not in nodes:
            nodes.append(n)

    def fetch(url: str) -> list:
        try:
            r = http_json("GET", f"{url}/debug/traces?request_id="
                                 f"{request_id}", timeout=10)
        except OSError:
            return []
        spans = r.get("spans", []) if isinstance(r, dict) else []
        for sp in spans:
            sp["node"] = url
        return spans

    merged: dict[str, dict] = {}
    with ThreadPoolExecutor(max_workers=min(8, len(nodes))) as ex:
        for spans in ex.map(fetch, nodes):
            for sp in spans:
                merged.setdefault(sp["spanId"], sp)
    return sorted(merged.values(), key=lambda sp: sp["start"])


def collect_peer_health(env: CommandEnv,
                        extra_nodes: "list[str] | None" = None
                        ) -> "list[str]":
    """Every node's `/debug/health` (the retry policy's breakers), one
    line per breaker that is not closed or has tripped."""
    try:
        nodes = _cluster_debug_nodes(env)
    except OSError:
        nodes = env.master_seeds()
    for n in extra_nodes or []:
        if n not in nodes:
            nodes.append(n)

    def fetch(url: str):
        # mid-incident a wedged node must not stall the command
        try:
            r = http_json("GET", f"{url}/debug/health", timeout=3)
        except OSError:
            return url, None
        return url, r if isinstance(r, dict) else None

    lines: list[str] = []
    with ThreadPoolExecutor(max_workers=min(8, len(nodes))) as ex:
        for url, r in ex.map(fetch, nodes):
            if not r:
                continue
            for peer, h in (r.get("peers") or {}).items():
                if h.get("state") == "closed" and not h.get("trips"):
                    continue
                lines.append(
                    f"  {url}: peer {peer} {h.get('state')} "
                    f"(consecutive failures "
                    f"{h.get('consecutiveFailures', 0)}, trips "
                    f"{h.get('trips', 0)})"
                    + (f" last: {h['lastError']}"
                       if h.get("lastError") else ""))
    return lines


@command("trace.show")
def cmd_trace_show(env: CommandEnv, args: list[str]) -> str:
    """One request's spans from every node's `/debug/traces`, as a
    time-aligned tree; `-nodes=` adds debug planes the topology does not
    know (the admin, which holds the workers' job spans).  A trace with
    retry or error spans, or `-health`, gets the peer health section."""
    rids = [a for a in args if not a.startswith("-")]
    opts = _parse_flags(args)
    extra = [n.strip() for n in opts.get("nodes", "").split(",")
             if n.strip()]
    if not rids:
        return "usage: trace.show <request_id> [-nodes=host:port,...]" \
               " [-health]"
    traces = [collect_trace(env, rid, extra_nodes=extra) for rid in rids]
    out = [render_trace(spans) for spans in traces]
    if "health" in opts or any(
            str(sp.get("name", "")).startswith("retry.") or sp.get("error")
            for spans in traces for sp in spans):
        health = collect_peer_health(env, extra_nodes=extra)
        if health:
            out.append("peer health (non-closed breakers):")
            out.extend(health)
        else:
            out.append("peer health: all breakers closed")
    return "\n".join(out)


@command("qos.status")
def cmd_qos_status(env: CommandEnv, args: list[str]) -> str:
    """Every node's `/debug/qos`: admission, the tenants' limits and
    in-flight bytes, and the EC throttle's pace and p99."""
    out = []
    for url in _top_nodes(env, _parse_flags(args)):
        try:
            r = http_json("GET", f"{url}/debug/qos", timeout=3)
        except OSError:
            out.append(f"{url}: unreachable")
            continue
        if not isinstance(r, dict) or "config" not in r:
            out.append(f"{url}: {r.get('error', 'no qos plane')}"
                       if isinstance(r, dict) else f"{url}: ?")
            continue
        cfg = r["config"]
        th = r.get("throttle", {})
        tenants = cfg.get("tenants", {})
        out.append(
            f"{url}: enabled={cfg.get('enabled')} "
            f"tenants={len(tenants)} "
            f"slo_p99={cfg.get('sloP99Ms', 0):.0f}ms "
            f"pace={th.get('paceMs', 0):.0f}ms "
            f"p99={th.get('lastP99Ms', 0):.1f}ms")
        for t, lim in sorted(tenants.items()):
            inflight = r.get("inflightBytes", {}).get(t, 0)
            out.append(f"  {t}: rps={lim.get('rps')} "
                       f"burst={lim.get('burst')} "
                       f"inflight_mb={lim.get('inflightMb')} "
                       f"(in flight now: {inflight}B)")
    return "\n".join(out)


@command("qos.set")
def cmd_qos_set(env: CommandEnv, args: list[str]) -> str:
    """One tenant's limits (`*` the default) pushed to every node's
    `/debug/qos`, or `-sloP99Ms=N` for the EC throttle, or `-clear`."""
    opts = _parse_flags(args)
    body: dict = {}
    if "clear" in opts:
        body["clear"] = True
    if "tenant" in opts:
        body["tenant"] = opts["tenant"]
        for k in ("rps", "burst", "inflightMb"):
            if k in opts:
                body[k] = float(opts[k])
    if "sloP99Ms" in opts:
        body["sloP99Ms"] = float(opts["sloP99Ms"])
    if not body:
        return ("usage: qos.set -tenant=<access-key|*> -rps=N "
                "[-burst=N] [-inflightMb=N] | -sloP99Ms=N | -clear")
    try:
        nodes = _cluster_debug_nodes(env)
    except OSError:
        nodes = env.master_seeds()
    ok, failed = 0, []
    for url in nodes:
        try:
            r = http_json("POST", f"{url}/debug/qos", body, timeout=5)
            if isinstance(r, dict) and "error" in r:
                failed.append(f"{url}: {r['error']}")
            else:
                ok += 1
        except OSError as e:
            failed.append(f"{url}: {e}")
    return "\n".join([f"qos updated on {ok}/{len(nodes)} nodes", *failed])


_ROLE_NAMESPACES = ("master", "volume_server", "filer", "s3")


def _top_nodes(env: CommandEnv, opts: dict) -> "list[str]":
    """Fan-out target list: the topology's debug planes plus any
    `-nodes=` extras (a standalone S3 gateway, the admin server)."""
    try:
        nodes = _cluster_debug_nodes(env)
    except OSError:
        nodes = env.master_seeds()
    for n in (opts.get("nodes", "") or "").split(","):
        n = n.strip()
        if n and n not in nodes:
            nodes.append(n)
    return nodes


def _fetch_metrics(url: str) -> "dict[str, list] | None":
    """One node's /metrics, parsed (profiling.parse_prom_text);
    None when unreachable."""
    from .. import profiling
    try:
        st, body, _ = http_bytes("GET", f"{url}/metrics", timeout=3)
    except OSError:
        return None
    if st >= 300:
        return None
    return profiling.parse_prom_text(body.decode("utf-8", "replace"))


def _node_role(metrics: "dict[str, list]") -> str:
    """Which role registry this listener renders (each role's Metrics
    namespace prefixes its request_seconds histogram)."""
    for ns in _ROLE_NAMESPACES:
        if f"{ns}_request_seconds_count" in metrics:
            return ns
    return "?"


def _gauge(metrics: "dict[str, list]", name: str,
           match: "dict | None" = None) -> "float | None":
    match = match or {}
    for labels, value in metrics.get(name, []):
        if all(labels.get(k) == v for k, v in match.items()):
            return value
    return None


def _counter_sum(metrics: "dict[str, list]", name: str,
                 match: "dict | None" = None) -> float:
    match = match or {}
    return sum(v for l, v in metrics.get(name, [])
               if all(l.get(k) == mv for k, mv in match.items()))


def _read_cache_report(before: "dict[str, list]",
                       after: "dict[str, list]") -> str:
    """Per-cache hot-read-cache view over the sampling window: hit
    ratio + bytes served from cache (util/chunk_cache meters on the
    shared registry).  Empty when no instrumented cache was touched."""
    caches = {l.get("cache", "") for name in
              ("seaweedfs_tpu_read_cache_hits_total",
               "seaweedfs_tpu_read_cache_misses_total")
              for l, _v in after.get(name, [])}
    parts = []
    for c in sorted(caches):
        hits = _counter_sum(
            after, "seaweedfs_tpu_read_cache_hits_total",
            {"cache": c}) - _counter_sum(
            before, "seaweedfs_tpu_read_cache_hits_total",
            {"cache": c})
        misses = _counter_sum(
            after, "seaweedfs_tpu_read_cache_misses_total",
            {"cache": c}) - _counter_sum(
            before, "seaweedfs_tpu_read_cache_misses_total",
            {"cache": c})
        if hits + misses <= 0:
            continue
        served = _counter_sum(
            after, "seaweedfs_tpu_read_cache_bytes_served_total",
            {"cache": c}) - _counter_sum(
            before, "seaweedfs_tpu_read_cache_bytes_served_total",
            {"cache": c})
        parts.append(f"{c} {hits / (hits + misses) * 100:.0f}% "
                     f"({served / (1 << 20):.1f}MB served)")
    if not parts:
        return ""
    return "read-cache: " + "  ".join(parts)


def _stage_report(before: "dict[str, list]", after: "dict[str, list]",
                  ns: str) -> str:
    """Per-stage share of write-path wall time over the sampling
    window, from the write_stage_seconds decomposition (profiling.py),
    with each stage's cpu/wall mean beside it (write_stage_cpu_seconds
    ): `upload 45% cpu=0.12/1.30ms` reads "45% of write
    wall, of which each call burned 0.12ms CPU out of 1.30ms wall —
    the other 1.18ms was GIL/lock/IO wait".  Empty string when no
    write landed in the window."""
    from .. import profiling
    name = f"{ns}_write_stage_seconds"
    cpu_name = f"{ns}_write_stage_cpu_seconds"
    stages: dict[str, tuple] = {}
    total = 0.0
    seen = {l.get("stage", "") for l, _v in
            after.get(f"{name}_count", [])}
    for stage in sorted(seen):
        h = profiling.histogram_delta(
            profiling.prom_histogram(after, name, {"stage": stage}),
            profiling.prom_histogram(before, name, {"stage": stage}))
        if not h or h["count"] <= 0:
            continue
        c = profiling.histogram_delta(
            profiling.prom_histogram(after, cpu_name,
                                     {"stage": stage}),
            profiling.prom_histogram(before, cpu_name,
                                     {"stage": stage}))
        cpu_mean = (c["sum"] / c["count"]) if c and c["count"] else None
        if stage == "total":
            total = h["sum"]
        else:
            stages[stage] = (h["sum"], h["sum"] / h["count"], cpu_mean)
    if not stages or total <= 0:
        return ""
    parts = []
    for s, (secs, wall_mean, cpu_mean) in sorted(
            stages.items(), key=lambda kv: -kv[1][0]):
        p = f"{s} {secs / total * 100.0:.0f}%"
        if cpu_mean is not None:
            p += (f" cpu={cpu_mean * 1e3:.2f}/"
                  f"{wall_mean * 1e3:.2f}ms")
        parts.append(p)
    return "write stages: " + " ".join(parts)


def _cpu_report(before: "dict[str, list]", after: "dict[str, list]",
                ns: str, req: "dict | None", window: float) -> str:
    """The node's cost-attribution line: mean CPU vs wall
    per request from request_cpu_seconds/request_seconds, the
    scheduler-probe gil_wait_ratio, and the /proc process-TREE CPU
    burn + RSS (pre-fork workers and native plane children included).
    Empty when the window saw no requests and no tree gauges."""
    from .. import profiling
    parts = []
    c = profiling.histogram_delta(
        profiling.prom_histogram(after, f"{ns}_request_cpu_seconds"),
        profiling.prom_histogram(before, f"{ns}_request_cpu_seconds"))
    if c and c["count"] > 0 and req and req["count"] > 0:
        cpu_ms = c["sum"] / c["count"] * 1e3
        wall_ms = req["sum"] / req["count"] * 1e3
        if wall_ms > 0:
            parts.append(
                f"{cpu_ms:.2f}ms cpu of {wall_ms:.2f}ms wall/req "
                f"(wait {max(1.0 - cpu_ms / wall_ms, 0.0) * 100:.0f}%)")
    gil = _gauge(after, "seaweedfs_tpu_gil_wait_ratio")
    if gil is not None:
        parts.append(f"gil-wait={gil * 100:.0f}%")
    tree_a = _gauge(after, "seaweedfs_tpu_process_tree_cpu_seconds")
    tree_b = _gauge(before, "seaweedfs_tpu_process_tree_cpu_seconds")
    if tree_a is not None and tree_b is not None and window > 0:
        burn = max(tree_a - tree_b, 0.0) / window
        procs = _gauge(after, "seaweedfs_tpu_process_tree_procs") or 1
        rss = _gauge(after, "seaweedfs_tpu_process_tree_rss_bytes") \
            or 0.0
        parts.append(f"tree={burn:.2f} cores/{procs:.0f} procs "
                     f"rss={rss / (1 << 20):.0f}MB")
    if not parts:
        return ""
    return "cpu: " + "  ".join(parts)


def _group_commit_report(before: "dict[str, list]",
                         after: "dict[str, list]") -> str:
    """Per-site group-commit view over the sampling window: mean
    batch (writers covered per shared durability barrier) and
    barrier-wait p99, from the util/group_commit metrics on the
    shared process registry.  Empty when no barrier fired."""
    from .. import profiling
    batch = "seaweedfs_tpu_group_commit_batch_size"
    wait = "seaweedfs_tpu_group_commit_wait_seconds"
    sites = {l.get("site", "") for l, _v in
             after.get(f"{batch}_count", [])}
    parts = []
    for site in sorted(sites):
        h = profiling.histogram_delta(
            profiling.prom_histogram(after, batch, {"site": site}),
            profiling.prom_histogram(before, batch, {"site": site}))
        if not h or h["count"] <= 0:
            continue
        w = profiling.histogram_delta(
            profiling.prom_histogram(after, wait, {"site": site}),
            profiling.prom_histogram(before, wait, {"site": site}))
        p99 = profiling.histogram_quantile(w, 0.99) if w else 0.0
        parts.append(f"{site} batch={h['sum'] / h['count']:.1f} "
                     f"wait-p99={p99 * 1e3:.2f}ms")
    if not parts:
        return ""
    return "group-commit: " + "  ".join(parts)


def _native_plane_report(before: "dict[str, list]",
                         after: "dict[str, list]") -> str:
    """Native read/write/meta plane view over the sampling window:
    acks and fallbacks per plane plus the native ack-latency p99 (C++
    atomics rendered by the volume server's and filer's /metrics).
    Empty when the node runs no native plane."""
    from .. import profiling
    parts = []
    wname = "volume_server_write_plane_ack_seconds"
    wr = _counter_sum(
        after, "volume_server_write_plane_requests_total") - \
        _counter_sum(before, "volume_server_write_plane_requests_total")
    wf = _counter_sum(
        after, "volume_server_write_plane_fallbacks_total") - \
        _counter_sum(before,
                     "volume_server_write_plane_fallbacks_total")
    if f"{wname}_count" in after:
        h = profiling.histogram_delta(
            profiling.prom_histogram(after, wname),
            profiling.prom_histogram(before, wname))
        p99 = profiling.histogram_quantile(h, 0.99) \
            if h and h.get("count") else 0.0
        parts.append(f"write {wr:.0f} acked/{wf:.0f} fallback"
                     f" ack-p99={p99 * 1e3:.2f}ms")
    rr = _counter_sum(
        after, "volume_server_read_plane_requests_total") - \
        _counter_sum(before,
                     "volume_server_read_plane_requests_total")
    rf = _counter_sum(
        after, "volume_server_read_plane_fallbacks_total") - \
        _counter_sum(before,
                     "volume_server_read_plane_fallbacks_total")
    if "volume_server_read_plane_requests_total" in after:
        parts.append(f"read {rr:.0f} served/{rf:.0f} fallback")
    # the filer's native READ plane: warm GETs served with
    # zero Python, coherence misses surfaced beside the fallbacks
    fr = _counter_sum(
        after, "filer_read_plane_native_requests_total") - \
        _counter_sum(before, "filer_read_plane_native_requests_total")
    ff = _counter_sum(
        after, "filer_read_plane_native_fallbacks_total") - \
        _counter_sum(before,
                     "filer_read_plane_native_fallbacks_total")
    if "filer_read_plane_native_requests_total" in after:
        fstale = _counter_sum(
            after, "filer_read_plane_native_stale_misses_total") - \
            _counter_sum(before,
                         "filer_read_plane_native_stale_misses_total")
        seg = f"filer-read {fr:.0f} served/{ff:.0f} fallback"
        if fstale > 0:
            seg += f" stale={fstale:.0f}"
        parts.append(seg)
    # the filer's native META plane: creates acked with
    # zero Python, plus its ack-latency p99 and mean WAL batch
    mname = "filer_meta_plane_native_ack_seconds"
    mr = _counter_sum(
        after, "filer_meta_plane_native_requests_total") - \
        _counter_sum(before, "filer_meta_plane_native_requests_total")
    mf = _counter_sum(
        after, "filer_meta_plane_native_fallbacks_total") - \
        _counter_sum(before,
                     "filer_meta_plane_native_fallbacks_total")
    if f"{mname}_count" in after:
        h = profiling.histogram_delta(
            profiling.prom_histogram(after, mname),
            profiling.prom_histogram(before, mname))
        p99 = profiling.histogram_quantile(h, 0.99) \
            if h and h.get("count") else 0.0
        batches = _counter_sum(
            after, "filer_meta_plane_native_wal_batches_total") - \
            _counter_sum(before,
                         "filer_meta_plane_native_wal_batches_total")
        lines = _counter_sum(
            after, "filer_meta_plane_native_wal_lines_total") - \
            _counter_sum(before,
                         "filer_meta_plane_native_wal_lines_total")
        seg = (f"meta {mr:.0f} acked/{mf:.0f} fallback"
               f" ack-p99={p99 * 1e3:.2f}ms")
        if batches > 0:
            seg += f" wal-batch={lines / batches:.1f}"
        parts.append(seg)
    # per-stage tails from the drained flight records: the
    # plane_stage_seconds family is fed by the Python drainer, so each
    # plane's stage decomposition shows up windowed, like every other
    # cluster.top figure
    sname = "seaweedfs_tpu_plane_stage_seconds"
    planes = sorted({l.get("plane", "") for l, _v in
                     after.get(f"{sname}_count", []) if l.get("plane")})
    from ..server.filer_read_plane_native import (
        RECORD_STAGES as _FILER_READ_STAGES)
    from ..server.meta_plane_native import (
        RECORD_STAGES as _META_STAGES)
    from ..server.read_plane import RECORD_STAGES as _READ_STAGES
    from ..server.write_plane import RECORD_STAGES as _WRITE_STAGES
    stage_order = {"meta": _META_STAGES, "write": _WRITE_STAGES,
                   "read": _READ_STAGES,
                   "filer_read": _FILER_READ_STAGES}
    for plane in planes:
        segs = []
        for stg in stage_order.get(plane, ()):
            h = profiling.histogram_delta(
                profiling.prom_histogram(
                    after, sname, {"plane": plane, "stage": stg}),
                profiling.prom_histogram(
                    before, sname, {"plane": plane, "stage": stg}))
            if h and h.get("count"):
                p99 = profiling.histogram_quantile(h, 0.99)
                segs.append(f"{stg}-p99={p99 * 1e3:.2f}ms")
        dropped = _counter_sum(
            after, "seaweedfs_tpu_plane_ring_dropped_total",
            {"plane": plane}) - _counter_sum(
            before, "seaweedfs_tpu_plane_ring_dropped_total",
            {"plane": plane})
        if dropped > 0:
            segs.append(f"ring-dropped={dropped:.0f}")
        if segs:
            parts.append(f"{plane}-stages " + " ".join(segs))
    if not parts:
        return ""
    return "native-planes: " + "  ".join(parts)


def _deadline_report(before: "dict[str, list]",
                     after: "dict[str, list]") -> str:
    """Deadline-plane view over the sampling window: budgets refused
    (per fail-fast site) and hedged replica reads issued/won
    (util/deadline + util/hedge meter on the shared registry).  Empty
    when the window saw neither — the common healthy state."""
    exceeded = _counter_sum(
        after, "seaweedfs_tpu_deadline_exceeded_total") - \
        _counter_sum(before, "seaweedfs_tpu_deadline_exceeded_total")
    issued = _counter_sum(
        after, "seaweedfs_tpu_hedges_issued_total") - \
        _counter_sum(before, "seaweedfs_tpu_hedges_issued_total")
    won = _counter_sum(
        after, "seaweedfs_tpu_hedges_won_total") - \
        _counter_sum(before, "seaweedfs_tpu_hedges_won_total")
    parts = []
    if exceeded > 0:
        sites = {l.get("site", "") for l, _v in after.get(
            "seaweedfs_tpu_deadline_exceeded_total", [])}
        worst = []
        for s in sorted(sites):
            d = _counter_sum(
                after, "seaweedfs_tpu_deadline_exceeded_total",
                {"site": s}) - _counter_sum(
                before, "seaweedfs_tpu_deadline_exceeded_total",
                {"site": s})
            if d > 0:
                worst.append((d, s))
        worst.sort(reverse=True)
        top = " ".join(f"{s}={d:.0f}" for d, s in worst[:3])
        parts.append(f"exceeded={exceeded:.0f} ({top})")
    if issued > 0:
        parts.append(f"hedges={issued:.0f} issued/{won:.0f} won")
    if not parts:
        return ""
    return "deadline: " + "  ".join(parts)


@command("cluster.top")
def cmd_cluster_top(env: CommandEnv, args: list[str]) -> str:
    """Live one-screen cluster view: every node's /metrics sampled
    twice `-interval=N` seconds apart (default 2), the delta rendered
    as per-role req/s, windowed p99, in-flight requests, pooled-client
    connection reuse, breaker state, device telemetry where the
    node has touched the card, the write-path stage decomposition and
    group-commit batching (mean batch size, barrier-wait p99) when
    writes landed in the window, and the top profiler stacks on any
    node whose sampler is armed.  The operator's answer to "what is
    this cluster doing RIGHT NOW"."""
    from .. import profiling
    opts = _parse_flags(args)
    try:
        window = max(0.2, float(opts.get("interval", 2.0)))
    except ValueError:
        return "bad -interval"
    nodes = _top_nodes(env, opts)

    with ThreadPoolExecutor(max_workers=min(8, len(nodes))) as ex:
        before = dict(zip(nodes, ex.map(_fetch_metrics, nodes)))
        time.sleep(window)
        after = dict(zip(nodes, ex.map(_fetch_metrics, nodes)))

    out = [f"cluster.top — {len(nodes)} nodes, "
           f"{window:.1f}s window"]
    for url in nodes:
        b, a = before.get(url), after.get(url)
        if a is None:
            out.append(f"{url}: unreachable")
            continue
        if b is None:
            # no baseline sample: rendering cumulative-since-boot
            # counters as this window's delta would show a day-old
            # node at absurd req/s
            out.append(f"{url}: no baseline sample this window")
            continue
        try:
            out.extend(_render_node_top(url, b, a, window))
        except Exception as e:  # noqa: BLE001 — one node's partial or
            # malformed mid-interval scrape must cost that node a
            # note, never the whole cluster view
            out.append(f"{url}: render failed: {e}")
    return "\n".join(out)


def _render_node_top(url: str, b: "dict[str, list]",
                     a: "dict[str, list]",
                     window: float) -> "list[str]":
    """One node's cluster.top block, split out so the caller can
    contain a render failure (a node restarting mid-interval hands
    back truncated metrics; a role skew hands back unexpected label
    shapes) to that node's line."""
    from .. import profiling
    out: list[str] = []
    ns = _node_role(a)
    req = profiling.histogram_delta(
        profiling.prom_histogram(a, f"{ns}_request_seconds"),
        profiling.prom_histogram(b, f"{ns}_request_seconds"))
    rate = (req["count"] / window) if req else 0.0
    p99 = profiling.histogram_quantile(req, 0.99) if req else 0.0
    inflight = _gauge(a, f"{ns}_requests_in_flight") or 0
    line = (f"{url} [{ns}] {rate:7.1f} req/s  "
            f"p99={p99 * 1e3:7.1f}ms  in-flight={inflight:.0f}")
    reused = _counter_sum(
        a, "seaweedfs_tpu_pool_connections_reused_total")
    opened = _counter_sum(
        a, "seaweedfs_tpu_pool_connections_opened_total")
    if reused + opened > 0:
        line += (f"  pool-reuse={reused / (reused + opened) * 100:.0f}%"
                 f" ({opened:.0f} dials)")
    open_breakers = sum(
        1 for _l, v in a.get("seaweedfs_tpu_peer_breaker_state", [])
        if v != 0)
    if open_breakers:
        line += f"  breakers:{open_breakers} non-closed"
    out.append(line)
    kern = _gauge(a, "seaweedfs_tpu_device_kernel_last_ms",
                  {"kernel": "gf_apply_matrix"})
    if kern is not None:
        h2d = _gauge(a, "seaweedfs_tpu_device_h2d_gbps") or 0.0
        d2h = _gauge(a, "seaweedfs_tpu_device_d2h_gbps") or 0.0
        line = (f"  device: kernel={kern:.2f}ms "
                f"h2d={h2d:.2f}GB/s d2h={d2h:.2f}GB/s")
        # windowed staging figures (ops.staging): window count
        # since the previous sample + how overlapped the last
        # launch's h2d/d2h planes actually ran
        ov = _gauge(a, "seaweedfs_tpu_device_h2d_overlap_fraction",
                    {"op": "encode"})
        if ov is None:  # rebuild-only workload stages too
            ov = _gauge(a,
                        "seaweedfs_tpu_device_h2d_overlap_fraction",
                        {"op": "rebuild"})
        wins = _counter_sum(
            a, "seaweedfs_tpu_device_staged_windows_total") - \
            _counter_sum(
                b, "seaweedfs_tpu_device_staged_windows_total")
        if ov is not None:
            line += f"  overlap={ov * 100:.0f}%"
        if wins > 0:
            line += f"  windows={wins:.0f}"
        out.append(line)
    cpu = _cpu_report(b, a, ns, req, window)
    if cpu:
        out.append("  " + cpu)
    cache_line = _read_cache_report(b, a)
    degraded = _counter_sum(
        a, "seaweedfs_tpu_ec_degraded_reads_total") - \
        _counter_sum(b, "seaweedfs_tpu_ec_degraded_reads_total")
    if degraded > 0:
        cache_line += ("  " if cache_line else "") + \
            f"degraded-reads={degraded:.0f}"
    if cache_line:
        out.append("  " + cache_line)
    stages = _stage_report(b, a, ns)
    if stages:
        out.append("  " + stages)
    planes = _native_plane_report(b, a)
    if planes:
        out.append("  " + planes)
    gc = _group_commit_report(b, a)
    if gc:
        out.append("  " + gc)
    dl = _deadline_report(b, a)
    if dl:
        out.append("  " + dl)
    try:
        prof = http_json("GET", f"{url}/debug/pprof?top=3",
                         timeout=3)
    except OSError:
        prof = None
    if isinstance(prof, dict) and prof.get("stacks"):
        total = max(1, prof["stacks"])
        for stack, n in sorted(prof.get("folded", {}).items(),
                               key=lambda kv: -kv[1]):
            leaf = stack.rsplit(";", 2)[-2:]
            out.append(f"  prof {n / total * 100:4.1f}% "
                       f"{';'.join(leaf)}")
    return out


def _render_slow_hop(url: str, rec: dict) -> "list[str]":
    """One flight record as an indented hop block: the wall/cpu/wait
    split, the deadline budget+verdict, the stage decomposition
    (wall/cpu per stage) and the hedge/QoS/plane flight notes."""
    wall = rec.get("wallMs", 0.0)
    cpu = rec.get("cpuMs")     # absent = request didn't draw the
    # CPU-attribution sample (SEAWEEDFS_TPU_CPU_SAMPLE): wall only,
    # never a fake 0ms cpu
    head = (f"  {rec.get('role', '?')}@{url}: "
            f"{rec.get('method', '?')} {rec.get('path', '?')} "
            f"status={rec.get('status', 0)}")
    if wall > 0 and cpu is not None:
        wait = rec.get("waitMs", max(wall - cpu, 0.0))
        line = (f"{head} {wall:.1f}ms wall / {cpu:.2f}ms cpu "
                f"(wait {wait / wall * 100:.0f}%)")
    elif wall > 0:
        line = f"{head} {wall:.1f}ms wall (cpu unsampled)"
    else:
        line = head
    dl = rec.get("deadline")
    if dl:
        line += (f"  deadline={dl.get('budgetMs', 0)}ms"
                 f"->{dl.get('remainingMs', 0)}ms left")
    if rec.get("verdict") not in (None, "slow"):
        line += f"  verdict={rec['verdict']}"
    out = [line]
    stages = (rec.get("stages") or {}).get("stages") or {}
    if stages:
        with_cpu = any("cpuMs" in d for d in stages.values())
        parts = [(f"{s} {d.get('wallMs', 0):.1f}/"
                  f"{d.get('cpuMs', 0):.2f}ms" if "cpuMs" in d else
                  f"{s} {d.get('wallMs', 0):.1f}ms")
                 for s, d in sorted(stages.items(),
                                    key=lambda kv:
                                    -kv[1].get("wallMs", 0))]
        out.append(("    stages (wall/cpu): " if with_cpu else
                    "    stages (wall): ") + " ".join(parts))
    notes = dict(rec.get("notes") or {})
    notes.update((rec.get("stages") or {}).get("notes") or {})
    if notes:
        out.append("    notes: " + " ".join(
            f"{k}={json.dumps(v, separators=(',', ':'))}"
            if isinstance(v, (dict, list)) else f"{k}={v}"
            for k, v in sorted(notes.items())))
    return out


@command("cluster.slow")
def cmd_cluster_slow(env: CommandEnv, args: list[str]) -> str:
    """The cluster's tail, after the fact: every node's flight
    recorder ring (/debug/slow, profiling.FlightRecorder) fanned out,
    merged by trace id, and rendered as the top-N slowest END-TO-END
    requests — one block per request with each hop's wall/cpu/wait
    split, stage decomposition, deadline budget+verdict and
    hedge/QoS/native-plane notes, then the merged cross-role span
    tree, time-aligned like trace.show.  `-top=N` blocks (default 5),
    `-verdict=slow|error|deadline|shed` filters on any hop's verdict,
    `-nodes=host:port,...` adds listeners the topology doesn't know,
    `-clear` empties every ring instead (chaos runs reset between
    scenarios).  A node whose scrape fails mid-fan-out is noted and
    skipped — mid-incident is exactly when one wedged node must not
    take the whole view down."""
    opts = _parse_flags(args)
    try:
        top = max(1, int(opts.get("top", 5)))
    except ValueError:
        return "bad -top"
    want = opts.get("verdict", "")
    nodes = _top_nodes(env, opts)

    if "clear" in opts:
        def clear(url: str) -> "tuple[str, bool]":
            try:
                r = http_json("POST", f"{url}/debug/slow",
                              {"clear": True}, timeout=5)
                return url, isinstance(r, dict) and "error" not in r
            except OSError:
                return url, False
        with ThreadPoolExecutor(max_workers=min(8, len(nodes))) as ex:
            results = dict(ex.map(clear, nodes))
        ok = sum(1 for v in results.values() if v)
        out = [f"cluster.slow — cleared {ok}/{len(nodes)} rings"]
        out.extend(f"  {u}: unreachable" for u, v in results.items()
                   if not v)
        return "\n".join(out)

    def fetch(url: str) -> "tuple[str, dict | None]":
        try:
            r = http_json("GET", f"{url}/debug/slow", timeout=5)
        except OSError:
            return url, None
        return url, r if isinstance(r, dict) and "records" in r \
            else None

    with ThreadPoolExecutor(max_workers=min(8, len(nodes))) as ex:
        snaps = dict(ex.map(fetch, nodes))

    # merge by trace id: the same end-to-end request appears in each
    # hop's ring under one id; records with no id stand alone
    groups: "dict[str, list[tuple[str, dict]]]" = {}
    captured = 0
    skipped: list[str] = []
    loose = 0
    seen_recs: "set[str]" = set()
    for url in nodes:
        snap = snaps.get(url)
        if snap is None:
            skipped.append(f"  {url}: scrape failed, skipped")
            continue
        for rec in snap.get("records", []):
            if not isinstance(rec, dict):
                continue
            # one recorder answering under two addresses (a node
            # listed both by the topology and -nodes=, or an
            # in-process multi-role rig sharing one ring) must not
            # double every hop of every request it captured
            fp = json.dumps(rec, sort_keys=True,
                            separators=(",", ":"))
            if fp in seen_recs:
                continue
            seen_recs.add(fp)
            captured += 1
            tid = rec.get("traceId") or ""
            if not tid:
                loose += 1
                tid = f"(no-trace-{loose})"
            groups.setdefault(tid, []).append((url, rec))
    if want:
        groups = {tid: hops for tid, hops in groups.items()
                  if any(r.get("verdict") == want for _u, r in hops)}

    # end-to-end wall = the slowest hop's wall (the edge's record
    # covers its downstream hops); rank the groups by it
    def group_wall(hops: "list[tuple[str, dict]]") -> float:
        return max(r.get("wallMs", 0.0) for _u, r in hops)

    ranked = sorted(groups.items(), key=lambda kv: -group_wall(kv[1]))
    out = [f"cluster.slow — {captured} records on "
           f"{sum(1 for u in nodes if snaps.get(u) is not None)}"
           f"/{len(nodes)} nodes, "
           f"{len(groups)} distinct requests"
           + (f" (verdict={want})" if want else "")
           + f", top {min(top, len(ranked))}"]
    out.extend(skipped)
    for tid, hops in ranked[:top]:
        # a hop with a terminal verdict names the incident better
        # than "slow"; surface the worst one in the header
        verdicts = {r.get("verdict", "slow") for _u, r in hops}
        headline = next((v for v in ("deadline", "error", "shed")
                         if v in verdicts), "slow")
        out.append(f"{group_wall(hops):9.1f}ms  trace={tid}  "
                   f"verdict={headline}  {len(hops)} hop(s)")
        spans: "dict[str, dict]" = {}
        for url, rec in sorted(hops,
                               key=lambda ur: -ur[1].get("wallMs", 0)):
            try:
                out.extend(_render_slow_hop(url, rec))
            except Exception as e:  # noqa: BLE001 — one malformed
                # record must not hide the rest of the request
                out.append(f"  {url}: record render failed: {e}")
            for s in rec.get("spans") or []:
                if isinstance(s, dict) and s.get("spanId"):
                    s.setdefault("node", url)
                    spans.setdefault(s["spanId"], s)
        if spans:
            tree = render_trace(
                sorted(spans.values(), key=lambda s: s["start"]))
            out.extend("  " + t for t in tree.splitlines())
    if len(out) == 1 + len(skipped):
        out.append("  (no records — rings empty or filtered out)")
    return "\n".join(out)


@command("cluster.profile")
def cmd_cluster_profile(env: CommandEnv, args: list[str]) -> str:
    """Arm the sampling profiler on every node, wait
    `-duration=N` seconds (default 10), disarm, and merge the folded
    stacks into one cluster-wide flame view (`-hz=N` sampling rate,
    `-top=N` lines shown, `-out=FILE` writes the full merged
    collapsed-stack file for flamegraph.pl).  A node whose sampler
    was already armed keeps its window but is still collected and
    disarmed — two operators profiling at once merge, not clobber."""
    from .. import profiling
    opts = _parse_flags(args)
    try:
        duration = max(0.2, float(opts.get("duration", 10.0)))
        hz = float(opts.get("hz", 100.0))
        top = int(opts.get("top", 25))
    except ValueError:
        return "bad -duration/-hz/-top"
    nodes = _top_nodes(env, opts)

    def arm(url: str) -> "tuple[str, bool]":
        try:
            r = http_json("POST", f"{url}/debug/pprof",
                          {"action": "start", "hz": hz}, timeout=5)
            return url, isinstance(r, dict) and "error" not in r
        except OSError:
            return url, False

    def disarm(url: str) -> "tuple[str, dict | None]":
        try:
            r = http_json("POST", f"{url}/debug/pprof",
                          {"action": "stop"}, timeout=10)
            return url, r if isinstance(r, dict) else None
        except OSError:
            return url, None

    with ThreadPoolExecutor(max_workers=min(8, len(nodes))) as ex:
        armed = dict(ex.map(arm, nodes))
        time.sleep(duration)
        snaps = dict(ex.map(disarm, nodes))

    tables, per_node = [], []
    for url in nodes:
        snap = snaps.get(url)
        if snap is None:
            per_node.append(f"  {url}: unreachable"
                            if not armed.get(url) else
                            f"  {url}: armed but no snapshot")
            continue
        tables.append(snap.get("folded") or {})
        per_node.append(
            f"  {url}: {snap.get('samples', 0)} passes, "
            f"{snap.get('stacks', 0)} stacks, "
            f"overhead={snap.get('overhead', 0.0) * 100:.2f}%")
    merged = profiling.merge_folded(tables)
    total = sum(merged.values()) or 1
    out = [f"cluster.profile — {duration:.1f}s @ {hz:.0f}Hz, "
           f"{len(tables)}/{len(nodes)} nodes, "
           f"{len(merged)} distinct stacks"]
    out.extend(per_node)
    if "out" in opts:
        with open(opts["out"], "w", encoding="utf-8") as f:
            for stack, n in sorted(merged.items(),
                                   key=lambda kv: -kv[1]):
                f.write(f"{stack} {n}\n")
        out.append(f"full collapsed-stack file: {opts['out']} "
                   f"(flamegraph.pl input)")
    for stack, n in sorted(merged.items(),
                           key=lambda kv: -kv[1])[:top]:
        frames = stack.split(";")
        tail = ";".join(frames[-3:]) if len(frames) > 3 else stack
        out.append(f"{n:6d} {n / total * 100:4.1f}%  {tail}")
    return "\n".join(out)


# --- helpers -------------------------------------------------------------

def _must(r: dict, what: str) -> dict:
    if isinstance(r, dict) and r.get("error"):
        raise RuntimeError(f"{what}: {r['error']}")
    return r


def _parse_flags(args: list[str]) -> dict:
    """-volumeId=3 -collection=x style flags."""
    out = {}
    for a in args:
        if a.startswith("-") and "=" in a:
            k, v = a[1:].split("=", 1)
            out[k] = v
        elif a.startswith("-"):
            out[a[1:]] = "true"
    return out


def _volumes_by_id(env: CommandEnv) -> dict[int, list[str]]:
    from ..topology import iter_volume_list_volumes
    out: dict[int, list[str]] = {}
    for node, v in iter_volume_list_volumes(env.volume_list()):
        out.setdefault(v["id"], []).append(node["url"])
    return out


def _ec_volumes(env: CommandEnv) -> dict[int, None]:
    from ..topology import iter_volume_list_ec_shards
    out: dict[int, None] = {}
    for _node, e in iter_volume_list_ec_shards(env.volume_list()):
        out[e["volumeId"]] = None
    return out


def _ec_shard_locations(env: CommandEnv, vid: int) -> dict[str, list[int]]:
    from ..topology import fetch_ec_shard_locations
    return fetch_ec_shard_locations(env.master, vid)


def _all_node_urls(env: CommandEnv) -> list[str]:
    r = master_json(env.master, "GET", "/cluster/status", timeout=30)
    return r.get("dataNodes", [])


def _select_volumes(env: CommandEnv, opts: dict) -> list[int]:
    """command_ec_encode.go:375 collectVolumeIdsForEcEncode, simplified:
    an explicit -volumeId, or every volume of -collection."""
    if "volumeId" in opts:
        return [int(opts["volumeId"])]
    collection = opts.get("collection")
    if collection is None:
        return []
    from ..topology import iter_volume_list_volumes
    want = "" if collection == "ALL" else collection
    return sorted({v["id"] for _node, v in
                   iter_volume_list_volumes(env.volume_list())
                   if v.get("collection", "") == want})


def run_command(env: CommandEnv, line: str) -> str:
    parts = line.split()
    if not parts:
        return ""
    name, args = parts[0], parts[1:]
    fn = COMMANDS.get(name)
    if fn is None:
        raise ValueError(
            f"unknown command {name!r}; known: {sorted(COMMANDS)}")
    return fn(env, args)


def run_script(env: CommandEnv, script: str) -> "list[str]":
    """`;`-separated commands on one env (so `lock; ec.encode ...;
    unlock` runs as one), each command's output in order."""
    return [run_command(env, one.strip())
            for one in script.split(";") if one.strip()]
