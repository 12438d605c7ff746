"""Shell commands (weed/shell/command_*.go): the EC part of
`seaweedfs_tpu/shell/commands.py` (the `fs.*` family is in
`fs_commands.py`).

    lock, unlock, volume.list
    ec.encode   [-volumeId=N | -collection=C] [-mode=scatter|local]
                [-dataShards=10 -parityShards=4]
    ec.rebuild  [-volumeId=N] [-mode=stream|copy]
    ec.decode   -volumeId=N
    ec.scrub    [-mode=local|index]

Commands run against a CommandEnv holding the master address and the
cluster admin lock token; the EC commands need the lock
(shell/command_lock_unlock.go).  The output lines keep the reference's
format.  The codec runs on the volume servers: this module does no
device work and imports no torch.
"""

from __future__ import annotations

import json

from ..operation import master_json
from ..server.httpd import http_json, http_relay
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

    def confirm_is_locked(self) -> None:
        """command_ec_encode.go:104 confirmIsLocked."""
        if self.admin_token is None:
            raise RuntimeError(
                "lock is lost, or it is not locked; run `lock` first")

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
    `_balance_ec_volume` applies after it: toward ceil(total/racks)
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
    per_rack_cap = max(1, -(-total // len(racks)))  # ceil
    rack_load: dict[str, int] = {r: 0 for r in racks}
    node_load: dict[str, int] = {n: 0 for n in nodes}
    placement: dict[int, str] = {}
    for sid in range(total):
        open_racks = [r for r in racks if rack_load[r] < per_rack_cap] \
            or racks
        rack = min(open_racks, key=lambda r: rack_load[r])
        members = [n for n in nodes if rack_of.get(n, "?") == rack]
        dst = min(members, key=lambda n: (node_load[n], score.get(n, 0)))
        placement[sid] = dst
        rack_load[rack] += 1
        node_load[dst] += 1
    return placement


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
    (2) spread shards across racks toward total/racks a rack, (3) even
    out the counts within each rack.  Returns the moves made."""
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

    # (2) across racks; only racks with an alive member receive
    racks = sorted({rack_of.get(n, "?") for n in nodes})
    avg_per_rack = max(1, -(-total // max(len(racks), 1)))  # ceil

    def rack_load() -> dict[str, list[int]]:
        rl: dict[str, list[int]] = {r: [] for r in racks}
        for sid, url in owner.items():
            rl.setdefault(rack_of.get(url, "?"), []).append(sid)
        return rl
    rl = rack_load()
    for rack in sorted(rl, key=lambda r: -len(rl[r])):
        while len(rl[rack]) > avg_per_rack:
            receivable = [r for r in rl if r != rack and
                          any(rack_of.get(n, "?") == r for n in nodes)]
            if not receivable:
                break
            dest_rack = min(receivable, key=lambda r: len(rl[r]))
            if len(rl[dest_rack]) + 1 > avg_per_rack:
                break
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
