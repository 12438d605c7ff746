"""Shell commands (weed/shell/command_*.go): the EC part and the
`cluster.top` / `cluster.slow` / `cluster.profile` views of
`seaweedfs_tpu/shell/commands.py` (the `fs.*` family is in
`fs_commands.py`).

    lock, unlock, volume.list
    ec.encode   [-volumeId=N | -collection=C] [-mode=scatter|local]
                [-dataShards=10 -parityShards=4]
    ec.rebuild  [-volumeId=N] [-mode=stream|copy]
    ec.decode   -volumeId=N
    ec.scrub    [-mode=local|index]
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
    nodes = [env.master]
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


_ROLE_NAMESPACES = ("master", "volume_server", "filer", "s3")


def _top_nodes(env: CommandEnv, opts: dict) -> "list[str]":
    """Fan-out target list: the topology's debug planes plus any
    `-nodes=` extras (a standalone S3 gateway, the admin server)."""
    try:
        nodes = _cluster_debug_nodes(env)
    except OSError:
        nodes = [env.master]
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
