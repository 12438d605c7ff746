"""The shell's `fs.*` family (weed/shell/command_fs_*.go), repair plane
and tier verbs, the port's copy of `seaweedfs_tpu/shell/fs_commands.py`:
fs.configure, fs.ls, fs.cat, fs.meta, fs.rm, fs.mkdir,
fs.du, fs.mv, fs.tree, fs.pwd and fs.cd operate on a filer's namespace
over its HTTP surface (the filer address comes from the shell's -filer
flag or `fs.configure`); fs.meta.save / .load / .cat / .notify back up,
restore, show and re-emit entries, fs.verify checks every chunk is
readable, fs.log lists recent metadata events, and
fs.meta.change.volume.id and fs.merge.volumes move chunk references
between volumes;

  volume.fsck        (command_volume_fsck.go) — the filer's chunk fids
                     against the volumes' needles: orphan needles no
                     entry references (purged with
                     -reallyDeleteFromVolume), and fids whose needle is
                     gone;
  volume.check.disk  (command_volume_check_disk.go) — the replicas'
                     needle inventories diffed, missing needles copied
                     over as raw records from a replica that has them;
  ec.rebalance.proportional
                     (ec_proportional_rebalance.go) — EC shards spread
                     in proportion to each server's free volume slots;
  volume.tier.move   (command_volume_tier_move.go) — every replica's
                     `.dat` to an S3 backend (-endpoint, -bucket,
                     -accessKey, -secretKey), reads then ranged GETs;
  volume.tier.fetch  — the `.dat` back to local disk (the last replica
                     deletes the remote object);
  volume.tier.compact
                     (command_volume_tier_compact.go) — a tiered
                     volume fetched, vacuumed and uploaded again to the
                     backend it came from (-volumeId, or every tiered
                     volume over -garbageThreshold in -collection).

The output lines are the JAX shell's.
"""

from __future__ import annotations

import json
import urllib.parse

from ..server.httpd import http_bytes, http_json
from ..topology import iter_volume_list_ec_shards, iter_volume_list_volumes
from .commands import (CommandEnv, _all_node_urls, _ec_shard_locations,
                       _ec_volumes, _move_shard, _must, _parse_flags,
                       _volumes_by_id, command)


def _filer_get(env: CommandEnv, path: str, query: str = ""):
    url = env.require_filer() + urllib.parse.quote(path)
    if query:
        url += "?" + query
    return http_bytes("GET", url)


# --- fs.* family ---------------------------------------------------------

@command("fs.configure")
def cmd_fs_configure(env: CommandEnv, args: list[str]) -> str:
    opts = _parse_flags(args)
    if "filer" in opts:
        env.filer = opts["filer"]
    return f"filer = {env.filer or '(unset)'}"


def _list_dir(env: CommandEnv, path: str) -> list[dict]:
    """Full listing with lastFileName pagination (a silent truncation
    would hide entries from ls, du and tree)."""
    out: list[dict] = []
    last = ""
    while True:
        st, body, _ = _filer_get(
            env, path.rstrip("/") + "/",
            "limit=1000&lastFileName=" + urllib.parse.quote(last))
        if st != 200:
            raise RuntimeError(f"list {path}: HTTP {st}")
        batch = json.loads(body).get("entries", [])
        out.extend(batch)
        if len(batch) < 1000:
            return out
        last = batch[-1]["fullPath"].rsplit("/", 1)[-1]


@command("fs.ls")
def cmd_fs_ls(env: CommandEnv, args: list[str]) -> str:
    """command_fs_ls.go: list a directory (-l for mode/size/mtime)."""
    opts = _parse_flags(args)
    paths = [a for a in args if not a.startswith("-")] or ["/"]
    out = []
    for path in paths:
        for e in _list_dir(env, path):
            name = e["fullPath"].rsplit("/", 1)[-1]
            if e.get("isDirectory"):
                name += "/"
            if "l" in opts:
                attrs = e.get("attributes", {})
                size = sum(c.get("size", 0)
                           for c in e.get("chunks", []))
                out.append(f"{attrs.get('mode', 0):>6o} "
                           f"{size:>12} {name}")
            else:
                out.append(name)
    return "\n".join(out)


@command("fs.cat")
def cmd_fs_cat(env: CommandEnv, args: list[str]) -> str:
    """command_fs_cat.go."""
    path = next(a for a in args if not a.startswith("-"))
    st, body, _ = _filer_get(env, path)
    if st != 200:
        raise RuntimeError(f"cat {path}: HTTP {st}")
    return body.decode(errors="replace")


@command("fs.meta")
def cmd_fs_meta(env: CommandEnv, args: list[str]) -> str:
    """command_fs_meta_cat.go: raw entry metadata incl. chunk fids."""
    path = next(a for a in args if not a.startswith("-"))
    st, body, _ = http_bytes(
        "GET", f"{env.require_filer()}/__meta__/lookup?path="
        f"{urllib.parse.quote(path)}")
    if st != 200:
        raise RuntimeError(f"meta {path}: HTTP {st}")
    return json.dumps(json.loads(body), indent=2)


@command("fs.rm")
def cmd_fs_rm(env: CommandEnv, args: list[str]) -> str:
    """command_fs_rm.go (-r recursive)."""
    opts = _parse_flags(args)
    targets = [a for a in args if not a.startswith("-")]
    removed = []
    for path in targets:
        rec = "?recursive=true" if "r" in opts else ""
        st, body, _ = http_bytes(
            "DELETE",
            env.require_filer() + urllib.parse.quote(path) + rec)
        if st not in (204, 200):
            raise RuntimeError(
                f"rm {path}: HTTP {st} {body[:200]!r}")
        removed.append(path)
    return f"removed: {removed}"


@command("fs.mkdir")
def cmd_fs_mkdir(env: CommandEnv, args: list[str]) -> str:
    path = next(a for a in args if not a.startswith("-"))
    st, _, _ = http_bytes(
        "PUT", env.require_filer() + urllib.parse.quote(
            path.rstrip("/") + "/"))
    if st not in (200, 201):
        raise RuntimeError(f"mkdir {path}: HTTP {st}")
    return f"created {path}"


@command("fs.du")
def cmd_fs_du(env: CommandEnv, args: list[str]) -> str:
    """command_fs_du.go: recursive size of a subtree."""
    path = (next((a for a in args if not a.startswith("-")), "/"))

    def du(p: str) -> "tuple[int, int]":
        nbytes = nfiles = 0
        for e in _list_dir(env, p):
            if e.get("isDirectory"):
                b, f = du(e["fullPath"])
                nbytes += b
                nfiles += f
            else:
                nbytes += sum(c.get("size", 0)
                              for c in e.get("chunks", []))
                nfiles += 1
        return nbytes, nfiles

    nbytes, nfiles = du(path)
    return f"{nbytes} bytes, {nfiles} files under {path}"


@command("fs.mv")
def cmd_fs_mv(env: CommandEnv, args: list[str]) -> str:
    """command_fs_mv.go: rename/move within the filer namespace via
    the atomic rename RPC (filer.proto AtomicRenameEntry)."""
    paths = [a for a in args if not a.startswith("-")]
    if len(paths) != 2:
        raise RuntimeError("usage: fs.mv <source> <destination>")
    src, dst = paths
    r = http_json("POST", env.require_filer() + "/__meta__/rename",
                  {"oldPath": src, "newPath": dst})
    if "error" in r:
        raise RuntimeError(f"fs.mv: {r['error']}")
    return f"moved {src} -> {dst}"


@command("fs.tree")
def cmd_fs_tree(env: CommandEnv, args: list[str]) -> str:
    """command_fs_tree.go: recursive listing as an indented tree."""
    paths = [a for a in args if not a.startswith("-")] or ["/"]
    root = paths[0]
    lines: list[str] = [root]
    dirs = files = 0

    def walk(path: str, depth: int) -> None:
        nonlocal dirs, files
        for e in _list_dir(env, path):
            name = e["fullPath"].rsplit("/", 1)[-1]
            is_dir = e.get("isDirectory")
            lines.append("  " * (depth + 1) +
                         (name + "/" if is_dir else name))
            if is_dir:
                dirs += 1
                walk(e["fullPath"], depth + 1)
            else:
                files += 1

    walk(root.rstrip("/") or "/", 0)
    lines.append(f"{dirs} directories, {files} files")
    return "\n".join(lines)


# --- the shell's working directory (command_fs_cd.go, _pwd) -------------

def _resolve(env: CommandEnv, path: str) -> str:
    """Resolve against the shell's working directory (fs.cd),
    collapsing ./.. segments so `fs.cd ..` navigates up."""
    import posixpath
    cwd = getattr(env, "cwd", "/")
    if not path:
        return cwd
    if not path.startswith("/"):
        path = cwd.rstrip("/") + "/" + path
    return posixpath.normpath(path) or "/"


@command("fs.pwd")
def cmd_fs_pwd(env: CommandEnv, args: list[str]) -> str:
    """command_fs_pwd.go."""
    return getattr(env, "cwd", "/")


@command("fs.cd")
def cmd_fs_cd(env: CommandEnv, args: list[str]) -> str:
    """command_fs_cd.go: change the shell's filer working directory
    (relative fs.* paths resolve against it)."""
    target = _resolve(env, args[0] if args else "/")
    if target != "/":
        st, body, _ = _filer_get(
            env, "/__meta__/lookup",
            "path=" + urllib.parse.quote(target.rstrip("/")))
        if st != 200 or not json.loads(body).get("isDirectory"):
            raise RuntimeError(f"{target}: not a directory")
    env.cwd = target if target.startswith("/") else "/" + target
    return env.cwd


# --- volume.fsck (command_volume_fsck.go) --------------------------------

def _collect_filer_fids(env: CommandEnv, path: str = "/"
                        ) -> "set[str]":
    fids: set[str] = set()
    for e in _list_dir(env, path):
        if e.get("isDirectory"):
            fids |= _collect_filer_fids(env, e["fullPath"])
        else:
            for c in e.get("chunks", []):
                fid = c.get("fileId") or c.get("fid", "")
                if fid:
                    fids.add(fid)
    return fids


def _needle_is_recent(url: str, vid: int, key: int,
                      cutoff_s: float) -> bool:
    """True if the needle was appended/modified within cutoff_s (or we
    cannot tell — err on the side of NOT purging)."""
    import struct
    import time as _time

    from ..storage.needle import Needle
    st, raw, hdrs = http_bytes(
        "GET", f"{url}/admin/needle_raw?volumeId={vid}&key={key}")
    if st != 200 or len(raw) < 16:
        return True
    try:
        version = int(hdrs.get("X-Needle-Version", 2))
        n = Needle.parse_header(raw[:16])
        n.parse_body(raw[16:], version, check_crc=False)
    except (ValueError, struct.error):
        return True
    now = _time.time()
    if n.append_at_ns:
        return now - n.append_at_ns / 1e9 < cutoff_s
    if n.last_modified:
        return now - n.last_modified < cutoff_s
    return True


def _volume_live_keys(url: str, vid: int) -> "dict[int, int]":
    r = http_json("GET", f"{url}/admin/volume_index?volumeId={vid}")
    if "error" in r:
        raise RuntimeError(f"volume_index {vid}@{url}: {r['error']}")
    return {int(k): int(s) for k, s in r["entries"]}


@command("volume.fsck")
def cmd_volume_fsck(env: CommandEnv, args: list[str]) -> str:
    """Cross-reference filer chunks against volume needles.

    Orphans (needle exists, no filer reference) are reported; pass
    -reallyDeleteFromVolume to purge them (the reference's flag name).
    Missing fids (filer references a needle that is gone) are always
    reported — they mean data loss upstream."""
    opts = _parse_flags(args)
    purge = "reallyDeleteFromVolume" in opts
    cutoff_s = float(opts.get("cutoffSeconds", 60))
    if purge:
        env.confirm_is_locked()
    referenced = _collect_filer_fids(env)
    ref_keys: dict[int, set[int]] = {}
    for fid in referenced:
        try:
            vid_s, rest = fid.split(",", 1)
            key = int(rest[:-8], 16)  # strip 8 cookie hex chars
            ref_keys.setdefault(int(vid_s), set()).add(key)
        except (ValueError, IndexError):
            continue
    orphans: list[str] = []
    missing: list[str] = []
    purged = 0
    skipped_recent = 0
    volumes = _volumes_by_id(env)
    for vid, urls in sorted(volumes.items()):
        live = _volume_live_keys(urls[0], vid)
        refs = ref_keys.get(vid, set())
        for key in sorted(set(live) - refs):
            orphans.append(f"{vid},{key:x}")
            if purge:
                if _needle_is_recent(urls[0], vid, key, cutoff_s):
                    # an in-flight upload writes its chunks BEFORE the
                    # filer entry exists; purging a fresh needle would
                    # destroy it (the reference's -cutoffTimeAgo guard,
                    # command_volume_fsck.go)
                    skipped_recent += 1
                    continue
                for url in urls:
                    http_json("POST", f"{url}/admin/delete_needle",
                              {"volumeId": vid, "key": key})
                purged += 1
        for key in sorted(refs - set(live)):
            missing.append(f"{vid},{key:x}")
    lines = [f"volumes checked: {len(volumes)}",
             f"filer-referenced fids: {len(referenced)}",
             f"orphan needles (no filer reference): {len(orphans)}"]
    if orphans:
        lines.append("  " + " ".join(orphans[:20]) +
                     (" ..." if len(orphans) > 20 else ""))
    if purge:
        lines.append(f"purged: {purged} "
                     f"(skipped {skipped_recent} newer than "
                     f"{cutoff_s:.0f}s)")
    lines.append(f"MISSING needles (filer references broken): "
                 f"{len(missing)}")
    if missing:
        lines.append("  " + " ".join(missing[:20]) +
                     (" ..." if len(missing) > 20 else ""))
    return "\n".join(lines)


# --- volume.check.disk (command_volume_check_disk.go) --------------------

@command("volume.check.disk")
def cmd_volume_check_disk(env: CommandEnv, args: list[str]) -> str:
    """Pairwise-sync replicas of each volume: needles present on one
    replica but absent on another are copied over as raw records."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    target = int(opts["volumeId"]) if "volumeId" in opts else None
    out = []
    for vid, urls in sorted(_volumes_by_id(env).items()):
        if target is not None and vid != target:
            continue
        if len(urls) < 2:
            continue
        inv = {url: _volume_live_keys(url, vid) for url in urls}
        union: set[int] = set()
        for keys in inv.values():
            union |= set(keys)
        fixed = 0
        for url in urls:
            lacking = union - set(inv[url])
            for key in sorted(lacking):
                donor = next(u for u in urls if key in inv[u])
                st, raw, hdrs = http_bytes(
                    "GET", f"{donor}/admin/needle_raw?volumeId={vid}"
                    f"&key={key}")
                if st != 200:
                    raise RuntimeError(
                        f"read needle {vid},{key:x} from {donor}: {st}")
                version = hdrs.get("X-Needle-Version", "")
                st, body, _ = http_bytes(
                    "POST", f"{url}/admin/write_needle_raw?volumeId="
                    f"{vid}&version={version}", raw)
                if st != 200:
                    raise RuntimeError(
                        f"write needle {vid},{key:x} to {url}: {st} "
                        f"{body[:200]!r}")
                fixed += 1
        out.append(f"volume {vid}: {len(urls)} replicas, "
                   f"{fixed} needles synced")
    return "\n".join(out) if out else "no replicated volumes"


# --- ec proportional rebalance (ec_proportional_rebalance.go) ------------

@command("ec.rebalance.proportional")
def cmd_ec_rebalance_proportional(env: CommandEnv,
                                  args: list[str]) -> str:
    """Spread EC shards proportionally to each node's free volume
    capacity: nodes with more headroom carry more shards (the
    reference's proportional strategy, vs ec.balance's even spread).
    Each volume's shards move under its own collection (-collection
    selects the volumes; ROADMAP C20)."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    want = opts.get("collection")
    vl = env.volume_list()
    collection_of = {e["volumeId"]: e.get("collection", "")
                     for _n, e in iter_volume_list_ec_shards(vl)}
    capacity: dict[str, int] = {}
    used: dict[str, int] = {}
    for dc in vl.get("dataCenters", {}).values():
        for rack in dc.get("racks", {}).values():
            for node in rack.get("nodes", []):
                url = node["url"]
                capacity[url] = int(node.get("maxVolumeCount", 8))
                used[url] = len(node.get("volumes", []))
    for url in _all_node_urls(env):
        capacity.setdefault(url, 8)
        used.setdefault(url, 0)
    free = {u: max(1, capacity[u] - used[u]) for u in capacity}
    total_free = sum(free.values())

    moved = 0
    for vid in _ec_volumes(env):
        collection = collection_of.get(vid, want or "")
        if want is not None and collection != want:
            continue
        locs = _ec_shard_locations(env, vid)
        n = sum(len(sids) for sids in locs.values())
        # proportional targets, largest-remainder rounding
        quota = {u: n * free[u] / total_free for u in free}
        tgt = {u: int(quota[u]) for u in quota}
        for u in sorted(quota, key=lambda u: quota[u] - tgt[u],
                        reverse=True):
            if sum(tgt.values()) >= n:
                break
            tgt[u] += 1
        have = {u: len(locs.get(u, [])) for u in free}
        for donor in sorted(free, key=lambda u: tgt[u] - have[u]):
            while have[donor] > tgt[donor] and locs.get(donor):
                recv = min((u for u in free if have[u] < tgt[u]),
                           key=lambda u: have[u] - tgt[u],
                           default=None)
                if recv is None:
                    break
                sid = locs[donor][-1]
                _move_shard(env, vid, collection, sid, donor, recv)
                locs[donor].remove(sid)
                locs.setdefault(recv, []).append(sid)
                have[donor] -= 1
                have[recv] += 1
                moved += 1
    return (f"proportionally rebalanced: moved {moved} shards; "
            f"capacity " +
            json.dumps({u: f"{used[u]}/{capacity[u]}"
                        for u in sorted(capacity)}))


# --- metadata backup, verification, chunk relocation -------------------

def _walk_entries(env: CommandEnv, directory: str):
    """Depth-first full-entry walk via the PAGINATED filer listing
    (_list_dir) — a flat limit would silently truncate large
    directories, making fs.meta.save backups and fs.verify sweeps
    incomplete without saying so."""
    for e in _list_dir(env, directory):
        yield e
        if e.get("isDirectory"):
            yield from _walk_entries(env, e["fullPath"])


@command("fs.meta.save")
def cmd_fs_meta_save(env: CommandEnv, args: list[str]) -> str:
    """command_fs_meta_save.go (-o=meta.jsonl [dir]): serialize the
    filer metadata tree (entries incl. chunk lists) to a local file
    for backup/migration."""
    opts = _parse_flags(args)
    out_path = opts.get("o", "filer-meta.jsonl")
    root = _resolve(env, next((a for a in args
                               if not a.startswith("-")), "/"))
    n = 0
    with open(out_path, "w") as f:
        for e in _walk_entries(env, root):
            f.write(json.dumps(e) + "\n")
            n += 1
    return f"saved {n} entries under {root} to {out_path}"


@command("fs.meta.load")
def cmd_fs_meta_load(env: CommandEnv, args: list[str]) -> str:
    """command_fs_meta_load.go (meta.jsonl): restore entries saved by
    fs.meta.save (full entries incl. chunk refs — the data itself must
    still live on the volume servers)."""
    src = next((a for a in args if not a.startswith("-")), "")
    if not src:
        return "usage: fs.meta.load <meta.jsonl>"
    filer = env.require_filer()
    n = 0
    with open(src) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            _must(http_json("POST", f"{filer}/__meta__/put_entry",
                            entry), f"load {entry.get('fullPath')}")
            n += 1
    return f"loaded {n} entries from {src}"


@command("fs.meta.cat")
def cmd_fs_meta_cat(env: CommandEnv, args: list[str]) -> str:
    """command_fs_meta_cat.go: the raw stored entry (attributes +
    chunk list) of one path."""
    path = _resolve(env, args[0] if args else "")
    st, body, _ = _filer_get(env, "/__meta__/lookup",
                             "path=" + urllib.parse.quote(path))
    if st != 200:
        raise RuntimeError(f"{path}: {st}")
    return json.dumps(json.loads(body), indent=1)


@command("fs.verify")
def cmd_fs_verify(env: CommandEnv, args: list[str]) -> str:
    """command_fs_verify.go ([dir]): every chunk fid of every file
    under dir must be readable on some volume server."""
    from .. import operation
    root = _resolve(env, args[0] if args else "/")
    files = chunks = broken = 0
    problems: list[str] = []
    for e in _walk_entries(env, root):
        if e.get("isDirectory"):
            continue
        files += 1
        for c in e.get("chunks", []):
            chunks += 1
            fid = c.get("fileId", "")
            try:
                vid = int(fid.split(",")[0])
                locs = operation.lookup(env.master, vid,
                                        use_cache=False)
                if not locs:
                    raise LookupError("no locations")
                # readable on SOME replica is the contract — a single
                # down server must not flag healthy data as broken
                errs = []
                for loc in locs:
                    try:
                        st, _, _ = http_bytes(
                            "HEAD", f"{loc['url']}/{fid}")
                    except OSError as oe:
                        errs.append(f"{loc['url']}: {oe}")
                        continue
                    if st == 200:
                        break
                    errs.append(f"{loc['url']}: HTTP {st}")
                else:
                    raise LookupError("; ".join(errs))
            except (OSError, LookupError, ValueError) as ex:
                broken += 1
                if len(problems) < 20:
                    problems.append(f"{e['fullPath']}: {fid}: {ex}")
    lines = [f"verified {files} files / {chunks} chunks under {root}: "
             f"{broken} broken"]
    lines += problems
    return "\n".join(lines)


@command("fs.log")
def cmd_fs_log(env: CommandEnv, args: list[str]) -> str:
    """command_fs_log.go analog: recent filer metadata log events
    (-n=20)."""
    opts = _parse_flags(args)
    n = int(opts.get("n", 20))
    st, body, _ = _filer_get(env, "/__meta__/events", "sinceNs=0")
    if st != 200:
        raise RuntimeError(f"meta events: {st}")
    events = json.loads(body).get("events", [])[-n:]
    lines = []
    for ev in events:
        path = ((ev.get("newEntry") or ev.get("oldEntry") or
                 {}).get("fullPath", "?"))
        lines.append(f"{ev.get('tsNs', 0)} {ev.get('op', '?'):7s} "
                     f"{path}")
    return "\n".join(lines) or "(no events)"


@command("fs.meta.notify")
def cmd_fs_meta_notify(env: CommandEnv, args: list[str]) -> str:
    """command_fs_meta_notify.go ([dir]): re-emit every entry under
    dir as a fresh metadata event (re-seeds filer.sync / notification
    consumers after they lost their position)."""
    filer = env.require_filer()
    root = _resolve(env, args[0] if args else "/")
    n = 0
    for e in _walk_entries(env, root):
        _must(http_json("POST", f"{filer}/__meta__/put_entry", e),
              f"notify {e.get('fullPath')}")
        n += 1
    return f"re-emitted {n} entries under {root} into the meta log"


# --- chunk relocation (command_fs_merge_volumes.go /
# command_fs_meta_change_volume_id.go) ------------------------------------

def _chunk_vid(fid: str) -> int:
    return int(fid.split(",", 1)[0])


@command("fs.meta.change.volume.id")
def cmd_fs_meta_change_volume_id(env: CommandEnv,
                                 args: list[str]) -> str:
    """command_fs_meta_change_volume_id.go: rewrite volume ids inside
    chunk fids in filer METADATA only (after an out-of-band volume
    move/renumber).

        fs.meta.change.volume.id -dir=/p -fromVolumeId=x
                                 -toVolumeId=y -apply
        fs.meta.change.volume.id -dir=/p -mapping=map.txt -apply

    mapping file lines: `1 => 2`.  Without -apply: dry run."""
    opts = _parse_flags(args)
    mapping: dict[int, int] = {}
    if opts.get("mapping"):
        with open(opts["mapping"]) as f:
            for line in f:
                line = line.strip()
                if not line or "=>" not in line:
                    continue
                a, b = line.split("=>", 1)
                mapping[int(a.strip())] = int(b.strip())
    elif "fromVolumeId" in opts and "toVolumeId" in opts:
        mapping[int(opts["fromVolumeId"])] = int(opts["toVolumeId"])
    if not mapping:
        return ("usage: fs.meta.change.volume.id -dir=/p "
                "(-fromVolumeId=x -toVolumeId=y | -mapping=f) "
                "[-apply]")
    root = _resolve(env, opts.get("dir", "/"))
    apply = "apply" in opts
    filer = env.require_filer()
    changed = files = 0
    for e in _walk_entries(env, root):
        chunks = e.get("chunks") or []
        touched = False
        for c in chunks:
            vid = _chunk_vid(c["fileId"])
            if vid in mapping:
                c["fileId"] = \
                    f"{mapping[vid]}," + c["fileId"].split(",", 1)[1]
                touched = True
                changed += 1
        if touched:
            files += 1
            if apply:
                _must(http_json("POST",
                                f"{filer}/__meta__/put_entry", e),
                      f"update {e['fullPath']}")
    verb = "changed" if apply else "would change"
    pairs = ", ".join(f"{a}=>{b}" for a, b in sorted(mapping.items()))
    return (f"{verb} {changed} chunk refs in {files} files under "
            f"{root} ({pairs})" + ("" if apply else "; add -apply to write"))


@command("fs.merge.volumes")
def cmd_fs_merge_volumes(env: CommandEnv, args: list[str]) -> str:
    """command_fs_merge_volumes.go: RELOCATE chunk data out of
    lighter volumes into a target volume so vacuum can reclaim the
    emptied ones.

        fs.merge.volumes -fromVolumeId=x -toVolumeId=y [-dir=/]
                         [-apply]

    For every file chunk on the source volume: read the bytes, write
    them to the SAME needle key on the target volume, update the
    entry's chunk fid, then delete the source needle.  Needle keys
    are cluster-unique (master sequence), so no collision on the
    target."""
    from .. import operation
    opts = _parse_flags(args)
    if "fromVolumeId" not in opts or "toVolumeId" not in opts:
        return ("usage: fs.merge.volumes -fromVolumeId=x "
                "-toVolumeId=y [-dir=/] [-apply]")
    src_vid = int(opts["fromVolumeId"])
    dst_vid = int(opts["toVolumeId"])
    if src_vid == dst_vid:
        raise RuntimeError("from and to volume are the same")
    apply = "apply" in opts
    root = _resolve(env, opts.get("dir", "/"))
    filer = env.require_filer()
    dst_locs = env.volume_locations(dst_vid)
    if not dst_locs:
        raise RuntimeError(f"target volume {dst_vid} not found")
    moved = bytes_moved = files = 0
    for e in _walk_entries(env, root):
        chunks = e.get("chunks") or []
        todo = [c for c in chunks
                if _chunk_vid(c["fileId"]) == src_vid]
        if not todo:
            continue
        files += 1
        if not apply:
            moved += len(todo)
            bytes_moved += sum(c.get("size", 0) for c in todo)
            continue
        old_fids = []
        for c in todo:
            data = operation.read(env.master, c["fileId"])
            rest = c["fileId"].split(",", 1)[1]
            new_fid = f"{dst_vid},{rest}"
            operation.upload(dst_locs[0]["url"], new_fid, data)
            old_fids.append(c["fileId"])
            c["fileId"] = new_fid
            moved += 1
            bytes_moved += len(data)
        _must(http_json("POST", f"{filer}/__meta__/put_entry", e),
              f"update {e['fullPath']}")
        # source needles die only AFTER the metadata points at the
        # new home — a crash in between leaves both copies (safe)
        for fid in old_fids:
            try:
                operation.delete(env.master, fid)
            except (OSError, RuntimeError):
                pass    # vacuum will reclaim
    verb = "moved" if apply else "would move"
    return (f"{verb} {moved} chunks ({bytes_moved} bytes) in {files} "
            f"files from volume {src_vid} to {dst_vid}"
            + ("" if apply else "; add -apply to execute"))


# --- volume tiers (shell/command_volume_tier_*.go) -------------------------

@command("volume.tier.move")
def cmd_volume_tier_move(env: CommandEnv, args: list[str]) -> str:
    """Move a volume's .dat to an S3-compatible backend on every replica;
    needle reads become ranged GETs (storage/volume_tier.go)."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    if "endpoint" not in opts:
        raise RuntimeError("volume.tier.move needs -endpoint=host:port "
                           "(an S3-compatible API, e.g. our own "
                           "gateway)")
    body = {"volumeId": vid,
            "endpoint": opts["endpoint"],
            "bucket": opts.get("bucket", "tier"),
            "accessKey": opts.get("accessKey", ""),
            "secretKey": opts.get("secretKey", ""),
            "backendId": opts.get("backendId", "default")}
    urls = [loc["url"] for loc in env.volume_locations(vid)]
    if not urls:
        raise RuntimeError(f"volume {vid} has no locations")
    out = []
    for url in urls:
        r = http_json("POST", f"{url}/admin/tier_move", body, timeout=3600)
        if r.get("error"):
            raise RuntimeError(f"tier_move on {url}: {r['error']}")
        out.append(f"{url}: -> s3://{body['bucket']}/"
                   f"{r.get('key', '?')} ({r.get('fileSize', '?')}B)")
    return "\n".join(out)


@command("volume.tier.fetch")
def cmd_volume_tier_fetch(env: CommandEnv, args: list[str]) -> str:
    """Bring a tiered volume's .dat back to local disk on every replica;
    only the last deletes the remote object, which the others read."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    vid = int(opts["volumeId"])
    urls = [loc["url"] for loc in env.volume_locations(vid)]
    out = []
    for i, url in enumerate(urls):
        r = http_json("POST", f"{url}/admin/tier_fetch",
                      {"volumeId": vid,
                       "deleteRemote": i == len(urls) - 1}, timeout=3600)
        if r.get("error"):
            raise RuntimeError(f"tier_fetch on {url}: {r['error']}")
        out.append(f"{url}: fetched ({r.get('fileSize', '?')}B)")
    return "\n".join(out)


@command("volume.tier.compact")
def cmd_volume_tier_compact(env: CommandEnv, args: list[str]) -> str:
    """command_volume_tier_compact.go: reclaim remote-tier space — fetch
    the tiered .dat back, vacuum out deleted needles, upload the
    compacted copy to the same backend.

        volume.tier.compact -volumeId=N [-endpoint=.. -bucket=..
                            -accessKey=.. -secretKey=..]
        volume.tier.compact [-collection=C] [-garbageThreshold=0.3]

    The backend flags may be left out while the server still holds the
    backend the volume was moved with."""
    env.confirm_is_locked()
    opts = _parse_flags(args)
    threshold = float(opts.get("garbageThreshold", 0.3))
    move_body = {"backendId": opts.get("backendId", "default")}
    for k in ("endpoint", "bucket", "accessKey", "secretKey"):
        if opts.get(k):
            move_body[k] = opts[k]
    if "volumeId" in opts:
        vids = [int(opts["volumeId"])]
    else:
        collection = opts.get("collection", "")
        vids = sorted({
            v["id"] for _node, v in iter_volume_list_volumes(env.volume_list())
            if v.get("remoteTiered") and
            (not collection or v.get("collection") == collection) and
            v.get("deletedByteCount", 0) / max(v.get("size", 0), 1) >=
            threshold})
    if not vids:
        return "no remote volumes above the garbage threshold"
    out = []
    for vid in vids:
        urls = _volumes_by_id(env).get(vid) or \
            [loc["url"] for loc in env.volume_locations(vid)]
        for url in urls:
            r = http_json("POST", f"{url}/admin/tier_fetch",
                          {"volumeId": vid, "deleteRemote": False},
                          timeout=3600)
            if r.get("error"):
                raise RuntimeError(f"tier_fetch on {url}: {r['error']}")
            if r.get("alreadyLocal"):
                # a verb that reclaims remote space never tiers a local
                # volume as a side effect
                raise RuntimeError(
                    f"volume {vid} on {url} is not remote-tiered; "
                    "use volume.vacuum for local volumes")
            before = r.get("fileSize", 0)
            # back to the backend it came from unless the flags say
            # otherwise: the fetch cleared the .vif's binding
            body = dict(move_body, volumeId=vid)
            if "backendId" not in opts and r.get("backendId"):
                body["backendId"] = r["backendId"]
            r2 = http_json("POST", f"{url}/admin/vacuum", {"volumeId": vid},
                           timeout=3600)
            if r2.get("error"):
                raise RuntimeError(f"vacuum on {url}: {r2['error']}")
            r = http_json("POST", f"{url}/admin/tier_move", body,
                          timeout=3600)
            if r.get("error"):
                raise RuntimeError(f"tier_move on {url}: {r['error']}")
            out.append(f"volume {vid} on {url}: {before} -> "
                       f"{r.get('fileSize', 0)} bytes remote")
    return "\n".join(out)
