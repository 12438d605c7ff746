"""The shell's `fs.*` family (weed/shell/command_fs_*.go) and repair
plane, the port's copy of `seaweedfs_tpu/shell/fs_commands.py` without
its tier verbs: fs.configure, fs.ls, fs.cat, fs.meta, fs.rm, fs.mkdir,
fs.du, fs.mv, fs.tree, fs.pwd and fs.cd operate on a filer's namespace
over its HTTP surface (the filer address comes from the shell's -filer
flag or `fs.configure`);

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
                     in proportion to each server's free volume slots.

The output lines are the JAX shell's.
"""

from __future__ import annotations

import json
import urllib.parse

from ..server.httpd import http_bytes, http_json
from ..topology import iter_volume_list_ec_shards
from .commands import (CommandEnv, _all_node_urls, _ec_shard_locations,
                       _ec_volumes, _move_shard, _parse_flags,
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
