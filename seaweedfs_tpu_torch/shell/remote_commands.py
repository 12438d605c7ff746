"""remote.* shell family (weed/shell/command_remote_*.go), the port's copy
of `seaweedfs_tpu/shell/remote_commands.py` without `mount.configure`
(it drives a FUSE mount over gRPC, which the port has not): configure
foreign object stores, mount them into the filer namespace, cache /
uncache content, re-pull metadata, copy local files up.

    remote.configure -name=cloud1 -type=s3 -endpoint=host:port \\
                     -accessKey=... -secretKey=...
    remote.mount     -dir=/buckets/b -remote=cloud1/bucket[/prefix]
    remote.meta.sync -dir=/buckets/b
    remote.cache     -dir=/buckets/b [-include=path]
    remote.uncache   -dir=/buckets/b [-include=path]
    remote.unmount   -dir=/buckets/b
    remote.mount.buckets -remote=cloud1 [-bucketPattern=sub]
    remote.copy.local -dir=/buckets/b [-include=s] [-exclude=s]
                      [-dryRun] [-forceUpdate]
"""

from __future__ import annotations

import json
import urllib.parse

from ..remote import (cache_path, load_conf, load_mounts,
                      mount_remote, save_conf, save_mounts,
                      uncache_path)
from ..server.httpd import http_bytes, http_json
from .commands import CommandEnv, _must, _parse_flags, command


def _filer(env: CommandEnv) -> str:
    return env.require_filer()


@command("remote.configure")
def remote_configure(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    name = flags.get("name", "")
    if not name:
        # list configured remotes
        st, body, _ = http_bytes(
            "GET", f"{_filer(env)}/etc/remote/?limit=1000")
        if st != 200:
            return "no remotes configured"
        # each remote may have TWO files: <name>.conf (JSON) and the
        # reference-wire twin <name>.remote.conf — one listing entry
        names = [e["fullPath"].rsplit("/", 1)[-1]
                 .removesuffix(".conf")
                 for e in json.loads(body).get("entries", [])
                 if e["fullPath"].endswith(".conf") and
                 not e["fullPath"].endswith(".remote.conf")]
        return "\n".join(names) or "no remotes configured"
    if flags.get("type", "s3") != "s3":
        return f"unsupported remote type {flags.get('type')!r}"
    save_conf(_filer(env), name, {
        "type": "s3",
        "endpoint": flags.get("endpoint", ""),
        "accessKey": flags.get("accessKey", ""),
        "secretKey": flags.get("secretKey", ""),
    })
    return f"saved remote {name}"


def _split_remote(spec: str) -> "tuple[str, str, str]":
    """cloud1/bucket[/prefix...] -> (conf, bucket, prefix)."""
    parts = spec.strip("/").split("/", 2)
    if len(parts) < 2:
        raise ValueError(
            "remote must be <name>/<bucket>[/<prefix>]")
    return parts[0], parts[1], parts[2] if len(parts) > 2 else ""


@command("remote.mount")
def remote_mount(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    directory = flags.get("dir", "")
    spec = flags.get("remote", "")
    if not directory or not spec:
        mounts = load_mounts(_filer(env))
        return "\n".join(
            f"{d} -> {m['conf']}/{m['bucket']}/{m.get('keyPrefix', '')}"
            for d, m in sorted(mounts.items())) or "no mounts"
    conf, bucket, prefix = _split_remote(spec)
    n = mount_remote(_filer(env), directory, conf, bucket, prefix)
    return f"mounted {spec} at {directory} ({n} entries)"


@command("remote.meta.sync")
def remote_meta_sync(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    directory = flags.get("dir", "").rstrip("/")
    mounts = load_mounts(_filer(env))
    if directory not in mounts:
        return f"{directory} is not remote-mounted"
    m = mounts[directory]
    n = mount_remote(_filer(env), directory, m["conf"], m["bucket"],
                     m.get("keyPrefix", ""))
    return f"meta re-synced: {n} entries"


def _walk(filer: str, directory: str):
    last = ""
    while True:
        st, body, _ = http_bytes(
            "GET", filer + urllib.parse.quote(
                directory.rstrip("/") + "/") +
            f"?limit=500&lastFileName={urllib.parse.quote(last)}")
        if st != 200:
            return
        batch = json.loads(body).get("entries", [])
        for e in batch:
            if e.get("isDirectory"):
                yield from _walk(filer, e["fullPath"])
            else:
                yield e
        if len(batch) < 500:
            return
        last = batch[-1]["fullPath"].rsplit("/", 1)[-1]


@command("remote.cache")
def remote_cache(env: CommandEnv, args: list[str]) -> str:
    from ..remote import remote_for_path
    flags = _parse_flags(args)
    directory = flags.get("dir", "").rstrip("/")
    include = flags.get("include", "")
    # resolve the mount ONCE: per-file resolution would re-fetch the
    # mount table + conf for every entry
    located = remote_for_path(_filer(env), directory)
    if located is None:
        return f"{directory} is not under a remote mount"
    client, base_key = located
    total = files = 0
    for e in _walk(_filer(env), directory):
        if include and include not in e["fullPath"]:
            continue
        if e.get("extended", {}).get("remote") and not e.get("chunks"):
            rel = e["fullPath"][len(directory):].lstrip("/")
            key = (base_key.rstrip("/") + "/" + rel).lstrip("/") \
                if base_key else rel
            total += cache_path(_filer(env), e["fullPath"],
                                located=(client, key))
            files += 1
    return f"cached {files} files, {total} bytes"


@command("remote.uncache")
def remote_uncache(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    directory = flags.get("dir", "")
    include = flags.get("include", "")
    files = 0
    for e in _walk(_filer(env), directory):
        if include and include not in e["fullPath"]:
            continue
        if e.get("extended", {}).get("remote") and e.get("chunks"):
            uncache_path(_filer(env), e["fullPath"])
            files += 1
    return f"uncached {files} files"


@command("remote.unmount")
def remote_unmount(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    directory = flags.get("dir", "").rstrip("/")
    mounts = load_mounts(_filer(env))
    if directory not in mounts:
        return f"{directory} is not remote-mounted"
    del mounts[directory]
    save_mounts(_filer(env), mounts)
    return (f"unmounted {directory} (entries left in place; "
            f"remove with fs.rm if unwanted)")


@command("remote.mount.buckets")
def remote_mount_buckets(env: CommandEnv, args: list[str]) -> str:
    """command_remote_mount_buckets.go (-remote=conf): list the remote
    storage's buckets and mount each under /buckets/<name>."""
    flags = _parse_flags(args)
    conf_name = flags.get("remote", "")
    if not conf_name:
        return "usage: remote.mount.buckets -remote=conf " \
               "[-bucketPattern=sub]"
    pattern = flags.get("bucketPattern", "")
    filer = _filer(env)
    conf = load_conf(filer, conf_name)
    from ..remote.remote_storage import S3RemoteStorage
    client = S3RemoteStorage.from_conf(conf)
    mounted = []
    for bucket in client.list_buckets():
        if pattern and pattern not in bucket:
            continue
        n = mount_remote(filer, f"/buckets/{bucket}", conf_name,
                         bucket, "")
        mounted.append(f"/buckets/{bucket} ({n} entries)")
    return "\n".join(mounted) or "no matching buckets on the remote"


@command("remote.copy.local")
def remote_copy_local(env: CommandEnv, args: list[str]) -> str:
    """command_remote_copy_local.go: push LOCAL-only files under a
    remote mount up to the remote storage (recovery path when the
    filer log was lost or files predate the mount).

        remote.copy.local -dir=/xxx [-include=sub] [-exclude=sub]
                          [-dryRun] [-forceUpdate]

    A file is copied when the remote object is missing (or on
    -forceUpdate when its md5 differs); local metadata then carries
    the remote stat so filer.remote.sync stays idempotent."""
    import hashlib
    from ..remote import remote_for_path
    flags = _parse_flags(args)
    directory = flags.get("dir", "").rstrip("/")
    if not directory:
        return ("usage: remote.copy.local -dir=/mounted "
                "[-include=s] [-exclude=s] [-dryRun] [-forceUpdate]")
    include = flags.get("include", "")
    exclude = flags.get("exclude", "")
    dry = flags.get("dryRun", "").lower() == "true"
    force = flags.get("forceUpdate", "").lower() == "true"
    located = remote_for_path(_filer(env), directory)
    if located is None:
        return f"{directory} is not under a remote mount"
    client, base_key = located
    filer = _filer(env)
    copied = skipped = 0
    lines = []
    for e in _walk(filer, directory):
        path = e["fullPath"]
        if include and include not in path:
            continue
        if exclude and exclude in path:
            continue
        if not e.get("chunks"):
            continue            # remote-only stub, nothing local
        rel = path[len(directory):].lstrip("/")
        key = (base_key.rstrip("/") + "/" + rel).lstrip("/") \
            if base_key else rel
        # stat FIRST: on a mostly-synced mount the common case is
        # "already there" — downloading every body just to discard it
        # would cost a full dataset read per run
        stat = client.stat(key)
        if stat is not None and not force:
            skipped += 1
            continue
        st, body, _ = http_bytes(
            "GET", filer + urllib.parse.quote(path))
        if st != 200:
            continue
        etag = hashlib.md5(body).hexdigest()
        if stat is not None and stat.get("etag") == etag:
            skipped += 1        # force, but content identical
            continue
        if dry:
            lines.append(f"would copy {path} -> {key} ({len(body)}B)")
            copied += 1
            continue
        client.write(key, body)
        # record the remote stat on the entry so sync/uncache treat
        # it as materialized-remote from now on — the SAME marker
        # shape _remote_marker() builds, because mount_remote's meta
        # sync compares markers by string equality and a mismatched
        # shape would make it evict the local copy as "changed"
        from ..remote.remote_storage import _remote_marker
        _must(http_json(
            "POST", f"{filer}/__meta__/patch_extended",
            {"path": path,
             "extended": {"remote": _remote_marker(len(body),
                                                   etag)}}),
            f"mark {path}")
        copied += 1
    verb = "would copy" if dry else "copied"
    head = f"{verb} {copied} files, {skipped} already on remote"
    return head + ("\n" + "\n".join(lines[:50]) if lines else "")
