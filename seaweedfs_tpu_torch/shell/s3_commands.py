"""s3.* shell family, the port's copy of `seaweedfs_tpu/shell/
s3_commands.py` (reference: weed/shell/command_s3_bucket_quota*.go +
the lifecycle enforcement pass):

    s3.bucket.quota          -bucket=b [-limitMB=N | -remove]
    s3.bucket.quota.enforce  flips over-quota buckets read-only (and
                             back) — the reference's
                             s3.bucket.quota.enforce
    s3.lifecycle.apply       one enforcement pass over every bucket
                             with a lifecycle configuration

with `s3.bucket.create` / `.delete` / `.list` and `s3.circuitBreaker`.
The four `s3tables.*` verbs are refused, as the gateway's S3 Tables
target answers 501: S3 Tables is not ported (ROADMAP A3.4).
"""

from __future__ import annotations

import urllib.parse

from ..filer.client import FilerClient
from ..server.httpd import http_bytes
from .commands import CommandEnv, _parse_flags, command


def _check_bucket_name(name: str) -> None:
    """S3 bucket-name charset (lowercase alnum, dots, dashes): also
    keeps URL metacharacters out of the filer paths these commands
    build."""
    import re
    if not name or not re.fullmatch(r"[a-z0-9][a-z0-9.\-]{1,62}",
                                    name):
        raise RuntimeError(
            f"bad bucket name {name!r} (3-63 chars, lowercase "
            "alnum/dot/dash)")


BUCKETS_ROOT = "/buckets"


def _client(env: CommandEnv) -> FilerClient:
    return FilerClient(env.require_filer())


def _bucket_usage(fc: FilerClient, path: str) -> int:
    """Recursive content bytes under a bucket (chunk extents)."""
    total = 0
    last = ""
    while True:
        batch = fc.list_directory(path, start_file=last, limit=500)
        if not batch:
            return total
        for e in batch:
            if e.is_directory:
                if not e.name.startswith("."):
                    total += _bucket_usage(fc, e.full_path)
            else:
                total += e.total_size()
        if len(batch) < 500:
            return total
        last = batch[-1].name


def _patch_extended(fc: FilerClient, path: str, patch: dict) -> None:
    # one shared client for /__meta__/patch_extended (also used by
    # the remote-storage gateway)
    from ..remote.remote_storage import _meta_patch_extended
    _meta_patch_extended(fc.filer, path, patch)


@command("s3.bucket.quota")
def s3_bucket_quota(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    bucket = flags.get("bucket", "")
    fc = _client(env)
    path = f"{BUCKETS_ROOT}/{bucket}"
    entry = fc.find_entry(path)
    if entry is None:
        return f"no such bucket {bucket!r}"
    if "remove" in flags:
        _patch_extended(fc, path, {"quotaBytes": "",
                                   "readOnly": ""})
        return f"quota removed from {bucket}"
    if "limitMB" not in flags:
        q = entry.extended.get("quotaBytes", "")
        used = _bucket_usage(fc, path)
        return (f"{bucket}: quota="
                f"{q or 'none'} used={used} "
                f"readOnly={entry.extended.get('readOnly', 'false')}")
    limit = int(float(flags["limitMB"]) * 1024 * 1024)
    _patch_extended(fc, path, {"quotaBytes": str(limit)})
    return f"quota on {bucket}: {limit} bytes"


@command("s3.bucket.quota.enforce")
def s3_bucket_quota_enforce(env: CommandEnv,
                            args: list[str]) -> str:
    fc = _client(env)
    lines = []
    for b in fc.list_directory(BUCKETS_ROOT, limit=10000):
        if not b.is_directory:
            continue
        quota = b.extended.get("quotaBytes", "")
        if not quota:
            continue
        used = _bucket_usage(fc, b.full_path)
        over = used > int(quota)
        was = b.extended.get("readOnly") == "true"
        if over != was:
            _patch_extended(fc, b.full_path,
                            {"readOnly": "true" if over else ""})
        lines.append(f"{b.name}: used={used}/{quota} "
                     f"{'READ-ONLY' if over else 'ok'}")
    return "\n".join(lines) or "no buckets carry quotas"


@command("s3.lifecycle.apply")
def s3_lifecycle_apply(env: CommandEnv, args: list[str]) -> str:
    from ..s3.lifecycle import (LifecycleError, apply_lifecycle,
                                parse_lifecycle)
    fc = _client(env)
    lines = []
    for b in fc.list_directory(BUCKETS_ROOT, limit=10000):
        if not b.is_directory:
            continue
        doc = b.extended.get("lifecycle", "")
        if not doc:
            continue
        try:
            rules = parse_lifecycle(doc.encode())
        except LifecycleError as e:
            lines.append(f"{b.name}: bad lifecycle config: {e}")
            continue
        deleted, aborted = apply_lifecycle(fc, b.full_path, rules)
        lines.append(f"{b.name}: expired {deleted} objects, "
                     f"aborted {aborted} uploads")
    return "\n".join(lines) or "no buckets carry lifecycle configs"


@command("s3.bucket.create")
def cmd_s3_bucket_create(env: CommandEnv, args: list[str]) -> str:
    """command_s3_bucket_create.go: a bucket is a directory under
    /buckets in the filer namespace."""
    opts = _parse_flags(args)
    name = opts.get("name", "")
    _check_bucket_name(name)
    st, body, _ = http_bytes(
        "POST", env.require_filer() +
        f"/buckets/{urllib.parse.quote(name)}/")
    if st >= 300:
        raise RuntimeError(f"create bucket: HTTP {st} {body[:120]!r}")
    return f"created bucket {name}"


@command("s3.bucket.delete")
def cmd_s3_bucket_delete(env: CommandEnv, args: list[str]) -> str:
    """command_s3_bucket_delete.go (-name=... [-force] — a non-empty
    bucket needs -force, matching the reference's guard)."""
    opts = _parse_flags(args)
    name = opts.get("name", "")
    _check_bucket_name(name)
    # existence via the metadata lookup: the directory LISTING answers
    # 200-with-empty for missing paths, so it cannot distinguish
    # "no such bucket" from "empty bucket"
    st, _, _ = http_bytes(
        "GET", env.require_filer() + "/__meta__/lookup?path=" +
        urllib.parse.quote(f"/buckets/{name}"))
    if st == 404:
        raise RuntimeError(f"no bucket {name}")
    q = urllib.parse.quote(name)
    st, body, _ = http_bytes(
        "GET", env.require_filer() + f"/buckets/{q}/?limit=1")
    import json as _json
    entries = _json.loads(body).get("entries", []) if st == 200 else []
    if entries and "force" not in opts:
        raise RuntimeError(
            f"bucket {name} is not empty; pass -force")
    st, body, _ = http_bytes(
        "DELETE", env.require_filer() + f"/buckets/{q}?recursive=true")
    if st >= 300:
        raise RuntimeError(f"delete bucket: HTTP {st}")
    return f"deleted bucket {name}"


@command("s3.bucket.list")
def cmd_s3_bucket_list(env: CommandEnv, args: list[str]) -> str:
    st, body, _ = http_bytes(
        "GET", env.require_filer() + "/buckets/?limit=10000")
    if st == 404:
        return "no buckets"
    import json as _json
    out = []
    for e in _json.loads(body).get("entries", []):
        if e.get("isDirectory"):
            out.append(e["fullPath"].rsplit("/", 1)[-1])
    return "\n".join(sorted(out)) or "no buckets"


@command("s3.circuitBreaker")
def cmd_s3_circuit_breaker(env: CommandEnv, args: list[str]) -> str:
    """command_s3_circuitbreaker.go: edit the admission-control
    config at /etc/s3/circuit_breaker.json (the gateway TTL-reloads
    it).  Usage mirrors the reference:

        s3.circuitBreaker -global -type=count -actions=Read,Write
                          -values=500,200 -apply
        s3.circuitBreaker -buckets=x,y -type=mb -actions=Write
                          -values=64 -apply
        s3.circuitBreaker -global -disable -apply
        s3.circuitBreaker -buckets=x -delete -apply
        s3.circuitBreaker -delete -apply          # clear everything

    Without -apply the resulting config is printed, not written."""
    import json as _json
    from ..s3.circuit_breaker import CONFIG_PATH, CircuitBreaker
    opts = _parse_flags(args)
    fc = _client(env)
    e = fc.find_entry(CONFIG_PATH)
    doc = {}
    if e is not None:
        raw = fc.read_file(CONFIG_PATH)
        doc = _json.loads(raw) if raw else {}
    is_global = "global" in opts
    buckets = [b for b in opts.get("buckets", "").split(",") if b]
    if "delete" in opts:
        if buckets:
            for b in buckets:
                doc.get("buckets", {}).pop(b, None)
        elif is_global:
            doc.pop("global", None)
        else:
            doc = {}
    elif "disable" in opts:
        targets = ([doc.setdefault("buckets", {}).setdefault(
            b, {"actions": {}}) for b in buckets] if buckets
            else [doc.setdefault("global", {"actions": {}})])
        for t in targets:
            t["enabled"] = False
    else:
        ltype = {"count": "Count", "mb": "MB"}.get(
            opts.get("type", "count").lower())
        if ltype is None:
            raise RuntimeError("-type must be count or mb")
        actions = [a for a in opts.get("actions", "").split(",") if a]
        values = [v for v in opts.get("values", "").split(",") if v]
        if not actions or len(actions) != len(values):
            return ("usage: s3.circuitBreaker [-global|-buckets=x,y] "
                    "-type=count|mb -actions=Read,Write "
                    "-values=N,M -apply")
        entries = {f"{a}:{ltype}": int(v)
                   for a, v in zip(actions, values)}
        targets = ([doc.setdefault("buckets", {}).setdefault(
            b, {"enabled": True, "actions": {}}) for b in buckets]
            if buckets
            else [doc.setdefault("global",
                                 {"enabled": True, "actions": {}})])
        for t in targets:
            t["enabled"] = True
            t.setdefault("actions", {}).update(entries)
    CircuitBreaker().load(doc)        # validate before write/print
    rendered = _json.dumps(doc, indent=1)
    if "apply" not in opts:
        return rendered + "\n(dry run; add -apply to write)"
    fc.write_file(CONFIG_PATH, rendered.encode(),
                  mime="application/json")
    return f"applied:\n{rendered}"


# -- S3 Tables (command_s3tables_*.go): not ported ------------------------

def _s3tables_refused(name: str):
    def refuse(env: CommandEnv, args: list[str]) -> str:
        raise RuntimeError(f"{name}: S3 Tables is not ported "
                           f"(ROADMAP A3.4)")
    refuse.__name__ = "cmd_" + name.replace(".", "_")
    refuse.__doc__ = (f"{name} (command_{name.replace('.', '_')}.go): "
                      f"refused, as the gateway's S3 Tables target is")
    return refuse


for _name in ("s3tables.bucket", "s3tables.namespace", "s3tables.table",
              "s3tables.tag"):
    command(_name)(_s3tables_refused(_name))
