"""s3.* shell family, the port's copy of `seaweedfs_tpu/shell/
s3_commands.py` (reference: weed/shell/command_s3_bucket_quota*.go +
the lifecycle enforcement pass):

    s3.bucket.quota          -bucket=b [-limitMB=N | -remove]
    s3.bucket.quota.enforce  flips over-quota buckets read-only (and
                             back) — the reference's
                             s3.bucket.quota.enforce
    s3.lifecycle.apply       one enforcement pass over every bucket
                             with a lifecycle configuration

with `s3.bucket.create` / `.delete` / `.list` and `s3.circuitBreaker`,
and the S3 Tables verbs over the filer (command_s3tables_*.go,
`s3/s3tables.S3TablesStore`):

    s3tables.bucket     -create|-list|-get|-delete|-put-policy|
                        -get-policy|-delete-policy -name=B
    s3tables.namespace  -bucket=B -create|-list|-get|-delete [-name=NS]
    s3tables.table      -bucket=B -namespace=NS -create|-list|-get|
                        -update|-delete [-name=T] [-metadataFile=F]
    s3tables.tag        -resource=ARN -set=k=v,...|-unset=k,...|-list
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


# -- S3 Tables (command_s3tables_*.go) ------------------------------------

def _s3tables_store(env: CommandEnv):
    from ..s3.s3tables import S3TablesStore
    return S3TablesStore(_client(env))


@command("s3tables.bucket")
def cmd_s3tables_bucket(env: CommandEnv, args: list[str]) -> str:
    """command_s3tables_bucket.go: manage table buckets.

        s3tables.bucket -create -name=B [-tags=k1=v1,k2=v2]
        s3tables.bucket -list [-prefix=P]
        s3tables.bucket -get -name=B
        s3tables.bucket -delete -name=B
        s3tables.bucket -put-policy -name=B -file=policy.json
        s3tables.bucket -get-policy -name=B
        s3tables.bucket -delete-policy -name=B"""
    import json as _json
    from ..s3.s3tables import S3TablesError
    opts = _parse_flags(args)
    st = _s3tables_store(env)
    name = opts.get("name", "")
    try:
        if "create" in opts:
            tags = dict(kv.split("=", 1) for kv in
                        opts.get("tags", "").split(",") if "=" in kv)
            r = st.create_table_bucket(name, tags=tags or None)
            return _json.dumps(r, indent=1)
        if "list" in opts:
            r = st.list_table_buckets(opts.get("prefix", ""),
                                      opts.get("continuation", ""),
                                      int(opts.get("limit", 0)))
            return _json.dumps(r, indent=1)
        if "get" in opts:
            return _json.dumps(st.get_table_bucket(name), indent=1)
        if "delete-policy" in opts:
            st.delete_policy(bucket_arn_=name)
            return f"deleted policy of {name}"
        if "delete" in opts:
            st.delete_table_bucket(name)
            return f"deleted table bucket {name}"
        if "put-policy" in opts:
            with open(opts["file"]) as f:
                st.put_policy(f.read(), bucket_arn_=name)
            return f"policy applied to {name}"
        if "get-policy" in opts:
            return st.get_policy(bucket_arn_=name)["resourcePolicy"]
    except S3TablesError as e:
        raise RuntimeError(f"{e.code}: {e.message}")
    return ("usage: s3tables.bucket -create|-list|-get|-delete|"
            "-put-policy|-get-policy|-delete-policy -name=B")


@command("s3tables.namespace")
def cmd_s3tables_namespace(env: CommandEnv, args: list[str]) -> str:
    """command_s3tables_namespace.go: namespaces inside a table
    bucket (-bucket=B -create|-list|-get|-delete [-name=NS])."""
    import json as _json
    from ..s3.s3tables import S3TablesError
    opts = _parse_flags(args)
    st = _s3tables_store(env)
    bucket, ns = opts.get("bucket", ""), opts.get("name", "")
    try:
        if "create" in opts:
            return _json.dumps(st.create_namespace(bucket, [ns]),
                               indent=1)
        if "list" in opts:
            return _json.dumps(
                st.list_namespaces(bucket, opts.get("prefix", "")),
                indent=1)
        if "get" in opts:
            return _json.dumps(st.get_namespace(bucket, [ns]),
                               indent=1)
        if "delete" in opts:
            st.delete_namespace(bucket, [ns])
            return f"deleted namespace {ns}"
    except S3TablesError as e:
        raise RuntimeError(f"{e.code}: {e.message}")
    return ("usage: s3tables.namespace -bucket=B "
            "-create|-list|-get|-delete [-name=NS]")


@command("s3tables.table")
def cmd_s3tables_table(env: CommandEnv, args: list[str]) -> str:
    """command_s3tables_table.go: tables inside a namespace
    (-bucket=B -namespace=NS -create|-list|-get|-delete|-update
    [-name=T] [-metadataFile=m.json] [-versionToken=V])."""
    import json as _json
    from ..s3.s3tables import S3TablesError
    opts = _parse_flags(args)
    st = _s3tables_store(env)
    bucket = opts.get("bucket", "")
    ns = [opts["namespace"]] if opts.get("namespace") else []
    name = opts.get("name", "")
    meta = None
    if opts.get("metadataFile"):
        with open(opts["metadataFile"]) as f:
            meta = _json.load(f)
    try:
        if "create" in opts:
            return _json.dumps(
                st.create_table(bucket, ns, name, metadata=meta),
                indent=1)
        if "list" in opts:
            return _json.dumps(
                st.list_tables(bucket, ns or None,
                               opts.get("prefix", "")), indent=1)
        if "get" in opts:
            return _json.dumps(st.get_table(bucket, ns, name),
                               indent=1)
        if "update" in opts:
            return _json.dumps(st.update_table(
                bucket, ns, name, opts.get("versionToken", ""),
                meta), indent=1)
        if "delete" in opts:
            st.delete_table(bucket, ns, name,
                            opts.get("versionToken", ""))
            return f"deleted table {name}"
    except S3TablesError as e:
        raise RuntimeError(f"{e.code}: {e.message}")
    return ("usage: s3tables.table -bucket=B -namespace=NS "
            "-create|-list|-get|-update|-delete [-name=T]")


@command("s3tables.tag")
def cmd_s3tables_tag(env: CommandEnv, args: list[str]) -> str:
    """command_s3tables_tag.go: tag table buckets/tables by ARN or
    bucket name (-resource=ARN -set=k=v,... | -list | -unset=k1,k2)."""
    import json as _json
    from ..s3.s3tables import S3TablesError
    opts = _parse_flags(args)
    st = _s3tables_store(env)
    arn = opts.get("resource", "")
    try:
        if opts.get("set"):
            tags = dict(kv.split("=", 1) for kv in
                        opts["set"].split(",") if "=" in kv)
            st.tag_resource(arn, tags)
            return f"tagged {arn}"
        if opts.get("unset"):
            st.untag_resource(arn, opts["unset"].split(","))
            return f"untagged {arn}"
        if "list" in opts:
            return _json.dumps(st.list_tags(arn), indent=1)
    except S3TablesError as e:
        raise RuntimeError(f"{e.code}: {e.message}")
    return "usage: s3tables.tag -resource=ARN -set=k=v|-unset=k|-list"
