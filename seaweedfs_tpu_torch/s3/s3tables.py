"""S3 Tables (Iceberg table buckets) over the filer, the port's copy of
`seaweedfs_tpu/s3/s3tables.py` (the reference's weed/s3api/s3tables/).

Wire protocol (handler.go:88): POST / with an `X-Amz-Target:
S3Tables.<Operation>` header and a JSON body; errors are JSON
`{"__type": code, "message": ...}`.  22 operations over three
resource levels:

    table bucket   /buckets/<bucket>            (extended s3tables.tableBucket)
    namespace      /buckets/<bucket>/<ns>       (extended s3tables.namespace)
    table          /buckets/<bucket>/<ns>/<tbl> (extended s3tables.metadata)

plus resource policies (s3tables.policy) and tags (s3tables.tags) on
bucket and table entries, version-token optimistic concurrency on table
mutations (utils.go generateVersionToken), and the Iceberg file-layout
validator (iceberg_layout.go) that the gateway applies to object writes
into table buckets.  The extended-attribute keys and their JSON are the
JAX package's, so a filer written through either package's gateway reads
the same through the other's.

ARNs follow the reference (utils.go buildARN):
    arn:aws:s3tables:<region>:<account>:bucket/<name>
    arn:aws:s3tables:<region>:<account>:bucket/<name>/table/<ns>/<tbl>
"""

from __future__ import annotations

import json
import re
import secrets
import time

from ..filer.entry import Entry

DEFAULT_ACCOUNT = "000000000000"
DEFAULT_REGION = "us-east-1"
BUCKETS_ROOT = "/buckets"

X_TABLE_BUCKET = "s3tables.tableBucket"
X_NAMESPACE = "s3tables.namespace"
X_METADATA = "s3tables.metadata"
X_POLICY = "s3tables.policy"
X_TAGS = "s3tables.tags"

# utils.go validateBucketName: 3-63 chars, lowercase alnum + hyphen,
# alnum at both ends.  validateNamespacePart/validateTableName: 1-255
# chars, lowercase alnum + underscore, alnum at both ends.
_BUCKET_RE = re.compile(
    r"[a-z0-9](?:[a-z0-9\-]{1,61}[a-z0-9])?")
_PART_RE = re.compile(r"[a-z0-9](?:[a-z0-9_]{0,253}[a-z0-9])?")
_TAG_RE = re.compile(r"^[\w .:/=+\-@]+$")
_UUID = r"[a-f0-9]{8}-[a-f0-9]{4}-[a-f0-9]{4}-[a-f0-9]{4}-[a-f0-9]{12}"

# iceberg_layout.go: the two allowed table subtrees and their file
# shapes.  metadata/: versioned table metadata, snapshot manifest
# lists, manifests, version hint, stats.  data/: columnar files,
# optionally under partition directories (year=2024/...).
_META_FILES = [re.compile(p) for p in (
    r"^v\d+\.metadata\.json$",
    rf"^snap-\d+-\d+-{_UUID}\.avro$",
    rf"^{_UUID}-m\d+\.avro$",
    rf"^{_UUID}\.avro$",
    r"^version-hint\.text$",
    rf"^{_UUID}\.metadata\.json$",
    r"^[^/]+\.stats$",
)]
_DATA_FILES = [re.compile(p) for p in (
    r"^[^/]+\.parquet$", r"^[^/]+\.orc$", r"^[^/]+\.avro$")]
_PARTITION_DIR = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*=[^/]+$")


class S3TablesError(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = status
        self.code = code
        self.message = message


def _bad(msg: str) -> S3TablesError:
    return S3TablesError(400, "InvalidRequest", msg)


def _not_found(kind: str, what: str) -> S3TablesError:
    return S3TablesError(404, "NotFoundException",
                         f"{kind} {what} not found")


def _validate_name(name: str, kind: str) -> None:
    if kind == "bucket":
        if not name or len(name) < 3 or \
                not _BUCKET_RE.fullmatch(name):
            raise _bad(f"invalid bucket name {name!r} (3-63 chars, "
                       "lowercase alnum/hyphen, alnum ends)")
        return
    if not name or not _PART_RE.fullmatch(name):
        raise _bad(f"invalid {kind} name {name!r} (1-255 chars, "
                   "lowercase alnum/underscore, alnum ends)")


def _validate_tags(tags: dict) -> None:
    if len(tags) > 10:
        raise _bad(f"{len(tags)} tags; max 10")
    for k, v in tags.items():
        if not k or len(k) > 128 or not _TAG_RE.match(k):
            raise _bad(f"bad tag key {k!r}")
        if len(v) > 256 or (v and not _TAG_RE.match(v)):
            raise _bad(f"bad tag value {v!r}")


def validate_iceberg_key(key: str) -> "str | None":
    """None when `key` (namespace/table/...) is a valid write into an
    Iceberg table subtree; else the reason (iceberg_layout.go).  The
    caller has already resolved namespace and table existence."""
    parts = key.split("/")
    if len(parts) < 3:
        return ("objects in a table bucket live under "
                "<namespace>/<table>/{metadata,data}/...")
    subtree, rest = parts[2], parts[3:]
    if subtree not in ("metadata", "data"):
        return f"directory {subtree!r} not allowed (metadata|data)"
    if not rest:
        return "missing file name"
    fname = rest[-1]
    if subtree == "metadata":
        if len(rest) != 1:
            return "metadata/ holds files directly, no subdirs"
        if not any(p.match(fname) for p in _META_FILES):
            return f"{fname!r} is not a recognized metadata file"
        return None
    for d in rest[:-1]:
        if not _PARTITION_DIR.match(d) and \
                not re.fullmatch(r"[a-zA-Z0-9_\-]+", d):
            return f"bad partition directory {d!r}"
    if not any(p.match(fname) for p in _DATA_FILES):
        return f"{fname!r} is not a data file (parquet|orc|avro)"
    return None


def bucket_arn(name: str, region: str = DEFAULT_REGION,
               account: str = DEFAULT_ACCOUNT) -> str:
    return f"arn:aws:s3tables:{region}:{account}:bucket/{name}"


def table_arn(bucket: str, ns: str, table: str,
              region: str = DEFAULT_REGION,
              account: str = DEFAULT_ACCOUNT) -> str:
    return (f"arn:aws:s3tables:{region}:{account}:bucket/{bucket}"
            f"/table/{ns}/{table}")


def parse_bucket_arn(arn: str) -> str:
    """ARN or bare name -> bucket name (utils.go
    parseBucketNameFromARN accepts both)."""
    if not arn.startswith("arn:"):
        return arn
    tail = arn.split(":", 5)[-1]
    if not tail.startswith("bucket/"):
        raise _bad(f"not a table-bucket ARN: {arn}")
    return tail.split("/")[1]


def parse_table_arn(arn: str) -> tuple[str, str, str]:
    tail = arn.split(":", 5)[-1]
    m = re.fullmatch(r"bucket/([^/]+)/table/([^/]+)/([^/]+)", tail)
    if not m:
        raise _bad(f"not a table ARN: {arn}")
    return m.group(1), m.group(2), m.group(3)


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


def is_table_bucket(entry) -> bool:
    """bucket_metadata.go IsTableBucketEntry: the marker attribute
    separates table buckets from object-store buckets sharing
    /buckets."""
    return entry is not None and X_TABLE_BUCKET in \
        getattr(entry, "extended", {})


class S3TablesStore:
    """All 22 operations against a Filer-shaped backend (in-process
    Filer or FilerClient both work — find_entry/create_entry/
    list_directory/delete_entry)."""

    def __init__(self, filer, region: str = DEFAULT_REGION,
                 account: str = DEFAULT_ACCOUNT):
        self.filer = filer
        self.region = region
        self.account = account

    # -- entry helpers ----------------------------------------------------

    def _mkdir(self, path: str, extended: dict) -> None:
        e = Entry(path, is_directory=True)
        e.extended.update(extended)
        self.filer.create_entry(e)

    def _get(self, path: str):
        return self.filer.find_entry(path)

    def _patch(self, entry, **extended) -> None:
        for k, v in extended.items():
            if v is None:
                entry.extended.pop(k, None)
            else:
                entry.extended[k] = v
        self.filer.create_entry(entry, create_parents=False)

    def _list_all(self, directory: str, start_file: str = "",
                  prefix: str = ""):
        """PAGINATED directory walk: a flat list_directory(limit=N)
        call silently truncates past N children and the result looks
        complete — every S3Tables listing iterates through this."""
        last = start_file
        while True:
            batch = self.filer.list_directory(
                directory, start_file=last, limit=500, prefix=prefix)
            yield from batch
            if len(batch) < 500:
                return
            last = batch[-1].name

    def _bucket_entry(self, name: str):
        e = self._get(f"{BUCKETS_ROOT}/{name}")
        if e is None or not is_table_bucket(e):
            raise _not_found("table bucket", name)
        return e

    def _ns_entry(self, bucket: str, ns: str):
        self._bucket_entry(bucket)
        e = self._get(f"{BUCKETS_ROOT}/{bucket}/{ns}")
        if e is None or X_NAMESPACE not in e.extended:
            raise _not_found("namespace", f"{bucket}/{ns}")
        return e

    def _table_entry(self, bucket: str, ns: str, table: str):
        self._ns_entry(bucket, ns)
        e = self._get(f"{BUCKETS_ROOT}/{bucket}/{ns}/{table}")
        if e is None or X_METADATA not in e.extended:
            raise _not_found("table", f"{bucket}/{ns}/{table}")
        return e

    @staticmethod
    def _meta(entry, key: str) -> dict:
        raw = entry.extended.get(key, "")
        if isinstance(raw, bytes):
            raw = raw.decode()
        return json.loads(raw) if raw else {}

    # -- table buckets ----------------------------------------------------

    def create_table_bucket(self, name: str, owner: str = "",
                            tags: "dict | None" = None) -> dict:
        _validate_name(name, "bucket")
        if tags:
            _validate_tags(tags)
        existing = self._get(f"{BUCKETS_ROOT}/{name}")
        if existing is not None:
            code = "BucketAlreadyExists"
            kind = "table bucket" if is_table_bucket(existing) \
                else "object-store bucket"
            raise S3TablesError(409, code,
                                f"{kind} {name} already exists")
        meta = {"name": name, "createdAt": _iso(time.time()),
                "ownerAccountId": owner or self.account}
        ext = {X_TABLE_BUCKET: json.dumps(meta)}
        if tags:
            ext[X_TAGS] = json.dumps(tags)
        self._mkdir(f"{BUCKETS_ROOT}/{name}", ext)
        return {"arn": bucket_arn(name, self.region, self.account)}

    def get_table_bucket(self, arn: str) -> dict:
        name = parse_bucket_arn(arn)
        meta = self._meta(self._bucket_entry(name), X_TABLE_BUCKET)
        return {"arn": bucket_arn(name, self.region, self.account),
                "name": name,
                "ownerAccountId": meta.get("ownerAccountId",
                                           self.account),
                "createdAt": meta.get("createdAt", "")}

    def list_table_buckets(self, prefix: str = "",
                           continuation: str = "",
                           max_buckets: int = 0) -> dict:
        out, token = [], ""
        limit = max_buckets or 100
        for e in self._list_all(BUCKETS_ROOT, continuation, prefix):
            if not is_table_bucket(e):
                continue
            if len(out) >= limit:
                token = out[-1]["name"]
                break
            meta = self._meta(e, X_TABLE_BUCKET)
            out.append({"arn": bucket_arn(e.name, self.region,
                                          self.account),
                        "name": e.name,
                        "createdAt": meta.get("createdAt", "")})
        resp = {"tableBuckets": out}
        if token:
            resp["continuationToken"] = token
        return resp

    def delete_table_bucket(self, arn: str) -> dict:
        name = parse_bucket_arn(arn)
        self._bucket_entry(name)
        kids = self.filer.list_directory(f"{BUCKETS_ROOT}/{name}",
                                         limit=2)
        if kids:
            raise S3TablesError(
                409, "BucketNotEmpty",
                f"table bucket {name} still has namespaces")
        self.filer.delete_entry(f"{BUCKETS_ROOT}/{name}",
                                recursive=True)
        return {}

    # -- namespaces -------------------------------------------------------

    def create_namespace(self, bucket_arn_: str, namespace: list,
                         owner: str = "",
                         properties: "dict | None" = None) -> dict:
        bucket = parse_bucket_arn(bucket_arn_)
        self._bucket_entry(bucket)
        if not namespace or len(namespace) != 1:
            raise _bad("namespace must be a single-element list")
        ns = namespace[0]
        _validate_name(ns, "namespace")
        if self._get(f"{BUCKETS_ROOT}/{bucket}/{ns}") is not None:
            raise S3TablesError(409, "NamespaceAlreadyExists",
                                f"namespace {ns} already exists")
        meta = {"namespace": [ns], "createdAt": _iso(time.time()),
                "ownerAccountId": owner or self.account}
        if properties:
            meta["properties"] = properties
        self._mkdir(f"{BUCKETS_ROOT}/{bucket}/{ns}",
                    {X_NAMESPACE: json.dumps(meta)})
        return {"namespace": [ns],
                "tableBucketARN": bucket_arn(bucket, self.region,
                                             self.account)}

    def get_namespace(self, bucket_arn_: str, namespace: list) -> dict:
        bucket = parse_bucket_arn(bucket_arn_)
        ns = namespace[0] if namespace else ""
        meta = self._meta(self._ns_entry(bucket, ns), X_NAMESPACE)
        return {"namespace": [ns],
                "createdAt": meta.get("createdAt", ""),
                "ownerAccountId": meta.get("ownerAccountId",
                                           self.account),
                **({"properties": meta["properties"]}
                   if meta.get("properties") else {})}

    def list_namespaces(self, bucket_arn_: str, prefix: str = "",
                        continuation: str = "",
                        max_namespaces: int = 0) -> dict:
        bucket = parse_bucket_arn(bucket_arn_)
        self._bucket_entry(bucket)
        out, token = [], ""
        limit = max_namespaces or 100
        for e in self._list_all(f"{BUCKETS_ROOT}/{bucket}",
                                continuation, prefix):
            if X_NAMESPACE not in e.extended:
                continue
            if len(out) >= limit:
                token = out[-1]["namespace"][0]
                break
            meta = self._meta(e, X_NAMESPACE)
            out.append({"namespace": [e.name],
                        "createdAt": meta.get("createdAt", "")})
        resp = {"namespaces": out}
        if token:
            resp["continuationToken"] = token
        return resp

    def delete_namespace(self, bucket_arn_: str,
                         namespace: list) -> dict:
        bucket = parse_bucket_arn(bucket_arn_)
        ns = namespace[0] if namespace else ""
        self._ns_entry(bucket, ns)
        kids = self.filer.list_directory(
            f"{BUCKETS_ROOT}/{bucket}/{ns}", limit=2)
        if kids:
            raise S3TablesError(409, "NamespaceNotEmpty",
                                f"namespace {ns} still has tables")
        self.filer.delete_entry(f"{BUCKETS_ROOT}/{bucket}/{ns}",
                                recursive=True)
        return {}

    # -- tables -----------------------------------------------------------

    def create_table(self, bucket_arn_: str, namespace: list,
                     name: str, fmt: str = "ICEBERG",
                     metadata: "dict | None" = None,
                     metadata_location: str = "",
                     owner: str = "",
                     tags: "dict | None" = None) -> dict:
        bucket = parse_bucket_arn(bucket_arn_)
        ns = namespace[0] if namespace else ""
        self._ns_entry(bucket, ns)
        _validate_name(name, "table")
        if fmt and fmt.upper() != "ICEBERG":
            raise _bad(f"unsupported table format {fmt!r}")
        if tags:
            _validate_tags(tags)
        path = f"{BUCKETS_ROOT}/{bucket}/{ns}/{name}"
        if self._get(path) is not None:
            raise S3TablesError(409, "TableAlreadyExists",
                                f"table {name} already exists")
        now = _iso(time.time())
        token = secrets.token_hex(16)
        internal = {"name": name, "namespace": ns,
                    "format": "ICEBERG", "createdAt": now,
                    "modifiedAt": now,
                    "ownerAccountId": owner or self.account,
                    "versionToken": token, "metadataVersion": 1,
                    "metadataLocation": metadata_location,
                    "metadata": metadata}
        ext = {X_METADATA: json.dumps(internal)}
        if tags:
            ext[X_TAGS] = json.dumps(tags)
        self._mkdir(path, ext)
        # the Iceberg subtrees exist from birth so clients can write
        # metadata/v1.metadata.json immediately
        self._mkdir(path + "/metadata", {})
        self._mkdir(path + "/data", {})
        arn = table_arn(bucket, ns, name, self.region, self.account)
        resp = {"tableARN": arn, "versionToken": token}
        if metadata_location:
            resp["metadataLocation"] = metadata_location
        return resp

    def get_table(self, bucket_arn_: str = "", namespace=None,
                  name: str = "", table_arn_: str = "") -> dict:
        if table_arn_:
            bucket, ns, name = parse_table_arn(table_arn_)
        else:
            bucket = parse_bucket_arn(bucket_arn_)
            ns = namespace[0] if namespace else ""
        meta = self._meta(self._table_entry(bucket, ns, name),
                          X_METADATA)
        return {"name": name,
                "tableARN": table_arn(bucket, ns, name, self.region,
                                      self.account),
                "namespace": [ns], "format": "ICEBERG",
                "createdAt": meta.get("createdAt", ""),
                "modifiedAt": meta.get("modifiedAt", ""),
                "ownerAccountId": meta.get("ownerAccountId",
                                           self.account),
                "metadataLocation": meta.get("metadataLocation", ""),
                "versionToken": meta.get("versionToken", ""),
                "metadataVersion": meta.get("metadataVersion", 1),
                **({"metadata": meta["metadata"]}
                   if meta.get("metadata") else {})}

    def list_tables(self, bucket_arn_: str, namespace=None,
                    prefix: str = "", continuation: str = "",
                    max_tables: int = 0) -> dict:
        bucket = parse_bucket_arn(bucket_arn_)
        self._bucket_entry(bucket)
        if namespace:
            spaces = [namespace[0]]
        else:
            # enumerate EVERY namespace dir (paginated — the capped
            # list_namespaces API call would silently drop tables of
            # namespaces past its page size)
            spaces = [e.name for e in
                      self._list_all(f"{BUCKETS_ROOT}/{bucket}")
                      if X_NAMESPACE in e.extended]
        # the continuation token is namespace-QUALIFIED ("ns/table"):
        # a bare table name applied as start_file to every namespace
        # would silently skip any later namespace's tables that sort
        # below it
        cont_ns, _, cont_name = continuation.partition("/")
        out, token = [], ""
        limit = max_tables or 100
        for ns in spaces:
            if continuation and ns < cont_ns:
                continue
            start = cont_name if continuation and ns == cont_ns \
                else ""
            if token:
                break           # page full: no more listing calls
            for e in self._list_all(f"{BUCKETS_ROOT}/{bucket}/{ns}",
                                    start, prefix):
                if X_METADATA not in e.extended:
                    continue
                if len(out) >= limit:
                    token = f"{ns}/{out[-1]['name']}" \
                        if out and out[-1]["namespace"] == [ns] \
                        else f"{ns}/"
                    break
                meta = self._meta(e, X_METADATA)
                out.append({
                    "name": e.name,
                    "tableARN": table_arn(bucket, ns, e.name,
                                          self.region, self.account),
                    "namespace": [ns],
                    "createdAt": meta.get("createdAt", ""),
                    "modifiedAt": meta.get("modifiedAt", ""),
                    "metadataLocation":
                        meta.get("metadataLocation", "")})
        resp = {"tables": out}
        if token:
            resp["continuationToken"] = token
        return resp

    def update_table(self, bucket_arn_: str, namespace: list,
                     name: str, version_token: str = "",
                     metadata: "dict | None" = None,
                     metadata_location: str = "") -> dict:
        bucket = parse_bucket_arn(bucket_arn_)
        ns = namespace[0] if namespace else ""
        entry = self._table_entry(bucket, ns, name)
        meta = self._meta(entry, X_METADATA)
        if version_token and \
                version_token != meta.get("versionToken"):
            raise S3TablesError(409, "ConflictException",
                                "version token mismatch")
        new_token = secrets.token_hex(16)
        meta["versionToken"] = new_token
        meta["modifiedAt"] = _iso(time.time())
        meta["metadataVersion"] = meta.get("metadataVersion", 1) + 1
        if metadata is not None:
            meta["metadata"] = metadata
        if metadata_location:
            meta["metadataLocation"] = metadata_location
        self._patch(entry, **{X_METADATA: json.dumps(meta)})
        resp = {"tableARN": table_arn(bucket, ns, name, self.region,
                                      self.account),
                "versionToken": new_token}
        if meta.get("metadataLocation"):
            resp["metadataLocation"] = meta["metadataLocation"]
        return resp

    def delete_table(self, bucket_arn_: str, namespace: list,
                     name: str, version_token: str = "") -> dict:
        bucket = parse_bucket_arn(bucket_arn_)
        ns = namespace[0] if namespace else ""
        entry = self._table_entry(bucket, ns, name)
        meta = self._meta(entry, X_METADATA)
        if version_token and \
                version_token != meta.get("versionToken"):
            raise S3TablesError(409, "ConflictException",
                                "version token mismatch")
        self.filer.delete_entry(
            f"{BUCKETS_ROOT}/{bucket}/{ns}/{name}", recursive=True)
        return {}

    # -- resource policies ------------------------------------------------

    def _policy_target(self, bucket_arn_: str = "", namespace=None,
                       name: str = ""):
        if name:
            bucket = parse_bucket_arn(bucket_arn_)
            return self._table_entry(
                bucket, namespace[0] if namespace else "", name)
        return self._bucket_entry(parse_bucket_arn(bucket_arn_))

    def put_policy(self, policy: str, **target) -> dict:
        try:
            json.loads(policy)
        except ValueError:
            raise _bad("resourcePolicy is not valid JSON")
        entry = self._policy_target(**target)
        self._patch(entry, **{X_POLICY: policy})
        return {}

    def get_policy(self, **target) -> dict:
        entry = self._policy_target(**target)
        raw = entry.extended.get(X_POLICY, "")
        if isinstance(raw, bytes):
            raw = raw.decode()
        if not raw:
            raise _not_found("policy", "resource policy")
        return {"resourcePolicy": raw}

    def delete_policy(self, **target) -> dict:
        entry = self._policy_target(**target)
        self._patch(entry, **{X_POLICY: None})
        return {}

    # -- tags -------------------------------------------------------------

    def _arn_entry(self, arn: str):
        tail = arn.split(":", 5)[-1] if arn.startswith("arn:") else ""
        if "/table/" in tail:
            bucket, ns, table = parse_table_arn(arn)
            return self._table_entry(bucket, ns, table)
        return self._bucket_entry(parse_bucket_arn(arn))

    def tag_resource(self, arn: str, tags: dict) -> dict:
        entry = self._arn_entry(arn)
        merged = self._meta(entry, X_TAGS)
        merged.update(tags or {})
        _validate_tags(merged)
        self._patch(entry, **{X_TAGS: json.dumps(merged)})
        return {}

    def list_tags(self, arn: str) -> dict:
        return {"tags": self._meta(self._arn_entry(arn), X_TAGS)}

    def untag_resource(self, arn: str, keys: list) -> dict:
        entry = self._arn_entry(arn)
        tags = self._meta(entry, X_TAGS)
        for k in keys or []:
            tags.pop(k, None)
        self._patch(entry, **{X_TAGS: json.dumps(tags) if tags
                              else None})
        return {}


# -- HTTP dispatch ---------------------------------------------------------

def handle_request(store: S3TablesStore, operation: str,
                   body: dict) -> dict:
    """X-Amz-Target operation name -> store call (handler.go:106's
    switch).  Raises S3TablesError for protocol errors."""
    ops = {
        "CreateTableBucket": lambda: store.create_table_bucket(
            body.get("name", ""), tags=body.get("tags")),
        "GetTableBucket": lambda: store.get_table_bucket(
            body.get("tableBucketARN", "")),
        "ListTableBuckets": lambda: store.list_table_buckets(
            body.get("prefix", ""), body.get("continuationToken", ""),
            int(body.get("maxBuckets") or 0)),
        "DeleteTableBucket": lambda: store.delete_table_bucket(
            body.get("tableBucketARN", "")),
        "PutTableBucketPolicy": lambda: store.put_policy(
            body.get("resourcePolicy", ""),
            bucket_arn_=body.get("tableBucketARN", "")),
        "GetTableBucketPolicy": lambda: store.get_policy(
            bucket_arn_=body.get("tableBucketARN", "")),
        "DeleteTableBucketPolicy": lambda: store.delete_policy(
            bucket_arn_=body.get("tableBucketARN", "")),
        "CreateNamespace": lambda: store.create_namespace(
            body.get("tableBucketARN", ""),
            body.get("namespace") or [],
            properties=body.get("properties")),
        "GetNamespace": lambda: store.get_namespace(
            body.get("tableBucketARN", ""),
            body.get("namespace") or []),
        "ListNamespaces": lambda: store.list_namespaces(
            body.get("tableBucketARN", ""), body.get("prefix", ""),
            body.get("continuationToken", ""),
            int(body.get("maxNamespaces") or 0)),
        "DeleteNamespace": lambda: store.delete_namespace(
            body.get("tableBucketARN", ""),
            body.get("namespace") or []),
        "CreateTable": lambda: store.create_table(
            body.get("tableBucketARN", ""),
            body.get("namespace") or [], body.get("name", ""),
            body.get("format", "ICEBERG"), body.get("metadata"),
            body.get("metadataLocation", ""),
            tags=body.get("tags")),
        "GetTable": lambda: store.get_table(
            body.get("tableBucketARN", ""), body.get("namespace"),
            body.get("name", ""), body.get("tableARN", "")),
        "ListTables": lambda: store.list_tables(
            body.get("tableBucketARN", ""), body.get("namespace"),
            body.get("prefix", ""),
            body.get("continuationToken", ""),
            int(body.get("maxTables") or 0)),
        "UpdateTable": lambda: store.update_table(
            body.get("tableBucketARN", ""),
            body.get("namespace") or [], body.get("name", ""),
            body.get("versionToken", ""), body.get("metadata"),
            body.get("metadataLocation", "")),
        "DeleteTable": lambda: store.delete_table(
            body.get("tableBucketARN", ""),
            body.get("namespace") or [], body.get("name", ""),
            body.get("versionToken", "")),
        "PutTablePolicy": lambda: store.put_policy(
            body.get("resourcePolicy", ""),
            bucket_arn_=body.get("tableBucketARN", ""),
            namespace=body.get("namespace"),
            name=body.get("name", "")),
        "GetTablePolicy": lambda: store.get_policy(
            bucket_arn_=body.get("tableBucketARN", ""),
            namespace=body.get("namespace"),
            name=body.get("name", "")),
        "DeleteTablePolicy": lambda: store.delete_policy(
            bucket_arn_=body.get("tableBucketARN", ""),
            namespace=body.get("namespace"),
            name=body.get("name", "")),
        "TagResource": lambda: store.tag_resource(
            body.get("resourceArn", ""), body.get("tags") or {}),
        "ListTagsForResource": lambda: store.list_tags(
            body.get("resourceArn", "")),
        "UntagResource": lambda: store.untag_resource(
            body.get("resourceArn", ""), body.get("tagKeys") or []),
    }
    fn = ops.get(operation)
    if fn is None:
        raise _bad(f"unknown S3Tables operation {operation!r}")
    return fn()
