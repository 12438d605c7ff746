"""S3-compatible remote storage client + mount bookkeeping
(weed/remote_storage/s3/s3_storage_client.go,
weed/command/filer_remote_mount.go), the port's copy of
`seaweedfs_tpu/remote/remote_storage.py`.

The conf's wire twin, `/etc/remote/<name>.remote.conf`, is the
reference's `remote_pb.RemoteConf` protobuf (the JAX package's
`pb/protos/remote.proto`), written and read by the encoder below, which
needs no protobuf package; the port always writes it.

The client signs with our own SigV4 signer, so it talks to ANY
S3-compatible endpoint — including our own gateway, which is what the
tests (and the reference's) point it at.
"""

from __future__ import annotations

import json
import urllib.parse
import xml.etree.ElementTree as ET

from ..s3.auth import sign_request
from ..server.httpd import http_bytes

CONF_DIR = "/etc/remote"
MOUNTS_PATH = "/etc/remote/mounts.json"


class RemoteError(OSError):
    pass


class S3RemoteStorage:
    """remote_storage.RemoteStorageClient, S3 flavor."""

    def __init__(self, endpoint: str, access_key: str,
                 secret_key: str, bucket: str):
        self.endpoint = endpoint.removeprefix("http://")
        self.access_key = access_key
        self.secret_key = secret_key
        self.bucket = bucket

    @classmethod
    def from_conf(cls, conf: dict, bucket: str = "") -> "S3RemoteStorage":
        return cls(conf["endpoint"], conf.get("accessKey", ""),
                   conf.get("secretKey", ""),
                   bucket or conf.get("bucket", ""))

    def _call(self, method: str, key: str, body: bytes = b"",
              query: dict | None = None, headers: dict | None = None
              ) -> "tuple[int, bytes, dict]":
        path = f"/{self.bucket}/{key}" if key else f"/{self.bucket}"
        q = dict(query or {})
        signed = sign_request(method, self.endpoint, path, q,
                              dict(headers or {}), body,
                              self.access_key, self.secret_key)
        qs = ("?" + urllib.parse.urlencode(q)) if q else ""
        return http_bytes(method, f"{self.endpoint}" +
                          urllib.parse.quote(path) + qs,
                          body or None, signed)

    # -- objects -----------------------------------------------------------

    def traverse(self, prefix: str = ""):
        """Yield (key, size, mtime_iso, etag) under prefix
        (ListObjectsV2 pagination)."""
        token = ""
        while True:
            q = {"list-type": "2", "prefix": prefix,
                 "max-keys": "1000"}
            if token:
                q["continuation-token"] = token
            st, body, _ = self._call("GET", "", query=q)
            if st != 200:
                raise RemoteError(f"list {self.bucket}/{prefix}: {st}")
            root = ET.fromstring(body)
            ns = root.tag.split("}")[0] + "}" if "}" in root.tag else ""
            for c in root.iter(f"{ns}Contents"):
                fields = {el.tag.rsplit("}", 1)[-1]: (el.text or "")
                          for el in c}
                yield (fields["Key"], int(fields.get("Size", 0)),
                       fields.get("LastModified", ""),
                       fields.get("ETag", "").strip('"'))
            token = ""
            for el in root.iter(f"{ns}NextContinuationToken"):
                token = el.text or ""
            if not token:
                return

    def read(self, key: str, offset: int = 0,
             size: "int | None" = None) -> bytes:
        headers = {}
        if offset or size is not None:
            end = "" if size is None else str(offset + size - 1)
            headers["range"] = f"bytes={offset}-{end}"
        st, body, _ = self._call("GET", key, headers=headers)
        if st == 404:
            raise FileNotFoundError(f"{self.bucket}/{key}")
        if st not in (200, 206):
            raise RemoteError(f"read {self.bucket}/{key}: {st}")
        if st == 200 and (offset or size is not None):
            # endpoint ignored Range: slice locally
            body = body[offset:offset + size if size else None]
        return body

    def write(self, key: str, data: bytes) -> None:
        st, body, _ = self._call("PUT", key, data)
        if st != 200:
            raise RemoteError(f"write {self.bucket}/{key}: {st} "
                              f"{body[:200]!r}")

    def delete(self, key: str) -> None:
        st, _, _ = self._call("DELETE", key)
        if st not in (200, 204, 404):
            raise RemoteError(f"delete {self.bucket}/{key}: {st}")

    def stat(self, key: str) -> "dict | None":
        st, _, h = self._call("HEAD", key)
        if st == 404:
            return None
        if st != 200:
            raise RemoteError(f"stat {self.bucket}/{key}: {st}")
        return {"size": int(h.get("Content-Length", 0)),
                "etag": h.get("ETag", "").strip('"')}

    def list_buckets(self) -> "list[str]":
        """GET / (S3 ListBuckets) on the remote endpoint — the one
        service-level call, signed for path "/" (no bucket prefix)."""
        import re as _re
        signed = sign_request("GET", self.endpoint, "/", {}, {}, b"",
                              self.access_key, self.secret_key)
        status, body, _ = http_bytes(
            "GET", f"{self.endpoint}/", None, signed)
        if status != 200:
            raise RemoteError(f"list buckets: {status}")
        return _re.findall(r"<Name>([^<]+)</Name>", body.decode(
            "utf-8", "replace"))

    def create_bucket(self) -> None:
        st, _, _ = self._call("PUT", "")
        if st not in (200, 409):
            raise RemoteError(f"create bucket {self.bucket}: {st}")


# -- conf + mount bookkeeping (stored IN the filer) ------------------------

# remote_pb.RemoteConf: field number -> (our JSON key, kind); the
# strings and bools of the S3, GCS, Azure and Backblaze families
_PB_FIELDS = {
    1: ("type", "str"), 2: ("name", "str"),
    4: ("accessKey", "str"), 5: ("secretKey", "str"),
    6: ("region", "str"), 7: ("endpoint", "str"),
    8: ("storageClass", "str"), 9: ("forcePathStyle", "bool"),
    10: ("gcsCredentials", "str"), 11: ("v4Signature", "bool"),
    12: ("gcsProjectId", "str"), 15: ("azureAccountName", "str"),
    16: ("azureAccountKey", "str"), 20: ("backblazeKeyId", "str"),
    21: ("backblazeApplicationKey", "str"),
    22: ("backblazeEndpoint", "str"), 23: ("backblazeRegion", "str"),
}


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, i: int) -> "tuple[int, int]":
    n = shift = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def encode_remote_conf(fields: dict) -> bytes:
    """RemoteConf wire bytes from {field number: value}, proto3 style:
    fields in number order, empty strings and false bools left out."""
    out = bytearray()
    for num in sorted(fields):
        kind = _PB_FIELDS[num][1]
        v = fields[num]
        if kind == "bool":
            if v:
                out += _varint(num << 3) + b"\x01"
        elif v:
            raw = str(v).encode()
            out += _varint(num << 3 | 2) + _varint(len(raw)) + raw
    return bytes(out)


def decode_remote_conf(data: bytes) -> dict:
    """{field number: value} of RemoteConf bytes; fields this module
    does not know are skipped, as protobuf does."""
    out: dict = {}
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 2:
            n, i = _read_varint(data, i)
            if i + n > len(data):
                raise ValueError("truncated field")
            v, i = data[i:i + n], i + n
        elif wire == 5:
            v, i = data[i:i + 4], i + 4
        elif wire == 1:
            v, i = data[i:i + 8], i + 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if num in _PB_FIELDS:
            kind = _PB_FIELDS[num][1]
            out[num] = bool(v) if kind == "bool" else \
                bytes(v).decode("utf-8")
    return out


def conf_to_pb_bytes(name: str, conf: dict) -> bytes:
    """Our JSON conf -> the reference's remote_pb.RemoteConf wire
    bytes (the reference persists this form at
    /etc/remote/<name>.remote.conf); the JAX package's fields."""
    return encode_remote_conf({
        1: conf.get("type", "s3"), 2: name,
        4: conf.get("accessKey", ""), 5: conf.get("secretKey", ""),
        6: conf.get("region", ""), 7: conf.get("endpoint", ""),
        9: bool(conf.get("forcePathStyle", True)),
        11: bool(conf.get("v4Signature", True))})


def conf_from_pb_bytes(data: bytes) -> dict:
    pb = decode_remote_conf(data)
    return {"type": pb.get(1) or "s3", "endpoint": pb.get(7, ""),
            "accessKey": pb.get(4, ""), "secretKey": pb.get(5, ""),
            "region": pb.get(6, ""),
            "forcePathStyle": pb.get(9, False),
            "v4Signature": pb.get(11, False)}


def save_conf(filer: str, name: str, conf: dict) -> None:
    st, _, _ = http_bytes(
        "PUT", f"{filer}{CONF_DIR}/{name}.conf",
        json.dumps(conf).encode())
    if st not in (200, 201):
        raise RemoteError(f"save remote conf {name}: {st}")
    # wire-form twin beside it so a reference deployment reading this
    # filer tree finds the config in its own format
    st, _, _ = http_bytes("PUT", f"{filer}{CONF_DIR}/{name}.remote.conf",
                          conf_to_pb_bytes(name, conf))
    if st not in (200, 201):
        raise RemoteError(f"save remote conf {name} (wire form): {st}")


def load_conf(filer: str, name: str) -> dict:
    st, body, _ = http_bytes("GET", f"{filer}{CONF_DIR}/{name}.conf")
    if st == 200:
        return json.loads(body)
    # fall back to the reference's protobuf conf (a tree configured
    # by the reference's `remote.configure` works as-is)
    st, body, _ = http_bytes(
        "GET", f"{filer}{CONF_DIR}/{name}.remote.conf")
    if st == 200:
        try:
            return conf_from_pb_bytes(body)
        except (ValueError, UnicodeDecodeError) as e:
            raise RemoteError(
                f"undecodable remote conf {name!r}: {e}") from e
    raise RemoteError(f"no remote conf {name!r} ({st})")


def load_mounts(filer: str) -> dict:
    st, body, _ = http_bytes("GET", f"{filer}{MOUNTS_PATH}")
    if st != 200:
        return {}
    return json.loads(body)


def save_mounts(filer: str, mounts: dict) -> None:
    st, _, _ = http_bytes("PUT", f"{filer}{MOUNTS_PATH}",
                          json.dumps(mounts, indent=1).encode())
    if st not in (200, 201):
        raise RemoteError(f"save mounts: {st}")


def remote_for_path(filer: str, path: str
                    ) -> "tuple[S3RemoteStorage, str] | None":
    """(client, remote_key) for a filer path under a mount, else
    None.  Longest mount prefix wins."""
    mounts = load_mounts(filer)
    best = None
    for d in mounts:
        cd = d.rstrip("/")
        if (path == cd or path.startswith(cd + "/")) and \
                (best is None or len(cd) > len(best)):
            best = cd
    if best is None:
        return None
    m = mounts[best]
    conf = load_conf(filer, m["conf"])
    client = S3RemoteStorage.from_conf(conf, m.get("bucket", ""))
    rel = path[len(best):].lstrip("/")
    prefix = m.get("keyPrefix", "")
    key = (prefix.rstrip("/") + "/" + rel).lstrip("/") if prefix \
        else rel
    return client, key


def _remote_marker(size: int, etag: str = "") -> str:
    return json.dumps({"size": size, "etag": etag})


def mount_remote(filer: str, directory: str, conf_name: str,
                 bucket: str, key_prefix: str = "") -> int:
    """Record the mount and pull remote metadata into filer entries
    (filer_remote_mount.go syncMetadata): each object becomes an
    entry with a remote pointer and NO chunks.  Returns entry count."""
    conf = load_conf(filer, conf_name)
    client = S3RemoteStorage.from_conf(conf, bucket)
    mounts = load_mounts(filer)
    mounts[directory.rstrip("/")] = {"conf": conf_name,
                                     "bucket": bucket,
                                     "keyPrefix": key_prefix}
    save_mounts(filer, mounts)
    n = 0
    for key, size, _mtime, etag in client.traverse(key_prefix):
        rel = key[len(key_prefix):].lstrip("/") if key_prefix else key
        if not rel or rel.endswith("/"):
            continue
        path = f"{directory.rstrip('/')}/{rel}"
        marker = _remote_marker(size, etag)
        # syncMetadata semantics: only touch entries whose remote
        # pointer CHANGED, and never replace a purely-local file —
        # an entry with chunks but NO remote marker is a local edit
        # not yet pushed; clobbering it would lose data
        existing = _meta_lookup(filer, path)
        if existing is not None:
            ext_marker = existing.get("extended", {}).get("remote")
            if ext_marker == marker:
                n += 1
                continue
            if ext_marker is None and existing.get("chunks"):
                n += 1     # local file shadows the remote one
                continue
        _meta_create(filer, path, {"remote": marker})
        n += 1
    return n


def _meta_lookup(filer: str, path: str) -> "dict | None":
    st, body, _ = http_bytes(
        "GET", f"{filer}/__meta__/lookup?path=" +
        urllib.parse.quote(path))
    return json.loads(body) if st == 200 else None


def _meta_create(filer: str, path: str, extended: dict) -> None:
    st, _, _ = http_bytes(
        "POST", f"{filer}/__meta__/create",
        json.dumps({"path": path, "extended": extended}).encode(),
        {"Content-Type": "application/json"})
    if st != 200:
        raise RemoteError(f"meta create {path}: {st}")


def cache_path(filer: str, path: str,
               located: "tuple[S3RemoteStorage, str] | None" = None
               ) -> int:
    """Materialize remote content into local chunks (remote.cache):
    returns bytes cached.  The ORIGINAL remote marker is re-attached
    verbatim — inventing a new one (e.g. without the etag) would make
    the next meta.sync see a "changed" pointer and evict the cache.
    `located` lets bulk callers resolve the mount once."""
    entry = _meta_lookup(filer, path)
    marker = (entry or {}).get("extended", {}).get("remote")
    if marker is None:
        raise RemoteError(f"{path} is not remote-backed")
    if located is None:
        located = remote_for_path(filer, path)
        if located is None:
            raise RemoteError(f"{path} is not under a remote mount")
    client, key = located
    data = client.read(key)
    st, _, _ = http_bytes("PUT", filer + urllib.parse.quote(path),
                          data)
    if st not in (200, 201):
        raise RemoteError(f"cache write {path}: {st}")
    # content PUT rebuilt the entry: re-attach the SAME marker
    _meta_patch_extended(filer, path, {"remote": marker})
    return len(data)


def uncache_path(filer: str, path: str) -> None:
    """Drop local chunks, keep the remote-backed entry
    (remote.uncache)."""
    st, body, _ = http_bytes(
        "GET", f"{filer}/__meta__/lookup?path=" +
        urllib.parse.quote(path))
    if st != 200:
        raise RemoteError(f"lookup {path}: {st}")
    entry = json.loads(body)
    marker = entry.get("extended", {}).get("remote")
    if not marker:
        raise RemoteError(f"{path} is not remote-backed")
    _meta_create(filer, path, {"remote": marker})   # replaces chunks


def _meta_patch_extended(filer: str, path: str,
                         extended: dict) -> None:
    st, _, _ = http_bytes(
        "POST", f"{filer}/__meta__/patch_extended",
        json.dumps({"path": path, "extended": extended}).encode(),
        {"Content-Type": "application/json"})
    if st != 200:
        raise RemoteError(f"meta patch {path}: {st}")
