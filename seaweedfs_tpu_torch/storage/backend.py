"""Remote `.dat` storage backends (weed/storage/backend/backend.go
BackendStorageFile and s3_backend/s3_backend.go), the port's copy of
`seaweedfs_tpu/storage/backend.py`.

A tiered volume's `.dat` lives as one object in an S3-compatible store,
and its needle reads become ranged GETs.  The targets are a process-wide
registry, configured like the reference's `[storage.backend.s3.default]`
section (`configure_s3_backend`, the volume server's `-tierBackend`); a
`.vif` `files` entry names its backend by id.  The object is uploaded in
64 MiB multipart parts and downloaded in 64 MiB ranged GETs, so a
multi-GB volume never sits whole in memory; a server that ignores
`Range` is answered by slicing its whole body.  Requests go over the
pooled client (`server/httpd.http_bytes`), signed with SigV4
(`s3/auth.sign_request`) when the target has keys.

`RemoteDatFile` is the read-only file-like over such an object that a
tiered `Volume` reads through; each read is counted in
`volume_tier_remote_reads_total` and `volume_tier_remote_read_bytes_total`
(`stats.PROCESS`, on the volume server's `/metrics`).
"""

from __future__ import annotations

import os
import re
import threading
import urllib.parse

from .. import stats
from ..server.httpd import http_bytes

PART_SIZE = 64 * 1024 * 1024


class S3BackendStorage:
    """One named S3 target (s3_backend.go S3BackendStorage)."""

    def __init__(self, backend_id: str, endpoint: str, bucket: str,
                 access_key: str = "", secret_key: str = ""):
        self.id = backend_id
        self.endpoint = endpoint  # host:port of an S3-compatible API
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key

    def _request(self, method: str, key: str, body: "bytes | None" = None,
                 extra_headers: "dict | None" = None,
                 query: "dict | None" = None) -> "tuple[int, bytes, dict]":
        path = f"/{self.bucket}/{key}"
        query = query or {}
        headers: dict = {}
        if self.access_key:
            from ..s3.auth import sign_request
            headers = sign_request(method, self.endpoint, path, query, {},
                                   body or b"", self.access_key,
                                   self.secret_key)
        # Range is no signed header in SigV4: added after the signature
        headers.update(extra_headers or {})
        qs = urllib.parse.urlencode(query)
        url = self.endpoint + urllib.parse.quote(path) + \
            (f"?{qs}" if qs else "")
        return http_bytes(method, url, body, headers, timeout=600)

    def _check(self, what: str, status: int, resp: bytes = b"") -> None:
        if status >= 300:
            raise RuntimeError(f"s3 backend {self.id}: {what}: {status} "
                               f"{resp[:200]!r}")

    def ensure_bucket(self) -> None:
        st, resp, _ = self._request("PUT", "")
        if st != 409:                       # 409: it exists already
            self._check(f"create bucket {self.bucket}", st, resp)

    def upload(self, local_path: str, key: str,
               chunk_size: int = PART_SIZE) -> int:
        """Upload a file a part at a time (the reference uses the SDK's
        multipart uploader for the same reason); one PUT when it fits in
        one part.  Returns its size."""
        size = os.path.getsize(local_path)
        if size <= chunk_size:
            with open(local_path, "rb") as f:
                data = f.read()
            st, resp, _ = self._request("PUT", key, data)
            self._check(f"upload {key}", st, resp)
            return size
        st, resp, _ = self._request("POST", key, query={"uploads": ""})
        self._check(f"initiate multipart {key}", st, resp)
        m = re.search(rb"<UploadId>([^<]+)</UploadId>", resp)
        if not m:
            raise RuntimeError("no UploadId in initiate response")
        upload_id = m.group(1).decode()
        parts = []
        with open(local_path, "rb") as f:
            while True:
                chunk = f.read(chunk_size)
                if not chunk:
                    break
                n = len(parts) + 1
                st, resp, _ = self._request(
                    "PUT", key, chunk,
                    query={"partNumber": str(n), "uploadId": upload_id})
                self._check(f"part {n}", st, resp)
                parts.append(f"<Part><PartNumber>{n}</PartNumber></Part>")
        body = ("<CompleteMultipartUpload>" + "".join(parts) +
                "</CompleteMultipartUpload>").encode()
        st, resp, _ = self._request("POST", key, body,
                                    query={"uploadId": upload_id})
        self._check(f"complete multipart {key}", st, resp)
        return size

    def put_bytes(self, key: str, data: bytes) -> None:
        """One PUT of an in-memory payload (a sink's object)."""
        st, resp, _ = self._request("PUT", key, data)
        self._check(f"put {key}", st, resp)

    def download(self, key: str, local_path: str,
                 chunk_size: int = PART_SIZE) -> int:
        """Ranged GETs of the object, a chunk at a time, into a temp file
        renamed to `local_path` (removed if the download fails).  Returns
        the size."""
        size = self.size_of(key)
        tmp = local_path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pos = 0
                while pos < size:
                    n = min(chunk_size, size - pos)
                    f.write(self.read_range(key, pos, n))
                    pos += n
            os.replace(tmp, local_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)          # a download that failed midway
        return size

    def size_of(self, key: str) -> int:
        st, _, hdrs = self._request("HEAD", key)
        if st != 200:
            raise RuntimeError(f"s3 backend {self.id}: head {key}: {st}")
        return int(hdrs.get("Content-Length", 0))

    def delete(self, key: str) -> None:
        self._request("DELETE", key)

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        st, data, _ = self._request(
            "GET", key,
            extra_headers={"Range": f"bytes={offset}-{offset + size - 1}"})
        if st not in (200, 206):
            raise RuntimeError(f"s3 backend {self.id}: ranged read "
                               f"{key}@{offset}+{size}: {st}")
        if st == 200:                       # Range ignored: slice here
            data = data[offset:offset + size]
        return data


class RemoteDatFile:
    """A read-only file-like over a remote `.dat` object, so a tiered
    volume's reads (seek, read, tell) go unchanged (backend.go
    BackendStorageFile ReadAt)."""

    def __init__(self, storage: S3BackendStorage, key: str, size: int):
        self._storage = storage
        self._key = key
        self._size = size
        self._pos = 0
        self._lock = threading.Lock()

    def seek(self, offset: int, whence: int = 0) -> int:
        with self._lock:
            if whence == 0:
                self._pos = offset
            elif whence == 1:
                self._pos += offset
            else:
                self._pos = self._size + offset
            return self._pos

    def tell(self) -> int:
        with self._lock:
            return self._pos

    def read(self, n: int = -1) -> bytes:
        with self._lock:
            if n < 0:
                n = self._size - self._pos
            n = max(0, min(n, self._size - self._pos))
            if n == 0:
                return b""
            data = self._storage.read_range(self._key, self._pos, n)
            self._pos += len(data)
        stats.PROCESS.counter_add(
            "volume_tier_remote_reads_total", 1.0,
            help_text="ranged reads of tiered volumes' remote .dat")
        stats.PROCESS.counter_add(
            "volume_tier_remote_read_bytes_total", float(len(data)),
            help_text="bytes read from tiered volumes' remote .dat")
        return data

    def flush(self) -> None:        # read-only: nothing to flush
        pass

    def close(self) -> None:
        pass

    def write(self, data: bytes) -> int:
        raise PermissionError("tiered volume .dat is read-only "
                              f"(volume.tier.move'd to {self._storage.id})")


# -- the registry (backend.go LoadConfiguration) -----------------------------

_REGISTRY: "dict[str, S3BackendStorage]" = {}
_REG_LOCK = threading.Lock()


def configure_s3_backend(backend_id: str, endpoint: str, bucket: str,
                         access_key: str = "", secret_key: str = ""
                         ) -> S3BackendStorage:
    s = S3BackendStorage(backend_id, endpoint, bucket, access_key,
                         secret_key)
    with _REG_LOCK:
        _REGISTRY[backend_id] = s
    return s


def configure_from_flag(spec: str) -> S3BackendStorage:
    """`-tierBackend endpoint,bucket[,accessKey,secretKey]` as the
    backend "default" (the bucket defaults to `tier`)."""
    parts = spec.split(",")
    return configure_s3_backend(
        "default", parts[0], parts[1] if len(parts) > 1 else "tier",
        parts[2] if len(parts) > 2 else "",
        parts[3] if len(parts) > 3 else "")


def get_backend(backend_id: str) -> S3BackendStorage:
    with _REG_LOCK:
        s = _REGISTRY.get(backend_id)
    if s is None:
        raise KeyError(
            f"s3 backend {backend_id!r} not configured on this server "
            f"(configure_s3_backend / -tierBackend)")
    return s
