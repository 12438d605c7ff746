"""Remote filer client: the Filer-shaped API over a running filer
server's HTTP surface (the analog of the reference's filer_pb client),
the port's copy of `seaweedfs_tpu/filer/client.py`.  It speaks the JAX
filer's wire format, so either package's client drives either filer.

Duck-typed to the in-process `Filer` for the read/write/namespace
methods that gateways consume.
"""

from __future__ import annotations

import json
import urllib.parse

from ..server.httpd import http_bytes
from .entry import Entry, normalize_path


class FilerClient:
    def __init__(self, filer: str):
        self.filer = filer

    def _url(self, path: str, suffix: str = "") -> str:
        return self.filer + urllib.parse.quote(path) + suffix

    # -- namespace --------------------------------------------------------

    def find_entry(self, path: str) -> "Entry | None":
        path = normalize_path(path)
        if path == "/":
            return Entry("/", is_directory=True)
        st, body, _ = http_bytes(
            "GET", f"{self.filer}/__meta__/lookup?path=" +
            urllib.parse.quote(path))
        if st == 404:
            return None
        if st != 200:
            raise OSError(f"filer lookup {path}: {st}")
        return Entry.from_json(json.loads(body))

    def list_directory(self, path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1000,
                       prefix: str = "") -> "list[Entry]":
        q = urllib.parse.urlencode({
            "limit": limit, "lastFileName": start_file,
            "prefix": prefix})
        st, body, _ = http_bytes(
            "GET", self._url(path.rstrip("/") + "/", "?" + q))
        if st != 200:
            raise OSError(f"filer list {path}: {st}")
        return [Entry.from_json(e)
                for e in json.loads(body).get("entries", [])]

    def create_entry(self, entry: Entry,
                     create_parents: bool = True) -> None:
        """Full-entry create/replace via /__meta__/put_entry
        (filer.proto CreateEntry): carries attributes, extended
        metadata and the chunk list — gateways mutate entries they
        fetched (etag/SSE/lock config) or assembled (multipart
        completion) and write them back whole."""
        st, body, _ = http_bytes(
            "POST", f"{self.filer}/__meta__/put_entry",
            json.dumps(entry.to_json()).encode(),
            {"Content-Type": "application/json"})
        if st != 200:
            raise OSError(f"filer put_entry {entry.full_path}: {st} "
                          f"{body[:200]!r}")

    def delete_entry(self, path: str, recursive: bool = False,
                     delete_chunks: bool = True) -> None:
        q = []
        if recursive:
            q.append("recursive=true")
        if not delete_chunks:
            # metadata-only delete: the chunks now belong to another
            # entry (multipart completion)
            q.append("ignoreChunks=true")
        st, body, _ = http_bytes(
            "DELETE",
            self._url(path, "?" + "&".join(q) if q else ""))
        if st == 409:
            raise IsADirectoryError(body.decode(errors="replace"))
        if st not in (204, 200, 404):
            raise OSError(f"filer delete {path}: {st}")

    def rename(self, old_path: str, new_path: str) -> None:
        st, body, _ = http_bytes(
            "POST", f"{self.filer}/__meta__/rename",
            json.dumps({"oldPath": old_path,
                        "newPath": new_path}).encode(),
            {"Content-Type": "application/json"})
        if st == 404:
            raise FileNotFoundError(old_path)
        if st != 200:
            raise OSError(f"filer rename {old_path}: {st}")

    def update_attrs(self, path: str, **kw) -> None:
        """Attribute-only update via /__meta__/set_attrs (the endpoint
        replaces the whole attribute block, so read-modify-write)."""
        entry = self.find_entry(path)
        if entry is None:
            raise FileNotFoundError(path)
        for k, v in kw.items():
            setattr(entry.attributes, k, v)
        st, _, _ = http_bytes(
            "POST", f"{self.filer}/__meta__/set_attrs",
            json.dumps({"path": path,
                        "attributes": entry.attributes.to_json()}
                       ).encode(),
            {"Content-Type": "application/json"})
        if st != 200:
            raise OSError(f"filer set_attrs {path}: {st}")

    # -- content ----------------------------------------------------------

    def write_file(self, path: str, data: bytes, mime: str = "",
                   mode: int = 0o660) -> Entry:
        headers = {"Content-Type": mime} if mime else {}
        st, body, _ = http_bytes("PUT", self._url(path), data, headers)
        if st not in (200, 201):
            raise OSError(f"filer write {path}: {st} "
                          f"{body[:200]!r}")
        entry = self.find_entry(path)
        if entry is None:
            raise OSError(f"filer write {path}: entry vanished")
        return entry

    def read_file(self, path: str, offset: int = 0,
                  size: "int | None" = None) -> bytes:
        headers = {}
        if offset or size is not None:
            end = "" if size is None else str(offset + size - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        st, body, _ = http_bytes("GET", self._url(path), None, headers)
        if st == 404:
            raise FileNotFoundError(path)
        if st == 416:
            return b""
        if st not in (200, 206):
            raise OSError(f"filer read {path}: {st}")
        if st == 200 and (offset or size is not None):
            body = body[offset:offset + size if size else None]
        return body
