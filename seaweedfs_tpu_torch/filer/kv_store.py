"""Remote ordered-KV FilerStore archetype, the port's copy of
`seaweedfs_tpu/filer/kv_store.py` (the etcd/tikv/redis shape
among the reference's 24 pluggable stores — weed/filer/etcd/,
redis2/, tikv/; interface weed/filer/filerstore.go).

Key scheme (the ordered-KV idiom the reference's etcd store uses):

    <parent-dir> \\x00 <name>   ->   entry JSON

so one range scan over the prefix `<dir>\\x00` yields a directory's
children in lexicographic name order — no SQL, no local file, just
get/put/delete/scan against a remote server.  `KVClient` is the
transport contract; `HttpKVClient`/`HttpKVServer` provide a real
remote (JSON-over-HTTP) implementation used by tests and as the
template for binding an actual etcd/redis.
"""

from __future__ import annotations

import json
import threading

from ..server.httpd import HttpServer, Request, http_json
from .entry import Entry, normalize_path
from .filer_store import FilerStore

SEP = "\x00"


def _key(path: str) -> str:
    path = normalize_path(path)
    parent, _, name = path.rpartition("/")
    return f"{parent or '/'}{SEP}{name}"


def _dir_prefix(dir_path: str) -> str:
    return f"{normalize_path(dir_path)}{SEP}"


class KVClient:
    """Transport contract: an ordered key-value store."""

    def get(self, key: str) -> "bytes | None":
        raise NotImplementedError

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def scan(self, prefix: str, start_after: str = "",
             limit: int = 1000) -> "list[tuple[str, bytes]]":
        """Keys with `prefix`, strictly greater than `start_after`
        (full key), ascending, at most `limit`."""
        raise NotImplementedError


class KVFilerStore(FilerStore):
    """filerstore.go over any KVClient."""

    def __init__(self, kv: KVClient):
        self.kv = kv

    def insert_entry(self, entry: Entry) -> None:
        self.kv.put(_key(entry.full_path),
                    json.dumps(entry.to_json()).encode())

    update_entry = insert_entry

    def find_entry(self, path: str) -> "Entry | None":
        if normalize_path(path) == "/":
            # root always exists (matches MemoryStore/SqliteStore —
            # clients PROPFIND the share root before anything else)
            return Entry("/", is_directory=True)
        raw = self.kv.get(_key(path))
        return Entry.from_json(json.loads(raw)) if raw else None

    def delete_entry(self, path: str) -> None:
        self.kv.delete(_key(path))

    def delete_folder_children(self, path: str) -> None:
        """Whole-SUBTREE delete, like the other stores — removing only
        direct children would orphan grandchildren keys, and a later
        mkdir of the same subdir would resurrect them with dangling
        chunk references."""
        prefix = _dir_prefix(path)
        while True:
            batch = self.kv.scan(prefix, limit=1000)
            if not batch:
                return
            for k, raw in batch:
                try:
                    child = Entry.from_json(json.loads(raw))
                    if child.is_directory:
                        self.delete_folder_children(child.full_path)
                except ValueError:
                    pass
                self.kv.delete(k)

    def list_directory_entries(self, dir_path: str,
                               start_file: str = "",
                               include_start: bool = False,
                               limit: int = 1000,
                               prefix: str = "") -> "list[Entry]":
        kp = _dir_prefix(dir_path)
        out: list[Entry] = []
        # start_after is exclusive; include_start re-reads the exact key
        start_after = kp + start_file if start_file else ""
        if start_file and include_start:
            raw = self.kv.get(kp + start_file)
            if raw:
                e = Entry.from_json(json.loads(raw))
                if e.name.startswith(prefix):
                    out.append(e)
        while len(out) < limit:
            batch = self.kv.scan(kp, start_after,
                                 min(1000, limit - len(out) + 64))
            if not batch:
                break
            for k, raw in batch:
                name = k[len(kp):]
                start_after = k
                if prefix and not name.startswith(prefix):
                    continue
                out.append(Entry.from_json(json.loads(raw)))
                if len(out) >= limit:
                    break
        return out

    def close(self) -> None:
        pass


# --- a real remote KV (JSON-over-HTTP) for tests & as a template ---------

class HttpKVServer:
    """Minimal ordered-KV server: the stand-in for etcd/redis in tests
    (the reference's stores are exercised against real containers in
    CI; this keeps the same client/server split in-process)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.http = HttpServer(host, port)
        self.http.route("POST", "/kv/get", self._get)
        self.http.route("POST", "/kv/put", self._put)
        self.http.route("POST", "/kv/delete", self._delete)
        self.http.route("POST", "/kv/scan", self._scan)

    def start(self) -> "HttpKVServer":
        self.http.start()
        return self

    def stop(self) -> None:
        self.http.stop()

    @property
    def url(self) -> str:
        return self.http.url

    def _get(self, req: Request):
        with self._lock:
            v = self._data.get(req.json()["key"])
        if v is None:
            return 200, {"found": False}
        return 200, {"found": True, "value": v.decode("latin-1")}

    def _put(self, req: Request):
        b = req.json()
        with self._lock:
            self._data[b["key"]] = b["value"].encode("latin-1")
        return 200, {}

    def _delete(self, req: Request):
        with self._lock:
            self._data.pop(req.json()["key"], None)
        return 200, {}

    def _scan(self, req: Request):
        b = req.json()
        prefix = b["prefix"]
        start_after = b.get("startAfter", "")
        limit = int(b.get("limit", 1000))
        with self._lock:
            keys = sorted(k for k in self._data
                          if k.startswith(prefix) and k > start_after)
            items = [{"key": k,
                      "value": self._data[k].decode("latin-1")}
                     for k in keys[:limit]]
        return 200, {"items": items}


class HttpKVClient(KVClient):
    def __init__(self, server: str):
        self.server = server

    def get(self, key: str) -> "bytes | None":
        r = http_json("POST", f"{self.server}/kv/get", {"key": key})
        return r["value"].encode("latin-1") if r.get("found") else None

    def put(self, key: str, value: bytes) -> None:
        http_json("POST", f"{self.server}/kv/put",
                  {"key": key, "value": value.decode("latin-1")})

    def delete(self, key: str) -> None:
        http_json("POST", f"{self.server}/kv/delete", {"key": key})

    def scan(self, prefix: str, start_after: str = "",
             limit: int = 1000) -> "list[tuple[str, bytes]]":
        r = http_json("POST", f"{self.server}/kv/scan",
                      {"prefix": prefix, "startAfter": start_after,
                       "limit": limit})
        return [(i["key"], i["value"].encode("latin-1"))
                for i in r.get("items", [])]
