"""Filer HTTP server (weed/server/filer_server.go + handlers), the port's
copy of `seaweedfs_tpu/server/filer_server.py` with the JAX package's
meta plane off, no native planes and one process.

The reference's filer HTTP surface:
  POST/PUT /path/to/file     upload (auto-chunked; a trailing / = mkdir)
  GET      /path/to/file     ranged read, streamed (206 / 416)
  GET      /path/to/dir/     JSON listing (?limit=&lastFileName=&prefix=)
  DELETE   /path             (?recursive=true, ?ignoreChunks=true)
  HEAD     /path             existence/size probe
  POST     /__chunk__/path   interval write (?offset=N[&truncateTo=M])
plus JSON-over-HTTP mirrors of filer.proto RPCs:
  GET  /__meta__/lookup?path=         <- LookupDirectoryEntry
  POST /__meta__/rename               <- AtomicRenameEntry
  POST /__meta__/set_attrs, /create, /put_entry, /patch_extended
  GET  /__meta__/events?sinceNs=      <- SubscribeMetadata (poll form)
  GET  /__meta__/statistics           <- Statistics
and `/status`, `/metrics`.

The store is sqlite (a file, or ":memory:"); its metadata log lives in
`<store>.metalog`, so two filers over one store file share one log dir
and see each other's commits through its watermark files.  Not ported
(ROADMAP): TUS uploads, the lock routes, follow mode, notification,
remote mounts, gRPC, QoS, fault sites and the autopilot.
"""

from __future__ import annotations

import os
import urllib.parse

from .. import stats
from ..filer import Entry, Filer
from ..filer.entry import Attributes
from ..filer.filer_store import SqliteStore
from ..util.chunk_cache import read_cache_disk
from .httpd import HttpServer, Request, http_json, parse_range


def cluster_statistics(master: str, collection: str = "") -> dict:
    """Aggregate used/total/file counts from the master topology, the
    filer Statistics feed (filer.proto Statistics).  Raises OSError
    when the master is unreachable."""
    vl = http_json("GET", f"{master}/dir/status", timeout=30)
    cs = http_json("GET", f"{master}/cluster/status", timeout=30)
    used = files = max_count = 0
    for dc in vl.get("dataCenters", {}).values():
        for rack in dc.get("racks", {}).values():
            for node in rack.get("nodes", []):
                max_count += node.get("maxVolumeCount", 0)
                for v in node.get("volumes", []):
                    if collection and \
                            v.get("collection") != collection:
                        continue
                    used += v.get("size", 0)
                    files += v.get("fileCount", 0)
    total = cs.get("volumeSizeLimit", 0) * max(max_count, 1)
    return {"totalSize": total, "usedSize": used,
            "fileCount": files}


class FilerServer:
    def __init__(self, master: str, host: str = "127.0.0.1",
                 port: int = 0, store_path: str = ":memory:",
                 collection: str = "", replication: str = "",
                 meta_log_dir: str | None = None):
        # bind the listener FIRST: it fails fast on a taken port,
        # before any store file is touched
        self.http = HttpServer(host, port)
        try:
            if meta_log_dir is None and store_path != ":memory:":
                # the metadata log persists beside the store:
                # subscribers must survive a restart, and siblings over
                # one store share it (filer_notify_append.go)
                meta_log_dir = store_path + ".metalog"
            # the disk tier of the chunk cache, when one is configured,
            # gets a directory of this filer's own
            cache_dir, _ = read_cache_disk()
            self.filer = Filer(
                master, SqliteStore(store_path), collection=collection,
                replication=replication, meta_log_dir=meta_log_dir,
                meta_cache=True,
                chunk_cache_dir=(os.path.join(cache_dir,
                                              f"filer{self.http.port}")
                                 if cache_dir else None))
        except BaseException:
            # a store-setup failure must not leak a bound socket
            self.http.stop()
            raise
        self.metrics = stats.Metrics("filer")
        self.http.role = "filer"
        r = self.http.route
        r("GET", "/status", self._status)
        r("GET", "/metrics", self._metrics)
        r("GET", "/__meta__/lookup", self._meta_lookup)
        r("POST", "/__meta__/rename", self._meta_rename)
        r("POST", "/__meta__/set_attrs", self._meta_set_attrs)
        r("POST", "/__meta__/create", self._meta_create)
        r("POST", "/__meta__/put_entry", self._meta_put_entry)
        r("POST", "/__meta__/patch_extended", self._meta_patch_extended)
        r("GET", "/__meta__/events", self._meta_events)
        r("GET", "/__meta__/statistics", self._meta_statistics)
        self.http.route_prefix("POST", "/__chunk__/", self._chunk_route)
        self.http.fallback = self._dispatch

    def start(self) -> "FilerServer":
        self.http.start()
        return self

    def stop(self) -> None:
        self.http.stop()
        self.filer.close()

    @property
    def url(self) -> str:
        return self.http.url

    def _metrics(self, req: Request):
        """Prometheus text: the filer's gauges, then the process-wide
        registry (the store's and metalog's group commits, the meta
        and chunk caches, negative lookups, the pooled client)."""
        self.metrics.gauge_set(
            "meta_log_last_ts_ns", float(self.filer.meta_log.last_ts()),
            help_text="timestamp of the newest metadata log event")
        return 200, ((self.metrics.render() +
                      stats.PROCESS.render()).encode(),
                     {"Content-Type": "text/plain; version=0.0.4"})

    def _status(self, req: Request):
        """Plane discovery, as the JAX filer answers it: this filer runs
        no native plane, so both ports are 0."""
        return 200, {"version": "seaweedfs-tpu/0.1", "role": "filer",
                     "metaPlanePort": 0, "readPlanePort": 0}

    # -- dispatch ---------------------------------------------------------

    def _chunk_route(self, req: Request):
        return self._chunk_write(
            req, urllib.parse.unquote(req.path)[len("/__chunk__"):])

    def _dispatch(self, req: Request):
        # the wire path is percent-encoded (every client quotes);
        # storing it un-decoded would persist names like "a%21" for "a!"
        path = urllib.parse.unquote(req.path)
        # a percent-encoded "/__chunk__/" misses the prefix table
        if path.startswith("/__chunk__/"):
            return self._chunk_write(req, path[len("/__chunk__"):])
        if req.method in ("POST", "PUT"):
            return self._put(req, path)
        if req.method in ("GET", "HEAD"):
            return self._get(req, path)
        if req.method == "DELETE":
            return self._delete(req, path)
        return 405, {"error": "method not allowed"}

    def _chunk_write(self, req: Request, path: str):
        """Interval chunk write (the mount's dirty-page flush target):
        POST /__chunk__/<path>?offset=N[&truncateTo=M] with raw bytes
        appends overlapping chunks or clips the length without
        rewriting the whole file (filer.proto UpdateEntry +
        AssignVolume)."""
        if req.method != "POST":
            return 405, {"error": "POST only"}
        offset = int(req.query.get("offset", 0))
        trunc = req.query.get("truncateTo")
        trunc = int(trunc) if trunc is not None else None
        try:
            if req.body or trunc is None:
                entry = self.filer.append_chunks(path, offset, req.body,
                                                 truncate_to=trunc)
            else:
                entry = self.filer.truncate_file(path, trunc)
        except IsADirectoryError:
            return 409, {"error": "is a directory"}
        except FileNotFoundError:
            return 404, {"error": "not found"}
        return 200, {"name": entry.name, "size": entry.total_size()}

    def _put(self, req: Request, path: str):
        if path.endswith("/"):
            # mkdir (filer_server_handlers_write.go mkdir on trailing /)
            e = Entry(path.rstrip("/") or "/", is_directory=True)
            self.filer.create_entry(e)
            return 201, {"name": e.name}
        mime = req.headers.get("Content-Type", "")
        if mime == "application/x-www-form-urlencoded":
            mime = ""
        entry = self.filer.write_file(path, req.body, mime=mime)
        return 201, {"name": entry.name, "size": entry.total_size()}

    def _get(self, req: Request, path: str):
        if path.endswith("/") or path == "":
            return self._list(req, path or "/")
        entry = self.filer.find_entry(path, count_negative=True)
        if entry is None:
            return 404, {"error": f"{path} not found"}
        if entry.is_directory:
            return self._list(req, path)
        rng = req.headers.get("Range", "")
        file_size = entry.total_size()
        parsed = parse_range(rng, file_size)
        if parsed == "unsatisfiable":
            return 416, (b"", {"Content-Range": f"bytes */{file_size}"})
        if parsed is None:
            rng = ""  # absent/malformed: full body (RFC 9110)
            offset, size = 0, file_size
        else:
            offset, size = parsed
        mime = entry.attributes.mime or "application/octet-stream"
        # stream, never buffer: views are fetched lazily as the response
        # drains, so a multi-GB GET holds one chunk in memory
        body = self.filer.open_read_stream(entry, offset, size)
        headers = {"Content-Type": mime, "Content-Length": str(size)}
        if rng:
            headers["Content-Range"] = \
                f"bytes {offset}-{offset + size - 1}/{file_size}"
            return 206, (body, headers)
        return 200, (body, headers)

    def _list(self, req: Request, path: str):
        limit = int(req.query.get("limit", 1000))
        last = req.query.get("lastFileName", "")
        prefix = req.query.get("prefix", "")
        entries = self.filer.list_directory(
            path.rstrip("/") or "/", start_file=last, limit=limit,
            prefix=prefix)
        return 200, {
            "path": path,
            "entries": [e.to_json() for e in entries],
            "lastFileName": entries[-1].name if entries else "",
            "shouldDisplayLoadMore": len(entries) >= limit,
        }

    def _delete(self, req: Request, path: str):
        recursive = req.query.get("recursive", "") == "true"
        # ignoreChunks: metadata only (filer.proto DeleteEntryRequest
        # is_delete_data=false), for entries whose chunks another entry
        # now references
        keep_chunks = req.query.get("ignoreChunks", "") == "true"
        try:
            self.filer.delete_entry(path.rstrip("/") or "/",
                                    recursive=recursive,
                                    delete_chunks=not keep_chunks)
        except IsADirectoryError as e:
            return 409, {"error": str(e)}
        return 204, b""

    # -- meta RPC mirrors -------------------------------------------------

    def _meta_lookup(self, req: Request):
        entry = self.filer.find_entry(req.query["path"])
        if entry is None:
            return 404, {"error": "not found"}
        return 200, entry.to_json()

    def _meta_rename(self, req: Request):
        b = req.json()
        try:
            self.filer.rename(b["oldPath"], b["newPath"])
        except FileNotFoundError as e:
            return 404, {"error": str(e)}
        return 200, {}

    def _meta_set_attrs(self, req: Request):
        """Attribute-only update (filer.proto UpdateEntry with unchanged
        chunks): mode/uid/gid/mtime that a content PUT cannot carry."""
        b = req.json()
        entry = self.filer.find_entry(b["path"])
        if entry is None:
            return 404, {"error": "not found"}
        entry.attributes = Attributes.from_json(b.get("attributes", {}))
        self.filer.create_entry(entry, create_parents=False)
        return 200, {}

    def _meta_create(self, req: Request):
        """Create/replace a chunkless entry with extended metadata;
        replacing a file reclaims its old chunks, as write_file does."""
        b = req.json()
        entry = Entry(b["path"], is_directory=bool(b.get("isDirectory")))
        entry.extended = dict(b.get("extended", {}))
        old_entry = self.filer.find_entry(b["path"])
        self.filer.create_entry(entry)
        if old_entry is not None and old_entry.chunks:
            self.filer._delete_chunks(old_entry)
        return 200, {}

    def _meta_put_entry(self, req: Request):
        """Full-entry create/replace (filer.proto CreateEntry):
        attributes, extended metadata AND chunk list, for clients that
        assembled an entry themselves."""
        self.filer.create_entry(Entry.from_json(req.json()))
        return 200, {}

    def _meta_patch_extended(self, req: Request):
        """Merge extended keys into an entry, keeping chunks/attrs."""
        b = req.json()
        entry = self.filer.find_entry(b["path"])
        if entry is None:
            return 404, {"error": "not found"}
        entry.extended.update(b.get("extended", {}))
        self.filer.create_entry(entry, create_parents=False)
        return 200, {}

    def _meta_statistics(self, req: Request):
        """Cluster usage aggregated from the master topology
        (filer.proto Statistics)."""
        try:
            return 200, cluster_statistics(
                self.filer.master, req.query.get("collection", ""))
        except OSError as e:
            return 503, {"error": str(e)}

    def _meta_events(self, req: Request):
        since = int(req.query.get("sinceNs", 0))
        limit = int(req.query.get("limit", 0))
        return 200, {"events": self.filer.events_since(since, limit)}
