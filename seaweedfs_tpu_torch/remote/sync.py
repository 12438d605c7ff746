"""filer.remote.sync (weed/command/filer_remote_sync.go +
filer_remote_sync_dir.go), the port's copy of
`seaweedfs_tpu/remote/sync.py`: tail the filer's metadata log and push
local changes under a remote-mounted directory back to the foreign
store — writes upload, deletes delete, renames delete+upload.

Offset checkpointing mirrors filer.sync: the last fully-applied
event's tsNs persists to a local state file, so a restarted syncer
resumes without skipping or reapplying history
(remote_storage/track_sync_offset.go)."""

from __future__ import annotations

import json
import os
import threading
import urllib.parse

from ..server.httpd import http_bytes, http_json
from .remote_storage import RemoteError, load_conf, load_mounts, \
    S3RemoteStorage


class RemoteSyncer:
    def __init__(self, filer: str, directory: str,
                 state_path: str | None = None,
                 poll_interval: float = 0.5):
        self.filer = filer
        self.dir = directory.rstrip("/")
        self.state_path = state_path or \
            f"remote-sync{self.dir.replace('/', '_')}.offset"
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        mounts = load_mounts(filer)
        if self.dir not in mounts:
            raise RemoteError(f"{self.dir} is not remote-mounted")
        m = mounts[self.dir]
        self.client = S3RemoteStorage.from_conf(
            load_conf(filer, m["conf"]), m.get("bucket", ""))
        self.key_prefix = m.get("keyPrefix", "")

    # -- offset checkpoint ------------------------------------------------

    def _load_offset(self) -> int:
        try:
            with open(self.state_path) as f:
                return int(json.load(f)["tsNs"])
        except (OSError, ValueError, KeyError):
            return 0

    def _save_offset(self, ts_ns: int) -> None:
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"tsNs": ts_ns}, f)
        os.replace(tmp, self.state_path)

    # -- event application -------------------------------------------------

    def _key_for(self, path: str) -> "str | None":
        if not (path == self.dir or path.startswith(self.dir + "/")):
            return None
        rel = path[len(self.dir):].lstrip("/")
        if not rel:
            return None
        return (self.key_prefix.rstrip("/") + "/" + rel).lstrip("/") \
            if self.key_prefix else rel

    def _apply(self, ev: dict) -> None:
        new = ev.get("newEntry")
        old = ev.get("oldEntry")
        # deletes (incl. the delete half of renames leaving the dir)
        if old and not (new and new.get("fullPath") ==
                        old.get("fullPath")):
            key = self._key_for(old["fullPath"])
            if key and not old.get("isDirectory"):
                self.client.delete(key)
        if new and not new.get("isDirectory"):
            key = self._key_for(new["fullPath"])
            if key is None:
                return
            ext = new.get("extended", {})
            if ext.get("remote") and not new.get("chunks"):
                return      # our own mount-metadata entries
            st, body, _ = http_bytes(
                "GET", self.filer +
                urllib.parse.quote(new["fullPath"]))
            if st != 200:
                return
            # idempotence guard: remote.cache round-trips content the
            # remote already holds — an md5-matching object needs no
            # re-upload (and must not clobber concurrent remote-side
            # updates with a stale copy)
            import hashlib
            stat = self.client.stat(key)
            if stat is not None and stat.get("etag") == \
                    hashlib.md5(body).hexdigest():
                return
            self.client.write(key, body)

    def run_once(self) -> int:
        """Apply pending events; returns how many were applied."""
        since = self._load_offset()
        r = http_json("GET", f"{self.filer}/__meta__/events"
                             f"?sinceNs={since}&limit=500")
        applied = 0
        for ev in r.get("events", []):
            self._apply(ev)
            self._save_offset(int(ev["tsNs"]))
            applied += 1
        return applied

    # -- daemon ------------------------------------------------------------

    def start(self) -> "RemoteSyncer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                n = self.run_once()
            except (OSError, RemoteError):
                n = 0
            if n == 0:
                self._stop.wait(self.poll_interval)
