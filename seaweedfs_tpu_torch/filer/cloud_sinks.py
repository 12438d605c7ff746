"""The object-store appliers of `filer.backup`
(weed/replication/sink/s3sink and its siblings): the shared `_CloudSink`
of `seaweedfs_tpu/filer/cloud_sinks.py`, the port's copy.  The GCS,
Azure and B2 sinks are not ported (ROADMAP A6); `filer/s3_sink.py`
rides this applier.

Same engine as `filer.sync` and `filer.backup` (`FilerSync`: poll the
source's persistent metadata stream, apply each event, checkpoint the
offset after it applied): a create or an update uploads the file's
bytes under its filer path, a delete removes the object, a rename
deletes the old key and uploads the new one (object stores have no
rename); directories are no objects.
"""

from __future__ import annotations

from ..server.httpd import http_bytes
from .filer_sync import FilerSync, _quote


class _CloudSink(FilerSync):
    """The s3sink event mapping over the wire verbs `_upload` and
    `_delete` that a subclass gives."""

    def __init__(self, source: str, target: str, key_prefix: str = "",
                 state_path: "str | None" = None,
                 poll_interval: float = 0.2):
        super().__init__(source, target, state_path, poll_interval)
        self.key_prefix = key_prefix.strip("/")

    def _key(self, path: str) -> str:
        key = path.lstrip("/")
        return f"{self.key_prefix}/{key}" if self.key_prefix else key

    def _apply(self, ev: dict) -> None:
        op = ev.get("op")
        new = ev.get("newEntry")
        old = ev.get("oldEntry")
        if op in ("create", "update") and new:
            self._put_entry(new)
        elif op == "delete" and old:
            if not old.get("isDirectory"):
                self._delete(self._key(old["fullPath"]))
        elif op == "rename" and new and old:
            if not old.get("isDirectory"):
                self._delete(self._key(old["fullPath"]))
            self._put_entry(new)

    def _put_entry(self, entry: dict) -> None:
        if entry.get("isDirectory"):
            return
        st, body, _ = http_bytes("GET", self.source + _quote(entry["fullPath"]))
        if st == 404:
            return              # deleted since; its delete event follows
        if st >= 300:
            raise RuntimeError(
                f"{self.target}: read {entry['fullPath']}: {st}")
        self._upload(self._key(entry["fullPath"]), body)

    def _upload(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def _delete(self, key: str) -> None:
        raise NotImplementedError
