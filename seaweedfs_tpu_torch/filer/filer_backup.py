"""`filer.backup` — continuously mirror a filer's namespace into a
LOCAL directory (weed/command/filer_backup.go; the localsink of
weed/replication/sink/); the port's copy of
`seaweedfs_tpu/filer/filer_backup.py`.

Same engine as filer.sync (poll the persistent metadata stream, apply
each event, checkpoint the offset after it fully applies) with a
local-filesystem applier instead of a second filer: create/update
writes the file bytes under the backup root, delete removes, rename
moves.  A restarted backup resumes from its offset; a fresh one
replays the full history (the metadata log is persistent)."""

from __future__ import annotations

import os
import shutil

from ..server.httpd import http_bytes
from .filer_sync import FilerSync, _quote


class FilerBackup(FilerSync):
    def __init__(self, source: str, backup_dir: str,
                 state_path: str | None = None,
                 poll_interval: float = 0.2):
        super().__init__(source, f"localdir:{backup_dir}",
                         state_path, poll_interval)
        self.backup_dir = os.path.abspath(backup_dir)
        os.makedirs(self.backup_dir, exist_ok=True)

    def _local(self, path: str) -> str:
        """Map a filer path into the backup root, refusing traversal
        out of it."""
        local = os.path.abspath(
            os.path.join(self.backup_dir, path.lstrip("/")))
        if not local.startswith(self.backup_dir + os.sep) and \
                local != self.backup_dir:
            raise RuntimeError(f"backup path escapes root: {path}")
        return local

    # -- applier (localsink) ----------------------------------------------

    def _apply(self, ev: dict) -> None:
        op = ev.get("op")
        new = ev.get("newEntry")
        old = ev.get("oldEntry")
        if op in ("create", "update") and new:
            self._copy_entry(new)
        elif op == "delete" and old:
            local = self._local(old["fullPath"])
            if os.path.isdir(local):
                shutil.rmtree(local, ignore_errors=True)
            elif os.path.exists(local):
                os.remove(local)
        elif op == "rename" and new and old:
            src = self._local(old["fullPath"])
            dst = self._local(new["fullPath"])
            if os.path.exists(src):
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                if os.path.isdir(src):
                    # replace, never nest: a re-applied rename (crash
                    # between apply and offset checkpoint) must stay
                    # idempotent, and shutil.move into an existing dir
                    # would produce dst/basename(src)
                    if os.path.isdir(dst):
                        shutil.rmtree(dst, ignore_errors=True)
                    shutil.move(src, dst)
                else:
                    os.replace(src, dst)
            else:
                self._copy_entry(new)

    def _copy_entry(self, entry: dict) -> None:
        local = self._local(entry["fullPath"])
        if entry.get("isDirectory"):
            os.makedirs(local, exist_ok=True)
            return
        st, body, _ = http_bytes(
            "GET", self.source + _quote(entry["fullPath"]))
        if st == 404:
            return  # deleted since; the delete event follows
        if st >= 300:
            raise RuntimeError(
                f"filer.backup: read {entry['fullPath']}: {st}")
        os.makedirs(os.path.dirname(local), exist_ok=True)
        tmp = local + ".tmp"
        with open(tmp, "wb") as f:
            f.write(body)
        os.replace(tmp, local)
        mode = (entry.get("attributes") or {}).get("mode")
        if mode:
            os.chmod(local, mode & 0o7777)
