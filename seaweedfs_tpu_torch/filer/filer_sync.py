"""`filer.sync` — continuously replicate one filer's namespace to
another (weed/command/filer_sync.go); the port's copy of
`seaweedfs_tpu/filer/filer_sync.py`.

The reference subscribes to the source filer's metadata stream
(SubscribeMetadata), applies each event to the target, and persists a
per-direction progress offset so a restarted sync resumes mid-stream
(command/filer_sync.go setOffset/getOffset).  Active-active runs one
such pipeline in each direction.

The port runs the same shape over the JSON-HTTP plane: poll
`GET <source>/__meta__/events?sinceNs=<offset>` (served from the
persistent MetaLog, so a restart of EITHER side never loses events),
apply each event to the target's filer API, and checkpoint the offset
to a local state file after every applied event.  The offset advances
ONLY after the event fully applied — an application failure aborts the
batch and retries, never skips.  Content is copied by read-through
(source filer ranged read -> target filer auto-chunk upload): chunk
fids are cluster-local and cannot be replicated verbatim, matching the
reference's re-upload behavior; attributes ride separately via
`/__meta__/set_attrs` (filer.proto UpdateEntry).

Unidirectional per instance; run two instances for active-active (the
reference suppresses echo loops via signature exclusion — not yet
implemented here, so active-active needs disjoint subtrees).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.parse

from ..server.httpd import http_bytes, http_json

log = logging.getLogger("seaweedfs_tpu_torch.filer.sync")


def _quote(path: str) -> str:
    return urllib.parse.quote(path)


def default_state_path(source: str, target: str) -> str:
    """Per-direction checkpoint name: two opposite-direction syncs in
    one cwd must never share (and silently clobber) a state file."""
    safe = (source + "-" + target).replace(":", "_").replace("/", "_")
    return f"filer.sync.{safe}.offset"


class FilerSync:
    def __init__(self, source: str, target: str,
                 state_path: str | None = None,
                 poll_interval: float = 0.2):
        self.source = source
        self.target = target
        self.state_path = state_path or default_state_path(source,
                                                           target)
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- offset checkpoint (filer_sync.go getOffset/setOffset) ------------

    def offset(self) -> int:
        try:
            with open(self.state_path, encoding="utf-8") as f:
                state = json.load(f)
        except OSError:
            return 0
        except ValueError as e:
            raise RuntimeError(
                f"filer.sync: corrupt state file {self.state_path}: {e}")
        src, tgt = state.get("source"), state.get("target")
        if (src, tgt) != (self.source, self.target):
            # an offset is a position in ONE source's log for ONE
            # direction; reading another direction's checkpoint would
            # silently skip (or mass-replay) events
            raise RuntimeError(
                f"filer.sync: state file {self.state_path} belongs to "
                f"{src} -> {tgt}, not {self.source} -> {self.target}; "
                f"pass a distinct -state per direction")
        return int(state.get("sinceNs", 0))

    def _save_offset(self, ts_ns: int) -> None:
        tmp = self.state_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"sinceNs": ts_ns, "source": self.source,
                       "target": self.target}, f)
        os.replace(tmp, self.state_path)

    # -- event application ------------------------------------------------

    def _apply(self, ev: dict) -> None:
        """Apply one event to the target; raises on ANY failed
        application so the offset never advances past a lost mutation."""
        op = ev.get("op")
        new = ev.get("newEntry")
        old = ev.get("oldEntry")
        if op in ("create", "update") and new:
            self._copy_entry(new)
        elif op == "delete" and old:
            st, body, _ = http_bytes(
                "DELETE", self.target + _quote(old["fullPath"]) +
                "?recursive=true")
            if st >= 300 and st != 404:  # 404 = already gone: idempotent
                raise RuntimeError(
                    f"filer.sync: delete {old['fullPath']}: "
                    f"{st} {body[:200]!r}")
        elif op == "rename" and new and old:
            st, body, _ = http_bytes(
                "POST", self.target + "/__meta__/rename",
                json.dumps({"oldPath": old["fullPath"],
                            "newPath": new["fullPath"]}).encode(),
                {"Content-Type": "application/json"})
            if st == 404:
                # target never saw the old path (e.g. sync started
                # mid-history): materialize the new path instead
                self._copy_entry(new)
            elif st >= 300:
                raise RuntimeError(
                    f"filer.sync: rename {old['fullPath']} -> "
                    f"{new['fullPath']}: {st} {body[:200]!r}")

    def _copy_entry(self, entry: dict) -> None:
        path = entry["fullPath"]
        if entry.get("isDirectory"):
            st, body, _ = http_bytes("PUT",
                                     self.target + _quote(path) + "/")
            if st >= 300:
                raise RuntimeError(
                    f"filer.sync: mkdir {path}: {st} {body[:200]!r}")
        else:
            st, body, _ = http_bytes("GET", self.source + _quote(path))
            if st == 404:
                return  # deleted since; the delete event will follow
            if st >= 300:
                raise RuntimeError(
                    f"filer.sync: read {path} from {self.source}: {st}")
            mime = (entry.get("attributes") or {}).get("mime") or ""
            headers = {"Content-Type": mime} if mime else {}
            st, body, _ = http_bytes("PUT", self.target + _quote(path),
                                     body, headers)
            if st >= 300:
                raise RuntimeError(
                    f"filer.sync: write {path} to {self.target}: "
                    f"{st} {body[:200]!r}")
        attrs = entry.get("attributes")
        if attrs:
            # mode/uid/gid/mtime/crtime/ttl/symlink can't ride the
            # content PUT; mirror them explicitly (UpdateEntry)
            st, body, _ = http_bytes(
                "POST", self.target + "/__meta__/set_attrs",
                json.dumps({"path": path,
                            "attributes": attrs}).encode(),
                {"Content-Type": "application/json"})
            if st >= 300:
                raise RuntimeError(
                    f"filer.sync: set_attrs {path}: {st} "
                    f"{body[:200]!r}")

    # -- loop -------------------------------------------------------------

    def sync_once(self, batch: int = 1000) -> int:
        """Pull and apply one batch; returns the number applied.  The
        offset checkpoints after EVERY event, so a crash between events
        re-applies at most one (applications are idempotent)."""
        since = self.offset()
        r = http_json("GET", f"{self.source}/__meta__/events"
                             f"?sinceNs={since}&limit={batch}")
        if "events" not in r:
            raise RuntimeError(
                f"filer.sync: source {self.source} events: "
                f"{r.get('error', r)}")
        events = r["events"]
        for ev in events:
            self._apply(ev)
            self._save_offset(int(ev["tsNs"]))
        return len(events)

    def run(self) -> None:
        failures = 0
        while not self._stop.is_set():
            try:
                n = self.sync_once()
                failures = 0
            except Exception as e:  # noqa: BLE001 — keep syncing; a
                n = 0               # down peer is retried next tick
                failures += 1
                if failures in (1, 10) or failures % 100 == 0:
                    log.warning(
                        "filer.sync %s -> %s failing (attempt %d): %s",
                        self.source, self.target, failures, e)
            if n == 0:
                self._stop.wait(self.poll_interval)

    def start(self) -> "FilerSync":
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
