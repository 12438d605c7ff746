"""Client verbs of the port (weed/operation/; `seaweedfs_tpu/operation.py`):
`master_json`, `assign`, `upload`, `assign_and_upload` / `submit`,
`lookup` through a TTL'd vid cache (weed/wdclient/vid_map.go), `read`
with failover over a volume's locations, and `delete`.

The port's master is a single node, so there is no leader to follow:
the seeds of a comma-separated list are tried in order and the first
that answers is used.  Under a deadline (`util/deadline`), assign,
upload, lookup and read derive each hop's timeout from the remaining
budget and forward it (the HTTP client stamps `X-Weed-Deadline-Ms`); a
spent budget raises `DeadlineExceeded` and is never taken for a failed
location.  No JWTs, hedged reads, native read or write planes, or
follow-mode lookups (ROADMAP).  It imports no torch.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from dataclasses import dataclass

from .server.httpd import http_bytes, http_json
from .storage import types
from .util import deadline


def master_json(master: str, method: str, path: str,
                payload: dict | None = None, timeout: float = 30.0,
                headers: dict | None = None) -> dict:
    """Call a master endpoint on the first reachable seed of `master`
    (one address or a comma-separated list).  Raises OSError when no
    seed answers; an answer with an "error" key is returned as is."""
    seeds = [s.strip() for s in master.split(",") if s.strip()]
    last = "no masters configured"
    for url in seeds:
        try:
            return http_json(method, f"{url}{path}", payload, timeout,
                             headers=headers)
        except OSError as e:
            last = f"{url}: {e}"
    raise OSError(f"master_json {path}: {last}")


class VidCache:
    """wdclient/vid_map.go: volume id -> locations for TTL seconds (on the
    monotonic clock), dropped when a read through them fails."""

    TTL = 10.0

    def __init__(self):
        self._m: dict[tuple[str, int], tuple[float, list[dict]]] = {}
        self._lock = threading.Lock()

    def get(self, master: str, vid: int) -> "list[dict] | None":
        with self._lock:
            hit = self._m.get((master, vid))
            if hit and time.monotonic() - hit[0] < self.TTL:
                return hit[1]
        return None

    def put(self, master: str, vid: int, locs: list[dict]) -> None:
        with self._lock:
            self._m[(master, vid)] = (time.monotonic(), locs)

    def invalidate(self, master: str, vid: int) -> None:
        with self._lock:
            self._m.pop((master, vid), None)


_vid_cache = VidCache()


@dataclass
class Assignment:
    fid: str
    url: str
    public_url: str
    count: int
    auth: str = ""  # a per-fid JWT: the port's master mints none


def assign(master: str, count: int = 1, collection: str = "",
           replication: str = "", ttl: str = "") -> Assignment:
    """operation/assign_file_id.go Assign."""
    qs = f"count={count}"
    if collection:
        qs += f"&collection={collection}"
    if replication:
        qs += f"&replication={replication}"
    if ttl:
        qs += f"&ttl={ttl}"
    r = master_json(master, "GET", f"/dir/assign?{qs}",
                    timeout=deadline.io_timeout(30.0, site="master.assign"))
    if "error" in r:
        raise RuntimeError(f"assign: {r['error']}")
    return Assignment(r["fid"], r["url"], r.get("publicUrl", r["url"]),
                      r.get("count", count), r.get("auth", ""))


class UploadError(RuntimeError):
    def __init__(self, msg: str, status: int):
        super().__init__(msg)
        self.status = status


def upload(url: str, fid: str, data: bytes, name: str = "",
           mime: str = "", auth: str = "") -> dict:
    """operation/upload_content.go Upload: POST the needle to a volume
    server; its JSON answer (`name`, `size`, `eTag`, `unchanged`), or
    UploadError with the status."""
    qs = "?" + urllib.parse.urlencode({"name": name}) if name else ""
    headers = {"Content-Type": mime} if mime else {}
    if auth:
        headers["Authorization"] = f"Bearer {auth}"
    status, body, _ = http_bytes(
        "POST", f"{url}/{fid}{qs}", data, headers,
        timeout=deadline.io_timeout(60.0, site="volume.upload"))
    if status >= 300:
        raise UploadError(f"upload {fid} -> {status}: {body[:200]!r}",
                          status)
    return json.loads(body)


class _AssignCache:
    """Assign batching: one master round trip reserves a range of keys
    (assign?count=N against a range-reserving sequencer), and the next
    N-1 writes derive their fids locally: same vid and cookie, key+i
    (the reference's count-assign contract).  A window expires after
    TTL seconds, so a volume the master would no longer pick is not
    written long after its state changed, and any upload failure drops
    it before the retry assigns afresh."""

    TTL = 2.0

    def __init__(self):
        self._m: dict = {}          # spec -> [Assignment, next_i, expiry]
        self._lock = threading.Lock()
        # one refresher a spec: when a window runs out, every writer
        # misses at once, and the rest wait and take from the new one
        self._refresh: dict = {}

    def refresh_lock(self, spec) -> "threading.Lock":
        with self._lock:
            lk = self._refresh.get(spec)
            if lk is None:
                lk = self._refresh[spec] = threading.Lock()
            return lk

    def take(self, spec) -> "Assignment | None":
        with self._lock:
            ent = self._m.get(spec)
            if ent is None:
                return None
            a, i, exp = ent
            if i >= a.count or time.monotonic() > exp:
                del self._m[spec]
                return None
            ent[1] += 1
        if i == 0:
            return a
        base = types.parse_file_id(a.fid)
        fid = str(types.FileId(base.volume_id, base.key + i, base.cookie))
        return Assignment(fid, a.url, a.public_url, 1, auth="")

    def put(self, spec, a: Assignment) -> None:
        if a.count <= 1:
            return
        with self._lock:
            # next_i 1: the base fid goes to the caller
            self._m[spec] = [a, 1, time.monotonic() + self.TTL]

    def invalidate(self, spec) -> None:
        with self._lock:
            self._m.pop(spec, None)


_assign_cache = _AssignCache()


def assign_batch_size() -> int:
    """SEAWEEDFS_TPU_ASSIGN_BATCH: the fids an assign reserves for the
    next writes (default 16; 1 assigns for every write)."""
    try:
        return max(1, int(os.environ.get(
            "SEAWEEDFS_TPU_ASSIGN_BATCH", "") or 16))
    except ValueError:
        return 16


def assign_and_upload(master: str, data: bytes, name: str = "",
                      mime: str = "", collection: str = "",
                      replication: str = "", ttl: str = "",
                      retries: int = 3) -> "tuple[Assignment, dict]":
    """Assign, then upload, with a fresh assign on each retry.  Retried:
    transport failures, 5xx, and 409 (a volume made read-only between
    the assign and the upload: the assignment is stale, not the data).
    Other 4xx raise at once, unless the fid came from the window cache.
    Returns (assignment, upload answer)."""
    last: Exception | None = None
    batch = assign_batch_size()
    spec = (master, collection, replication, ttl)
    for attempt in range(max(retries, 1)):
        if attempt:
            # the usual cause is a volume state the master has not
            # absorbed yet: an assign in the same millisecond replays it
            time.sleep(0.05 * attempt)
        from_cache = False
        try:
            a = _assign_cache.take(spec) if batch > 1 and \
                not attempt else None
            from_cache = a is not None
            if a is None and batch > 1 and not attempt:
                with _assign_cache.refresh_lock(spec):
                    a = _assign_cache.take(spec)
                    from_cache = a is not None
                    if a is None:
                        a = assign(master, count=batch,
                                   collection=collection,
                                   replication=replication, ttl=ttl)
                        _assign_cache.put(spec, a)
            elif a is None:
                a = assign(master, count=batch, collection=collection,
                           replication=replication, ttl=ttl)
            r = upload(a.url, a.fid, data, name=name, mime=mime,
                       auth=a.auth)
            return a, r
        except UploadError as e:
            _assign_cache.invalidate(spec)
            if not from_cache and e.status != 409 and e.status < 500:
                raise  # a deterministic rejection
            last = e
        except deadline.DeadlineExceeded:
            raise  # a retry cannot change a spent budget's verdict
        except (RuntimeError, OSError) as e:
            _assign_cache.invalidate(spec)
            last = e
    raise RuntimeError(f"upload failed after {retries} attempts: {last}")


def submit(master: str, data: bytes, name: str = "", mime: str = "",
           collection: str = "", replication: str = "",
           ttl: str = "", retries: int = 3) -> str:
    """operation/submit.go: assign + upload; returns the fid."""
    a, _ = assign_and_upload(master, data, name=name, mime=mime,
                             collection=collection,
                             replication=replication, ttl=ttl,
                             retries=retries)
    return a.fid


def lookup(master: str, vid: int, use_cache: bool = True) -> list[dict]:
    """operation/lookup.go Lookup -> [{url, publicUrl}], from the TTL'd
    cache unless `use_cache` is False, else from the master."""
    if use_cache:
        cached = _vid_cache.get(master, vid)
        if cached is not None:
            return cached
    r = master_json(master, "GET", f"/dir/lookup?volumeId={vid}",
                    timeout=deadline.io_timeout(30.0, site="master.lookup"))
    if "error" in r:
        raise LookupError(r["error"])
    _vid_cache.put(master, vid, r["locations"])
    return r["locations"]


def read(master: str, fid: str, offset: int = 0,
         size: int | None = None) -> bytes:
    """A whole or ranged needle read: each location in turn; when all
    fail, the locations are looked up afresh and tried once more."""
    vid = int(fid.split(",", 1)[0])
    locs = lookup(master, vid)
    headers = {}
    if offset or size is not None:
        end = f"{offset + size - 1}" if size is not None else ""
        headers["Range"] = f"bytes={offset}-{end}"
    last_err = None
    for attempt in range(2):
        for loc in locs:
            try:
                status, body, _ = http_bytes(
                    "GET", f"{loc['url']}/{fid}", None, headers,
                    timeout=deadline.io_timeout(60.0, site="volume.read"))
            except deadline.DeadlineExceeded:
                raise
            except OSError as e:
                # a timeout that the budget capped is the budget's
                # verdict, not the location's
                deadline.reraise_if_expired("volume.read")
                last_err = f"{loc['url']} -> {e}"
                continue
            if status in (200, 206):
                return body
            last_err = f"{loc['url']} -> {status}"
        _vid_cache.invalidate(master, vid)
        if attempt == 0:
            try:
                locs = lookup(master, vid, use_cache=False)
            except LookupError as e:
                raise RuntimeError(f"read {fid}: {e}")
    raise RuntimeError(f"read {fid}: {last_err}")


def delete(master: str, fid: str) -> None:
    """operation/delete_content.go: delete at one location; the volume
    server fans it out to the other holders, even when its own copy is
    gone, so a 2xx anywhere means every holder was told.  A location
    that answers 404 may not hold the volume, so the loop goes on past
    it; only when every location answered 404 is the needle taken as
    gone.  Anything else raises: a lost delete is never silent."""
    vid = int(fid.split(",", 1)[0])
    last = "no locations"
    # a fresh lookup: all-404 means gone only over current locations
    locs = lookup(master, vid, use_cache=False)
    answered = 0
    for loc in locs:
        try:
            status, body, _ = http_bytes("DELETE", f"{loc['url']}/{fid}",
                                         timeout=60.0)
        except OSError as e:
            last = f"{loc['url']}: {e}"
            continue
        if status < 300:
            return
        if status == 404:
            answered += 1
            continue
        last = f"{loc['url']} -> {status}: {body[:200]!r}"
    if locs and answered == len(locs):
        return
    raise RuntimeError(f"delete {fid}: {last}")
