"""Client verbs of the port (weed/operation/; `seaweedfs_tpu/operation.py`):
`master_json`, `assign`, `upload`, `assign_and_upload` / `submit`,
`lookup`, `read` with failover over a volume's locations, and `delete`.

Every call to a master goes through `master_json`, which takes one
address or a comma-separated seed list and follows the raft leader
(wdclient/masterclient.go: the re-dial on a leader announcement): the
leader cached for that seed list first, then the seeds, and a follower's
503 `{"error": "not leader", "leader": hint}` re-dials the hint.  The
follow stream (`wdclient.MasterFollower`) feeds the cache with the
leader it hears.  Under a deadline (`util/deadline`), assign,
upload, lookup and read derive each hop's timeout from the remaining
budget and forward it (the HTTP client stamps `X-Weed-Deadline-Ms`); a
spent budget raises `DeadlineExceeded` and is never taken for a failed
location.

`lookup` resolves from the follow stream's pushed map when
`enable_follow(master)` runs one (`wdclient.MasterFollower`, refcounted
a master), then from a TTL'd vid cache (weed/wdclient/vid_map.go), then
by asking the master.

A plain upload (no name, no mime) goes to the server's native write
plane, over a lean persistent socket a thread (`_plane_request`), at the
port the server's `/status` gives (cached per server).  A whole-needle
read takes the JAX package's ladder: a hedged read across the first two
locations when the request carries a deadline (`util/hedge`: each leg
runs its location's UDS, read plane and HTTP port in turn); then the
native read plane of each location; then the same-host UDS zero-copy
plane (`server/uds_reader.py`, at `/status`'s `udsPath`); then the HTTP
ports.  Every primary read that succeeds feeds the hedge's threshold.
A 404 or an unreachable plane falls through, byte for byte the path
without planes; everything else goes over the pooled keep-alive client
of `server/httpd.py`.

Security (`security.py`): an upload carries the assign's per-fid write
JWT, else one minted here with the write key; a read carries a read JWT
minted with the read key, and a delete a write JWT.  The native planes
and the UDS plane carry no JWT and no TLS, so the client tries them only
where neither the key of the operation nor `[tls]` is configured, as
the servers start them only there.  It imports no torch.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import urllib.parse
from dataclasses import dataclass

from . import profiling, security, tracing
from .server.httpd import http_bytes, http_json
from .server.uds_reader import uds_read_needle
from .storage import types
from .util import deadline, hedge


# the leader of each seed list, as last found (or announced on the
# follow stream)
_leader_cache: "dict[str, str]" = {}
_leader_lock = threading.Lock()

# what a leader new in office answers a lookup it cannot answer yet
WARMING = "topology warming"

# how long a call waits out an election: while a live member of the set
# answers "not leader" and no seed leads, the set is electing (4-8 raft
# pulses), and the call asks again rather than fail; so it does while a
# leader new in office answers a lookup `WARMING` (it has not heard every
# server yet: server/master_server.py)
ELECTION_WAIT = 10.0


def master_json(master: str, method: str, path: str,
                payload: dict | None = None, timeout: float = 30.0,
                headers: dict | None = None) -> dict:
    """Call a master endpoint through the seed list `master` (one address
    or a comma-separated list), following the leader: the cached leader
    of the list first, then each seed; a follower's `not leader` answer
    re-dials its hint.  The seed that answers is cached as the list's
    leader.  While some member answers but none leads, or the leader
    answers "topology warming", the round is repeated for up to
    `ELECTION_WAIT` seconds (at most `timeout`).
    Raises OSError when no seed answers (chained to the last transport
    error), `DeadlineExceeded` at once (another seed cannot give time
    back); any other answer with an "error" key is returned as is."""
    seeds = [x.strip() for x in master.split(",") if x.strip()]
    give_up = None
    while True:
        r, last, last_exc, electing = _master_round(
            master, seeds, method, path, payload, timeout, headers)
        if r is not None:
            return r
        if not electing:
            break
        now = time.monotonic()
        if give_up is None:
            give_up = now + min(ELECTION_WAIT, timeout)
        if now >= give_up:
            break
        time.sleep(0.1)
    raise OSError(f"master_json {path}: {last}") from last_exc


def _master_round(master, seeds, method, path, payload, timeout, headers):
    """One pass over the seeds: (answer or None, the last failure, its
    exception, whether a live member answered "not leader")."""
    with _leader_lock:
        cached = _leader_cache.get(master)
    order = ([cached] if cached else []) + [x for x in seeds if x != cached]
    last = "no masters configured"
    last_exc: "OSError | None" = None
    electing = False
    tried: "set[str]" = set()
    while order:
        url = order.pop(0)
        if url in tried:
            continue
        tried.add(url)
        try:
            r = http_json(method, f"{url}{path}", payload, timeout,
                          headers=headers)
        except deadline.DeadlineExceeded:
            raise
        except OSError as e:
            last, last_exc = f"{url}: {e}", e
            continue
        if r.get("error") == "not leader":
            electing = True
            hint = r.get("leader", "")
            last = f"{url}: not leader"
            if hint and hint not in tried:
                order.insert(0, hint)
            continue
        if r.get("error") == WARMING:
            electing = True
            last = f"{url}: {WARMING}"
            continue
        note_leader(master, url)
        return r, last, last_exc, electing
    return None, last, last_exc, electing


def note_leader(master: str, url: str) -> None:
    """Record `url` as the leader of the seed list `master`, which
    `master_json` dials first."""
    with _leader_lock:
        _leader_cache[master] = url


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
    auth: str = ""  # the per-fid write JWT the master minted


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
    with profiling.stage("assign"):
        r = master_json(master, "GET", f"/dir/assign?{qs}",
                        timeout=deadline.io_timeout(30.0,
                                                    site="master.assign"))
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
    UploadError with the status.  A plain upload tries the server's
    native write plane first, where no write key and no TLS are
    configured.  `auth` is the assign's per-fid write JWT; without it
    the upload is signed here when this process holds the write key
    (the derived fids of an assign batch)."""
    if not name and not mime and not auth and data and \
            _planes_allowed(write=True):
        with profiling.stage("upload"):
            r = _write_via_write_plane(url, fid, data)
        if r is not None:
            # the flight record: the C++ plane acked this write
            profiling.flight_note("nativePlane", "write")
            return r
    qs = "?" + urllib.parse.urlencode({"name": name}) if name else ""
    headers = {"Content-Type": mime} if mime else {}
    # a write of a fixed fid is idempotent (the server answers a replay
    # of the same fid, cookie and bytes "unchanged"), so the pooled
    # client may send it again when a reused socket died under it
    headers["X-Idempotent"] = "1"
    if not auth:
        auth = security.current().write_jwt(fid)
    if auth:
        headers["Authorization"] = f"Bearer {auth}"
    with profiling.stage("upload"):
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


_followers: "dict[str, object]" = {}
_follower_refs: "dict[str, int]" = {}
_followers_lock = threading.Lock()


def enable_follow(master: str) -> None:
    """Start the follow stream of `master` (a pushed vid map over its
    /cluster/watch, masterclient.go:471 KeepConnectedToMaster), or join
    the one running: refcounted, one a master spec in the process.  Each
    call is paired with one `disable_follow`; the stream stops when its
    last user leaves."""
    from .wdclient import MasterFollower
    with _followers_lock:
        _follower_refs[master] = _follower_refs.get(master, 0) + 1
        if master not in _followers:
            _followers[master] = MasterFollower(master).start()


def disable_follow(master: str) -> None:
    with _followers_lock:
        refs = _follower_refs.get(master, 0) - 1
        if refs > 0:
            _follower_refs[master] = refs
            return
        _follower_refs.pop(master, None)
        f = _followers.pop(master, None)
    if f is not None:
        f.stop()


def follower(master: str):
    """The running follow stream of `master`, or None."""
    return _followers.get(master)


def lookup(master: str, vid: int, use_cache: bool = True) -> list[dict]:
    """operation/lookup.go Lookup -> [{url, publicUrl}]: from the follow
    stream's pushed map when one runs, then the TTL'd cache, then the
    master.  `use_cache=False` asks the master (a caller that needs the
    current locations: the push may trail a volume that just moved)."""
    if use_cache:
        f = _followers.get(master)
        if f is not None:
            locs = f.get_locations(vid)
            if locs is not None:
                return locs
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
    """A whole or ranged needle read down the ladder of the module's
    docstring; when every location fails, the locations are looked up
    afresh and tried once more."""
    vid = int(fid.split(",", 1)[0])
    locs = lookup(master, vid)
    headers = {}
    key = cookie = -1
    read_auth = security.current().read_jwt(fid)
    if read_auth:
        headers["Authorization"] = f"Bearer {read_auth}"
    if offset or size is not None:
        end = f"{offset + size - 1}" if size is not None else ""
        headers["Range"] = f"bytes={offset}-{end}"
    elif _planes_allowed(write=False):
        # the planes' shape: a whole needle, where reads need no JWT
        try:
            part = fid.split(",", 1)[1]
            key, cookie = int(part[:-8], 16), int(part[-8:], 16)
        except (IndexError, ValueError):
            key = cookie = -1
    if len(locs) >= 2:
        # a deadline-carrying read past a slow replica: the first of two
        # legs to answer wins (None: not armed, or no success)
        body = _maybe_hedged_read(locs, fid, headers, vid, key, cookie)
        if body is not None:
            return body
    if key >= 0:
        t0 = time.monotonic()
        data = _read_via_read_plane(locs, fid)
        route = "read-cpp"
        if data is None:
            data = _read_via_uds(locs, vid, key, cookie)
            route = "read-uds"
        if data is not None:
            hedge.note_primary(time.monotonic() - t0)
            profiling.flight_note("nativePlane", route)
            return data
    last_err = None
    for attempt in range(2):
        for loc in locs:
            t0 = time.monotonic()
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
                hedge.note_primary(time.monotonic() - t0)
                return body
            last_err = f"{loc['url']} -> {status}"
        _vid_cache.invalidate(master, vid)
        if attempt == 0:
            try:
                locs = lookup(master, vid, use_cache=False)
            except LookupError as e:
                raise RuntimeError(f"read {fid}: {e}")
    raise RuntimeError(f"read {fid}: {last_err}")


# -- the native planes' funnel ----------------------------------------------

_status_cache: "dict[str, dict]" = {}
_status_lock = threading.Lock()


def _server_status(url: str) -> dict:
    """A volume server's `/status` (its plane ports), probed once and
    cached.  A probe that a spent budget cut short answers "no plane"
    for this request and is not cached."""
    with _status_lock:
        if url in _status_cache:
            return _status_cache[url]
    try:
        t = deadline.io_timeout(5.0, site="status.probe")
        st, body, _ = http_bytes("GET", f"{url}/status", None, None, t)
        doc = json.loads(body) if st == 200 else {}
    except deadline.DeadlineExceeded:
        return {}
    except (OSError, ValueError):
        d = deadline.get()
        if d is not None and d.expired():
            return {}
        doc = {}
    with _status_lock:
        _status_cache[url] = doc
    return doc


def _invalidate_status(url: str) -> None:
    """Forget a server's cached `/status`: a plane that refused a
    connection means the server restarted, and its plane ports moved."""
    with _status_lock:
        _status_cache.pop(url, None)


# The planes speak a strict, minimal HTTP/1.1, so their client skips
# http.client (several hundred microseconds of Python a call): a
# persistent socket a thread and plane, a request assembled by hand, a
# ~100-byte answer parsed with two partitions.
_plane_local = threading.local()


def _plane_request(addr: str, method: str, path: str, body: bytes = b"",
                   timeout: float = 10.0) -> "tuple[int, bytes]":
    """One request over the thread's persistent socket to a plane at
    `addr`: (status, body).  Sent again once on a fresh socket when a
    reused one failed (a plane request is idempotent: a write of a fixed
    fid, or a read).  `timeout` bounds the whole call, and a spent
    request budget raises DeadlineExceeded before anything is sent: the
    planes do not read `X-Weed-Deadline-Ms`.  OSError when the plane is
    unreachable."""
    socks = getattr(_plane_local, "socks", None)
    if socks is None:
        socks = _plane_local.socks = {}
    extra = ""
    rid = tracing.get_request_id()
    if rid:
        extra += f"{tracing.REQUEST_ID_HEADER}: {rid}\r\n"
    d = deadline.get()
    if d is not None:
        remaining_ms = int(d.remaining() * 1e3)
        if remaining_ms > 0:
            extra += f"{deadline.HEADER}: {remaining_ms}\r\n"
    req = (f"{method} {path} HTTP/1.1\r\nHost: {addr}\r\n{extra}"
           f"Content-Length: {len(body)}\r\n\r\n").encode()
    end = time.monotonic() + timeout

    def _left() -> float:
        # a spent request budget is the budget's verdict, never a wedged
        # plane's: that would drop a healthy server's cached status
        d = deadline.get()
        if d is not None and d.expired():
            deadline.note_exceeded("plane.io")
            raise deadline.DeadlineExceeded("plane.io")
        left = end - time.monotonic()
        if left <= 0:
            raise socket.timeout(f"plane {addr}: {timeout:.2f} s spent")
        return left

    for attempt in (0, 1):
        sock = socks.get(addr)
        reused = sock is not None
        if sock is None:
            host, _, port = addr.rpartition(":")
            sock = socket.create_connection((host, int(port)),
                                            timeout=_left())
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            socks[addr] = sock
        try:
            sock.settimeout(_left())
            if len(body) < (256 << 10):
                sock.sendall(req + body)
            else:
                sock.sendall(req)
                sock.sendall(body)
            buf = b""
            while b"\r\n\r\n" not in buf:
                sock.settimeout(_left())
                chunk = sock.recv(65536)
                if not chunk:
                    raise OSError("plane socket closed mid-response")
                buf += chunk
                if len(buf) > (64 << 10):
                    raise OSError("oversized plane response header")
            head, _, rest = buf.partition(b"\r\n\r\n")
            status = int(head.split(b" ", 2)[1])
            clen = 0
            for line in head.split(b"\r\n")[1:]:
                k, _, v = line.partition(b":")
                if k.strip().lower() == b"content-length":
                    clen = int(v.strip())
                    break
            while len(rest) < clen:
                sock.settimeout(_left())
                chunk = sock.recv(65536)
                if not chunk:
                    raise OSError("plane socket closed mid-body")
                rest += chunk
            return status, rest[:clen]
        except deadline.DeadlineExceeded:
            # an answer may be left on the wire: the socket goes, but no
            # fresh dial can bring budget back
            sock.close()
            socks.pop(addr, None)
            raise
        except OSError:
            sock.close()
            socks.pop(addr, None)
            if reused and attempt == 0:
                continue     # a stale keep-alive socket: one re-dial
            raise
    raise OSError("unreachable")  # pragma: no cover


def _plane_addr(url: str, key: str) -> "str | None":
    """host:port of the server's plane named by the /status `key`, or
    None when it runs none."""
    port = _server_status(url).get(key) or 0
    if not port:
        return None
    return f"{url.split('://')[-1].rsplit(':', 1)[0]}:{port}"


def _planes_allowed(write: bool) -> bool:
    """Whether the client may use the native and UDS planes: they carry
    no JWT and no TLS, so not where the operation's key or `[tls]` is
    configured (the servers do not start them there either)."""
    sec = security.current()
    key = sec.volume_write_key if write else sec.volume_read_key
    return not key and sec.tls is None


def _plane_vid_misses() -> dict:
    m = getattr(_plane_local, "vid_misses", None)
    if m is None:
        m = _plane_local.vid_misses = {}
    return m


def _write_via_write_plane(url: str, fid: str, data: bytes
                           ) -> "dict | None":
    """The write plane's answer to a plain upload, or None to send it to
    the HTTP port.  A 404 (a volume the plane does not own, a key it has
    seen) is remembered for 2 s a volume, so steady traffic to such a
    volume does not pay a plane round trip a write."""
    addr = _plane_addr(url, "writePlanePort")
    if addr is None:
        return None
    vid = fid.partition(",")[0]
    misses = _plane_vid_misses()
    until = misses.get((addr, vid))
    if until is not None:
        if time.monotonic() < until:
            return None
        del misses[(addr, vid)]
    # outside the try: a spent budget fails the write, it does not read
    # as a plane that is down
    t = deadline.io_timeout(10.0, site="plane.write")
    try:
        status, body = _plane_request(addr, "POST", f"/{fid}", data,
                                      timeout=t)
    except deadline.DeadlineExceeded:
        raise
    except OSError:
        # a wait the budget cut short is the budget's verdict
        deadline.reraise_if_expired("plane.write")
        _invalidate_status(url)      # a restarted server: probe again
        return None
    if status == 201:
        try:
            return json.loads(body)
        except ValueError:
            return None
    misses[(addr, vid)] = time.monotonic() + 2.0
    return None


def _read_via_read_plane(locs: "list[dict]", fid: str
                         ) -> "bytes | None":
    """A plain needle from the first location's read plane that serves
    it, or None: anything the plane does not hold (not registered yet,
    named, mimed, compressed, TTL'd, an EC volume) answers 404 and the
    caller reads through the HTTP ports."""
    for loc in locs:
        addr = _plane_addr(loc["url"], "readPlanePort")
        if addr is None:
            continue
        t = deadline.io_timeout(10.0, site="plane.read")
        try:
            status, body = _plane_request(addr, "GET", f"/{fid}",
                                          timeout=t)
        except deadline.DeadlineExceeded:
            raise
        except OSError:
            deadline.reraise_if_expired("plane.read")
            _invalidate_status(loc["url"])
            continue
        if status == 200:
            return body
    return None


def _uds_path_for(url: str) -> "str | None":
    """The server's UDS read socket when this host can reach it (the
    same machine, or a shared filesystem namespace), else None."""
    p = _server_status(url).get("udsPath") or ""
    return p if p and os.path.exists(p) else None


def _uds_read_one(loc: dict, vid: int, key: int, cookie: int
                  ) -> "tuple[bytes | None, bool]":
    """One location's UDS attempt: (data, stop).  Data on a success;
    stop when the needle's meaning lives on the server (compressed,
    a chunk manifest or TTL'd: the HTTP port must serve it, and every
    replica would answer alike); (None, False) when this location did
    not serve it (no socket here, a transport error, a miss, a cookie
    mismatch): the caller tries its next location or plane."""
    misses = _uds_vid_misses()
    until = misses.get((loc["url"], vid))
    if until is not None:
        if time.monotonic() < until:
            return None, False
        del misses[(loc["url"], vid)]
    p = _uds_path_for(loc["url"])
    if not p:
        return None, False
    try:
        n = uds_read_needle(p, vid, key,
                            timeout=deadline.io_timeout(10.0,
                                                        site="uds.read"))
    except deadline.DeadlineExceeded:
        raise
    except LookupError as e:
        if str(e).startswith("volume "):
            # no normal volume `vid` there (an EC volume, say): every
            # read of it would miss, so skip the socket for 2 s
            misses[(loc["url"], vid)] = time.monotonic() + 2.0
        return None, False
    except (OSError, ValueError):
        return None, False
    if n.cookie != cookie:
        return None, False
    if n.is_compressed() or n.is_chunked_manifest() or n.has_ttl():
        return None, True
    return bytes(n.data), False


def _uds_vid_misses() -> dict:
    """This thread's (server url, vid) -> monotonic time until which the
    UDS reader is skipped for a vid the server does not hold as a normal
    volume (the JAX client asks every location on every read)."""
    m = getattr(_plane_local, "uds_misses", None)
    if m is None:
        m = _plane_local.uds_misses = {}
    return m


def _read_via_uds(locs: "list[dict]", vid: int, key: int, cookie: int
                  ) -> "bytes | None":
    """The same-host zero-copy read: the raw record over the server's
    Unix socket, checked here.  None where it does not apply (no local
    socket, or a needle whose meaning lives on the server)."""
    for loc in locs:
        data, stop = _uds_read_one(loc, vid, key, cookie)
        if data is not None:
            return data
        if stop:
            return None
    return None


def _maybe_hedged_read(locs: "list[dict]", fid: str, headers: dict,
                       vid: int = -1, key: int = -1, cookie: int = -1
                       ) -> "bytes | None":
    """A first-wins read of `fid` across the first two locations
    (`util/hedge`), for requests that carry a deadline only, once the
    tracker knows what slow is and the budget leaves room for a second
    leg.  Each leg runs its location's whole ladder: for a whole needle
    (`key` >= 0) UDS first, the read plane second, then the HTTP port,
    so one wedged replica costs about the p95 whichever plane it is
    wedged on.  None: not armed, or no leg succeeded."""
    d = deadline.get()
    if d is None or not hedge.reads_enabled():
        return None
    threshold = hedge.read_threshold()
    if threshold is None:
        return None                       # a cold tracker
    if d.remaining() <= threshold + deadline.MIN_TIMEOUT:
        return None                       # no room for a second leg

    def fetch(loc):
        if key >= 0:
            data, _stop = _uds_read_one(loc, vid, key, cookie)
            if data is not None:
                return 200, data
            addr = _plane_addr(loc["url"], "readPlanePort")
            if addr:
                try:
                    status, pbody = _plane_request(
                        addr, "GET", f"/{fid}",
                        timeout=deadline.io_timeout(10.0,
                                                    site="plane.read"))
                    if status == 200:
                        return 200, pbody
                except deadline.DeadlineExceeded:
                    raise
                except OSError:
                    # a raced leg: the HTTP port next, and the status
                    # cache is the sequential path's to drop
                    pass
        status, body, _ = http_bytes(
            "GET", f"{loc['url']}/{fid}", None, headers,
            timeout=deadline.io_timeout(60.0, site="volume.read"))
        return status, body

    val, _hedged = hedge.hedged_fetch(
        lambda: fetch(locs[0]), lambda: fetch(locs[1]), threshold,
        lambda sv: sv[0] in (200, 206), kind="read")
    return val[1] if val is not None else None


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
    headers = security.current().write_headers(fid)
    for loc in locs:
        try:
            status, body, _ = http_bytes("DELETE", f"{loc['url']}/{fid}",
                                         headers=headers, timeout=60.0)
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
