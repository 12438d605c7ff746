"""Filer HTTP server (weed/server/filer_server.go + handlers), the port's
copy of `seaweedfs_tpu/server/filer_server.py`, one process.

Over a sqlite file the Filer runs its meta plane (filer/meta_plane.py)
by default, and this server arms two native planes beside the Python
port, as the JAX filer does:
- the meta plane (server/meta_plane_native.py): plain single-chunk PUTs
  into provably fresh directories, parsed, uploaded to the volume write
  plane, WAL-appended and acked by a C++ epoll loop;
- the read plane (server/filer_read_plane_native.py): warm single-chunk
  GETs served from a C-side entry map by a C++ epoll loop that fetches
  from the volume read plane.
Each answers what it does not own with 404 `{"error":"... plane
fallback"}`, and the client replays it on this port.  `GET /status`
advertises their ports (`metaPlanePort`, `readPlanePort`; 0 when
disarmed), `POST /debug/meta_plane` and `POST /debug/read_plane`
(`{"native": "on"|"off"}`) arm and disarm them, and `/metrics` renders
their counters.  `SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE=0` and
`SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE=0` keep them off; the native meta
plane needs the Python meta plane.  A plane that fails to build or start
is logged and counted (`filer_native_plane_unavailable_total{plane}`),
and this port serves its traffic.  Under `security.toml` the planes
stand down, logged and counted in
`filer_native_plane_stood_down_total{plane,reason}`: neither starts
under `[tls]` (they speak plain text) or under a `[qos.default]` limit
(reason "qos": they serve anonymous requests without admission; a
tenant-tagged request goes to this port), the meta plane's fid pool stays
dry when assigns carry a write JWT, and the read plane takes no entry
when a read key is set; the admin paths (`/debug/*`) need the admin
JWT.  A started filer follows the master's
location pushes (`operation.enable_follow`), so its chunk lookups and
the read plane's fills resolve without a lookup RPC; `GET
/debug/follow` shows the stream's state, the leader it follows and the
pushed map.  `-master` may be the seed list of an HA master set: every
call follows the leader (`operation.master_json`).

A started filer runs the SLO autopilot (autopilot.py, `GET/POST
/debug/autopilot`) unless `SEAWEEDFS_TPU_AUTOPILOT=0`: it moves the
hedge's ratio and floor, the brownout factor and the chunk and meta
caches, and its plane guards disarm a native plane whose errors spike
and re-arm it after probation, through `plane_lever`, which refuses
while the planes stand down.

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

A local store (a sqlite file or an lsm directory) keeps its metadata
log in `<store>.metalog`, so two filers over one store share one log dir
and see each other's commits (through its watermark files, or the meta
plane's log follower).

A pre-fork fleet (`filer -workers N`, __main__.py) runs N such
processes over one store on one port (`reuse_port`: SO_REUSEPORT).  In
a sibling the meta cache stays off when the meta plane is off (the
shared watermark advances at the fleet's commit rate, so a fill would
live one sibling commit), and the native read plane runs only with the
meta plane, whose log-follower tap tells it of every sibling's writes.

Observability: the server spans, `filer_request_seconds` and
`filer_request_cpu_seconds` (httpd's middleware, either front), a write
track a PUT (`filer_write_stage_seconds{stage}`: recv, assign, upload,
meta, gc), the flight recorder and the debug routes (server/debug.py),
and the native planes' record drains.

The rest of the JAX filer:
- stores (`store_type`): sqlite (a file or ":memory:"), lsm (a
  directory, filer/lsm_store.py; the meta plane checkpoints into it as
  into a sqlite file), redis (`store_path` the host:port of a RESP
  server) and elastic (an ES-wire server).  A remote store keeps its
  metalog in `filer-<type>-<address>-p<port>.metalog` in the working
  directory, and its meta cache stays off (`SEAWEEDFS_TPU_FILER_META_
  CACHE=force` turns it on): co-located filers over one remote store
  keep distinct logs, so no watermark tells one of the other's writes;
- TUS resumable uploads (`/__tus__/`: POST `?path=` with
  `Upload-Length`, HEAD for the offset, PATCH at it, DELETE), their
  parts staged as files under `/.tus/<id>/` and stitched by chunk list;
- the lock ring (`/admin/locks/acquire|release|list`; `lock_peers`
  names every member, this filer among them, or the constructor
  raises); a key owned by another member answers `movedTo`;
- notification (`notification`, a `notification.from_spec` string):
  started with the server, a `NotificationTailer` follows the metalog
  and publishes every event, its offset in `<metalog>/notify.offset`;
- remote mounts: an entry with a remote marker and no chunks is read
  through from the mount's S3 store (remote/).
Not ported (ROADMAP): gRPC.
"""

from __future__ import annotations

import json
import os
import urllib.parse
import uuid

from .. import autopilot as _autopilot
from .. import faults, notification, operation, profiling, qos, security
from .. import stats
from ..cluster.lock_manager import LockManager, normalize_address
from ..filer import Entry, Filer
from ..filer.entry import Attributes
from ..filer.filer_store import FilerStore, SqliteStore
from ..util import wlog
from ..util.chunk_cache import read_cache_disk
from .httpd import HttpServer, Request, admin_guard, parse_range
from .debug import (install_autopilot_routes, install_debug_routes,
                    start_process_probes)
from .meta_plane_native import note_stood_down


def open_store(store_type: str, store_path: str) -> FilerStore:
    """The filer store `-storeType` names over `-store`: a sqlite file
    (or ":memory:"), an lsm directory, or the host:port of a RESP or
    ES-wire server."""
    if store_type == "sqlite":
        return SqliteStore(store_path)
    if store_type == "lsm":
        if store_path == ":memory:":
            raise ValueError(
                "the lsm store needs a directory path, not :memory: (use "
                "-storeType sqlite for in-memory)")
        from ..filer.lsm_store import LsmStore
        return LsmStore(store_path)
    if store_type == "redis":
        from ..filer.redis_store import RedisFilerStore, RespClient
        r_host, _, r_port = store_path.rpartition(":")
        if not r_host or not r_port.isdigit():
            raise ValueError("-storeType redis needs -store host:port of "
                             "a RESP server")
        return RedisFilerStore(RespClient(r_host, int(r_port)))
    if store_type == "elastic":
        from ..filer.elastic_store import ElasticClient, ElasticFilerStore
        return ElasticFilerStore(ElasticClient(store_path))
    raise ValueError(f"unknown filer store type {store_type!r} "
                     f"(sqlite|lsm|redis|elastic)")


def cluster_statistics(master: str, collection: str = "") -> dict:
    """Aggregate used/total/file counts from the master topology, the
    filer Statistics feed (filer.proto Statistics).  Raises OSError
    when the master is unreachable."""
    vl = operation.master_json(master, "GET", "/dir/status", timeout=30)
    cs = operation.master_json(master, "GET", "/cluster/status", timeout=30)
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
                 meta_log_dir: str | None = None,
                 store_type: str = "sqlite",
                 notification: str = "",
                 lock_peers: "list[str] | None" = None,
                 reuse_port: bool = False):
        self._notification_spec = notification
        self._notifier = None
        # bind the listener FIRST: it fails fast on a taken port,
        # before any store file is touched, and a remote store's
        # metalog dir below needs the resolved port
        self.http = HttpServer(host, port, reuse_port=reuse_port)
        try:
            local = store_type in ("sqlite", "lsm")
            if meta_log_dir is None and store_path != ":memory:" and local:
                # the metadata log persists beside the store:
                # subscribers must survive a restart, and siblings over
                # one store share it (filer_notify_append.go)
                meta_log_dir = store_path + ".metalog"
            elif meta_log_dir is None and not local:
                # a remote store's path is an address: the log goes to
                # the working directory, one per address AND port, so
                # two co-located filers over one server never interleave
                # their stamp clocks (a pinned port keeps it across
                # restarts)
                safe = store_path.replace(":", "_").replace("/", "_")
                meta_log_dir = (f"filer-{store_type}-{safe}"
                                f"-p{self.http.port}.metalog")
            store = open_store(store_type, store_path)
            from ..filer.meta_plane import meta_plane_enabled
            # will the meta plane run here?  (Filer decides; this is its
            # gate, for the fleet's cache decision)
            plane_on = local and store_path != ":memory:" and \
                meta_plane_enabled() is not False
            # the cache's cross-filer coherence rides the shared metalog
            # dir, which filers over one remote store do not share; and
            # a sibling of a fleet without the meta plane sees the
            # shared watermark move at the fleet's commit rate, every
            # fill invalidated at once (with the plane, sibling commits
            # arrive as per-path invalidations and fills survive)
            forced = os.environ.get(
                "SEAWEEDFS_TPU_FILER_META_CACHE") == "force"
            coherent = forced or (local and (plane_on or not reuse_port))
            # the disk tier of the chunk cache, when one is configured,
            # gets a directory of this filer's own
            cache_dir, _ = read_cache_disk()
            self.filer = Filer(
                master, store, collection=collection,
                replication=replication, meta_log_dir=meta_log_dir,
                meta_cache=coherent, meta_plane=None if local else False,
                chunk_cache_dir=(os.path.join(cache_dir,
                                              f"filer{self.http.port}")
                                 if cache_dir else None))
        except BaseException:
            # a store-setup failure must not leak a bound socket
            self.http.stop()
            raise
        # the lock ring (distributed_lock_manager.go): every member's
        # -lockPeers names the same filers, each key hashes to one of
        # them; the ring compares normalized addresses, and one that
        # does not name this filer is refused (a diverged ring could
        # grant one lock twice)
        self._ring_self = normalize_address(
            f"[{self.http.host}]:{self.http.port}"
            if ":" in self.http.host else self.http.url)
        self.lock_manager = LockManager(self._ring_self)
        if lock_peers:
            members = {normalize_address(p) for p in lock_peers}
            if self._ring_self not in members:
                self.filer.close()
                self.http.stop()
                raise ValueError(
                    f"filer {self.http.url} (normalized "
                    f"{self._ring_self}) is not in -lockPeers "
                    f"{sorted(members)}; every filer must appear in "
                    f"the shared peer list under a spelling that "
                    f"normalizes to its advertised address")
            self.lock_manager.members = sorted(members)
        self.metrics = stats.Metrics("filer")
        self.http.role = "filer"
        self.http.metrics = self.metrics
        # the planes bind the listener's address when it is numeric
        plane_host = self.http.host if all(
            c in "0123456789." for c in self.http.host) else "127.0.0.1"
        self.native_meta = None
        planes_down = self.planes_stood_down()
        if planes_down:
            for name in ("meta", "read"):
                note_stood_down(name, planes_down)
        if self.filer.meta_plane is not None and not planes_down:
            from .meta_plane_native import (NativeMetaPlane,
                                            native_meta_plane_enabled)
            if native_meta_plane_enabled() is not False:
                self.native_meta = self._start_plane(
                    "meta", lambda: NativeMetaPlane(
                        self.filer.meta_log.dir, master, host=plane_host,
                        collection=collection, replication=replication))
        from .filer_read_plane_native import (NativeReadPlane,
                                              native_read_plane_enabled)
        self.native_read = None
        # the read plane's entry map needs an event of every writer of
        # the namespace: this process's own, and in a fleet the
        # siblings' through the meta plane's log follower
        if native_read_plane_enabled() is not False and \
                not planes_down and \
                (self.filer.meta_plane is not None or not reuse_port):
            self.native_read = self._start_plane(
                "read", lambda: NativeReadPlane(master, host=plane_host))
        # entry truth flows in from both sides: this process's own
        # Python-path mutations (the listener) and every sibling
        # writer's WAL lines, the native meta plane's included (the
        # meta plane's follower tap, fanned out to both planes)
        taps = []
        for plane in (self.native_meta, self.native_read):
            if plane is not None:
                self.filer.subscribe(plane.on_event)
                taps.append(plane.on_follower_events)
        if taps and self.filer.meta_plane is not None:
            def _fan_sink(evs, _taps=tuple(taps)):
                evs = list(evs)   # every tap sees the full batch
                for t in _taps:
                    t(evs)
            self.filer.meta_plane.sink = _fan_sink
        for plane in (self.native_meta, self.native_read):
            if plane is not None:
                plane.arm(True)
                # the plane's flight ring, drained into the stage
                # histograms and the recorder on a tick and at scrapes
                plane.start_record_drain()
        r = self.http.route
        r("GET", "/status", self._status)
        r("GET", "/debug/follow", self._follow_state)
        r("GET", "/metrics", self._metrics)
        r("POST", "/debug/meta_plane", self._debug_meta_plane)
        r("POST", "/debug/read_plane", self._debug_read_plane)
        r("GET", "/__meta__/lookup", self._meta_lookup)
        r("POST", "/__meta__/rename", self._meta_rename)
        r("POST", "/__meta__/set_attrs", self._meta_set_attrs)
        r("POST", "/__meta__/create", self._meta_create)
        r("POST", "/__meta__/put_entry", self._meta_put_entry)
        r("POST", "/__meta__/patch_extended", self._meta_patch_extended)
        r("GET", "/__meta__/events", self._meta_events)
        r("GET", "/__meta__/statistics", self._meta_statistics)
        r("POST", "/admin/locks/acquire", self._lock_acquire)
        r("POST", "/admin/locks/release", self._lock_release)
        r("GET", "/admin/locks/list", self._lock_list)
        install_debug_routes(self.http)
        for m in ("OPTIONS", "POST", "HEAD", "PATCH", "DELETE", "GET",
                  "PUT"):
            self.http.route_prefix(m, "/__tus__/", self._tus_route)
        self.http.route_prefix("POST", "/__chunk__/", self._chunk_route)
        self.http.fallback = self._dispatch
        self.http.guard = admin_guard
        # QoS: tenant admission at the filer's edge, and this filer's
        # foreground (its request_seconds and its planes' walls) feeds
        # the process's EC throttle
        qos.install(self.http, "filer")
        qos.throttle().add_metrics(f"filer:{self.http.port}", self.metrics)
        qos.throttle().add_metrics(f"filer:{self.http.port}:planes",
                                   stats.PROCESS,
                                   names=("plane_request_seconds",))
        qos.throttle().maybe_start()
        # the SLO autopilot (autopilot.py): the hedge, brownout and
        # cache knobs, and guards over both native planes; start() runs
        # it unless SEAWEEDFS_TPU_AUTOPILOT=0, /debug/autopilot serves
        # either way
        self.autopilot = _autopilot.build_for_filer(self)
        install_autopilot_routes(self.http, self.autopilot)

    @staticmethod
    def planes_stood_down() -> "str | None":
        """Why the native planes stay down here ("tls", "qos"), or None:
        under `[tls]` they would speak plain text, and under a
        `[qos.default]` limit serve what admission refuses."""
        if security.current().tls is not None:
            return "tls"
        if qos.anonymous_limited():
            return "qos"
        return None

    def plane_lever(self, plane):
        """A plane guard's lever: it disarms at once, and arms only while
        no stand-down holds, so probation never brings back a plane that
        the configuration keeps down."""
        def arm(on: bool) -> None:
            reason = self.planes_stood_down() if on else None
            if reason:
                raise RuntimeError(f"the planes stand down ({reason})")
            plane.arm(on)
        return arm

    @staticmethod
    def _start_plane(name: str, make):
        """A native plane, or None when it does not build or start: the
        cause goes to stderr and `filer_native_plane_unavailable_total`,
        and the Python port serves the plane's traffic."""
        try:
            return make()
        except (RuntimeError, OSError) as e:
            wlog.warning(f"filer: native {name} plane off: {e}",
                         component="filer")
            stats.PROCESS.counter_add(
                "filer_native_plane_unavailable_total", 1.0,
                help_text="native filer planes that failed to build or "
                          "start (the Python port serves their traffic)",
                plane=name)
            return None

    def start(self) -> "FilerServer":
        start_process_probes()
        self.http.start()
        # the follow stream: chunk lookups and the read plane's fills
        # resolve from the master's pushes (masterclient.go:471)
        operation.enable_follow(self.filer.master)
        if _autopilot.enabled_by_env():
            self.autopilot.start()
        if self._notification_spec:
            # every namespace mutation goes to the sink, at least once:
            # the tailer's offset advances after a publish succeeded
            self._notifier = notification.NotificationTailer(
                self.filer.meta_log,
                notification.from_spec(self._notification_spec),
                state_path=(os.path.join(self.filer.meta_log.dir,
                                         "notify.offset")
                            if self.filer.meta_log.dir else None)).start()
        return self

    def stop(self) -> None:
        self.autopilot.stop()
        if self._notifier is not None:
            self._notifier.stop()
        # the native planes before the Python listener: once a plane
        # stops acking, clients retry here and must still find a
        # server; the meta plane's final apply (Filer.close) last
        if self.native_meta is not None:
            self.native_meta.stop()
        if self.native_read is not None:
            self.native_read.stop()
        self.http.stop()
        qos.throttle().remove_source(f"filer:{self.http.port}")
        qos.throttle().remove_source(f"filer:{self.http.port}:planes")
        operation.disable_follow(self.filer.master)
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
        self.metrics.gauge_set(
            "locks_held", float(len(self.lock_manager.all_locks())),
            help_text="distributed locks currently held here")
        if self.filer.meta_plane is not None:
            mp = self.filer.meta_plane.snapshot()
            self.metrics.gauge_set(
                "meta_plane_overlay_entries", float(mp["overlay"]),
                help_text="WAL-acked entries awaiting the async store "
                          "checkpoint (the overlay index)")
            self.metrics.gauge_set(
                "meta_plane_applier", float(bool(mp["holder"])),
                help_text="1 when this process holds the designated-"
                          "applier lock for the shared metalog")
            self.metrics.gauge_set(
                "meta_plane_checkpoint_ts_ns",
                float(mp["checkpointTsNs"]),
                help_text="newest event stamp the store checkpoint "
                          "covers")
        return 200, ((self.metrics.render() +
                      self._native_meta_metrics_text() +
                      self._native_read_metrics_text() +
                      stats.render_process()).encode(),
                     {"Content-Type": "text/plain; version=0.0.4"})

    @staticmethod
    def _plane_text(prefix: str, st: dict, counters, stages,
                    gauge: "tuple[str, str, float]", hist_name: str,
                    bounds, hist) -> str:
        """One native plane's counters, stage walls, gauge and latency
        histogram in the Prometheus text format, read from the C++
        atomics at scrape time."""
        out = []
        for key, help_text in counters:
            name = f"{prefix}_{key}_total"
            out.append(f"# HELP {name} {help_text}\n"
                       f"# TYPE {name} counter\n{name} {st[key]}\n")
        name = f"{prefix}_stage_seconds_total"
        out.append(f"# HELP {name} cumulative native-plane wall per "
                   f"stage\n# TYPE {name} counter\n")
        for stage in stages:
            out.append(f'{name}{{stage="{stage}"}} '
                       f"{st[stage + '_ns'] / 1e9}\n")
        gname, ghelp, gvalue = gauge
        out.append(f"# HELP {prefix}_{gname} {ghelp}\n"
                   f"# TYPE {prefix}_{gname} gauge\n"
                   f"{prefix}_{gname} {gvalue}\n")
        buckets, count, total_s = hist
        name = f"{prefix}_{hist_name}"
        out.append(f"# HELP {name} native-plane latency\n"
                   f"# TYPE {name} histogram\n")
        for le, cum in zip(bounds, buckets):
            out.append(f'{name}_bucket{{le="{le}"}} {cum}\n')
        out.append(f'{name}_bucket{{le="+Inf"}} {count}\n'
                   f"{name}_sum {total_s}\n{name}_count {count}\n")
        return "".join(out)

    def _native_meta_metrics_text(self) -> str:
        """The native meta plane's requests, fallbacks and fid pool, its
        ack latency histogram and its wall split (parse, upload, wal)."""
        nm = self.native_meta
        if nm is None:
            return ""
        from .meta_plane_native import ACK_BUCKETS_S
        return self._plane_text(
            "filer_meta_plane_native", nm.stats(), (
                ("requests", "filer writes acked by the native meta "
                             "plane"),
                ("fallbacks", "native meta-plane requests answered 404 "
                              "(the python filer owns them)"),
                ("fid_misses", "native requests that fell back on an "
                               "empty pre-assigned fid pool"),
                ("wal_errors", "group-commit batches that failed the "
                               "WAL append (every member fell back)"),
                ("upstream_errors", "chunk uploads the volume write "
                                    "plane refused or dropped"),
                ("wal_batches", "group-commit barrier batches landed"),
                ("wal_lines", "WAL lines landed by the native plane")),
            ("parse", "upload", "wal"),
            ("fid_level", "pre-assigned fids ready in the native pool",
             max(nm.fid_level(), 0)),
            "ack_seconds", ACK_BUCKETS_S, nm.ack_histogram())

    def _native_read_metrics_text(self) -> str:
        """The native read plane's requests, fallbacks, stale and
        upstream misses, its entry map, its response latency histogram
        and its wall split (parse, lookup, fetch, send)."""
        nr = self.native_read
        if nr is None:
            return ""
        from .filer_read_plane_native import RESPONSE_BUCKETS_S
        return self._plane_text(
            "filer_read_plane_native", nr.stats(), (
                ("requests", "filer reads served by the native read "
                             "plane"),
                ("fallbacks", "native read-plane requests answered 404 "
                              "(the python filer owns them)"),
                ("stale_misses", "native fetches the volume plane "
                                 "404'd (registration invalidated)"),
                ("upstream_errors", "chunk fetches the volume read "
                                    "plane refused or dropped")),
            ("parse", "lookup", "fetch", "send"),
            ("entries", "paths registered in the C-side entry map",
             nr.entries()),
            "response_seconds", RESPONSE_BUCKETS_S,
            nr.response_histogram())

    def _status(self, req: Request):
        """Plane discovery: clients probe this once and send their plain
        PUTs and GETs to the armed planes' ports first."""
        nm, nr = self.native_meta, self.native_read
        return 200, {"version": "seaweedfs-tpu/0.1", "role": "filer",
                     "metaPlanePort":
                         nm.port if nm is not None and nm.armed else 0,
                     "readPlanePort":
                         nr.port if nr is not None and nr.armed else 0}

    def _follow_state(self, req: Request):
        """The follow stream's state (the port's own route): synced, the
        snapshots and event batches applied, the pushed vid -> urls."""
        f = operation.follower(self.filer.master)
        if f is None:
            return 404, {"error": "no follow stream"}
        return 200, f.state()

    @staticmethod
    def _lever(plane, req: Request, **extra):
        """POST {"native": "on"|"off"}: arm or disarm a plane without
        tearing down its listener (clients keep their sockets; every
        request falls back to this port while it is off)."""
        if plane is None:
            return 404, {"error": "native plane not running"}
        b = req.json() if req.body else {}
        want = str(b.get("native", "")).lower()
        if want in ("on", "1", "true"):
            plane.arm(True)
        elif want in ("off", "0", "false"):
            plane.arm(False)
        return 200, {"armed": plane.armed, "port": plane.port,
                     **{k: f() for k, f in extra.items()},
                     **plane.stats()}

    def _debug_meta_plane(self, req: Request):
        nm = self.native_meta
        return self._lever(nm, req, fidLevel=lambda: max(nm.fid_level(), 0))

    def _debug_read_plane(self, req: Request):
        nr = self.native_read
        return self._lever(nr, req, entries=lambda: nr.entries())

    # -- dispatch ---------------------------------------------------------

    def _tus_route(self, req: Request):
        return self._tus(req, urllib.parse.unquote(req.path))

    def _chunk_route(self, req: Request):
        return self._chunk_write(
            req, urllib.parse.unquote(req.path)[len("/__chunk__"):])

    def _dispatch(self, req: Request):
        # the wire path is percent-encoded (every client quotes);
        # storing it un-decoded would persist names like "a%21" for "a!"
        path = urllib.parse.unquote(req.path)
        # a percent-encoded "/__tus__/" or "/__chunk__/" misses the
        # prefix table
        if path.startswith("/__tus__/"):
            return self._tus(req, path)
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
        # an armed fault fails the write before any chunk is assigned
        faults.fire("filer.entry.put", key=path)
        # the write's decomposition: recv here, assign and upload in
        # operation (on the chunk pool, re-bound), meta and gc in
        # Filer.write_file
        with profiling.track("write", role="filer",
                             metrics=self.metrics):
            with profiling.stage("recv"):
                body = req.body
            entry = self.filer.write_file(path, body, mime=mime)
        return 201, {"name": entry.name, "size": entry.total_size()}

    def _get(self, req: Request, path: str):
        if path.endswith("/") or path == "":
            return self._list(req, path or "/")
        # the read plane's fill fence: its generation token is taken
        # BEFORE the lookup, so the warm fill below loses to any
        # invalidation that raced it
        nr = self.native_read
        token = nr.begin_fill() if nr is not None else 0
        entry = self.filer.find_entry(path, count_negative=True)
        if entry is None:
            return 404, {"error": f"{path} not found"}
        if entry.is_directory:
            return self._list(req, path)
        if not entry.chunks and entry.extended.get("remote"):
            return self._get_remote(req, path, entry)
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
        # the tenant's in-flight bytes are charged for the whole
        # response write, cache hits included
        release, deny = qos.charge_response(req, size, "filer")
        if deny is not None:
            return deny
        # stream, never buffer: views are fetched lazily as the response
        # drains, so a multi-GB GET holds one chunk in memory
        body = self.filer.open_read_stream(entry, offset, size,
                                           on_close=release)
        if nr is not None and not rng:
            # warm fill: the NEXT read of this path can be served
            # natively (fenced by the token above)
            nr.warm_fill(path, entry, token)
        headers = {"Content-Type": mime, "Content-Length": str(size)}
        if rng:
            headers["Content-Range"] = \
                f"bytes {offset}-{offset + size - 1}/{file_size}"
            return 206, (body, headers)
        return 200, (body, headers)

    def _get_remote(self, req: Request, path: str, entry):
        """Read-through of an uncached remote-mounted entry
        (filer_remote_read: fetched from the foreign store on demand;
        remote.cache materializes local chunks so this stops being
        hit)."""
        from ..remote import RemoteError, remote_for_path
        try:
            located = remote_for_path(self.url, path)
            if located is None:
                return 404, {"error": f"{path}: remote mount gone"}
            client, key = located
            marker = json.loads(entry.extended["remote"])
            total = int(marker.get("size", 0))
            parsed = parse_range(req.headers.get("Range", ""), total)
            if parsed == "unsatisfiable":
                return 416, (b"", {"Content-Range": f"bytes */{total}"})
            if parsed is not None:
                offset, size = parsed
                data = client.read(key, offset, size)
                end = offset + len(data) - 1
                return 206, (data, {
                    "Content-Type": "application/octet-stream",
                    "Content-Range": f"bytes {offset}-{end}/{total}"})
            return 200, (client.read(key),
                         {"Content-Type": "application/octet-stream"})
        except FileNotFoundError:
            return 404, {"error": f"{path}: gone on remote"}
        except (RemoteError, OSError, ValueError) as e:
            return 502, {"error": f"remote read {path}: {e}"}

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

    # -- TUS resumable uploads (filer_server_tus_handlers.go) -------------

    TUS_VERSION = "1.0.0"
    _TUS_DIR = "/.tus"

    def _tus_parts(self, updir: str) -> list:
        return sorted((e for e in self.filer.list_directory(updir,
                                                             limit=100000)
                       if e.name.endswith(".part")),
                      key=lambda e: int(e.name.split(".")[0]))

    def _tus(self, req: Request, path: str):
        """tus.io core protocol: creation (POST), offset probe (HEAD),
        append (PATCH), abort (DELETE).  Parts are staged as filer files
        under /.tus/<id>/, so an upload resumes across filer restarts,
        and the completed upload is materialized by stitching the parts'
        chunk lists (no data copy)."""
        tus_headers = {"Tus-Resumable": self.TUS_VERSION,
                       "Tus-Version": self.TUS_VERSION,
                       "Tus-Extension": "creation,termination"}
        if req.method == "OPTIONS":
            return 204, (b"", tus_headers)
        if req.method == "POST":
            try:
                length = int(req.headers.get("Upload-Length", -1))
            except ValueError:
                length = -1
            target = req.query.get("path", "")
            if length < 0 or not target:
                return 400, {"error": "Upload-Length header and "
                                      "?path= are required"}
            uid = uuid.uuid4().hex
            marker = Entry(f"{self._TUS_DIR}/{uid}", is_directory=True)
            marker.extended["tusTarget"] = target
            marker.extended["tusLength"] = str(length)
            self.filer.create_entry(marker)
            return 201, (b"", {**tus_headers,
                               "Location": f"/__tus__/{uid}"})

        uid = path[len("/__tus__/"):].strip("/")
        if not uid or "/" in uid:
            # an empty id would name the /.tus staging root: a DELETE
            # would then wipe every upload in flight
            return 404, {"error": "unknown upload"}
        updir = f"{self._TUS_DIR}/{uid}"
        marker = self.filer.find_entry(updir)
        if marker is None or not marker.extended.get("tusTarget"):
            return 404, {"error": "unknown upload"}
        length = int(marker.extended.get("tusLength", 0))
        offset = sum(e.total_size() for e in self._tus_parts(updir))
        if req.method == "HEAD":
            return 200, (b"", {**tus_headers,
                               "Upload-Offset": str(offset),
                               "Upload-Length": str(length),
                               "Cache-Control": "no-store"})
        if req.method == "DELETE":
            self.filer.delete_entry(updir, recursive=True)
            return 204, (b"", tus_headers)
        if req.method != "PATCH":
            return 405, {"error": f"method {req.method} not allowed"}
        try:
            claimed = int(req.headers.get("Upload-Offset", -1))
        except ValueError:
            claimed = -1
        if claimed != offset:
            # 409: the client's view of the offset is stale
            return 409, (b"", {**tus_headers,
                               "Upload-Offset": str(offset)})
        data = req.body
        if offset + len(data) > length:
            return 413, {"error": "upload exceeds Upload-Length"}
        self.filer.write_file(f"{updir}/{offset:020d}.part", data)
        offset += len(data)
        if offset == length:
            # stitch the parts' chunk lists into the target entry
            target = marker.extended["tusTarget"]
            chunks = []
            base = 0
            for part in self._tus_parts(updir):
                for c in part.chunks:
                    chunks.append(type(c)(c.file_id, base + c.offset,
                                          c.size, c.e_tag, c.mtime_ns))
                base += part.total_size()
            old = self.filer.find_entry(target)
            self.filer.create_entry(Entry(target, chunks=chunks))
            if old is not None and not old.is_directory:
                # the replaced file's chunks are reclaimed, as
                # write_file's overwrite does
                self.filer._delete_chunks(old)
            self.filer.delete_entry(updir, recursive=True,
                                    delete_chunks=False)
        return 204, (b"", {**tus_headers, "Upload-Offset": str(offset)})

    # -- distributed locks (distributed_lock_manager.go) ---------------

    def _lock_acquire(self, req: Request):
        b = req.json()
        key = str(b.get("key", ""))
        if not key:
            return 400, {"error": "missing lock key"}
        target = self.lock_manager.target_server(key)
        if target and target != self._ring_self:
            return 200, {"movedTo": target}
        r = self.lock_manager.acquire(
            key, str(b.get("owner", "")), float(b.get("ttlSec", 10.0)),
            str(b.get("renewToken", "")))
        if isinstance(r, str):
            return 423, {"error": "locked", "owner": r}
        token, expires_at = r
        return 200, {"renewToken": token, "expiresAt": expires_at}

    def _lock_release(self, req: Request):
        b = req.json()
        key = str(b.get("key", ""))
        target = self.lock_manager.target_server(key)
        if target and target != self._ring_self:
            return 200, {"movedTo": target}
        if not self.lock_manager.release(key,
                                         str(b.get("renewToken", ""))):
            return 409, {"error": "token mismatch"}
        return 200, {}

    def _lock_list(self, req: Request):
        return 200, {"locks": self.lock_manager.all_locks()}

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
