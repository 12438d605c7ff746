"""Volume server: the EC admin routes of `seaweedfs_tpu/server/
volume_server.py` (volume_grpc_erasure_coding.go mirrored as JSON over
HTTP), with the GF(2^8) work on this server's codec device, its link to
a master, and the public data path for reads and deletes.

- `GET` / `HEAD` / `DELETE /<vid>,<key><cookie>`: a needle of a normal
  or an EC volume (`Range` answers 206).  An EC needle's intervals are
  read from local shards, else from the shards' holders, else rebuilt
  from survivors on the host's codec (`store_ec.EcReader`).  A delete
  on an EC volume tombstones the needle on every holder the master's
  `/dir/ec_lookup` lists; on a replicated normal volume, on every
  replica.
- The hot-needle cache (`util/chunk_cache.TieredChunkCache`, memory
  `SEAWEEDFS_TPU_READ_CACHE_MB`, 64 by default, 0 turns it off; an
  optional disk tier under `SEAWEEDFS_TPU_READ_CACHE_DIR`): a read
  fills it, degraded decodes included unless
  `SEAWEEDFS_TPU_DEGRADED_PROMOTE` is 0 or false, and a repeated read is
  answered from memory.  Keys carry the cookie and a per-volume
  generation; a write or a delete invalidates its needle, and every
  mount, unmount, delete or decode that changes what a volume id serves
  drops the volume's generation.
- `POST` / `PUT /<vid>,<key><cookie>`: write a needle (`name` and `ts`
  in the query, the mime type in `Content-Type`), answered after the
  volume's group commit (and its fsync on the `-fsync` tier), then on
  every other replica of a replicated volume
  with `?type=replicate` and the stamped `ts`, so that every replica
  holds the same needle record.  A replica that fails the write fails
  the request (500, no ack).
- The native planes (`server/read_plane.py`, `server/write_plane.py`,
  the JAX server's defaults): a C++ epoll loop on a port of its own
  serves plain needle reads with sendfile(2), another receives, appends
  and acks plain anonymous uploads to volumes of replication 000
  (`SEAWEEDFS_TPU_WRITE_PLANE=0` or `false` turns it off).  `GET
  /status` gives their ports (`readPlanePort`, `writePlanePort`, 0 for
  a plane that is off) with the heartbeat's fields; a pump drains the
  write plane's appends into the needle maps and registers them with
  the read plane, and the heartbeat ticks it first; `/metrics` carries
  their counters.  Anything a plane does not own answers 404 there, and
  the client comes to the HTTP port.
- The UDS zero-copy read plane (`server/uds_reader.py`): a same-host
  reader fetches a raw needle record over a Unix socket, given in
  `/status` as `udsPath`; each record it serves warms the native read
  plane.  The socket lives in a private temporary directory, removed at
  stop (the JAX server puts `uds.sock` in its first data directory),
  so a data directory holds only volume and shard files.
- The `-fsync` tier (`fsync=True`): every volume's group-commit barrier
  fsyncs its `.dat` before a write or delete is acked.  The write plane
  parks its acks of such a volume until the handshake thread has run
  the volume's barrier for their epoch (`_wp_epoch`); a plane without
  the handshake leaves the volume on the Python path.
- `/admin/allocate_volume`: a new empty volume, for the master's
  growth.
- Tiers (storage/volume_tier.go): `/admin/tier_move` freezes a volume,
  heartbeats at once (so the master stops assigning into it: the tier
  may be this very cluster's gateway), uploads its `.dat` to an S3
  backend under a key of its own a replica (`<vid>.<port>.dat`), writes
  the `.vif`'s `files` entry, removes the `.dat` and mounts the volume
  again, remote and read-only; `/admin/tier_fetch` downloads it back and
  mounts it local and writable.  A remote volume is never in the read
  or write plane, its UDS reads go through the remote `.dat`, and each
  swap drops the volume from the read plane and the hot-needle cache
  (`_swap_guard`); a tier move or fetch holds the volume against a
  vacuum, a merge or an EC generate (409, as those hold each other).
- `/admin/query` (volume_server.proto Query): a SQL-subset SELECT over
  one needle's JSON or CSV content (`query/engine.run_query`).

- `/admin/ec/generate`: encode a read-only volume, locally or, with a
  `placement` map ({shard_id: url}), as a scatter-encode: each shard
  streams off the codec to its placement target, sidecars follow, and
  every shard is committed and mounted at its destination.  A failure
  anywhere unwinds: nothing is mounted from a partial stripe and a
  pre-existing `.vif` is restored byte for byte.
- `/admin/ec/shard_write`, `_commit`, `_abort`: the receiving side of a
  scatter (temp file + CRC32 while streaming, atomic rename on commit).
- `/admin/ec/rebuild`: regenerate lost shards, streaming survivors this
  node lacks from their servers' `/admin/ec/shard_read` (`mode:
  "stream"`, the default) or from local files only (`mode: "local"`).
  Survivors come from the request's `shardLocations` ({shard_id:
  [urls]}), else from the master's `/dir/ec_lookup`; with neither, the
  rebuild is local.
- `/admin/ec/copy` (pull shard and index files from another server) and
  `/admin/ec/to_volume` (decode the local data shards back to a
  `.dat`/`.idx` volume): the two steps of `ec.decode`.
- `/admin/ec/mount`, `unmount`, `delete_shards`, `info`, `shard_read`,
  `scrub` (modes `index` and `local`), `/admin/volume_file`,
  `/admin/delete_volume`, `/admin/mount_volume`,
  `/admin/unmount_volume`, `/admin/set_readonly` and
  `/admin/receive_file`.
- `/admin/volume/hold`: a copy's lease on its source volume, which
  `/admin/vacuum`, `/admin/volume/merge` and `/admin/ec/generate` answer
  with 409 while it lasts (the JAX server has no such hold).

With a `master` (host:port, or the `-mserver` seed list of an HA set),
the server posts `Store.collect_heartbeat()` to the leader's `/heartbeat`
(`operation.master_json` follows it) at start, every `pulse_seconds`,
and at once after every change of what it serves, and keeps the set's
`topologyId` from the answer (on `/status`: a new epoch is observable,
and a full heartbeat has already given the new leader all of this
server's state); a follower's `not leader` is followed, not
taken for a rejected heartbeat.  A started server runs the SLO
autopilot (autopilot.py: the hot-needle cache's size; `GET/POST
/debug/autopilot`) unless `SEAWEEDFS_TPU_AUTOPILOT=0`.  Without one (`master=""`)
there is no heartbeat, and a scatter's `placement` and a rebuild's
`shardLocations` must come in the request body, and EC reads find no
remote shard.

Under `security.toml` (`security.py`): `/<fid>` needs a JWT for that fid
signed with the read key (GET, HEAD) or the write key (POST, PUT,
DELETE) when the key is set; the admin paths need the admin JWT (401
otherwise); the heartbeat and every call this server makes to another
(scatter, sidecars, commits, rebuild survivors, remote EC reads, copies)
carry the admin JWT, which `httpd._auth_for` adds on every admin path,
and the replica and EC-delete fan-outs a write JWT signed afresh.  The
native planes and the UDS plane carry no JWT and
no TLS, so they are not started where a key for what they serve is set
(the UDS and read planes under the read key, the write plane under the
write key) or `[tls]` is on: `/status` shows their ports as 0 (and no
`udsPath`), and `volume_server_plane_stood_down_total{plane,reason}`
counts each.  QoS (`qos.install`) admits the `/admin/*` maintenance
plane by tenant, and the EC throttle's foreground is this server's
`request_seconds` and its planes' drained walls; a needle GET is
charged to its tenant's in-flight bytes and resized on `?width=` /
`?height=` (`images.resized`).  The fault sites `master.heartbeat`,
`volume.read.serve`, `volume.write.serve`, `volume.receive_file.recv`,
`volume.shard_write.recv` and `volume.shard_read.serve` fire where the
reference's do.  Counters go to
`stats.PROCESS`, which `GET /metrics` renders (the opt-in `telemetry`
report reads its EC totals there), with this process's kernel launch
counts and the planes' counters.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
import urllib.parse
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor

from .. import autopilot as _autopilot
from .. import faults, profiling, qos, security, stats
from ..storage import types
from ..storage.erasure_coding import ec_decoder, ec_encoder
from ..storage.erasure_coding.ec_context import ECContext, to_ext
from ..storage.needle import Needle
from ..storage.store import Store
from ..storage.types import check_path_fields
from ..util.chunk_cache import (TieredChunkCache, read_cache_disk,
                                read_cache_mb)
from .httpd import (FileSlice, HttpServer, Request, http_bytes,
                    admin_guard, http_download, http_json)
from .debug import (install_autopilot_routes, install_debug_routes,
                    start_process_probes)
from .read_plane import DATA_OFFSET_IN_RECORD, plain_record
from .write_plane import ACK_BUCKETS_S
from .store_ec import EcReader
from ..util import wlog


def _promote_degraded() -> bool:
    """`SEAWEEDFS_TPU_DEGRADED_PROMOTE` (default on): degraded decodes
    fill the hot-needle cache, so only the first read of a needle pays
    the d-way fan-out; 0 or false keeps decode results out of it."""
    return os.environ.get("SEAWEEDFS_TPU_DEGRADED_PROMOTE",
                          "1") not in ("0", "false")


class VolumeServer:
    """The EC admin plane of one volume server over `directories`.  The
    codec runs on `device`: the CUDA card by default, the CPU when the
    caller asks for it; a card that is missing fails the request."""

    def __init__(self, directories: list[str], host: str = "127.0.0.1",
                 port: int = 0, public_url: str = "",
                 device: str = "cuda", master: str = "",
                 pulse_seconds: float = 1.0, data_center: str = "",
                 rack: str = "", max_volume_count: int = 8,
                 fsync: bool = False):
        self.device = device
        self.master = master
        self.pulse_seconds = pulse_seconds
        self.data_center = data_center
        self.rack = rack
        self.http = HttpServer(host, port)
        self.http.role = "volume"
        self.store = Store(directories, ip=host, port=self.http.port,
                           public_url=public_url or self.http.url,
                           fsync=fsync)
        for loc in self.store.locations:
            loc.max_volume_count = max_volume_count
        self.metrics = stats.PROCESS
        # the role's own registry: requests_in_flight, request_seconds
        # and request_cpu_seconds (httpd's middleware) and the write
        # track's stages, under the JAX volume server's namespace
        self.role_metrics = stats.Metrics("volume_server")
        self.http.metrics = self.role_metrics
        self._hb_stop = threading.Event()
        self._hb_thread: "threading.Thread | None" = None
        self._hb_lock = threading.Lock()
        self._last_hb_error: "str | None" = None
        self.topology_id = ""       # the master set's, from a heartbeat
        r = self.http.route
        r("POST", "/admin/allocate_volume", self._allocate_volume)
        r("POST", "/admin/set_readonly", self._set_readonly)
        r("POST", "/admin/volume/hold", self._hold_volume)
        r("POST", "/admin/receive_file", self._receive_file)
        r("GET", "/admin/volume_file", self._read_volume_file)
        r("POST", "/admin/delete_volume", self._delete_volume)
        r("POST", "/admin/mount_volume", self._mount_volume)
        r("POST", "/admin/unmount_volume", self._unmount_volume)
        r("POST", "/admin/configure_volume", self._configure_volume)
        r("POST", "/admin/vacuum", self._vacuum)
        r("POST", "/admin/vacuum_toggle", self._vacuum_toggle)
        r("POST", "/admin/leave", self._leave)
        r("POST", "/admin/scrub", self._scrub)
        r("POST", "/admin/volume/merge", self._merge_volume)
        r("GET", "/admin/volume_index", self._volume_index)
        r("GET", "/admin/needle_raw", self._needle_raw)
        r("POST", "/admin/write_needle_raw", self._write_needle_raw)
        r("POST", "/admin/delete_needle", self._admin_delete_needle)
        r("POST", "/admin/ec/copy", self._ec_copy)
        r("POST", "/admin/ec/to_volume", self._ec_to_volume)
        r("POST", "/admin/ec/generate", self._ec_generate)
        r("POST", "/admin/ec/shard_write", self._ec_shard_write)
        r("POST", "/admin/ec/shard_write_commit",
          self._ec_shard_write_commit)
        r("POST", "/admin/ec/shard_write_abort", self._ec_shard_write_abort)
        r("POST", "/admin/ec/mount", self._ec_mount)
        r("POST", "/admin/ec/unmount", self._ec_unmount)
        r("POST", "/admin/ec/delete_shards", self._ec_delete_shards)
        r("POST", "/admin/ec/rebuild", self._ec_rebuild)
        r("GET", "/admin/ec/shard_read", self._ec_shard_read)
        r("GET", "/admin/ec/info", self._ec_info)
        r("POST", "/admin/ec/scrub", self._ec_scrub)
        r("POST", "/admin/query", self._query)
        r("POST", "/admin/tier_move", self._tier_move)
        r("POST", "/admin/tier_fetch", self._tier_fetch)
        r("GET", "/metrics", self._metrics)
        r("GET", "/status", self._status)
        install_debug_routes(self.http)
        self.http.fallback = self._data_path
        # the data path checks its per-fid JWTs itself
        self.http.guard = admin_guard
        # QoS: tenant admission on the maintenance plane only (the
        # foreground needle traffic is protected by the EC throttle);
        # the throttle's foreground signal is this role's request_seconds
        # and the native planes' drained walls (plane_request_seconds)
        qos.install(self.http, "volume", path_prefix="/admin/")
        qos.throttle().add_metrics(f"volume:{self.http.port}",
                                   self.role_metrics)
        qos.throttle().add_metrics(f"volume:{self.http.port}:planes",
                                   stats.PROCESS,
                                   names=("plane_request_seconds",))
        qos.throttle().maybe_start()
        self.ec_reader = EcReader(master, self.http.url)
        # hot-needle cache: a repeated read skips the index lookup and
        # the .dat read (for an EC volume, the interval resolution and
        # any degraded decode).  Keys carry a per-volume generation, so
        # a volume is dropped whole without enumerating its needles;
        # writes and deletes invalidate their needle's group
        mb = read_cache_mb(64)
        disk_dir, disk_mb = read_cache_disk()
        self.needle_cache = TieredChunkCache(
            mem_limit=mb << 20,
            disk_dir=(os.path.join(disk_dir, f"vol{self.http.port}")
                      if disk_dir else None),
            disk_limit=disk_mb << 20,
            name="volume_needle") if mb > 0 else None
        self._nc_gen: dict[int, int] = {}
        self._nc_gen_lock = threading.Lock()
        # fill/invalidate guard: a read that began before a write or
        # delete landed must not cache its stale needle after the
        # invalidation ran, so fills carry the epoch they began at
        self._nc_epoch = 0
        # the native planes, started by start(), and the volumes whose
        # .dat the read plane has open
        self.read_plane = None
        self.write_plane = None
        self.uds_server = None
        self._rp_volumes: set[int] = set()
        self._rp_lock = threading.Lock()
        # staged scatter uploads awaiting commit:
        # uploadId -> {path, crc, bytes, vid, sid, collection, stamp}
        self._pending_shard_writes: dict[str, dict] = {}
        self._pending_lock = threading.Lock()
        # volumes a compaction, a merge, an EC generate or a copy is
        # rewriting or reading whole: one at a time a volume (409 for the
        # second); a copy's hold spans requests, so it is a lease:
        # vid -> (token, monotonic deadline)
        self._busy: dict[int, str] = {}
        self._holds: dict[int, tuple[str, float]] = {}
        self._busy_lock = threading.Lock()
        self._vacuum_disabled = False
        # the SLO autopilot (autopilot.py): this role's loop owns the
        # hot-needle cache's size; start() runs it unless
        # SEAWEEDFS_TPU_AUTOPILOT=0, and /debug/autopilot serves either way
        self.autopilot = _autopilot.build_for_volume(self)
        install_autopilot_routes(self.http, self.autopilot)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "VolumeServer":
        # staged scatter temps of a crashed process: the pending
        # registry died with it, so nothing else would reclaim them
        for loc in self.store.locations:
            for name in os.listdir(loc.directory):
                if ".scatter." in name:
                    try:
                        os.remove(os.path.join(loc.directory, name))
                    except OSError:
                        pass
        # the planes start before the HTTP port, so /status never shows
        # a client plane ports of 0 that it would keep
        self._start_planes()
        start_process_probes()
        self.http.start()
        if self.master:
            self._heartbeat_once()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name="heartbeat", daemon=True)
            self._hb_thread.start()
        if _autopilot.enabled_by_env():
            self.autopilot.start()
        return self

    def _plane_stand_down(self, plane: str, key: str) -> bool:
        """True when the configuration keeps `plane` down: the key of
        what it serves is set, or `[tls]` is on (the planes speak plain
        text and check no JWT).  A stand-down is printed once and
        counted; it is the configuration's, never a fallback."""
        sec = security.current()
        reason = "tls" if sec.tls is not None else \
            ("jwt" if key else "")
        if not reason:
            return False
        stats.PROCESS.counter_add(
            "volume_server_plane_stood_down_total", 1.0,
            help_text="native or UDS planes not started because "
                      "security.toml keys or TLS are configured",
            plane=plane, reason=reason)
        wlog.warning(f"volume server {self.url}: {plane} plane stands down "
                     f"({reason})")
        return True

    def _start_planes(self) -> None:
        """The UDS reader, the native read plane, and the write plane
        unless `SEAWEEDFS_TPU_WRITE_PLANE` is 0 or false, each unless the
        security configuration keeps it down (`_plane_stand_down`).  A
        plane that does not build or start leaves the server on its
        Python port, as the JAX server does, with one line on stderr."""
        from .read_plane import ReadPlane
        from .write_plane import WritePlane
        read_key = security.current().volume_read_key
        if not self._plane_stand_down("uds", read_key):
            self._start_uds()
        if not self._plane_stand_down("read", read_key):
            try:
                self.read_plane = ReadPlane(self.http.host)
            except (RuntimeError, OSError) as e:
                wlog.warning(f"volume server {self.url}: no read plane: {e}")
            else:
                # plane-served reads train the hedge's threshold and
                # reach the flight recorder
                self.read_plane.start_record_drain()
        if os.environ.get("SEAWEEDFS_TPU_WRITE_PLANE",
                          "1") in ("0", "false"):
            return
        if self._plane_stand_down("write",
                                  security.current().volume_write_key):
            return
        try:
            self.write_plane = WritePlane(self.http.host,
                                          on_tick=self._wp_tick,
                                          on_epoch=self._wp_epoch)
        except (RuntimeError, OSError) as e:
            wlog.warning(f"volume server {self.url}: no write plane: {e}")
            return
        self.write_plane.start_record_drain()
        for loc in self.store.locations:
            for vid in list(loc.volumes):
                self._wp_sync_volume(vid)

    def _start_uds(self) -> None:
        """The UDS reader on a socket in a private temporary directory."""
        from .uds_reader import UdsNeedleServer
        try:
            sock_dir = tempfile.mkdtemp(prefix="swfs-uds-")
            try:
                self.uds_server = UdsNeedleServer(
                    self.store, os.path.join(sock_dir, "uds.sock"),
                    on_read=self._rp_sync_needle).start()
            except OSError:
                os.rmdir(sock_dir)
                raise
        except OSError as e:       # no AF_UNIX, or a path too long
            wlog.warning(f"volume server {self.url}: no UDS reader: {e}")

    def stop(self) -> None:
        self.autopilot.stop()
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10)
        qos.throttle().remove_source(f"volume:{self.http.port}")
        qos.throttle().remove_source(f"volume:{self.http.port}:planes")
        with self._rp_lock:         # no index call runs into a stopped plane
            rp, self.read_plane = self.read_plane, None
        if rp is not None:
            rp.stop()
        if self.uds_server is not None:
            self.uds_server.stop()
            shutil.rmtree(os.path.dirname(self.uds_server.sock_path),
                          ignore_errors=True)
        self.http.stop()
        self.ec_reader.close()
        # closing the store detaches every volume from the write plane
        # (a drain and an .idx flush each), so the plane outlives it
        self.store.close()
        if self.write_plane is not None:
            self.write_plane.stop()

    @property
    def url(self) -> str:
        return self.http.url

    # -- heartbeat (volume_grpc_client_to_master.go:51) -------------------

    def _heartbeat_once(self) -> None:
        """Post the full heartbeat to the master; an unreachable master
        is retried at the next pulse.  Pulses are serialised, so the
        last one posted is the newest state."""
        if not self.master:
            return
        from ..operation import master_json
        with self._hb_lock:
            # native appends count: the master floors its sequencer by
            # maxFileKey and seals a volume by its size
            self._wp_tick()
            hb = self.store.collect_heartbeat()
            if self.data_center:
                hb["dataCenter"] = self.data_center
            if self.rack:
                hb["rack"] = self.rack
            try:
                # an armed delay stalls this pulse, an error skips it
                faults.fire("master.heartbeat", key=self.url)
                r = master_json(self.master, "POST", "/heartbeat", hb,
                                timeout=5)
            except OSError:
                return
        err = r.get("error")
        if err and err != self._last_hb_error:
            # invisible to the master: say so once per distinct error
            wlog.warning(f"volume server {self.url}: heartbeat rejected by "
                         f"master: {err}")
        self._last_hb_error = err
        tid = r.get("topologyId", "")
        if not err and tid:
            # the set's identity: a heartbeat is always full, so a new
            # leader has all of this server's state from this one on
            self.topology_id = tid

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.pulse_seconds):
            self._heartbeat_once()

    def _codec_device(self):
        """CUDA's current device is per thread: make the codec's device
        current on this handler thread (streams are passed explicitly
        below it).  Raises when the codec device is a missing card."""
        from ..ops.rs_torch import _resolve_device
        dev = _resolve_device(self.device)
        if dev.type != "cuda":
            return contextlib.nullcontext()
        import torch
        return torch.cuda.device(dev)

    # -- paths ------------------------------------------------------------

    def _file_path(self, vid: int, collection: str, ext: str
                   ) -> str | None:
        check_path_fields(collection, ext)
        name = (f"{collection}_" if collection else "") + f"{vid}{ext}"
        for loc in self.store.locations:
            p = os.path.join(loc.directory, name)
            if os.path.exists(p):
                return p
        return None

    def _base_path(self, vid: int, collection: str) -> str:
        """Base file path of volume vid on the disk holding it (or the
        first location for new files)."""
        check_path_fields(collection)
        for ext in (".dat", ".ecx", ".ec00"):
            p = self._file_path(vid, collection, ext)
            if p is not None:
                return p[: -len(ext)]
        name = (f"{collection}_" if collection else "") + str(vid)
        return os.path.join(self.store.locations[0].directory, name)

    # -- public data path ---------------------------------------------------

    def _data_path(self, req: Request):
        """`/<vid>,<key><cookie>`: every request that no admin route
        matches."""
        fid_str = req.path.lstrip("/")
        try:
            fid = types.parse_file_id(fid_str)
        except ValueError:
            return 404, {"error": f"bad file id {fid_str!r}"}
        # the per-fid JWT gate (volume_server_handlers_write.go
        # maybeCheckJwtAuthorization): the read key for reads, the write
        # key for writes and deletes, when set
        sec = security.current()
        key = sec.volume_read_key if req.method in ("GET", "HEAD") \
            else sec.volume_write_key
        err = sec.check_fid_jwt(key, req.query, req.headers, str(fid))
        if err:
            return 401, {"error": err}
        if req.method in ("GET", "HEAD"):
            return self._get_needle(fid, req.headers.get("Range", ""),
                                    req)
        if req.method in ("POST", "PUT"):
            return self._put_needle(fid, req)
        if req.method == "DELETE":
            return self._delete_needle(fid, req)
        return 405, {"error": "method not allowed"}

    def _get_needle(self, fid: types.FileId, rng: str = "",
                    req: "Request | None" = None):
        """volume_server_handlers_read.go: the needle's data with its
        mime type, or the `Range` asked for (206), from the hot-needle
        cache when it holds the needle; resized when the query asks
        (`width`, `height`, `mode`), and charged to the tenant's
        in-flight bytes (`qos.charge_response`, cache hits included)."""
        # an armed delay wedges this replica, an error kills it; keyed
        # by this server's url, so `match` picks one replica
        faults.fire("volume.read.serve", key=f"{self.http.url}/{fid}")
        cached = self._nc_get(fid)
        if cached is not None:
            mime, data = cached
        else:
            token = self._nc_epoch    # before the store read
            try:
                n = self.store.read_needle(fid.volume_id, fid.key,
                                           cookie=fid.cookie,
                                           ec_reader=self.ec_reader)
            except KeyError:
                return 404, {"error": "not found"}
            except ValueError as e:   # cookie mismatch, corrupt record
                return 404, {"error": str(e)}
            if self.read_plane is not None:
                # a read served here while the read plane is up: not
                # registered yet, not plain, or from a client that never
                # asked the plane
                self.metrics.counter_add(
                    "read_plane_fallbacks_total", 1.0,
                    help_text="needle reads on the Python port while the "
                              "native read plane is up")
                self._rp_sync_needle(fid.volume_id, fid.key)
            if not getattr(n, "was_degraded", False) or \
                    _promote_degraded():
                self._nc_put(fid, n, token)
            mime = n.mime.decode() if n.mime \
                else "application/octet-stream"
            data = n.data
        query = req.query if req is not None else {}
        if "width" in query or "height" in query:
            # resize-on-read (volume_server_handlers_read.go:353)
            from .. import images
            try:
                w = int(query.get("width", 0))
                h = int(query.get("height", 0))
            except ValueError:
                w = h = 0
            data = images.resized(data, mime, w, h, query.get("mode", ""))

        def serve(status: int, body: bytes, headers: dict):
            if req is not None:
                release, deny = qos.charge_response(req, len(body),
                                                    "volume")
                if deny is not None:
                    return deny
                if release is not None:
                    return status, (qos.MeteredBody(body, release), {
                        **headers, "Content-Length": str(len(body))})
            return status, (body, headers)

        if rng.startswith("bytes="):
            try:
                lo, _, hi = rng[6:].partition("-")
                total = len(data)
                if lo:
                    start = int(lo)
                    stop = int(hi) + 1 if hi else total
                else:
                    start = total - min(int(hi), total)
                    stop = total
                part = data[start:stop]
                return serve(206, part, {
                    "Content-Type": mime,
                    "Content-Range":
                        f"bytes {start}-{start + len(part) - 1}/{total}"})
            except ValueError:
                pass
        return serve(200, data, {"Content-Type": mime})

    def _put_needle(self, fid: types.FileId, req: Request):
        """volume_server_handlers_write.go: write the needle here, then
        on the other replicas (topology/store_replicate.go:27
        ReplicatedWrite).  201 with the reference's keys; 404 for a
        volume not here, 409 for a read-only one.  The request's stages
        (recv, prep, the volume's lock, index, append and flush,
        register, replicate) land in `volume_server_write_stage_seconds`
        and its trace."""
        # the write side's sibling of volume.read.serve
        faults.fire("volume.write.serve", key=f"{self.http.url}/{fid}")
        with profiling.track("write", role="volume",
                             metrics=self.role_metrics):
            return self._put_needle_tracked(fid, req)

    def _put_needle_tracked(self, fid: types.FileId, req: Request):
        with profiling.stage("recv"):
            body = req.body
        with profiling.stage("prep"):
            n = Needle(cookie=fid.cookie, id=fid.key, data=body)
            name = req.query.get("name", "")
            if name:
                n.set_name(name.encode())
            mime = req.headers.get("Content-Type", "")
            if mime and mime not in ("application/octet-stream",
                                     "multipart/form-data"):
                n.set_mime(mime.encode())
            ts = req.query.get("ts")
            ts_val = int(ts) if ts else int(time.time())
            n.set_last_modified(ts_val)
        try:
            size, unchanged = self.store.write_needle(fid.volume_id, n)
        except KeyError:
            return 404, {"error": f"volume {fid.volume_id} not found"}
        except PermissionError as e:
            return 409, {"error": str(e)}
        self._nc_invalidate_needle(fid.volume_id, fid.key)
        with profiling.stage("register"):
            self._rp_sync_needle(fid.volume_id, fid.key)
        if req.query.get("type") != "replicate":
            # the stamped ts and the original Content-Type (always set:
            # "" would store no mime, a missing header likewise) make
            # every replica write the same needle record
            with profiling.stage("replicate"):
                err = self._replicate(
                    fid, req, "POST", body,
                    extra_query={"ts": str(ts_val)},
                    headers={"Content-Type":
                             mime or "application/octet-stream"})
            if err:
                # the flight record of a failed write names the fan-out
                profiling.flight_note("replicate", {"error": str(err)})
                return 500, {"error": f"replication: {err}"}
        return 201, {"name": name, "size": size, "eTag": n.etag(),
                     "unchanged": unchanged}

    def _delete_needle(self, fid: types.FileId, req: Request):
        """Delete here, then on every other holder (store_replicate.go:142
        ReplicatedDelete; for EC, store_ec_delete.go:38), even when the
        local copy is already gone, accepting a sibling's 404, so a
        retried delete stays idempotent.  A holder reached with
        `?type=replicate` does not fan out again."""
        try:
            freed = self.store.delete_needle(
                fid.volume_id, Needle(cookie=fid.cookie, id=fid.key))
        except KeyError:
            freed = None
        self._rp_sync_needle(fid.volume_id, fid.key)
        # after the store's change, as for a write: invalidating first
        # would let a concurrent read cache the needle again
        self._nc_invalidate_needle(fid.volume_id, fid.key)
        if req.query.get("type") != "replicate":
            if self.store.find_ec_volume(fid.volume_id) is not None:
                err = self._ec_delete_fan_out(fid)
            else:
                err = self._replicate(fid, req, "DELETE", None,
                                      ok_statuses=(404,))
            if err:
                return 500, {"error": f"replication: {err}"}
        if freed is None:
            return 404, {"error": "not found"}
        return 202, {"size": freed}

    def _ec_delete_fan_out(self, fid: types.FileId) -> "str | None":
        """Tombstone the needle in every other shard holder's .ecx/.ecj
        (store_ec_delete.go:38; each holder keeps a full index copy).
        A master that does not know the shard set fails the delete:
        that beats a delete silently lost on some holder."""
        from ..operation import master_json
        try:
            r = master_json(self.master, "GET",
                            f"/dir/ec_lookup?volumeId={fid.volume_id}",
                            timeout=5)
        except OSError as e:
            return str(e)
        if "error" in r:
            return f"ec_lookup: {r['error']}"
        for url in sorted({loc["url"]
                           for loc in r.get("shardIdLocations", [])}):
            if url in (self.url, self.store.public_url):
                continue
            status, data, _ = http_bytes(
                "DELETE", f"{url}/{fid}?type=replicate",
                headers=security.current().write_headers(str(fid)),
                timeout=60)
            if status >= 300 and status != 404:
                return f"{url} -> {status}: {data[:200]!r}"
        return None

    def _replicate(self, fid: types.FileId, req: Request, method: str,
                   body: "bytes | None",
                   extra_query: "dict[str, str] | None" = None,
                   headers: "dict[str, str] | None" = None,
                   ok_statuses: "tuple[int, ...]" = ()) -> "str | None":
        """The request on every other replica of a replicated volume,
        found through the master's /dir/lookup, with `?type=replicate`
        so that none fans out again (store_replicate.go:192
        DistributedOperation).  The first failure is returned.  The
        port's master drops a dead node from its lookups, so fewer
        locations than the placement's copies is a failure too, as in
        the reference's GetWritableRemoteReplications: a write must not
        be acknowledged on a short replica set."""
        v = self.store.find_volume(fid.volume_id)
        if v is None or not v.super_block.replica_placement.byte():
            return None
        from ..operation import master_json
        try:
            locs = master_json(self.master, "GET",
                               f"/dir/lookup?volumeId={fid.volume_id}",
                               timeout=5).get("locations", [])
        except OSError as e:
            return str(e)
        copies = v.super_block.replica_placement.copy_count()
        if len(locs) < copies:
            return (f"replicating operations [{len(locs)}] is less than "
                    f"volume {fid.volume_id} replication copy count "
                    f"[{copies}]")
        query = {k: val for k, val in req.query.items()
                 if k not in ("type", "jwt")}
        query.update(extra_query or {})
        qs = urllib.parse.urlencode(query)
        # signed afresh for the replicas: forwarding the request's token
        # could carry an expired one on a slow fan-out
        headers = {**(headers or {}),
                   **security.current().write_headers(str(fid))}
        for loc in locs:
            if loc["url"] in (self.url, self.store.public_url):
                continue
            try:
                status, data, _ = http_bytes(
                    method, f"{loc['url']}/{fid}?type=replicate" +
                    (f"&{qs}" if qs else ""), body, headers=headers,
                    timeout=60)
            except OSError as e:
                return f"{loc['url']} -> {e}"
            if status >= 300 and status not in ok_statuses:
                return f"{loc['url']} -> {status}: {data[:200]!r}"
        return None

    # -- the native planes (server/read_plane.py, write_plane.py) -------------

    def _rp_sync_needle(self, vid: int, key: int) -> None:
        """Make the read plane's entry for a needle of a normal volume the
        record the index points at now, if it is plain, else none: after
        a Python write or delete and before its answer, and on a read
        through Python or over UDS (the UDS server's `on_read`, so a
        needle read only there reaches the plane too).  The index is read and the entry set in one step
        under `_rp_lock`, which drops and the pump take too, so no racing
        registration binds a replaced record.  (The JAX server registers
        the needle object it was handed, from a queue, so it can serve
        the old bytes for a moment after an acked overwrite.)"""
        v = self.store.find_volume(vid)
        if self.read_plane is None or v is None or v.is_remote:
            return          # no plane, not a normal volume, or no local fd
        with self._rp_lock:
            rp = self.read_plane
            if rp is None:
                return
            got = v.nm.get(key)
            rec = None
            if got is not None and v.version >= 2:
                off = types.to_actual_offset(got[0])
                try:
                    rec = plain_record(v.dat_fd(), off)
                except (OSError, ValueError):  # closed under an unmount
                    return
            if rec is None:
                rp.delete_needle(vid, key)
            elif self._rp_add_volume(vid, v):
                rp.register_raw(vid, key, rec[0],
                                off + DATA_OFFSET_IN_RECORD, rec[1])

    def _rp_add_volume(self, vid: int, v) -> bool:
        """Open the volume's `.dat` in the read plane once (the caller
        holds `_rp_lock`)."""
        if vid not in self._rp_volumes:
            if not self.read_plane.add_volume(vid, v.file_name(".dat")):
                return False
            self._rp_volumes.add(vid)
        return True

    def _rp_drop_volume(self, vid: int) -> None:
        """Forget a volume in the read plane and the hot-needle cache:
        every caller changed what the volume id serves (its `.dat`
        replaced, unmounted, deleted, converted).  Live needles
        register again as they are read."""
        self._nc_drop_volume(vid)
        with self._rp_lock:
            if self.read_plane is not None:
                self.read_plane.remove_volume(vid)
            self._rp_volumes.discard(vid)

    def _wp_sync_volume(self, vid: int) -> None:
        """Offer a volume to the write plane after a change of its state;
        an ineligible or failed one stays on the Python port (an -fsync
        volume too, where the plane has no epoch handshake: the plane
        logs and counts that)."""
        v = self.store.find_volume(vid)
        if self.write_plane is not None and v is not None:
            v.attach_native(self.write_plane)

    def _wp_epoch(self, vid: int, epoch: int) -> None:
        """The -fsync handshake: the acks parked on a flush epoch of
        `vid` wait for the volume's barrier, one fsync for the whole
        window (group commit across the C++ boundary).  A volume gone
        since has no bytes to fsync here."""
        v = self.store.find_volume(vid)
        if v is not None:
            v._barrier.commit()

    def _wp_tick(self) -> None:
        """Drain every attached volume's completed native appends into
        its needle map and `.idx`, and register with the read plane the
        ones that are still the index's record (under `_rp_lock`, as
        `_rp_sync_needle`: a Python overwrite or delete may have come
        after the append, or the volume may have gone)."""
        if self.write_plane is None:
            return
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                if self.read_plane is None:
                    v.drain_native()
                    continue
                with self._rp_lock:
                    rp = self.read_plane
                    entries = v.drain_native()
                    if not entries or rp is None or \
                            self.store.find_volume(v.id) is not v or \
                            not self._rp_add_volume(v.id, v):
                        continue
                    for e in entries:
                        if v.nm.get(e.key) == (
                                types.to_stored_offset(e.offset), e.size):
                            rp.register_raw(
                                v.id, e.key, e.cookie,
                                e.offset + DATA_OFFSET_IN_RECORD, e.data_len)

    def _status(self, req: Request):
        """The plane ports a client sends plain reads and writes to (0
        for a plane that is off), the master set's `topologyId` as last
        heard, with the heartbeat's fields."""
        return 200, {
            "version": "seaweedfs-tpu/0.1",
            "topologyId": self.topology_id,
            "udsPath": self.uds_server.sock_path if self.uds_server
            else "",
            "readPlanePort": self.read_plane.port if self.read_plane
            else 0,
            "writePlanePort": self.write_plane.port if self.write_plane
            else 0,
            **self.store.collect_heartbeat()}

    # -- hot-needle cache (util/chunk_cache) ---------------------------------

    def _nc_key(self, vid: int, key: int, cookie: int) -> str:
        with self._nc_gen_lock:
            gen = self._nc_gen.get(vid, 0)
        return f"{vid}.g{gen}.{key:x}.{cookie:08x}"

    def _nc_get(self, fid: types.FileId) -> "tuple[str, bytes] | None":
        """Cached (mime, data) of a needle, or None.  The cookie is part
        of the key: a wrong cookie misses and takes the store path,
        which refuses it."""
        if self.needle_cache is None:
            return None
        blob = self.needle_cache.get(
            self._nc_key(fid.volume_id, fid.key, fid.cookie))
        if blob is None:
            return None
        mlen = int.from_bytes(blob[:2], "big")
        return blob[2:2 + mlen].decode(), blob[2 + mlen:]

    def _nc_put(self, fid: types.FileId, n, token: int) -> None:
        """Cache a needle just read.  TTL'd needles stay out (the cache
        has no clock of its own), and so do bodies over the memory
        tier's bound.  `token` is the epoch the store read began at: a
        fill that raced an invalidation is dropped."""
        if self.needle_cache is None or n.has_ttl() or \
                token != self._nc_epoch:
            return
        mime = n.mime.decode() if n.mime else "application/octet-stream"
        blob = len(mime.encode()).to_bytes(2, "big") + \
            mime.encode() + bytes(n.data)
        key = self._nc_key(fid.volume_id, fid.key, fid.cookie)
        self.needle_cache.set(key, blob,
                              group=f"{fid.volume_id}.{fid.key:x}")
        # the epoch check above is not atomic with set(): an
        # invalidation that completed in between wiped the group before
        # this key joined it.  Check again and undo this fill; one of
        # the two always removes it
        if token != self._nc_epoch:
            self.needle_cache.delete(key)

    def _nc_invalidate_needle(self, vid: int, key: int) -> None:
        """Invalidate one needle under every cookie (the group has none,
        so a delete without the right cookie still clears it)."""
        if self.needle_cache is not None:
            with self._nc_gen_lock:
                self._nc_epoch += 1
            self.needle_cache.invalidate_group(f"{vid}.{key:x}")

    def _nc_drop_volume(self, vid: int) -> None:
        """Drop a volume whole by bumping its generation: its old keys
        become unreachable and age out of the LRU."""
        if self.needle_cache is not None:
            with self._nc_gen_lock:
                self._nc_epoch += 1
                self._nc_gen[vid] = self._nc_gen.get(vid, 0) + 1

    # -- volume admin -----------------------------------------------------

    def _allocate_volume(self, req: Request):
        """volume_server.proto AllocateVolume, then an instant heartbeat:
        the master sees the volume before the allocation answers."""
        b = req.json()
        collection = b.get("collection", "")
        check_path_fields(collection)
        self.store.add_volume(int(b["volumeId"]), collection,
                              b.get("replication", ""), b.get("ttl", ""))
        self._wp_sync_volume(int(b["volumeId"]))
        self._heartbeat_once()
        return 200, {}

    def _set_readonly(self, req: Request):
        b = req.json()
        vid = int(b["volumeId"])
        self.store.set_volume_read_only(vid, bool(b.get("readOnly", True)))
        v = self.store.find_volume(vid)
        if v.read_only:
            v.sync()  # commit buffered .dat/.idx before anyone reads them
        else:
            self._wp_sync_volume(vid)   # thawed: the plane may own it
        return 200, {}

    def _receive_file(self, req: Request):
        """volume_server.proto ReceiveFile: a sidecar or shard file
        pushed whole, to a temp file renamed into place, so a push that
        dies mid-stream never leaves a truncated file at the final
        path."""
        vid = int(req.query["volumeId"])
        collection = req.query.get("collection", "")
        ext = req.query["ext"]
        try:
            check_path_fields(collection, ext)
        except ValueError as e:
            return 400, {"error": str(e)}
        base = self._base_path(vid, collection)
        if ext in (".dat", ".idx"):
            # a pushed data or index file replaces what the volume serves
            self._rp_drop_volume(vid)
        n = 0
        tmp = f"{base}{ext}.recv.{uuid.uuid4().hex}"
        try:
            with open(tmp, "wb") as f:
                for chunk in req.stream_body():
                    if faults.fire("volume.receive_file.recv",
                                   key=f"{vid}{ext}") is not None:
                        raise IOError(f"receive_file {vid}{ext}: "
                                      f"fault-injected mid-stream failure")
                    f.write(chunk)
                    n += len(chunk)
            os.replace(tmp, base + ext)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        return 200, {"bytes": n}

    def _read_volume_file(self, req: Request):
        """volume_server.proto:69 CopyFile: stream a byte range
        (`offset`, `size`; the rest of the file without `size`) of a
        volume or EC file, never buffering it."""
        vid = int(req.query["volumeId"])
        ext = req.query["ext"]
        collection = req.query.get("collection", "")
        try:
            check_path_fields(collection, ext)
        except ValueError as e:
            return 400, {"error": str(e)}
        offset = int(req.query.get("offset", 0))
        size = int(req.query.get("size", -1))
        if ext in (".dat", ".idx"):
            v = self.store.find_volume(vid)
            if v is not None:
                v.sync()  # serve committed bytes, not a buffered tail
        path = self._file_path(vid, collection, ext)
        if path is None:
            return 404, {"error": f"no {ext} file for volume {vid}"}
        total = os.path.getsize(path)
        n = max(total - offset, 0) if size < 0 else \
            max(min(size, total - offset), 0)
        f = open(path, "rb")
        f.seek(offset)
        return 200, (FileSlice(f, n), {"Content-Length": str(n)})

    def _delete_volume(self, req: Request):
        vid = int(req.json()["volumeId"])
        self.store.delete_volume(vid)
        self._rp_drop_volume(vid)
        self._heartbeat_once()
        return 200, {}

    def _mount_volume(self, req: Request):
        b = req.json()
        collection = b.get("collection", "")
        check_path_fields(collection)
        vid = int(b["volumeId"])
        self.store.mount_volume(vid, collection)
        self._rp_drop_volume(vid)
        self._wp_sync_volume(vid)
        self._heartbeat_once()
        return 200, {}

    def _unmount_volume(self, req: Request):
        vid = int(req.json()["volumeId"])
        self.store.unmount_volume(vid)
        self._rp_drop_volume(vid)
        self._heartbeat_once()
        return 200, {}

    # -- volume maintenance (vacuum, merge, scrub, replica repair) ---------

    @contextlib.contextmanager
    def _exclusive(self, vid: int, what: str):
        """Hold `vid` for one whole-volume operation; yields None, or
        the operation that holds it already (the caller answers 409):
        a compaction must not swap the `.dat` under an EC generate that
        reads it, nor two rewrites race."""
        with self._busy_lock:
            self._expire_hold(vid)
            holder = self._busy.get(vid)
            if holder is None:
                self._busy[vid] = what
        if holder is not None:
            yield holder
            return
        try:
            yield None
        finally:
            with self._busy_lock:
                self._busy.pop(vid, None)

    def _expire_hold(self, vid: int) -> None:
        """Free a copy's hold whose lease ran out (its copier died);
        `_busy_lock` held."""
        held = self._holds.get(vid)
        if held is not None and held[1] < time.monotonic():
            self._holds.pop(vid, None)
            self._busy.pop(vid, None)

    def _hold_volume(self, req: Request):
        """A whole-volume copy's hold on its source across the requests
        that pull `.dat` then `.idx`: while it lasts `/admin/vacuum`, a
        merge and an EC generate answer 409, so no compaction commits
        between the two pulls.  `seconds` > 0 takes or renews the lease
        of `token`, 0 releases it; 409 while another operation holds the
        volume."""
        b = req.json()
        vid = int(b["volumeId"])
        token = str(b["token"])
        seconds = float(b.get("seconds", 600))
        with self._busy_lock:
            self._expire_hold(vid)
            held = self._holds.get(vid)
            mine = held is not None and held[0] == token
            if seconds <= 0:
                if mine:
                    self._holds.pop(vid, None)
                    self._busy.pop(vid, None)
                return 200, {"held": False}
            holder = self._busy.get(vid)
            if holder is not None and not mine:
                return 409, {"error": f"volume {vid} is busy: {holder}"}
            self._busy[vid] = "copy"
            self._holds[vid] = (token, time.monotonic() + seconds)
        return 200, {"held": True}

    @contextlib.contextmanager
    def _swap_guard(self, vid: int):
        """Around the rename of a compaction or merge (taken before the
        volume's lock): no read plane registration runs while the files
        change, and the plane forgets the volume before any can run
        again.  A read during the copy may have re-added the volume with
        an fd on the old `.dat`; new-layout offsets must never be read
        through it.  The hot-needle cache's generation drops too (a
        merge changes what a needle id holds)."""
        with self._rp_lock:
            try:
                yield
            finally:
                if self.read_plane is not None:
                    self.read_plane.remove_volume(vid)
                self._rp_volumes.discard(vid)
        self._nc_drop_volume(vid)

    def _configure_volume(self, req: Request):
        """volume_server.proto VolumeConfigure: the replica placement
        byte rewritten in the superblock and the volume info."""
        b = req.json()
        vid = int(b["volumeId"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        try:
            v.configure_replication(str(b.get("replication", "000")))
        except ValueError as e:
            return 400, {"error": str(e)}
        # a replicated volume leaves the write plane (its writes fan out)
        v.detach_native()
        self._wp_sync_volume(vid)
        self._heartbeat_once()
        return 200, {"replication": str(v.super_block.replica_placement)}

    def _leave(self, req: Request):
        """volume.server.leave (VolumeServerLeave): stop heartbeating, so
        the master forgets this server after its pulse timeout; volumes
        stay served until the process exits."""
        self._hb_stop.set()
        return 200, {"left": True}

    def _vacuum_toggle(self, req: Request):
        """volume.vacuum.enable / disable: the gate `/admin/vacuum`
        honours."""
        self._vacuum_disabled = not bool(req.json().get("enabled", True))
        return 200, {"vacuumEnabled": not self._vacuum_disabled}

    def _vacuum(self, req: Request):
        """volume_server.proto VacuumVolume{Check,Compact,Commit}: the
        copy without the volume's lock, the diff replay and the swap
        under it and `_swap_guard`; the write plane is offered the
        volume again after."""
        if self._vacuum_disabled:
            return 409, {"error": "vacuum disabled on this server "
                                  "(volume.vacuum.enable to resume)"}
        vid = int(req.json()["volumeId"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": "volume not found"}
        with self._exclusive(vid, "vacuum") as busy:
            if busy:
                return 409, {"error": f"volume {vid} is busy: {busy}"}
            garbage = v.garbage_level()
            before = v.dat_size()
            t0 = time.perf_counter()
            try:
                v.compact()
                t1 = time.perf_counter()
                replayed = v.commit_compact(
                    guard=lambda: self._swap_guard(vid))
            finally:
                self._wp_sync_volume(vid)
            t2 = time.perf_counter()
        for name, value, what in (
                ("volume_server_vacuum_total", 1.0,
                 "volumes compacted by /admin/vacuum"),
                ("volume_server_vacuum_replayed_entries_total", replayed,
                 ".idx entries the vacuum's diff replay applied (writes "
                 "and deletes that landed during the copy)"),
                ("volume_server_vacuum_reclaimed_bytes_total",
                 max(before - v.dat_size(), 0),
                 ".dat bytes the vacuum reclaimed")):
            self.metrics.counter_add(name, float(value), help_text=what)
        self._heartbeat_once()
        return 200, {"garbageRatio": garbage, "datBytesBefore": before,
                     "datBytes": v.dat_size(), "replayed": replayed,
                     "compactSeconds": t1 - t0, "commitSeconds": t2 - t1}

    def _merge_volume(self, req: Request):
        """volume.merge's server side: pull the peers' `.dat` files and
        rewrite this read-only copy as the AppendAtNs-ordered union
        (`Volume.merge_from`)."""
        b = req.json()
        vid = int(b["volumeId"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": "volume not found"}
        if not v.read_only:
            return 409, {"error": f"volume {vid} must be readonly "
                                  "before merging"}
        with self._exclusive(vid, "merge") as busy:
            if busy:
                return 409, {"error": f"volume {vid} is busy: {busy}"}
            tmp_paths: list = []
            try:
                for peer in b.get("peers", []):
                    fd, tmp = tempfile.mkstemp(
                        suffix=".dat", dir=os.path.dirname(v.file_name("")))
                    os.close(fd)
                    tmp_paths.append(tmp)
                    status, _hdrs = http_download(
                        f"{peer}/admin/volume_file?volumeId={vid}"
                        f"&collection={v.collection}&ext=.dat", tmp,
                        timeout=600)
                    if status != 200:
                        return 500, {"error":
                                     f"pull .dat from {peer}: {status}"}
                merged = v.merge_from(tmp_paths,
                                      guard=lambda: self._swap_guard(vid))
            except (OSError, ValueError, PermissionError) as e:
                return 500, {"error": f"merge: {e}"}
            finally:
                for tmp in tmp_paths:
                    try:
                        os.remove(tmp)
                    except FileNotFoundError:
                        pass
        self._heartbeat_once()
        return 200, {"mergedNeedles": merged, "datBytes": v.dat_size()}

    # -- tiers (storage/volume_tier.go) and the needle query ----------------

    def _tier_move(self, req: Request):
        """volume_server.proto VolumeTierMoveDatToRemote: the `.dat` to an
        S3 backend (named by `endpoint`, `bucket` and keys, else the one
        registered as `backendId`), then the volume mounted remote."""
        from ..storage.backend import configure_s3_backend, get_backend
        b = req.json()
        vid = int(b["volumeId"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        if v.is_remote:
            return 200, {"alreadyRemote": True}
        backend_id = b.get("backendId", "default")
        if b.get("endpoint"):
            storage = configure_s3_backend(
                backend_id, b["endpoint"], b.get("bucket", "tier"),
                b.get("accessKey", ""), b.get("secretKey", ""))
        else:
            try:
                storage = get_backend(backend_id)
            except KeyError as e:
                return 400, {"error": str(e)}
        with self._exclusive(vid, "tier.move") as busy:
            if busy:
                return 409, {"error": f"volume {vid} is busy: {busy}"}
            return self._tier_move_locked(v, vid, backend_id, storage)

    def _tier_move_locked(self, v, vid: int, backend_id: str, storage):
        collection = v.collection
        was_read_only = v.read_only
        self.store.set_volume_read_only(vid, True)
        v.sync()
        # the master stops assigning into it before the upload, whose
        # chunks may land on this very cluster
        self._heartbeat_once()
        # each replica tiers its own copy under its own key: replicas
        # may differ, and one key would be overwritten by the last
        key = (f"{collection}_" if collection else "") + \
            f"{vid}.{self.http.port}.dat"
        dat_path = v.file_name(".dat")
        try:
            storage.ensure_bucket()
            size = storage.upload(dat_path, key)
        except (OSError, RuntimeError) as e:
            if not was_read_only:
                self.store.set_volume_read_only(vid, False)
                self._wp_sync_volume(vid)
                self._heartbeat_once()
            return 500, {"error": f"tier upload failed: {e}"}
        v.volume_info.files = [{
            "backendType": "s3", "backendId": backend_id, "key": key,
            "fileSize": size, "extension": ".dat"}]
        v.volume_info.read_only = True
        v.save_volume_info()
        with self._swap_guard(vid):
            self.store.unmount_volume(vid)
        os.remove(dat_path)
        # outside the guard: the remote mount reads its superblock through
        # the tier, which may be this server's own gateway chain
        self.store.mount_volume(vid, collection)
        self._heartbeat_once()
        return 200, {"key": key, "fileSize": size, "backendId": backend_id}

    def _tier_fetch(self, req: Request):
        """volume.tier.download (VolumeTierMoveDatFromRemote): the remote
        `.dat` downloaded back, the volume mounted local and writable; the
        remote object deleted unless `deleteRemote` is false."""
        from ..storage.backend import get_backend
        b = req.json()
        vid = int(b["volumeId"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        if not v.is_remote:
            return 200, {"alreadyLocal": True}
        remote = v.volume_info.files[0]
        try:
            storage = get_backend(remote.get("backendId", "default"))
        except KeyError as e:
            return 400, {"error": str(e)}
        with self._exclusive(vid, "tier.fetch") as busy:
            if busy:
                return 409, {"error": f"volume {vid} is busy: {busy}"}
            collection = v.collection
            try:
                size = storage.download(remote["key"], v.file_name(".dat"))
            except (OSError, RuntimeError) as e:
                return 500, {"error": f"tier download failed: {e}"}
            v.volume_info.files = []
            # local and writable again: a stale readOnly in the .vif
            # would leave a reference reader treating it as frozen
            v.volume_info.read_only = False
            v.save_volume_info()
            with self._swap_guard(vid):
                self.store.unmount_volume(vid)
            self.store.mount_volume(vid, collection)
            self._wp_sync_volume(vid)
        if bool(b.get("deleteRemote", True)):
            storage.delete(remote["key"])
        self._heartbeat_once()
        # the backend that held it: volume.tier.compact uploads the
        # compacted copy there again
        return 200, {"fileSize": size,
                     "backendId": remote.get("backendId", "default")}

    def _query(self, req: Request):
        """volume_server.proto:132 Query (volume_grpc_query.go): a
        SQL-subset SELECT over one stored needle's JSON or CSV content,
        evaluated where the bytes are."""
        from ..query import QueryError, run_query
        b = req.json()
        vid, key = int(b["volumeId"]), int(b["key"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        try:
            n = v.read_needle(key)
        except KeyError as e:
            return 404, {"error": str(e)}
        try:
            rows = run_query(b["expression"], n.data,
                             b.get("inputFormat", "json"),
                             bool(b.get("csvHeader", True)))
        except QueryError as e:
            return 400, {"error": str(e)}
        return 200, {"rows": rows, "count": len(rows)}

    def _scrub(self, req: Request):
        """volume_grpc_scrub.go ScrubVolume: every live needle re-read
        and CRC-checked."""
        vid = int(req.json()["volumeId"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        count, errors = v.scrub()
        return 200, {"checked": count, "errors": errors}

    def _volume_index(self, req: Request):
        """The live [key, size] pairs of one volume, the `.idx` replayed
        with its deletes: what volume.check.disk and volume.fsck diff."""
        from ..storage import idx as idxmod
        vid = int(req.query["volumeId"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        v.sync()
        with open(v.file_name(".idx"), "rb") as f:
            live = idxmod.live_entries(f.read())
        return 200, {"volumeId": vid,
                     "entries": sorted((k, s) for k, (_o, s) in live.items())}

    def _admin_delete_needle(self, req: Request):
        """Tombstone one needle by key, without its cookie (the admin
        plane): the purge of volume.fsck -reallyDeleteFromVolume."""
        b = req.json()
        vid, key = int(b["volumeId"]), int(b["key"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        try:
            n = v.read_needle(key)
        except KeyError:
            self._rp_sync_needle(vid, key)
            self._nc_invalidate_needle(vid, key)
            return 200, {"freed": 0}
        try:
            freed = v.delete_needle(n)
        except PermissionError as e:
            return 409, {"error": str(e)}
        self._rp_sync_needle(vid, key)
        self._nc_invalidate_needle(vid, key)
        return 200, {"freed": freed}

    def _needle_raw(self, req: Request):
        """One needle's whole record (header to padding): the unit that
        replica repair copies (command_volume_check_disk.go)."""
        vid, key = int(req.query["volumeId"]), int(req.query["key"])
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        try:
            n = v.read_needle(key)
        except KeyError as e:
            return 404, {"error": str(e)}
        return 200, (n.to_bytes(v.version),
                     {"Content-Type": "application/octet-stream",
                      "X-Needle-Version": str(v.version)})

    def _write_needle_raw(self, req: Request):
        """Append a record pulled from a healthy replica (the receiving
        side of replica repair)."""
        import struct
        vid = int(req.query["volumeId"])
        version = int(req.query.get("version") or types.CURRENT_VERSION)
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        body = req.body
        if len(body) < types.NEEDLE_HEADER_SIZE:
            return 400, {"error": "needle record shorter than header"}
        try:
            n = Needle.parse_header(body[:types.NEEDLE_HEADER_SIZE])
            n.parse_body(body[types.NEEDLE_HEADER_SIZE:], version)
        except (ValueError, struct.error) as e:
            return 400, {"error": f"bad needle record: {e}"}
        try:
            size, _ = self.store.write_needle(vid, n)
        except PermissionError as e:
            return 409, {"error": str(e)}
        self._nc_invalidate_needle(vid, n.id)
        self._rp_sync_needle(vid, n.id)
        return 200, {"size": size}

    # -- EC generate (volume_grpc_erasure_coding.go:43) -------------------

    def _ec_generate(self, req: Request):
        """:43 VolumeEcShardsGenerate: `.ecx` BEFORE the shard files
        (race rationale :89-98), then the scheme to `.vif` (:132).  With
        `placement` ({shard_id: url}) in the body, a scatter-encode."""
        b = req.json()
        vid = int(b["volumeId"])
        collection = b.get("collection", "")
        ctx = ECContext(int(b.get("dataShards") or 10),
                        int(b.get("parityShards") or 4),
                        collection, vid, device=self.device)
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        if collection != v.collection:
            return 409, {"error": f"collection mismatch: volume {vid} "
                                  f"is {v.collection!r}, "
                                  f"not {collection!r}"}
        if not v.read_only:
            return 409, {"error": "volume must be readonly before encode"}
        with self._exclusive(vid, "ec.generate") as busy:
            if busy:
                return 409, {"error": f"volume {vid} is busy: {busy}"}
            return self._ec_generate_locked(b, v, vid, collection, ctx)

    def _ec_generate_locked(self, b: dict, v, vid: int, collection: str,
                            ctx: ECContext):
        v.sync()
        base = v.file_name("")
        dat_size = v.dat_size()
        placement = b.get("placement")
        with self._codec_device():
            if placement is not None:
                replan = int(b.get("replan") or 0)
                if replan:
                    # the shell re-planned a failed stripe around dead
                    # destinations and retries here
                    self.role_metrics.counter_add(
                        "ec_scatter_replans_total", float(replan),
                        help_text="scatter encodes re-planned around "
                                  "failed destinations")
                return self._ec_scatter_generate(
                    v, ctx, collection, base, dat_size, placement)
            ec_encoder.write_sorted_file_from_idx(base)      # .ecx first
            ec_encoder.write_ec_files(base, ctx)
            ec_encoder.save_ec_volume_info(base, ctx, dat_size, v.version)
        return 200, {"shardIds": list(range(ctx.total))}

    def _ec_scatter_generate(self, v, ctx: ECContext, collection: str,
                             base: str, dat_size: int, placement: dict):
        """Placement-first streaming encode.  The order is the
        no-partial-stripe invariant: (1) stream every shard to its sink
        and verify delivery (CRC and byte count, still uncommitted
        temps), (2) push the sidecars (.ecx/.vif/.ecj) to every remote
        destination, (3) commit each destination's shards in one round
        trip, mounting them, (4) commit and mount the local shards.  A
        failure anywhere aborts what is uncommitted, deletes what was
        committed, and restores this node's `.vif`; `failedDests` in the
        error body names the destinations seen failing, for a
        re-planner."""
        from ..storage.erasure_coding.shard_sink import (
            LocalShardSink, RemoteShardSink, ScatterStats)
        dests = {int(sid): url for sid, url in (placement or {}).items()}
        if sorted(dests) != list(range(ctx.total)):
            return 400, {"error": f"placement must cover shards "
                                  f"0..{ctx.total - 1}, got "
                                  f"{sorted(dests)}"}
        self_urls = {self.http.url, self.store.public_url}
        stats_ = ScatterStats()
        failed_dests: set = set()
        failed_lock = threading.Lock()

        def _note_failed(url: str) -> None:
            with failed_lock:
                failed_dests.add(url)

        t_start = time.perf_counter()
        # a pre-existing .vif is restored verbatim by the unwind, never
        # just deleted (for a tiered volume it is the only pointer to
        # the remote .dat)
        vif_before: "bytes | None" = None
        try:
            with open(base + ".vif", "rb") as vf:
                vif_before = vf.read()
        except OSError:
            pass
        ec_encoder.write_sorted_file_from_idx(base)      # .ecx first
        sinks: list = []
        local_sids: list[int] = []
        try:
            for sid in range(ctx.total):
                if dests[sid] in self_urls:
                    local_sids.append(sid)
                    sinks.append(LocalShardSink(base + ctx.to_ext(sid),
                                                temp=True, stats=stats_))
                else:
                    sinks.append(RemoteShardSink(
                        dests[sid], v.id, sid, collection=collection))
            # (1) on return every sink is finished (delivery verified)
            # or aborted
            ec_encoder._generate_ec_files(base, ctx, sinks=sinks,
                                          stats=stats_)
            t_encoded = time.perf_counter()
            ec_encoder.save_ec_volume_info(base, ctx, dat_size, v.version)
            # (2) sidecars before any commit: mount needs .ecx, and a
            # destination must never hold a visible shard it cannot
            # serve.  One thread per destination: the files are small,
            # the round trips are what would serialise
            remote_dests = sorted({u for s, u in dests.items()
                                   if s not in local_sids})
            sidecars: list[tuple[str, bytes]] = []
            for ext in (".ecx", ".vif", ".ecj"):
                if os.path.exists(base + ext):
                    with open(base + ext, "rb") as sf:
                        sidecars.append((ext, sf.read()))

            def push_sidecars(url: str) -> None:
                try:
                    for ext, payload in sidecars:
                        st, body, _ = http_bytes(
                            "POST",
                            f"{url}/admin/receive_file?volumeId={v.id}"
                            f"&collection={collection}&ext={ext}",
                            payload, timeout=60)
                        if st != 200:
                            raise OSError(f"push {ext} to {url}: {st} "
                                          f"{body[:200]!r}")
                except OSError:
                    _note_failed(url)
                    raise
            with ThreadPoolExecutor(
                    max_workers=max(1, len(remote_dests))) as pool:
                list(pool.map(push_sidecars, remote_dests))
            t_sidecars = time.perf_counter()
            # (3) + (4): one batched commit-and-mount per destination,
            # destinations in parallel
            by_dest_sids: dict[str, list[int]] = {}
            for sid in range(ctx.total):
                if sid not in local_sids:
                    by_dest_sids.setdefault(dests[sid], []).append(sid)

            def commit_dest(item):
                url, sids = item
                try:
                    r = http_json(
                        "POST", f"{url}/admin/ec/shard_write_commit",
                        {"volumeId": v.id, "collection": collection,
                         "mount": True,
                         "commits": [{"uploadId": sinks[sid].upload_id,
                                      "shardId": sid,
                                      "crc32": sinks[sid].crc,
                                      "bytes": sinks[sid].bytes}
                                     for sid in sids]},
                        timeout=30)
                    if "error" in r:
                        raise OSError(f"commit {sids} on {url}: "
                                      f"{r['error']}")
                except OSError:
                    _note_failed(url)
                    raise
                for sid in sids:
                    sinks[sid].mark_committed()
            with ThreadPoolExecutor(
                    max_workers=max(1, len(by_dest_sids))) as pool:
                list(pool.map(commit_dest, by_dest_sids.items()))
            for sid in local_sids:
                sinks[sid].commit()
            if local_sids:
                self.store.mount_ec_shards(v.id, collection, local_sids)
            else:
                # no shard stays here: drop the staging .ecx so this
                # node does not resolve a stale EC base for the vid
                try:
                    os.remove(base + ".ecx")
                except OSError:
                    pass
            self._heartbeat_once()
            t_mounted = time.perf_counter()
        except Exception as e:  # noqa: BLE001 — unwind, then report
            for sink in sinks:
                url = getattr(sink, "url", "")
                if url and (getattr(sink, "_error", None) is not None
                            or url in str(e)):
                    # the sink's send thread failed, or the error names
                    # this destination (finish()'s mismatch does)
                    _note_failed(url)
                try:
                    sink.close()  # aborts anything uncommitted
                except OSError:
                    pass
            self._ec_scatter_unwind(v.id, collection, ctx, dests, base,
                                    vif_before)
            return 500, {"error": f"scatter encode: {e}",
                         "failedDests": sorted(failed_dests)}
        wall = time.perf_counter() - t_start
        tele = stats_.summary(dat_size, wall)
        tele["mode"] = "scatter"
        tele["encodeSeconds"] = round(t_encoded - t_start, 3)
        tele["sidecarSeconds"] = round(t_sidecars - t_encoded, 3)
        tele["commitSeconds"] = round(t_mounted - t_sidecars, 3)
        self._record_scatter_metrics(stats_, tele)
        return 200, {"shardIds": list(range(ctx.total)),
                     "placement": {str(s): u for s, u in dests.items()},
                     "localShardIds": local_sids,
                     "telemetry": tele}

    def _ec_scatter_unwind(self, vid: int, collection: str,
                           ctx: ECContext, dests: "dict[int, str]",
                           base: str, vif_before: "bytes | None") -> None:
        """Tear down whatever a destination may already hold (committed
        shards, pushed sidecars) and this node's local artifacts, so the
        still-live volume is the only copy.  delete_shards is idempotent
        and cleans sidecars when the last shard goes.  The `.vif` is
        restored to its pre-encode bytes."""
        for url in sorted(set(dests.values())):
            try:
                http_json("POST", f"{url}/admin/ec/delete_shards",
                          {"volumeId": vid, "collection": collection,
                           "shardIds": list(range(ctx.total))},
                          timeout=30)
            except OSError:
                pass
        try:
            os.remove(base + ".ecx")
        except OSError:
            pass
        try:
            if vif_before is not None:
                with open(base + ".vif", "wb") as vf:
                    vf.write(vif_before)
            else:
                os.remove(base + ".vif")
        except OSError:
            pass

    def _record_scatter_metrics(self, stats_, tele: dict) -> None:
        """Bytes scattered per destination against bytes written
        locally, per-window push latency, and the last GB/s."""
        by_dest, latencies, local_bytes = stats_.snapshot()
        for dest, nbytes in by_dest.items():
            self.metrics.counter_add(
                "ec_encode_bytes_scattered_total", float(nbytes),
                help_text="shard bytes streamed to placement targets "
                          "during scatter-encode", dest=dest)
        self.metrics.counter_add(
            "ec_encode_local_write_bytes_total", float(local_bytes),
            help_text="shard bytes written to this node's own disks "
                      "during scatter-encode")
        for seconds in latencies:
            self.metrics.histogram_observe(
                "ec_encode_push_slice_seconds", seconds,
                help_text="per-window destination push latency")
        self.metrics.counter_add("ec_scatter_encodes_total", 1.0,
                                 help_text="scatter encodes run")
        self.metrics.gauge_set(
            "ec_encode_volume_gbps", tele["volumeGbps"],
            help_text="volume-bytes/s of the last scatter encode")

    # -- scatter receivers -------------------------------------------------

    def _ec_shard_write(self, req: Request):
        """Stream one shard into a `.scatter.<uploadId>` temp file with a
        running CRC32.  It stays invisible until `shard_write_commit`; a
        stream that dies mid-body leaves nothing registered and the temp
        is removed.  Page-cache writes: integrity is the CRC and commit
        handshake."""
        vid = int(req.query["volumeId"])
        sid = int(req.query["shardId"])
        collection = req.query.get("collection", "")
        upload_id = req.query.get("uploadId", "")
        try:
            check_path_fields(collection)
        except ValueError as e:
            return 400, {"error": str(e)}
        if not upload_id.isalnum():
            return 400, {"error": "bad uploadId"}
        self._reap_stale_shard_writes()
        base = self._base_path(vid, collection)
        tmp = f"{base}{to_ext(sid)}.scatter.{upload_id}"
        crc = 0
        n = 0
        ok = False
        try:
            with open(tmp, "wb") as f:
                for chunk in req.stream_body():
                    directive = faults.fire("volume.shard_write.recv",
                                            key=f"{vid}.{sid}")
                    if directive is not None:
                        # the stream dies here: the temp goes, nothing
                        # registers, the sender errors
                        raise IOError(f"shard_write {vid}.{sid}: "
                                      f"fault-injected {directive} "
                                      f"mid-stream")
                    f.write(chunk)
                    crc = zlib.crc32(chunk, crc)
                    n += len(chunk)
            ok = True
        finally:
            if not ok:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        with self._pending_lock:
            self._pending_shard_writes[upload_id] = {
                "path": tmp, "crc": crc, "bytes": n, "vid": vid,
                "sid": sid, "collection": collection,
                "stamp": time.monotonic()}
        return 200, {"bytes": n, "crc32": crc}

    def _reap_stale_shard_writes(self, max_age: float = 3600.0) -> None:
        """Drop staged uploads whose sender died without an abort."""
        now = time.monotonic()
        with self._pending_lock:
            stale = [k for k, rec in self._pending_shard_writes.items()
                     if now - rec["stamp"] > max_age]
            recs = [self._pending_shard_writes.pop(k) for k in stale]
        for rec in recs:
            try:
                os.remove(rec["path"])
            except OSError:
                pass

    def _ec_shard_write_commit(self, req: Request):
        """Check the sender's CRC and byte count against what was
        streamed, then rename the temps to their `.ecNN` names (`mount:
        true` mounts them too).  One upload ({uploadId, shardId, crc32,
        bytes}) or a batch (`commits: [...]`), all verified before any
        rename; a mismatch refuses the commit and discards the
        temps."""
        b = req.json()
        vid = int(b["volumeId"])
        collection = b.get("collection", "")
        commits = b.get("commits")
        if commits is None:
            commits = [{"uploadId": b.get("uploadId", ""),
                        "shardId": b.get("shardId", -1),
                        "crc32": b.get("crc32", -1),
                        "bytes": b.get("bytes", -1)}]
        recs: list[tuple[dict, dict]] = []
        with self._pending_lock:
            for c in commits:
                rec = self._pending_shard_writes.pop(
                    str(c.get("uploadId", "")), None)
                if rec is not None:
                    recs.append((c, rec))

        def _discard():
            for _c, rec in recs:
                try:
                    os.remove(rec["path"])
                except OSError:
                    pass
        if len(recs) != len(commits):
            _discard()
            return 404, {"error": f"unknown staged upload in "
                                  f"{[c.get('uploadId') for c in commits]}"}
        for c, rec in recs:
            sid = int(c["shardId"])
            if int(c.get("bytes", -1)) != rec["bytes"] or \
                    int(c.get("crc32", -1)) != rec["crc"] or \
                    vid != rec["vid"] or sid != rec["sid"] or \
                    collection != rec["collection"]:
                _discard()
                return 409, {"error":
                             f"shard {vid}.{sid} upload mismatch: staged "
                             f"{rec['bytes']}B crc {rec['crc']}, caller "
                             f"says {c.get('bytes')}B crc "
                             f"{c.get('crc32')}"}
        base = self._base_path(vid, collection)
        sids = []
        for c, rec in recs:
            sid = int(c["shardId"])
            os.replace(rec["path"], base + to_ext(sid))
            sids.append(sid)
        if b.get("mount"):
            self.store.mount_ec_shards(vid, collection, sids)
            self._rp_drop_volume(vid)
            self._heartbeat_once()
        return 200, {"shardIds": sids,
                     "bytes": sum(rec["bytes"] for _c, rec in recs)}

    def _ec_shard_write_abort(self, req: Request):
        upload_id = str(req.json().get("uploadId", ""))
        with self._pending_lock:
            rec = self._pending_shard_writes.pop(upload_id, None)
        if rec is not None:
            try:
                os.remove(rec["path"])
            except OSError:
                pass
        return 200, {}

    # -- mount / unmount / delete -----------------------------------------

    def _ec_mount(self, req: Request):
        """:443 VolumeEcShardsMount."""
        b = req.json()
        collection = b.get("collection", "")
        check_path_fields(collection)
        vid = int(b["volumeId"])
        ev = self.store.mount_ec_shards(
            vid, collection, [int(s) for s in b.get("shardIds", [])])
        self._rp_drop_volume(vid)
        self._heartbeat_once()
        return 200, {"shardIds": ev.shard_ids}

    def _ec_unmount(self, req: Request):
        """:464 VolumeEcShardsUnmount: only the listed shards; no
        `shardIds` key unmounts the volume, an empty list nothing."""
        b = req.json()
        vid = int(b["volumeId"])
        self.store.unmount_ec_shards(
            vid, [int(s) for s in b["shardIds"]] if "shardIds" in b else None)
        self.ec_reader.forget(vid)
        self._rp_drop_volume(vid)
        self._heartbeat_once()
        return 200, {}

    def _ec_delete_shards(self, req: Request):
        """:327 VolumeEcShardsDelete: remove local shard files, and the
        index files with the last shard."""
        b = req.json()
        vid = int(b["volumeId"])
        collection = b.get("collection", "")
        base = self._base_path(vid, collection)
        for s in b.get("shardIds", []):
            try:
                os.remove(base + to_ext(int(s)))
            except FileNotFoundError:
                pass
        if not any(os.path.exists(base + to_ext(s)) for s in range(32)):
            for ext in (".ecx", ".ecj", ".vif"):
                try:
                    os.remove(base + ext)
                except FileNotFoundError:
                    pass
            self.store.unmount_ec_shards(vid)
        else:
            self.store.mount_ec_shards(vid, collection, [])
        self.ec_reader.forget(vid)
        self._rp_drop_volume(vid)
        self._heartbeat_once()
        return 200, {}

    def _ec_copy(self, req: Request):
        """:228 VolumeEcShardsCopy: pull shard and index files from the
        source server's `/admin/volume_file`, each streamed to disk."""
        b = req.json()
        vid = int(b["volumeId"])
        collection = b.get("collection", "")
        source = b["sourceDataNode"]
        base = self._base_path(vid, collection)
        exts = [to_ext(int(s)) for s in b.get("shardIds", [])]
        if exts:
            self.metrics.counter_add(
                "ec_shard_whole_file_copies", float(len(exts)),
                help_text="whole shard files pulled via /admin/ec/copy")
        for key, ext in (("copyEcxFile", ".ecx"), ("copyEcjFile", ".ecj"),
                         ("copyVifFile", ".vif")):
            if b.get(key, False):
                exts.append(ext)
        for ext in exts:
            status, _hdrs = http_download(
                f"{source}/admin/volume_file?volumeId={vid}"
                f"&collection={collection}&ext={ext}", base + ext,
                timeout=600)
            if status != 200:
                if ext == ".ecj":  # the journal may not exist
                    continue
                return 500, {"error":
                             f"copy {ext} from {source}: {status}"}
        return 200, {}

    def _ec_to_volume(self, req: Request):
        """:586 VolumeEcShardsToVolume: the data shards back into a
        `.dat` (concatenated on the host, no codec) and the `.ecx` minus
        the `.ecj` deletes into an `.idx`, then mounted as a normal
        volume."""
        b = req.json()
        vid = int(b["volumeId"])
        collection = b.get("collection", "")
        base = self._base_path(vid, collection)
        if not ec_decoder.has_live_needles(base):
            return 400, {"error": f"volume {vid} has no live entries"}
        dat_size = ec_decoder.find_dat_file_size(base, base)
        scheme = ec_encoder.scheme_from_vif(base, device="cpu")
        n_data = scheme.data_shards if scheme else 10
        ec_decoder.write_dat_file(base, dat_size,
                                  [base + to_ext(i) for i in range(n_data)])
        ec_decoder.write_idx_file_from_ec_index(base)
        self.store.unmount_ec_shards(vid)
        self.ec_reader.forget(vid)
        self._rp_drop_volume(vid)
        self.store.mount_volume(vid, collection)
        self._wp_sync_volume(vid)
        self._heartbeat_once()
        return 200, {}

    # -- rebuild (:149) ----------------------------------------------------

    def _ec_rebuild(self, req: Request):
        """:149 VolumeEcShardsRebuild, streaming by default: survivors
        this node lacks are read in slice windows straight off their
        servers' `/admin/ec/shard_read` (one prefetching stream each),
        so repair stages no whole survivor file here.  `mode: "local"`
        needs every survivor on this node.  Remote survivors come from
        `shardLocations` ({shard_id: [urls]}) or, without it, from the
        master; with neither, the rebuild is local."""
        from ..storage.erasure_coding.shard_source import (
            LocalShardSource, RebuildStats, RemoteShardSource,
            rebuild_slice_bytes)
        t_start = time.perf_counter()
        b = req.json()
        vid = int(b["volumeId"])
        collection = b.get("collection", "")
        base = self._base_path(vid, collection)
        extra_dirs = [loc.directory for loc in self.store.locations]
        ctx = ec_encoder.scheme_from_vif(base, device=self.device) or \
            ECContext(int(b.get("dataShards") or 10),
                      int(b.get("parityShards") or 4), device=self.device)
        if b.get("mode", "stream") == "local":
            with self._codec_device():
                generated = ec_encoder.rebuild_ec_files(
                    base, ctx, additional_dirs=extra_dirs)
            return 200, {"rebuiltShardIds": generated, "mode": "local"}
        # file discovery is the anchor (survivors copied here unmounted
        # count); the mounted shards only give the size
        present_paths, local_missing = \
            ec_encoder.discover_shard_files(base, ctx, extra_dirs)
        ev = self.store.find_ec_volume(vid)
        size_hint = None
        if ev is not None:
            with ev.lock:
                if ev.shards:
                    size_hint = max(s.size for s in ev.shards.values())
        remote: dict[int, list[str]] = {}
        raw_locs = b.get("shardLocations")
        if raw_locs is None:
            raw_locs = self._master_shard_locations(vid)
        self_urls = {self.http.url, self.store.public_url}
        for sid_s, urls in (raw_locs or {}).items():
            sid = int(sid_s)
            urls = [u for u in urls if u not in self_urls]
            if sid not in present_paths and urls:
                remote[sid] = urls
        targets = [sid for sid in local_missing if sid not in remote]
        if not targets:
            return 200, {"rebuiltShardIds": [], "mode": "stream"}
        device = self._codec_device()   # raises before any file opens
        sources: dict[int, object] = {
            sid: LocalShardSource(p) for sid, p in present_paths.items()}
        # any d survivors reconstruct, so the local ones first, then
        # only d - local remote rows, round-robined across donors so no
        # one peer's disk serialises the streams
        want_remote = max(ctx.data_shards - len(present_paths), 0)
        by_donor: dict[str, list[int]] = {}
        for sid in sorted(remote):
            by_donor.setdefault(remote[sid][0], []).append(sid)
        chosen: list[int] = []
        tiers = list(by_donor.values())
        i = 0
        while len(chosen) < want_remote and any(tiers):
            if tiers[i % len(tiers)]:
                chosen.append(tiers[i % len(tiers)].pop(0))
            i += 1
        for sid in chosen:
            sources[sid] = RemoteShardSource(remote[sid], vid, sid)
        stats_ = RebuildStats()
        t0 = time.perf_counter()
        try:
            if size_hint is None and present_paths:
                size_hint = max(os.path.getsize(p)
                                for p in present_paths.values())
            with device:
                generated = ec_encoder.rebuild_from_sources(
                    base, ctx, sources, targets, stats=stats_,
                    slice_bytes=rebuild_slice_bytes() if chosen else None,
                    shard_size=size_hint)
        except ValueError as e:
            return 500, {"error": str(e)}
        wall = time.perf_counter() - t0
        shard_size = os.path.getsize(base + ctx.to_ext(targets[0]))
        tele = stats_.summary(ctx.data_shards * shard_size, wall)
        tele["mode"] = "stream"
        tele["rebuiltBytes"] = len(generated) * shard_size
        tele["setupSeconds"] = round(t0 - t_start, 3)
        self._record_rebuild_metrics(stats_, tele)
        return 200, {"rebuiltShardIds": generated, "mode": "stream",
                     "telemetry": tele}

    def _master_shard_locations(self, vid: int) -> "dict[str, list[str]]":
        """Survivor locations for a rebuild sent without
        `shardLocations`: the master's `/dir/ec_lookup`.  No master, or
        one that does not answer, leaves a local rebuild."""
        if not self.master:
            return {}
        from ..topology import fetch_ec_shard_locations, shard_ids_to_urls
        try:
            return shard_ids_to_urls(
                fetch_ec_shard_locations(self.master, vid))
        except OSError:
            return {}

    def _record_rebuild_metrics(self, stats_, tele: dict) -> None:
        by_source, latencies = stats_.snapshot()
        for label, nbytes in by_source.items():
            self.metrics.counter_add(
                "ec_rebuild_bytes_fetched_total", float(nbytes),
                help_text="survivor bytes streamed into EC rebuild",
                source=label)
        for seconds in latencies:
            self.metrics.histogram_observe(
                "ec_rebuild_slice_seconds", seconds,
                help_text="per-slice survivor fetch latency")
        self.metrics.counter_add("ec_rebuilds_total", 1.0,
                                 help_text="streaming EC rebuilds run")
        self.metrics.gauge_set(
            "ec_rebuild_volume_gbps", tele["volumeGbps"],
            help_text="volume-bytes/s of the last streaming rebuild")

    def _metrics(self, req: Request):
        """Prometheus text: the role's registry (`volume_server_`
        request and write-stage histograms), then `stats.PROCESS`
        (device, staging, kernel and EC route metrics, the process
        tree), with this server's volume gauges and the launches the
        GF(2^8) kernel's wrappers have counted in this process
        (`rs_cuda.LAUNCHES` and `LAUNCHES_BATCHED`)."""
        from ..ops import rs_cuda
        for entry, n in (("gf_apply_words", rs_cuda.LAUNCHES),
                         ("gf_apply_words_batched",
                          rs_cuda.LAUNCHES_BATCHED)):
            self.metrics.gauge_set(
                "gf_kernel_launches", float(n), entry=entry,
                help_text="kernel launches counted by the wrappers")
        hb = self.store.collect_heartbeat()
        self.metrics.gauge_set("volumes", len(hb["volumes"]),
                               help_text="mounted volumes")
        self.metrics.gauge_set("ec_volumes", len(hb["ecShards"]))
        self.metrics.gauge_set("max_volume_count", hb["maxVolumeCount"])
        return 200, ((self.role_metrics.render() +
                      stats.render_process() +
                      self._plane_metrics_text()).encode(),
                     {"Content-Type": "text/plain; version=0.0.4"})

    def _plane_metrics_text(self) -> str:
        """The planes' counters, read from their C++ atomics at scrape
        time (no Python runs on a plane's request): records the UDS
        plane sent, reads the read plane served, writes the write plane
        acked and handed back to Python, its -fsync epochs, and its ack
        latency histogram."""
        out = []
        rp, wp = self.read_plane, self.write_plane
        if self.uds_server is not None:
            out.append(
                "# HELP volume_server_uds_reads_total needle records "
                "served over the UDS zero-copy plane\n"
                "# TYPE volume_server_uds_reads_total counter\n"
                f"volume_server_uds_reads_total {self.uds_server.served}\n")
        if rp is not None:
            out.append(
                "# HELP volume_server_read_plane_requests_total needle "
                "reads served by the native read plane\n"
                "# TYPE volume_server_read_plane_requests_total counter\n"
                f"volume_server_read_plane_requests_total {rp.served()}\n")
        if wp is None:
            return "".join(out)
        out.append(
            "# HELP volume_server_write_plane_requests_total needle "
            "writes acked by the native write plane\n"
            "# TYPE volume_server_write_plane_requests_total counter\n"
            f"volume_server_write_plane_requests_total {wp.requests()}\n"
            "# HELP volume_server_write_plane_fallbacks_total native "
            "writes answered 404 (the Python port takes them)\n"
            "# TYPE volume_server_write_plane_fallbacks_total counter\n"
            f"volume_server_write_plane_fallbacks_total {wp.fallbacks()}\n"
            "# HELP volume_server_write_plane_epochs_total -fsync epoch "
            "handshakes released after the volume's barrier\n"
            "# TYPE volume_server_write_plane_epochs_total counter\n"
            f"volume_server_write_plane_epochs_total {wp.epochs}\n"
            "# HELP volume_server_write_plane_epoch_failures_total -fsync "
            "epochs whose barrier failed (their acks stay parked)\n"
            "# TYPE volume_server_write_plane_epoch_failures_total "
            "counter\n"
            "volume_server_write_plane_epoch_failures_total "
            f"{wp.epoch_failures}\n"
            "# HELP volume_server_write_plane_fsync_refused_total -fsync "
            "volumes the plane refused for want of the epoch handshake\n"
            "# TYPE volume_server_write_plane_fsync_refused_total counter\n"
            "volume_server_write_plane_fsync_refused_total "
            f"{wp.fsync_refused}\n"
            "# HELP volume_server_write_plane_ack_seconds native write "
            "plane ack latency\n"
            "# TYPE volume_server_write_plane_ack_seconds histogram\n")
        buckets, count, total_s = wp.ack_histogram()
        for le, cum in zip(ACK_BUCKETS_S, buckets):
            out.append("volume_server_write_plane_ack_seconds_bucket"
                       f'{{le="{le}"}} {cum}\n')
        out.append("volume_server_write_plane_ack_seconds_bucket"
                   f'{{le="+Inf"}} {count}\n'
                   f"volume_server_write_plane_ack_seconds_sum {total_s}\n"
                   f"volume_server_write_plane_ack_seconds_count {count}\n")
        return "".join(out)

    # -- reads --------------------------------------------------------------

    def _ec_shard_read(self, req: Request):
        """:101 VolumeEcShardRead: a raw range of one mounted shard, from
        a private fd (shard files are immutable), sent with sendfile."""
        vid = int(req.query["volumeId"])
        shard_id = int(req.query["shardId"])
        offset = int(req.query.get("offset", 0))
        size = int(req.query.get("size", 0))
        ev = self.store.find_ec_volume(vid)
        if ev is None or shard_id not in ev.shards:
            return 404, {"error": f"shard {vid}.{shard_id} not found"}
        shard = ev.shards[shard_id]
        n = max(0, min(size, shard.size - offset))
        directive = faults.fire("volume.shard_read.serve",
                                key=f"{vid}.{shard_id}")
        f = open(shard.path, "rb")
        f.seek(offset)
        if directive in ("truncate", "drop"):
            # a donor dying mid-serve: promise n bytes, send fewer (half,
            # or none for drop) and close, so the reader sees EOF short
            # of the Content-Length, which its failover treats as a dead
            # donor, never as a short shard
            req._handler.close_connection = True
            served = n // 2 if directive == "truncate" else 0
            return 200, (FileSlice(f, served), {"Content-Length": str(n)})
        return 200, (FileSlice(f, n), {"Content-Length": str(n)})

    def _ec_scrub(self, req: Request):
        """volume_grpc_scrub.go ScrubEcVolume, modes `index` and `local`
        (shell/command_ec_scrub.go:52)."""
        b = req.json()
        vid = int(b["volumeId"])
        mode = b.get("mode", "local")
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            return 404, {"error": f"ec volume {vid} not mounted"}
        if mode == "index":
            count, errors = ev.scrub_index()
            return 200, {"checked": count, "errors": errors,
                         "brokenShards": []}
        count, broken, errors = ev.scrub_local()
        return 200, {"checked": count, "errors": errors,
                     "brokenShards": broken}

    def _ec_info(self, req: Request):
        """:688 VolumeEcShardsInfo."""
        vid = int(req.query["volumeId"])
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            return 404, {"error": f"ec volume {vid} not mounted"}
        return 200, {
            "volumeId": vid,
            "collection": ev.collection,
            "shardIds": ev.shard_ids,
            "shardSize": ev.shard_size(),
            "dataShards": ev.ctx.data_shards,
            "parityShards": ev.ctx.parity_shards,
        }
