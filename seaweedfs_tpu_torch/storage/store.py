"""Store: a volume server's disk locations, their volumes and mounted EC
volumes (weed/storage/store.go, disk_location.go) — the part of
`seaweedfs_tpu/storage/store.py` that the EC admin routes and the
heartbeat use, over the port's `Volume`: lookups, volume allocation,
mount, unmount and delete, EC shard mount and unmount, needle writes,
needle reads and deletes on normal and EC volumes, and the heartbeat
snapshot the master consumes.  An EcVolume holds open shard and `.ecx`
handles: the store closes one it replaces or unmounts.
"""

from __future__ import annotations

import glob
import os
import re
import threading

from .erasure_coding.ec_context import to_ext
from .erasure_coding.ec_volume import EcVolume
from .needle import Needle
from .replica_placement import ReplicaPlacement
from .ttl import EMPTY_TTL, read_ttl
from .volume import Volume

_VOL_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.dat$")
_EC_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.ec00$")


class DiskLocation:
    """One storage directory (weed/storage/disk_location.go)."""

    def __init__(self, directory: str, max_volume_count: int = 8,
                 fsync: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_volume_count = max_volume_count
        self.fsync = fsync
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        os.makedirs(self.directory, exist_ok=True)

    def load_existing(self) -> None:
        for path in glob.glob(os.path.join(self.directory, "*.dat")):
            m = _VOL_RE.match(os.path.basename(path))
            if m:
                vid = int(m.group("vid"))
                self.volumes[vid] = Volume(self.directory, vid,
                                           collection=m.group("col") or "",
                                           fsync=self.fsync)
        for path in glob.glob(os.path.join(self.directory, "*.ec00")):
            m = _EC_RE.match(os.path.basename(path))
            if m:
                vid = int(m.group("vid"))
                self.ec_volumes[vid] = EcVolume(
                    self.directory, vid, collection=m.group("col") or "")


class Store:
    """storage/store.go:88 NewStore."""

    def __init__(self, directories: list[str], ip: str = "localhost",
                 port: int = 0, public_url: str = "", fsync: bool = False):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        # -fsync: every volume's group-commit barrier also fsyncs (the
        # power-loss tier, one fsync a commit window)
        self.fsync = fsync
        self.locations = [DiskLocation(d, fsync=fsync) for d in directories]
        self.lock = threading.RLock()
        for loc in self.locations:
            loc.load_existing()

    def find_volume(self, vid: int) -> Volume | None:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def find_ec_volume(self, vid: int) -> EcVolume | None:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev
        return None

    def _location_for_new_volume(self) -> DiskLocation:
        """The location with the most free volume slots (the first of
        equals)."""
        best, slack = None, -1
        for loc in self.locations:
            s = loc.max_volume_count - len(loc.volumes)
            if s > slack:
                best, slack = loc, s
        if best is None:
            raise RuntimeError("no disk locations")
        return best

    # -- volume admin -----------------------------------------------------

    def add_volume(self, vid: int, collection: str = "",
                   replication: str = "", ttl: str = "") -> Volume:
        """volume_server.proto AllocateVolume: a new empty volume."""
        with self.lock:
            if self.find_volume(vid) is not None:
                raise ValueError(f"volume {vid} already exists")
            loc = self._location_for_new_volume()
            v = Volume(
                loc.directory, vid, collection=collection,
                replica_placement=ReplicaPlacement.from_string(replication),
                ttl=read_ttl(ttl) if ttl else EMPTY_TTL, fsync=loc.fsync)
            loc.volumes[vid] = v
            return v

    def delete_volume(self, vid: int) -> None:
        with self.lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    v.destroy()
                    return
            raise KeyError(f"volume {vid} not found")

    def unmount_volume(self, vid: int) -> None:
        with self.lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    v.close()
                    return
            raise KeyError(f"volume {vid} not found")

    def mount_volume(self, vid: int, collection: str = "") -> Volume:
        with self.lock:
            for loc in self.locations:
                name = (f"{collection}_" if collection else "") + f"{vid}"
                if os.path.exists(os.path.join(loc.directory,
                                               name + ".dat")):
                    v = Volume(loc.directory, vid, collection=collection,
                               fsync=loc.fsync)
                    loc.volumes[vid] = v
                    return v
            raise KeyError(f"volume {vid} files not found")

    def set_volume_read_only(self, vid: int, read_only: bool) -> None:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        if read_only:
            # the native write plane must stop acking what Python now
            # refuses; the volume server re-attaches on the thaw
            v.detach_native()
        v.read_only = read_only

    # -- needle IO (store.go:580/:604) ------------------------------------

    def write_needle(self, vid: int, n: Needle,
                     check_cookie: bool = True) -> tuple[int, bool]:
        """(size, unchanged) of the write (store.go:580)."""
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        _, size, unchanged = v.write_needle(n, check_cookie=check_cookie)
        return size, unchanged

    def read_needle(self, vid: int, needle_id: int,
                    cookie: int | None = None, ec_reader=None) -> Needle:
        """store.go:604 ReadVolumeNeedle.  For EC volumes, `ec_reader`
        (server/store_ec.EcReader) reads remote intervals and rebuilds
        lost ones; without it only locally complete needles are
        readable."""
        v = self.find_volume(vid)
        if v is not None:
            return v.read_needle(needle_id, cookie=cookie)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            if ec_reader is not None:
                return ec_reader.read_needle(ev, needle_id, cookie=cookie)
            return ev.read_needle_local(needle_id, cookie=cookie)
        raise KeyError(f"volume {vid} not found")

    def delete_needle(self, vid: int, n: Needle) -> int:
        """The freed size on a normal volume; 0 on an EC volume, whose
        `.ecx` entry is tombstoned and the id journaled to `.ecj`."""
        v = self.find_volume(vid)
        if v is not None:
            return v.delete_needle(n)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            ev.delete_needle(n.id)
            return 0
        raise KeyError(f"volume {vid} not found")

    # -- EC shard admin (store_ec.go) -------------------------------------

    def mount_ec_shards(self, vid: int, collection: str,
                        shard_ids: list[int]) -> EcVolume:
        """Open an EcVolume over the locally present shard files
        (store_ec.go MountEcShards), closing the one it replaces."""
        with self.lock:
            for loc in self.locations:
                old = loc.ec_volumes.pop(vid, None)
                if old is not None:
                    old.close()
            for loc in self.locations:
                base = os.path.join(
                    loc.directory,
                    (f"{collection}_" if collection else "") + str(vid))
                if any(os.path.exists(base + to_ext(s))
                       for s in (shard_ids or range(32))):
                    ev = EcVolume(loc.directory, vid, collection=collection)
                    loc.ec_volumes[vid] = ev
                    return ev
            raise KeyError(f"no local shards for volume {vid}")

    def unmount_ec_shards(self, vid: int,
                          shard_ids: "list[int] | None" = None) -> None:
        """shard_ids=None unmounts the whole EC volume; an EMPTY list is
        a no-op (the reference servicer loops over req.ShardIds,
        volume_grpc_erasure_coding.go:463-481); a subset drops only
        those shards."""
        if shard_ids is not None and not shard_ids:
            return
        with self.lock:
            for loc in self.locations:
                ev = loc.ec_volumes.get(vid)
                if ev is None:
                    continue
                if shard_ids is None:
                    loc.ec_volumes.pop(vid).close()
                    return
                for sid in shard_ids:
                    shard = ev.shards.pop(int(sid), None)
                    if shard is not None:
                        shard.close()
                if not ev.shards:
                    loc.ec_volumes.pop(vid).close()
                return

    # -- heartbeat (store.go:371 CollectHeartbeat) ------------------------

    def collect_heartbeat(self) -> dict:
        volumes = []
        ec_shards = []
        max_volume_count = 0
        max_file_key = 0
        with self.lock:
            for loc in self.locations:
                max_volume_count += loc.max_volume_count
                for vid, v in loc.volumes.items():
                    max_file_key = max(max_file_key, v.max_file_key())
                    volumes.append({
                        "id": vid,
                        "collection": v.collection,
                        "size": v.dat_size(),
                        "fileCount": v.file_count(),
                        "deleteCount": v.deleted_count(),
                        "deletedByteCount": v.deleted_bytes(),
                        "readOnly": v.read_only,
                        "replicaPlacement":
                            v.super_block.replica_placement.byte(),
                        "ttl": v.super_block.ttl.to_u32(),
                        "version": v.version,
                        # no remote tiers in the port
                        "remoteTiered": False,
                    })
                for vid, ev in loc.ec_volumes.items():
                    ec_shards.append({
                        "id": vid,
                        "collection": ev.collection,
                        "ecIndexBits": sum(1 << s for s in ev.shard_ids),
                        "dataShards": ev.ctx.data_shards,
                        "parityShards": ev.ctx.parity_shards,
                    })
        return {
            "ip": self.ip,
            "port": self.port,
            "publicUrl": self.public_url,
            "maxVolumeCount": max_volume_count,
            "maxFileKey": max_file_key,
            "volumes": volumes,
            "ecShards": ec_shards,
        }

    def close(self) -> None:
        for loc in self.locations:
            for v in loc.volumes.values():
                v.close()
            for ev in loc.ec_volumes.values():
                ev.close()
