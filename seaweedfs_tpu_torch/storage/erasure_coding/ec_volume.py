"""Mounted EC volume (weed/storage/erasure_coding/ec_volume.go,
ec_shard.go): the part of `seaweedfs_tpu/storage/erasure_coding/
ec_volume.py` that the EC admin routes use — the locally present shard
files of one volume, their size, and destroy.  It holds no open file,
so unmounting is forgetting.  Needle lookup through `.ecx`, `.ecj`
deletes and scrub come with degraded reads.
"""

from __future__ import annotations

import os
import threading

from ..volume_info import maybe_load_volume_info
from .ec_context import DATA_SHARDS_COUNT, PARITY_SHARDS_COUNT, ECContext


class EcVolumeShard:
    """One local .ecNN shard file (ec_shard.go).  Shard files are
    immutable once written, so readers open private handles on
    `path`."""

    def __init__(self, shard_id: int, path: str):
        self.shard_id = shard_id
        self.path = path
        self.size = os.path.getsize(path)


class EcVolume:
    """ec_volume.go:26 EcVolume: a volume mounted as the EC shards this
    node holds.  The scheme comes from `.vif` (RS(10,4) without one)."""

    def __init__(self, directory: str, volume_id: int, collection: str = "",
                 ctx: ECContext | None = None,
                 index_directory: str | None = None):
        self.dir = directory
        self.index_dir = index_directory or directory
        self.id = volume_id
        self.collection = collection
        self.shards: dict[int, EcVolumeShard] = {}
        self.lock = threading.RLock()
        base = self.base_file_name()
        vi = maybe_load_volume_info(self.index_base_file_name() + ".vif") \
            or maybe_load_volume_info(base + ".vif")
        if ctx is None:
            if vi is not None and vi.ec_shard_config is not None and \
                    vi.ec_shard_config.data_shards:
                ctx = ECContext(vi.ec_shard_config.data_shards,
                                vi.ec_shard_config.parity_shards,
                                collection, volume_id)
            else:
                ctx = ECContext(DATA_SHARDS_COUNT, PARITY_SHARDS_COUNT,
                                collection, volume_id)
        self.ctx = ctx
        self.dat_file_size = vi.dat_file_size if vi else 0
        for sid in range(ctx.total):
            p = base + ctx.to_ext(sid)
            if os.path.exists(p):
                self.shards[sid] = EcVolumeShard(sid, p)

    # -- naming ----------------------------------------------------------

    def _name(self, d: str) -> str:
        name = f"{self.id}"
        if self.collection:
            name = f"{self.collection}_{name}"
        return os.path.join(d, name)

    def base_file_name(self) -> str:
        return self._name(self.dir)

    def index_base_file_name(self) -> str:
        return self._name(self.index_dir)

    @property
    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    def shard_size(self) -> int:
        for s in self.shards.values():
            return s.size
        return 0

    # -- lifecycle -------------------------------------------------------

    def destroy(self) -> None:
        base = self.base_file_name()
        for sid in range(self.ctx.total):
            try:
                os.remove(base + self.ctx.to_ext(sid))
            except FileNotFoundError:
                pass
        for ext in (".ecx", ".ecj", ".vif"):
            try:
                os.remove(self.index_base_file_name() + ext)
            except FileNotFoundError:
                pass
