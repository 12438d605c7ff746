"""The native read plane (`native/read_plane.cc`), the port's copy of
`seaweedfs_tpu/server/read_plane.py`: a C++ epoll loop that answers
`GET /<vid>,<fid>` with sendfile(2) from the `.dat`, no Python on the
request's path.

Only plain needles are registered (no compression, no name, mime or
pairs, no TTL, not a chunk manifest): the plane serves raw payload bytes
with octet-stream headers, so a needle whose HTTP answer needs Python
stays unregistered and the plane answers 404; the client falls back to
the server's HTTP port.  The volume server registers a needle from the
record its index points at now (`plain_record`): after the write
plane's drain, after a Python write or delete of the key and before its
answer (which drops the entry when the record is gone or not plain),
and on a read through Python; a volume dropped whole (unmount, delete,
EC conversion) registers again as it is read.

The plane keeps a ring of per-request records that overwrites its oldest
entry; the port has no flight recorder to feed, so the ring is left
undrained (ROADMAP A), which never blocks a request.
"""

from __future__ import annotations

import ctypes
import os
import struct

from .. import native
from ..storage import types
from ..storage.needle import Needle

# byte offset of the data payload inside a needle record: the header
# (cookie 4 + id 8 + size 4) and the DataSize field (4)
DATA_OFFSET_IN_RECORD = types.NEEDLE_HEADER_SIZE + 4


def needle_is_plain(n) -> bool:
    """True when raw payload bytes with octet-stream headers are the
    needle's whole HTTP answer."""
    return not (n.is_compressed() or n.is_chunked_manifest() or
                n.has_ttl() or n.has_name() or n.has_mime() or
                n.has_pairs())


def plain_record(fd: int, offset: int) -> "tuple[int, int] | None":
    """(cookie, data length) of the v2/v3 record at `offset` in the `.dat`
    open as `fd`, read with pread(2) (its header, DataSize and flags
    byte), or None when the record has no data or is not plain."""
    head = os.pread(fd, DATA_OFFSET_IN_RECORD, offset)
    if len(head) < DATA_OFFSET_IN_RECORD:
        return None
    cookie, _, size, data_len = struct.unpack(">IQiI", head)
    if size <= 0 or data_len == 0:
        return None
    flags = os.pread(fd, 1, offset + DATA_OFFSET_IN_RECORD + data_len)
    if len(flags) < 1 or not needle_is_plain(Needle(flags=flags[0])):
        return None
    return cookie, data_len


class ReadPlane:
    """One native read-plane server bound to <host>:<ephemeral>."""

    def __init__(self, host: str = "127.0.0.1"):
        self._lib = native.load_read_plane()
        if self._lib is None:
            raise RuntimeError(
                "native read plane unavailable: "
                f"{native.BUILD_INFO['read_plane'].get('error')}")
        port = ctypes.c_int(0)
        self._h = self._lib.rp_start(host.encode(), 0, ctypes.byref(port))
        if self._h < 0:
            raise RuntimeError("read plane failed to start")
        self.host = host
        self.port = port.value

    # -- the index (kept by the volume server) ---------------------------

    def add_volume(self, vid: int, dat_path: str) -> bool:
        return self._lib.rp_add_volume(self._h, vid,
                                       dat_path.encode()) == 0

    def remove_volume(self, vid: int) -> None:
        self._lib.rp_remove_volume(self._h, vid)

    def register_raw(self, vid: int, needle_id: int, cookie: int,
                     data_off: int, data_len: int) -> None:
        """Register a needle's data at `data_off` (absolute, in the
        `.dat`); its writer's write(2) made the bytes visible to this
        plane's fd."""
        self._lib.rp_put(self._h, vid, needle_id, cookie, data_off,
                         data_len)

    def delete_needle(self, vid: int, needle_id: int) -> None:
        self._lib.rp_del(self._h, vid, needle_id)

    def served(self) -> int:
        return self._lib.rp_served(self._h)

    def stop(self) -> None:
        if self._h >= 0:
            self._lib.rp_stop(self._h)
            self._h = -1
