"""Core storage types and on-disk scalar encodings.

Mirrors weed/storage/types/needle_types.go and offset_4bytes.go: all
integers are BIG-endian on disk (weed/util/bytes.go:34-74); offsets are
stored divided by the 8-byte needle padding, giving 32GB max volume size
with 4-byte offsets (offset_4bytes.go:14-16).
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass

# --- sizes (needle_types.go:52-61) -------------------------------------
COOKIE_SIZE = 4
NEEDLE_ID_SIZE = 8
SIZE_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
DATA_SIZE_SIZE = 4
OFFSET_SIZE = 4
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
NEEDLE_CHECKSUM_SIZE = 4

TOMBSTONE_FILE_SIZE = -1  # Size(-1), needle_types.go:59

# 4-byte offsets x 8-byte padding = 32GB (offset_4bytes.go:14-16)
MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8

# --- volume versions (needle/volume_version.go) ------------------------
VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3


# --- Size semantics (needle_types.go:17-46) ----------------------------

def size_is_tombstone(size: int) -> bool:
    return size == TOMBSTONE_FILE_SIZE


def size_is_deleted(size: int) -> bool:
    """Negative or tombstone == deleted; 0 is anomalous-but-active."""
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


def size_raw(size: int) -> int:
    if size == TOMBSTONE_FILE_SIZE:
        return 0
    return -size if size < 0 else size


def size_to_u32(size: int) -> int:
    """Size is an int32 stored as uint32 on disk."""
    return size & 0xFFFFFFFF


def u32_to_size(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


# --- offset encoding (offset_4bytes.go) --------------------------------

def to_stored_offset(actual_offset: int) -> int:
    """Byte offset -> stored unit (divided by padding)."""
    return actual_offset // NEEDLE_PADDING_SIZE


def to_actual_offset(stored_offset: int) -> int:
    return stored_offset * NEEDLE_PADDING_SIZE


# --- file ids (needle/file_id.go, needle.go:153) -----------------------

@dataclass(frozen=True)
class FileId:
    """volumeId,needleId+cookie — e.g. "3,01637037d6"."""

    volume_id: int
    key: int
    cookie: int

    def __str__(self) -> str:
        return f"{self.volume_id},{format_needle_id_cookie(self.key, self.cookie)}"


def format_needle_id_cookie(key: int, cookie: int) -> str:
    """Hex needle id (leading zero bytes dropped) + 8-hex-digit cookie
    (needle/file_id.go formatNeedleIdCookie)."""
    kb = struct.pack(">Q", key).lstrip(b"\x00") or b""
    return kb.hex() + struct.pack(">I", cookie).hex()


def parse_needle_id_cookie(s: str) -> tuple[int, int]:
    """Parse "<hexkey><8-hex cookie>" (needle/needle.go:153
    ParseNeedleIdCookie)."""
    if len(s) <= 8:
        raise ValueError(f"key-cookie string too short: {s!r}")
    if len(s) % 2 == 1:
        s = "0" + s
    key = int(s[:-8], 16)
    cookie = int(s[-8:], 16)
    return key, cookie


def parse_file_id(fid: str) -> FileId:
    """Parse "vid,keycookie" (split at first ','; file_id.go
    ParseFileIdFromString)."""
    comma = fid.find(",")
    if comma <= 0:
        raise ValueError(f"invalid file id {fid!r}")
    vid = int(fid[:comma])
    key, cookie = parse_needle_id_cookie(fid[comma + 1:])
    return FileId(vid, key, cookie)


# --- request fields that name files (security.go check_path_fields) ----

_SAFE_EXT = re.compile(r"^\.(dat|idx|vif|ecx|ecj|ec\d{2})$")
_SAFE_COLLECTION = re.compile(r"^[A-Za-z0-9_.-]*$")


def check_path_fields(collection: str, ext: str | None = None) -> None:
    """Both fields land in file paths on volume servers: reject
    traversal before any path is built (the volume admin routes and the
    master's assign and grow)."""
    if ext is not None and not _SAFE_EXT.match(ext):
        raise ValueError(f"unacceptable ext {ext!r}")
    if not _SAFE_COLLECTION.match(collection):
        raise ValueError(f"unacceptable collection {collection!r}")
