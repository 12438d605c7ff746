"""Filer entry model (weed/filer/entry.go, filechunks.go), the port's
copy of `seaweedfs_tpu/filer/entry.py`: `to_json` and `from_json` are
byte for byte the same, so stores and listings compare across packages.

An Entry is a directory or a file; files carry an ordered chunk list
[{file_id, offset, size, e_tag, mtime_ns}] over the volume store.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class FileChunk:
    file_id: str
    offset: int
    size: int
    e_tag: str = ""
    mtime_ns: int = 0

    def to_json(self) -> dict:
        return {"fileId": self.file_id, "offset": self.offset,
                "size": self.size, "eTag": self.e_tag,
                "mtime": self.mtime_ns}

    @classmethod
    def from_json(cls, d: dict) -> "FileChunk":
        return cls(d["fileId"], int(d.get("offset", 0)),
                   int(d.get("size", 0)), d.get("eTag", ""),
                   int(d.get("mtime", 0)))


@dataclass
class Attributes:
    mtime: float = field(default_factory=time.time)
    crtime: float = field(default_factory=time.time)
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    symlink_target: str = ""

    def to_json(self) -> dict:
        return {"mtime": self.mtime, "crtime": self.crtime,
                "mode": self.mode, "uid": self.uid, "gid": self.gid,
                "mime": self.mime, "ttlSec": self.ttl_sec,
                "symlinkTarget": self.symlink_target}

    @classmethod
    def from_json(cls, d: dict) -> "Attributes":
        return cls(d.get("mtime", 0), d.get("crtime", 0),
                   d.get("mode", 0o660), d.get("uid", 0),
                   d.get("gid", 0), d.get("mime", ""),
                   d.get("ttlSec", 0), d.get("symlinkTarget", ""))


@dataclass
class Entry:
    full_path: str                      # canonical, starts with /
    is_directory: bool = False
    attributes: Attributes = field(default_factory=Attributes)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict = field(default_factory=dict)  # user metadata

    @property
    def name(self) -> str:
        return self.full_path.rsplit("/", 1)[-1]

    @property
    def parent(self) -> str:
        p = self.full_path.rsplit("/", 1)[0]
        return p or "/"

    def total_size(self) -> int:
        """filer/entry.go Size: max over chunk extents."""
        return max((c.offset + c.size for c in self.chunks), default=0)

    def to_json(self) -> dict:
        return {
            "fullPath": self.full_path,
            "isDirectory": self.is_directory,
            "attributes": self.attributes.to_json(),
            "chunks": [c.to_json() for c in self.chunks],
            "extended": self.extended,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Entry":
        return cls(
            full_path=d["fullPath"],
            is_directory=d.get("isDirectory", False),
            attributes=Attributes.from_json(d.get("attributes", {})),
            chunks=[FileChunk.from_json(c)
                    for c in d.get("chunks", [])],
            extended=d.get("extended", {}),
        )

    def clone(self) -> "Entry":
        """Deep-enough copy for the metadata cache: callers mutate
        attributes, the chunk list AND individual FileChunks in place
        (update_attrs / append_chunks / _clip_chunks), so every
        mutable layer is copied — a cached entry must never alias one
        a handler is editing."""
        import copy as _copy
        return Entry(
            full_path=self.full_path,
            is_directory=self.is_directory,
            attributes=_copy.copy(self.attributes),
            chunks=[_copy.copy(c) for c in self.chunks],
            extended=dict(self.extended),
        )


def normalize_path(path: str) -> str:
    """Canonical /a/b/c (no trailing slash except root)."""
    if not path.startswith("/"):
        path = "/" + path
    while "//" in path:
        path = path.replace("//", "/")
    if len(path) > 1 and path.endswith("/"):
        path = path[:-1]
    return path
