"""Chunk visibility resolution (weed/filer/filechunks.go), the port's
copy of `seaweedfs_tpu/filer/filechunks.py`.

Chunks may overlap after overwrites; later-written chunks win.  The
visible-interval sweep mirrors ReadResolvedChunks/NonOverlappingVisible-
Intervals: order by (mtime, appearance), overlay onto an interval list,
then produce ChunkViews for any requested [offset, offset+size) range.
"""

from __future__ import annotations

from dataclasses import dataclass

from .entry import FileChunk


@dataclass
class ChunkView:
    file_id: str
    chunk_offset: int   # offset inside the stored chunk blob
    size: int
    logical_offset: int  # offset in the file
    chunk_size: int = 0  # FULL size of the stored chunk blob (the
    #                      filer's chunk cache keys whole bodies by
    #                      fid, so a partial view must know whether
    #                      caching the whole blob is worth it)


@dataclass
class _Visible:
    start: int
    stop: int
    file_id: str
    chunk_start: int  # file-logical offset where this chunk begins
    chunk_size: int = 0


def non_overlapping_visible_intervals(chunks: list[FileChunk]
                                      ) -> list[_Visible]:
    visibles: list[_Visible] = []
    ordered = sorted(enumerate(chunks),
                     key=lambda t: (t[1].mtime_ns, t[0]))
    for _, c in ordered:
        new = _Visible(c.offset, c.offset + c.size, c.file_id,
                       c.offset, c.size)
        out: list[_Visible] = []
        for v in visibles:
            if v.stop <= new.start or v.start >= new.stop:
                out.append(v)
                continue
            if v.start < new.start:
                out.append(_Visible(v.start, new.start, v.file_id,
                                    v.chunk_start, v.chunk_size))
            if v.stop > new.stop:
                out.append(_Visible(new.stop, v.stop, v.file_id,
                                    v.chunk_start, v.chunk_size))
        out.append(new)
        out.sort(key=lambda v: v.start)
        visibles = out
    return visibles


def view_from_chunks(chunks: list[FileChunk], offset: int, size: int
                     ) -> list[ChunkView]:
    """ChunkViews covering [offset, offset+size); gaps are skipped (the
    reader zero-fills them)."""
    views: list[ChunkView] = []
    stop = offset + size
    for v in non_overlapping_visible_intervals(chunks):
        lo = max(offset, v.start)
        hi = min(stop, v.stop)
        if lo >= hi:
            continue
        views.append(ChunkView(
            file_id=v.file_id,
            chunk_offset=lo - v.chunk_start,
            size=hi - lo,
            logical_offset=lo,
            chunk_size=v.chunk_size))
    return views


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)
