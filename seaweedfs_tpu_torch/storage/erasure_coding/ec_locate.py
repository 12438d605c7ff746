"""EC striping geometry: map logical .dat ranges to (shard, offset)
intervals (weed/storage/erasure_coding/ec_locate.go), a copy of
`seaweedfs_tpu/storage/erasure_coding/ec_locate.py`.

A volume byte-stream lays out row-major: N large rows of
data_shards x 1GB blocks, then small rows of data_shards x 1MB blocks.
Every read resolves through this pure interval math.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Interval:
    block_index: int          # index within large-blocks or small-blocks
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int

    def to_shard_id_and_offset(self, large_block_size: int,
                               small_block_size: int,
                               data_shards: int) -> tuple[int, int]:
        """ec_locate.go:88 ToShardIdAndOffset."""
        offset = self.inner_block_offset
        row_index = self.block_index // data_shards
        if self.is_large_block:
            offset += row_index * large_block_size
        else:
            offset += (self.large_block_rows_count * large_block_size +
                       row_index * small_block_size)
        return self.block_index % data_shards, offset


def locate_data(large_block_size: int, small_block_size: int,
                shard_dat_size: int, offset: int, size: int,
                data_shards: int) -> list[Interval]:
    """ec_locate.go:16 LocateData: intervals covering [offset, offset+size)
    of the logical .dat stream.  shard_dat_size is the per-shard file size
    (used to derive the large-row count)."""
    block_index, is_large, n_large_rows, inner = _locate_offset(
        large_block_size, small_block_size, shard_dat_size, offset,
        data_shards)
    intervals: list[Interval] = []
    while size > 0:
        block_len = large_block_size if is_large else small_block_size
        remaining = block_len - inner
        if remaining <= 0:
            block_index, is_large = _next_block(
                block_index, is_large, n_large_rows, data_shards)
            inner = 0
            continue
        take = min(size, remaining)
        intervals.append(Interval(block_index, inner, take, is_large,
                                  n_large_rows))
        size -= take
        if size <= 0:
            break
        block_index, is_large = _next_block(
            block_index, is_large, n_large_rows, data_shards)
        inner = 0
    return intervals


def _next_block(block_index: int, is_large: bool, n_large_rows: int,
                data_shards: int) -> tuple[int, bool]:
    nxt = block_index + 1
    if is_large and nxt == n_large_rows * data_shards:
        return 0, False
    return nxt, is_large


def _locate_offset(large_block_size: int, small_block_size: int,
                   shard_dat_size: int, offset: int,
                   data_shards: int) -> tuple[int, bool, int, int]:
    large_row_size = large_block_size * data_shards
    n_large_rows = shard_dat_size // large_block_size
    if offset < n_large_rows * large_row_size:
        return (offset // large_block_size, True, n_large_rows,
                offset % large_block_size)
    offset -= n_large_rows * large_row_size
    return (offset // small_block_size, False, n_large_rows,
            offset % small_block_size)
