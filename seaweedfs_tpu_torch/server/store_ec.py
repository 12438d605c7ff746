"""EC read path with remote shards and degraded reads that rebuild lost
intervals on the fly (weed/storage/store_ec.go:141-443), the port of
`seaweedfs_tpu/server/store_ec.py`.

Resolution order per interval (store_ec.go:207 readOneEcShardInterval):
local shard -> remote shard (locations cached from the master with
tiered TTL freshness, :248 cachedLookupEcShardLocations) -> reconstruct
from >= data_shards surviving shards (:366
recoverOneRemoteEcShardInterval).  Reconstruction runs on the host CPU
codec (`ops/rs_cpu.ReedSolomonCPU`), as the reference's does: a
single-needle read is bound by its latency, so the card's batched kernel
stays with bulk encode and rebuild.  The codec does not depend on
whether a card is present.

The reference's request deadlines and flight-recorder notes are not
ported (ROADMAP C): a read waits out each hop's own timeout.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import stats
from ..ops import rs_cpu, rs_matrix
from ..storage.erasure_coding.ec_volume import EcVolume, NotFoundError
from ..storage.erasure_coding.ec_context import (LARGE_BLOCK_SIZE,
                                                 SMALL_BLOCK_SIZE)
from ..storage.erasure_coding.shard_source import (
    LocalShardSource, MultiSourceFetcher, RemoteShardSource)
from ..storage.needle import Needle
from ..util import retry
from .httpd import http_bytes

# tiered freshness (store_ec.go:248): incomplete -> 11s, full -> 37min,
# enough-to-read -> 7min
_TTL_INCOMPLETE = 11.0
_TTL_FULL = 37 * 60.0
_TTL_ENOUGH = 7 * 60.0

# degraded-read latency histogram: loopback slice decode sits well
# under DEFAULT_BUCKETS' floor, WAN survivor fan-outs above it
_DEGRADED_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _degraded_enabled() -> bool:
    """``SEAWEEDFS_TPU_EC_DEGRADED_READS`` kill switch (default on):
    an operator riding out a cascading failure can turn the d-way
    survivor fan-outs into fast 404s instead of amplifying load."""
    return os.environ.get("SEAWEEDFS_TPU_EC_DEGRADED_READS",
                          "1") not in ("0", "false")


def _degraded_stream_bytes() -> int:
    """Window size for the STREAMED degraded path; intervals at or
    under one window keep the one-shot latency shape
    (``SEAWEEDFS_TPU_DEGRADED_SLICE_MB``, default 1)."""
    try:
        mb = float(os.environ.get("SEAWEEDFS_TPU_DEGRADED_SLICE_MB",
                                  "") or 1.0)
    except ValueError:
        mb = 1.0
    return max(int(mb * (1 << 20)), 4 << 10)


# the `refreshed` stamp of locations never looked up, or expired by a
# failed read: older than every TTL on any host (a stamp of 0.0 is not,
# on a host up for less than the TTL: `time.monotonic` counts from boot)
_EXPIRED = float("-inf")


class _ShardLocationCache:
    def __init__(self):
        self.locations: dict[int, list[str]] = {}
        self.refreshed = _EXPIRED
        self.lock = threading.Lock()


class EcReader:
    """Serves needle reads over an EcVolume whose shards may live on
    other servers; owned by the volume server (`master` is its master,
    `self_url` its own address, never read from remotely)."""

    def __init__(self, master: str, self_url: str):
        self.master = master
        self.self_url = self_url
        self._caches: dict[int, _ShardLocationCache] = {}
        self._codecs: dict[tuple[int, int], rs_cpu.ReedSolomonCPU] = {}
        self._pool = ThreadPoolExecutor(max_workers=14)

    # -- public -----------------------------------------------------------

    def read_needle(self, ev: EcVolume, needle_id: int,
                    cookie: int | None = None) -> Needle:
        """store_ec.go:141 ReadEcShardNeedle: the local read path with
        this reader's remote/reconstruct interval resolution.  The
        returned needle is tagged `was_degraded` when any interval was
        reconstructed."""
        degraded = [False]
        n = ev.read_needle_with(
            lambda iv: self._read_interval(ev, iv, degraded),
            needle_id, cookie=cookie)
        n.was_degraded = degraded[0]
        return n

    # -- interval resolution ---------------------------------------------

    def _read_interval(self, ev: EcVolume, iv,
                       degraded: "list | None" = None) -> bytes:
        sid, off = iv.to_shard_id_and_offset(
            LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, ev.ctx.data_shards)
        # 1. local
        shard = ev.shards.get(sid)
        if shard is not None:
            return shard.read_at(off, iv.size)
        # 2. remote direct
        locs = self._shard_locations(ev)
        for url in locs.get(sid, []):
            data = self._remote_read(url, ev.id, sid, off, iv.size)
            if data is not None:
                return data
        # 3. reconstruct from survivors: the DEGRADED read, counted (the
        # SLO difference between "one dead peer" and "every read pays a
        # d-way fan-out" lives in this counter)
        if not _degraded_enabled():
            raise NotFoundError(
                f"volume {ev.id}: shard {sid} unreachable and degraded "
                f"reads are disabled")
        if degraded is not None:
            degraded[0] = True
        stats.PROCESS.counter_add(
            "ec_degraded_reads_total", 1.0,
            help_text="needle reads served by interval reconstruction "
                      "instead of a direct shard read", vid=ev.id)
        t0 = time.perf_counter()
        try:
            step = _degraded_stream_bytes()
            if iv.size > step:
                # large interval: decode-on-read in slice windows, the
                # survivor fetch overlapping the matrix apply; nothing
                # is written to disk and memory stays at d x window
                try:
                    return self._recover_interval_streamed(
                        ev, sid, off, iv.size, locs, step)
                except (OSError, ValueError, KeyError):
                    # a survivor died mid-stream past its own failover:
                    # the one-shot path below re-plans from everything
                    # reachable rather than failing the read
                    pass
            return self._recover_interval(ev, sid, off, iv.size)
        finally:
            stats.PROCESS.histogram_observe(
                "ec_degraded_read_seconds",
                time.perf_counter() - t0, buckets=_DEGRADED_BUCKETS,
                help_text="wall time of degraded (reconstructing) "
                          "needle interval reads")

    def _remote_read(self, url: str, vid: int, sid: int, offset: int,
                     size: int) -> bytes | None:
        """volume_server.proto:101 VolumeEcShardRead.  Returns None on
        any transport failure: a dead shard server degrades to
        reconstruction, never to a 500 (store_ec.go falls through).
        A peer whose breaker is open is skipped without a timeout, and
        a failure drops the peer from this volume's cached locations and
        expires them, so the next read asks the master again instead of
        retrying the same dead peer until the 37-minute TTL ends."""
        if url == self.self_url:
            return None
        if not retry.peer_available(url):
            self._note_failover(url)
            return None
        try:
            status, body, _ = http_bytes(
                "GET",
                f"{url}/admin/ec/shard_read?volumeId={vid}&shardId={sid}"
                f"&offset={offset}&size={size}", timeout=10.0)
        except OSError:
            self._note_failover(url)
            self._bust_locations(vid, url)
            return None
        if status == 200 and len(body) == size:
            return body
        self._note_failover(url)
        return None

    def _note_failover(self, url: str) -> None:
        stats.PROCESS.counter_add(
            "ec_read_source_failovers_total", 1.0,
            help_text="EC reads that abandoned a shard source "
                      "(transport failure, short body, open breaker)",
            peer=url)

    def _bust_locations(self, vid: int, dead_url: str) -> None:
        """Drop a dead peer from this volume's cached shard locations
        and expire the cache."""
        cache = self._caches.get(vid)
        if cache is None:
            return
        with cache.lock:
            for sid, urls in list(cache.locations.items()):
                if dead_url in urls:
                    cache.locations[sid] = \
                        [u for u in urls if u != dead_url]
            cache.refreshed = _EXPIRED

    def _recover_interval_streamed(self, ev: EcVolume,
                                   missing_sid: int, offset: int,
                                   size: int, locs: dict,
                                   step: int) -> bytes:
        """Streamed decode-on-read for one lost-shard interval: pick d
        survivors (local shards first, remote donors round-robined),
        stream only the requested byte range in slice windows through
        the cached reconstruction matrix, and return the missing
        shard's bytes for that range.  The rebuild's seams
        (`MultiSourceFetcher` prefetch) with the response as the only
        output: no shard file is written."""
        d = ev.ctx.data_shards
        total = ev.ctx.total
        sources: dict[int, object] = {}
        with ev.lock:
            local = {sid: s.path for sid, s in ev.shards.items()}
        try:
            for sid in sorted(local):
                if sid != missing_sid and len(sources) < d:
                    sources[sid] = LocalShardSource(local[sid])
            if len(sources) < d:
                # remote rows round-robined across donors, like the
                # rebuild planner: no single peer's disk serialises the
                # fetch streams
                by_donor: dict[str, list[int]] = {}
                for sid in sorted(locs):
                    if sid == missing_sid or sid in sources or \
                            sid >= total or not locs[sid]:
                        continue
                    by_donor.setdefault(locs[sid][0], []).append(sid)
                tiers = list(by_donor.values())
                i = 0
                while len(sources) < d and any(tiers):
                    tier = tiers[i % len(tiers)]
                    if tier:
                        sid = tier.pop(0)
                        sources[sid] = RemoteShardSource(locs[sid], ev.id,
                                                         sid)
                    i += 1
            if len(sources) < d:
                raise NotFoundError(
                    f"volume {ev.id}: only {len(sources)} shards "
                    f"reachable, need {d} to recover shard "
                    f"{missing_sid}")
            present = tuple(sid in sources for sid in range(total))
            mat, survivor_rows = rs_matrix.cached_reconstruction_matrix(
                d, ev.ctx.parity_shards, present, (missing_sid,))
            used = {sid: sources[sid] for sid in survivor_rows}
            for sid, src in sources.items():
                if sid not in used:
                    src.close()
            sources = used
        except BaseException:
            for src in sources.values():
                src.close()
            raise
        work = [(offset + pos, min(step, size - pos))
                for pos in range(0, size, step)]
        codec = self._codec(d, ev.ctx.parity_shards)
        out = bytearray(size)
        fetcher = MultiSourceFetcher(used, work)
        try:
            buf = None
            for pos, n in work:
                if buf is None or buf.shape != (len(survivor_rows), n):
                    buf = np.empty((len(survivor_rows), n),
                                   dtype=np.uint8)
                filled = fetcher.get(
                    (pos, n),
                    rows={sid: memoryview(buf[row])
                          for row, sid in enumerate(survivor_rows)})
                for row, sid in enumerate(survivor_rows):
                    got = filled[sid]
                    if got < n:
                        buf[row, got:] = 0  # EOF zero-padding
                rec = codec.apply_matrix(mat, buf)
                lo = pos - offset
                out[lo:lo + n] = rec[0, :n].tobytes()
        finally:
            fetcher.close()
        return bytes(out)

    def _recover_interval(self, ev: EcVolume, missing_sid: int,
                          offset: int, size: int) -> bytes:
        """store_ec.go:366: parallel reads of the same range from every
        other shard, then ReconstructData."""
        total = ev.ctx.total
        d = ev.ctx.data_shards
        locs = self._shard_locations(ev, force_if_missing=missing_sid)
        bufs = np.zeros((total, size), dtype=np.uint8)
        present = [False] * total

        def fetch(sid: int):
            if sid == missing_sid:
                return sid, None
            shard = ev.shards.get(sid)
            if shard is not None:
                return sid, shard.read_at(offset, size)
            for url in locs.get(sid, []):
                data = self._remote_read(url, ev.id, sid, offset, size)
                if data is not None:
                    return sid, data
            return sid, None

        for sid, data in self._pool.map(fetch, range(total)):
            if data is not None and len(data) == size:
                bufs[sid] = np.frombuffer(data, dtype=np.uint8)
                present[sid] = True
        if sum(present) < d:
            raise NotFoundError(
                f"volume {ev.id}: only {sum(present)} shards reachable, "
                f"need {d} to recover shard {missing_sid}")
        codec = self._codec(d, ev.ctx.parity_shards)
        # intervals only ever target data shards (block_index %
        # data_shards < d), so ReconstructData semantics apply
        # (store_ec.go:435): missing parity rows are not regenerated
        rec = codec.reconstruct(bufs, present, data_only=True)
        return rec[missing_sid].tobytes()

    # -- shard location cache (store_ec.go:248) ---------------------------

    def _shard_locations(self, ev: EcVolume,
                         force_if_missing: int | None = None
                         ) -> dict[int, list[str]]:
        cache = self._caches.setdefault(ev.id, _ShardLocationCache())
        with cache.lock:
            n = len(cache.locations)
            age = time.monotonic() - cache.refreshed
            fresh = ((n < ev.ctx.data_shards and age < _TTL_INCOMPLETE) or
                     (n == ev.ctx.total and age < _TTL_FULL) or
                     (ev.ctx.data_shards <= n < ev.ctx.total and
                      age < _TTL_ENOUGH))
            if force_if_missing is not None and \
                    force_if_missing not in cache.locations:
                fresh = fresh and age < _TTL_INCOMPLETE
            if not fresh:
                from ..operation import master_json
                try:
                    r = master_json(
                        self.master, "GET",
                        f"/dir/ec_lookup?volumeId={ev.id}", timeout=5.0)
                except OSError:
                    r = {}
                locs: dict[int, list[str]] = {}
                for entry in r.get("shardIdLocations", []):
                    for sid in entry["shardIds"]:
                        locs.setdefault(sid, []).append(entry["url"])
                if locs:
                    cache.locations = locs
                    cache.refreshed = time.monotonic()
            return dict(cache.locations)

    def _codec(self, d: int, p: int) -> rs_cpu.ReedSolomonCPU:
        key = (d, p)
        if key not in self._codecs:
            self._codecs[key] = rs_cpu.ReedSolomonCPU(d, p)
        return self._codecs[key]

    def forget(self, vid: int) -> None:
        """Drop the cached shard locations of volume vid (after an
        unmount, a shard delete or a decode, or when shards came back)."""
        self._caches.pop(vid, None)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
