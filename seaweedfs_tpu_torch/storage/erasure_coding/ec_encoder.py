"""EC encode/rebuild file pipeline
(weed/storage/erasure_coding/ec_encoder.go).

`.dat` -> `.ec00..ecNN`: the volume stream is striped into rows of
data_shards blocks (1GB rows first, then 1MB rows for the tail, zero-
padded past EOF), parity blocks are computed per row, and each block is
appended to its shard file.  The file geometry is identical to the
reference for ANY batch size that divides the block size; the codec
takes 64MB batches per shard row, one device launch each, and the
outputs are byte-identical.

Rebuild regenerates missing shards from >= data_shards survivors
(ec_encoder.go:323 rebuildEcFiles) through the same staged pipeline.

The block sizes are read from this module's globals at call time, so
tests can shrink them.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ... import tracing
from .. import idx as idxmod
from ..volume_info import (EcShardConfig, VolumeInfo,
                           maybe_load_volume_info, save_volume_info)
from .ec_context import (ECContext, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE,
                         to_ext)  # noqa: F401  (re-exported)


# --- .ecx generation ----------------------------------------------------

def write_sorted_file_from_idx(base_file_name: str, ext: str = ".ecx"
                               ) -> None:
    """Generate the sorted needle index (ec_encoder.go:31
    WriteSortedFileFromIdx): replay .idx with memdb semantics — a delete
    removes the key entirely, so pre-encode deletes never appear in
    .ecx — then write live entries ascending by key."""
    with open(base_file_name + ".idx", "rb") as f:
        live = idxmod.live_entries(f.read())
    entries = sorted(live.items())
    with open(base_file_name + ext, "wb") as out:
        if entries:
            keys = [k for k, _ in entries]
            offs = [o for _, (o, _) in entries]
            sizes = [s for _, (_, s) in entries]
            out.write(idxmod.pack_index(keys, offs, sizes))


# --- encode -------------------------------------------------------------

def write_ec_files(base_file_name: str, ctx: ECContext | None = None
                   ) -> None:
    """ec_encoder.go:61 WriteEcFiles / :67 WriteEcFilesWithContext."""
    ctx = ctx or ECContext()
    _generate_ec_files(base_file_name, ctx)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _encode_work_items(dat_size: int, ctx: ECContext
                       ) -> "list[tuple[int, int, int, int, int]]":
    """The batch schedule of ec_encoder.go:280 encodeDatFile (1GB rows,
    then 1MB rows for the tail) as a flat work list of
    (row_start, block_size, batch_offset, batch_bytes, real_rows):

    - large rows (1GB blocks) are chunked WITHIN a block: one item per
      (row, batch-offset), real_rows == 1, and the reader gathers the
      d strided block slices at batch_offset;
    - small rows (1MB blocks) are AGGREGATED: one item covers
      real_rows consecutive rows read contiguously and stacked on the
      batch axis (batch_bytes = padded_rows * block_size per shard),
      padded up to a power-of-two row count so the volume launches a
      handful of shapes; the writer emits only real_rows * block_size
      bytes per shard.

    Either way shard i's file is the in-order concatenation of row
    blocks i, byte-identical to the reference."""
    work = []
    large_row = LARGE_BLOCK_SIZE * ctx.data_shards
    small_row = SMALL_BLOCK_SIZE * ctx.data_shards
    remaining = dat_size
    processed = 0
    while remaining >= large_row:
        batch = ctx.batch_size(LARGE_BLOCK_SIZE)
        for b0 in range(0, LARGE_BLOCK_SIZE, batch):
            work.append((processed, LARGE_BLOCK_SIZE, b0, batch, 1))
        remaining -= large_row
        processed += large_row
    rows_left = (remaining + small_row - 1) // small_row
    r_full = ctx.rows_per_launch(SMALL_BLOCK_SIZE)
    while rows_left > 0:
        g = min(r_full, rows_left)
        padded = min(r_full, _next_pow2(g))
        work.append((processed, SMALL_BLOCK_SIZE, 0,
                     padded * SMALL_BLOCK_SIZE, g))
        rows_left -= g
        processed += g * small_row
    return work


class _Stopped(Exception):
    """Internal: a pipeline stage was asked to abort."""


class _StageTimer:
    """Wraps one pipeline-stage callback to measure its window: wall
    start of the first call, end of the last call, and cumulative busy
    seconds.  The three stage windows overlap by design (the triple
    buffer); emitted as sibling trace spans they show that overlap."""

    def __init__(self, fn):
        self._fn = fn
        # forwarded so _staged_run still sees a lazy-capable writer
        # through the wrap
        self.accepts_lazy = getattr(fn, "accepts_lazy", False)
        self.start_wall = 0.0
        self.first = 0.0
        self.last = 0.0
        self.busy = 0.0
        self.calls = 0

    def __call__(self, *args):
        t0 = time.perf_counter()
        if not self.calls:
            self.first = t0
            self.start_wall = time.time()
        try:
            return self._fn(*args)
        finally:
            t1 = time.perf_counter()
            self.busy += t1 - t0
            self.last = t1
            self.calls += 1

    def emit(self, name: str, trace_ctx, **attrs) -> None:
        """Record the stage window as a span parented to the span that
        was active when the pipeline started (`trace_ctx` from
        tracing.current_ids(): the stages ran on other threads, where
        the contextvar does not follow)."""
        if not self.calls:
            return
        attrs.update(busySeconds=round(self.busy, 6), calls=self.calls)
        tracing.emit_span(
            name, self.start_wall, self.last - self.first,
            role=trace_ctx[2] if trace_ctx else "",
            parent=trace_ctx[1] if trace_ctx else "",
            trace_id=trace_ctx[0] if trace_ctx else "",
            attrs=attrs)


class _OverlappedFlusher:
    """Background thread that round-robins flush+fdatasync over the
    output files while the pipeline runs, so flushing overlaps reads and
    compute instead of serializing after them.  Flush errors are latched
    and re-raised by stop(): a failing disk must fail the encode."""

    def __init__(self, files, interval: float = 0.05):
        import threading
        self._files = list(files)
        self._interval = interval
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.wait(self._interval):
            for f in self._files:
                if self._stop.is_set():
                    return
                try:
                    f.flush()
                    os.fdatasync(f.fileno())
                except ValueError:  # closed under us at teardown
                    return
                except OSError as e:
                    self._error = e
                    return

    def stop(self, final: bool = True):
        """Join the flusher; when `final`, leave every file durably
        flushed and raise the first flush error, if any.  With
        final=False (pipeline already failing) latched errors are
        dropped so this never masks the caller's original exception."""
        self._stop.set()
        self._t.join()
        if not final:
            return
        if self._error is not None:
            raise self._error
        for f in self._files:
            f.flush()
            os.fdatasync(f.fileno())


def _staged_run(work, read_item, compute, write_item) -> None:
    """Triple-buffered staging pipeline, shared by encode and rebuild: a
    reader thread stages disk batches into host buffers, the calling
    thread launches the codec, and a writer thread appends to the shard
    files — so disk reads, the codec and disk writes overlap.

    read_item(item, buf) -> payload: fill (or replace) the recycled
    buffer; the payload's FIRST element must be the buffer to recycle.
    compute(payload) -> result: may return a lazy handle exposing
    .materialize(); the writer materializes it before the buffer is
    recycled (the aliasing contract of the codec's *_lazy calls),
    unless write_item.accepts_lazy, in which case write_item takes the
    handle and must drain it before returning.
    write_item(payload, result) -> None: append to the output files.

    Host memory is bounded by a pool of 3 recycled buffers.  A shared
    stop event unblocks every stage on any error or interrupt, so a
    writer failure (ENOSPC) aborts the read and compute stages
    promptly.  Output order is preserved because every stage is FIFO."""
    import queue
    import threading

    q_read: "queue.Queue" = queue.Queue()
    q_write: "queue.Queue" = queue.Queue()
    pool: "queue.Queue" = queue.Queue()
    for _ in range(3):
        pool.put(None)  # lazy-allocated buffer slots
    stop = threading.Event()
    errors: list[BaseException] = []

    def _blocking(q_op, *args):
        """put/get that stays interruptible by the stop event."""
        while True:
            try:
                return q_op(*args, timeout=0.2)
            except (queue.Full, queue.Empty):
                if stop.is_set():
                    raise _Stopped() from None

    def reader():
        try:
            for item in work:
                buf = _blocking(pool.get)
                _blocking(q_read.put, read_item(item, buf))
        except _Stopped:
            pass
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
            stop.set()
        finally:
            q_read.put(None)

    def writer():
        result = None
        try:
            while True:
                item = _blocking(q_write.get)
                if item is None:
                    return
                payload, result = item
                if hasattr(result, "materialize") and \
                        not getattr(write_item, "accepts_lazy", False):
                    result = result.materialize()
                write_item(payload, result)
                result = None
                pool.put(payload[0])  # recycle the slot for the reader
        except _Stopped:
            pass
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            stop.set()
            # a launch this writer failed to drain: stop its staging
            # thread now, not when the handle is collected
            if hasattr(result, "abort"):
                result.abort()

    rt = threading.Thread(target=reader, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    rt.start()
    wt.start()
    try:
        while not stop.is_set():
            payload = q_read.get()
            if payload is None:
                break
            q_write.put((payload, compute(payload)))
    except BaseException as e:  # noqa: BLE001 — incl. KeyboardInterrupt
        errors.insert(0, e)
    finally:
        stop.set()  # unblocks any parked stage
        q_write.put(None)
        rt.join()
        wt.join()
        # results still queued were never materialized: release their
        # device launches now
        while True:
            try:
                item = q_write.get_nowait()
            except queue.Empty:
                break
            if item is not None and hasattr(item[1], "abort"):
                item[1].abort()
    if errors:
        raise errors[0]


def _generate_ec_files(base_file_name: str, ctx: ECContext,
                       sinks: "list | None" = None,
                       stats=None) -> None:
    """Staged encode: .dat batches -> GF parity -> d+p shard streams.

    `sinks` (shard_sink.ShardSink, one per shard id) are where the
    writer puts each shard: None means a LocalShardSink per `.ecNN` file
    on this node; scatter-encode passes RemoteShardSink streams to each
    shard's placement target.  On success every sink is finish()ed
    (delivery verified), on failure every sink is abort()ed, so a failed
    encode leaves no partial shard.  Only the local sinks made here are
    committed here: the scatter caller commits after the sidecars have
    landed."""
    from .shard_sink import LocalShardSink, ScatterStats
    dat_path = base_file_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    codec = ctx.create_codec()
    d = ctx.data_shards
    work = _encode_work_items(dat_size, ctx)
    own_sinks = sinks is None
    if stats is None:
        stats = ScatterStats()
    if sinks is None:
        sinks = [LocalShardSink(base_file_name + ctx.to_ext(i), stats=stats)
                 for i in range(ctx.total)]
    for s in sinks:
        if hasattr(s, "set_stats"):
            s.set_stats(stats)
    dat = open(dat_path, "rb")

    def read_item(item, buf):
        row_start, block_size, b0, batch, real_rows = item
        if buf is None or buf.shape != (d, batch):
            buf = np.empty((d, batch), dtype=np.uint8)
        # only short/EOF read tails are zeroed (the reference's zero
        # padding, ec_encoder.go:258-262); rows padded past real_rows
        # are left dirty: the GF apply is column-independent and the
        # writer cuts at `real`
        if batch <= block_size:
            # chunk within one (large) row: gather the d strided block
            # slices at batch offset b0
            for i in range(d):
                dat.seek(row_start + i * block_size + b0)
                got = dat.readinto(memoryview(buf[i])[:batch])
                if got < batch:
                    buf[i, got:] = 0
        else:
            # real_rows stacked small rows: one sequential pass
            dat.seek(row_start)
            for r in range(real_rows):
                base = r * block_size
                for i in range(d):
                    got = dat.readinto(
                        memoryview(buf[i])[base:base + block_size])
                    if got < block_size:
                        buf[i, base + got:base + block_size] = 0
        real = min(batch, real_rows * block_size)
        return (buf, real)

    def compute(payload):
        buf, _real = payload
        return codec.parity_lazy(buf)  # the writer materializes

    def write_item(payload, parity):
        buf, real = payload
        for i in range(d):
            sinks[i].write(buf[i, :real].data)
        if hasattr(parity, "windows"):
            # windowed launch (ops.staging): push each parity window to
            # its sink as it lands, so window k's d2h wait and write
            # overlap the staging of windows k+1, k+2.  Always drain
            # fully: the buffer is recycled when this returns.
            for w0, chunk in parity.windows():
                n = min(chunk.shape[1], real - w0)
                if n <= 0:
                    continue  # device-shape padding beyond `real`
                for j in range(ctx.total - d):
                    sinks[d + j].write(chunk[j, :n].data)
            return
        if hasattr(parity, "materialize"):
            # one-shot launch: accepts_lazy means _staged_run leaves the
            # materialize to this writer
            parity = parity.materialize()
        for j in range(ctx.total - d):
            sinks[d + j].write(parity[j, :real].data)

    write_item.accepts_lazy = True

    # stage spans: capture the caller's span context now (the stages run
    # on pipeline threads, where the contextvar does not follow)
    trace_ctx = tracing.current_ids()
    read_item = _StageTimer(read_item)
    compute = _StageTimer(compute)
    write_item = _StageTimer(write_item)

    flusher = _OverlappedFlusher(
        [s.file for s in sinks if hasattr(s, "file")])
    ok = False
    try:
        _staged_run(work, read_item, compute, write_item)
        for s in sinks:
            s.end_stream()
        for s in sinks:
            s.finish()
        ok = True
    finally:
        dat.close()
        try:
            flusher.stop(final=ok)
        except Exception:
            ok = False
            raise
        finally:
            if not ok:
                for s in sinks:
                    try:
                        s.abort()
                    except OSError:
                        pass
            elif own_sinks:
                for s in sinks:
                    s.commit()
            read_item.emit("encode.read", trace_ctx,
                           datBytes=dat_size, windows=len(work))
            compute.emit("encode.codec", trace_ctx,
                         dataShards=d, parityShards=ctx.total - d,
                         device=ctx.device)
            write_item.emit("encode.write", trace_ctx,
                            bytesByDest=stats.snapshot()[0],
                            aborted=not ok)


# --- rebuild ------------------------------------------------------------

def scheme_from_vif(base_file_name: str, device: str = "cuda"
                    ) -> ECContext | None:
    """Recover the EC scheme persisted to .vif
    (server/volume_grpc_erasure_coding.go:132) as a context on `device`;
    None when absent or recorded without a scheme."""
    vi = maybe_load_volume_info(base_file_name + ".vif")
    if vi is not None and vi.ec_shard_config is not None and \
            vi.ec_shard_config.data_shards:
        return ECContext(vi.ec_shard_config.data_shards,
                         vi.ec_shard_config.parity_shards, device=device)
    return None


def rebuild_ec_files(base_file_name: str, ctx: ECContext | None = None,
                     additional_dirs: list[str] | None = None
                     ) -> list[int]:
    """ec_encoder.go:74 RebuildEcFiles: recover the scheme from .vif
    when no context is given, then regenerate missing shard files from
    survivors.  Returns the generated shard ids."""
    if ctx is None:
        ctx = scheme_from_vif(base_file_name) or ECContext()
    return _generate_missing_ec_files(
        base_file_name, ctx, additional_dirs or [])


def _find_shard_file(base_file_name: str, ext: str,
                     additional_dirs: list[str]) -> str | None:
    """ec_encoder.go:131 findShardFile: primary path, then extra dirs."""
    primary = base_file_name + ext
    if os.path.exists(primary):
        return primary
    base = os.path.basename(base_file_name)
    for d in additional_dirs:
        cand = os.path.join(d, base + ext)
        if os.path.exists(cand):
            return cand
    return None


def discover_shard_files(base_file_name: str, ctx: ECContext,
                         additional_dirs: list[str]
                         ) -> "tuple[dict[int, str], list[int]]":
    """(present shard paths by id, missing shard ids) — the discovery
    half of the two-pass rebuild (ec_encoder.go:146)."""
    present_paths: dict[int, str] = {}
    missing: list[int] = []
    for sid in range(ctx.total):
        p = _find_shard_file(base_file_name, ctx.to_ext(sid),
                             additional_dirs)
        if p is not None:
            present_paths[sid] = p
        else:
            missing.append(sid)
    return present_paths, missing


def _generate_missing_ec_files(base_file_name: str, ctx: ECContext,
                               additional_dirs: list[str]) -> list[int]:
    """Two-pass discover-then-create (ec_encoder.go:146) over local
    files."""
    present_paths, missing = discover_shard_files(
        base_file_name, ctx, additional_dirs)
    if len(present_paths) < ctx.data_shards:
        raise ValueError(
            f"not enough shards to rebuild {base_file_name}: found "
            f"{len(present_paths)}, need {ctx.data_shards}, "
            f"missing {missing}")
    if not missing:
        return []
    from .shard_source import LocalShardSource
    sources = {sid: LocalShardSource(p)
               for sid, p in present_paths.items()}
    return rebuild_from_sources(base_file_name, ctx, sources, missing)


def rebuild_step(shard_size: int, ctx: ECContext,
                 slice_bytes: int | None = None) -> int:
    """Bytes of each shard row per rebuild step.  Without `slice_bytes`
    one device batch; with it, the slice caps the step, and small shards
    get steps of ~1/8 of the shard (at least 1 MiB, or the cap when
    smaller), so the prefetching streams overlap fetch with compute
    instead of degenerating to one or two giant slices."""
    if not slice_bytes:
        return ctx.batch_size(LARGE_BLOCK_SIZE)
    return max(min(slice_bytes, -(-shard_size // 8)),
               min(slice_bytes, 1 << 20))


def rebuild_from_sources(base_file_name: str, ctx: ECContext,
                         sources: dict, missing: list[int],
                         stats=None, slice_bytes: int | None = None,
                         shard_size: int | None = None) -> list[int]:
    """Regenerate `missing` shard files from survivor `sources`
    ({shard_id: ShardSource}) through the staged pipeline: a
    MultiSourceFetcher streams the windows of `rebuild_step` (one
    concurrent stream per prefetching source), the codec applies the
    reconstruction matrix, and the writer appends to the new shard
    files.  Slice boundaries never change output bytes.  `shard_size`,
    when the caller knows it, spares a size lookup per source.  Closes
    every source; a failure leaves no target file behind."""
    from ...ops import rs_matrix
    from .shard_source import MultiSourceFetcher
    outputs: dict = {}
    fetcher = None
    try:
        if len(sources) < ctx.data_shards:
            raise ValueError(
                f"not enough shards to rebuild {base_file_name}: "
                f"found {len(sources)}, need {ctx.data_shards}, "
                f"missing {missing}")
        codec = ctx.create_codec()
        # one matrix maps the first data_shards survivors onto ALL
        # missing rows (data and parity alike): each step is a single
        # [len(missing), d] x [d, batch] apply
        present_mask = tuple(sid in sources
                             for sid in range(ctx.total))
        rec_matrix, survivor_rows = \
            rs_matrix.cached_reconstruction_matrix(
                ctx.data_shards, ctx.parity_shards, present_mask,
                tuple(missing))
        used = {sid: sources[sid] for sid in survivor_rows}
        for sid in sources:
            if sid not in used:  # survivors beyond the first d: unused
                sources[sid].close()
        if shard_size is None:
            shard_size = max(src.size() for src in used.values())
        for sid in missing:
            outputs[sid] = open(base_file_name + ctx.to_ext(sid), "wb")
        step = rebuild_step(shard_size, ctx, slice_bytes)
        work = [(pos, min(step, shard_size - pos))
                for pos in range(0, shard_size, step)]
        d = ctx.data_shards
        fetcher = MultiSourceFetcher(used, work, stats=stats)
    except BaseException:
        # setup failed before the pipeline owned these resources: leak
        # no fds, and leave no empty target file for discovery to take
        # for a survivor
        if fetcher is not None:
            fetcher.close()
        else:
            for src in sources.values():
                src.close()
        for sid, f in outputs.items():
            f.close()
            try:
                os.remove(base_file_name + ctx.to_ext(sid))
            except OSError:
                pass
        raise

    def read_item(item, buf):
        pos, n = item
        if buf is None or buf.shape != (d, n):
            buf = np.empty((d, n), dtype=np.uint8)
        # every source fills its staging row in place; only the short
        # tail of a row is zeroed (EOF zero-padding)
        filled = fetcher.get(
            item, rows={sid: memoryview(buf[row])
                        for row, sid in enumerate(survivor_rows)})
        for row, sid in enumerate(survivor_rows):
            got = filled[sid]
            if got < n:
                buf[row, got:] = 0
        return (buf, n)

    def compute(payload):
        buf, _n = payload
        return codec.apply_matrix_lazy(rec_matrix, buf)

    def write_item(payload, rec):
        _buf, n = payload
        for row, sid in enumerate(missing):
            outputs[sid].write(rec[row, :n].data)

    # stage spans: capture the caller's span context now (the stages run
    # on pipeline threads, where the contextvar does not follow)
    trace_ctx = tracing.current_ids()
    read_item = _StageTimer(read_item)
    compute = _StageTimer(compute)
    write_item = _StageTimer(write_item)

    flusher = _OverlappedFlusher(outputs.values())
    ok = False
    try:
        _staged_run(work, read_item, compute, write_item)
        ok = True
    finally:
        try:
            flusher.stop(final=ok)
        finally:
            fetcher.close()  # joins prefetch threads, closes sources
            for sid, f in outputs.items():
                f.close()
                if not ok:
                    # a truncated .ecNN would be counted as a survivor
                    # by the next rebuild's discovery
                    try:
                        os.remove(base_file_name + ctx.to_ext(sid))
                    except OSError:
                        pass
            by_source = stats.snapshot()[0] if stats is not None \
                else {}
            read_item.emit("rebuild.fetch", trace_ctx,
                           bytesBySource=by_source,
                           windows=len(work), sliceBytes=step)
            compute.emit("rebuild.codec", trace_ctx,
                         missingShards=list(missing),
                         dataShards=ctx.data_shards)
            write_item.emit("rebuild.write", trace_ctx,
                            bytesWritten=len(missing) * shard_size,
                            aborted=not ok)
    return missing


def save_ec_volume_info(base_file_name: str, ctx: ECContext,
                        dat_file_size: int, version: int) -> None:
    """Persist the EC scheme to .vif so rebuild/decode can recover it
    (server/volume_grpc_erasure_coding.go:132)."""
    vi = maybe_load_volume_info(base_file_name + ".vif") or VolumeInfo()
    vi.version = version
    vi.dat_file_size = dat_file_size
    vi.ec_shard_config = EcShardConfig(ctx.data_shards, ctx.parity_shards)
    save_volume_info(base_file_name + ".vif", vi)
