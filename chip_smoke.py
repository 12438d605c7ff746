#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`seaweedfs_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--volume-gib 1.0] [--batch-gib 1.0] [--seed 0]

Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the seconds the kernel build took (the CUDA sources in
   seaweedfs_tpu_torch/csrc are compiled with nvcc at first use).
2. kernel: the CUDA GF(2^8) kernel's two entries against their plain
   PyTorch versions and the numpy twin, bit for bit, at the main paths'
   shapes (one 32 MiB staging window, [4,10] x 838,860 words, with the
   encode matrix and the rebuild matrices of 4, 3, 2 and 1 lost shards;
   the streamed rebuild's [2,10] matrix of shards {1,8} at the window
   and at the step tail of an 8 MiB slice (419,432 words); the 64-volume
   batch step, [64,10] -> [64,4] x 262,144 words; a 64 MiB batch;
   RS(6,3)'s window, [3,6] x 1,398,100 words (32 MiB of input), encode
   and 3- and 2-loss rebuilds, each also through the generic body it
   replaced (`rs_cuda.gf_apply_matrix_words_generic`, equal and timed
   the same ways); and ragged, word-path and generic-body shapes).  Each
   case is timed (CUDA events, median of 10 runs) on the same buffers and
   rotating over enough buffer sets that every launch reads past the
   50 MB L2, beside its bytes bound, a device-to-device copy_ of the same
   bytes, the card's streaming ceiling in this call (`stream_gbps`, a
   copy_ of 512 MiB), the launch's grid (`rs_cuda.launch_plan`) and its
   issue floor: the SASS instructions of the launched template's column
   loop (`cuobjdump -sass`) x columns / (4 x 32 lanes x SMs x the highest
   SM clock nvidia-smi sampled during the phase).  Each case's plain
   version is timed too.
3. ec: the volume-server EC sequence on a volume of seeded needles
   written through the port's Volume (BASELINE.json's "Single 1GB
   volume, RS(10,4)" by default): .ecx, encode, .vif; lose shards
   0, 7, 11 and 13 and rebuild them; decode back to .dat/.idx; every
   step checked by SHA-256, sampled parity against the numpy twin, and
   needles read back against their seeded payloads.  The kernel launch
   count is zeroed before and read after, and must match the work list.
   The phase writes about 5.2x the volume to disk (volume, shards,
   rebuilt shards, decoded volume, a profiled second encode) and holds
   about 2.4x at its peak.
4. remote: the same volume (its .dat/.idx hard-linked) scatter-encoded
   and rebuilt across 7 port volume servers on loopback, one directory
   each: server 0 in this process (its codec on the card, so the launch
   count covers it), servers 1-6 started as `python3 -m
   seaweedfs_tpu_torch volume` subprocesses.  `POST /admin/ec/generate`
   with placement sid % 7 (2 shards a server); every shard's SHA-256 at
   its destination held against the ec phase's.  Server 1 is stopped
   and its directory deleted (shards 1 and 8 lost); `POST
   /admin/ec/rebuild` in stream mode on server 0, the survivors listed
   as a master would, streams 8 remote rows from 5 donors; the rebuilt
   .ec01/.ec08 held against the originals.  Walls, GB/s, the scatter and
   rebuild stats summaries, the stage and stream spans, and launches
   against `plan_windows` are printed; then each is run once more under
   torch.profiler (after deleting what it wrote) for the device's busy
   time and idle share.  About 3x the volume written.
5. cluster: the same volume (hard-linked) through the port's own
   cluster on loopback: `python3 -m seaweedfs_tpu_torch master -port 0`,
   server 0 in this process with `master=` (its launches counted) and 6
   `volume -mserver` peers, polled in /vol/list until all 7 and volume
   1 show.  The port's shell runs `lock; ec.encode -volumeId=1; unlock`
   (scatter; launches against the ec phase's encode count, 14 shards in
   /dir/ec_lookup with the ec phase's SHA-256s, volume 1 gone from the
   normal volumes); a peer holding two data shards is stopped with its
   disk, and once the master has dropped it, `ec.rebuild` (stream;
   launches against `plan_windows`, SHA-256s); the same rebuild once
   more under torch.profiler, posted to server 0 without shard
   locations (it asks the master); then `ec.decode` (the target's
   .dat/.idx against the originals' SHA-256s, volume 1 listed again, no
   shard file left).  Needle reads, every `GET /<fid>` sent to server 0
   and held against its seeded payload: a seeded sample of 128 needles
   (half of them with intervals on the shards the peer will lose) after
   the encode; one lost-shard needle right after the peer stops, while
   the master still lists it; the sample once the master has dropped
   the peer (one-shot degraded reads on the host CPU codec: degraded
   reads counted = the sample's lost intervals); its lost-shard needles
   again with `SEAWEEDFS_TPU_DEGRADED_SLICE_MB=0.25` (the streamed path
   for every interval over 256 KiB, no fallback); and the sample after
   the rebuild, server 0's location cache cleared (no degraded read).
   Each read step fails if the kernel was launched in it, and prints
   its GB/s, p50/p99 ms a needle, degraded reads and failovers.  Walls,
   GB/s, the routes' telemetry, launches, the servers' start time and
   the heartbeats the master received.  About 4x the volume written.
6. batch: 64 seeded volumes (BASELINE.json's config 3) encoded through
   one batched launch a step, every shard's SHA-256 held against the
   same volumes encoded one by one, sampled parity against the numpy
   twin, and `distributed_ec_step` on the one-card grid.  It leaves the
   volumes' .dat/.idx for the worker phase.
7. worker: the maintenance plane over the port's own cluster: a `master`
   subprocess (`-volumeSizeLimitMB` the volume's whole MiB, 1025 at 1
   GiB, so the volume is full), server 0 in this process holding the ec
   phase's volume (hard-linked, volume 1) and the batch's 64 (volumes
   101-164), 6 `volume -mserver` peers, an `admin` subprocess, one start
   and stop of the `worker` command (its first line checked), and the
   worker in this process (`EcEncodeHandler(device="cuda")`,
   `EcRebuildHandler`), so its launches are counted.  Jobs:
   `trigger_detection` finds volume 1, which the worker pulls, encodes
   on the card (launches against the ec phase's encode) and spreads over
   the 7 servers; a peer is stopped with its disk and, once the master
   drops it, detection proposes the rebuild, streamed on the server with
   the most survivors (launches against `plan_windows`, read as that
   server's `device_staged_windows_total{op="rebuild"}` on its
   `/metrics`); the batch's 64 volumes in one job (batched launches
   against the batch phase's); a scatter job on a second link of the
   volume (volume 2, encoded by server 0); then the worker-mode encode
   once more under torch.profiler (volume 3).  Before volume 2's
   shards are dropped, 3 of its needles are deleted through server 0:
   each is then a 404 on every holder and in every holder's `.ecj`, and
   the port's `ec.scrub -mode=local` finds no error.  Every shard's SHA-256,
   found through /dir/ec_lookup, is held against the ec phase's or the
   batch's one-by-one encode.  Each job's wall, GB/s of .dat and stage
   times from `/maintenance/job`, the worker's spans from the admin's
   `/debug/traces`, and the bytes of the files its jobs wrote are
   printed: about 14x the volume at 1 GiB (the batch's shards are padded
   to whole 1 MiB rows).

8. write: the write path through the front door of the port's own
   cluster: a `master -volumeSizeLimitMB 1024 -defaultReplication 000`
   subprocess, 3 `volume -max 8` subprocesses (racks r1, r1, r2), the
   admin and the worker in this process (`EcEncodeHandler(device=
   "cuda")`).  `benchmark.run_benchmark` in the reference's `weed
   benchmark` shape (1 KiB files, 16 threads; n cut from 1,048,576 to
   32,768 for the run's time, printed), every read held against the
   payload, and the volumes the assigns grew; 256 seeded needles of
   1 KiB - 1 MiB under each of 001 and 010, each read back from every
   location `/dir/lookup` gives and its record on each replica (bytes,
   flags, ts, ETag against the ack's) compared; the second holder of a
   001 volume stopped: a write to it answers 500 `replication:` before
   and after the master drops the holder, and no assign hands out its
   volumes; config 1's seeded needles (256 KiB - 4 MiB) through
   `operation.submit` on 8 writers under collection `fill` until
   `/dir/assign` stops naming the first volume (the master's 1 GiB
   limit, seen through the heartbeat); detection's `erasure_coding` job
   encodes it on the card (launches against the sum of `launches_for`
   over its batches); every filled fid read back through
   `operation.read` on 8 readers (0 launches, here and on every server's
   `/metrics`); then `upload` and `download` on the command line.  Fill
   and read-back GB/s and p50/p99, the job's wall and stages.  About 3x
   the volume written.

9. read_load: BASELINE.json's config 5, "RS(6,3) alt scheme +
   streaming ec.decode read path under weed benchmark load", through
   the front door of the port's own cluster: a `master
   -volumeSizeLimitMB 1024` subprocess and 4 `volume -max 8`
   subprocesses (their codec on the card).  16,384 files of 1 KiB in
   `weed benchmark`'s shape (assign and upload on 16 threads; n cut from
   1,048,576 for the run's time) and config 1's needles on 8 writers, all
   in collection `rs63`, until the 1 GiB limit seals a volume; every
   volume of the collection `ec.encode -dataShards=6 -parityShards=3`
   through the port's shell (launches, read off each server's
   /metrics, against the sum of `launches_for` over its batches).  Six
   read passes on 16 threads, each a seeded sample of 4,096 of the 1 KiB
   files and 64 of the large needles, every byte compared: all shards
   up, cold and again warm (every 1 KiB read a hit of the hot-needle
   cache); the server holding the most data shards stopped (at most 3
   of 9), a fresh sample degraded (every rebuilt interval on the host's
   native codec) and again warm (the promoted 1 KiB decodes hit, no new
   degraded read); after `ec.rebuild` (launches against its steps'
   windows); after `ec.decode`.  Each pass: reads/s, p50/p99/max ms,
   GB/s, degraded reads, cache hits and misses, the codec engine and its
   SIMD tier, and 0 launches.  Deadline checks: a GET with a spent
   budget (`X-Weed-Deadline-Ms: 0`) answers 504 with `Retry-After`
   without reading the store, and a degraded GET under a 30 s budget
   forwards less to its shard reads (`deadline_remaining_seconds` on
   the holders).

`--kernel-only` runs phases 1 and 2 alone and prints no result line.
Then a `kernels` line, the card's name and power limit, and the device
line.  Exits non-zero, with no result, when there is no CUDA device or
the package is not beside this script; any failed check fails the run.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM3.  The data sheet gives
# no 32-bit integer rate, so the kernel's operations are bounded by its
# issue floor instead: the SASS instructions of one column, four warp
# schedulers of 32 lanes a clock on each SM, at the sampled SM clock.
HBM_BYTES_PER_S = 3.35e12
ISSUE_LANES_PER_SM = 4 * 32
L2_BYTES = 50 * 10**6
STREAM_BYTES = 512 << 20

MAIN_WORDS = 16_777_216          # 64 MiB per shard row: one device batch
TWIN_WORDS = 1 << 20             # 4 MiB per row held against numpy
LOST = (0, 7, 11, 13)
STAGE_SPANS = ("encode.read", "encode.codec", "encode.write",
               "rebuild.fetch", "rebuild.codec", "rebuild.write")
BATCH_VOLUMES = 64               # BASELINE.json config 3
BATCH_STEP_WORDS = 262_144       # 1 MiB row per volume at 64 volumes
STEP_LOST = (0, 11)
REMOTE_SERVERS = 7               # placement sid % 7, 2 shards a server
REMOTE_DOWN = 1                  # the server stopped: shards 1 and 8
REMOTE_LOST = (1, 8)
CLUSTER_SERVERS = 7              # the master's 7 volume servers
READ_SAMPLE = 128                # needles read from server 0 a state
LOST_SAMPLE_INTERVALS = 32       # of their intervals on the lost shards
EC_DELETES = 3                   # needles deleted from an EC volume
WORKER_BATCH_VID0 = 100          # batch volume i is volume 100 + i there
WRITE_RACKS = ("r1", "r1", "r2")  # the write phase's 3 volume servers
WRITE_MAX_VOLUMES = 8
WRITE_LIMIT_MB = 1024            # the master's size limit: it seals the fill
# cut from weed benchmark's 1,048,576: at 65,536 the write phase took 426 s
# of a 900 s run once read_load joined it (PERF.md §4)
BENCH_N = 32_768
BENCH_SIZE = 1024                # weed benchmark's file size and
BENCH_C = 16                     # concurrency (seaweedfs_tpu/benchmark.py)
REPLICATED = 256                 # seeded needles under each of 001 and 010
FILL_WRITERS = 8
FILL_READERS = 8
SPIN_CYCLES = 10_000_000         # ~5 ms of device spin ahead of a timed run
# read_load: BASELINE.json's config 5, "RS(6,3) alt scheme + streaming
# ec.decode read path under weed benchmark load"
RS63 = (6, 3)
READ_SERVERS = 4
READ_COLLECTION = "rs63"
READ_N = 16_384                  # 1 KiB files, cut from weed benchmark's
READ_SMALL_SAMPLE = 4_096        # 1,048,576; sampled per read pass
READ_LARGE_SAMPLE = 64           # config 1's needles sampled per pass
READ_C = 16                      # weed benchmark's concurrency


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int, trials: int = 10) -> float:
    """Device time of one call: the median over `trials` of a run of
    `reps` back-to-back calls between two CUDA events, queued behind a
    spin kernel so that the host's launch overhead leaves no gap on the
    device.  After a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def case_bytes(r: int, k: int, w: int, v: int = 1) -> int:
    """Bytes V [R,K] x W-word applies must move: V times K+R rows of W
    words, each read or written once, plus the tables read once."""
    return v * (k + r) * w * 4 + r * k * 8 * 4


def stream_gbps(nbytes: int = STREAM_BYTES) -> float:
    """The card's streaming ceiling in this call: a device-to-device
    copy_ of `nbytes`, counted as the bytes read plus the bytes written
    (CUDA events, median of 10 runs of 5)."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), 5)
    return 2 * nbytes / ms / 1e6


def _copy_ms(nbytes: int) -> float:
    """A device-to-device copy_ that moves `nbytes` (half read, half
    written), rotated over buffer sets as the kernel's cases are: the
    streaming yardstick at a case's own size, launch and ramp
    included."""
    import torch
    pairs = []
    for _ in range(max(3, -(-3 * L2_BYTES // nbytes))):
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
        pairs.append((torch.empty_like(src), src))
    nxt = itertools.cycle(pairs).__next__
    return time_ms(lambda: torch.Tensor.copy_(*nxt()), 60)


class SmiSampler:
    """nvidia-smi's SM clock and power draw every 50 ms while the block
    runs (a child process, stopped on exit)."""

    def __enter__(self):
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        try:
            out, _ = self._proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            out, _ = self._proc.communicate()
        self.samples = []
        for line in out.splitlines():
            try:
                mhz, watts = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((mhz, watts))
        return False

    def summary(self) -> dict:
        if not self.samples:
            return {"samples": 0}
        mhz = [m for m, _ in self.samples]
        watts = [w for _, w in self.samples]
        return {"samples": len(self.samples),
                "clocks_sm_mhz": {"min": min(mhz), "median":
                                  statistics.median(mhz), "max": max(mhz)},
                "power_draw_w": {"min": min(watts), "median":
                                 statistics.median(watts),
                                 "max": max(watts)}}


_SASS_LINE = re.compile(
    r"^\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
    r"\s*([^;]*);")


def sass_loops(lib_path: str) -> "dict | str":
    """The SASS of every kernel in a built library (`cuobjdump -sass`):
    for each function, its instruction count, and for each loop (a
    backward branch) the instructions of its body by class (the opcode
    before its first dot).  "not measured" without cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return "not measured"
    text = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    funcs: "dict[str, list]" = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _SASS_LINE.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for name, code in funcs.items():
        loops = []
        for addr, op, args in code:
            t = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and t and int(t.group(1), 16) <= addr:
                lo = int(t.group(1), 16)
                body = [o for a, o, _ in code if lo <= a <= addr]
                classes: "dict[str, int]" = {}
                for o in body:
                    c = o.split(".")[0]
                    classes[c] = classes.get(c, 0) + 1
                loops.append({"start": lo, "end": addr, "n": len(body),
                              "classes": dict(sorted(
                                  classes.items(), key=lambda kv: -kv[1]))})
        out[name] = {"n": len(code), "loops": loops}
    return out


def launches_for(k: int, batch_bytes: int) -> int:
    """Kernel launches of one codec batch of k rows: one per staging
    window when the batch is larger than a window (ops.staging), else
    one."""
    from seaweedfs_tpu_torch.ops import staging
    from seaweedfs_tpu_torch.ops.rs_torch import PACK_MULTIPLE
    w = -(-batch_bytes // PACK_MULTIPLE) * PACK_MULTIPLE // 4
    wb = staging.window_bytes()
    if wb > 0 and k * w * 4 > wb:
        return len(staging.plan_windows(k, w))
    return 1


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(16 << 20)
            if not chunk:
                return h.hexdigest()
            h.update(chunk)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --- phase 1 ---------------------------------------------------------------

def phase_device(smi: str) -> dict:
    import torch

    from seaweedfs_tpu_torch.ops import _build, rs_cuda
    t0 = time.perf_counter()
    _build.load(rs_cuda.SOURCE)
    build_s = time.perf_counter() - t0
    log = _build.BUILD_INFO[rs_cuda.SOURCE]["log"]
    regs = sorted({int(line.split("Used ")[1].split()[0])
                   for line in log.splitlines() if "Used " in line})
    spills = [line.strip() for line in log.splitlines()
              if "spill" in line and not line.strip().startswith("0 bytes")]
    # ptxas' report per kernel: registers and spilled bytes
    per_kernel: "dict[str, dict]" = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"(?:entry function '|properties for )([\w$]+)", line)
        if m:
            fn = per_kernel.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            fn["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
    out = {"phase": "device", "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "device_name": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count(),
           "kernel_build_seconds": build_s,
           "registers_per_thread": regs, "spills": spills,
           "ptxas": per_kernel}
    emit(out)
    return out


# --- phase 2 ---------------------------------------------------------------

def _check_case(name, out, plain, twin_out, twin_want) -> int:
    """Bit-exact checks of one kernel case; returns the max abs error
    (over bytes) against the plain version."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    err = int((out.view(torch.uint8).to(torch.int16) -
               plain.view(torch.uint8).to(torch.int16)).abs().max().item())
    check(err == 0 and torch.equal(out, plain),
          f"{name}: kernel differs from the plain version")
    check(np.array_equal(twin_out, twin_want),
          f"{name}: kernel differs from the numpy twin")
    return err


def _column_loop(sass, symbol: str, k: int) -> "dict | None":
    """The column loop of the kernel whose mangled name holds `symbol`
    (its outermost loop) and the instructions one column runs: the
    loop's body, or with one loop nested in it (the generic body's loop
    over the K input rows), that loop K times.  None otherwise."""
    if not isinstance(sass, dict):
        return None
    fns = [f for name, f in sass.items() if symbol in name]
    if len(fns) != 1 or not fns[0]["loops"]:
        return None
    loops = fns[0]["loops"]
    outer = max(loops, key=lambda lp: lp["end"] - lp["start"])
    inner = [lp for lp in loops if lp is not outer and
             outer["start"] <= lp["start"] and lp["end"] <= outer["end"]]
    if len(inner) > 1:
        return None
    n = outer["n"] + (k - 1) * inner[0]["n"] if inner else outer["n"]
    return {**outer, "inner": inner[0] if inner else None,
            "per_column": n}


def phase_kernel(seed: int) -> dict:
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops import _build, rs_cuda, rs_matrix, staging

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rng = np.random.default_rng(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _build.load(rs_cuda.SOURCE)
    sass = sass_loops(_build.BUILD_INFO[rs_cuda.SOURCE]["path"])

    def rec_matrix(lost):
        present = tuple(i not in lost for i in range(14))
        return np.asarray(rs_matrix.cached_reconstruction_matrix(
            10, 4, present, tuple(lost))[0])

    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    pm = rs_matrix.parity_matrix(10, 4)
    window_words = staging.plan_windows(10, MAIN_WORDS)[0][1]
    # RS(6,3)'s window: 32 MiB of input rows, 1,398,100 words
    window_words_63 = staging.plan_windows(6, MAIN_WORDS)[0][1]

    def rec_matrix_63(lost):
        present = tuple(i not in lost for i in range(9))
        return np.asarray(rs_matrix.cached_reconstruction_matrix(
            6, 3, present, tuple(lost))[0])
    # the streamed rebuild's step: 8 MiB slices of 10 rows, windowed
    step_tail_words = staging.plan_windows(
        10, rebuild_slice_bytes() // 4)[-1][1]
    # (name, matrix, words, volumes or None for the single entry)
    cases = [
        ("window parity [4,10]", pm, window_words, None),
        ("batch parity [64,10]->[64,4]", pm, BATCH_STEP_WORDS,
         BATCH_VOLUMES),
        ("batch ragged [3,10]->[3,4] odd W", pm, 100_003, 3),
        ("window rebuild {0,7,11,13} [4,10]", rec_matrix(LOST),
         window_words, None),
        ("window rebuild {0,7,11} [3,10]", rec_matrix(LOST[:3]),
         window_words, None),
        ("window rebuild {0,13} [2,10]", rec_matrix((0, 13)),
         window_words, None),
        ("window rebuild {7} [1,10]", rec_matrix((7,)), window_words, None),
        ("window rebuild {1,8} [2,10]", rec_matrix(REMOTE_LOST),
         window_words, None),
        ("step tail rebuild {1,8} [2,10]", rec_matrix(REMOTE_LOST),
         step_tail_words, None),
        ("window parity [3,6]", rs_matrix.parity_matrix(6, 3),
         window_words_63, None),
        ("window rebuild {0,4,8} [3,6]", rec_matrix_63((0, 4, 8)),
         window_words_63, None),
        # read_load's rebuild: a server of 4 holds 2 or 3 of 9 shards
        ("window rebuild {1,5} [2,6]", rec_matrix_63((1, 5)),
         window_words_63, None),
        ("parity [4,10]", pm, MAIN_WORDS, None),
        ("rebuild {0,7,11,13} [4,10]", rec_matrix(LOST), MAIN_WORDS, None),
        ("tail [3,6] x 1000003 bytes",
         rng.integers(0, 256, (3, 6), dtype=np.uint8), -(-1_000_003 // 4),
         None),
        ("random [16,16]", rng.integers(0, 256, (16, 16), dtype=np.uint8),
         1 << 22, None),
    ]
    stream = stream_gbps()
    results = []
    max_err = {"single": 0, "batched": 0}
    main = {}
    sampler = SmiSampler()
    with sampler:
        for case in cases:
            row = _kernel_case(case, dev, g, sass, stream)
            max_err[row["entry"]] = max(max_err[row["entry"]],
                                        row["max_abs_err"])
            main.setdefault(row["entry"], row)
            results.append(row)
    clocks = sampler.summary()
    # the issue floor at the highest SM clock sampled (the least time)
    mhz = clocks.get("clocks_sm_mhz", {}).get("max")
    for row in results:
        for key in ("", "generic_"):
            if f"_{key}instructions_per_column" not in row:
                continue
            n = row.pop(f"_{key}instructions_per_column")
            row[f"{key}issue_floor_ms"] = (
                n * row["columns"] / (ISSUE_LANES_PER_SM * sms * mhz * 1e6)
                * 1e3 if n and mhz else "not measured")
    out = {"phase": "kernel", "stream_gbps": stream, "sms": sms,
           "clocks": clocks, "cases": results, "max_abs_err": max_err,
           "sass": sass,
           "library": "no single PyTorch call computes a GF(2^8) "
                      "constant-matrix apply: no library_ms",
           "main": main}
    emit(out)
    return out


def _kernel_case(case, dev, g, sass, stream) -> dict:
    """One kernel case: bit-exact against the plain version and the
    numpy twin, then timed on the same buffers and rotating over enough
    buffer sets that each launch reads past the L2 cache."""
    import collections

    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops import gf256, rs_cuda
    name, mat, w, v = case
    r, k = mat.shape
    tables = rs_cuda.tables_from_numpy(mat, dev)
    shape = (k, w * 4) if v is None else (v, k, w * 4)
    data = torch.randint(0, 256, shape, dtype=torch.uint8,
                         device=dev, generator=g).view(torch.int32)
    if v is None:
        kind = "single"
        fn = rs_cuda.gf_apply_matrix_words
        plain_fn = rs_cuda.gf_apply_matrix_words_plain
        s = min(w, TWIN_WORDS)
        host = data[:, :s].cpu().numpy().view(np.uint8)
        out = fn(tables, data)
        twin_out = out[:, :s].cpu().numpy().view(np.uint8)
        twin_want = gf256.gf_apply_matrix(mat, host)
        twin_bytes = s * 4
    else:
        kind = "batched"
        fn = rs_cuda.gf_apply_matrix_words_batch
        plain_fn = rs_cuda.gf_apply_matrix_words_batch_plain
        # whole volumes against the twin until >= 4 MiB per row
        nv = min(v, -(-TWIN_WORDS // w))
        out = fn(tables, data)
        twin_out = np.concatenate(
            [out[i].cpu().numpy().view(np.uint8) for i in range(nv)],
            axis=1)
        twin_want = np.concatenate(
            [gf256.gf_apply_matrix(mat, data[i].cpu().numpy().view(
                np.uint8)) for i in range(nv)], axis=1)
        twin_bytes = nv * w * 4
    plain = plain_fn(tables, data)
    err = _check_case(name, out, plain, twin_out, twin_want)
    del plain, out
    nbytes = case_bytes(r, k, w, v or 1)
    ms = time_ms(lambda: fn(tables, data), 20)
    sets = [data] + [
        torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                      generator=g).view(torch.int32)
        for _ in range(max(3, -(-3 * L2_BYTES // nbytes)) - 1)]
    kept = collections.deque(maxlen=len(sets))   # outputs rotate too
    nxt = itertools.cycle(sets).__next__
    rotated_ms = time_ms(lambda: kept.append(fn(tables, nxt())), 60)
    del sets, kept
    copy_ms = _copy_ms(nbytes)
    aligned = w % 4 == 0
    loop = _column_loop(sass, rs_cuda.kernel_symbol(r, k, aligned), k)
    row = {"case": name, "entry": kind, "V": v or 1, "R": r, "K": k,
           "words": w, "equal_plain": True,
           "numpy_twin_bytes_per_row": twin_bytes,
           "equal_numpy_twin": True, "max_abs_err": err,
           "ms": ms, "rotated_ms": rotated_ms,
           "rotated_gbps": nbytes / rotated_ms / 1e6,
           "stream_share": nbytes / rotated_ms / 1e6 / stream,
           "copy_ms": copy_ms,
           "bytes": nbytes,
           "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "columns": (v or 1) * (w // 4 if aligned else w),
           "launch": rs_cuda.launch_plan(r, k, w, v or 1, aligned),
           "column_loop": loop,
           "_instructions_per_column": loop and loop["per_column"]}
    row["plain_ms"] = time_ms(lambda: plain_fn(tables, data), 2)
    if v is None and k == 6 and rs_cuda.specialised(r, k):
        # the RS(6,3) template against the generic body it replaced, on
        # the same inputs: equal outputs, then both timed the same ways
        gen = rs_cuda.gf_apply_matrix_words_generic
        check(torch.equal(gen(tables, data), fn(tables, data)),
              f"{name}: the generic body differs from the template")
        sets = [data] + [
            torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=g).view(torch.int32)
            for _ in range(max(3, -(-3 * L2_BYTES // nbytes)) - 1)]
        kept = collections.deque(maxlen=len(sets))
        nxt = itertools.cycle(sets).__next__
        row["generic_ms"] = time_ms(lambda: gen(tables, data), 20)
        row["generic_rotated_ms"] = time_ms(
            lambda: kept.append(gen(tables, nxt())), 60)
        # and the template again after it, in turns
        row["rotated_ms_after"] = time_ms(
            lambda: kept.append(fn(tables, nxt())), 60)
        gloop = _column_loop(
            sass, f"gf_apply_genericILi{min(r, 8)}ELb{int(aligned)}E", k)
        row["generic_column_loop"] = gloop
        row["_generic_instructions_per_column"] = gloop and \
            gloop["per_column"]
        del sets, kept
    del data
    torch.cuda.empty_cache()
    return row


# --- phase 3 ---------------------------------------------------------------

def _payload(seed: int, nid: int, size: int) -> bytes:
    import numpy as np
    return np.random.default_rng([seed, nid]).bytes(size)


def _cookie(nid: int) -> int:
    return (nid * 2654435761) & 0xFFFFFFFF


def _copy_rates() -> dict:
    """At one encode batch (10 x 64 MiB in, 4 x 64 MiB out): pinned
    host<->device copy rates (CUDA events, median of 5) and the host
    copy of a packed batch into pinned memory (host clock, median of 5),
    all GB/s."""
    import torch
    dev = torch.device("cuda")
    pin_in = torch.empty((10, MAIN_WORDS), dtype=torch.int32,
                         pin_memory=True)
    dev_in = torch.empty_like(pin_in, device=dev)
    dev_out = torch.empty((4, MAIN_WORDS), dtype=torch.int32, device=dev)
    pin_out = torch.empty((4, MAIN_WORDS), dtype=torch.int32,
                          pin_memory=True)
    h2d = time_ms(lambda: dev_in.copy_(pin_in, non_blocking=True), 5)
    d2h = time_ms(lambda: pin_out.copy_(dev_out, non_blocking=True), 5)
    pageable = torch.ones((10, MAIN_WORDS), dtype=torch.int32)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        pin_in.copy_(pageable)
        host.append(time.perf_counter() - t0)
    nbytes = pin_in.numel() * 4
    return {"pinned_h2d_gbps": nbytes / h2d / 1e6,
            "pinned_d2h_gbps": pin_out.numel() * 4 / d2h / 1e6,
            "host_to_pinned_gbps": nbytes / statistics.median(host) / 1e9}


def _staging_probe(seed: int) -> dict:
    """The codec's staging alone, without the disk: one encode batch
    (10 x 64 MiB) through parity_lazy(...).materialize(), windowed and
    one-shot in turns (host clock, 3 each), the windowed launches'
    staging snapshot, and the host copy of one staging window into
    pinned memory by torch and by numpy (host clock, median of 5)."""
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops import staging
    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch, pack_words
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (10, MAIN_WORDS * 4), dtype=np.uint8)
    codec = ReedSolomonTorch(10, 4, "cuda")
    walls: "dict[str, list]" = {"windowed": [], "one_shot": []}
    knob = os.environ.get("SEAWEEDFS_TPU_H2D_WINDOW_MB")
    staging.reset_aggregate()
    results = {}
    try:
        for _turn in range(3):
            for mode in ("windowed", "one_shot"):
                if mode == "one_shot":
                    os.environ["SEAWEEDFS_TPU_H2D_WINDOW_MB"] = "0"
                elif knob is None:
                    os.environ.pop("SEAWEEDFS_TPU_H2D_WINDOW_MB", None)
                else:
                    os.environ["SEAWEEDFS_TPU_H2D_WINDOW_MB"] = knob
                t0 = time.perf_counter()
                results[mode] = codec.parity_lazy(data).materialize()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
    finally:
        if knob is None:
            os.environ.pop("SEAWEEDFS_TPU_H2D_WINDOW_MB", None)
        else:
            os.environ["SEAWEEDFS_TPU_H2D_WINDOW_MB"] = knob
    check(np.array_equal(results["windowed"], results["one_shot"]),
          "windowed and one-shot parity differ")
    snap = staging.snapshot()
    flat = pack_words(data).view(np.int32)
    _w0, n, _ = staging.plan_windows(10, flat.shape[1])[0]
    pin = torch.empty((10, n), dtype=torch.int32, pin_memory=True)
    copies = {}
    for name, fn in (
            ("torch", lambda: pin.copy_(torch.from_numpy(flat[:, :n]))),
            ("numpy", lambda: np.copyto(pin.numpy(), flat[:, :n]))):
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            t.append(time.perf_counter() - t0)
        copies[name] = pin.nbytes / statistics.median(t) / 1e9
    return {"staging_probe": {
        "batch": "[10, 67108864] uint8 -> [4, 67108864]",
        "windowed_ms": walls["windowed"], "one_shot_ms": walls["one_shot"],
        "windowed_snapshot": snap,
        "window_host_copy_gbps": copies}}


def _disk_write_gbps(path: str, nbytes: int = 1 << 30) -> float:
    """Sequential write + fdatasync of `nbytes` (host clock)."""
    chunk = bytes(64 << 20)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(nbytes // len(chunk)):
            f.write(chunk)
        f.flush()
        os.fdatasync(f.fileno())
    wall = time.perf_counter() - t0
    os.remove(path)
    return nbytes / wall / 1e9


def _device_profile(fn) -> dict:
    """Run fn() once under torch.profiler: its wall (host clock) and the
    device's busy time in it (kernels and copies), the idle share, and
    the busiest device events.  The profiler's own cost lands in this
    wall, so a profiled run is a second run beside the timed one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpys): the host ops that
    # launched them (aten::copy_) carry the same time again
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if busy else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy
            else "not measured",
            "device_ms_by_name": dict(sorted(
                by_name.items(), key=lambda kv: -kv[1])[:6])}


def _profiled_encode(dat_path: str, workdir: str) -> dict:
    """Encode the volume once more under torch.profiler (staging follows
    SEAWEEDFS_TPU_H2D_WINDOW_MB as it is set)."""
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        write_ec_files)
    os.makedirs(workdir)
    base = os.path.join(workdir, "1")
    os.link(dat_path, base + ".dat")
    out = _device_profile(
        lambda: write_ec_files(base, ECContext(device="cuda")))
    shutil.rmtree(workdir)
    out["profiled_encode_ms"] = out.pop("wall_ms")
    return out


def phase_ec(volume_gib: float, seed: int, tmp: str
             ) -> "tuple[dict, dict]":
    """The EC sequence in `tmp`, which it leaves holding the volume
    (.dat/.idx, decoded) for the remote phase; returns the printed
    result and what the remote phase needs of it."""
    import numpy as np

    from seaweedfs_tpu_torch import profiling, stats, tracing
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_matrix, staging
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_decoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        LARGE_BLOCK_SIZE, ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        _encode_work_items, rebuild_ec_files, save_ec_volume_info,
        write_ec_files, write_sorted_file_from_idx)
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    os.makedirs(tmp)
    vid = 1
    rng = np.random.default_rng(seed)
    target = int(volume_gib * (1 << 30))
    t0 = time.perf_counter()
    v = Volume(tmp, vid)
    sizes = {}
    while v.dat_size() < target:
        nid = len(sizes) + 1
        sizes[nid] = int(rng.integers(256 << 10, 4 << 20))
        v.write_needle(Needle(cookie=_cookie(nid), id=nid,
                              data=_payload(seed, nid, sizes[nid])))
    n_needles = len(sizes)
    v.read_only = True
    v.sync()
    dat_size = v.dat_size()
    version = v.version
    base = v.file_name("")
    v.close()
    write_s = time.perf_counter() - t0
    dat_sha = sha256_file(base + ".dat")

    # the three calls of volume_server.py:1457-1459, on the card
    ctx = ECContext(device="cuda")
    work = _encode_work_items(dat_size, ctx)
    expect_enc = sum(launches_for(ctx.data_shards, item[3])
                     for item in work)
    staging.reset_aggregate()
    tracing.reset_buffer()
    root = tracing.start_span("chip_smoke.ec", role="volume")
    rs_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    write_sorted_file_from_idx(base)
    t1 = time.perf_counter()
    write_ec_files(base, ctx)
    t2 = time.perf_counter()
    save_ec_volume_info(base, ctx, dat_size, version)
    t3 = time.perf_counter()
    enc_launches = rs_cuda.LAUNCHES
    check(enc_launches == expect_enc,
          f"encode launched {enc_launches}, the staging windows of "
          f"the work list are {expect_enc}")

    shard_size = os.path.getsize(base + ".ec00")
    lengths = {os.path.getsize(base + ctx.to_ext(i))
               for i in range(ctx.total)}
    check(lengths == {shard_size}, f"shard sizes differ: {lengths}")
    # parity on sampled windows against the numpy twin
    pm = rs_matrix.parity_matrix(10, 4)
    win = 1 << 20
    samples = sorted({0, shard_size // 2, max(0, shard_size - win)})
    for off in samples:
        rows = []
        for i in range(ctx.total):
            with open(base + ctx.to_ext(i), "rb") as f:
                f.seek(off)
                rows.append(np.frombuffer(f.read(win), dtype=np.uint8))
        data = np.stack(rows[:10])
        check(np.array_equal(gf256.gf_apply_matrix(pm, data),
                             np.stack(rows[10:])),
              f"parity at shard offset {off} differs from numpy")
    shard_sha = {i: sha256_file(base + ctx.to_ext(i))
                 for i in range(ctx.total)}

    # lose 4 shards, rebuild them (scheme recovered from .vif)
    for sid in LOST:
        os.remove(base + ctx.to_ext(sid))
    step = ctx.batch_size(LARGE_BLOCK_SIZE)
    expect_reb = sum(launches_for(ctx.data_shards,
                                  min(step, shard_size - pos))
                     for pos in range(0, shard_size, step))
    before = rs_cuda.LAUNCHES
    t4 = time.perf_counter()
    generated = rebuild_ec_files(base)
    t5 = time.perf_counter()
    reb_launches = rs_cuda.LAUNCHES - before
    main_launches = rs_cuda.LAUNCHES
    root.finish()
    check(generated == list(LOST), f"rebuilt {generated}")
    check(reb_launches == expect_reb,
          f"rebuild launched {reb_launches}, the staging windows of "
          f"the work list are {expect_reb}")
    snap = staging.snapshot()
    check(snap["windows"] == main_launches,
          f"staging counted {snap['windows']} windows, the kernel "
          f"{main_launches} launches")
    spans = {}
    for sp in tracing.spans_for(root.trace_id):
        if sp["name"] in STAGE_SPANS:
            check(sp["parentId"] == root.span_id,
                  f"{sp['name']} is not parented to the ec span")
            spans[sp["name"]] = {
                "durationMs": sp["durationMs"],
                "busySeconds": sp["attrs"]["busySeconds"],
                "calls": sp["attrs"]["calls"]}
    check(sorted(spans) == sorted(STAGE_SPANS),
          f"stage spans {sorted(spans)}")
    m = stats.PROCESS
    gauges = {
        "device_h2d_gbps": m.gauge_value("device_h2d_gbps"),
        "device_d2h_gbps": m.gauge_value("device_d2h_gbps"),
        "device_h2d_overlap_fraction": {
            op: m.gauge_value("device_h2d_overlap_fraction", op=op)
            for op in ("encode", "rebuild")},
        "device_staged_windows_total": {
            op: m.counter_value("device_staged_windows_total", op=op)
            for op in ("encode", "rebuild")},
        "device_kernel_last_ms": m.gauge_value(
            "device_kernel_last_ms", kernel="gf_apply_matrix")}
    hist = m.histogram_merged("device_kernel_seconds")
    gauges["device_kernel_seconds"] = {"count": hist["count"],
                                       "sum": hist["sum"]}
    memory = profiling.sample_device_memory()
    check(bool(memory), "no device memory sample")
    for sid in LOST:
        check(sha256_file(base + ctx.to_ext(sid)) == shard_sha[sid],
              f"rebuilt shard {sid} differs")

    # decode back to .dat + .idx and read needles through Volume
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    t6 = time.perf_counter()
    ec_decoder.write_dat_file(
        base, dat_size, [base + ctx.to_ext(i) for i in range(10)])
    ec_decoder.write_idx_file_from_ec_index(base)
    t7 = time.perf_counter()
    check(sha256_file(base + ".dat") == dat_sha,
          "decoded .dat differs from the original")
    pick = sorted({1, n_needles, *(int(x) for x in rng.integers(
        1, n_needles + 1, size=30))})
    v = Volume(tmp, vid)
    try:
        for i in pick:
            n = v.read_needle(i, cookie=_cookie(i))
            check(n.data == _payload(seed, i, sizes[i]),
                  f"needle {i} read back wrong")
    finally:
        v.close()
    for i in range(ctx.total):      # disk room for the profiled run
        os.remove(base + ctx.to_ext(i))
    rates = _copy_rates()
    rates.update(_staging_probe(seed))
    rates["disk_write_gbps"] = _disk_write_gbps(
        os.path.join(tmp, "disk_probe"))
    # windowed (default) then one-shot, in turns, in this call
    profiled = {"windowed": _profiled_encode(
        base + ".dat", os.path.join(tmp, "profiled_windowed"))}
    knob = os.environ.get("SEAWEEDFS_TPU_H2D_WINDOW_MB")
    os.environ["SEAWEEDFS_TPU_H2D_WINDOW_MB"] = "0"
    try:
        profiled["one_shot"] = _profiled_encode(
            base + ".dat", os.path.join(tmp, "profiled_one_shot"))
    finally:
        if knob is None:
            os.environ.pop("SEAWEEDFS_TPU_H2D_WINDOW_MB")
        else:
            os.environ["SEAWEEDFS_TPU_H2D_WINDOW_MB"] = knob
    out = {"phase": "ec", "scheme": str(ctx),
           "volume_gib_requested": volume_gib, "dat_bytes": dat_size,
           "needles": n_needles, "payload_bytes": sum(sizes.values()),
           "volume_write_seconds": write_s,
           "shard_bytes": shard_size,
           "ecx_seconds": t1 - t0, "encode_seconds": t2 - t1,
           "vif_seconds": t3 - t2,
           "encode_gbps": dat_size / (t2 - t1) / 1e9,
           "encode_sequence_gbps": dat_size / (t3 - t0) / 1e9,
           "encode_launches": enc_launches,
           "rebuild_lost": list(LOST),
           "rebuild_seconds": t5 - t4,
           "rebuild_gbps": dat_size / (t5 - t4) / 1e9,
           "rebuild_launches": reb_launches,
           "main_path_launches": main_launches,
           "decode_seconds": t7 - t6,
           "parity_windows_checked": len(samples),
           "shards_sha256_equal_after_rebuild": True,
           "dat_sha256_equal_after_decode": True,
           "needles_read_back": len(pick),
           "staging": snap, "stage_spans": spans,
           "telemetry": gauges, "device_memory": memory,
           "profiled_encode": profiled, **rates}
    emit(out)
    return out, {"base": base, "dat_size": dat_size, "dat_sha": dat_sha,
                 "shard_size": shard_size, "shard_sha": shard_sha,
                 "encode_launches": enc_launches, "seed": seed,
                 "sizes": sizes}


# --- phase 4 ---------------------------------------------------------------

def _start_procs(argvs: "list[list[str]]", logs: "list[str]",
                 procs: list, role: str, line: "str | None" = None
                 ) -> "list[str]":
    """`python3 -m seaweedfs_tpu_torch <argv>` for each argv, all started
    together and appended to `procs` as they start (the caller stops
    them), stderr to its log; returns the group of `line` (a regex; by
    default `<role> server listening on <url>`, the url) once each has
    printed its first line (120 s), and fails if one does not."""
    line = line or rf"{role} server listening on (\S+:\d+)\n"
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    started = []
    for argv, log in zip(argvs, logs):
        with open(log, "w") as err:
            p = subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", *argv],
                stdout=subprocess.PIPE, stderr=err, text=True, env=env)
        procs.append(p)
        started.append(p)
    lines = [[] for _ in started]
    readers = [threading.Thread(target=lambda p=p, out=out:
                                out.append(p.stdout.readline()),
                                daemon=True)
               for p, out in zip(started, lines)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + 120
    for t in readers:
        t.join(max(0.0, deadline - time.monotonic()))
    urls = []
    for out, log in zip(lines, logs):
        m = re.fullmatch(line, out[0] if out else "")
        if m is None:
            with open(log) as f:
                raise RuntimeError(f"check failed: {log} did not start: "
                                   f"{out} {f.read()[-2000:]}")
        urls.append(m.group(1))
    return urls


def _start_peers(dirs: "list[str]", logdir: str, procs: list,
                 master: str = "") -> "list[str]":
    """A `volume` subprocess on each directory (heartbeating to `master`
    when one is given); their urls."""
    extra = ["-mserver", master] if master else []
    return _start_procs(
        [["volume", "-dir", d, "-port", "0", *extra] for d in dirs],
        [os.path.join(logdir, os.path.basename(d) + ".log") for d in dirs],
        procs, "volume")


def _stop_peers(procs) -> "list[str]":
    """SIGTERM each peer still running and wait for a clean exit 0
    (30 s); a peer that does not is killed and reported."""
    bad = []
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            rc = p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)
            rc = "killed after 30 s"
        if rc != 0:
            bad.append(f"pid {p.pid}: {rc}")
        if p.stdout is not None:
            p.stdout.close()
    return bad


def _spans(trace_id: str, prefix: str) -> dict:
    """The spans of one request's trace whose names start `prefix`."""
    from seaweedfs_tpu_torch import tracing
    out = {}
    for sp in tracing.spans_for(trace_id):
        if sp["name"].startswith(prefix):
            out[sp["name"]] = {"durationMs": sp["durationMs"],
                               **(sp.get("attrs") or {})}
    return dict(sorted(out.items()))


def _post(url: str, payload: dict, rid: str) -> dict:
    """An EC admin POST under request id `rid`; fails on an error."""
    from seaweedfs_tpu_torch import tracing
    from seaweedfs_tpu_torch.server.httpd import http_json
    r = http_json("POST", url, payload, timeout=900,
                  headers={tracing.REQUEST_ID_HEADER: rid})
    check("error" not in r, f"{url}: {r}")
    return r


def phase_remote(ec: dict, tmp: str) -> dict:
    """Scatter-encode the ec phase's volume over 7 port volume servers,
    lose one server, and rebuild its shards by streaming survivors."""
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch import tracing

    os.makedirs(tmp)
    dirs = [os.path.join(tmp, f"v{i}") for i in range(REMOTE_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    for ext in (".dat", ".idx"):
        os.link(ec["base"] + ext, os.path.join(dirs[0], "1" + ext))
    ctx = ECContext(device="cuda")
    shard_size = ec["shard_size"]
    t0 = time.perf_counter()
    server0 = VolumeServer([dirs[0]]).start()
    procs = []
    try:
        peer_urls = _start_peers(dirs[1:], tmp, procs)
        peers_s = time.perf_counter() - t0
        urls = [server0.url] + peer_urls
        _post(f"{server0.url}/admin/set_readonly", {"volumeId": 1},
              "smoke-readonly")

        # scatter-encode: placement round-robin over the 7 servers
        placement = {str(s): urls[s % REMOTE_SERVERS]
                     for s in range(ctx.total)}
        tracing.reset_buffer()
        generate = (f"{server0.url}/admin/ec/generate",
                    {"volumeId": 1, "placement": placement})
        rs_cuda.LAUNCHES = 0
        t1 = time.perf_counter()
        r = _post(*generate, "smoke-scatter")
        t2 = time.perf_counter()
        scatter_launches = rs_cuda.LAUNCHES
        scatter_tele = r["telemetry"]
        check(scatter_launches == ec["encode_launches"],
              f"scatter launched {scatter_launches}, the staging windows "
              f"of the work list are {ec['encode_launches']}")

        def check_placed() -> dict:
            placed = {}
            for sid in range(ctx.total):
                host = sid % REMOTE_SERVERS
                sha = sha256_file(os.path.join(dirs[host],
                                               f"1{ctx.to_ext(sid)}"))
                check(sha == ec["shard_sha"][sid], f"shard {sid} at "
                      f"{urls[host]} differs from the ec phase's")
                placed[sid] = {"dest": urls[host], "sha256": sha}
            return placed
        placed = check_placed()
        for d in dirs:
            check(os.path.exists(os.path.join(d, "1.ecx")) and
                  os.path.exists(os.path.join(d, "1.vif")),
                  f"sidecars missing in {d}")
            check(not [p for p in os.listdir(d) if ".scatter." in p],
                  f"staged temps left in {d}")
        scatter_spans = _spans("smoke-scatter", "encode.")
        check(len([n for n in scatter_spans
                   if n.startswith("encode.scatter.")]) == 12 and
              {"encode.read", "encode.codec", "encode.write"} <=
              set(scatter_spans), f"scatter spans {sorted(scatter_spans)}")
        # the same scatter again under the profiler, after deleting every
        # shard: the device's share of its wall
        for url in urls:
            _post(f"{url}/admin/ec/delete_shards",
                  {"volumeId": 1, "shardIds": list(range(ctx.total))},
                  "smoke-delete")
        scatter_profile = _device_profile(
            lambda: _post(*generate, "smoke-scatter-profiled"))
        check_placed()

        # lose server 1 (shards 1 and 8) with its disk
        bad = _stop_peers([procs[REMOTE_DOWN - 1]])
        check(not bad, f"server {REMOTE_DOWN} did not stop: {bad}")
        shutil.rmtree(dirs[REMOTE_DOWN])
        locs = {str(s): [urls[s % REMOTE_SERVERS]] for s in range(ctx.total)
                if s % REMOTE_SERVERS != REMOTE_DOWN}
        step = rebuild_step(shard_size, ctx, rebuild_slice_bytes())
        expect_reb = sum(launches_for(ctx.data_shards,
                                      min(step, shard_size - pos))
                         for pos in range(0, shard_size, step))
        rebuild = (f"{server0.url}/admin/ec/rebuild",
                   {"volumeId": 1, "mode": "stream", "shardLocations": locs})
        rs_cuda.LAUNCHES = 0
        t3 = time.perf_counter()
        r = _post(*rebuild, "smoke-rebuild")
        t4 = time.perf_counter()
        rebuild_launches = rs_cuda.LAUNCHES
        check(r.get("rebuiltShardIds") == list(REMOTE_LOST),
              f"streamed rebuild: {r}")
        check(rebuild_launches == expect_reb,
              f"rebuild launched {rebuild_launches}, the staging windows "
              f"of its steps are {expect_reb}")
        rebuilt = {}
        for sid in REMOTE_LOST:
            rebuilt[sid] = sha256_file(os.path.join(dirs[0],
                                                    f"1{ctx.to_ext(sid)}"))
            check(rebuilt[sid] == ec["shard_sha"][sid],
                  f"rebuilt shard {sid} differs")
        fetched = r["telemetry"]["bytesFetchedBySource"]
        remote_rows = [u for u in fetched if u != "local"]
        check(len(remote_rows) == 5 and
              r["telemetry"]["bytesFetchedTotal"] ==
              ctx.data_shards * shard_size,
              f"rebuild fetched {fetched}")
        rebuild_spans = _spans("smoke-rebuild", "rebuild.")
        check({"rebuild.fetch", "rebuild.codec", "rebuild.write"} <=
              set(rebuild_spans) and
              len([n for n in rebuild_spans
                   if n.startswith("rebuild.source.")]) == 8,
              f"rebuild spans {sorted(rebuild_spans)}")
        # the same rebuild again under the profiler
        _post(f"{server0.url}/admin/ec/delete_shards",
              {"volumeId": 1, "shardIds": list(REMOTE_LOST)}, "smoke-delete")
        rebuild_profile = _device_profile(
            lambda: _post(*rebuild, "smoke-rebuild-profiled"))
        for sid in REMOTE_LOST:
            check(sha256_file(os.path.join(dirs[0], f"1{ctx.to_ext(sid)}"))
                  == ec["shard_sha"][sid], f"re-rebuilt shard {sid} differs")
    finally:
        server0.stop()
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"peers did not stop cleanly: {bad}")
    dat = ec["dat_size"]
    out = {"phase": "remote", "servers": REMOTE_SERVERS,
           "placement": "shard sid on server sid % 7",
           "peer_start_seconds": peers_s,
           "scatter": {"seconds": t2 - t1, "gbps": dat / (t2 - t1) / 1e9,
                       "launches": scatter_launches,
                       "expected_launches": ec["encode_launches"],
                       "shards_sha256_equal": ctx.total,
                       "shards": placed,
                       "telemetry": scatter_tele,
                       "spans": scatter_spans,
                       "profiled": scatter_profile},
           "lost": {"server": REMOTE_DOWN, "shards": list(REMOTE_LOST)},
           "rebuild": {"seconds": t4 - t3, "gbps": dat / (t4 - t3) / 1e9,
                       "step_bytes": step,
                       "launches": rebuild_launches,
                       "expected_launches": expect_reb,
                       "rebuilt_sha256_equal": rebuilt,
                       "telemetry": r["telemetry"],
                       "spans": rebuild_spans,
                       "profiled": rebuild_profile}}
    emit(out)
    return out


# --- phase 5 ---------------------------------------------------------------

def _recording(calls: list):
    """The shell's http_json, keeping each EC generate and rebuild reply
    (the routes' telemetry) in `calls`."""
    from seaweedfs_tpu_torch.server.httpd import http_json

    def call(method, url, payload=None, timeout=30.0, headers=None):
        r = http_json(method, url, payload, timeout, headers)
        if url.endswith(("/admin/ec/generate", "/admin/ec/rebuild")):
            calls.append({"url": url, "reply": r})
        return r
    return call


def _fid(vid: int, nid: int) -> str:
    from seaweedfs_tpu_torch.storage import types
    return str(types.FileId(vid, nid, _cookie(nid)))


def _lost_intervals(ev, nids, lost) -> "dict[int, list[int]]":
    """Needle id -> the sizes of its intervals on the shards `lost`, for
    the needles of `nids` that have any."""
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)
    out = {}
    for nid in nids:
        sizes = [iv.size for iv in ev.locate_needle(nid)[2]
                 if iv.to_shard_id_and_offset(
                     LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE,
                     ev.ctx.data_shards)[0] in lost]
        if sizes:
            out[nid] = sizes
    return out


def _read_step(server, nids, ec: dict, what: str) -> dict:
    """GET each needle of `nids` (volume 1) from `server`, which runs in
    this process, one after another, each held against its seeded
    payload.  Returns the read GB/s over the GETs' wall time, p50/p99 ms
    a needle, and the degraded reads and source failovers the server's
    reader counted meanwhile.  Fails if a read launched the kernel.  The
    server's hot-needle cache is dropped first, so every GET reaches the
    EC reader."""
    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    server._nc_drop_volume(1)
    launches = (rs_cuda.LAUNCHES, rs_cuda.LAUNCHES_BATCHED)
    deg0 = stats.PROCESS.counter_value("ec_degraded_reads_total", vid=1) \
        or 0.0
    fo0 = stats.PROCESS.counter_sum("ec_read_source_failovers_total")
    ms = []
    nbytes = 0
    for nid in nids:
        t = time.perf_counter()
        st, body, _ = http_bytes("GET", f"{server.url}/{_fid(1, nid)}",
                                 timeout=300)
        ms.append((time.perf_counter() - t) * 1e3)
        check(st == 200 and body == _payload(ec["seed"], nid,
                                             ec["sizes"][nid]),
              f"{what}: needle {nid} read {st}, {len(body)} bytes, "
              f"not its payload")
        nbytes += len(body)
    check((rs_cuda.LAUNCHES, rs_cuda.LAUNCHES_BATCHED) == launches,
          f"{what}: the reads launched the kernel")
    deg = (stats.PROCESS.counter_value("ec_degraded_reads_total", vid=1)
           or 0.0) - deg0
    ordered = sorted(ms)
    return {"needles": len(nids), "bytes": nbytes,
            "seconds": sum(ms) / 1e3, "gbps": nbytes / sum(ms) / 1e6,
            "p50_ms": statistics.median(ordered),
            "p99_ms": statistics.quantiles(ordered, n=100,
                                          method="inclusive")[98]
            if len(ordered) > 1 else ordered[0],
            "max_ms": ordered[-1], "degraded_reads": int(deg),
            "failovers": int(stats.PROCESS.counter_sum(
                "ec_read_source_failovers_total") - fo0),
            "kernel_launches": 0}


def phase_cluster(ec: dict, tmp: str) -> dict:
    """The ec phase's volume through the port's own cluster: a `master`
    subprocess, server 0 in this process (its codec on the card, so the
    launch count covers it) and 6 `volume -mserver` peers, driven by the
    port's shell: `ec.encode` (scatter), a peer stopped with its disk,
    `ec.rebuild` (stream), `ec.decode`.  A seeded sample of 128 needles
    is read from server 0 after the encode, with the peer lost (one-shot
    degraded reads, then the lost-shard needles again with a 0.25 MiB
    streaming window) and after the rebuild."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.server.httpd import http_json
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.shell import CommandEnv, commands
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.topology import iter_volume_list_nodes

    os.makedirs(tmp)
    dirs = [os.path.join(tmp, f"v{i}") for i in range(CLUSTER_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    for ext in (".dat", ".idx"):
        os.link(ec["base"] + ext, os.path.join(dirs[0], "1" + ext))
    idx_sha = sha256_file(ec["base"] + ".idx")
    ctx = ECContext(device="cuda")
    shard_size = ec["shard_size"]
    dat = ec["dat_size"]
    procs = []
    server0 = None
    calls: list = []
    real_http_json = commands.http_json
    commands.http_json = _recording(calls)
    try:
        t0 = time.perf_counter()
        (murl,) = _start_procs([["master", "-port", "0"]],
                               [os.path.join(tmp, "master.log")], procs,
                               "master")
        server0 = VolumeServer([dirs[0]], master=murl).start()
        peer_urls = _start_peers(dirs[1:], tmp, procs, master=murl)
        urls = [server0.url] + peer_urls
        dir_of = dict(zip(urls, dirs))

        def get(path):
            return http_json("GET", f"{murl}{path}", timeout=30)

        def poll(cond, what, timeout=60.0):
            deadline = time.monotonic() + timeout
            while not cond():
                check(time.monotonic() < deadline, f"timed out: {what}")
                time.sleep(0.05)

        def normal_vids():
            return {v["id"] for n in iter_volume_list_nodes(
                get("/vol/list")) for v in n["volumes"]}
        poll(lambda: len(list(iter_volume_list_nodes(get("/vol/list"))))
             == CLUSTER_SERVERS and 1 in normal_vids(), "7 nodes and "
             "volume 1 in /vol/list")
        start_s = time.perf_counter() - t0

        def ec_locs():
            r = get("/dir/ec_lookup?volumeId=1")
            return {loc["url"]: loc["shardIds"]
                    for loc in r.get("shardIdLocations", [])}

        def check_shards(what):
            locs = ec_locs()
            held = sorted(s for sids in locs.values() for s in sids)
            check(held == list(range(ctx.total)),
                  f"{what}: /dir/ec_lookup lists {locs}")
            for url, sids in locs.items():
                for sid in sids:
                    check(sha256_file(os.path.join(
                        dir_of[url], f"1{ctx.to_ext(sid)}")) ==
                        ec["shard_sha"][sid],
                        f"{what}: shard {sid} at {url} differs")
            return locs

        env = CommandEnv(murl)
        rs_cuda.LAUNCHES = 0
        t1 = time.perf_counter()
        enc_out = commands.run_script(
            env, "lock; ec.encode -volumeId=1; unlock")
        t2 = time.perf_counter()
        enc_launches = rs_cuda.LAUNCHES
        check(enc_launches == ec["encode_launches"],
              f"shell encode launched {enc_launches}, the staging "
              f"windows of the work list are {ec['encode_launches']}")
        check(1 not in normal_vids() and all(
            "shardBits" in loc for loc in
            get("/dir/lookup?volumeId=1")["locations"]),
            "volume 1 still listed as a normal volume")
        placed = check_shards("encode")
        enc_tele = calls[-1]["reply"].get("telemetry")

        # a peer holding two data shards (else any peer), stopped with
        # its disk
        victim = next((u for u in peer_urls if len(placed.get(u, ())) == 2
                       and all(s < ctx.data_shards for s in placed[u])),
                      next(u for u in peer_urls if placed.get(u)))
        lost = placed[victim]

        # the read sample: 128 needles, seeded, half of them (at most)
        # with intervals on the shards that will be lost
        ev0 = server0.store.find_ec_volume(1)
        hit = _lost_intervals(ev0, ec["sizes"], set(lost))
        rng = np.random.default_rng([ec["seed"], 8])
        n_hit = min(READ_SAMPLE // 2, len(hit))
        others = sorted(set(ec["sizes"]) - set(hit))
        sample = sorted(
            [int(x) for x in rng.choice(sorted(hit), n_hit, replace=False)] +
            [int(x) for x in rng.choice(
                others, min(READ_SAMPLE - n_hit, len(others)),
                replace=False)])
        lost_in_sample = {nid: hit[nid] for nid in sample if nid in hit}
        n_lost_iv = sum(len(v) for v in lost_in_sample.values())
        check(n_lost_iv >= LOST_SAMPLE_INTERVALS,
              f"only {n_lost_iv} sampled intervals on the lost shards "
              f"{lost}")
        reads = {"sample": {
            "needles": len(sample), "lost_shard_needles":
                len(lost_in_sample), "lost_shard_intervals": n_lost_iv,
            "min_bytes": min(ec["sizes"][n] for n in sample),
            "max_bytes": max(ec["sizes"][n] for n in sample)}}
        reads["encoded"] = _read_step(server0, sample, ec, "encoded")
        check(reads["encoded"]["degraded_reads"] == 0,
              f"degraded reads with every shard up: {reads['encoded']}")

        bad = _stop_peers([procs[1 + peer_urls.index(victim)]])
        check(not bad, f"{victim} did not stop: {bad}")
        shutil.rmtree(dir_of[victim])
        t3 = time.perf_counter()
        # one lost-shard needle while the master still lists the peer
        reads["in_master_window"] = _read_step(
            server0, [next(iter(lost_in_sample))], ec, "in window")
        poll(lambda: victim not in ec_locs(), "master drops the peer")
        drop_s = time.perf_counter() - t3
        reads["degraded"] = _read_step(server0, sample, ec, "degraded")
        check(reads["degraded"]["degraded_reads"] == n_lost_iv,
              f"{reads['degraded']['degraded_reads']} degraded reads "
              f"counted, {n_lost_iv} sampled intervals are lost")
        # the lost-shard needles again through 0.25 MiB windows: each
        # interval over a window streams, the others take the one-shot
        # path, and no streamed read falls back to it
        reader = server0.ec_reader
        paths = {"streamed": 0, "one_shot": 0}

        def counting(name, fn):
            def call(*a, **k):
                paths[name] += 1
                return fn(*a, **k)
            return call
        reader._recover_interval_streamed = counting(
            "streamed", reader._recover_interval_streamed)
        reader._recover_interval = counting("one_shot",
                                            reader._recover_interval)
        os.environ["SEAWEEDFS_TPU_DEGRADED_SLICE_MB"] = "0.25"
        try:
            reads["streamed"] = _read_step(server0, sorted(lost_in_sample),
                                           ec, "streamed")
        finally:
            del os.environ["SEAWEEDFS_TPU_DEGRADED_SLICE_MB"]
            del reader._recover_interval_streamed, \
                reader._recover_interval
        window = 1 << 18
        want = {"streamed": sum(1 for v in lost_in_sample.values()
                                for n in v if n > window),
                "one_shot": sum(1 for v in lost_in_sample.values()
                                for n in v if n <= window)}
        reads["streamed"]["paths"] = paths
        check(paths == want and want["streamed"] > 0,
              f"streamed pass took {paths}, its intervals need {want}")
        step = rebuild_step(shard_size, ctx, rebuild_slice_bytes())
        expect_reb = sum(launches_for(ctx.data_shards,
                                      min(step, shard_size - pos))
                         for pos in range(0, shard_size, step))
        rs_cuda.LAUNCHES = 0
        t4 = time.perf_counter()
        reb_out = commands.run_script(
            env, "lock; ec.rebuild -volumeId=1; unlock")
        t5 = time.perf_counter()
        reb_launches = rs_cuda.LAUNCHES
        check(f"rebuilt shards {lost} on {server0.url}" in reb_out[1],
              f"rebuild: {reb_out}")
        check(reb_launches == expect_reb,
              f"shell rebuild launched {reb_launches}, the staging "
              f"windows of its steps are {expect_reb}")
        reb_tele = calls[-1]["reply"].get("telemetry")
        check_shards("rebuild")

        # the rebuild once more under the profiler, on server 0 with the
        # survivors from the master (no shardLocations in the request)
        for url, sids in ec_locs().items():
            gone = [s for s in sids if s in lost]
            if gone:
                _post(f"{url}/admin/ec/delete_shards",
                      {"volumeId": 1, "shardIds": gone}, "smoke-delete")
        rs_cuda.LAUNCHES = 0
        reb_profile = _device_profile(lambda: _post(
            f"{server0.url}/admin/ec/rebuild", {"volumeId": 1},
            "smoke-cluster-rebuild"))
        reb_profile["launches"] = rs_cuda.LAUNCHES
        check(reb_profile["launches"] == expect_reb,
              f"profiled rebuild launched {reb_profile['launches']}")
        _post(f"{server0.url}/admin/ec/mount",
              {"volumeId": 1, "shardIds": lost}, "smoke-mount")
        check_shards("profiled rebuild")
        # the reader's 12-of-14 location entry would stay fresh for 7
        # minutes and keep rebuilding intervals whose shards are back
        server0.ec_reader.forget(1)
        reads["rebuilt"] = _read_step(server0, sample, ec, "rebuilt")
        check(reads["rebuilt"]["degraded_reads"] == 0,
              f"degraded reads after the rebuild: {reads['rebuilt']}")

        t6 = time.perf_counter()
        dec_out = commands.run_script(
            env, "lock; ec.decode -volumeId=1; unlock")
        t7 = time.perf_counter()
        target = dec_out[1].rsplit(" ", 1)[1]
        for ext, want in ((".dat", ec["dat_sha"]), (".idx", idx_sha)):
            check(sha256_file(os.path.join(dir_of[target], "1" + ext)) ==
                  want, f"decoded {ext} on {target} differs")
        check(get("/dir/lookup?volumeId=1")["locations"] ==
              [{"url": target, "publicUrl": target}],
              "volume 1 not listed again after the decode")
        left = [os.path.join(d, n) for d in dirs if os.path.isdir(d)
                for n in os.listdir(d) if re.search(r"\.ec\d\d$", n)]
        check(not left, f"shard files left: {left}")
        heartbeats = get("/cluster/status")["heartbeats"]
    finally:
        commands.http_json = real_http_json
        if server0 is not None:
            server0.stop()
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"servers did not stop cleanly: {bad}")
    out = {"phase": "cluster", "servers": CLUSTER_SERVERS,
           "server_start_seconds": start_s,
           "encode": {"seconds": t2 - t1, "gbps": dat / (t2 - t1) / 1e9,
                      "launches": enc_launches,
                      "expected_launches": ec["encode_launches"],
                      "shell": enc_out, "placement": placed,
                      "telemetry": enc_tele},
           "lost": {"server": victim, "shards": lost,
                    "master_drop_seconds": drop_s},
           "rebuild": {"seconds": t5 - t4, "gbps": dat / (t5 - t4) / 1e9,
                       "launches": reb_launches,
                       "expected_launches": expect_reb,
                       "shell": reb_out, "telemetry": reb_tele,
                       "profiled": reb_profile},
           "decode": {"seconds": t7 - t6, "gbps": dat / (t7 - t6) / 1e9,
                      "target": target, "shell": dec_out,
                      "dat_idx_sha256_equal": True},
           "reads": reads,
           "master_heartbeats": heartbeats}
    emit(out)
    return out


# --- phase 6 ---------------------------------------------------------------

def _write_volume(directory: str, vid: int, target: int, rng,
                  seed: int) -> "tuple[str, int, int, dict]":
    """A seeded volume of `target` .dat bytes, less under 8 KiB, written
    through the port's Volume; returns (base, dat bytes, version, needle
    sizes)."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    v = Volume(directory, vid)
    sizes = {}
    while v.dat_size() < target - (8 << 10):
        nid = len(sizes) + 1
        room = target - v.dat_size() - 4096    # needle header and tail
        sizes[nid] = min(int(rng.integers(256 << 10, 2 << 20)), room)
        v.write_needle(Needle(cookie=_cookie(nid), id=nid,
                              data=_payload(seed + vid, nid, sizes[nid])))
    v.read_only = True
    v.sync()
    out = (v.file_name(""), v.dat_size(), v.version, sizes)
    v.close()
    return out


def phase_batch(batch_gib: float, seed: int, tmp: str
                ) -> "tuple[dict, dict]":
    """The 64-volume batch in `tmp`, which it leaves holding the volumes
    (.dat/.idx) for the worker phase; returns the printed result and
    what the worker phase needs of it."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_matrix
    from seaweedfs_tpu_torch.parallel import ec_batch, ec_sharded, make_mesh
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        DEVICE_BATCH_SIZE, SMALL_BLOCK_SIZE, ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        save_ec_volume_info, write_ec_files, write_sorted_file_from_idx)

    batch_dir = os.path.join(tmp, "batch")
    alone_dir = os.path.join(tmp, "alone")
    os.makedirs(batch_dir)
    os.makedirs(alone_dir)
    try:
        rng = np.random.default_rng(seed + 1)
        mean = batch_gib * (1 << 30) / BATCH_VOLUMES
        t0 = time.perf_counter()
        vols = [_write_volume(batch_dir, vid, int(rng.uniform(
            0.75 * mean, 1.25 * mean)), rng, seed)
            for vid in range(1, BATCH_VOLUMES + 1)]
        write_s = time.perf_counter() - t0
        bases = [b for b, _, _, _ in vols]
        total = sum(n for _, n, _, _ in vols)
        ctx = ECContext(device="cuda")
        d = ctx.data_shards
        rows_per_step = max(1, DEVICE_BATCH_SIZE //
                            (SMALL_BLOCK_SIZE * BATCH_VOLUMES))
        n_rows = [-(-n // (SMALL_BLOCK_SIZE * d)) for _, n, _, _ in vols]
        expect_steps = max(-(-r // rows_per_step) for r in n_rows)

        # as the worker's execute_batch: .ecx each, one batched encode,
        # .vif each
        for b in bases:
            write_sorted_file_from_idx(b)
        rs_cuda.LAUNCHES = 0
        rs_cuda.LAUNCHES_BATCHED = 0
        t1 = time.perf_counter()
        ec_batch.encode_volume_files_batch(bases, ctx)
        t2 = time.perf_counter()
        batched = rs_cuda.LAUNCHES_BATCHED
        single = rs_cuda.LAUNCHES
        for b, n, version, _ in vols:
            save_ec_volume_info(b, ctx, n, version)
        check(batched == expect_steps and single == 0,
              f"batch encode made {batched} batched and {single} single "
              f"launches for {expect_steps} steps")

        # each volume alone through the per-volume pipeline
        t3 = time.perf_counter()
        for b in bases:
            alone = os.path.join(alone_dir, os.path.basename(b))
            os.link(b + ".dat", alone + ".dat")
            write_ec_files(alone, ctx)
        t4 = time.perf_counter()
        alone_sha = {}
        for vid, b in enumerate(bases, 1):
            alone = os.path.join(alone_dir, os.path.basename(b))
            alone_sha[vid] = [sha256_file(alone + ctx.to_ext(i))
                              for i in range(ctx.total)]
            for i in range(ctx.total):
                check(sha256_file(b + ctx.to_ext(i)) == alone_sha[vid][i],
                      f"{b}{ctx.to_ext(i)} differs from the per-volume "
                      f"encode")
        pm = rs_matrix.parity_matrix(d, ctx.parity_shards)
        win = 1 << 20
        checked = 0
        for b in (bases[0], bases[BATCH_VOLUMES // 2], bases[-1]):
            shard = os.path.getsize(b + ".ec00")
            for off in sorted({0, max(0, shard - win)}):
                rows = []
                for i in range(ctx.total):
                    with open(b + ctx.to_ext(i), "rb") as f:
                        f.seek(off)
                        rows.append(np.frombuffer(f.read(win),
                                                  dtype=np.uint8))
                check(np.array_equal(gf256.gf_apply_matrix(
                    pm, np.stack(rows[:d])), np.stack(rows[d:])),
                    f"{b} parity at {off} differs from numpy")
                checked += 1

        # the sharded step on the one-card grid, 64 MiB per shard row
        mesh = make_mesh()
        data32 = rng.integers(0, 1 << 32, size=(d, MAIN_WORDS),
                              dtype=np.uint32)
        rs_cuda.LAUNCHES = 0
        t5 = time.perf_counter()
        par, _rec, err = ec_sharded.distributed_ec_step(
            mesh, data32, lost=STEP_LOST)
        t6 = time.perf_counter()
        step_launches = rs_cuda.LAUNCHES
        check(err == 0, f"distributed_ec_step err {err}")
        s = TWIN_WORDS
        check(np.array_equal(
            par[:, :s].view(np.uint8),
            gf256.gf_apply_matrix(pm, data32[:, :s].view(np.uint8))),
            "distributed_ec_step parity differs from numpy")
        out = {"phase": "batch", "volumes": BATCH_VOLUMES,
               "batch_gib_requested": batch_gib, "dat_bytes": total,
               "dat_bytes_min": min(n for _, n, _, _ in vols),
               "dat_bytes_max": max(n for _, n, _, _ in vols),
               "volume_write_seconds": write_s,
               "rows_per_step": rows_per_step, "steps": expect_steps,
               "step_shape": f"[{BATCH_VOLUMES},{d}] -> "
                             f"[{BATCH_VOLUMES},{ctx.parity_shards}] x "
                             f"{rows_per_step * SMALL_BLOCK_SIZE // 4} "
                             f"words",
               "batch_encode_seconds": t2 - t1,
               "batch_encode_gbps": total / (t2 - t1) / 1e9,
               "batched_launches": batched,
               "per_volume_encode_seconds": t4 - t3,
               "per_volume_encode_gbps": total / (t4 - t3) / 1e9,
               "shards_sha256_equal_per_volume": BATCH_VOLUMES * ctx.total,
               "parity_windows_checked": checked,
               "step": {"grid": mesh.shape, "words": MAIN_WORDS,
                        "lost": list(STEP_LOST), "err": err,
                        "launches": step_launches,
                        "seconds": t6 - t5}}
        emit(out)
    finally:
        # the worker phase needs the volumes only
        shutil.rmtree(alone_dir, ignore_errors=True)
        for name in os.listdir(batch_dir):
            if not name.endswith((".dat", ".idx")):
                os.remove(os.path.join(batch_dir, name))
    return out, {"bases": bases, "dat_bytes": total,
                 "batched_launches": batched, "alone_sha": alone_sha}


# --- phase 7 ---------------------------------------------------------------

def _metric(text: str, name: str) -> float:
    """One sample of a Prometheus text page (0 when absent)."""
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def _job(admin: str, submit: "dict | None" = None,
         job_type: str = "") -> dict:
    """Submit a job to the admin, or without `submit` trigger detection
    and take the one new job of `job_type`; wait for it to end (900 s)
    and fail unless it is done.  Returns its record with `wall_s`
    (submit or trigger to done, host clock) and `stages`: each trace
    event's seconds after the assignment."""
    from seaweedfs_tpu_torch.server.httpd import http_json

    def call(method, path, payload=None):
        r = http_json(method, f"{admin}{path}", payload, timeout=60)
        check("error" not in r, f"{path}: {r}")
        return r
    before = {j["jobId"] for j in call("GET", "/maintenance/queue")["jobs"]}
    t0 = time.perf_counter()
    if submit is not None:
        jid = call("POST", "/maintenance/submit_job", submit)["jobId"]
    else:
        call("POST", "/maintenance/trigger_detection")
        deadline = time.monotonic() + 60
        while True:
            new = [j["jobId"] for j in call("GET", "/maintenance/queue")[
                "jobs"] if j["jobId"] not in before and
                j["jobType"] == job_type]
            if new:
                break
            check(time.monotonic() < deadline,
                  f"detection proposed no {job_type} job")
            time.sleep(0.05)
        check(len(new) == 1, f"detection proposed {new}: " + str([
            j.get("params") for j in call("GET", "/maintenance/queue")[
                "jobs"] if j["jobId"] in new]))
        jid = new[0]
    deadline = time.monotonic() + 900
    while True:
        job = call("GET", f"/maintenance/job?id={jid}")
        if job["status"] in ("done", "failed"):
            break
        check(time.monotonic() < deadline, f"job {jid} did not end")
        time.sleep(0.05)
    job["wall_s"] = time.perf_counter() - t0
    check(job["status"] == "done", f"job {jid}: {job['message']} "
          f"{job['trace']}")
    t_assigned = next(t["ts"] for t in job["trace"]
                      if t["event"].startswith("assigned to"))
    # a run of like events (a batch's "pulled volume 7 (7/64)") keeps
    # its last
    stages = []
    for t in job["trace"]:
        if t["ts"] < t_assigned:
            continue
        kind = re.sub(r"[\d.]+", "N", t["event"])
        if stages and stages[-1][0] == kind:
            stages.pop()
        stages.append((kind, [t["event"][:60],
                              round(t["ts"] - t_assigned, 3)]))
    job["stages"] = [s for _, s in stages]
    return job


def phase_worker(ec: dict, batch: dict, tmp: str) -> dict:
    """The maintenance plane over the port's own cluster: a `master`
    subprocess (the volume's size as its limit), server 0 in this
    process, 6 `volume -mserver` peers, an `admin` subprocess, and the
    worker in this process with its codec on the card.  Jobs: the ec
    phase's volume found by detection and encoded on the worker; a peer
    lost with its disk and its shards rebuilt by a detected job; the
    batch phase's 64 volumes in one job; a scatter job on a second link
    of the volume; and the worker-mode encode once more under
    torch.profiler."""
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.plugin import (EcEncodeHandler,
                                            EcRebuildHandler, PluginWorker)
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.shell import CommandEnv, commands
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.topology import iter_volume_list_nodes

    os.makedirs(tmp)
    dirs = [os.path.join(tmp, f"v{i}") for i in range(CLUSTER_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    # server 0 holds the ec phase's volume as volume 1 and batch volume
    # i as volume WORKER_BATCH_VID0 + i (no volume id is inside a file)
    batch_vids = [WORKER_BATCH_VID0 + i
                  for i in range(1, len(batch["bases"]) + 1)]
    for ext in (".dat", ".idx"):
        os.link(ec["base"] + ext, os.path.join(dirs[0], "1" + ext))
        for vid, b in zip(batch_vids, batch["bases"]):
            os.link(b + ext, os.path.join(dirs[0], f"{vid}{ext}"))
    ctx = ECContext(device="cuda")
    shard_size = ec["shard_size"]
    dat = ec["dat_size"]
    idx = os.path.getsize(ec["base"] + ".idx")
    procs: list = []
    server0 = None
    worker = None
    try:
        t0 = time.perf_counter()
        # the volume is full at this limit (its whole MiB, 1025 at
        # 1 GiB): over the encode handler's 0.9, where no batch volume
        # comes near
        (murl,) = _start_procs(
            [["master", "-port", "0", "-volumeSizeLimitMB", str(dat >> 20)]],
            [os.path.join(tmp, "master.log")], procs, "master")
        server0 = VolumeServer([dirs[0]], master=murl).start()
        peer_urls = _start_peers(dirs[1:], tmp, procs, master=murl)
        urls = [server0.url] + peer_urls
        dir_of = dict(zip(urls, dirs))
        (aurl,) = _start_procs(
            [["admin", "-port", "0", "-master", murl,
              "-detectionInterval", "3600",
              "-dataDir", os.path.join(tmp, "admin")]],
            [os.path.join(tmp, "admin.log")], procs, "admin",
            r"admin listening on (\S+:\d+)\n")
        # the command line's worker: its first line, then a clean stop
        # (it would take jobs whose launches this process cannot count)
        (cli_id,) = _start_procs(
            [["worker", "-admin", aurl, "-master", murl,
              "-dir", os.path.join(tmp, "cli_worker"), "-device", "cuda"]],
            [os.path.join(tmp, "cli_worker.log")], procs, "worker",
            rf"worker (\w+) polling {re.escape(aurl)}\n")
        bad = _stop_peers([procs[-1]])
        check(not bad, f"the worker command did not stop cleanly: {bad}")
        worker = PluginWorker(
            aurl, murl, os.path.join(tmp, "worker"),
            [EcEncodeHandler(device="cuda"), EcRebuildHandler()],
            poll_wait=1.0).start()

        def get(path):
            return http_json("GET", f"{murl}{path}", timeout=30)

        def poll(cond, what, timeout=60.0):
            deadline = time.monotonic() + timeout
            while not cond():
                check(time.monotonic() < deadline, f"timed out: {what}")
                time.sleep(0.05)

        def normal_vids():
            return {v["id"] for n in iter_volume_list_nodes(
                get("/vol/list")) for v in n["volumes"]}
        poll(lambda: len(get("/cluster/status")["dataNodes"]) ==
             CLUSTER_SERVERS and {1, *batch_vids} <= normal_vids(),
             "7 nodes and the volumes in /vol/list")
        start_s = time.perf_counter() - t0

        def ec_locs(vid):
            r = get(f"/dir/ec_lookup?volumeId={vid}")
            return {loc["url"]: loc["shardIds"]
                    for loc in r.get("shardIdLocations", [])}

        def check_shards(vid, want, what):
            """The 14 shards of vid where the master lists them, each
            against `want`; the original volume gone.  Returns the
            placement and the bytes of vid's EC files on the servers."""
            poll(lambda: vid not in normal_vids(),
                 f"{what}: volume {vid} still listed as a normal volume")
            locs = ec_locs(vid)
            held = sorted(s for sids in locs.values() for s in sids)
            check(held == list(range(ctx.total)),
                  f"{what}: /dir/ec_lookup lists {locs}")
            for url, sids in locs.items():
                for sid in sids:
                    check(sha256_file(os.path.join(
                        dir_of[url], f"{vid}{ctx.to_ext(sid)}")) ==
                        want[sid], f"{what}: shard {sid} at {url} differs")
            held_bytes = sum(
                os.path.getsize(os.path.join(d, n)) for d in dirs
                if os.path.isdir(d) for n in os.listdir(d)
                if re.fullmatch(rf"{vid}\.(ec\d\d|ecx|vif)", n))
            return locs, held_bytes

        def drop_shards(vid):
            for url in ec_locs(vid):
                _post(f"{url}/admin/ec/delete_shards",
                      {"volumeId": vid, "shardIds": list(range(ctx.total))},
                      "smoke-delete")

        def worker_spans(job):
            rid = job["requestId"] or f"job-{job['jobId']}"
            r = http_json("GET", f"{aurl}/debug/traces?request_id={rid}",
                          timeout=30)
            return {sp["name"]: {"durationMs": sp["durationMs"],
                                 **(sp.get("attrs") or {})}
                    for sp in r["spans"]
                    if sp["name"].startswith(("encode.", "job:"))}

        def delete_and_scrub(vid):
            """EC_DELETES seeded needles of vid deleted through server 0
            (a holder: 14 shards on 7 servers): each then a 404 on every
            holder and in every holder's .ecj, a live needle still read
            back, and `ec.scrub -mode=local` with no error on any
            holder."""
            import numpy as np
            locs = ec_locs(vid)
            check(server0.url in locs, f"server 0 holds no shard of "
                                       f"volume {vid}: {locs}")
            rng = np.random.default_rng([ec["seed"], 9])
            dead = sorted(int(x) for x in rng.choice(
                sorted(ec["sizes"]), EC_DELETES, replace=False))
            live = next(n for n in sorted(ec["sizes"]) if n not in dead)
            t = time.perf_counter()
            for nid in dead:
                st, body, _ = http_bytes(
                    "DELETE", f"{server0.url}/{_fid(vid, nid)}",
                    timeout=120)
                check(st == 202, f"DELETE {_fid(vid, nid)}: {st} {body}")
            delete_s = time.perf_counter() - t
            journal = b"".join(n.to_bytes(8, "big") for n in dead)
            for url in locs:
                for nid in dead:
                    st = http_bytes("GET", f"{url}/{_fid(vid, nid)}",
                                    timeout=120)[0]
                    check(st == 404, f"deleted {_fid(vid, nid)} on {url}: "
                                     f"{st}")
                with open(os.path.join(dir_of[url], f"{vid}.ecj"),
                          "rb") as f:
                    check(f.read() == journal, f"{url}: .ecj differs")
                st, body, _ = http_bytes(
                    "GET", f"{url}/{_fid(vid, live)}", timeout=300)
                check(st == 200 and body == _payload(
                    ec["seed"], live, ec["sizes"][live]),
                    f"live needle {live} on {url}: {st}")
            t = time.perf_counter()
            (scrub,) = commands.run_script(CommandEnv(murl),
                                           "ec.scrub -mode=local")
            scrub_s = time.perf_counter() - t
            lines = scrub.splitlines()
            check(len(lines) == len(locs) and all(
                line.startswith(f"volume {vid} @ ") and
                line.endswith(", ok") for line in lines),
                f"ec.scrub: {scrub}")
            return {"volume": vid, "deleted": dead, "holders": len(locs),
                    "delete_seconds": delete_s, "scrub": lines,
                    "scrub_seconds": scrub_s}

        def summary(job, nbytes, launches, expected):
            return {"jobId": job["jobId"], "seconds": job["wall_s"],
                    "gbps": nbytes / job["wall_s"] / 1e9,
                    "launches": launches, "expected_launches": expected,
                    "message": job["message"], "stages": job["stages"]}

        # 1. detection finds the full volume; the worker pulls it,
        # encodes it on the card and distributes 14 shards
        rs_cuda.LAUNCHES = 0
        enc = _job(aurl, job_type="erasure_coding")
        enc_launches = rs_cuda.LAUNCHES
        check(enc["params"]["volumeId"] == 1, f"detected {enc['params']}")
        check(enc_launches == ec["encode_launches"],
              f"worker encode launched {enc_launches}, the staging "
              f"windows of the work list are {ec['encode_launches']}")
        placed, held = check_shards(1, ec["shard_sha"], "worker encode")
        spans = worker_spans(enc)
        check({"job:erasure_coding", "encode.read", "encode.codec",
               "encode.write"} <= set(spans), f"worker spans {spans}")
        # files written: the pulled .dat/.idx, the worker's shards and
        # sidecars, and what it pushed (shards, sidecars at each target)
        sidecars = (held - ctx.total * shard_size) // len(placed)
        written = {"worker_encode": dat + idx + ctx.total * shard_size +
                   sidecars + held}

        # 2. a peer with two data shards (else any) stopped with its
        # disk; once the master drops it, detection proposes the rebuild
        victim = next((u for u in peer_urls if len(placed.get(u, ())) == 2
                       and all(s < ctx.data_shards for s in placed[u])),
                      next(u for u in peer_urls if placed.get(u)))
        lost = placed[victim]
        bad = _stop_peers([procs[1 + peer_urls.index(victim)]])
        check(not bad, f"{victim} did not stop: {bad}")
        shutil.rmtree(dir_of[victim])
        t1 = time.perf_counter()
        poll(lambda: victim not in ec_locs(1) and victim not in
             get("/cluster/status")["dataNodes"], "master drops the peer")
        drop_s = time.perf_counter() - t1
        live = [u for u in urls if u != victim]
        step = rebuild_step(shard_size, ctx, rebuild_slice_bytes())
        expect_reb = sum(launches_for(ctx.data_shards,
                                      min(step, shard_size - pos))
                         for pos in range(0, shard_size, step))
        windows_name = \
            'seaweedfs_tpu_device_staged_windows_total{op="rebuild"}'
        launches_name = \
            'seaweedfs_tpu_gf_kernel_launches{entry="gf_apply_words"}'

        def counts(url):
            """(the wrapper's launches, staged rebuild windows) of the
            process serving `url`, from its /metrics."""
            text = http_bytes("GET", f"{url}/metrics")[1].decode()
            return _metric(text, launches_name), _metric(text, windows_name)
        rs_cuda.LAUNCHES = 0
        before = {u: counts(u) for u in live}
        reb = _job(aurl, job_type="ec_rebuild")
        in_process = rs_cuda.LAUNCHES
        check(f"rebuilt shards {lost} on " in reb["message"],
              f"rebuild job: {reb['message']}")
        rebuilder = re.search(r" on (\S+:\d+),", reb["message"]).group(1)
        after = counts(rebuilder)
        # the rebuilder's own wrapper count, wherever it ran (server 0
        # shares this process's count); every launch is a staged window
        reb_launches, staged = (int(a - b) for a, b in
                                zip(after, before[rebuilder]))
        check(reb_launches == staged == expect_reb and
              in_process == (expect_reb if rebuilder == server0.url else 0),
              f"rebuild on {rebuilder}: {reb_launches} launches and "
              f"{staged} staged windows there, {in_process} launches "
              f"here; plan_windows: {expect_reb}")
        check_shards(1, ec["shard_sha"], "rebuild job")
        moved = int(re.search(r"rebalanced (\d+)", reb["message"]).group(1))
        written["worker_rebuild"] = (len(lost) + moved) * shard_size
        drop_shards(1)

        # 3. the 64 volumes in one job: one batched launch a step
        rs_cuda.LAUNCHES = 0
        rs_cuda.LAUNCHES_BATCHED = 0
        bj = _job(aurl, {"jobType": "erasure_coding",
                         "params": {"volumeIds": batch_vids}})
        batched, single = rs_cuda.LAUNCHES_BATCHED, rs_cuda.LAUNCHES
        check(batched == batch["batched_launches"] and single == 0,
              f"batch job made {batched} batched and {single} single "
              f"launches; the batch phase made {batch['batched_launches']}")
        batch_held = 0
        for i, vid in enumerate(batch_vids, 1):
            batch_held += check_shards(vid, batch["alone_sha"][i],
                                       "batch job")[1]
            drop_shards(vid)
        batch_idx = sum(os.path.getsize(b + ".idx") for b in batch["bases"])
        written["worker_batch"] = batch["dat_bytes"] + batch_idx + \
            2 * batch_held   # pulled, the worker's files, the pushes

        # 4. a scatter job on a second link of the volume: the source
        # (server 0, in this process) encodes and streams the shards
        def mount_link(vid):
            for ext in (".dat", ".idx"):
                os.link(ec["base"] + ext,
                        os.path.join(dirs[0], f"{vid}{ext}"))
            _post(f"{server0.url}/admin/mount_volume", {"volumeId": vid},
                  "smoke-mount")
            poll(lambda: vid in normal_vids(), f"volume {vid} listed")
        mount_link(2)
        rs_cuda.LAUNCHES = 0
        sj = _job(aurl, {"jobType": "erasure_coding",
                         "params": {"volumeId": 2, "encodeMode": "scatter"}})
        scatter_launches = rs_cuda.LAUNCHES
        check(scatter_launches == ec["encode_launches"],
              f"scatter job launched {scatter_launches}, the staging "
              f"windows of the work list are {ec['encode_launches']}")
        written["worker_scatter"] = check_shards(2, ec["shard_sha"],
                                                 "scatter job")[1]
        deletes = delete_and_scrub(2)
        drop_shards(2)

        # 5. the worker-mode encode again, under the profiler
        mount_link(3)
        rs_cuda.LAUNCHES = 0
        prof_jobs = []
        profiled = _device_profile(lambda: prof_jobs.append(_job(
            aurl, {"jobType": "erasure_coding", "params": {"volumeId": 3}})))
        profiled["launches"] = rs_cuda.LAUNCHES
        check(profiled["launches"] == ec["encode_launches"],
              f"profiled worker encode launched {profiled['launches']}")
        written["worker_encode_profiled"] = written["worker_encode"]
        check_shards(3, ec["shard_sha"], "profiled worker encode")
        profiled["job_seconds"] = prof_jobs[0]["wall_s"]
        heartbeats = get("/cluster/status")["heartbeats"]
    finally:
        if worker is not None:
            worker.stop()
        if server0 is not None:
            server0.stop()
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"servers or the admin did not stop cleanly: {bad}")
    out = {"phase": "worker", "servers": CLUSTER_SERVERS,
           "cluster_start_seconds": start_s, "cli_worker_id": cli_id,
           "encode": {**summary(enc, dat, enc_launches,
                                ec["encode_launches"]),
                      "placement": placed, "worker_spans": spans},
           "lost": {"server": victim, "shards": lost,
                    "master_drop_seconds": drop_s},
           "rebuild": {**summary(reb, dat, reb_launches, expect_reb),
                       "rebuilder": rebuilder,
                       "staged_windows_on_rebuilder": staged,
                       "launches_in_this_process": in_process},
           "batch": summary(bj, batch["dat_bytes"], batched,
                            batch["batched_launches"]),
           "scatter": summary(sj, dat, scatter_launches,
                              ec["encode_launches"]),
           "deletes": deletes,
           "profiled_encode": profiled,
           "files_written_bytes": {**written,
                                   "total": sum(written.values())},
           "master_heartbeats": heartbeats}
    emit(out)
    return out


def _pcts(ms: "list[float]") -> dict:
    ordered = sorted(ms)
    return {"p50_ms": statistics.median(ordered),
            "p99_ms": statistics.quantiles(ordered, n=100,
                                          method="inclusive")[98]
            if len(ordered) > 1 else ordered[0],
            "max_ms": ordered[-1]}


_CRC_PROBE = """
import json, time
import numpy as np
from seaweedfs_tpu_torch.storage import crc
buf = np.random.default_rng(0).bytes(4 << 20)
crc.crc32c(buf)
t = time.perf_counter()
for _ in range(4):
    crc.crc32c(buf)
s = time.perf_counter() - t
print(json.dumps({"path": "numpy" if crc.crc32c is crc.crc32c_numpy
                  else "google_crc32c", "gbps": 4 * len(buf) / s / 1e9}))
"""


def _crc_probe() -> dict:
    """Which CRC32-C the volume servers compute a needle's checksum with
    (the same interpreter and path as `_start_procs` gives them), and its
    rate on one core over a 4 MiB buffer (the fill's mean needle is
    ~2.1 MiB)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _CRC_PROBE],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    check(out.returncode == 0, f"the CRC probe: {out.stderr[-2000:]}")
    return json.loads(out.stdout)


def _record(directory: str, vid: int, collection: str, key: int):
    """The live needle record of key in volume vid as it lies in
    `directory` (its .idx's last entry for the key, then the .dat)."""
    from seaweedfs_tpu_torch.storage import idx, types
    from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
    base = os.path.join(directory, (f"{collection}_" if collection else "")
                        + str(vid))
    with open(base + ".idx", "rb") as f:
        off, size = idx.live_entries(f.read())[key]
    with open(base + ".dat", "rb") as f:
        f.seek(types.to_actual_offset(off))
        buf = f.read(get_actual_size(size, types.CURRENT_VERSION))
    return Needle.from_bytes(buf, types.CURRENT_VERSION, expected_size=size)


def phase_write(tmp: str, seed: int, bench_n: int = BENCH_N,
                limit_mb: int = WRITE_LIMIT_MB) -> dict:
    """The write path through the front door of the port's own cluster:
    a `master -volumeSizeLimitMB 1024 -defaultReplication 000`
    subprocess, 3 `volume -max 8` subprocesses (racks r1, r1, r2), the
    admin and the worker in this process (its codec on the card).
    `benchmark.run_benchmark` (1 KiB files, 16 threads); 256 seeded
    needles under each of 001 and 010, each read back from every
    location with its record, then a lost replica that must fail the
    write; a fill of config 1's needles through `operation.submit` on 8
    writers until the master's limit seals the first volume; the
    detected EC job that encodes it on the card; every filled fid read
    back on 8 readers; `upload` and `download` on the command line."""
    import numpy as np

    from seaweedfs_tpu_torch import benchmark, operation
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.plugin import (AdminServer, EcEncodeHandler,
                                            EcRebuildHandler, PluginWorker)
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.storage import types
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        _encode_work_items)
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes

    os.makedirs(tmp)
    dirs = [os.path.join(tmp, f"w{i}") for i in range(len(WRITE_RACKS))]
    procs: list = []
    admin = worker = None
    launches_name = \
        'seaweedfs_tpu_gf_kernel_launches{entry="gf_apply_words"}'
    cuts = {"benchmark_n": {"run": bench_n, "reference_default": 1 << 20,
                            "why": "the run's time"}}
    print(f"write phase: benchmark n = {bench_n} (weed benchmark's "
          f"default 1,048,576, cut for the run's time)", flush=True)
    try:
        t0 = time.perf_counter()
        (murl,) = _start_procs(
            [["master", "-port", "0", "-volumeSizeLimitMB", str(limit_mb),
              "-defaultReplication", "000"]],
            [os.path.join(tmp, "master.log")], procs, "master")
        urls = _start_procs(
            [["volume", "-dir", d, "-port", "0", "-mserver", murl,
              "-max", str(WRITE_MAX_VOLUMES), "-rack", rack]
             for d, rack in zip(dirs, WRITE_RACKS)],
            [d + ".log" for d in dirs], procs, "volume")
        dir_of = dict(zip(urls, dirs))
        proc_of = dict(zip(urls, procs[1:]))
        admin = AdminServer(murl, detection_interval=3600).start()
        worker = PluginWorker(admin.url, murl, os.path.join(tmp, "worker"),
                              [EcEncodeHandler(device="cuda"),
                               EcRebuildHandler()], poll_wait=1.0).start()

        def get(path):
            return http_json("GET", f"{murl}{path}", timeout=30)

        def poll(cond, what, timeout=60.0):
            deadline = time.monotonic() + timeout
            while not cond():
                check(time.monotonic() < deadline, f"timed out: {what}")
                time.sleep(0.05)

        def volumes():
            out: dict = {}
            for node, v in iter_volume_list_volumes(get("/vol/list")):
                out.setdefault(v["id"], []).append((node["url"], v))
            return out
        poll(lambda: len(get("/cluster/status")["dataNodes"]) ==
             len(urls), "3 volume servers registered")
        start_s = time.perf_counter() - t0
        check(volumes() == {}, "the cluster starts with no volume")

        # 1. weed benchmark's shape; every read held against the payload
        import random
        rng0 = random.Random(0)
        payload = bytes(rng0.getrandbits(8) for _ in range(BENCH_SIZE))
        reads = []
        real_read = operation.read

        def checked_read(master, fid, *a, **kw):
            data = real_read(master, fid, *a, **kw)
            check(data == payload, f"benchmark read of {fid}: "
                                   f"{len(data)} bytes, not its payload")
            reads.append(fid)
            return data
        # what shares the host with the benchmark's 16 client threads
        host = {"cpus": len(os.sched_getaffinity(0)),
                "loadavg_1m": os.getloadavg()[0],
                "threads_in_this_process": threading.active_count()}
        rs_cuda.LAUNCHES = 0
        operation.read = checked_read
        try:
            bench = benchmark.run_benchmark(murl, bench_n, BENCH_SIZE,
                                            BENCH_C)
        finally:
            operation.read = real_read
        host["loadavg_1m_after"] = os.getloadavg()[0]
        check(len(reads) == bench_n and len(set(reads)) == bench_n,
              f"benchmark read {len(set(reads))} of {bench_n} fids")
        bench_grown = sorted(volumes())
        check(bench_grown, "the benchmark grew no volume")
        bench_launches = rs_cuda.LAUNCHES

        # 2. replication: 256 seeded needles under each of 001 and 010
        rng = np.random.default_rng([seed, 10])
        sizes = [int(x) for x in rng.integers(1 << 10, 1 << 20,
                                              2 * REPLICATED)]
        jobs = [("001" if i < REPLICATED else "010", i, n)
                for i, n in enumerate(sizes)]

        def write_replicated(job):
            rep, i, n = job
            body = _payload(seed + 1, i, n)
            a, r = operation.assign_and_upload(murl, body, replication=rep)
            return rep, i, a.fid, r["eTag"]
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            acked = list(pool.map(write_replicated, jobs))
        repl_s = time.perf_counter() - t
        racks = dict(zip(urls, WRITE_RACKS))
        repl_vids: dict = {"001": set(), "010": set()}
        for rep, i, fid, etag in acked:
            f = types.parse_file_id(fid)
            repl_vids[rep].add(f.volume_id)
            locs = [loc["url"] for loc in
                    operation.lookup(murl, f.volume_id, use_cache=False)]
            check(len(locs) == 2 and len({racks[u] for u in locs}) ==
                  (1 if rep == "001" else 2),
                  f"{rep} fid {fid} at {locs}")
            body = _payload(seed + 1, i, sizes[i])
            recs = []
            for u in locs:
                st, data, _ = http_bytes("GET", f"{u}/{fid}", timeout=120)
                check(st == 200 and data == body,
                      f"{rep} fid {fid} on {u}: {st}, not its bytes")
                recs.append(_record(dir_of[u], f.volume_id, "", f.key))
            check(all(r.etag() == etag and r.data == body for r in recs),
                  f"{rep} fid {fid}: a replica's ETag is not the ack's")
            check(all((r.cookie, r.flags, r.last_modified, r.checksum) ==
                      (recs[0].cookie, recs[0].flags, recs[0].last_modified,
                       recs[0].checksum) for r in recs),
                  f"{rep} fid {fid}: the replicas' records differ")
        # the second holder of a 001 volume goes away
        a = operation.assign(murl, replication="001")
        vid = types.parse_file_id(a.fid).volume_id
        holders = [loc["url"] for loc in operation.lookup(
            murl, vid, use_cache=False)]
        second = next(u for u in holders if u != a.url)
        second_vids = {v for v, reps in volumes().items()
                       if second in [u for u, _ in reps]}
        bad = _stop_peers([proc_of[second]])
        check(not bad, f"{second} did not stop: {bad}")
        st, body, _ = http_bytes("POST", f"{a.url}/{a.fid}", b"unacked",
                                 timeout=60)
        check(st == 500 and b'"replication: ' in body,
              f"a write with a replica down: {st} {body[:200]!r}")
        t = time.perf_counter()
        poll(lambda: second not in get("/cluster/status")["dataNodes"],
             "the master drops the stopped replica")
        drop_s = time.perf_counter() - t
        st, body2, _ = http_bytes("POST", f"{a.url}/{a.fid}", b"unacked",
                                  timeout=60)
        check(st == 500 and b'"replication: ' in body2,
              f"a write with a replica dropped: {st} {body2[:200]!r}")
        try:
            b = operation.assign(murl, replication="001")
            handed = types.parse_file_id(b.fid).volume_id
            check(handed not in second_vids,
                  f"an assign handed out volume {handed} of {second}")
        except RuntimeError as e:
            # the one refusal expected: 001 has no same-rack pair left
            if "not enough same-rack nodes" not in str(e):
                raise
            handed = str(e)
        live = [u for u in urls if u != second]

        # 3. the fill: config 1's needles until the limit seals volume 1
        first = types.parse_file_id(operation.assign(
            murl, collection="fill").fid).volume_id
        frng = np.random.default_rng(seed)
        counter = itertools.count(1)
        stop = threading.Event()
        written: list = []          # (fid, nid, size, ms)
        lock = threading.Lock()
        fill_sizes: dict = {}

        def writer():
            while not stop.is_set():
                with lock:
                    nid = next(counter)
                    fill_sizes[nid] = int(frng.integers(256 << 10, 4 << 20))
                body = _payload(seed, nid, fill_sizes[nid])
                t = time.perf_counter()
                fid = operation.submit(murl, body, collection="fill")
                ms = (time.perf_counter() - t) * 1e3
                with lock:
                    written.append((fid, nid, len(body), ms))
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            futs = [pool.submit(writer) for _ in range(FILL_WRITERS)]
            try:
                while not any(f.done() for f in futs):
                    time.sleep(0.2)
                    nxt = types.parse_file_id(operation.assign(
                        murl, collection="fill").fid).volume_id
                    if nxt != first:
                        break
            finally:
                stop.set()
            for f in futs:
                f.result()
        fill_s = time.perf_counter() - t
        fill_bytes = sum(w[2] for w in written)
        in_first = [w for w in written
                    if types.parse_file_id(w[0]).volume_id == first]
        (holder,) = [loc["url"] for loc in operation.lookup(
            murl, first, use_cache=False)]
        dat_path = os.path.join(dir_of[holder], f"fill_{first}.dat")
        dat_size = os.path.getsize(dat_path)
        poll(lambda: [v["size"] for _, v in volumes()[first]] == [dat_size],
             "the master sees the filled volume's size")
        check(dat_size >= limit_mb << 20, f"volume {first} is {dat_size} "
                                          f"bytes, under the limit")

        # 4. the detected EC job encodes it on the card (in this process)
        ctx = ECContext(device="cuda")
        expect = sum(launches_for(ctx.data_shards, item[3])
                     for item in _encode_work_items(dat_size, ctx))
        rs_cuda.LAUNCHES = 0
        job = _job(admin.url, job_type="erasure_coding")
        enc_launches = rs_cuda.LAUNCHES
        check(job["params"]["volumeId"] == first, f"detected {job['params']}")
        check(enc_launches == expect,
              f"the fill's encode launched {enc_launches}, the staging "
              f"windows of its work list are {expect}")
        poll(lambda: sorted(s for loc in get(
            f"/dir/ec_lookup?volumeId={first}").get(
                "shardIdLocations", []) for s in loc["shardIds"]) ==
             list(range(ctx.total)) and first not in volumes(),
             "14 shards listed and the volume gone")

        # 5. every filled fid read back from the EC volume, 8 readers
        def launches_on(u):
            text = http_bytes("GET", f"{u}/metrics")[1].decode()
            return _metric(text, launches_name)
        before = {u: launches_on(u) for u in live}
        rs_cuda.LAUNCHES = 0

        def read_one(w):
            fid, nid, size, _ = w
            t = time.perf_counter()
            data = operation.read(murl, fid)
            ms = (time.perf_counter() - t) * 1e3
            check(data == _payload(seed, nid, fill_sizes[nid]),
                  f"fill fid {fid}: {len(data)} bytes, not its payload")
            return ms
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_READERS) as pool:
            read_ms = list(pool.map(read_one, written))
        read_s = time.perf_counter() - t
        read_launches = rs_cuda.LAUNCHES + int(sum(
            launches_on(u) - before[u] for u in live))
        check(read_launches == 0,
              f"the read-back launched the kernel {read_launches} times")

        # 6. upload and download on the command line
        src = os.path.join(tmp, "upload.bin")
        with open(src, "wb") as f:
            f.write(_payload(seed + 2, 1, 3 << 20))
        env = dict(os.environ,
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        up = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "upload",
             "-master", murl, src], capture_output=True, text=True,
            timeout=120, env=env)
        check(up.returncode == 0, f"upload: {up.stderr[-2000:]}")
        cli_fid = up.stdout.strip()
        down = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "download",
             "-master", murl, cli_fid], capture_output=True, timeout=120,
            env=env)
        check(down.returncode == 0 and
              down.stdout == _payload(seed + 2, 1, 3 << 20),
              f"download of {cli_fid}: {down.returncode}, "
              f"{len(down.stdout)} bytes, {down.stderr[-2000:]!r}")
        heartbeats = get("/cluster/status")["heartbeats"]
        crc_probe = _crc_probe()
    finally:
        if worker is not None:
            worker.stop()
        if admin is not None:
            admin.stop()
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"the master or a volume server did not stop "
                   f"cleanly: {bad}")
    write_ms = [w[3] for w in written]
    out = {"phase": "write", "servers": len(urls),
           "racks": list(WRITE_RACKS), "cuts": cuts,
           "cluster_start_seconds": start_s,
           "benchmark": {"ops": bench, "volumes_grown": len(bench_grown),
                         "host": host,
                         "every_read_its_bytes": True,
                         "kernel_launches": bench_launches},
           "replication": {"needles": len(acked), "seconds": repl_s,
                           "volumes": {k: sorted(v) for k, v in
                                       repl_vids.items()},
                           "every_replica_equal": True,
                           "stopped": second, "unacked_status": 500,
                           "master_drop_seconds": drop_s,
                           "assign_after_drop": handed},
           "fill": {"writers": FILL_WRITERS, "needles": len(written),
                    "in_first_volume": len(in_first), "bytes": fill_bytes,
                    "seconds": fill_s, "gbps": fill_bytes / fill_s / 1e9,
                    **_pcts(write_ms), "volume": first,
                    "volume_bytes": dat_size, "limit_bytes": limit_mb << 20},
           "encode": {"jobId": job["jobId"], "seconds": job["wall_s"],
                      "gbps": dat_size / job["wall_s"] / 1e9,
                      "launches": enc_launches, "expected_launches": expect,
                      "message": job["message"], "stages": job["stages"]},
           "read_back": {"readers": FILL_READERS, "needles": len(read_ms),
                         "bytes": fill_bytes, "seconds": read_s,
                         "gbps": fill_bytes / read_s / 1e9,
                         **_pcts(read_ms), "kernel_launches": read_launches},
           "cli": {"fid": cli_fid, "bytes": 3 << 20, "round_trip": True},
           "crc32c": crc_probe, "master_heartbeats": heartbeats}
    emit(out)
    return out


# --- phase 9 ---------------------------------------------------------------

_SAMPLE = re.compile(r"^seaweedfs_tpu_(\w+?)(?:\{([^}]*)\})? (\S+)$", re.M)


def _samples(text: str, name: str) -> "list[tuple[dict, float]]":
    """Every sample of metric `name` (without its namespace) on a
    Prometheus text page: (labels, value)."""
    out = []
    for m in _SAMPLE.finditer(text):
        if m.group(1) != name:
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2) or ""))
        out.append((labels, float(m.group(3))))
    return out


def _counters(urls) -> dict:
    """What the read passes read off each server's /metrics, summed over
    `urls`: kernel launches of both entries, degraded reads, source
    failovers, hot-needle cache hits and misses, and the lost intervals
    each host codec rebuilt ("engine/simd": count)."""
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    out = {"launches": 0.0, "degraded": 0.0, "failovers": 0.0,
           "hits": 0.0, "misses": 0.0, "engines": {}}
    for u in urls:
        text = http_bytes("GET", f"{u}/metrics", timeout=60)[1].decode()
        out["launches"] += sum(v for _, v in _samples(
            text, "gf_kernel_launches"))
        out["degraded"] += sum(v for _, v in _samples(
            text, "ec_degraded_reads_total"))
        out["failovers"] += sum(v for _, v in _samples(
            text, "ec_read_source_failovers_total"))
        for key, which in (("hits", "read_cache_hits_total"),
                           ("misses", "read_cache_misses_total")):
            out[key] += sum(v for lb, v in _samples(text, which)
                            if lb.get("cache") == "volume_needle")
        for lb, v in _samples(text, "ec_degraded_codec_intervals_total"):
            k = f"{lb.get('engine')}/{lb.get('simd')}"
            out["engines"][k] = out["engines"].get(k, 0.0) + v
    return out


def _delta(after: dict, before: dict) -> dict:
    out = {k: int(after[k] - before[k]) for k in after if k != "engines"}
    out["engines"] = {k: int(v - before["engines"].get(k, 0.0))
                      for k, v in after["engines"].items()
                      if v - before["engines"].get(k, 0.0)}
    return out


def _read_pass(murl: str, urls, items, seeds: dict, what: str,
               order=("small", "large")) -> dict:
    """Read `items` ((fid, nid, size, kind)) through `operation.read` on
    READ_C threads, every byte held against its payload (seeded by
    `seeds[kind]`); each kind ("small", "large") in a sub-pass of its
    own, in `order`, with its reads/s, GB/s, p50/p99/max ms and what the
    servers counted meanwhile.  Fails if the kernel was launched."""
    from seaweedfs_tpu_torch import operation
    from seaweedfs_tpu_torch.ops import rs_cuda
    out = {}
    for kind in order:
        todo = [it for it in items if it[3] == kind]

        def read_one(it):
            fid, nid, size, _ = it
            t = time.perf_counter()
            data = operation.read(murl, fid)
            ms = (time.perf_counter() - t) * 1e3
            check(data == _payload(seeds[kind], nid, size),
                  f"{what}: {fid} read {len(data)} bytes, not its payload")
            return ms
        before = _counters(urls)
        here = rs_cuda.LAUNCHES + rs_cuda.LAUNCHES_BATCHED
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            ms = list(pool.map(read_one, todo))
        wall = time.perf_counter() - t
        d = _delta(_counters(urls), before)
        d["launches"] += rs_cuda.LAUNCHES + rs_cuda.LAUNCHES_BATCHED - here
        check(d["launches"] == 0,
              f"{what} ({kind}): the reads launched the kernel "
              f"{d['launches']} times")
        nbytes = sum(it[2] for it in todo)
        out[kind] = {"reads": len(todo), "bytes": nbytes, "seconds": wall,
                     "reads_per_s": len(todo) / wall,
                     "gbps": nbytes / wall / 1e9, **_pcts(ms),
                     "degraded_reads": d["degraded"],
                     "cache_hits": d["hits"], "cache_misses": d["misses"],
                     "failovers": d["failovers"], "engines": d["engines"],
                     "kernel_launches": d["launches"]}
    return out


def phase_read_load(tmp: str, seed: int, n_small: int = READ_N,
                    limit_mb: int = WRITE_LIMIT_MB,
                    small_sample: int = READ_SMALL_SAMPLE,
                    large_sample: int = READ_LARGE_SAMPLE,
                    device: str = "cuda") -> dict:
    """BASELINE.json's config 5 through the port's front door: a `master
    -volumeSizeLimitMB 1024` subprocess and 4 `volume -max 8` subprocesses
    (their codec on `device`).  `n_small` 1 KiB files in `weed
    benchmark`'s shape (assign and upload on 16 threads) and config 1's
    needles on 8 writers, all in collection `rs63`, until the limit seals
    a volume; every volume of the collection encoded RS(6,3) by the
    port's shell; then six read passes on 16 threads, each a seeded
    sample of the 1 KiB files and of the large needles: all shards up
    (cold, then warm), the server with the most data shards stopped
    (degraded on the host's native codec, then warm), after `ec.rebuild`,
    after `ec.decode`.  Two deadline checks.  Launches are read as each
    server's wrapper counts on its /metrics."""
    import numpy as np

    from seaweedfs_tpu_torch import operation
    from seaweedfs_tpu_torch.ops import rs_native
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.storage import types
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext, to_ext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        _encode_work_items, rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes

    # the host codec of degraded reads, built here once: the servers
    # load the same library
    t = time.perf_counter()
    simd = rs_native.gf_native_simd()
    native_build_s = time.perf_counter() - t
    check(simd is not None, "the native host codec did not build: "
          f"{rs_native.native.BUILD_INFO.get('error')}")
    os.makedirs(tmp)
    dirs = [os.path.join(tmp, f"r{i}") for i in range(READ_SERVERS)]
    procs: list = []
    coll = READ_COLLECTION
    d, p = RS63
    ctx = ECContext(d, p, device="cpu")
    cuts = {"write_n": {"run": n_small, "reference_default": 1 << 20,
                        "why": "the run's time"},
            "servers": {"run": READ_SERVERS, "why": "one host, loopback"}}
    print(f"read_load phase: {n_small} files of 1 KiB (weed benchmark's "
          f"default 1,048,576, cut for the run's time)", flush=True)
    try:
        t0 = time.perf_counter()
        (murl,) = _start_procs(
            [["master", "-port", "0", "-volumeSizeLimitMB", str(limit_mb)]],
            [os.path.join(tmp, "master.log")], procs, "master")
        urls = _start_procs(
            [["volume", "-dir", dd, "-port", "0", "-mserver", murl,
              "-max", str(WRITE_MAX_VOLUMES), "-device", device]
             for dd in dirs], [dd + ".log" for dd in dirs], procs,
            "volume")
        proc_of = dict(zip(urls, procs[1:]))
        env = commands.CommandEnv(murl)

        def get(path):
            return http_json("GET", f"{murl}{path}", timeout=30)

        def poll(cond, what, timeout=60.0):
            deadline = time.monotonic() + timeout
            while not cond():
                check(time.monotonic() < deadline, f"timed out: {what}")
                time.sleep(0.05)

        def normal_vids():
            return {v["id"]: v for _n, v in
                    iter_volume_list_volumes(get("/vol/list"))
                    if v.get("collection", "") == coll}

        def ec_locs(vid):
            return {loc["url"]: loc["shardIds"] for loc in get(
                f"/dir/ec_lookup?volumeId={vid}").get(
                    "shardIdLocations", [])}
        poll(lambda: len(get("/cluster/status")["dataNodes"]) == len(urls),
             "4 volume servers registered")
        start_s = time.perf_counter() - t0

        # 1. weed benchmark's writes, 1 KiB each, seeded per file
        def write_small(i):
            body = _payload(seed + 3, i, BENCH_SIZE)
            t = time.perf_counter()
            a = operation.assign(murl, collection=coll)
            operation.upload(a.url, a.fid, body)
            return a.fid, i, len(body), (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            small = list(pool.map(write_small, range(n_small)))
        small_s = time.perf_counter() - t

        # 2. config 1's needles until the limit seals a volume
        frng = np.random.default_rng([seed, 9])
        counter = itertools.count(1)
        stop = threading.Event()
        large: list = []
        lock = threading.Lock()

        def writer():
            while not stop.is_set():
                with lock:
                    nid = next(counter)
                    size = int(frng.integers(256 << 10, 4 << 20))
                body = _payload(seed + 4, nid, size)
                t = time.perf_counter()
                fid = operation.submit(murl, body, collection=coll)
                ms = (time.perf_counter() - t) * 1e3
                with lock:
                    large.append((fid, nid, size, ms))

        def sealed():
            return any(v["size"] >= limit_mb << 20
                       for v in normal_vids().values())
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            futs = [pool.submit(writer) for _ in range(FILL_WRITERS)]
            try:
                while not any(f.done() for f in futs) and not sealed():
                    time.sleep(0.2)
            finally:
                stop.set()
            for f in futs:
                f.result()
        fill_s = time.perf_counter() - t
        fill_bytes = sum(w[2] for w in large)
        vols = normal_vids()

        def sizes_seen():
            seen = {vid: (v["size"], [os.path.getsize(os.path.join(
                dirs[urls.index(loc["url"])], f"{coll}_{vid}.dat"))
                for loc in operation.lookup(murl, vid, use_cache=False)])
                for vid, v in normal_vids().items()}
            return all(want == [got] for got, want in seen.values())
        poll(sizes_seen, "the master sees every volume's size")
        vols = normal_vids()
        check(any(v["size"] >= limit_mb << 20 for v in vols.values()),
              f"no volume of {coll} reached the limit: {vols}")

        # 3. every volume of the collection encoded RS(6,3) on the card
        def launches_on_all():
            return _counters(urls)["launches"]
        encode = {}
        for vid in sorted(vols):
            size = vols[vid]["size"]
            expect = sum(launches_for(d, item[3])
                         for item in _encode_work_items(size, ctx))
            before = launches_on_all()
            t = time.perf_counter()
            out = commands.run_script(
                env, f"lock; ec.encode -volumeId={vid} -collection={coll} "
                     f"-dataShards={d} -parityShards={p}; unlock")
            wall = time.perf_counter() - t
            got = int(launches_on_all() - before)
            check("scatter-encoded 9 shards" in out[1], f"encode: {out}")
            check(got == expect, f"volume {vid}'s encode launched {got}, "
                                 f"the windows of its work list are "
                                 f"{expect}")
            encode[vid] = {"bytes": size, "seconds": wall,
                           "gbps": size / wall / 1e9, "launches": got,
                           "expected_launches": expect, "output": out[1]}
        poll(lambda: not normal_vids() and all(
            sorted(s for sids in ec_locs(v).values() for s in sids) ==
            list(range(d + p)) for v in vols),
            "every volume's 9 shards listed and the volumes gone")
        placement = {v: ec_locs(v) for v in sorted(vols)}
        operation._vid_cache = operation.VidCache()

        # 4. the read passes
        rng = np.random.default_rng([seed, 11])

        def sample(exclude=frozenset()):
            s_idx = [i for i in rng.permutation(len(small))
                     if small[i][0] not in exclude][:small_sample]
            l_idx = [i for i in rng.permutation(len(large))
                     if large[i][0] not in exclude][:large_sample]
            return [(*small[i][:3], "small") for i in s_idx] + \
                [(*large[i][:3], "large") for i in l_idx]

        seeds = {"small": seed + 3, "large": seed + 4}
        # a cold pass reads the large needles first and a warm pass
        # reads the 1 KiB files first: the large ones outgrow the 64 MiB
        # memory tier, and would evict the 1 KiB files the warm pass
        # counts on
        cold_first = ("large", "small")

        def run(items, what, live, order=("small", "large")):
            return _read_pass(murl, live, items, seeds, what, order)
        passes = {}
        a = sample()
        passes["cold"] = run(a, "cold", urls, cold_first)
        passes["warm"] = run(a, "warm", urls)
        check(passes["cold"]["small"]["degraded_reads"] == 0 and
              passes["warm"]["small"]["cache_hits"] == len(
                  [x for x in a if x[3] == "small"]),
              f"all shards up: {passes['cold']['small']} then "
              f"{passes['warm']['small']}")

        # the server with the most data shards goes away
        data_held = {u: sum(1 for v in placement for s in
                            placement[v].get(u, []) if s < d)
                     for u in urls}
        victim = max(urls, key=lambda u: data_held[u])
        check(all(len(placement[v].get(victim, [])) <= p
                  for v in placement),
              f"{victim} holds more than {p} shards of a volume")
        bad = _stop_peers([proc_of[victim]])
        check(not bad, f"{victim} did not stop: {bad}")
        t = time.perf_counter()
        poll(lambda: victim not in get("/cluster/status")["dataNodes"] and
             all(victim not in ec_locs(v) for v in placement),
             "the master drops the stopped server")
        drop_s = time.perf_counter() - t
        live = [u for u in urls if u != victim]
        operation._vid_cache = operation.VidCache()
        b = sample(exclude={x[0] for x in a})
        passes["degraded"] = run(b, "degraded", live, cold_first)
        passes["degraded_warm"] = run(b, "degraded_warm", live)
        deg, warm = passes["degraded"], passes["degraded_warm"]
        n_b_small = len([x for x in b if x[3] == "small"])
        for kind in ("small", "large"):
            eng = deg[kind]["engines"]
            check(sum(eng.values()) == deg[kind]["degraded_reads"] and
                  all(k.startswith("native/") for k in eng),
                  f"degraded ({kind}): {deg[kind]['degraded_reads']} "
                  f"degraded reads, rebuilt by {eng}: not all native")
        check(deg["small"]["degraded_reads"] > 0 and
              deg["large"]["degraded_reads"] > 0,
              f"the stopped server's loss made no degraded read: {deg}")
        check(warm["small"]["degraded_reads"] == 0 and
              warm["small"]["cache_hits"] == n_b_small,
              f"the promoted 1 KiB decodes: {warm['small']}")

        # the deadline checks, while the server is down
        from seaweedfs_tpu_torch.util import deadline as dl
        x = b[0]
        reader = operation.lookup(murl, types.parse_file_id(
            x[0]).volume_id, use_cache=False)[0]["url"]
        before = _counters([reader])
        st, _body, hdrs = http_bytes("GET", f"{reader}/{x[0]}", timeout=60,
                                     headers={dl.HEADER: "0"})
        spent = _delta(_counters([reader]), before)
        text = http_bytes("GET", f"{reader}/metrics")[1].decode()
        exceeded = sum(v for lb, v in _samples(
            text, "deadline_exceeded_total")
            if lb.get("site") == "volume.ingress")
        check(st == 504 and hdrs.get("Retry-After") == "1" and
              spent["hits"] == spent["misses"] == 0 and exceeded >= 1,
              f"a spent budget: {st} {hdrs}, {spent}")

        def remaining_obs(u):
            text = http_bytes("GET", f"{u}/metrics")[1].decode()
            got = {"sum": 0.0, "count": 0.0}
            for key in got:
                got[key] = sum(v for lb, v in _samples(
                    text, f"deadline_remaining_seconds_{key}")
                    if lb.get("site") == "volume")
            return got
        seen = {x[0] for x in a} | {x[0] for x in b}
        forwarded = None
        for fid, _nid, _size, _ms in small:
            if fid in seen:
                continue
            vid = types.parse_file_id(fid).volume_id
            reader = operation.lookup(murl, vid)[0]["url"]
            holders = [u for u in ec_locs(vid) if u != reader]
            obs0 = {u: remaining_obs(u) for u in [reader] + holders}
            deg0 = _counters([reader])["degraded"]
            st, _body, _ = http_bytes("GET", f"{reader}/{fid}", timeout=60,
                                      headers={dl.HEADER: "30000"})
            check(st == 200, f"a budgeted read of {fid}: {st}")
            if _counters([reader])["degraded"] == deg0:
                continue
            obs = {u: {k: remaining_obs(u)[k] - obs0[u][k]
                       for k in ("sum", "count")} for u in obs0}
            given = obs[reader]["sum"]
            shard_reads = {u: o for u, o in obs.items()
                           if u != reader and o["count"]}
            check(obs[reader]["count"] == 1 and shard_reads and all(
                o["sum"] / o["count"] < given
                for o in shard_reads.values()),
                f"a degraded read under 30 s: the reader got {given} s, "
                f"its shard reads {shard_reads}")
            forwarded = {"fid": fid, "reader_remaining_s": given,
                         "shard_reads": {u: o["sum"] / o["count"] for u, o
                                         in shard_reads.items()}}
            break
        check(forwarded is not None, "no unsampled 1 KiB needle read "
                                     "degraded")

        # 5. ec.rebuild of what the server held
        rebuild = {}
        for vid in sorted(placement):
            lost = placement[vid].get(victim, [])
            if not lost:
                continue
            holder = next(iter(ec_locs(vid)))
            shard_size = int(http_json(
                "GET", f"{holder}/admin/ec/info?volumeId={vid}",
                timeout=30)["shardSize"])
            step = rebuild_step(shard_size, ctx, rebuild_slice_bytes())
            expect = sum(launches_for(d, min(step, shard_size - pos))
                         for pos in range(0, shard_size, step))
            before = _counters(live)["launches"]
            t = time.perf_counter()
            out = commands.run_script(
                env, f"lock; ec.rebuild -volumeId={vid} "
                     f"-collection={coll}; unlock")
            wall = time.perf_counter() - t
            got = int(_counters(live)["launches"] - before)
            check(f"rebuilt shards {sorted(lost)} on " in out[1],
                  f"rebuild of {vid}: {out}")
            check(got == expect, f"volume {vid}'s rebuild launched {got}, "
                                 f"the windows of its steps are {expect}")
            rebuild[vid] = {"lost": sorted(lost), "seconds": wall,
                            "launches": got, "expected_launches": expect,
                            "output": out[1]}
        poll(lambda: all(sorted(s for sids in ec_locs(v).values()
                                for s in sids) == list(range(d + p))
                         for v in placement), "9 shards listed again")
        # each reader asks the master again (an unmount of no shard
        # drops its cached locations and its cached needles)
        for u in live:
            for vid in placement:
                http_json("POST", f"{u}/admin/ec/unmount",
                          {"volumeId": vid, "shardIds": []}, timeout=30)
        c = sample(exclude={x[0] for x in a} | {x[0] for x in b})
        passes["rebuilt"] = run(c, "rebuilt", live)
        check(passes["rebuilt"]["small"]["degraded_reads"] ==
              passes["rebuilt"]["large"]["degraded_reads"] == 0,
              f"degraded reads after the rebuild: {passes['rebuilt']}")

        # 6. ec.decode back to normal volumes
        decode = {}
        for vid in sorted(placement):
            t = time.perf_counter()
            out = commands.run_script(
                env, f"lock; ec.decode -volumeId={vid} "
                     f"-collection={coll}; unlock")
            decode[vid] = {"seconds": time.perf_counter() - t,
                           "output": out[1]}
            check("decoded to normal volume" in out[1],
                  f"decode of {vid}: {out}")
        poll(lambda: set(normal_vids()) == set(placement) and
             not any(ec_locs(v) for v in placement),
             "the volumes listed again and no shard left")
        left = [f for dd, u in zip(dirs, urls) if u != victim
                for f in os.listdir(dd)
                if any(f.endswith(to_ext(i)) for i in range(d + p))]
        check(not left, f"shard files left after the decode: {left}")
        operation._vid_cache = operation.VidCache()
        e = sample(exclude={x[0] for x in a} | {x[0] for x in b} |
                   {x[0] for x in c})
        passes["decoded"] = run(e, "decoded", live)
        check(passes["decoded"]["small"]["degraded_reads"] ==
              passes["decoded"]["large"]["degraded_reads"] == 0,
              f"degraded reads after the decode: {passes['decoded']}")
        heartbeats = get("/cluster/status")["heartbeats"]
    finally:
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"the master or a volume server did not stop "
                   f"cleanly: {bad}")
    write_ms = [w[3] for w in small]
    fill_ms = [w[3] for w in large]
    out = {"phase": "read_load", "servers": READ_SERVERS,
           "scheme": f"RS({d},{p})", "collection": coll, "cuts": cuts,
           "cluster_start_seconds": start_s,
           "native_codec": {"simd": simd, "build_seconds": native_build_s,
                            **{k: v for k, v in
                               rs_native.native.BUILD_INFO.items()
                               if k in ("march_native", "error")}},
           "writes": {"files": len(small), "bytes": len(small) * BENCH_SIZE,
                      "seconds": small_s,
                      "writes_per_s": len(small) / small_s,
                      **_pcts(write_ms)},
           "fill": {"writers": FILL_WRITERS, "needles": len(large),
                    "bytes": fill_bytes, "seconds": fill_s,
                    "gbps": fill_bytes / fill_s / 1e9, **_pcts(fill_ms),
                    "volumes": {v: x["size"] for v, x in vols.items()},
                    "limit_bytes": limit_mb << 20},
           "encode": encode, "placement": placement,
           "stopped": {"url": victim, "data_shards": data_held[victim],
                       "master_drop_seconds": drop_s},
           "passes": passes, "rebuild": rebuild, "decode": decode,
           "deadline": {"spent_budget_status": 504,
                        "forwarded": forwarded},
           "launches": {"encode": sum(x["launches"]
                                      for x in encode.values()),
                        "rebuild": sum(x["launches"]
                                       for x in rebuild.values()),
                        "reads": sum(pp[k]["kernel_launches"]
                                     for pp in passes.values()
                                     for k in pp)},
           "master_heartbeats": heartbeats}
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--volume-gib", type=float, default=1.0,
                    help="size of the seeded volume to encode (GiB)")
    ap.add_argument("--batch-gib", type=float, default=1.0,
                    help="total .dat size of the 64-volume batch (GiB)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-only", action="store_true",
                    help="run the device and kernel phases only (no main "
                         "path, no result line)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = nvidia_smi()
    phase_device(smi)
    kern = phase_kernel(args.seed)
    if args.kernel_only:
        print(smi, flush=True)
        return 0
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ec, ec_state = phase_ec(args.volume_gib, args.seed,
                                os.path.join(work, "ec"))
        remote = phase_remote(ec_state, os.path.join(work, "remote"))
        cluster = phase_cluster(ec_state, os.path.join(work, "cluster"))
        batch, batch_state = phase_batch(args.batch_gib, args.seed,
                                         os.path.join(work, "batch"))
        worker = phase_worker(ec_state, batch_state,
                              os.path.join(work, "worker"))
        write = phase_write(os.path.join(work, "write"), args.seed)
        read_load = phase_read_load(os.path.join(work, "read_load"),
                                    args.seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = []
    for kind, name, replaces, by_path in (
            ("single", "gf_apply_words", "seaweedfs_tpu/ops/rs_pallas.py:33",
             {"ec": ec["main_path_launches"],
              "scatter": remote["scatter"]["launches"],
              "streamed_rebuild": remote["rebuild"]["launches"],
              "shell_encode": cluster["encode"]["launches"],
              "shell_rebuild": cluster["rebuild"]["launches"],
              "cluster_reads": sum(r["kernel_launches"] for r in
                                   cluster["reads"].values()
                                   if "kernel_launches" in r),
              "worker_encode": worker["encode"]["launches"],
              "worker_rebuild": worker["rebuild"]["launches"],
              "worker_scatter": worker["scatter"]["launches"],
              "write_encode": write["encode"]["launches"],
              "write_reads": write["read_back"]["kernel_launches"],
              "rs63_encode": read_load["launches"]["encode"],
              "rs63_rebuild": read_load["launches"]["rebuild"],
              "rs63_reads": read_load["launches"]["reads"]}),
            ("batched", "gf_apply_words_batched",
             "seaweedfs_tpu/parallel/ec_sharded.py:157",
             {"batch": batch["batched_launches"],
              "worker_batch": worker["batch"]["launches"]})):
        case = kern["main"][kind]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/gf_apply.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": kern["max_abs_err"][kind],
            "ms": case["rotated_ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bytes_bound_ms"], "bound_by": "bytes",
            "library_ms": None, "matched": True,
            "same_buffer_ms": case["ms"], "copy_ms": case["copy_ms"],
            "issue_floor_ms": case["issue_floor_ms"],
            "stream_gbps": kern["stream_gbps"],
            "resident_blocks_per_sm":
                case["launch"]["resident_blocks_per_sm"],
            "waves": case["launch"]["waves"],
            "shape": f"[{case['V']},{case['R']},{case['K']}] x "
                     f"{case['words']} words"})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
