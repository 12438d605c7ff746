#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`seaweedfs_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--volume-gib 1.0] [--batch-gib 1.0] [--seed 0]

Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the seconds the kernel build took (the CUDA sources in
   seaweedfs_tpu_torch/csrc are compiled with nvcc at first use); the
   host libraries the servers load (the native CRC32-C, the volume read
   and write planes, the filer's meta and read planes,
   seaweedfs_tpu_torch/native) built with g++, once, before any server
   starts: one that does not build fails.
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
   2,048 for the run's time, printed), every read held against the
   payload, and the volumes the assigns grew; 128 seeded needles of
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
   and read-back GB/s and p50/p99, the job's wall and stages.  The
   native planes: both ports non-zero in every server's `/status`; the
   planes' counters off every `/metrics` (native writes and reads, write
   fallbacks, reads on the Python port, the write plane's ack p50/p99)
   for the benchmark, the fill and the phase; at least 90% of the
   benchmark's writes (all to volumes of replication 000) acked by the
   write plane and some of its reads served by the read plane; the
   servers' CRC32-C engine, which must be `sse4.2`.  About 3x the volume
   written.

9. read_load: BASELINE.json's config 5, "RS(6,3) alt scheme +
   streaming ec.decode read path under weed benchmark load", through
   the front door of the port's own cluster: a `master
   -volumeSizeLimitMB 1024` subprocess and 4 `volume -max 8`
   subprocesses (their codec on the card).  2,048 files of 1 KiB in
   `weed benchmark`'s shape (assign and upload on 16 threads; n cut from
   1,048,576 for the run's time) and config 1's needles on 8 writers, all
   in collection `rs63`, until the 1 GiB limit seals a volume; every
   volume of the collection `ec.encode -dataShards=6 -parityShards=3`
   through the port's shell (launches, read off each server's
   /metrics, against the sum of `launches_for` over its batches).  Six
   read passes on 16 threads, each a seeded sample of 512 of the 1 KiB
   files and 32 of the large needles, every byte compared: all shards
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
   the holders).  The native planes as in the write phase: both ports up
   on every server, the planes' counters for the writes, the fill (some
   of it acked by the write plane: the master's default replication is
   000) and each read pass, and the CRC32-C engine `sse4.2`.

10. filer: the port's filer (`python3 -m seaweedfs_tpu_torch filer
   -metaPlane 0`, the sqlite store, every mutation committed
   synchronously, no native plane) over a `master
   -volumeSizeLimitMB 1024` subprocess and 3 `volume -max 8` subprocesses
   (their codec on the card), collection `filer`.  Through the filer's
   HTTP API: 2,048 files of 1 KiB in 64 directories on 16 threads (`weed
   benchmark`'s shape, n cut), 16 files of 8-24 MiB (2-6 chunks) and
   config 1's needles on 8 writers until a 1 GiB volume seals (files/s,
   GB/s, p50/p99); 1,024 chunkless creates, 1,024 lookups and a listing of
   every directory (ops/s).  Every sealed volume `ec.encode`d RS(10,4) by
   the port's shell (launches, read off the servers' /metrics, against
   its work list's windows).  Four read passes on 16 threads, each a
   seeded sample of 512 1 KiB files, 32 large needles and 8 multi-chunk
   files, every body held to its SHA-256, plus a range across every chunk
   boundary of the multi-chunk files and a listing of every directory:
   all servers up, cold and again warm (every 1 KiB read a hit of the
   filer's chunk cache); the server holding the most data shards of
   those that hold at most 4 of a volume stopped (degraded reads, each
   rebuilt on the host's native codec); after `ec.rebuild` on the card
   (launches against its steps' windows, no degraded read).  Each pass:
   reads/s, p50/p99/max ms, GB/s, degraded reads, the filer's meta- and
   chunk-cache hits and 0 launches.  Then an overwrite of a multi-chunk
   file (its old chunks no longer readable from their volumes), a
   recursive delete of a directory (its chunks gone, a non-recursive
   delete of its parent answered 409) and `fs.ls` / `fs.du` through the
   port's shell, held to the namespace.  The filer's group commits' mean
   batch at the store and the metalog.
11. filer_plane: the same cluster with the filer in its default
   configuration (no `-metaPlane` flag: the meta plane over sqlite, the
   metalog its WAL, and the native meta and read planes armed; both
   ports on /status must be non-zero).  Clients find the planes' ports
   on /status, one probe a thread, and send PUTs to the meta plane and
   GETs to the read plane first, replaying a plane's 404 on the Python
   port inside the same latency sample.  2,048 files of 1 KiB in 64
   directories on 16 threads (the meta plane must ack more than half),
   16 files of 8-24 MiB (too large for the plane: every one falls back)
   and config 1's needles until a 1 GiB volume seals; the overlay must
   drain to 0 and the checkpoint reach the log's last event.  A warm
   pass of 512 1 KiB files (the read plane must serve more than half);
   every sealed volume `ec.encode`d RS(10,4) on the card (launches
   against its windows); the filer phase's passes (cold, warm, the
   server with the most data shards stopped, after `ec.rebuild`, whose
   launches match its steps' windows), each body held to its SHA-256,
   with the read plane's share, fallbacks, stale and upstream misses and
   stage split.  Then the filer is restarted with
   `SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS=600000` (its applier lags),
   1,024 files are written, the filer is SIGKILLed and restarted with
   the default tick, every acked file reads back equal, and the overlay
   and checkpoint drain again.  Printed: files/s and p50/p99 of the
   writes and each pass, the meta plane's share of acked writes, its
   fallbacks, its ack p50/p99 (upper bucket bounds of its histogram) and
   its stage split (parse, upload, wal); `filer_meta_sub_seconds`
   (serialize, barrier, apply); the metalog's mean group-commit batch;
   and the launches, 0 in every read pass.
12. fsync_tier: config 1 on the `-fsync` tier.  A `master
   -volumeSizeLimitMB 1024 -defaultReplication 001`, 3 `volume -max 8
   -fsync` subprocesses in one rack (every needle has two locations;
   their directories on a disk filesystem, its type and one writer's
   fsync rate printed: a tmpfs work directory moves the phase under the
   checkout's gitignored `_work/`) and a filer in its default
   configuration, which follows the master's location pushes.  Writes:
   `weed benchmark`'s shape (1 KiB, 16 threads, n cut to 2,048) at 001,
   the same shape at 000 (1,024: the write plane parks each ack until
   the epoch handshake ran the volume's barrier), 512 1 KiB needles
   and config 1's needles into one volume until it seals; writes/s,
   p50/p99, the native share, the epochs, the barrier's mean batch and
   fsyncs per ack.  A holder of the sealed
   volume SIGKILLed right after the last ack and restarted on its
   directory and port; two passes over every second acked needle of
   each kind, each read from every one of its replicas, the restarted
   server among them, through each location's ladder (read plane, UDS,
   HTTP), every
   body equal to its seeded payload, with each plane's share.  2,048
   benchmark reads under a 100 ms deadline: a warm pass of 1,024 with
   every replica up, then the replica that is their first location
   SIGSTOPped for a pass hedging on (the token pool's burst set to the
   pass's size and the hedge workers' cap to 256; 0 reads may miss the
   budget; the client's full collections in the pass are counted) and
   one with
   `SEAWEEDFS_TPU_HEDGE_READS=0`.  The filer's `/dir/lookup` RPCs during
   two read passes of 1,024 1 KiB files (the master's `/metrics`), and the seconds until its pushed map drops the
   killed server, holds it again, and holds a grown volume.
   `ec.encode` of the sealed volume on the card (launches against its
   windows; shard SHA-256s equal to the host's native codec's on the
   same `.dat`), then its 1 KiB needles read back with 0 launches.
13. secure_s3: a secured cluster as `security.toml` configures it, with
   the S3 gateway on it.  Certificates minted at the phase's start
   (`tls.generate_cluster_certs`, or the `openssl` command where the
   `cryptography` package is missing, which the phase prints); a
   security.toml with a write key (10 s tokens), a read key, an admin
   key and `[tls] mtls = true`; a `master -volumeSizeLimitMB 1024`, 3
   `volume -max 8` subprocesses, a filer in its default configuration
   and `s3 -filer` with `-iamConfig` identities `admin` (Admin) and
   `reader` (Read, List), each under `-securityToml`, and this client
   configured from the same file (it dials https with its certificate
   and signs as the roles do).  The volume servers and the filer run
   with `SEAWEEDFS_TPU_READ_CACHE_MB=0`, so every read pass reaches the
   volumes.  Through the gateway, as `admin`, on 16 threads: 256
   objects of 4 KiB over 4 buckets (half in the first, so its listing
   pages), 8 of 10 MiB (warp's default object size), one multipart
   upload of 64 MiB in 8 MiB parts, 16 streaming-chunked PUTs of 1 MiB
   and, with `cryptography`, 16 SSE-C PUTs of 64 KiB.  The volume holding
   the most of the objects' chunks is filled with config 1's needles,
   each signed with its fid's write JWT, until the 1 GiB limit seals it;
   `ec.encode` of it on the card through the port's shell over mTLS with
   the admin JWT (launches against its windows; shard SHA-256s equal to
   the host's native codec on the same `.dat`).  Every object read back
   as `reader`, each body its seeded payload, and ListObjectsV2 paged at
   1,000 listing every key (0 launches).  Refusals, each checked:
   `reader`'s PUT (403 AccessDenied), an unsigned GET (403), a
   plain-text request to every listener, a TLS client without a
   certificate at every listener, a volume GET without a read JWT (401),
   a volume POST with another fid's token (401), admin paths and a
   heartbeat without the admin JWT (401), and no plane port open (the
   stand-downs counted on `/metrics`).  The server with the most data
   shards of those holding at most 4 stopped; the encoded objects read
   degraded (the host's native codec); `ec.rebuild` on the card
   (launches against its steps' windows); the objects read again with
   no degraded read.  Then a second cluster without security.toml: 1,024
   objects of 4 KiB PUT and GET through its gateway, and the volume
   planes' shares.  PUT and GET objects/s, MB/s and p50/p99 of each
   size, the multipart wall, the launches and the phase's seconds.
14. filer_fleet: the filer fleet.  A `master -volumeSizeLimitMB 1024`,
   3 `volume -max 8` subprocesses and the filer in its default
   configuration over one sqlite store, run three ways (each an arm of
   16 client threads on the shared port, the read caches off): 1
   process on the threaded front, `-workers 4` (a pre-fork fleet on one
   port, SO_REUSEPORT) and `-workers 4` on the asyncio front
   (`SEAWEEDFS_TPU_ASYNC_FRONT=filer`).  Each arm POSTs 512 files of
   1 KiB and 64 of 64 KiB and GETs them back (files/s, p50/p99).  In
   the fleets: each sibling's view on one keep-alive connection (the
   write track's stage shares, a GET's and a POST's CPU share of its
   wall, the flight records, the plane drains' records against the
   planes' requests after a plane-first pass, the process tree), the
   sampler on every sibling during the GETs with the folded stacks
   merged, `cluster.top` once, and a sibling SIGKILLed under load: every
   acked file reads back equal at once and the parent respawns it.  The
   volume holding the most of the files is filled with config 1's
   needles to the 1 GiB seal and `ec.encode`d on the card (launches
   against its windows; shards equal to the host codec's); data shards
   1, 4, 7 and 9 deleted; every file read degraded through the fleet (0
   launches); `ec.rebuild` on the card (launches against its steps'
   windows); every file read again.
15. qos_chaos: the QoS plane, the fault sites and the retry policy.  A
   master, 7 `volume` servers and a filer under one `-securityToml` that
   carries only `[qos]`; 16 threads of 1 KiB GETs over 2,048 files for
   the whole phase.  Volume A (1 GiB) `ec.encode`d with the SLO at 0,
   volume B with the SLO at half the source's throttle signal during A's
   encode (the SLO loop must pace its windows); A's shards 1, 4, 7 and 9
   rebuilt on the card through donors armed to truncate (a failover, the
   shards equal); volumes C and D (128 MiB) scattered with a dropped and a
   truncated destination (re-planned, nothing on the victim, the short
   commit refused); lookups through counted retries; a noisy tenant at
   twice its rate (503 with Retry-After) while the anonymous foreground
   sees none.  Launches against windows in every encode and rebuild.
16. maintenance: the volume maintenance plane.  A master, 4 `volume`
   servers, the admin and a worker with `-capabilities erasure_coding,
   vacuum,volume_balance,ec_balance`, all subprocesses, on 2 racks (4
   and 3 servers at the end).  Volume A filled to 1 GiB with config 1's
   needles, 8 small volumes of 1 KiB needles, 40% of A's bytes deleted;
   the vacuum job that detection proposes, under 4 threads writing and
   deleting in A (every acked needle read back over HTTP and the read plane, every
   deleted one 404, the `.dat` shrunk by 95% of the deleted bytes at
   least, the `.idx` entries replayed counted); A's `ec.encode` by the
   worker's job on the source's card (launches against the compacted
   `.dat`'s windows, parity equal to the host codec's); 3 more servers,
   then the `ec_balance` and `volume_balance` jobs (at most ceil(14 / 7)
   of A's shards a server, which leaves the ec_balance detection nothing
   to propose, and a volume count spread of at most 2); a server
   with 2 of A's shards stopped and `ec.rebuild` on the card (launches
   against its [2,10] windows, the shards equal, every needle read back);
   `volume.check.disk` on a 001 volume one replica lost needles of,
   `volume.fix.replication` after that replica's server stopped, and a
   `volume.scrub` with no error.
17. master_ha: the master's raft and the SLO autopilot.  3 `master
   -peers m1,m2,m3 -mdir D`, 4 `volume -mserver m1,m2,m3`, a filer in
   its default configuration, the admin and a worker with
   `-capabilities erasure_coding`, all subprocesses.  One leader within
   5 s, named by every master, followers answering /dir/assign 503 with
   the hint, `cluster.raft.ps` with commit = applied; volume A (1 GiB,
   config 1's needles) filled through a seed list with a follower first
   and 512 1 KiB files through the filer; A's `ec.encode` by the
   worker's job with the leader SIGKILLed once A's server launches the
   kernel (a new leader, the kill-to-assign gap, launches against A's
   windows, parity equal, 14 shards listed within 3 pulses); 256 assigns
   above every key issued before the kill, no held vid grown again; the
   killed master back as a follower, A's largest shard holder (of those
   with no filer file) SIGKILLed, `ec.rebuild` on the card (launches
   against its windows, shards equal, A read back); a leader transfer to
   a named follower that the filer's follow stream names within 2 s,
   under 1 KiB reads that all answer 200 and equal; all three masters
   restarted on their -mdir (the topologyId kept, 256 assigns above every
   key, the servers registered again); the autopilot's knobs and guards,
   and the filer's read plane disarmed by its guard when the server of
   some files is down and re-armed once it is back.

`--kernel-only` runs phases 1 and 2 alone and prints no result line.
Then a `kernels` line, the card's name and power limit, and the device
line.  Exits non-zero, with no result, when there is no CUDA device or
the package is not beside this script; any failed check fails the run.
The script is the subreaper of every process it starts, and a phase
that leaves one running fails (the process killed and named).
"""

from __future__ import annotations

import argparse
import functools
import gc
import hashlib
import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
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
BENCH_N = 2_048
BENCH_SIZE = 1024                # weed benchmark's file size and
BENCH_C = 16                     # concurrency (seaweedfs_tpu/benchmark.py)
REPLICATED = 128                 # seeded needles under each of 001 and 010
FILL_WRITERS = 8
FILL_READERS = 8
SPIN_CYCLES = 10_000_000         # ~5 ms of device spin ahead of a timed run
# read_load: BASELINE.json's config 5, "RS(6,3) alt scheme + streaming
# ec.decode read path under weed benchmark load"
RS63 = (6, 3)
READ_SERVERS = 4
READ_COLLECTION = "rs63"
READ_N = 2_048                   # 1 KiB files, cut from weed benchmark's
READ_SMALL_SAMPLE = 512          # 1,048,576; sampled per read pass
READ_LARGE_SAMPLE = 32           # config 1's needles sampled per pass
READ_C = 16                      # weed benchmark's concurrency
# filer and filer_plane: the port's filer (sqlite store; synchronous
# commit, then its default planes) over volumes that ec.encode encodes on
# the card
FILER_SERVERS = 3
FILER_COLLECTION = "filer"
FILER_N = 2_048                  # 1 KiB files through the filer (weed
FILER_DIRS = 64                  # benchmark's shape, n cut), in 64 dirs
FILER_MULTI = 16                 # files of 8-24 MiB: 2-6 chunks each
FILER_META_N = 1_024             # chunkless creates, then lookups
FILER_SMALL_SAMPLE = 512         # 1 KiB files read per pass, and
FILER_LARGE_SAMPLE = 32          # config 1's needles (read_load's)
FILER_MULTI_SAMPLE = FILER_MULTI // 3   # three fresh samples of 5
FILER_CRASH_N = 1_024            # filer_plane: files written, then SIGKILL


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def poll(cond, what: str, timeout: float = 60.0,
         interval: float = 0.05) -> None:
    """Wait until cond() holds; fail the run after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out: {what}")
        time.sleep(interval)


PR_SET_CHILD_SUBREAPER = 36      # prctl(2)


def adopt_orphans() -> None:
    """Make this process the subreaper of every process it starts: one
    whose parent exits (a filer sibling whose parent is gone) is
    re-parented here, not to init, so `sweep_children` still sees it."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _own_children() -> "list[tuple[int, bytes, str]]":
    """This process's children, each (pid, state, command line)."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", "rb") as f:
                parts = f.read().rsplit(b") ", 1)[1].split()
            if int(parts[1]) != me:
                continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, IndexError, ValueError):
            continue
        out.append((int(d), parts[0], cmd.strip()))
    return out


def sweep_children() -> "list[str]":
    """Every process a phase started must be gone when it ends: reap
    this process's exited children, and SIGKILL and reap the live ones
    (rounds until none is left, for what a killed one leaves
    re-parented here).  The live ones found, described."""
    left: "list[str]" = []
    for _ in range(10):
        kids = _own_children()
        if not kids:
            break
        for pid, state, cmd in kids:
            if state not in (b"Z", b"X"):
                left.append(f"pid {pid} ({state.decode()}): {cmd[:300]}")
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
    return left


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

    from seaweedfs_tpu_torch import native
    from seaweedfs_tpu_torch.ops import _build, rs_cuda

    def build_kernel() -> float:
        t0 = time.perf_counter()
        _build.load(rs_cuda.SOURCE)
        return time.perf_counter() - t0
    # nvcc runs beside the g++ builds of the host libraries the volume
    # servers and the filer load (the needle CRC32-C, the volume read and
    # write planes, the filer's meta and read planes), all built here once
    # before any server starts; one that does not build fails the run
    host_libs = {}
    with ThreadPoolExecutor(1) as pool:
        kernel_build = pool.submit(build_kernel)
        for stem, load in (("crc32c", native.load_crc32c),
                           ("read_plane", native.load_read_plane),
                           ("write_plane", native.load_write_plane),
                           ("meta_plane", native.load_meta_plane),
                           ("filer_read_plane",
                            native.load_filer_read_plane)):
            check(load() is not None, f"native {stem} did not build: "
                  f"{native.BUILD_INFO[stem].get('error')}")
            host_libs[stem] = {k: native.BUILD_INFO[stem].get(k)
                               for k in ("seconds", "march_native")}
        build_s = kernel_build.result()
    # the -fsync tier's epoch handshake: without it the write plane takes
    # no -fsync volume
    check(native.load_write_plane().epoch_handshake,
          "the write plane does not bind the epoch handshake")
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
           "kernel_build_seconds": build_s, "host_libraries": host_libs,
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
                 procs: list, role: str, line: "str | None" = None,
                 env_extra: "dict | None" = None, log_mode: str = "w"
                 ) -> "list[str]":
    """`python3 -m seaweedfs_tpu_torch <argv>` for each argv (with
    `env_extra` in its environment), all started together and appended
    to `procs` as they start (the caller stops them), stderr to its log
    (opened with `log_mode`); returns the group of `line` (a regex; by
    default `<role> server listening on <url>`, the url) once each has
    printed its first line (120 s), and fails if one does not."""
    line = line or rf"{role} server listening on (\S+:\d+)\n"
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo, **(env_extra or {}))
    started = []
    for argv, log in zip(argvs, logs):
        with open(log, log_mode) as err:
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
    measured = (rs_cuda.LAUNCHES - launches[0]) + \
        (rs_cuda.LAUNCHES_BATCHED - launches[1])
    check(measured == 0, f"{what}: the reads launched the kernel "
                         f"{measured} times")
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
            "kernel_launches": measured}


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
print(json.dumps({"path": crc.engine(), "gbps": 4 * len(buf) / s / 1e9}))
"""


def _crc_probe() -> dict:
    """Which CRC32-C the volume servers compute a needle's checksum with
    (`crc.engine()` in the same interpreter and path as `_start_procs`
    gives them: google_crc32c, sse4.2, sw or numpy), and its rate on one
    core over a 4 MiB buffer (the fill's mean needle is ~2.1 MiB)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _CRC_PROBE],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    check(out.returncode == 0, f"the CRC probe: {out.stderr[-2000:]}")
    return json.loads(out.stdout)


_PLANE_LINE = re.compile(
    r'^volume_server_(\w+?)(?:\{le="([^"]*)"\})? (\S+)$', re.M)


def _planes_up(urls) -> dict:
    """Each server's plane ports from its /status; fails unless both
    planes run on every server (a plane that did not build or start
    leaves its port 0)."""
    from seaweedfs_tpu_torch.server.httpd import http_json
    ports = {}
    for u in urls:
        st = http_json("GET", f"{u}/status", timeout=30)
        ports[u] = {"read": st.get("readPlanePort", 0),
                    "write": st.get("writePlanePort", 0)}
        check(ports[u]["read"] and ports[u]["write"],
              f"{u} runs without a native plane: {ports[u]}")
    return ports


def _plane_counters(urls) -> dict:
    """The planes' counters on every server's /metrics, summed: native
    writes, write fallbacks, native reads, reads on the Python port while
    the read plane is up, and the write plane's ack histogram
    ({bound: cumulative count})."""
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    out = dict(_NO_PLANES, ack={})
    names = {"write_plane_requests_total": "native_writes",
             "write_plane_fallbacks_total": "write_fallbacks",
             "read_plane_requests_total": "native_reads"}
    for u in urls:
        text = http_bytes("GET", f"{u}/metrics", timeout=60)[1].decode()
        for m in _PLANE_LINE.finditer(text):
            name, le, val = m.group(1), m.group(2), float(m.group(3))
            if name in names:
                out[names[name]] += val
            elif name == "write_plane_ack_seconds_bucket":
                out["ack"][le] = out["ack"].get(le, 0.0) + val
        out["python_reads"] += sum(
            v for _, v in _samples(text, "read_plane_fallbacks_total"))
    return out


_NO_PLANES = {"native_writes": 0.0, "write_fallbacks": 0.0,
              "native_reads": 0.0, "python_reads": 0.0, "ack": {}}


def _plane_delta(after: dict, before: dict) -> dict:
    """What the planes counted between two `_plane_counters`, with the
    ack latency's p50 and p99 as the upper bounds of the histogram
    buckets that hold them."""
    out = {k: int(after[k] - before[k]) for k in after if k != "ack"}
    cells = sorted(((float(le), after["ack"][le] -
                     before["ack"].get(le, 0.0)) for le in after["ack"]))
    total = cells[-1][1] if cells else 0.0
    for name, q in (("ack_p50_s", 0.5), ("ack_p99_s", 0.99)):
        out[name] = next((le for le, cum in cells if total and
                          cum >= q * total), None)
    out["acks"] = int(total)
    return out


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


        def volumes():
            out: dict = {}
            for node, v in iter_volume_list_volumes(get("/vol/list")):
                out.setdefault(v["id"], []).append((node["url"], v))
            return out
        poll(lambda: len(get("/cluster/status")["dataNodes"]) ==
             len(urls), "3 volume servers registered")
        start_s = time.perf_counter() - t0
        check(volumes() == {}, "the cluster starts with no volume")
        plane_ports = _planes_up(urls)

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
        before = _plane_counters(urls)
        operation.read = checked_read
        try:
            bench = benchmark.run_benchmark(murl, bench_n, BENCH_SIZE,
                                            BENCH_C)
        finally:
            operation.read = real_read
        bench_planes = _plane_delta(_plane_counters(urls), before)
        # every benchmark write goes to a volume of replication 000, which
        # the write plane owns; a read goes to the read plane first
        check(bench_planes["native_writes"] >= 0.9 * bench_n,
              f"the write plane acked {bench_planes['native_writes']} of "
              f"the benchmark's {bench_n} writes")
        check(bench_planes["native_reads"] > 0,
              "the read plane served none of the benchmark's reads")
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
        before = _plane_counters(live)
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
        fill_planes = _plane_delta(_plane_counters(live), before)
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
        check(crc_probe["path"] == "sse4.2",
              f"the servers' CRC32-C runs on {crc_probe['path']}, not on "
              f"the SSE4.2 instruction")
        # the live servers' counts since they started
        phase_planes = _plane_delta(_plane_counters(live), _NO_PLANES)
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
           "planes": {"ports": plane_ports, "benchmark": bench_planes,
                      "fill": fill_planes, "phase": phase_planes},
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
    failovers, hot-needle cache hits and misses, reads the native read
    plane served and reads on the Python port while it was up, and the
    lost intervals each host codec rebuilt ("engine/simd": count)."""
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    out = {"launches": 0.0, "degraded": 0.0, "failovers": 0.0,
           "hits": 0.0, "misses": 0.0, "native_reads": 0.0,
           "python_reads": 0.0, "engines": {}}
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
        out["native_reads"] += sum(
            float(m.group(3)) for m in _PLANE_LINE.finditer(text)
            if m.group(1) == "read_plane_requests_total")
        out["python_reads"] += sum(
            v for _, v in _samples(text, "read_plane_fallbacks_total"))
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
        pcts = _pcts(ms)
        if len(ms) < 2 * READ_C:
            del pcts["p99_ms"]
        out[kind] = {"reads": len(todo), "bytes": nbytes, "seconds": wall,
                     "reads_per_s": len(todo) / wall,
                     "gbps": nbytes / wall / 1e9, **pcts,
                     "degraded_reads": d["degraded"],
                     "cache_hits": d["hits"], "cache_misses": d["misses"],
                     "failovers": d["failovers"], "engines": d["engines"],
                     "read_plane_reads": d["native_reads"],
                     "python_port_reads": d["python_reads"],
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
        LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, ECContext, to_ext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        _encode_work_items, rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import (
        EcVolume)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes

    # the host codec of degraded reads, built here once: the servers
    # load the same library
    t = time.perf_counter()
    simd = rs_native.gf_native_simd()
    native_build_s = time.perf_counter() - t
    check(simd is not None, "the native host codec did not build: "
          f"{rs_native.native.BUILD_INFO.get('gf_rs', {}).get('error')}")
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
        plane_ports = _planes_up(urls)

        # 1. weed benchmark's writes, 1 KiB each, seeded per file
        def write_small(i):
            body = _payload(seed + 3, i, BENCH_SIZE)
            t = time.perf_counter()
            a = operation.assign(murl, collection=coll)
            operation.upload(a.url, a.fid, body)
            return a.fid, i, len(body), (time.perf_counter() - t) * 1e3
        before = _plane_counters(urls)
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            small = list(pool.map(write_small, range(n_small)))
        small_s = time.perf_counter() - t
        small_planes = _plane_delta(_plane_counters(urls), before)

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
            # the servers' own files: the master sees a size a heartbeat
            # late, and at the write plane's rate the collection's volumes
            # would pass the limit together and grow a third volume first
            return any(os.path.getsize(os.path.join(dd, f)) >= limit_mb << 20
                       for dd in dirs for f in os.listdir(dd)
                       if f.startswith(f"{coll}_") and f.endswith(".dat"))
        before = _plane_counters(urls)
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
        fill_planes = _plane_delta(_plane_counters(urls), before)
        # the master runs -defaultReplication 000: the write plane owns
        # the collection's volumes
        check(fill_planes["native_writes"] > 0,
              f"the write plane acked none of the fill: {fill_planes}")
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
        # the candidates whose interval lies on a shard of the stopped
        # server, read from the volume's .ecx on disk: in write order
        # the 1 KiB files fill shard 0's first small block, so a trial
        # read of each (five /metrics scrapes) ran ~1,000 times when the
        # stopped server held no shard 0
        ecvs: dict = {}

        def on_stopped(fid) -> bool:
            f = types.parse_file_id(fid)
            lost = set(placement.get(f.volume_id, {}).get(victim, []))
            if not lost:
                return False
            if f.volume_id not in ecvs:
                name = f"{coll}_{f.volume_id}.ecx"
                dd = next(dd for dd in [dirs[urls.index(victim)]] + dirs
                          if os.path.exists(os.path.join(dd, name)))
                ecvs[f.volume_id] = EcVolume(dd, f.volume_id, coll, ctx)
            _off, _size, ivs = ecvs[f.volume_id].locate_needle(f.key)
            return any(iv.to_shard_id_and_offset(
                LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, d)[0] in lost
                for iv in ivs)
        try:
            candidates = [w for w in small
                          if w[0] not in seen and on_stopped(w[0])]
        finally:
            for ev in ecvs.values():
                ev.close()
        forwarded = None
        for fid, _nid, _size, _ms in candidates:
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
        # the live servers' counts since they started
        phase_planes = _plane_delta(_plane_counters(live), _NO_PLANES)
        crc_probe = _crc_probe()
        check(crc_probe["path"] == "sse4.2",
              f"the servers' CRC32-C runs on {crc_probe['path']}, not on "
              f"the SSE4.2 instruction")
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
                               rs_native.native.BUILD_INFO["gf_rs"].items()
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
           "planes": {"ports": plane_ports, "writes": small_planes,
                      "fill": fill_planes, "phase": phase_planes},
           "crc32c": crc_probe,
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


# --- phase 10 --------------------------------------------------------------

def _filer_counters(furl: str) -> dict:
    """What the filer counted on its /metrics: meta-cache and chunk-cache
    hits and misses, and each group-commit site's batches and writers."""
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    text = http_bytes("GET", f"{furl}/metrics", timeout=60)[1].decode()
    out = {}
    for cache in ("filer_meta", "filer_chunk"):
        for which in ("hits", "misses"):
            out[f"{cache}_{which}"] = sum(
                v for lb, v in _samples(text, f"read_cache_{which}_total")
                if lb.get("cache") == cache)
    for site in ("filer.store", "filer.metalog"):
        for part in ("sum", "count"):
            out[f"{site}_{part}"] = sum(
                v for lb, v in _samples(text, f"group_commit_batch_size_{part}")
                if lb.get("site") == site)
    return out


def _filer_ranges(get, urls, items: list, what: str) -> int:
    """A ranged GET across every 4 MiB chunk boundary of each multi-chunk
    item, held to the payload's bytes; fails if the kernel launched."""
    ranges = 0
    before = _counters(urls)["launches"]
    for path, _digest, size, _kind, nid, seed in items:
        body = None
        for edge in range(4 << 20, size, 4 << 20):
            lo, hi = edge - 1000, min(edge + 999, size - 1)
            st, got = get(path, {"Range": f"bytes={lo}-{hi}"})
            if body is None:
                body = _payload(seed, nid, size)
            check(st == 206 and got == body[lo:hi + 1],
                  f"filer {what}: {path} bytes={lo}-{hi} answered {st}, "
                  f"not its bytes")
            ranges += 1
    check(_counters(urls)["launches"] == before,
          f"filer {what}: the ranged reads launched the kernel")
    return ranges


def _filer_pass(furl: str, urls, items: list, what: str,
                order=("small", "large", "multi")) -> dict:
    """GET every item (path, sha256, size, kind) through the filer on
    READ_C threads, each body held to its seeded SHA-256; each kind in a
    sub-pass of its own, in `order`, with reads/s, GB/s, p50/p99/max ms
    and what the volume servers and the filer counted meanwhile; the
    multi-chunk sub-pass also reads a range across each of their chunk
    boundaries (`_filer_ranges`).  A sub-pass of fewer reads than two
    rounds of the pool reports no p99 (it would be its max).  Fails if
    the kernel was launched."""
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    out = {}

    def get(path, headers=None):
        st, body, _ = http_bytes("GET", f"{furl}{path}", headers=headers,
                                 timeout=120)
        return st, body
    for kind in order:
        todo = [it for it in items if it[3] == kind]
        if not todo:
            continue

        def read_one(it):
            path, digest, size = it[:3]
            t = time.perf_counter()
            st, body = get(path)
            ms = (time.perf_counter() - t) * 1e3
            check(st == 200 and len(body) == size and
                  hashlib.sha256(body).hexdigest() == digest,
                  f"filer {what}: {path} answered {st}, {len(body)} bytes, "
                  f"not its payload")
            return ms
        before, fbefore = _counters(urls), _filer_counters(furl)
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            ms = list(pool.map(read_one, todo))
        wall = time.perf_counter() - t
        d = _delta(_counters(urls), before)
        fafter = _filer_counters(furl)
        check(d["launches"] == 0,
              f"filer {what} ({kind}): the reads launched the kernel "
              f"{d['launches']} times")
        if kind == "multi":
            # ranges across every chunk boundary, held to their bytes
            # (in this sub-pass: their whole 4 MiB chunks pass through
            # the filer's chunk cache and evict what it held)
            out["ranges_across_chunks"] = _filer_ranges(get, urls, todo,
                                                        what)
        nbytes = sum(it[2] for it in todo)
        pcts = _pcts(ms)
        if len(ms) < 2 * READ_C:
            del pcts["p99_ms"]
        out[kind] = {"reads": len(todo), "bytes": nbytes, "seconds": wall,
                     "reads_per_s": len(todo) / wall,
                     "gbps": nbytes / wall / 1e9, **pcts,
                     "degraded_reads": d["degraded"],
                     "needle_cache_hits": d["hits"],
                     "engines": d["engines"],
                     "meta_cache_hits": fafter["filer_meta_hits"] -
                     fbefore["filer_meta_hits"],
                     "chunk_cache_hits": fafter["filer_chunk_hits"] -
                     fbefore["filer_chunk_hits"],
                     "chunk_cache_misses": fafter["filer_chunk_misses"] -
                     fbefore["filer_chunk_misses"],
                     "kernel_launches": d["launches"]}
    return out


def _filer_volumes(furl: str, dirs) -> "dict[str, set]":
    """path -> the volume ids of its chunks, for every file in `dirs`,
    read off the filer's listings (paged by lastFileName)."""
    from seaweedfs_tpu_torch.server.httpd import http_json

    def one(d):
        got, last = {}, ""
        while True:
            r = http_json("GET", f"{furl}{d}/?limit=1000&lastFileName="
                          f"{urllib.parse.quote(last)}", timeout=60)
            check("error" not in r, f"listing {d}: {r}")
            for e in r["entries"]:
                got[e["fullPath"]] = {int(c["fileId"].split(",")[0])
                                      for c in e["chunks"]}
            if len(r["entries"]) < 1000:
                return got
            last = r["entries"][-1]["fullPath"].rsplit("/", 1)[-1]
    out: dict = {}
    with ThreadPoolExecutor(READ_C) as pool:
        for got in pool.map(one, sorted(dirs)):
            out.update(got)
    return out


def _filer_listing(furl: str, want: "dict[str, set]") -> dict:
    """List every directory of `want` (dir -> names) through the filer,
    paging by lastFileName, and hold each to its names."""
    from seaweedfs_tpu_torch.server.httpd import http_json

    def names(d):
        got, last = [], ""
        while True:
            r = http_json("GET", f"{furl}{d}/?limit=1000&lastFileName="
                          f"{urllib.parse.quote(last)}", timeout=60)
            check("error" not in r, f"listing {d}: {r}")
            batch = [e["fullPath"].rsplit("/", 1)[-1] for e in r["entries"]]
            got += batch
            if len(batch) < 1000:
                return d, got
            last = batch[-1]
    t = time.perf_counter()
    with ThreadPoolExecutor(READ_C) as pool:
        listed = dict(pool.map(names, sorted(want)))
    wall = time.perf_counter() - t
    for d, got in listed.items():
        check(got == sorted(want[d]),
              f"listing {d}: {len(got)} names, not its {len(want[d])}")
    return {"directories": len(listed), "seconds": wall,
            "lists_per_s": len(listed) / wall,
            "entries": sum(len(v) for v in listed.values())}


def phase_filer(tmp: str, seed: int, n_small: int = FILER_N,
                n_multi: int = FILER_MULTI, limit_mb: int = WRITE_LIMIT_MB,
                small_sample: int = FILER_SMALL_SAMPLE,
                large_sample: int = FILER_LARGE_SAMPLE,
                multi_sample: int = FILER_MULTI_SAMPLE,
                meta_n: int = FILER_META_N,
                device: str = "cuda") -> dict:
    """The port's filer over volumes that ec.encode encodes on the card: a
    `master -volumeSizeLimitMB 1024` subprocess, 3 `volume -max 8`
    subprocesses (their codec on `device`) and one `filer` subprocess
    (sqlite store, synchronous commit: `-metaPlane 0`, and no native
    plane) over collection `filer`.  Through the filer's HTTP API: `n_small` 1 KiB files in 64 directories on 16
    threads (weed benchmark's shape), `n_multi` files of 8-24 MiB (2-6
    chunks), and config 1's needles (256 KiB - 4 MiB) on 8 writers until
    a volume reaches the limit; chunkless creates, lookups and listings.
    Every sealed volume encoded RS(10,4) by the port's shell (launches
    against the staging plan's windows).  Read passes on 16 threads, each
    body held to its seeded SHA-256, each with ranges across chunk
    boundaries and a listing of every directory: all servers up (cold,
    then warm), the server holding the most data shards that a volume
    can lose stopped (degraded, on the host's codec), and after
    `ec.rebuild` (launches against its steps' windows).  Then an
    overwrite (the old chunks gone from their volumes), a recursive
    delete, and `fs.ls` / `fs.du` through the shell.  The reads launch
    nothing."""
    import numpy as np

    from seaweedfs_tpu_torch import operation
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        _encode_work_items, rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes

    os.makedirs(tmp)
    dirs = [os.path.join(tmp, f"f{i}") for i in range(FILER_SERVERS)]
    procs: list = []
    coll = FILER_COLLECTION
    d, p = 10, 4
    ctx = ECContext(d, p, device="cpu")
    cuts = {"files_1k": {"run": n_small, "reference_default": 1 << 20,
                         "why": "the run's time"},
            "read_sample": {"small": small_sample, "large": large_sample,
                            "multi": multi_sample,
                            "why": "fresh files a pass (cold and warm "
                                   "share one): 3 samples of the files "
                                   "on the encoded volume"},
            "servers": {"run": FILER_SERVERS, "why": "one host, loopback"}}
    print(f"filer phase: {n_small} files of 1 KiB through the filer (weed "
          f"benchmark's default 1,048,576, cut for the run's time)",
          flush=True)
    phase_t0 = time.perf_counter()
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
        (furl,) = _start_procs(
            [["filer", "-port", "0", "-master", murl, "-store",
              os.path.join(tmp, "filer.db"), "-collection", coll,
              "-metaPlane", "0"]],
            [os.path.join(tmp, "filer.log")], procs, "filer",
            line=r"filer listening on (\S+:\d+)\n",
            env_extra={"SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE": "0"})
        env = commands.CommandEnv(murl, filer=furl)

        def get(path):
            return http_json("GET", f"{murl}{path}", timeout=30)


        def normal_vids():
            return {v["id"]: v for _n, v in
                    iter_volume_list_volumes(get("/vol/list"))
                    if v.get("collection", "") == coll}

        def ec_locs(vid):
            return {loc["url"]: loc["shardIds"] for loc in get(
                f"/dir/ec_lookup?volumeId={vid}").get(
                    "shardIdLocations", [])}
        poll(lambda: len(get("/cluster/status")["dataNodes"]) == len(urls),
             "3 volume servers registered")
        start_s = time.perf_counter() - t0
        check(http_json("GET", f"{furl}/status", timeout=30).get("role") ==
              "filer", "the filer's /status")

        files: dict = {}            # path -> (sha256, size, kind, nid, seed)
        lock = threading.Lock()

        def put(path, body, kind, nid, sd):
            t = time.perf_counter()
            st, ans, _ = http_bytes("PUT", f"{furl}{path}", body,
                                    timeout=120)
            ms = (time.perf_counter() - t) * 1e3
            check(st == 201 and json.loads(ans)["size"] == len(body),
                  f"filer PUT {path}: {st} {ans[:200]!r}")
            with lock:
                files[path] = (hashlib.sha256(body).hexdigest(), len(body),
                               kind, nid, sd)
            return ms

        # 1. weed benchmark's shape through the filer: 1 KiB files
        small_seed = seed + 20
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            small_ms = list(pool.map(
                lambda i: put(f"/small/d{i % FILER_DIRS:02d}/f{i:05d}",
                              _payload(small_seed, i, BENCH_SIZE), "small",
                              i, small_seed), range(n_small)))
        small_s = time.perf_counter() - t

        # 2. multi-chunk files of 8-24 MiB
        multi_seed = seed + 21
        mrng = np.random.default_rng([seed, 21])
        multi_sizes = [int(mrng.integers(8 << 20, (24 << 20) + 1))
                       for _ in range(n_multi)]
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            multi_ms = list(pool.map(
                lambda j: put(f"/multi/m{j:02d}",
                              _payload(multi_seed, j, multi_sizes[j]),
                              "multi", j, multi_seed), range(n_multi)))
        multi_s = time.perf_counter() - t

        # 3. config 1's needles until the limit seals a volume
        fill_seed = seed + 22
        frng = np.random.default_rng([seed, 22])
        counter = itertools.count(1)
        stop = threading.Event()
        fill_ms: list = []

        def writer():
            while not stop.is_set():
                with lock:
                    nid = next(counter)
                    size = int(frng.integers(256 << 10, 4 << 20))
                ms = put(f"/fill/n{nid:05d}",
                         _payload(fill_seed, nid, size), "large", nid,
                         fill_seed)
                with lock:
                    fill_ms.append(ms)

        def sealed():
            return any(os.path.getsize(os.path.join(dd, f)) >= limit_mb << 20
                       for dd in dirs for f in os.listdir(dd)
                       if f.startswith(f"{coll}_") and f.endswith(".dat"))
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
        fill_bytes = sum(v[1] for v in files.values() if v[2] == "large")
        multi_bytes = sum(multi_sizes)

        # 4. metadata-only operations: creates, lookups, listings
        def create(i):
            st, ans, _ = http_bytes(
                "POST", f"{furl}/__meta__/put_entry", json.dumps(
                    {"fullPath": f"/meta/d{i % 16:02d}/e{i:05d}",
                     "attributes": {"mode": 0o644}, "chunks": [],
                     "extended": {"i": str(i)}}).encode(),
                {"Content-Type": "application/json"}, timeout=60)
            check(st == 200, f"put_entry {i}: {st} {ans[:200]!r}")
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            list(pool.map(create, range(meta_n)))
        create_s = time.perf_counter() - t
        small_paths = sorted(k for k, v in files.items() if v[2] == "small")
        lrng = np.random.default_rng([seed, 23])
        look = [small_paths[i] for i in
                lrng.choice(len(small_paths), meta_n, replace=False)]

        def find(path):
            r = http_json("GET", "{}/__meta__/lookup?path={}".format(
                furl, urllib.parse.quote(path)), timeout=60)
            check(r.get("fullPath") == path and
                  r["chunks"][0]["size"] == BENCH_SIZE,
                  f"lookup {path}: {r}")
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            list(pool.map(find, look))
        find_s = time.perf_counter() - t
        want_dirs: dict = {}
        for path in files:
            parent, _, name = path.rpartition("/")
            want_dirs.setdefault(parent, set()).add(name)
        listing = _filer_listing(furl, want_dirs)
        meta_ops = {"creates": meta_n, "creates_per_s": meta_n / create_s,
                    "finds": meta_n, "finds_per_s": meta_n / find_s,
                    "lists": listing["directories"],
                    "lists_per_s": listing["lists_per_s"]}

        vols = normal_vids()

        def sizes_seen():
            seen = {vid: (v["size"], [os.path.getsize(os.path.join(
                dirs[urls.index(loc["url"])], f"{coll}_{vid}.dat"))
                for loc in operation.lookup(murl, vid, use_cache=False)])
                for vid, v in normal_vids().items()}
            return all(want == [got] for got, want in seen.values())
        poll(sizes_seen, "the master sees every volume's size")
        vols = normal_vids()
        sealed_vids = sorted(v for v, x in vols.items()
                             if x["size"] >= limit_mb << 20)
        check(sealed_vids, f"no volume of {coll} reached the limit: {vols}")

        # 5. every sealed volume encoded RS(10,4) on the card
        def launches_on_all():
            return _counters(urls)["launches"]
        encode = {}
        for vid in sealed_vids:
            size = vols[vid]["size"]
            expect = sum(launches_for(d, item[3])
                         for item in _encode_work_items(size, ctx))
            before = launches_on_all()
            t = time.perf_counter()
            out = commands.run_script(
                env, f"lock; ec.encode -volumeId={vid} -collection={coll}; "
                     f"unlock")
            wall = time.perf_counter() - t
            got = int(launches_on_all() - before)
            check("scatter-encoded 14 shards" in out[1], f"encode: {out}")
            check(got == expect, f"volume {vid}'s encode launched {got}, "
                                 f"the windows of its work list are "
                                 f"{expect}")
            encode[vid] = {"bytes": size, "seconds": wall,
                           "gbps": size / wall / 1e9, "launches": got,
                           "expected_launches": expect, "output": out[1]}
        poll(lambda: not set(sealed_vids) & set(normal_vids()) and all(
            sorted(s for sids in ec_locs(v).values() for s in sids) ==
            list(range(d + p)) for v in sealed_vids),
            "every sealed volume's 14 shards listed and the volume gone")
        placement = {v: ec_locs(v) for v in sealed_vids}

        # 6. the read passes, over the files whose chunks all lie on the
        # encoded volumes (a fill needle the master placed on a volume
        # grown after the limit stays on a normal volume, which a stopped
        # server takes offline)
        vids_of = _filer_volumes(furl, want_dirs)
        on_ec = {k for k, v in vids_of.items() if v <= set(sealed_vids)}
        check(len(on_ec) >= 0.9 * len(files),
              f"{len(on_ec)} of {len(files)} files lie on the encoded "
              f"volumes {sealed_vids}")
        rng = np.random.default_rng([seed, 24])
        items = [(path, *v) for path, v in sorted(files.items())
                 if path in on_ec]
        by_kind = {k: [it for it in items if it[3] == k]
                   for k in ("small", "large", "multi")}
        take = {"small": small_sample, "large": large_sample,
                "multi": multi_sample}
        used: set = set()

        def sample():
            out = []
            for k, its in by_kind.items():
                fresh = [it for it in (its[i] for i in
                                       rng.permutation(len(its)))
                         if it[0] not in used][:take[k]]
                out += fresh
            used.update(it[0] for it in out)
            return out
        passes = {}
        a = sample()
        passes["cold"] = _filer_pass(furl, urls, a, "cold",
                                     ("multi", "large", "small"))
        passes["warm"] = _filer_pass(furl, urls, a, "warm")
        check(passes["warm"]["small"]["chunk_cache_hits"] ==
              passes["warm"]["small"]["reads"] and
              passes["cold"]["small"]["degraded_reads"] == 0,
              f"all servers up: {passes['cold']['small']} then "
              f"{passes['warm']['small']}")
        listings = {"all_up": _filer_listing(furl, want_dirs)}

        data_held = {u: sum(1 for v in placement for s in
                            placement[v].get(u, []) if s < d)
                     for u in urls}
        fits = [u for u in urls
                if all(len(placement[v].get(u, [])) <= p for v in placement)]
        check(fits, f"no server holds at most {p} shards of every volume: "
                    f"{placement}")
        victim = max(fits, key=lambda u: data_held[u])
        check(data_held[victim] > 0, f"{victim} holds no data shard")
        bad = _stop_peers([proc_of[victim]])
        check(not bad, f"{victim} did not stop: {bad}")
        t = time.perf_counter()
        poll(lambda: victim not in get("/cluster/status")["dataNodes"] and
             all(victim not in ec_locs(v) for v in placement),
             "the master drops the stopped server")
        drop_s = time.perf_counter() - t
        live = [u for u in urls if u != victim]
        b = sample()
        passes["degraded"] = _filer_pass(furl, live, b, "degraded",
                                         ("multi", "large", "small"))
        def sub(name):
            return [v for v in passes[name].values() if isinstance(v, dict)]
        deg = sum(v["degraded_reads"] for v in sub("degraded"))
        check(deg > 0, f"the stopped server's loss made no degraded read: "
                       f"{passes['degraded']}")
        for v in sub("degraded"):
            check(all(e.startswith("native/") for e in v["engines"]),
                  f"degraded: rebuilt by {v['engines']}, not all native")
        listings["degraded"] = _filer_listing(furl, want_dirs)

        # 7. ec.rebuild of what the server held, on the card
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
                         for v in placement), "14 shards listed again")
        for u in live:
            for vid in placement:
                http_json("POST", f"{u}/admin/ec/unmount",
                          {"volumeId": vid, "shardIds": []}, timeout=30)
        c = sample()
        passes["rebuilt"] = _filer_pass(furl, live, c, "rebuilt")
        check(all(v["degraded_reads"] == 0 for v in sub("rebuilt")),
              f"degraded reads after the rebuild: {passes['rebuilt']}")
        listings["rebuilt"] = _filer_listing(furl, want_dirs)

        # 8. namespace changes: an overwrite, a recursive delete, the shell
        target = by_kind["multi"][0][0]
        old = [ch["fileId"] for ch in http_json(
            "GET", f"{furl}/__meta__/lookup?path={target}",
            timeout=30)["chunks"]]
        new_body = _payload(seed + 25, 0, (9 << 20) + 7)
        put(target, new_body, "multi", 0, seed + 25)
        st, got, _ = http_bytes("GET", f"{furl}{target}", timeout=120)
        check(st == 200 and got == new_body, f"overwrite of {target}")
        operation._vid_cache = operation.VidCache()
        gone = []
        for fid in old:
            try:
                operation.read(murl, fid)
            except (RuntimeError, OSError, LookupError):
                gone.append(fid)
        check(gone == old, f"overwrite of {target}: old chunks "
                           f"{sorted(set(old) - set(gone))} still readable")
        victim_dir = f"/small/d{FILER_DIRS - 1:02d}"
        doomed = sorted(k for k in files if k.startswith(victim_dir + "/"))
        doomed_fids = [http_json("GET", f"{furl}/__meta__/lookup?path={k}",
                                 timeout=30)["chunks"][0]["fileId"]
                       for k in doomed[:8]]
        st, _, _ = http_bytes("DELETE", f"{furl}/small?recursive=false",
                              timeout=60)
        check(st == 409, f"a non-recursive delete of /small: {st}")
        t = time.perf_counter()
        st, _, _ = http_bytes("DELETE", f"{furl}{victim_dir}?recursive=true",
                              timeout=300)
        delete_s = time.perf_counter() - t
        check(st == 204, f"recursive delete of {victim_dir}: {st}")
        check(http_json("GET", f"{furl}{victim_dir}/", timeout=30)[
            "entries"] == [], f"{victim_dir} still lists entries")
        for fid in doomed_fids:
            try:
                operation.read(murl, fid)
                check(False, f"{fid} of {victim_dir} still readable")
            except (RuntimeError, OSError, LookupError):
                pass
        for k in doomed:
            files.pop(k)
        out = commands.run_script(env, "fs.ls /small; fs.du /small")
        n_left = sum(1 for v in files.values() if v[2] == "small")
        check(out[0].splitlines() == [f"d{i:02d}/" for i in
                                      range(FILER_DIRS - 1)],
              f"fs.ls /small: {out[0][:300]}")
        check(out[1] == f"{n_left * BENCH_SIZE} bytes, {n_left} files under "
                       f"/small", f"fs.du /small: {out[1]}")
        fcount = _filer_counters(furl)
        heartbeats = get("/cluster/status")["heartbeats"]
    finally:
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"the master, a volume server or the filer did not stop "
                   f"cleanly: {bad}")
    out = {"phase": "filer", "seconds": time.perf_counter() - phase_t0,
           "servers": FILER_SERVERS, "scheme": f"RS({d},{p})",
           "collection": coll, "cuts": cuts, "cluster_start_seconds": start_s,
           "writes": {
               "small": {"files": n_small, "bytes": n_small * BENCH_SIZE,
                         "seconds": small_s, "files_per_s": n_small / small_s,
                         "gbps": n_small * BENCH_SIZE / small_s / 1e9,
                         **_pcts(small_ms)},
               "multi": {"files": n_multi, "bytes": multi_bytes,
                         "seconds": multi_s, "files_per_s": n_multi / multi_s,
                         "gbps": multi_bytes / multi_s / 1e9,
                         **_pcts(multi_ms)},
               "fill": {"writers": FILL_WRITERS, "files": len(fill_ms),
                        "bytes": fill_bytes, "seconds": fill_s,
                        "files_per_s": len(fill_ms) / fill_s,
                        "gbps": fill_bytes / fill_s / 1e9, **_pcts(fill_ms),
                        "volumes": {v: x["size"] for v, x in vols.items()},
                        "limit_bytes": limit_mb << 20}},
           "meta_ops": meta_ops, "listing": listings,
           "group_commit_mean_batch": {
               site: fcount[f"{site}_sum"] / max(fcount[f"{site}_count"], 1)
               for site in ("filer.store", "filer.metalog")},
           "encode": encode, "placement": placement,
           "files_on_encoded_volumes": len(on_ec),
           "stopped": {"url": victim, "data_shards": data_held[victim],
                       "master_drop_seconds": drop_s},
           "passes": passes, "rebuild": rebuild,
           "overwrite": {"path": target, "old_chunks_gone": len(old)},
           "recursive_delete": {"dir": victim_dir, "entries": len(doomed),
                                "seconds": delete_s},
           "filer_counters": fcount,
           "launches": {"encode": sum(x["launches"] for x in encode.values()),
                        "rebuild": sum(x["launches"]
                                       for x in rebuild.values()),
                        "reads": sum(pp[k]["kernel_launches"]
                                     for pp in passes.values()
                                     for k in pp if isinstance(pp[k], dict))},
           "master_heartbeats": heartbeats}
    emit(out)
    return out


# --- phase 11 --------------------------------------------------------------

_FULL_SAMPLE = re.compile(r"^(\w+?)(?:\{([^}]*)\})? (\S+)$", re.M)


def _full_samples(text: str, name: str) -> "list[tuple[dict, float]]":
    """Every sample of the metric named `name` in full on a Prometheus
    text page: (labels, value)."""
    out = []
    for m in _FULL_SAMPLE.finditer(text):
        if m.group(1) == name:
            labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2) or ""))
            out.append((labels, float(m.group(3))))
    return out


def _hist_le(cum: "list[tuple[float, float]]", q: float) -> "float | None":
    """The upper bound of the histogram bucket holding quantile `q`, from
    its cumulative (le, count) cells; None when it is empty."""
    total = cum[-1][1] if cum else 0
    for le, n in cum:
        if total and n >= q * total:
            return le
    return None


def _plane_metrics(furl: str) -> dict:
    """What the filer's /metrics says of its planes: the native meta
    plane's and read plane's counters, stage walls and latency
    histograms, the Python meta plane's sub-stages, overlay, applier and
    checkpoint, and the metalog's group commits."""
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    text = http_bytes("GET", f"{furl}/metrics", timeout=60)[1].decode()

    def one(name, **labels):
        return sum(v for lb, v in _full_samples(text, name)
                   if all(lb.get(k) == x for k, x in labels.items()))

    def hist(name):
        cells = [(float("inf") if lb["le"] == "+Inf" else float(lb["le"]),
                  v) for lb, v in _full_samples(text, name + "_bucket")]
        return sorted(cells)
    out = {"mp": {k: one(f"filer_meta_plane_native_{k}_total") for k in (
        "requests", "fallbacks", "fid_misses", "wal_errors",
        "upstream_errors", "wal_batches", "wal_lines")},
        "rp": {k: one(f"filer_read_plane_native_{k}_total") for k in (
            "requests", "fallbacks", "stale_misses", "upstream_errors")}}
    out["mp"]["stage_s"] = {s: one(
        "filer_meta_plane_native_stage_seconds_total", stage=s)
        for s in ("parse", "upload", "wal")}
    out["rp"]["stage_s"] = {s: one(
        "filer_read_plane_native_stage_seconds_total", stage=s)
        for s in ("parse", "lookup", "fetch", "send")}
    out["mp"]["ack_hist"] = hist("filer_meta_plane_native_ack_seconds")
    out["rp"]["response_hist"] = hist(
        "filer_read_plane_native_response_seconds")
    out["sub"] = {s: (one("seaweedfs_tpu_filer_meta_sub_seconds_sum",
                          stage=s),
                      one("seaweedfs_tpu_filer_meta_sub_seconds_count",
                          stage=s))
                  for s in ("serialize", "barrier", "apply")}
    out["metalog_batches"] = (
        one("seaweedfs_tpu_group_commit_batch_size_sum",
            site="filer.metalog"),
        one("seaweedfs_tpu_group_commit_batch_size_count",
            site="filer.metalog"))
    out["overlay"] = one("filer_meta_plane_overlay_entries")
    return out


def _log_last_ts(log_dir: str) -> int:
    """The newest stamp of a whole event in the metalog's segments (a torn
    line, which the applier skips, is skipped here too)."""
    last = 0
    for day in sorted(os.listdir(log_dir)):
        dd = os.path.join(log_dir, day)
        if not os.path.isdir(dd):
            continue
        for seg in sorted(os.listdir(dd)):
            if not seg.endswith(".log"):
                continue
            with open(os.path.join(dd, seg), "rb") as f:
                for line in f.read().split(b"\n"):
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(ev, dict):
                        last = max(last, int(ev.get("tsNs", 0) or 0))
    return last


def _applier_state(furl: str, log_dir: str) -> dict:
    """The overlay's size, the checkpoint's stamp and position, and how far
    the checkpoint trails the log's last event."""
    from seaweedfs_tpu_torch.filer.meta_plane import read_checkpoint
    ck = read_checkpoint(log_dir)
    last = _log_last_ts(log_dir)
    return {"overlay": _plane_metrics(furl)["overlay"],
            "checkpoint_ts_ns": ck[1] if ck else 0,
            "checkpoint_pos": list(ck[0]) if ck else None,
            "log_last_ts_ns": last,
            "checkpoint_lag_ms": (last - (ck[1] if ck else 0)) / 1e6}


def _drain_applier(furl: str, log_dir: str, timeout: float = 120.0) -> dict:
    """Wait until the overlay is empty and the checkpoint covers the log's
    last event; the state when the writes stopped and the seconds the
    applier took to get there.  Fails on the timeout."""
    at_stop = _applier_state(furl, log_dir)
    t = time.perf_counter()
    end = time.monotonic() + timeout
    while True:
        now = _applier_state(furl, log_dir)
        if now["overlay"] == 0 and \
                now["checkpoint_ts_ns"] == now["log_last_ts_ns"]:
            break
        check(time.monotonic() < end,
              f"the applier did not catch up in {timeout} s: {now}")
        time.sleep(0.1)
    return {"at_stop": at_stop, "drained": now,
            "drain_seconds": time.perf_counter() - t}


class _PlaneClient:
    """A client of one filer that sends plain PUTs to its native meta
    plane and GETs to its native read plane first, over persistent
    connections, and replays a plane's 404 on the Python port inside the
    same latency sample (a fallback's cost is the client's).  The ports
    come from the filer's /status, probed once a client; one client a
    thread."""

    def __init__(self, furl: str):
        import http.client
        from seaweedfs_tpu_torch.server.httpd import http_json
        self._http = http.client
        self.furl = furl.split("://")[-1]
        st = http_json("GET", f"{self.furl}/status", timeout=30)
        host = self.furl.rsplit(":", 1)[0]
        self.meta = f"{host}:{st['metaPlanePort']}" \
            if st.get("metaPlanePort") else None
        self.read = f"{host}:{st['readPlanePort']}" \
            if st.get("readPlanePort") else None
        self._conns: dict = {}

    def _req(self, addr: str, method: str, path: str, body=None):
        c = self._conns.get(addr)
        if c is None:
            c = self._conns[addr] = self._http.HTTPConnection(
                addr, timeout=120)
        try:
            c.request(method, urllib.parse.quote(path), body,
                      {"Content-Type": "application/octet-stream"}
                      if body is not None else {})
            r = c.getresponse()
            return r.status, r.read()
        except (OSError, self._http.HTTPException):
            c.close()
            self._conns.pop(addr, None)
            raise

    def _first(self, plane, method, path, body, ok):
        if plane is not None:
            try:
                st, ans = self._req(plane, method, path, body)
                if st == ok:
                    return "plane", st, ans
            except (OSError, self._http.HTTPException):
                pass
        st, ans = self._req(self.furl, "PUT" if body is not None
                            else "GET", path, body)
        return "python", st, ans

    def put(self, path: str, body: bytes):
        """(route, status, answer): route "plane" when the meta plane
        acked it, "python" when the Python port answered."""
        return self._first(self.meta, "POST", path, body, 201)

    def get(self, path: str):
        return self._first(self.read, "GET", path, None, 200)


def _plane_read_pass(client, furl: str, urls, items: list, what: str,
                     order=("small", "large", "multi")) -> dict:
    """GET every item (path, sha256, size, kind, ...) read plane first on
    READ_C threads, every body held to its seeded SHA-256; each kind in a
    sub-pass of its own, with reads/s, GB/s, p50/p99/max ms, the share
    the read plane served, its fallbacks, stale and upstream misses and
    stage walls, and the kernel launches, which must be 0."""
    out = {}
    for kind in order:
        todo = [it for it in items if it[3] == kind]
        if not todo:
            continue
        routes: list = []

        def read_one(it):
            path, digest, size = it[:3]
            t = time.perf_counter()
            route, st, body = client().get(path)
            ms = (time.perf_counter() - t) * 1e3
            check(st == 200 and len(body) == size and
                  hashlib.sha256(body).hexdigest() == digest,
                  f"filer_plane {what}: {path} answered {st} by {route}, "
                  f"{len(body)} bytes, not its payload")
            routes.append(route)
            return ms
        before, pbefore = _counters(urls), _plane_metrics(furl)["rp"]
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            ms = list(pool.map(read_one, todo))
        wall = time.perf_counter() - t
        d = _delta(_counters(urls), before)
        pafter = _plane_metrics(furl)["rp"]
        check(d["launches"] == 0,
              f"filer_plane {what} ({kind}): the reads launched the kernel "
              f"{d['launches']} times")
        nbytes = sum(it[2] for it in todo)
        pcts = _pcts(ms)
        if len(ms) < 2 * READ_C:
            del pcts["p99_ms"]
        served = routes.count("plane")
        out[kind] = {"reads": len(todo), "bytes": nbytes, "seconds": wall,
                     "reads_per_s": len(todo) / wall,
                     "gbps": nbytes / wall / 1e9, **pcts,
                     "read_plane_served": served,
                     "read_plane_share": served / len(todo),
                     **{f"read_plane_{k}": int(pafter[k] - pbefore[k])
                        for k in ("requests", "fallbacks", "stale_misses",
                                  "upstream_errors")},
                     "read_plane_stage_s": {
                         s: pafter["stage_s"][s] - pbefore["stage_s"][s]
                         for s in pafter["stage_s"]},
                     "degraded_reads": d["degraded"],
                     "engines": d["engines"],
                     "kernel_launches": d["launches"]}
    return out


def phase_filer_plane(tmp: str, seed: int, n_small: int = FILER_N,
                      n_multi: int = FILER_MULTI,
                      limit_mb: int = WRITE_LIMIT_MB,
                      warm_sample: int = FILER_SMALL_SAMPLE,
                      small_sample: int = FILER_SMALL_SAMPLE,
                      large_sample: int = FILER_LARGE_SAMPLE,
                      multi_sample: int = FILER_MULTI_SAMPLE,
                      crash_n: int = FILER_CRASH_N,
                      device: str = "cuda") -> dict:
    """The port's filer in its default configuration (no -metaPlane flag:
    the meta plane over sqlite with the metalog as its WAL, and the native
    meta and read planes armed) over volumes that ec.encode encodes on
    the card: the filer phase's cluster, clients plane first.
    `n_small` 1 KiB files in 64 directories on 16 threads, `n_multi` files
    of 8-24 MiB (too large for the plane: each falls back) and config 1's
    needles until a volume seals; the overlay drained and the checkpoint
    at the log's last event; a warm pass of `warm_sample` 1 KiB files
    through the read plane; every sealed volume encoded RS(10,4)
    (launches against its windows); read passes as the filer phase's
    (cold, warm, a server stopped, after ec.rebuild, which launches
    against its steps' windows), every body held to its SHA-256; then the
    filer restarted with its applier stalled, `crash_n` files written,
    the filer SIGKILLed and restarted, every acked file read back equal,
    and the applier drained again.  The reads launch nothing."""
    import numpy as np

    from seaweedfs_tpu_torch import operation
    from seaweedfs_tpu_torch.server.httpd import http_json
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        _encode_work_items, rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes

    os.makedirs(tmp)
    dirs = [os.path.join(tmp, f"f{i}") for i in range(FILER_SERVERS)]
    procs: list = []
    coll = FILER_COLLECTION
    d, p = 10, 4
    ctx = ECContext(d, p, device="cpu")
    store = os.path.join(tmp, "filer.db")
    log_dir = store + ".metalog"
    cuts = {"files_1k": {"run": n_small, "reference_default": 1 << 20,
                         "why": "the run's time"},
            "read_sample": {"warm_before_encode": warm_sample,
                            "small": small_sample, "large": large_sample,
                            "multi": multi_sample,
                            "why": "fresh files a pass (cold and warm "
                                   "share one)"},
            "crash_files": crash_n,
            "servers": {"run": FILER_SERVERS, "why": "one host, loopback"}}
    print(f"filer_plane phase: {n_small} files of 1 KiB through the filer's "
          f"planes (weed benchmark's default 1,048,576, cut for the run's "
          f"time)", flush=True)
    phase_t0 = time.perf_counter()
    local = threading.local()
    filer_proc: list = []

    def start_filer(env_extra=None) -> str:
        (u,) = _start_procs(
            [["filer", "-port", "0", "-master", murl, "-store", store,
              "-collection", coll]],
            [os.path.join(tmp, "filer.log")], procs, "filer",
            line=r"filer listening on (\S+:\d+)\n", env_extra=env_extra,
            log_mode="a")
        filer_proc[:] = [procs[-1]]
        st = http_json("GET", f"{u}/status", timeout=30)
        check(st.get("metaPlanePort") and st.get("readPlanePort"),
              f"a plane port is 0 on the filer's /status: {st}")
        return u

    def client() -> _PlaneClient:
        c = getattr(local, "client", None)
        if c is None or c.furl != furl.split("://")[-1]:
            c = local.client = _PlaneClient(furl)
        return c

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
        furl = start_filer()
        env = commands.CommandEnv(murl, filer=furl)

        def get(path):
            return http_json("GET", f"{murl}{path}", timeout=30)


        def normal_vids():
            return {v["id"]: v for _n, v in
                    iter_volume_list_volumes(get("/vol/list"))
                    if v.get("collection", "") == coll}

        def ec_locs(vid):
            return {loc["url"]: loc["shardIds"] for loc in get(
                f"/dir/ec_lookup?volumeId={vid}").get(
                    "shardIdLocations", [])}
        poll(lambda: len(get("/cluster/status")["dataNodes"]) == len(urls),
             "3 volume servers registered")
        start_s = time.perf_counter() - t0

        files: dict = {}            # path -> (sha256, size, kind, nid, seed)
        routes: dict = {}           # kind -> [route of each acked write]
        lock = threading.Lock()

        def put(path, body, kind, nid, sd):
            t = time.perf_counter()
            route, st, ans = client().put(path, body)
            ms = (time.perf_counter() - t) * 1e3
            check(st == 201 and json.loads(ans)["size"] == len(body),
                  f"filer PUT {path} by {route}: {st} {ans[:200]!r}")
            with lock:
                files[path] = (hashlib.sha256(body).hexdigest(), len(body),
                               kind, nid, sd)
                routes.setdefault(kind, []).append(route)
            return ms

        # 1. writes: weed benchmark's shape, then multi-chunk files, then
        # config 1's needles until the limit seals a volume
        m0 = _plane_metrics(furl)
        small_seed = seed + 20
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            small_ms = list(pool.map(
                lambda i: put(f"/small/d{i % FILER_DIRS:02d}/f{i:05d}",
                              _payload(small_seed, i, BENCH_SIZE), "small",
                              i, small_seed), range(n_small)))
        small_s = time.perf_counter() - t
        m1 = _plane_metrics(furl)

        multi_seed = seed + 21
        mrng = np.random.default_rng([seed, 21])
        multi_sizes = [int(mrng.integers(8 << 20, (24 << 20) + 1))
                       for _ in range(n_multi)]
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            multi_ms = list(pool.map(
                lambda j: put(f"/multi/m{j:02d}",
                              _payload(multi_seed, j, multi_sizes[j]),
                              "multi", j, multi_seed), range(n_multi)))
        multi_s = time.perf_counter() - t
        check(set(routes["multi"]) == {"python"},
              f"a multi-chunk file was acked by the meta plane: "
              f"{routes['multi'].count('plane')}")

        fill_seed = seed + 22
        frng = np.random.default_rng([seed, 22])
        counter = itertools.count(1)
        stop = threading.Event()
        fill_ms: list = []

        def writer():
            while not stop.is_set():
                with lock:
                    nid = next(counter)
                    size = int(frng.integers(256 << 10, 4 << 20))
                ms = put(f"/fill/n{nid:05d}",
                         _payload(fill_seed, nid, size), "large", nid,
                         fill_seed)
                with lock:
                    fill_ms.append(ms)

        def sealed():
            return any(os.path.getsize(os.path.join(dd, f)) >= limit_mb << 20
                       for dd in dirs for f in os.listdir(dd)
                       if f.startswith(f"{coll}_") and f.endswith(".dat"))
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
        m2 = _plane_metrics(furl)
        fill_bytes = sum(v[1] for v in files.values() if v[2] == "large")
        writes_applier = _drain_applier(furl, log_dir)

        def acked_share(kind):
            rs = routes.get(kind, [])
            return {"plane": rs.count("plane"), "python": rs.count("python"),
                    "plane_share": rs.count("plane") / max(len(rs), 1)}
        small_share = acked_share("small")
        check(small_share["plane_share"] > 0.5,
              f"the meta plane acked {small_share} of the 1 KiB writes, "
              f"not more than half")
        mp_small = {k: m1["mp"][k] - m0["mp"][k] for k in m1["mp"]
                    if not isinstance(m1["mp"][k], (dict, list))}
        check(mp_small["requests"] == small_share["plane"],
              f"the meta plane counted {mp_small['requests']} acks, the "
              f"clients {small_share['plane']}")

        # 2. a warm pass through the read plane before the encode
        small_paths = sorted(k for k, v in files.items() if v[2] == "small")
        wrng = np.random.default_rng([seed, 26])
        warm_items = [(path, *files[path]) for path in
                      (small_paths[i] for i in wrng.choice(
                          len(small_paths), warm_sample, replace=False))]
        warm_pre = _plane_read_pass(client, furl, urls, warm_items,
                                    "warm before the encode", ("small",))
        check(warm_pre["small"]["read_plane_share"] > 0.5,
              f"the read plane served {warm_pre['small']['read_plane_share']}"
              f" of the warm pass, not more than half")

        vols = normal_vids()

        def sizes_seen():
            seen = {vid: (v["size"], [os.path.getsize(os.path.join(
                dirs[urls.index(loc["url"])], f"{coll}_{vid}.dat"))
                for loc in operation.lookup(murl, vid, use_cache=False)])
                for vid, v in normal_vids().items()}
            return all(want == [got] for got, want in seen.values())
        poll(sizes_seen, "the master sees every volume's size")
        vols = normal_vids()
        sealed_vids = sorted(v for v, x in vols.items()
                             if x["size"] >= limit_mb << 20)
        check(sealed_vids, f"no volume of {coll} reached the limit: {vols}")

        # 3. every sealed volume encoded RS(10,4) on the card
        encode = {}
        for vid in sealed_vids:
            size = vols[vid]["size"]
            expect = sum(launches_for(d, item[3])
                         for item in _encode_work_items(size, ctx))
            before = _counters(urls)["launches"]
            t = time.perf_counter()
            out = commands.run_script(
                env, f"lock; ec.encode -volumeId={vid} -collection={coll}; "
                     f"unlock")
            wall = time.perf_counter() - t
            got = int(_counters(urls)["launches"] - before)
            check("scatter-encoded 14 shards" in out[1], f"encode: {out}")
            check(got == expect, f"volume {vid}'s encode launched {got}, "
                                 f"the windows of its work list are "
                                 f"{expect}")
            encode[vid] = {"bytes": size, "seconds": wall,
                           "gbps": size / wall / 1e9, "launches": got,
                           "expected_launches": expect}
        poll(lambda: not set(sealed_vids) & set(normal_vids()) and all(
            sorted(s for sids in ec_locs(v).values() for s in sids) ==
            list(range(d + p)) for v in sealed_vids),
            "every sealed volume's 14 shards listed and the volume gone")
        placement = {v: ec_locs(v) for v in sealed_vids}

        # 4. the filer phase's passes, read plane first, over the files
        # whose chunks all lie on the encoded volumes
        want_dirs: dict = {}
        for path in files:
            parent, _, name = path.rpartition("/")
            want_dirs.setdefault(parent, set()).add(name)
        vids_of = _filer_volumes(furl, want_dirs)
        on_ec = {k for k, v in vids_of.items() if v <= set(sealed_vids)}
        check(len(on_ec) >= 0.9 * len(files),
              f"{len(on_ec)} of {len(files)} files lie on the encoded "
              f"volumes {sealed_vids}")
        rng = np.random.default_rng([seed, 24])
        items = [(path, *v) for path, v in sorted(files.items())
                 if path in on_ec]
        by_kind = {k: [it for it in items if it[3] == k]
                   for k in ("small", "large", "multi")}
        take = {"small": small_sample, "large": large_sample,
                "multi": multi_sample}
        used: set = set()

        def sample():
            out = []
            for k, its in by_kind.items():
                fresh = [it for it in (its[i] for i in
                                       rng.permutation(len(its)))
                         if it[0] not in used][:take[k]]
                out += fresh
            used.update(it[0] for it in out)
            return out
        passes = {"warm_before_encode": warm_pre}
        a = sample()
        passes["cold"] = _plane_read_pass(client, furl, urls, a, "cold",
                                          ("multi", "large", "small"))
        passes["warm"] = _plane_read_pass(client, furl, urls, a, "warm")
        check(passes["cold"]["small"]["degraded_reads"] == 0,
              f"all servers up: {passes['cold']['small']}")

        data_held = {u: sum(1 for v in placement for s in
                            placement[v].get(u, []) if s < d)
                     for u in urls}
        fits = [u for u in urls
                if all(len(placement[v].get(u, [])) <= p for v in placement)]
        check(fits, f"no server holds at most {p} shards of every volume: "
                    f"{placement}")
        victim = max(fits, key=lambda u: data_held[u])
        check(data_held[victim] > 0, f"{victim} holds no data shard")
        bad = _stop_peers([proc_of[victim]])
        check(not bad, f"{victim} did not stop: {bad}")
        poll(lambda: victim not in get("/cluster/status")["dataNodes"] and
             all(victim not in ec_locs(v) for v in placement),
             "the master drops the stopped server")
        live = [u for u in urls if u != victim]
        b = sample()
        passes["degraded"] = _plane_read_pass(client, furl, live, b,
                                              "degraded",
                                              ("multi", "large", "small"))
        deg = sum(v["degraded_reads"] for v in passes["degraded"].values())
        check(deg > 0, f"the stopped server's loss made no degraded read: "
                       f"{passes['degraded']}")
        for v in passes["degraded"].values():
            check(all(e.startswith("native/") for e in v["engines"]),
                  f"degraded: rebuilt by {v['engines']}, not all native")

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
                            "launches": got, "expected_launches": expect}
        poll(lambda: all(sorted(s for sids in ec_locs(v).values()
                                for s in sids) == list(range(d + p))
                         for v in placement), "14 shards listed again")
        for u in live:
            for vid in placement:
                http_json("POST", f"{u}/admin/ec/unmount",
                          {"volumeId": vid, "shardIds": []}, timeout=30)
        c = sample()
        passes["rebuilt"] = _plane_read_pass(client, furl, live, c,
                                             "rebuilt")
        check(all(v["degraded_reads"] == 0
                  for v in passes["rebuilt"].values()),
              f"degraded reads after the rebuild: {passes['rebuilt']}")
        m3 = _plane_metrics(furl)

        # 5. crash and restart: a clean stop, a restart with the applier
        # stalled, crash_n writes, SIGKILL, a restart with the default tick
        bad = _stop_peers(filer_proc)
        check(not bad, f"the filer did not stop cleanly: {bad}")
        procs.remove(filer_proc[0])
        furl = start_filer({"SEAWEEDFS_TPU_META_PLANE_INTERVAL_MS":
                            "600000"})
        crash_seed = seed + 27
        crash = {}
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            crash_ms = list(pool.map(
                lambda i: put(f"/crash/d{i % 16:02d}/c{i:05d}",
                              _payload(crash_seed, i, BENCH_SIZE), "crash",
                              i, crash_seed), range(crash_n)))
        crash["write_seconds"] = time.perf_counter() - t
        crash["acked"] = acked_share("crash")
        crash["at_kill"] = _applier_state(furl, log_dir)
        m_crash = _plane_metrics(furl)
        check(crash["at_kill"]["overlay"] > 0,
              f"the applier did not lag: {crash['at_kill']}")
        killed = filer_proc[0]
        killed.kill()
        killed.wait(30)
        if killed.stdout is not None:
            killed.stdout.close()
        procs.remove(killed)
        t = time.perf_counter()
        furl = start_filer()
        crash["restart_seconds"] = time.perf_counter() - t
        crash_items = [(path, *v) for path, v in sorted(files.items())
                       if v[2] == "crash"]
        check(len(crash_items) == crash_n, f"{len(crash_items)} crash files")
        crash["read_back"] = _plane_read_pass(client, furl, live,
                                              crash_items,
                                              "after the SIGKILL",
                                              ("crash",))
        crash["applier"] = _drain_applier(furl, log_dir)
        crash["write"] = {"files": crash_n, **_pcts(crash_ms)}
    finally:
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"the master, a volume server or the filer did not stop "
                   f"cleanly: {bad}")

    def mp_summary(b, a=None, acks=None):
        """The native meta plane between two scrapes (`a` None: from the
        process's start)."""
        b = b["mp"]
        a = a["mp"] if a is not None else {
            "ack_hist": [], "stage_s": {}}
        hist = [(le, n - dict(a["ack_hist"]).get(le, 0))
                for le, n in b["ack_hist"]]
        reqs = b["requests"] - a.get("requests", 0)
        return {**{k: int(b[k] - a.get(k, 0)) for k in (
            "requests", "fallbacks", "fid_misses", "wal_errors",
            "upstream_errors", "wal_batches", "wal_lines")},
            "acked_share": acks,
            "ack_p50_le_s": _hist_le(hist, 0.5),
            "ack_p99_le_s": _hist_le(hist, 0.99),
            "stage_mean_ms": {s: (b["stage_s"][s] - a["stage_s"].get(s, 0))
                              / max(reqs, 1) * 1e3 for s in b["stage_s"]}}
    sub = {s: {"mean_ms": m3["sub"][s][0] / max(m3["sub"][s][1], 1) * 1e3,
               "count": int(m3["sub"][s][1])}
           for s in m3["sub"]}
    out = {"phase": "filer_plane",
           "seconds": time.perf_counter() - phase_t0,
           "servers": FILER_SERVERS, "scheme": f"RS({d},{p})",
           "collection": coll, "cuts": cuts,
           "cluster_start_seconds": start_s,
           "writes": {
               "small": {"files": n_small, "seconds": small_s,
                         "files_per_s": n_small / small_s,
                         **_pcts(small_ms), **small_share},
               "multi": {"files": n_multi, "bytes": sum(multi_sizes),
                         "seconds": multi_s, "files_per_s": n_multi / multi_s,
                         "gbps": sum(multi_sizes) / multi_s / 1e9,
                         **_pcts(multi_ms), **acked_share("multi")},
               "fill": {"writers": FILL_WRITERS, "files": len(fill_ms),
                        "bytes": fill_bytes, "seconds": fill_s,
                        "files_per_s": len(fill_ms) / fill_s,
                        "gbps": fill_bytes / fill_s / 1e9, **_pcts(fill_ms),
                        **acked_share("large"),
                        "volumes": {v: x["size"] for v, x in vols.items()},
                        "limit_bytes": limit_mb << 20}},
           "meta_plane_native": {
               "small_writes": mp_summary(m1, m0, small_share),
               "all_writes": mp_summary(m2, m0)},
           "meta_sub_seconds": sub,
           "metalog_group_commit_mean_batch":
               m3["metalog_batches"][0] / max(m3["metalog_batches"][1], 1),
           "applier_after_writes": writes_applier,
           "encode": encode, "placement": placement,
           "files_on_encoded_volumes": len(on_ec),
           "stopped": {"url": victim, "data_shards": data_held[victim]},
           "passes": passes, "rebuild": rebuild,
           "read_plane_native": {k: int(m3["rp"][k] - m0["rp"][k]) for k in (
               "requests", "fallbacks", "stale_misses", "upstream_errors")},
           "crash": {**crash, "meta_plane_native": mp_summary(
               m_crash, acks=crash["acked"])},
           "launches": {"encode": sum(x["launches"] for x in encode.values()),
                        "rebuild": sum(x["launches"]
                                       for x in rebuild.values()),
                        "reads": sum(pp[k]["kernel_launches"]
                                     for pp in passes.values() for k in pp)
                        + sum(v["kernel_launches"]
                              for v in crash["read_back"].values())}}
    check(out["launches"]["reads"] == 0, "the filer_plane reads launched")
    emit(out)
    return out


# --- phase 12 --------------------------------------------------------------

# the fsync_tier phase (config 1 on the -fsync tier): the write phase's
# shapes on 3 `volume -fsync` servers of replication 001
FSYNC_SERVERS = 3
FSYNC_COLLECTION = "fsync"        # the fill, encoded on the card
FSYNC_BENCH_N = 2_048             # the benchmark at 001 (the Python path
#                                   acks ~360 writes/s on the card's
#                                   host): the hedged passes read its files
FSYNC_NATIVE_N = 1_024            # 1 KiB writes of replication 000: the
#                                   write plane's epoch handshake
FSYNC_SMALL_FILL = 512            # 1 KiB needles in the fill volume, read
#                                   after its encode
FSYNC_HEDGE_N = 2_048             # 1 KiB reads a hedged pass
FSYNC_PASS_STRIDE = 2             # the read passes take every 2nd needle
#                                   of each kind, on each of its replicas
FSYNC_HEDGE_WARM = 1_024          # reads of the warm-up pass
FSYNC_BUDGET_S = 0.1              # their deadline
FSYNC_FILER_N = 512               # 1 KiB files through the filer

SECURE_SERVERS = 3
SECURE_COLLECTION = "s3"
SECURE_BUCKETS = 4
SECURE_SMALL_N = 128             # 4 KiB objects over the 4 buckets
SECURE_SMALL_SIZE = 4 << 10
SECURE_LARGE_N = 8               # objects of warp's default --obj.size
SECURE_LARGE_SIZE = 10 << 20
SECURE_MP_SIZE = 64 << 20        # one multipart upload, in the AWS
SECURE_MP_PART = 8 << 20         # CLI's default 8 MiB parts
SECURE_CHUNKED_N = 16            # STREAMING-AWS4-HMAC-SHA256-PAYLOAD
SECURE_CHUNKED_SIZE = 1 << 20
SECURE_SSE_N = 16                # SSE-C objects, when `cryptography` is
SECURE_SSE_SIZE = 64 << 10       # installed
SECURE_C = 16
S3_ADMIN = ("SECUREADMINKEY", "secure-admin-secret")
S3_READER = ("SECUREREADERKEY", "secure-reader-secret")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fs_type(path: str) -> str:
    out = subprocess.run(["stat", "-f", "-c", "%T", path],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip() or f"unknown ({out.stderr.strip()})"


def _fsync_counters(urls) -> dict:
    """The -fsync tier's counters on each server's /metrics, summed:
    fsyncs, the volume barrier's batches and members, native acks, the
    write plane's epochs (released, failed) and refused -fsync volumes,
    and the reads of each plane (read plane, UDS, Python port)."""
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    out = {"fsyncs": 0.0, "batches": 0.0, "members": 0.0,
           "native_writes": 0.0, "epochs": 0.0, "epoch_failures": 0.0,
           "fsync_refused": 0.0, "read_plane_reads": 0.0,
           "uds_reads": 0.0, "python_reads": 0.0}
    plane = {"write_plane_requests_total": "native_writes",
             "write_plane_epochs_total": "epochs",
             "write_plane_epoch_failures_total": "epoch_failures",
             "write_plane_fsync_refused_total": "fsync_refused",
             "read_plane_requests_total": "read_plane_reads",
             "uds_reads_total": "uds_reads"}
    for u in urls:
        text = http_bytes("GET", f"{u}/metrics", timeout=60)[1].decode()
        for m in _PLANE_LINE.finditer(text):
            if m.group(1) in plane:
                out[plane[m.group(1)]] += float(m.group(3))
        out["fsyncs"] += sum(v for _, v in _samples(
            text, "volume_fsyncs_total"))
        for key, name in (("batches", "group_commit_batch_size_count"),
                          ("members", "group_commit_batch_size_sum")):
            out[key] += sum(v for lb, v in _samples(text, name)
                            if lb.get("site") == "volume.needle")
        out["python_reads"] += sum(
            v for _, v in _samples(text, "read_plane_fallbacks_total"))
    return out


def _fsync_delta(after: dict, before: dict, client_acks: int) -> dict:
    """What the servers counted between two `_fsync_counters`: the
    writes they acked (Python-path barrier members less the epoch
    handshakes, plus native acks), fsyncs per server-side ack and per
    client ack, and the barrier's mean batch."""
    d = {k: int(after[k] - before[k]) for k in after}
    server_acks = d["members"] - d["epochs"] + d["native_writes"]
    d.update(client_acks=client_acks, server_acks=server_acks,
             fsyncs_per_server_ack=d["fsyncs"] / max(server_acks, 1),
             fsyncs_per_client_ack=d["fsyncs"] / max(client_acks, 1),
             native_share=d["native_writes"] / max(server_acks, 1),
             mean_batch=d["members"] / max(d["batches"], 1))
    return d


def _replica_read(url: str, fid: str) -> "tuple[bytes, str]":
    """One needle from one replica, down the client's ladder for that
    location alone: its native read plane, then UDS, then its HTTP
    port.  (bytes, the route that served them)."""
    from seaweedfs_tpu_torch import operation
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    from seaweedfs_tpu_torch.storage.types import parse_file_id
    f = parse_file_id(fid)
    loc = [{"url": url}]
    data = operation._read_via_read_plane(loc, fid)
    if data is not None:
        return data, "read_plane"
    data = operation._read_via_uds(loc, f.volume_id, f.key, f.cookie)
    if data is not None:
        return data, "uds"
    st, body, _ = http_bytes("GET", f"{url}/{fid}", timeout=60)
    check(st == 200, f"{fid} on {url}: {st} {body[:200]!r}")
    return body, "http"


def _fsync_rate(path: str, seconds: float = 1.0) -> float:
    """1 KiB appends with an fsync each, one writer, a second: the
    filesystem's fsync rate under the phase's volumes."""
    p = os.path.join(path, ".fsync_probe")
    fd = os.open(p, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    n, t0 = 0, time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            os.write(fd, b"x" * 1024)
            os.fsync(fd)
            n += 1
    finally:
        os.close(fd)
        os.remove(p)
    return n / (time.perf_counter() - t0)


def phase_fsync_tier(tmp: str, seed: int, bench_n: int = FSYNC_BENCH_N,
                     native_n: int = FSYNC_NATIVE_N,
                     small_fill: int = FSYNC_SMALL_FILL,
                     limit_mb: int = WRITE_LIMIT_MB,
                     hedge_n: int = FSYNC_HEDGE_N,
                     hedge_warm: int = FSYNC_HEDGE_WARM,
                     filer_n: int = FSYNC_FILER_N,
                     device: str = "cuda") -> dict:
    """Config 1 on the `-fsync` tier: a `master -volumeSizeLimitMB 1024
    -defaultReplication 001`, 3 `volume -max 8 -fsync` servers (one rack,
    so every needle has two locations) and a filer in its default
    configuration, all on this host, their directories on a disk
    filesystem (its type printed; tmpfs is refused).  Writes: `weed
    benchmark`'s shape (1 KiB, 16 threads, `bench_n`) at replication 001,
    the same shape at 000 (`native_n`, the write plane's -fsync arm),
    `small_fill` 1 KiB needles and config 1's needles into one volume
    until the limit seals it; writes/s, p50/p99, the native share, the
    epoch handshakes, the barrier's mean batch and fsyncs per ack.  One
    volume server SIGKILLed right after the last ack and restarted on
    its directory and port.  Two passes over every `FSYNC_PASS_STRIDE`th
    acked needle of each kind, read from each of its replicas through
    that location's ladder (read plane, UDS, HTTP), each plane's share;
    every body equal to its seeded payload, and both the restarted
    server and the other replicas serving reads in each pass.  A warm pass, then two passes of `hedge_n` reads
    under a `FSYNC_BUDGET_S` deadline with one replica SIGSTOPped,
    hedging on and off.  The filer's `/dir/lookup` RPCs during its read
    passes; the seconds from the SIGKILL until the filer's pushed map
    drops the server, from its restart until the map holds it again,
    and from a volume's growth until the map holds it.  `ec.encode` of
    the sealed volume on the card: launches against its windows, shard
    SHA-256s against the host's native codec on the same `.dat`, then
    the 1 KiB needles of the encoded volume read back, 0 launches."""
    import signal
    import types as pytypes

    import numpy as np

    from seaweedfs_tpu_torch import benchmark, operation, stats
    from seaweedfs_tpu_torch.ops import rs_native
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.types import parse_file_id
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes
    from seaweedfs_tpu_torch.util import deadline, hedge

    # the client's heap after the earlier phases: a full collection of it
    # stalls every reader thread for longer than a read's budget, so the
    # objects alive now are kept out of the collector for the phase
    gc.collect()
    gc.freeze()
    fs_type = _fs_type(os.path.dirname(tmp))
    if fs_type in ("tmpfs", "ramfs"):
        # an fsync on memory proves nothing: put the phase on the disk
        # under the checkout (gitignored, removed at the end)
        tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_work", "fsync_tier")
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    fs_type = _fs_type(tmp)
    fsync_rate = _fsync_rate(tmp)
    print(f"fsync_tier phase: volume directories on {fs_type} ({tmp}, "
          f"{fsync_rate:.1f} fsyncs/s of 1 KiB appends, one writer); "
          f"benchmark n = {bench_n} (the write phase's {BENCH_N}, cut for "
          f"the phase's time)", flush=True)
    check(fs_type not in ("tmpfs", "ramfs"),
          f"the -fsync volumes would live on {fs_type}")
    dirs = [os.path.join(tmp, f"s{i}") for i in range(FSYNC_SERVERS)]
    ports = [_free_port() for _ in dirs]
    store = os.path.join(tmp, "filer.db")
    procs: list = []
    coll, filer_coll, native_coll = FSYNC_COLLECTION, "fsyncfiler", \
        "fsyncnative"
    d, p = 10, 4
    cuts = {"benchmark_n": {"run": bench_n, "write_phase": BENCH_N,
                            "reference_default": 1 << 20,
                            "why": "the phase's time: ~360 acks/s at 001 "
                                   "on the Python path"},
            "native_n": native_n, "small_fill": small_fill,
            "hedge_warm": hedge_warm, "filer_files": filer_n,
            "servers": {"run": FSYNC_SERVERS, "why": "one host, UDS"}}
    phase_t0 = time.perf_counter()
    real_ttl = operation._vid_cache.TTL

    def volume_argv(i):
        return ["volume", "-dir", dirs[i], "-port", str(ports[i]),
                "-mserver", murl, "-max", str(WRITE_MAX_VOLUMES),
                "-rack", "r1", "-fsync", "-device", device]

    try:
        (murl,) = _start_procs(
            [["master", "-port", "0", "-volumeSizeLimitMB", str(limit_mb),
              "-defaultReplication", "001"]],
            [os.path.join(tmp, "master.log")], procs, "master")
        urls = _start_procs([volume_argv(i) for i in range(len(dirs))],
                            [dd + ".log" for dd in dirs], procs, "volume")
        proc_of = dict(zip(urls, procs[1:]))
        (furl,) = _start_procs(
            [["filer", "-port", "0", "-master", murl, "-store", store,
              "-collection", filer_coll]],
            [os.path.join(tmp, "filer.log")], procs, "filer",
            line=r"filer listening on (\S+:\d+)\n")

        def get(path):
            return http_json("GET", f"{murl}{path}", timeout=30)

        poll_fine = functools.partial(poll, interval=0.02)

        def holders() -> "dict[int, list[str]]":
            out: dict = {}
            for node, v in iter_volume_list_volumes(get("/vol/list")):
                out.setdefault(v["id"], []).append(node["url"])
            return out

        def pushed() -> "dict[int, list[str]]":
            st = http_json("GET", f"{furl}/debug/follow", timeout=30)
            return {int(k): v for k, v in
                    (st.get("volumes") or {}).items()}

        def lookup_rpcs() -> float:
            text = http_bytes("GET", f"{murl}/metrics", timeout=30)[1]
            m = re.search(rb'^master_route_requests_total\{path="/dir/'
                          rb'lookup"\} (\S+)$', text, re.M)
            return float(m.group(1)) if m else 0.0
        poll_fine(lambda: len(get("/cluster/status")["dataNodes"]) ==
                  len(urls), "3 volume servers registered")
        start_s = time.perf_counter() - phase_t0
        status = {u: http_json("GET", f"{u}/status", timeout=30)
                  for u in urls}
        for u, st in status.items():
            check(st.get("udsPath") and os.path.exists(st["udsPath"]) and
                  st.get("readPlanePort") and st.get("writePlanePort"),
                  f"{u} runs without UDS or a native plane: {st}")
        poll_fine(lambda: http_json("GET", f"{furl}/debug/follow").get(
            "synced"), "the filer's follow stream syncs")

        # 1. weed benchmark's shape at 001: the Python path, every write
        # acked after the barrier's fsync on both replicas
        payload_b = None
        bench_fids: list = []
        real_read = operation.read

        def recording_read(master, fid, *a, **kw):
            data = real_read(master, fid, *a, **kw)
            bench_fids.append(fid)
            return data
        c0 = _fsync_counters(urls)
        operation.read = recording_read
        try:
            bench = benchmark.run_benchmark(murl, bench_n, BENCH_SIZE,
                                            BENCH_C)
        finally:
            operation.read = real_read
        c1 = _fsync_counters(urls)
        import random
        rng0 = random.Random(0)
        payload_b = bytes(rng0.getrandbits(8) for _ in range(BENCH_SIZE))
        check(len(set(bench_fids)) == bench_n,
              f"the benchmark read {len(set(bench_fids))} of {bench_n}")
        w_bench = _fsync_delta(c1, c0, bench_n)
        check(w_bench["fsyncs"] > 0 and w_bench["fsyncs_per_server_ack"]
              <= 1.0, f"the benchmark's fsyncs: {w_bench}")

        # 2. the same shape at 000: the write plane parks each ack on a
        # flush epoch until the barrier's fsync ran
        lock = threading.Lock()
        native_fids: list = []

        def write_native(i):
            body = _payload(seed + 30, i, BENCH_SIZE)
            t = time.perf_counter()
            a, _r = operation.assign_and_upload(
                murl, body, collection=native_coll, replication="000")
            ms = (time.perf_counter() - t) * 1e3
            with lock:
                native_fids.append((a.fid, i))
            return ms
        t = time.perf_counter()
        with ThreadPoolExecutor(BENCH_C) as pool:
            native_ms = list(pool.map(write_native, range(native_n)))
        native_s = time.perf_counter() - t
        c2 = _fsync_counters(urls)
        w_native = _fsync_delta(c2, c1, native_n)
        check(w_native["native_share"] > 0.9 and w_native["epochs"] > 0
              and not w_native["epoch_failures"]
              and not w_native["fsync_refused"],
              f"the write plane's -fsync arm: {w_native}")

        # 3. the fill: 1 KiB needles, then config 1's needles until the
        # limit seals the volume
        small = {}

        def write_small(i):
            body = _payload(seed + 31, i, BENCH_SIZE)
            fid = operation.submit(murl, body, collection=coll)
            with lock:
                small[fid] = i
        t = time.perf_counter()
        with ThreadPoolExecutor(BENCH_C) as pool:
            list(pool.map(write_small, range(small_fill)))
        small_s = time.perf_counter() - t
        (first,) = {parse_file_id(f).volume_id for f in small}
        frng = np.random.default_rng(seed)
        counter = itertools.count(1)
        stop = threading.Event()
        fill: list = []             # (fid, nid, size, ms)
        fill_sizes: dict = {}

        def writer():
            while not stop.is_set():
                with lock:
                    nid = next(counter)
                    fill_sizes[nid] = int(frng.integers(256 << 10, 4 << 20))
                body = _payload(seed, nid, fill_sizes[nid])
                t = time.perf_counter()
                fid = operation.submit(murl, body, collection=coll)
                ms = (time.perf_counter() - t) * 1e3
                with lock:
                    fill.append((fid, nid, len(body), ms))

        def sealed():
            return any(os.path.getsize(os.path.join(dd, f)) >=
                       limit_mb << 20 for dd in dirs for f in os.listdir(dd)
                       if f == f"{coll}_{first}.dat")
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            futs = [pool.submit(writer) for _ in range(FILL_WRITERS)]
            try:
                while not any(f.done() for f in futs) and not sealed():
                    time.sleep(0.05)
            finally:
                stop.set()
            for f in futs:
                f.result()
        fill_s = time.perf_counter() - t
        c3 = _fsync_counters(urls)
        w_fill = _fsync_delta(c3, c2, small_fill + len(fill))
        fill_bytes = sum(w[2] for w in fill)
        check(sealed(), f"volume {first} did not reach the limit")
        in_first = [w for w in fill if parse_file_id(w[0]).volume_id == first]

        # 4. SIGKILL a holder of the fill right after the last ack; the
        # filer's pushed map drops it; restart on its directory and port
        locs = holders()
        victim = locs[first][0]
        vi = urls.index(victim)
        t_kill = time.perf_counter()
        proc_of[victim].send_signal(signal.SIGKILL)
        proc_of[victim].wait(30)
        poll_fine(lambda: all(victim not in us for us in pushed().values()),
                  "the filer's pushed map drops the killed server", 30)
        depart_s = time.perf_counter() - t_kill
        t_restart = time.perf_counter()
        procs.remove(proc_of[victim])
        (again,) = _start_procs([volume_argv(vi)], [dirs[vi] + ".log"],
                                procs, "volume", log_mode="a")
        check(again == victim, f"restarted at {again}, not {victim}")
        proc_of[victim] = procs[-1]
        restart_s = time.perf_counter() - t_restart
        operation._invalidate_status(victim)
        poll_fine(lambda: all(victim in pushed().get(v, [])
                              for v, us in locs.items() if victim in us),
                  "the filer's pushed map holds the restarted server", 30)
        return_s = time.perf_counter() - t_restart

        # 5. two passes over every second acked needle of each kind, each
        # read from every one of its replicas
        locs = holders()
        items = ([(f, payload_b) for f in bench_fids[::FSYNC_PASS_STRIDE]] +
                 [(f, ("native", i))
                  for f, i in native_fids[::FSYNC_PASS_STRIDE]] +
                 [(f, ("small", i))
                  for f, i in list(small.items())[::FSYNC_PASS_STRIDE]] +
                 [(w[0], ("fill", w[1])) for w in fill[::FSYNC_PASS_STRIDE]])
        reads = [(u, fid, want) for fid, want in items
                 for u in locs[parse_file_id(fid).volume_id]]
        check(all(len(locs[parse_file_id(f).volume_id]) ==
                  (1 if isinstance(w, tuple) and w[0] == "native" else 2)
                  for f, w in items), "a needle's replica count")

        def body_of(want):
            if isinstance(want, bytes):
                return want
            kind, i = want
            return {"native": lambda: _payload(seed + 30, i, BENCH_SIZE),
                    "small": lambda: _payload(seed + 31, i, BENCH_SIZE),
                    "fill": lambda: _payload(seed, i, fill_sizes[i])}[kind]()

        def read_pass(what):
            routes: dict = {}
            by_server: dict = {}
            before = _fsync_counters(urls)

            def one(item):
                u, fid, want = item
                t = time.perf_counter()
                data, route = _replica_read(u, fid)
                ms = (time.perf_counter() - t) * 1e3
                check(data == body_of(want),
                      f"{what}: {fid} on {u} by {route}: {len(data)} "
                      f"bytes, not its payload")
                return u, route, ms
            t = time.perf_counter()
            with ThreadPoolExecutor(READ_C) as pool:
                got = list(pool.map(one, reads))
            secs = time.perf_counter() - t
            after = _fsync_counters(urls)
            for u, route, _ms in got:
                routes[route] = routes.get(route, 0) + 1
                srv = "restarted" if u == victim else "others"
                by_server.setdefault(srv, {}).setdefault(route, 0)
                by_server[srv][route] += 1
            srv = {k: int(after[k] - before[k]) for k in
                   ("read_plane_reads", "uds_reads", "python_reads")}
            out = {"reads": len(got), "seconds": secs,
                   "reads_per_s": len(got) / secs,
                   **_pcts([g[2] for g in got]),
                   "share": {k: v / len(got) for k, v in routes.items()},
                   "by_server": by_server, "servers_counted": srv}
            print(f"fsync_tier {what}: {json.dumps(out)}", flush=True)
            check(by_server.get("restarted") and by_server.get("others"),
                  f"{what}: the restarted server and the other replicas "
                  f"must each serve reads: {by_server}")
            return out
        pass_a = read_pass("after the restart")
        pass_b = read_pass("the same pass again")
        check(pass_a["share"].get("uds", 0) > 0,
              "UDS served no read of the pass after the restart")

        # 6. hedged reads under a deadline past a stopped replica: the
        # benchmark's needles whose first location is the stopped one.
        # Lookups: the client's vid cache, filled before the stop and
        # held for the passes (the master drops a node after 3 missed
        # pulses, and the passes would otherwise read its answer)
        operation._vid_cache.TTL = 3600.0
        bvids = sorted({parse_file_id(f).volume_id for f in bench_fids})
        for v in bvids:
            operation.lookup(murl, v, use_cache=False)
        stopped = operation.lookup(murl, bvids[0])[0]["url"]
        sample_pool = [f for f in bench_fids if operation.lookup(
            murl, parse_file_id(f).volume_id)[0]["url"] == stopped]
        hrng = np.random.default_rng([seed, 32])
        hsample = [sample_pool[i] for i in hrng.choice(
            len(sample_pool), min(hedge_n, len(sample_pool)),
            replace=False)]
        check(len(hsample) == min(hedge_n, len(sample_pool)) >=
              min(hedge_n, bench_n // 2), f"{len(hsample)} hedge samples")
        # every read's primary is the stopped replica: the default budget
        # (16 tokens, 10% of primary successes) would hedge ~16 of them,
        # and the default 64 workers are all parked on primaries that
        # wait out their 100 ms (16 readers x 100 ms / ~25 ms a read)
        hedge_knobs = {"SEAWEEDFS_TPU_HEDGE_BURST": str(hedge_n),
                       "SEAWEEDFS_TPU_HEDGE_WORKERS": "256"}

        def hedge_pass(what, stop_replica: bool, env: dict, sample,
                       budget: "float | None" = FSYNC_BUDGET_S):
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            won0 = _metric(stats.PROCESS.render(),
                           'seaweedfs_tpu_hedges_won_total{kind="read"}')
            iss0 = _metric(stats.PROCESS.render(),
                           'seaweedfs_tpu_hedges_issued_total{kind="read"}')
            hedge._tokens.reset()

            def one(fid):
                t = time.perf_counter()
                try:
                    if budget is None:
                        data = operation.read(murl, fid)
                    else:
                        with deadline.scope(budget):
                            data = operation.read(murl, fid)
                except (deadline.DeadlineExceeded, RuntimeError):
                    data = None
                ms = (time.perf_counter() - t) * 1e3
                ok = data == payload_b
                check(data is None or ok, f"{what}: {fid} not its bytes")
                return ms, ok and (budget is None or ms <= budget * 1e3)
            threshold = hedge.read_threshold()
            pid = proc_of[stopped].pid
            got: list = [None] * len(sample)
            errs: list = []

            def reader(first: int) -> None:
                try:
                    for i in range(first, len(sample), READ_C):
                        got[i] = one(sample[i])
                except Exception as e:  # noqa: BLE001 — raised below
                    errs.append(e)
            readers = [threading.Thread(target=reader, args=(i,))
                       for i in range(READ_C)]
            # what the phase has built since its start (the acked
            # needles, the read passes' records) leaves the collector
            # too, and the readers take their fids by stride, not from a
            # pool's queue of a future a read: a full collection stalls
            # every reader, and its time grows with what it scans
            gc.collect()
            gc.freeze()
            full_gc: list = []        # the client's full collections

            def on_gc(phase, info):
                if info["generation"] == 2:
                    full_gc.append(time.perf_counter() if phase == "start"
                                   else time.perf_counter() - full_gc.pop())
            gc.callbacks.append(on_gc)
            t = time.perf_counter()
            try:
                if stop_replica:
                    os.kill(pid, signal.SIGSTOP)
                for r in readers:
                    r.start()
                for r in readers:
                    r.join()
            finally:
                gc.callbacks.remove(on_gc)
                if stop_replica:
                    os.kill(pid, signal.SIGCONT)
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            secs = time.perf_counter() - t
            if errs:
                raise errs[0]
            out = {"reads": len(got), "seconds": secs,
                   "reads_per_s": len(got) / secs,
                   **_pcts([g[0] for g in got]),
                   "over_budget": sum(1 for g in got if not g[1]),
                   "budget_ms": None if budget is None else budget * 1e3,
                   "client_full_collections": len(full_gc),
                   "client_full_collection_max_ms":
                       max(full_gc, default=0.0) * 1e3,
                   "threshold_ms": None if threshold is None
                   else threshold * 1e3, "env": env,
                   "hedges_issued": int(_metric(
                       stats.PROCESS.render(),
                       'seaweedfs_tpu_hedges_issued_total{kind="read"}')
                       - iss0),
                   "hedges_won": int(_metric(
                       stats.PROCESS.render(),
                       'seaweedfs_tpu_hedges_won_total{kind="read"}')
                       - won0)}
            print(f"fsync_tier {what}: {json.dumps(out)}", flush=True)
            return out
        hedge.reset()
        # the tracker learns what a primary read takes from reads that
        # carry no deadline (they never hedge), as the JAX chaos test's
        warm = hedge_pass("hedge warm-up, every replica up, no deadline",
                          False, hedge_knobs, hsample[:hedge_warm], None)
        check(hedge.read_threshold() is not None, "the tracker is cold")
        hedged = hedge_pass("hedged, one replica stopped", True,
                            hedge_knobs, hsample)
        poll_fine(lambda: stopped in get("/cluster/status")["dataNodes"],
                  "the stopped replica is back", 30)
        unhedged = hedge_pass("unhedged, one replica stopped", True,
                              {"SEAWEEDFS_TPU_HEDGE_READS": "0"}, hsample)
        operation._vid_cache.TTL = real_ttl
        check(hedged["over_budget"] == 0,
              f"{hedged['over_budget']} hedged reads missed the budget")
        check(hedged["hedges_won"] > 0, "no hedge won")
        poll_fine(lambda: stopped in get("/cluster/status")["dataNodes"] and
                  all(stopped in pushed().get(v, []) for v in bvids),
                  "the stopped replica is back in the filer's map", 30)

        # 7. the filer: 1 KiB files, two read passes; its /dir/lookup RPCs
        ffiles = {f"/f/d{i % 16:02d}/f{i:05d}": _payload(seed + 33, i,
                                                           BENCH_SIZE)
                  for i in range(filer_n)}

        def fput(item):
            path, body = item
            st, ans, _ = http_bytes("PUT", f"{furl}{path}", body,
                                    timeout=60)
            check(st == 201, f"filer PUT {path}: {st} {ans[:200]!r}")
        with ThreadPoolExecutor(BENCH_C) as pool:
            list(pool.map(fput, ffiles.items()))
        fvids = {v["id"] for _n, v in iter_volume_list_volumes(
            get("/vol/list")) if v.get("collection") == filer_coll}
        poll_fine(lambda: all(v in pushed() for v in fvids),
                  "the filer's map holds its volumes", 30)

        def fget(path):
            t = time.perf_counter()
            st, body, _ = http_bytes("GET", f"{furl}{path}", timeout=60)
            check(st == 200 and body == ffiles[path],
                  f"filer GET {path}: {st}")
            return (time.perf_counter() - t) * 1e3
        filer_passes = {}
        for what in ("cold", "warm"):
            l0 = lookup_rpcs()
            t = time.perf_counter()
            with ThreadPoolExecutor(READ_C) as pool:
                ms = list(pool.map(fget, sorted(ffiles)))
            secs = time.perf_counter() - t
            filer_passes[what] = {"reads": len(ms), "seconds": secs,
                                  "reads_per_s": len(ms) / secs,
                                  **_pcts(ms),
                                  "lookup_rpcs": int(lookup_rpcs() - l0)}

        # 8. a volume's growth until the filer's map holds it
        t = time.perf_counter()
        grown = http_json("POST", f"{murl}/vol/grow",
                          {"collection": "fsyncgrow", "replication": "001",
                           "count": 1}, timeout=60)["volumeIds"]
        check(grown, "no volume grew")
        poll_fine(lambda: all(len(pushed().get(v, [])) == 2 for v in grown),
                  "the filer's map holds the grown volume", 30)
        grow_s = time.perf_counter() - t
        follow_state = http_json("GET", f"{furl}/debug/follow")

        # 9. ec.encode of the sealed volume on the card; its shards held
        # to the host's native codec on the same .dat
        size = max(os.path.getsize(os.path.join(dd, f"{coll}_{first}.dat"))
                   for dd in dirs if os.path.exists(
                       os.path.join(dd, f"{coll}_{first}.dat")))
        poll_fine(lambda: all(v["size"] == size for n_, v in
                         iter_volume_list_volumes(get("/vol/list"))
                         if v["id"] == first), "the master sees the size")
        source = operation.lookup(murl, first, use_cache=False)[0]["url"]
        twin = os.path.join(tmp, "twin")
        os.makedirs(twin)
        src_base = os.path.join(dirs[urls.index(source)], f"{coll}_{first}")
        for ext in (".dat", ".idx"):
            shutil.copyfile(src_base + ext, os.path.join(
                twin, f"{coll}_{first}{ext}"))
        host = rs_native.ReedSolomonNative(d, p)

        class _HostCtx(ECContext):
            def create_codec(self):
                return pytypes.SimpleNamespace(parity_lazy=host.parity)
        t = time.perf_counter()
        ec_encoder.write_ec_files(os.path.join(twin, f"{coll}_{first}"),
                                  _HostCtx(d, p, device="cpu"))
        twin_s = time.perf_counter() - t
        twin_sha = [sha256_file(os.path.join(twin, f"{coll}_{first}" +
                                             ECContext().to_ext(i)))
                    for i in range(d + p)]
        ctx = ECContext(d, p, device="cpu")
        expect = sum(launches_for(d, item[3]) for item in
                     ec_encoder._encode_work_items(size, ctx))
        env = commands.CommandEnv(murl)
        before = _counters(urls)["launches"]
        t = time.perf_counter()
        out = commands.run_script(
            env, f"lock; ec.encode -volumeId={first} -collection={coll}; "
                 f"unlock")
        enc_s = time.perf_counter() - t
        enc_launches = int(_counters(urls)["launches"] - before)
        check("scatter-encoded 14 shards" in out[1], f"encode: {out}")
        check(enc_launches == expect,
              f"the fsync volume's encode launched {enc_launches}, the "
              f"windows of its work list are {expect}")
        poll_fine(lambda: first not in holders() and sorted(
            s for loc in get(f"/dir/ec_lookup?volumeId={first}").get(
                "shardIdLocations", []) for s in loc["shardIds"]) ==
            list(range(d + p)), "14 shards listed and the volume gone")
        shard_sha = []
        for i in range(d + p):
            name = f"{coll}_{first}" + ECContext().to_ext(i)
            (path,) = [os.path.join(dd, name) for dd in dirs
                       if os.path.exists(os.path.join(dd, name))]
            shard_sha.append(sha256_file(path))
        check(shard_sha == twin_sha,
              "the card's shards differ from the host codec's: " + str(
                  [i for i in range(d + p) if shard_sha[i] != twin_sha[i]]))
        shutil.rmtree(twin, ignore_errors=True)

        # 10. the encoded volume's 1 KiB needles read back: 0 launches
        before = _counters(urls)["launches"]

        def ec_read(item):
            fid, i = item
            t = time.perf_counter()
            data = operation.read(murl, fid)
            check(data == _payload(seed + 31, i, BENCH_SIZE),
                  f"EC read of {fid}: not its payload")
            return (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        with ThreadPoolExecutor(READ_C) as pool:
            ec_ms = list(pool.map(ec_read, sorted(small.items())))
        ec_s = time.perf_counter() - t
        ec_launches = int(_counters(urls)["launches"] - before)
        check(ec_launches == 0,
              f"the reads of the encoded volume launched {ec_launches}")
    finally:
        gc.unfreeze()
        operation._vid_cache.TTL = real_ttl
        for pr in procs:        # a stopped replica must take its SIGTERM
            if pr.poll() is None:
                try:
                    os.kill(pr.pid, signal.SIGCONT)
                except OSError:
                    pass
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"a server of the phase did not stop cleanly: {bad}")
    fill_ms = [w[3] for w in fill]
    out = {"phase": "fsync_tier", "filesystem": fs_type,
           "fsyncs_per_s_one_writer": fsync_rate,
           "servers": FSYNC_SERVERS, "cuts": cuts,
           "cluster_start_seconds": start_s,
           "writes": {
               "benchmark_001": {"ops": bench, **w_bench},
               "native_000": {"writes": native_n, "seconds": native_s,
                              "writes_per_s": native_n / native_s,
                              **_pcts(native_ms), **w_native},
               "fill_001": {"small": small_fill, "small_seconds": small_s,
                            "needles": len(fill),
                            "in_sealed_volume": len(in_first),
                            "bytes": fill_bytes, "seconds": fill_s,
                            "gbps": fill_bytes / fill_s / 1e9,
                            **_pcts(fill_ms), **w_fill}},
           "sigkill": {"server": victim, "depart_to_map_seconds": depart_s,
                       "restart_seconds": restart_s,
                       "restart_to_map_seconds": return_s,
                       "acked_needles": len(items),
                       "replica_reads": len(reads),
                       "every_acked_needle_equal_on_every_replica": True},
           "read_passes": {"after_restart": pass_a, "again": pass_b},
           "hedged": {"stopped": stopped, "knobs": hedge_knobs,
                      "lookups": "the client's vid cache, filled before "
                                 "the stop and held for the passes",
                      "warm": warm, "hedging_on": hedged,
                      "hedging_off": unhedged},
           "follow": {"filer_passes": filer_passes,
                      "grow_to_map_seconds": grow_s,
                      "grown": grown, "filer_state": {
                          k: v for k, v in follow_state.items()
                          if k != "volumes"}},
           "encode": {"volume": first, "bytes": size, "seconds": enc_s,
                      "gbps": size / enc_s / 1e9, "launches": enc_launches,
                      "expected_launches": expect,
                      "host_codec": rs_native.gf_native_simd(),
                      "host_codec_seconds": twin_s,
                      "shards_sha256_equal_host_codec": True},
           "ec_reads": {"reads": len(ec_ms), "seconds": ec_s,
                        "reads_per_s": len(ec_ms) / ec_s, **_pcts(ec_ms),
                        "kernel_launches": ec_launches},
           "launches": {"encode": enc_launches, "reads": ec_launches},
           "phase_seconds": time.perf_counter() - phase_t0}
    emit(out)
    return out


def _openssl_certs(directory: str) -> dict:
    """A cluster CA and one node certificate (IP 127.0.0.1 and
    localhost, server and client use) with the `openssl` command, the
    layout `tls.generate_cluster_certs` writes: where the `cryptography`
    package is missing."""
    os.makedirs(directory, exist_ok=True)

    def j(name):
        return os.path.join(directory, name)

    def run(*argv):
        out = subprocess.run(["openssl", *argv], capture_output=True,
                             text=True, timeout=60)
        check(out.returncode == 0, f"openssl {argv[0]}: {out.stderr}")
    run("ecparam", "-name", "prime256v1", "-genkey", "-noout",
        "-out", j("ca.key"))
    run("req", "-x509", "-new", "-key", j("ca.key"), "-sha256", "-days",
        "3650", "-subj", "/CN=seaweedfs-tpu CA", "-addext",
        "basicConstraints=critical,CA:TRUE,pathlen:0", "-addext",
        "keyUsage=critical,keyCertSign,cRLSign", "-out", j("ca.crt"))
    run("ecparam", "-name", "prime256v1", "-genkey", "-noout",
        "-out", j("node.key"))
    run("req", "-new", "-key", j("node.key"), "-subj",
        "/CN=seaweedfs-tpu node", "-out", j("node.csr"))
    with open(j("node.ext"), "w") as f:
        f.write("subjectAltName=IP:127.0.0.1,DNS:localhost\n"
                "extendedKeyUsage=serverAuth,clientAuth\n")
    run("x509", "-req", "-in", j("node.csr"), "-CA", j("ca.crt"),
        "-CAkey", j("ca.key"), "-CAcreateserial", "-days", "825",
        "-sha256", "-extfile", j("node.ext"), "-out", j("node.crt"))
    os.chmod(j("node.key"), 0o600)
    return {"ca": j("ca.crt"), "cert": j("node.crt"), "key": j("node.key")}


def _s3_client(url: str, keys: "tuple[str, str]"):
    """send(method, path, query, body, headers) -> (status, body,
    headers): SigV4 with `keys` (None: unsigned) over the port's pooled
    client (https with the cluster CA and this node's certificate under
    the process's `[tls]`)."""
    from seaweedfs_tpu_torch.s3 import auth
    from seaweedfs_tpu_torch.server.httpd import http_bytes

    def send(method, path, query=None, body=b"", headers=None,
             signed=True):
        query = query or {}
        headers = dict(headers or {})
        if signed and keys is not None:
            headers = auth.sign_request(method, url, path, query, headers,
                                        body, *keys)
        qs = urllib.parse.urlencode(query)
        return http_bytes(method, f"{url}{auth.uri_encode(path, False)}" +
                          (f"?{qs}" if qs else ""), body or None, headers,
                          timeout=120)
    return send


def _chunked_put(url: str, path: str, payload: bytes,
                 keys: "tuple[str, str]", chunk: int = 64 << 10):
    """A STREAMING-AWS4-HMAC-SHA256-PAYLOAD PUT as an SDK signs it: the
    seed signature over the streaming constant, then every chunk signed
    after the one before it."""
    import hmac as hmac_mod

    from seaweedfs_tpu_torch.s3 import auth, chunked
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    scope = f"{amz_date[:8]}/us-east-1/s3/aws4_request"
    hl = {"x-amz-content-sha256": auth.STREAMING_PAYLOAD,
          "content-encoding": "aws-chunked",
          "x-amz-decoded-content-length": str(len(payload)),
          "x-amz-date": amz_date, "host": url}
    signed = sorted(h for h in hl if h in ("host", "content-type") or
                    h.startswith("x-amz-"))
    creq = auth.canonical_request("PUT", auth.uri_encode(path, False), {},
                                  hl, signed, auth.STREAMING_PAYLOAD)
    key = auth.signing_key(keys[1], amz_date[:8], "us-east-1")
    seed = hmac_mod.new(key, auth.string_to_sign(amz_date, scope, creq)
                        .encode(), "sha256").hexdigest()
    hl["authorization"] = (f"{auth.ALGORITHM} Credential={keys[0]}/{scope}, "
                           f"SignedHeaders={';'.join(signed)}, "
                           f"Signature={seed}")
    ctx = auth.AuthContext(keys[0], seed, key, amz_date, scope,
                           auth.STREAMING_PAYLOAD)
    body = chunked.encode_streaming_body(payload, ctx, chunk)
    return http_bytes("PUT", f"{url}{path}", body, hl, timeout=120)


def _refused_plain(url: str) -> bool:
    """A plain-text HTTP request to a TLS listener: True when no HTTP
    answer comes back (the handshake fails on it)."""
    import socket
    host, port = url.rsplit(":", 1)
    try:
        with socket.create_connection((host, int(port)), timeout=10) as s:
            s.sendall(f"GET /status HTTP/1.1\r\nHost: {url}\r\n\r\n"
                      .encode())
            got = s.recv(64)
    except OSError:
        return True
    return not got.startswith(b"HTTP/")


def _tls_status(url: str, ctx, method: str, path: str,
                headers: "dict | None" = None) -> "int | str":
    """One request with the given client context and headers only (no
    admin JWT added): the status, or the error that refused it."""
    import http.client
    host, port = url.rsplit(":", 1)
    conn = http.client.HTTPSConnection(host, int(port), timeout=10,
                                       context=ctx)
    try:
        conn.request(method, path, body=b"{}" if method == "POST" else None,
                     headers=headers or {})
        return conn.getresponse().status
    except (OSError, http.client.HTTPException) as e:
        return type(e).__name__
    finally:
        conn.close()


def phase_secure_s3(tmp: str, seed: int, small_n: int = SECURE_SMALL_N,
                    large_n: int = SECURE_LARGE_N,
                    mp_size: int = SECURE_MP_SIZE,
                    chunked_n: int = SECURE_CHUNKED_N,
                    limit_mb: int = WRITE_LIMIT_MB,
                    plain_n: int = SECURE_SMALL_N,
                    device: str = "cuda") -> dict:
    """A secured cluster as `security.toml` configures it, with the S3
    gateway on it: per-fid write JWTs (10 s), read JWTs, the admin JWT
    and mTLS on every listener, from certificates minted at the phase's
    start (`tls.generate_cluster_certs`, or the `openssl` command where
    `cryptography` is missing); a `master -volumeSizeLimitMB 1024`, 3
    `volume -max 8` servers, a filer in its default configuration (its
    native planes standing down, counted) and `s3 -filer` with an
    `-iamConfig` of two identities (`admin`: Admin; `reader`: Read and
    List), every process under `-securityToml` on this host and this
    client under the same file.  Through the gateway, as `admin`, on 16
    threads: 4 KiB objects over 4 buckets, 10 MiB objects, one multipart
    upload of 64 MiB in 8 MiB parts, streaming-chunked PUTs and SSE-C
    PUTs (when `cryptography` is installed).  The volume holding the
    most of the objects' chunks is filled with config 1's needles, each
    with its write JWT, until the limit seals it, and `ec.encode`d on
    the card through the port's shell over mTLS with the admin JWT
    (launches against its windows; shard SHA-256s against the host's
    native codec on the same `.dat`).  Every object read back as
    `reader`, each body its seeded payload, ListObjectsV2 paged at 1,000
    (0 launches); the refusals, each counted; a server holding shards of
    the encoded volume stopped, the encoded objects read degraded (the
    host codec), `ec.rebuild` on the card (launches against its steps'
    windows), the objects read again.  Then a short unsecured arm: a
    second cluster without `security.toml`, 4 KiB objects PUT and GET
    through its gateway, the volume planes' shares printed."""
    import base64
    import types as pytypes

    import numpy as np

    from seaweedfs_tpu_torch import operation, security
    from seaweedfs_tpu_torch.ops import rs_native
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.storage.types import FileId
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes

    phase_t0 = time.perf_counter()
    os.makedirs(tmp)
    d, p = 10, 4
    coll = SECURE_COLLECTION
    try:
        import cryptography  # noqa: F401
        have_crypto = True
    except ImportError:
        have_crypto = False
    if have_crypto:
        from seaweedfs_tpu_torch.tls import generate_cluster_certs
        pki = generate_cluster_certs(os.path.join(tmp, "pki"))
        pki_by = "tls.generate_cluster_certs"
    else:
        pki = _openssl_certs(os.path.join(tmp, "pki"))
        pki_by = "openssl"
        print("secure_s3: `cryptography` is not installed: the PEMs come "
              "from the openssl command; the SSE-C step is not run",
              flush=True)
    keys = {"write": "secure-write-key", "read": "secure-read-key",
            "admin": "secure-admin-key"}
    toml = os.path.join(tmp, "security.toml")
    with open(toml, "w") as f:
        f.write(f'[jwt.signing]\nkey = "{keys["write"]}"\n'
                f'expires_after_seconds = 10\n\n'
                f'[jwt.signing.read]\nkey = "{keys["read"]}"\n\n'
                f'[admin]\nkey = "{keys["admin"]}"\n\n'
                f'[tls]\nca = "{pki["ca"]}"\ncert = "{pki["cert"]}"\n'
                f'key = "{pki["key"]}"\nmtls = true\n')
    iam = os.path.join(tmp, "s3.json")
    with open(iam, "w") as f:
        json.dump({"identities": [
            {"name": "admin", "actions": ["Admin"], "credentials": [
                {"accessKey": S3_ADMIN[0], "secretKey": S3_ADMIN[1]}]},
            {"name": "reader", "actions": ["Read", "List"], "credentials": [
                {"accessKey": S3_READER[0], "secretKey": S3_READER[1]}]}]},
            f)
    dirs = [os.path.join(tmp, f"s{i}") for i in range(SECURE_SERVERS)]
    for dd in dirs:
        os.makedirs(dd)
    procs: list = []
    sec = ["-securityToml", toml]
    # every read pass reaches the volumes: no hot-needle or chunk cache
    nocache = {"SEAWEEDFS_TPU_READ_CACHE_MB": "0"}
    cuts = {"caches": "SEAWEEDFS_TPU_READ_CACHE_MB=0 on the filer and "
                      "the volume servers, so each pass reads the store",
            "servers": {"run": SECURE_SERVERS, "why": "one host"},
            "small_objects": small_n, "large_objects": large_n,
            "plain_arm_objects": plain_n}
    security.configure(security.load_security_toml(toml))
    try:
        (murl,) = _start_procs(
            [[*sec, "master", "-port", "0", "-volumeSizeLimitMB",
              str(limit_mb)]], [os.path.join(tmp, "master.log")], procs,
            "master")
        urls = _start_procs(
            [[*sec, "volume", "-dir", dd, "-port", "0", "-mserver", murl,
              "-max", str(WRITE_MAX_VOLUMES), "-device", device]
             for dd in dirs], [dd + ".log" for dd in dirs], procs, "volume",
            env_extra=nocache)
        proc_of = dict(zip(urls, procs[1:]))
        (furl,) = _start_procs(
            [[*sec, "filer", "-port", "0", "-master", murl, "-store",
              os.path.join(tmp, "filer.db"), "-collection", coll]],
            [os.path.join(tmp, "filer.log")], procs, "filer",
            line=r"filer listening on (\S+:\d+)\n", env_extra=nocache)
        (s3url,) = _start_procs(
            [[*sec, "s3", "-port", "0", "-filer", furl, "-iamConfig", iam]],
            [os.path.join(tmp, "s3.log")], procs, "s3",
            line=r"s3 gateway listening on (\S+:\d+).*\n")

        def get(path):
            return http_json("GET", f"{murl}{path}", timeout=30)

        poll(lambda: len(get("/cluster/status")["dataNodes"]) == len(urls),
             "3 volume servers registered over mTLS")
        start_s = time.perf_counter() - phase_t0
        admin = _s3_client(s3url, S3_ADMIN)
        reader = _s3_client(s3url, S3_READER)

        # 1. writes through the gateway as admin
        buckets = [f"bucket{i}" for i in range(SECURE_BUCKETS)]
        for b in buckets:
            st, body, _ = admin("PUT", f"/{b}")
            check(st == 200, f"create {b}: {st} {body[:200]!r}")
        objects: dict = {}          # path -> (seed, nid, size, sse key)

        def put_all(kind, items):
            def one(item):
                path, (sd, nid, size) = item
                body = _payload(sd, nid, size)
                t = time.perf_counter()
                st, ans, _ = admin("PUT", path, body=body)
                ms = (time.perf_counter() - t) * 1e3
                check(st == 200, f"PUT {path}: {st} {ans[:200]!r}")
                return ms
            t = time.perf_counter()
            with ThreadPoolExecutor(SECURE_C) as pool:
                ms = list(pool.map(one, items))
            secs = time.perf_counter() - t
            nbytes = sum(x[1][2] for x in items)
            for path, (sd, nid, size) in items:
                objects[path] = (sd, nid, size, None)
            return {"objects": len(items), "seconds": secs,
                    "objects_per_s": len(items) / secs,
                    "mb_per_s": nbytes / secs / 1e6, **_pcts(ms)}
        writes = {}
        # half of them in the first bucket, so its listing pages
        small = [(f"/{buckets[0 if i % 2 == 0 else 1 + (i // 2) % 3]}"
                  f"/small/o{i:05d}", (seed + 50, i, SECURE_SMALL_SIZE))
                 for i in range(small_n)]
        writes["4KiB"] = put_all("4KiB", small)
        large = [(f"/{buckets[i % SECURE_BUCKETS]}/large/o{i:03d}",
                  (seed + 51, i, SECURE_LARGE_SIZE)) for i in range(large_n)]
        writes["10MiB"] = put_all("10MiB", large)
        # one multipart upload of 8 MiB parts
        mp_path = f"/{buckets[0]}/multipart/object.bin"
        mp_body = _payload(seed + 52, 0, mp_size)
        t = time.perf_counter()
        st, ans, _ = admin("POST", mp_path, {"uploads": ""})
        upload = re.search(rb"<UploadId>([^<]+)</UploadId>", ans)
        check(st == 200 and upload, f"initiate multipart: {st} {ans!r}")
        upload = upload.group(1).decode()

        def part(n):
            piece = mp_body[(n - 1) * SECURE_MP_PART:n * SECURE_MP_PART]
            pst, pans, ph = admin("PUT", mp_path, {"partNumber": str(n),
                                                   "uploadId": upload},
                                  body=piece)
            check(pst == 200, f"part {n}: {pst} {pans[:200]!r}")
            return n, ph.get("ETag", "")
        n_parts = -(-mp_size // SECURE_MP_PART)
        with ThreadPoolExecutor(SECURE_C) as pool:
            etags = dict(pool.map(part, range(1, n_parts + 1)))
        done = ("<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{etags[n]}</ETag>"
            f"</Part>" for n in sorted(etags)) +
            "</CompleteMultipartUpload>").encode()
        st, ans, _ = admin("POST", mp_path, {"uploadId": upload}, body=done)
        check(st == 200, f"complete multipart: {st} {ans[:300]!r}")
        mp_s = time.perf_counter() - t
        objects[mp_path] = (seed + 52, 0, mp_size, None)
        writes["multipart"] = {"bytes": mp_size, "parts": n_parts,
                               "seconds": mp_s,
                               "mb_per_s": mp_size / mp_s / 1e6}
        # streaming-chunked PUTs
        t = time.perf_counter()
        for i in range(chunked_n):
            path = f"/{buckets[1]}/chunked/o{i:02d}"
            body = _payload(seed + 53, i, SECURE_CHUNKED_SIZE)
            st, ans, _ = _chunked_put(s3url, path, body, S3_ADMIN)
            check(st == 200, f"chunked PUT {path}: {st} {ans[:200]!r}")
            objects[path] = (seed + 53, i, SECURE_CHUNKED_SIZE, None)
        writes["streaming_chunked"] = {
            "objects": chunked_n, "seconds": time.perf_counter() - t}
        # SSE-C
        sse_keys = {}
        if have_crypto:
            t = time.perf_counter()
            for i in range(SECURE_SSE_N):
                key = _payload(seed + 54, i, 32)
                hdr = {"x-amz-server-side-encryption-customer-algorithm":
                       "AES256",
                       "x-amz-server-side-encryption-customer-key":
                       base64.b64encode(key).decode(),
                       "x-amz-server-side-encryption-customer-key-md5":
                       base64.b64encode(hashlib.md5(key).digest())
                       .decode()}
                path = f"/{buckets[2]}/sse/o{i:02d}"
                st, ans, _ = admin("PUT", path,
                                   body=_payload(seed + 55, i,
                                                 SECURE_SSE_SIZE),
                                   headers=hdr)
                check(st == 200, f"SSE-C PUT {path}: {st} {ans[:200]!r}")
                objects[path] = (seed + 55, i, SECURE_SSE_SIZE, None)
                sse_keys[path] = hdr
            writes["sse_c"] = {"objects": SECURE_SSE_N,
                               "seconds": time.perf_counter() - t}
        else:
            print("secure_s3: SSE-C step not run (no `cryptography`)",
                  flush=True)

        # 2. which volume holds the most of the objects' chunks
        def chunk_fids(path):
            r = http_json("GET", f"{furl}/__meta__/lookup?path="
                                 f"{urllib.parse.quote('/buckets' + path)}",
                          timeout=30)
            check("error" not in r, f"lookup {path}: {r}")
            return path, [c["fileId"] for c in r.get("chunks", [])]
        with ThreadPoolExecutor(SECURE_C) as pool:
            fids_of = dict(pool.map(chunk_fids, sorted(objects)))
        per_vid: dict = {}
        for fids in fids_of.values():
            for fid in fids:
                vid = int(fid.split(",")[0])
                per_vid[vid] = per_vid.get(vid, 0) + 1
        target = max(per_vid, key=per_vid.get)
        encoded = sorted(path for path, fids in fids_of.items()
                         if any(int(f.split(",")[0]) == target
                                for f in fids))
        (loc,) = operation.lookup(murl, target, use_cache=False)
        tdir = dirs[urls.index(loc["url"])]
        dat = os.path.join(tdir, f"{coll}_{target}.dat")

        # 3. the seal: config 1's needles into that volume, each with its
        # write JWT (signed here with the cluster's write key)
        frng = np.random.default_rng(seed)
        lock = threading.Lock()
        fill: list = []
        stop = threading.Event()
        counter = itertools.count(1)

        def filler():
            while not stop.is_set():
                a = operation.assign(murl, collection=coll)
                with lock:
                    nid = next(counter)
                    size = int(frng.integers(256 << 10, 4 << 20))
                fid = str(FileId(target, int(a.fid.split(",")[1][:-8], 16),
                                 _cookie(nid)))
                body = _payload(seed, nid, size)
                operation.upload(loc["url"], fid, body)
                with lock:
                    fill.append((fid, nid, size))
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            futs = [pool.submit(filler) for _ in range(FILL_WRITERS)]
            try:
                while not any(f.done() for f in futs) and \
                        os.path.getsize(dat) < limit_mb << 20:
                    time.sleep(0.05)
            finally:
                stop.set()
            for f in futs:
                f.result()
        fill_s = time.perf_counter() - t
        size = os.path.getsize(dat)
        check(size >= limit_mb << 20, f"volume {target}: {size} bytes")
        poll(lambda: all(v["size"] == size for _n, v in
                         iter_volume_list_volumes(get("/vol/list"))
                         if v["id"] == target), "the master sees the size")

        # 4. ec.encode on the card, over mTLS with the admin JWT; the
        # shards held to the host's native codec on the same .dat
        twin = os.path.join(tmp, "twin")
        os.makedirs(twin)
        for ext in (".dat", ".idx"):
            shutil.copyfile(dat[:-4] + ext,
                            os.path.join(twin, f"{coll}_{target}{ext}"))
        host = rs_native.ReedSolomonNative(d, p)

        class _HostCtx(ECContext):
            def create_codec(self):
                return pytypes.SimpleNamespace(parity_lazy=host.parity)
        ec_encoder.write_ec_files(os.path.join(twin, f"{coll}_{target}"),
                                  _HostCtx(d, p, device="cpu"))
        twin_sha = [sha256_file(os.path.join(twin, f"{coll}_{target}" +
                                             ECContext().to_ext(i)))
                    for i in range(d + p)]
        shutil.rmtree(twin, ignore_errors=True)
        ctx = ECContext(d, p, device="cpu")
        enc_expect = sum(launches_for(d, item[3]) for item in
                         ec_encoder._encode_work_items(size, ctx))
        env = commands.CommandEnv(murl)
        before = _counters(urls)["launches"]
        t = time.perf_counter()
        out = commands.run_script(
            env, f"lock; ec.encode -volumeId={target} -collection={coll}; "
                 f"unlock")
        enc_s = time.perf_counter() - t
        enc_launches = int(_counters(urls)["launches"] - before)
        check("scatter-encoded 14 shards" in out[1], f"encode: {out}")
        check(enc_launches == enc_expect,
              f"the encode launched {enc_launches}, the windows of its "
              f"work list are {enc_expect}")

        def ec_locs():
            return {x["url"]: x["shardIds"] for x in get(
                f"/dir/ec_lookup?volumeId={target}").get(
                    "shardIdLocations", [])}
        poll(lambda: sorted(s for ids in ec_locs().values()
                            for s in ids) == list(range(d + p)),
             "14 shards listed")
        shard_sha = []
        for i in range(d + p):
            name = f"{coll}_{target}" + ECContext().to_ext(i)
            (path,) = [os.path.join(dd, name) for dd in dirs
                       if os.path.exists(os.path.join(dd, name))]
            shard_sha.append(sha256_file(path))
        check(shard_sha == twin_sha,
              "the card's shards differ from the host codec's: " + str(
                  [i for i in range(d + p) if shard_sha[i] != twin_sha[i]]))

        # 5. every object read back as reader; ListObjectsV2 paged at 1,000
        def get_one(path, client=reader):
            sd, nid, n, _ = objects[path]
            t = time.perf_counter()
            st, body, _ = client("GET", path,
                                 headers=sse_keys.get(path))
            ms = (time.perf_counter() - t) * 1e3
            check(st == 200 and body == _payload(sd, nid, n),
                  f"GET {path} as reader: {st}, {len(body)} bytes")
            return ms

        def read_pass(paths, what):
            c0 = _counters([u for u in urls if u in live])
            t = time.perf_counter()
            with ThreadPoolExecutor(SECURE_C) as pool:
                ms = list(pool.map(get_one, paths))
            secs = time.perf_counter() - t
            c1 = _counters([u for u in urls if u in live])
            dlt = _delta(c1, c0)
            check(dlt["launches"] == 0,
                  f"{what}: the reads launched {dlt['launches']}")
            nbytes = sum(objects[x][2] for x in paths)
            return {"objects": len(paths), "seconds": secs,
                    "objects_per_s": len(paths) / secs,
                    "mb_per_s": nbytes / secs / 1e6, **_pcts(ms),
                    "degraded_reads": dlt["degraded"],
                    "engines": dlt["engines"],
                    "kernel_launches": int(dlt["launches"])}
        live = set(urls)
        kinds = {"4KiB": [x for x, _ in small], "10MiB": [x for x, _ in large],
                 "other": sorted(set(objects) - {x for x, _ in small} -
                                 {x for x, _ in large})}
        reads = {k: read_pass(v, f"read {k}") for k, v in kinds.items()}
        listed = 0
        page_counts: dict = {}
        for b in buckets:
            token, keys_seen, pages = "", [], 0
            while True:
                q = {"list-type": "2", "max-keys": "1000"}
                if token:
                    q["continuation-token"] = token
                st, body, _ = reader("GET", f"/{b}", q)
                check(st == 200, f"list {b}: {st}")
                keys_seen += [k.decode() for k in
                              re.findall(rb"<Key>([^<]+)</Key>", body)]
                pages += 1
                m = re.search(rb"<NextContinuationToken>([^<]+)<", body)
                if b"<IsTruncated>true</IsTruncated>" not in body or not m:
                    break
                token = m.group(1).decode()
            want = sorted(x.split("/", 2)[2] for x in objects
                          if x.split("/")[1] == b)
            check(sorted(keys_seen) == want,
                  f"list {b}: {len(keys_seen)} keys, want {len(want)}")
            check(pages == -(-max(len(want), 1) // 1000),
                  f"list {b}: {pages} pages for {len(want)} keys")
            listed += len(keys_seen)
            page_counts[b] = pages
        reads["listing"] = {"keys": listed, "max_keys": 1000,
                            "pages": page_counts}

        # 6. the refusals, each counted
        refusals: dict = {}
        st, body, _ = reader("PUT", f"/{buckets[0]}/denied", body=b"x")
        refusals["reader_put_403"] = st == 403 and b"AccessDenied" in body
        st, _, _ = reader("GET", encoded[0], signed=False)
        refusals["unsigned_get_403"] = st == 403
        roles = {"master": murl, "filer": furl, "s3": s3url,
                 **{f"volume{i}": u for i, u in enumerate(urls)}}
        refusals["plain_http_refused"] = {
            r: _refused_plain(u) for r, u in roles.items()}
        import ssl
        nocert = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        nocert.load_verify_locations(pki["ca"])
        refusals["tls_without_cert_refused"] = {
            r: not isinstance(_tls_status(u, nocert, "GET", "/status"), int)
            for r, u in roles.items()}
        full = security.current().tls.client_context()
        sample_fid = fids_of[encoded[0]][0]
        vloc = operation.lookup(murl, int(sample_fid.split(",")[0]))[0]["url"]
        refusals["volume_get_without_read_jwt_401"] = _tls_status(
            vloc, full, "GET", f"/{sample_fid}") == 401
        other = security.gen_jwt(keys["write"], {"fid": "999,deadbeef01"},
                                 10)
        a = operation.assign(murl, collection=coll)
        refusals["volume_post_other_fid_jwt_401"] = _tls_status(
            a.url, full, "POST", f"/{a.fid}",
            {"Authorization": f"Bearer {other}"}) == 401
        refusals["admin_without_jwt_401"] = {
            "volume /admin/ec/info": _tls_status(
                urls[0], full, "GET", f"/admin/ec/info?volumeId={target}"),
            "master /heartbeat": _tls_status(murl, full, "POST",
                                             "/heartbeat"),
            "master /vol/grow": _tls_status(murl, full, "POST",
                                            "/vol/grow"),
            "filer /debug/read_plane": _tls_status(
                furl, full, "POST", "/debug/read_plane")}
        refusals["admin_without_jwt_401"] = {
            k: v == 401 for k, v in refusals["admin_without_jwt_401"].items()}
        planes = {u: http_json("GET", f"{u}/status", timeout=30)
                  for u in urls + [furl]}
        refusals["no_plane_port_open"] = all(
            not st.get("readPlanePort") and not st.get("writePlanePort")
            and not st.get("metaPlanePort") and not st.get("udsPath")
            for st in planes.values())
        failed = [k for k, v in refusals.items()
                  if not (all(v.values()) if isinstance(v, dict) else v)]
        check(not failed, f"refusals not met: {failed}: {refusals}")
        standdown = {}
        for u in urls + [furl]:
            text = http_bytes("GET", f"{u}/metrics", timeout=30)[1].decode()
            for m in re.finditer(r'^(?:seaweedfs_tpu_)?(volume_server_plane_'
                                 r'stood_down_total|filer_native_plane_stood'
                                 r'_down_total)\{plane="(\w+)",reason="(\w+)"'
                                 r'\} (\S+)$', text, re.M):
                k = f"{m.group(1).split('_')[0]}:{m.group(2)}:{m.group(3)}"
                standdown[k] = standdown.get(k, 0) + int(float(m.group(4)))
            hs = _samples(text, "tls_handshake_failures_total")
            standdown.setdefault("tls_handshake_failures", 0)
            standdown["tls_handshake_failures"] += int(sum(v for _, v in hs))
        check(standdown.get("volume:read:tls") == SECURE_SERVERS and
              standdown.get("volume:write:tls") == SECURE_SERVERS and
              standdown.get("volume:uds:tls") == SECURE_SERVERS and
              standdown.get("filer:meta:tls") and
              standdown.get("filer:read:tls"),
              f"the planes' stand-downs: {standdown}")

        # 7. loss and rebuild: a server holding shards of the encoded
        # volume stopped (the one with the most data shards of those
        # holding at most 4), the encoded objects read degraded
        placement = ec_locs()
        fits = [u for u, ids in placement.items() if len(ids) <= p]
        check(fits, f"no server holds at most {p} shards: {placement}")
        victim = max(fits, key=lambda u: sum(1 for s in placement[u]
                                             if s < d))
        lost = sorted(placement[victim])
        bad = _stop_peers([proc_of[victim]])
        check(not bad, f"{victim} did not stop: {bad}")
        live.discard(victim)
        poll(lambda: victim not in get("/cluster/status")["dataNodes"] and
             victim not in ec_locs(), "the master drops the stopped server")
        degraded = read_pass(encoded, "degraded")
        check(degraded["degraded_reads"] > 0,
              f"the loss of {lost} made no degraded read: {degraded}")
        check(all(e.startswith("native/") for e in degraded["engines"]),
              f"degraded reads rebuilt by {degraded['engines']}")
        shard_size = int(http_json(
            "GET", f"{next(iter(ec_locs()))}/admin/ec/info?volumeId="
                   f"{target}", timeout=30)["shardSize"])
        step = rebuild_step(shard_size, ctx, rebuild_slice_bytes())
        reb_expect = sum(launches_for(d, min(step, shard_size - pos))
                         for pos in range(0, shard_size, step))
        before = _counters(sorted(live))["launches"]
        t = time.perf_counter()
        out = commands.run_script(
            env, f"lock; ec.rebuild -volumeId={target} -collection={coll}; "
                 f"unlock")
        reb_s = time.perf_counter() - t
        reb_launches = int(_counters(sorted(live))["launches"] - before)
        check(f"rebuilt shards {lost} on " in out[1],
              f"rebuild of {target}: {out}")
        check(reb_launches == reb_expect,
              f"the rebuild launched {reb_launches}, the windows of its "
              f"steps are {reb_expect}")
        poll(lambda: sorted(s for ids in ec_locs().values()
                            for s in ids) == list(range(d + p)),
             "14 shards listed again")
        for u in sorted(live):
            http_json("POST", f"{u}/admin/ec/unmount",
                      {"volumeId": target, "shardIds": []}, timeout=30)
        rebuilt = read_pass(encoded, "rebuilt")
        check(rebuilt["degraded_reads"] == 0,
              f"degraded reads after the rebuild: {rebuilt}")
    finally:
        security.configure(None)
        bad = _stop_peers(procs)
    check(not bad, f"a server of the secured cluster did not stop: {bad}")
    secured_s = time.perf_counter() - phase_t0

    # 8. the unsecured arm: the same roles without security.toml
    t_plain = time.perf_counter()
    procs = []
    pdirs = [os.path.join(tmp, f"p{i}") for i in range(SECURE_SERVERS)]
    try:
        (pm,) = _start_procs([["master", "-port", "0"]],
                             [os.path.join(tmp, "pmaster.log")], procs,
                             "master")
        purls = _start_procs(
            [["volume", "-dir", dd, "-port", "0", "-mserver", pm, "-max",
              str(WRITE_MAX_VOLUMES), "-device", device] for dd in pdirs],
            [dd + ".log" for dd in pdirs], procs, "volume")
        (pf,) = _start_procs(
            [["filer", "-port", "0", "-master", pm, "-store",
              os.path.join(tmp, "pfiler.db"), "-collection", coll]],
            [os.path.join(tmp, "pfiler.log")], procs, "filer",
            line=r"filer listening on (\S+:\d+)\n")
        (ps3,) = _start_procs(
            [["s3", "-port", "0", "-filer", pf, "-accessKey", S3_ADMIN[0],
              "-secretKey", S3_ADMIN[1]]], [os.path.join(tmp, "ps3.log")],
            procs, "s3", line=r"s3 gateway listening on (\S+:\d+).*\n")
        end = time.monotonic() + 60
        while len(http_json("GET", f"{pm}/cluster/status")["dataNodes"]) < \
                len(purls):
            check(time.monotonic() < end, "the unsecured volume servers")
            time.sleep(0.05)
        pstatus = {u: http_json("GET", f"{u}/status") for u in purls + [pf]}
        check(all(st.get("readPlanePort") and st.get("writePlanePort")
                  for u, st in pstatus.items() if u != pf) and
              pstatus[pf].get("metaPlanePort") and
              pstatus[pf].get("readPlanePort"),
              f"the unsecured cluster's planes: {pstatus}")
        client = _s3_client(ps3, S3_ADMIN)
        check(client("PUT", "/plain")[0] == 200, "create /plain")
        pobjs = [(f"/plain/o{i:05d}", i) for i in range(plain_n)]
        c0 = _plane_counters(purls)

        def pput(item):
            path, i = item
            t = time.perf_counter()
            st, _, _ = client("PUT", path,
                              body=_payload(seed + 56, i, SECURE_SMALL_SIZE))
            check(st == 200, f"unsecured PUT {path}: {st}")
            return (time.perf_counter() - t) * 1e3

        def pget(item):
            path, i = item
            t = time.perf_counter()
            st, body, _ = client("GET", path)
            check(st == 200 and body == _payload(seed + 56, i,
                                                 SECURE_SMALL_SIZE),
                  f"unsecured GET {path}: {st}")
            return (time.perf_counter() - t) * 1e3
        plain = {}
        for what, fn in (("put", pput), ("get", pget)):
            t = time.perf_counter()
            with ThreadPoolExecutor(SECURE_C) as pool:
                ms = list(pool.map(fn, pobjs))
            secs = time.perf_counter() - t
            plain[what] = {"objects": len(ms), "seconds": secs,
                           "objects_per_s": len(ms) / secs,
                           "mb_per_s": len(ms) * SECURE_SMALL_SIZE / secs
                           / 1e6, **_pcts(ms)}
        pd = _plane_delta(_plane_counters(purls), c0)
        writes_all = pd["native_writes"] + pd["write_fallbacks"]
        reads_all = pd["native_reads"] + pd["python_reads"]
        plain["planes"] = {**pd, "write_plane_share":
                           pd["native_writes"] / writes_all
                           if writes_all else 0.0,
                           "read_plane_share": pd["native_reads"] / reads_all
                           if reads_all else 0.0}
    finally:
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"a server of the unsecured cluster did not stop: {bad}")
    fill_bytes = sum(x[2] for x in fill)
    out = {"phase": "secure_s3", "pki": pki_by, "sse_c": have_crypto,
           "servers": SECURE_SERVERS, "cuts": cuts,
           "cluster_start_seconds": start_s,
           "writes": writes,
           "seal": {"volume": target, "gateway_chunks_in_it":
                    per_vid[target], "needles": len(fill),
                    "bytes": fill_bytes, "seconds": fill_s,
                    "gbps": fill_bytes / fill_s / 1e9},
           "encode": {"volume": target, "bytes": size, "seconds": enc_s,
                      "gbps": size / enc_s / 1e9, "launches": enc_launches,
                      "windows": enc_expect,
                      "shards_sha256_equal_host_codec": True,
                      "host_codec": rs_native.gf_native_simd()},
           "reads": reads, "encoded_objects": len(encoded),
           "refusals": refusals, "stood_down": standdown,
           "loss": {"server": victim, "lost_shards": lost,
                    "degraded": degraded},
           "rebuild": {"seconds": reb_s, "launches": reb_launches,
                       "windows": reb_expect, "after": rebuilt},
           "unsecured": plain,
           "launches": {"encode": enc_launches, "rebuild": reb_launches,
                        "reads": sum(reads[k]["kernel_launches"]
                                     for k in kinds) +
                        degraded["kernel_launches"] +
                        rebuilt["kernel_launches"]},
           "secured_seconds": secured_s,
           "unsecured_seconds": time.perf_counter() - t_plain,
           "phase_seconds": time.perf_counter() - phase_t0}
    emit(out)
    return out


FLEET_SERVERS = 3
FLEET_COLLECTION = "fleet"
FLEET_WORKERS = 4
FLEET_C = 16                     # client threads an arm
FLEET_SMALL_N = 512              # 1 KiB files an arm
FLEET_LARGE_N = 32               # 64 KiB files an arm
FLEET_KILL_S = 0.25              # load before a sibling's SIGKILL
FLEET_LOST = (1, 4, 7, 9)        # data shards deleted before the reads
# (name, -workers, SEAWEEDFS_TPU_ASYNC_FRONT)
FLEET_ARMS = (("w1_threaded", 1, ""), ("w4_threaded", FLEET_WORKERS, ""),
              ("w4_async", FLEET_WORKERS, "filer"))


def _children(pid: int) -> "list[int]":
    """The live children of `pid` (a filer fleet's siblings)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", "rb") as f:
                parts = f.read().rsplit(b") ", 1)[1].split()
        except (OSError, IndexError):
            continue
        if int(parts[1]) == pid and parts[0] not in (b"Z", b"X"):
            out.append(int(d))
    return sorted(out)


def _prom(text: str) -> dict:
    """A whole Prometheus page, namespaced names kept:
    {name: [(labels, value)]}."""
    from seaweedfs_tpu_torch import profiling
    return profiling.parse_prom_text(text)


def _sibling_views(furl: str, want: int, tries: int = 200) -> dict:
    """Each sibling of the fleet behind `furl`, as one keep-alive
    connection sees it: GET /status, /debug/slow (which drains the
    native planes' rings first) and /metrics on the same connection,
    keyed by the sibling's native plane ports (unique to each process).
    New connections until `want` distinct siblings answered."""
    import http.client
    host, port = furl.split(":")
    views: dict = {}
    for _ in range(tries):
        if len(views) >= want:
            break
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            got = {}
            for path in ("/status", "/debug/slow", "/metrics"):
                conn.request("GET", path)
                resp = conn.getresponse()
                got[path] = resp.read()
                check(resp.status == 200, f"{furl}{path}: {resp.status}")
        finally:
            conn.close()
        st = json.loads(got["/status"])
        key = (st.get("metaPlanePort", 0), st.get("readPlanePort", 0))
        check(all(key), f"a sibling without its native planes: {st}")
        views[key] = {"slow": json.loads(got["/debug/slow"]),
                      "metrics": _prom(got["/metrics"].decode())}
    return views


def _fleet_instruments(views: dict) -> dict:
    """What a fleet's siblings say, summed over them: the write track's
    stage shares and wall/CPU means, a GET's and a POST's CPU share of
    its wall, each sibling's flight records, the plane drains' records
    against the planes' requests, and the process tree one sibling
    reports."""
    def csum(m, name, match=None):
        return sum(v for lb, v in m.get(name, [])
                   if all(lb.get(k) == x for k, x in (match or {}).items()))
    stage_wall: dict = {}
    stage_cpu: dict = {}
    req: dict = {}
    siblings = []
    for key, v in sorted(views.items()):
        m = v["metrics"]
        for lb, val in m.get("filer_write_stage_seconds_sum", []):
            stage_wall[lb["stage"]] = stage_wall.get(lb["stage"], 0.0) + val
        for lb, val in m.get("filer_write_stage_cpu_seconds_sum", []):
            c = csum(m, "filer_write_stage_cpu_seconds_count",
                     {"stage": lb["stage"]})
            acc = stage_cpu.setdefault(lb["stage"], [0.0, 0.0])
            acc[0] += val
            acc[1] += c
        for method in ("GET", "POST"):
            acc = req.setdefault(method, [0.0, 0.0, 0.0, 0.0])
            acc[0] += csum(m, "filer_request_seconds_sum",
                           {"method": method})
            acc[1] += csum(m, "filer_request_seconds_count",
                           {"method": method})
            acc[2] += csum(m, "filer_request_cpu_seconds_sum",
                           {"method": method})
            acc[3] += csum(m, "filer_request_cpu_seconds_count",
                           {"method": method})
        slow = v["slow"]
        siblings.append({
            "plane_ports": list(key),
            "slow_records": len(slow["records"]),
            "slow_captured": slow["captured"],
            "slow_threshold_ms": slow["thresholdMs"],
            "plane_records": {lb["plane"]: int(val) for lb, val in
                              m.get("seaweedfs_tpu_plane_records_total",
                                    [])},
            "plane_requests": {
                "meta": int(csum(m,
                                 "filer_meta_plane_native_requests_total")),
                "meta_fallbacks": int(csum(
                    m, "filer_meta_plane_native_fallbacks_total")),
                "filer_read": int(csum(
                    m, "filer_read_plane_native_requests_total")),
                "filer_read_fallbacks": int(csum(
                    m, "filer_read_plane_native_fallbacks_total"))},
            "gil_wait_ratio": csum(m, "seaweedfs_tpu_gil_wait_ratio"),
            "tree_procs": int(csum(m, "seaweedfs_tpu_process_tree_procs")),
            "tree_rss_mb": csum(m, "seaweedfs_tpu_process_tree_rss_bytes")
            / (1 << 20)})
    total = stage_wall.pop("total", 0.0)
    shares = {s: w / total for s, w in sorted(stage_wall.items())} \
        if total else {}
    cpu = {s: {"cpu_ms_mean": c[0] / c[1] * 1e3} for s, c in
           sorted(stage_cpu.items()) if c[1]}
    methods = {}
    for method, (ws, wc, cs, cc) in req.items():
        if wc and cc:
            methods[method] = {"wall_ms_mean": ws / wc * 1e3,
                               "cpu_ms_mean": cs / cc * 1e3,
                               "cpu_share": (cs / cc) / (ws / wc),
                               "requests": int(wc), "cpu_sampled": int(cc)}
    return {"siblings_seen": len(views), "write_stage_shares": shares,
            "write_stage_cpu": cpu, "request_cpu": methods,
            "per_sibling": siblings}


def phase_filer_fleet(tmp: str, seed: int, small_n: int = FLEET_SMALL_N,
                      large_n: int = FLEET_LARGE_N,
                      limit_mb: int = WRITE_LIMIT_MB,
                      device: str = "cuda") -> dict:
    """The filer fleet: a `master -volumeSizeLimitMB 1024`, 3 `volume -max
    8` subprocesses and the filer in its default configuration (the meta
    plane over one sqlite store, the native meta and read planes armed)
    run three ways over that one store, each for an arm of 16 client
    threads: 1 process on the threaded front, `-workers 4` (a pre-fork
    fleet on one port, SO_REUSEPORT) on the threaded front, and
    `-workers 4` with `SEAWEEDFS_TPU_ASYNC_FRONT=filer`.  Each arm POSTs
    1 KiB and 64 KiB files and GETs them back through the shared port,
    each body its seeded payload (files/s, p50/p99).  The read caches are
    off (`SEAWEEDFS_TPU_READ_CACHE_MB=0`), so every read reaches the
    volumes.  In each 4-worker arm: each sibling's view on one keep-alive
    connection (its plane ports, `/debug/slow`, `/metrics`): the write
    track's stage shares, a GET's and a POST's CPU share of its wall, the
    flight records, the plane drains' records against the planes'
    requests (after a pass sent plane-first: creates to each sibling's
    meta plane, reads to its read plane), the process tree; the sampler
    armed on every sibling during the GETs and the folded stacks merged
    (`profiling.merge_folded`, as `cluster.profile` merges nodes);
    `cluster.top` once.  Then a sibling is SIGKILLed under load: every
    acked file reads back equal through the shared port at once, and the
    parent respawns the sibling.  The last fleet stays up: the volume
    holding the most of the collection's files is filled with config 1's
    needles until the limit seals it, `ec.encode`d on the card (launches
    against its windows; shards equal to the host's native codec's);
    data shards 1, 4, 7 and 9 deleted; every file of every arm read
    degraded through the fleet (0 launches); `ec.rebuild` on the card
    (launches against its steps' windows); every file read again."""
    import http.client
    import types as pytypes

    import numpy as np

    from seaweedfs_tpu_torch import operation, profiling
    from seaweedfs_tpu_torch.ops import rs_native
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.storage.types import FileId
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes

    phase_t0 = time.perf_counter()
    os.makedirs(tmp)
    d, p = 10, 4
    coll = FLEET_COLLECTION
    store = os.path.join(tmp, "filer.db")
    dirs = [os.path.join(tmp, f"s{i}") for i in range(FLEET_SERVERS)]
    for dd in dirs:
        os.makedirs(dd)
    nocache = {"SEAWEEDFS_TPU_READ_CACHE_MB": "0"}
    procs: list = []
    fleet: list = []            # the running filer (its parent process)
    files: dict = {}            # path -> (seed, nid, size)

    def get(path):
        return http_json("GET", f"{murl}{path}", timeout=30)


    def start_filer(workers: int, front: str, log: str) -> str:
        env = dict(nocache)
        if front:
            env["SEAWEEDFS_TPU_ASYNC_FRONT"] = front
        (url,) = _start_procs(
            [["filer", "-port", "0", "-master", murl, "-store", store,
              "-collection", coll, "-workers", str(workers)]],
            [os.path.join(tmp, log)], fleet, "filer",
            line=r"filer listening on (\S+:\d+)\n", env_extra=env)
        parent = fleet[-1]
        if workers > 1:
            # poll for the siblings, never a fixed sleep: they re-exec
            # the command line and each takes seconds to listen
            poll(lambda: len(_children(parent.pid)) == workers - 1 and
                 len(_sibling_views(url, workers, tries=4 * workers))
                 == workers, f"{workers - 1} siblings of {url}", 120.0)
        return url

    def stop_filer() -> None:
        bad = _stop_peers(fleet)
        fleet.clear()
        check(not bad, f"the filer fleet did not stop: {bad}")

    def put(furl, item):
        path, (sd, nid, size) = item
        t = time.perf_counter()
        st, ans, _ = http_bytes("POST", f"{furl}{path}",
                                _payload(sd, nid, size),
                                {"Content-Type": "application/octet-stream"},
                                timeout=60)
        ms = (time.perf_counter() - t) * 1e3
        check(st == 201, f"POST {path}: {st} {ans[:200]!r}")
        return ms

    def read(furl, path):
        sd, nid, size = files[path]
        t = time.perf_counter()
        st, body, _ = http_bytes("GET", f"{furl}{path}", timeout=120)
        ms = (time.perf_counter() - t) * 1e3
        check(st == 200 and body == _payload(sd, nid, size),
              f"GET {path}: {st}, {len(body)} bytes")
        return ms

    def run(fn, items):
        t = time.perf_counter()
        with ThreadPoolExecutor(FLEET_C) as pool:
            ms = list(pool.map(fn, items))
        secs = time.perf_counter() - t
        return {"files": len(ms), "seconds": secs,
                "files_per_s": len(ms) / secs, **_pcts(ms)}

    def plane_pass(furl, views, tag) -> dict:
        """Creates sent to each sibling's meta plane and reads to its
        read plane (a plane's 404 replayed on the shared port), so the
        drains have plane records to count."""
        host = furl.split(":")[0]
        acked = native_reads = 0
        for n, (mport, rport) in enumerate(sorted(views)):
            paths = [f"/{tag}/plane{n}/f{i:03d}" for i in range(64)]
            for i, path in enumerate(paths):
                body = _payload(seed + 70, n * 1000 + i, 1024)
                st, _, _ = http_bytes("POST", f"{host}:{mport}{path}",
                                      body, timeout=30)
                if st == 201:
                    acked += 1
                else:
                    check(st == 404, f"meta plane {path}: {st}")
                    st, _, _ = http_bytes("POST", f"{furl}{path}", body,
                                          timeout=30)
                    check(st == 201, f"replayed {path}: {st}")
                files[path] = (seed + 70, n * 1000 + i, 1024)
            for path in paths:
                want = _payload(*files[path])
                st, body, _ = http_bytes("GET", f"{host}:{rport}{path}",
                                         timeout=30)
                if st == 200:
                    check(body == want, f"read plane {path}: bytes differ")
                    native_reads += 1
                else:
                    check(st == 404, f"read plane {path}: {st}")
                    check(read(furl, path) >= 0, path)
        return {"meta_plane_acked": acked, "read_plane_served":
                native_reads, "files": 64 * len(views)}

    def kill_sibling(furl, tag) -> dict:
        """A sibling SIGKILLed mid-load; every acked file read back."""
        parent = fleet[-1]
        kids = _children(parent.pid)
        acked: dict = {}
        lock = threading.Lock()
        stop = threading.Event()
        counter = itertools.count()

        def writer():
            while not stop.is_set():
                i = next(counter)
                path = f"/{tag}/kill/f{i:05d}"
                body = _payload(seed + 71, i, 1024)
                try:
                    st, _, _ = http_bytes("POST", f"{furl}{path}", body,
                                          timeout=30)
                except OSError:
                    continue
                if st == 201:
                    with lock:
                        acked[path] = (seed + 71, i, 1024)
        threads = [threading.Thread(target=writer) for _ in range(FLEET_C)]
        for t in threads:
            t.start()
        time.sleep(FLEET_KILL_S)
        victim = kids[0]
        os.kill(victim, signal.SIGKILL)
        t_kill = time.perf_counter()
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        check(acked, "no file was acked before the kill")
        files.update(acked)
        reads = run(lambda pth: read(furl, pth), sorted(acked))
        poll(lambda: len(_children(parent.pid)) == len(kids) and
             victim not in _children(parent.pid),
             f"the parent respawns sibling {victim}", 60.0)
        poll(lambda: len(_sibling_views(furl, FLEET_WORKERS,
                                        tries=4 * FLEET_WORKERS))
             == FLEET_WORKERS, "the respawned sibling serves", 120.0)
        return {"killed_pid": victim, "acked": len(acked),
                "read_back_equal": len(acked), "read_back": reads,
                "respawn_seconds": time.perf_counter() - t_kill}

    try:
        (murl,) = _start_procs(
            [["master", "-port", "0", "-volumeSizeLimitMB",
              str(limit_mb)]], [os.path.join(tmp, "master.log")], procs,
            "master")
        urls = _start_procs(
            [["volume", "-dir", dd, "-port", "0", "-mserver", murl,
              "-max", str(WRITE_MAX_VOLUMES), "-device", device]
             for dd in dirs], [dd + ".log" for dd in dirs], procs, "volume",
            env_extra=nocache)
        poll(lambda: len(get("/cluster/status")["dataNodes"]) == len(urls),
             "3 volume servers registered")
        start_s = time.perf_counter() - phase_t0

        arms = {}
        for n_arm, (name, workers, front) in enumerate(FLEET_ARMS):
            if fleet:
                stop_filer()
            t_arm = time.perf_counter()
            furl = start_filer(workers, front, f"filer_{name}.log")
            boot_s = time.perf_counter() - t_arm
            small = [(f"/{name}/small/f{i:05d}",
                      (seed + 60 + n_arm, i, 1024)) for i in range(small_n)]
            large = [(f"/{name}/large/f{i:04d}",
                      (seed + 60 + n_arm, 100_000 + i, 64 << 10))
                     for i in range(large_n)]
            for path, spec in small + large:
                files[path] = spec
            arm = {"workers": workers, "front": front or "threaded",
                   "boot_seconds": boot_s}
            arm["post_1KiB"] = run(lambda it: put(furl, it), small)
            arm["post_64KiB"] = run(lambda it: put(furl, it), large)
            profile = None
            top = None
            if workers > 1:
                # the sampler on every sibling while the GETs run: one
                # keep-alive connection a sibling, found by plane port
                host, port = furl.split(":")
                conns = {}
                for _ in range(20 * workers):
                    if len(conns) == workers:
                        break
                    c = http.client.HTTPConnection(host, int(port),
                                                   timeout=30)
                    c.request("GET", "/status")
                    st = json.loads(c.getresponse().read())
                    key = (st["metaPlanePort"], st["readPlanePort"])
                    if key in conns:
                        c.close()
                        continue
                    c.request("POST", "/debug/pprof",
                              json.dumps({"action": "start",
                                          "hz": 100}).encode(),
                              {"Content-Type": "application/json"})
                    armed = json.loads(c.getresponse().read())
                    check(armed.get("running"), f"pprof start: {armed}")
                    conns[key] = c
                check(len(conns) == workers,
                      f"the sampler armed on {len(conns)} siblings")
                tops = []
                tt = threading.Thread(target=lambda: tops.append(
                    commands.run_script(commands.CommandEnv(
                        murl, filer=furl), "cluster.top -interval=1")[0]))
                tt.start()
            arm["get_1KiB"] = run(lambda it: read(furl, it[0]), small)
            arm["get_64KiB"] = run(lambda it: read(furl, it[0]), large)
            if workers > 1:
                tt.join(timeout=60)
                top = tops[0] if tops else None
                tables, per = [], {}
                for key, c in conns.items():
                    c.request("POST", "/debug/pprof",
                              json.dumps({"action": "stop"}).encode(),
                              {"Content-Type": "application/json"})
                    snap = json.loads(c.getresponse().read())
                    c.close()
                    tables.append(snap.get("folded") or {})
                    per[str(key)] = {"samples": snap["samples"],
                                     "overhead": snap["overhead"]}
                merged = profiling.merge_folded(tables)
                total = sum(merged.values()) or 1
                profile = {"siblings": per, "stacks": len(merged),
                           "top": [[round(n / total * 100, 2),
                                    ";".join(s.split(";")[-3:])]
                                   for s, n in sorted(
                                       merged.items(),
                                       key=lambda kv: -kv[1])[:5]]}
                views = _sibling_views(furl, workers)
                arm["plane_pass"] = plane_pass(furl, views, name)
            views = _sibling_views(furl, workers)
            check(len(views) == workers,
                  f"{name}: {len(views)} of {workers} siblings answered")
            arm["instruments"] = _fleet_instruments(views)
            arm["profile"] = profile
            arm["cluster_top"] = top.splitlines() if top else None
            if workers > 1:
                check(all(s["tree_procs"] >= workers for s in
                          arm["instruments"]["per_sibling"]),
                      f"{name}: the process tree "
                      f"{arm['instruments']['per_sibling']}")
                arm["sigkill"] = kill_sibling(furl, name)
            arms[name] = arm
            print(json.dumps({"filer_fleet_arm": name, **{
                k: arm[k] for k in ("post_1KiB", "post_64KiB", "get_1KiB",
                                    "get_64KiB")}}), flush=True)
        # the last fleet (4 workers, the asyncio front) stays up
        furl_ec = furl

        # the seal: the volume holding the most of the collection's files
        vols = [v for _n, v in iter_volume_list_volumes(get("/vol/list"))
                if v.get("collection") == coll]
        target = max(vols, key=lambda v: v.get("fileCount", 0))["id"]
        (loc,) = operation.lookup(murl, target, use_cache=False)
        tdir = dirs[urls.index(loc["url"])]
        dat = os.path.join(tdir, f"{coll}_{target}.dat")
        frng = np.random.default_rng(seed)
        lock = threading.Lock()
        fill: list = []
        stop = threading.Event()
        counter = itertools.count(1)

        def filler():
            while not stop.is_set():
                a = operation.assign(murl, collection=coll)
                with lock:
                    nid = next(counter)
                    size = int(frng.integers(256 << 10, 4 << 20))
                fid = str(FileId(target, int(a.fid.split(",")[1][:-8], 16),
                                 _cookie(nid)))
                operation.upload(loc["url"], fid, _payload(seed, nid, size))
                with lock:
                    fill.append((fid, nid, size))
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            futs = [pool.submit(filler) for _ in range(FILL_WRITERS)]
            try:
                while not any(f.done() for f in futs) and \
                        os.path.getsize(dat) < limit_mb << 20:
                    time.sleep(0.05)
            finally:
                stop.set()
            for f in futs:
                f.result()
        fill_s = time.perf_counter() - t
        size = os.path.getsize(dat)
        check(size >= limit_mb << 20, f"volume {target}: {size} bytes")
        poll(lambda: all(v["size"] == size for _n, v in
                         iter_volume_list_volumes(get("/vol/list"))
                         if v["id"] == target), "the master sees the size")

        # ec.encode on the card; the shards held to the host codec's
        twin = os.path.join(tmp, "twin")
        os.makedirs(twin)
        for ext in (".dat", ".idx"):
            shutil.copyfile(dat[:-4] + ext,
                            os.path.join(twin, f"{coll}_{target}{ext}"))
        host = rs_native.ReedSolomonNative(d, p)

        class _HostCtx(ECContext):
            def create_codec(self):
                return pytypes.SimpleNamespace(parity_lazy=host.parity)
        ec_encoder.write_ec_files(os.path.join(twin, f"{coll}_{target}"),
                                  _HostCtx(d, p, device="cpu"))
        twin_sha = [sha256_file(os.path.join(twin, f"{coll}_{target}" +
                                             ECContext().to_ext(i)))
                    for i in range(d + p)]
        shutil.rmtree(twin, ignore_errors=True)
        ctx = ECContext(d, p, device="cpu")
        enc_expect = sum(launches_for(d, item[3]) for item in
                         ec_encoder._encode_work_items(size, ctx))
        env = commands.CommandEnv(murl)
        before = _counters(urls)["launches"]
        t = time.perf_counter()
        out = commands.run_script(
            env, f"lock; ec.encode -volumeId={target} -collection={coll}; "
                 f"unlock")
        enc_s = time.perf_counter() - t
        enc_launches = int(_counters(urls)["launches"] - before)
        check("scatter-encoded 14 shards" in out[1], f"encode: {out}")
        check(enc_launches == enc_expect,
              f"the encode launched {enc_launches}, the windows of its "
              f"work list are {enc_expect}")

        def ec_locs():
            return {x["url"]: x["shardIds"] for x in get(
                f"/dir/ec_lookup?volumeId={target}").get(
                    "shardIdLocations", [])}
        poll(lambda: sorted(s for ids in ec_locs().values()
                            for s in ids) == list(range(d + p)),
             "14 shards listed")
        shard_sha = []
        for i in range(d + p):
            name = f"{coll}_{target}" + ECContext().to_ext(i)
            (path,) = [os.path.join(dd, name) for dd in dirs
                       if os.path.exists(os.path.join(dd, name))]
            shard_sha.append(sha256_file(path))
        check(shard_sha == twin_sha,
              "the card's shards differ from the host codec's: " + str(
                  [i for i in range(d + p) if shard_sha[i] != twin_sha[i]]))

        def read_all(what):
            c0 = _counters(urls)
            r = run(lambda pth: read(furl_ec, pth), sorted(files))
            dlt = _delta(_counters(urls), c0)
            check(dlt["launches"] == 0,
                  f"{what}: the reads launched {dlt['launches']}")
            return {**r, "degraded_reads": dlt["degraded"],
                    "engines": dlt["engines"],
                    "kernel_launches": int(dlt["launches"])}

        # four data shards lost; every file read through the fleet
        placement = ec_locs()
        for u, ids in placement.items():
            gone = [s for s in ids if s in FLEET_LOST]
            if gone:
                _post(f"{u}/admin/ec/delete_shards",
                      {"volumeId": target, "collection": coll,
                       "shardIds": gone}, f"fleet-loss-{u}")
        poll(lambda: sorted(s for ids in ec_locs().values()
                            for s in ids) ==
             [s for s in range(d + p) if s not in FLEET_LOST],
             "the master lists 10 shards")
        degraded = read_all("degraded")
        check(degraded["degraded_reads"] > 0,
              f"the loss of {FLEET_LOST} made no degraded read: {degraded}")
        check(all(e.startswith("native/") for e in degraded["engines"]),
              f"degraded reads rebuilt by {degraded['engines']}")
        shard_size = int(http_json(
            "GET", f"{next(iter(ec_locs()))}/admin/ec/info?volumeId="
                   f"{target}", timeout=30)["shardSize"])
        step = rebuild_step(shard_size, ctx, rebuild_slice_bytes())
        reb_expect = sum(launches_for(d, min(step, shard_size - pos))
                         for pos in range(0, shard_size, step))
        before = _counters(urls)["launches"]
        t = time.perf_counter()
        out = commands.run_script(
            env, f"lock; ec.rebuild -volumeId={target} -collection={coll}; "
                 f"unlock")
        reb_s = time.perf_counter() - t
        reb_launches = int(_counters(urls)["launches"] - before)
        check(f"rebuilt shards {list(FLEET_LOST)} on " in out[1],
              f"rebuild of {target}: {out}")
        check(reb_launches == reb_expect,
              f"the rebuild launched {reb_launches}, the windows of its "
              f"steps are {reb_expect}")
        poll(lambda: sorted(s for ids in ec_locs().values()
                            for s in ids) == list(range(d + p)),
             "14 shards listed again")
        for u in urls:
            http_json("POST", f"{u}/admin/ec/unmount",
                      {"volumeId": target, "shardIds": []}, timeout=30)
        rebuilt = read_all("rebuilt")
        check(rebuilt["degraded_reads"] == 0,
              f"degraded reads after the rebuild: {rebuilt}")
    finally:
        bad = _stop_peers(fleet) + _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"a server of the fleet's cluster did not stop: {bad}")
    fill_bytes = sum(x[2] for x in fill)
    out = {"phase": "filer_fleet", "servers": FLEET_SERVERS,
           "workers": FLEET_WORKERS, "client_threads": FLEET_C,
           "cuts": {"files_an_arm": small_n + large_n,
                    "servers": {"run": FLEET_SERVERS, "why": "one host"},
                    "caches": "SEAWEEDFS_TPU_READ_CACHE_MB=0 on the filer "
                              "and the volume servers"},
           "cluster_start_seconds": start_s, "arms": arms,
           "seal": {"volume": target, "needles": len(fill),
                    "bytes": fill_bytes, "seconds": fill_s,
                    "gbps": fill_bytes / fill_s / 1e9},
           "encode": {"volume": target, "bytes": size, "seconds": enc_s,
                      "gbps": size / enc_s / 1e9, "launches": enc_launches,
                      "windows": enc_expect,
                      "shards_sha256_equal_host_codec": True,
                      "host_codec": rs_native.gf_native_simd()},
           "loss": {"lost_shards": list(FLEET_LOST), "degraded": degraded},
           "rebuild": {"seconds": reb_s, "launches": reb_launches,
                       "windows": reb_expect, "after": rebuilt},
           "launches": {"encode": enc_launches, "rebuild": reb_launches,
                        "reads": degraded["kernel_launches"] +
                        rebuilt["kernel_launches"]},
           "phase_seconds": time.perf_counter() - phase_t0}
    emit(out)
    return out


QOS_SERVERS = 7
QOS_COLLECTION = "qos"               # volumes A-D: config 1's needles
QOS_FG_COLLECTION = "fg"             # the foreground's 1 KiB files
QOS_FG_N = 2_048
QOS_FG_C = 16                        # foreground client threads
QOS_BIG_MB = 1024                    # volumes A and B (config 1's volume)
QOS_SMALL_MB = 128                   # volumes C and D, cut (PERF.md §4)
QOS_LOST = (1, 4, 7, 9)              # A's shards deleted before ec.rebuild
QOS_NOISY_RPS = 20                   # [qos.tenants.noisy]
QOS_QUIET_S = 2.0                    # foreground alone before an encode
QOS_SAMPLE = 32                      # C's and D's needles read back
QOS_TOML = """[qos]
slo_p99_ms = 1000
pace_min_ms = 25
pace_max_ms = 200
check_interval_ms = 250
[qos.tenants.noisy]
rps = {rps}
burst = {rps}
"""


def phase_qos_chaos(tmp: str, seed: int, fg_n: int = QOS_FG_N,
                    big_mb: int = QOS_BIG_MB, small_mb: int = QOS_SMALL_MB,
                    device: str = "cuda") -> dict:
    """The QoS plane, the fault sites and the retry policy on the card's
    encode and rebuild.  A master, 7 `volume` servers and a filer, all
    started with one `-securityToml` that carries only `[qos]` (an SLO,
    `pace_min_ms = 25`, `pace_max_ms = 200`, `check_interval_ms = 250`
    and a `[qos.tenants.noisy]` rate limit).  A foreground runs for the
    whole phase: 16 threads GET 2,048 1 KiB needles with the pooled
    client, from each volume's native read plane (a fallback 404 replayed
    on its Python port).  Steps, each printed on its JSON line:
    1. the unpaced arm: volume A filled with config 1's needles to
       1 GiB, the SLO set to 0 on every volume server (`POST /debug/qos`),
       `ec.encode` on the card under the foreground (wall, launches
       against windows, the foreground's p50/p99 before and during, the
       source's throttle signal during);
    2. the paced arm: volume B the same, with the SLO at half the
       source's throttle signal of step 1: `qos_ec_paced_total{kind=
       "encode"}` must move by the SLO loop alone (no `paceMs` is ever
       set), and the pace's peak is read off `/debug/qos`;
    3. A's shards 1, 4, 7 and 9 deleted, `volume.shard_read.serve=
       truncate,n=1` armed on every donor, `ec.rebuild` on the card: at
       least one failover, launches equal to the windows, every rebuilt
       shard equal to the lost one;
    4. volume C (128 MiB) encoded with `ec.encode.window=drop,n=1,match=
       <victim>` on its source: the scatter is re-planned (counted), no
       shard lands on the victim, a sample of C's needles reads back;
    5. volume D (128 MiB) with `ec.encode.window=truncate,n=1,match=
       <victim>`: re-planned, nothing of D on the victim, no temp file
       left, and a short upload committed with its promised count is
       refused (409, "mismatch");
    6. lookups through the retries: `httpd.pool.request=error,n=3` to
       the master armed in this process and `master.lookup=delay` on the
       master; the reads succeed, the retries are counted, the budget
       drops; then `master.lookup=error,n=2` answers two lookups with an
       error (not retried: an answer, not a transport failure);
    7. `X-Tenant: noisy` at twice its rate against the filer: 503 with
       `Retry-After`, counted in `qos_rejected_total{reason="rate"}`,
       while the anonymous foreground sees no 503.
    Every step clears the faults on every role."""
    import numpy as np

    from seaweedfs_tpu_torch import faults, operation, stats
    from seaweedfs_tpu_torch.server.httpd import (http_bytes, http_json,
                                                  http_stream_request)
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.storage.types import FileId
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes
    from seaweedfs_tpu_torch.util import retry

    phase_t0 = time.perf_counter()
    os.makedirs(tmp)
    d, p = 10, 4
    coll = QOS_COLLECTION
    toml = os.path.join(tmp, "security.toml")
    with open(toml, "w") as f:
        f.write(QOS_TOML.format(rps=QOS_NOISY_RPS))
    sec = ["-securityToml", toml]
    dirs = [os.path.join(tmp, f"s{i}") for i in range(QOS_SERVERS)]
    for dd in dirs:
        os.makedirs(dd)
    procs: list = []
    steps: dict = {}
    fg_log: list = []             # (start, ms, status) of every fg GET
    fg_lock = threading.Lock()
    fg_stop = threading.Event()
    ctx = ECContext(d, p, device="cpu")

    def get(path):
        return http_json("GET", f"{murl}{path}", timeout=30)


    def lever(url, route, body):
        r = http_json("POST", f"{url}/debug/{route}", body, timeout=30)
        check("error" not in r, f"{url}/debug/{route} {body}: {r}")
        return r

    def clear_faults():
        for u in [murl, furl, *urls]:
            lever(u, "faults", {"clear": True})
        faults.reset()

    def metric(url, name, **labels):
        text = http_bytes("GET", f"{url}/metrics", timeout=60)[1].decode()
        return sum(v for lb, v in _full_samples(text, name)
                   if all(lb.get(k) == w for k, w in labels.items()))

    def fg_window(t0, t1) -> dict:
        with fg_lock:
            got = [(ms, st) for t, ms, st in fg_log if t0 <= t < t1]
        ms = [m for m, _ in got]
        check(ms, "the foreground made no request in a window")
        with fg_lock:
            span = min(t1, fg_log[-1][0]) - max(t0, fg_log[0][0])
        return {"requests": len(ms),
                "rps": len(ms) / max(span, 1e-9),
                "status_503": sum(st == 503 for _, st in got),
                "errors": sum(st not in (200, 503) for _, st in got),
                **_pcts(ms)}

    def foreground(fids, planes, rng_seed):
        rng = np.random.default_rng(rng_seed)
        while not fg_stop.is_set():
            fid, url = fids[int(rng.integers(len(fids)))]
            host = url.rsplit(":", 1)[0]
            t = time.perf_counter()
            try:
                st, body, _ = http_bytes(
                    "GET", f"{host}:{planes[url]}/{fid}", timeout=30)
                if st == 404:
                    st, body, _ = http_bytes("GET", f"{url}/{fid}",
                                             timeout=30)
            except OSError:
                st = -1
            ms = (time.perf_counter() - t) * 1e3
            with fg_lock:
                fg_log.append((t, ms, st))

    def fill(vid, url, target_mb, seed_off):
        ddir = dirs[urls.index(url)]
        dat = os.path.join(ddir, f"{coll}_{vid}.dat")
        frng = np.random.default_rng([seed, seed_off])
        lock = threading.Lock()
        out: list = []
        stop = threading.Event()
        counter = itertools.count(1)

        def filler():
            while not stop.is_set():
                a = operation.assign(murl, collection=coll)
                with lock:
                    nid = next(counter)
                    size = int(frng.integers(256 << 10, 4 << 20))
                fid = str(FileId(vid, int(a.fid.split(",")[1][:-8], 16),
                                 _cookie(nid)))
                operation.upload(url, fid, _payload(seed + seed_off, nid,
                                                    size))
                with lock:
                    out.append((fid, nid, size))
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            futs = [pool.submit(filler) for _ in range(FILL_WRITERS)]
            try:
                while not any(f.done() for f in futs) and \
                        os.path.getsize(dat) < target_mb << 20:
                    time.sleep(0.05)
            finally:
                stop.set()
            for f in futs:
                f.result()
        size = os.path.getsize(dat)
        poll(lambda: all(v["size"] == size for _n, v in
                         iter_volume_list_volumes(get("/vol/list"))
                         if v["id"] == vid), f"the master sees {vid}'s size")
        return {"volume": vid, "needles": len(out), "bytes": size,
                "seconds": time.perf_counter() - t}, out

    def enc_windows(size):
        return sum(launches_for(d, item[3]) for item in
                   ec_encoder._encode_work_items(size, ctx))

    def ec_locs(vid):
        return {x["url"]: x["shardIds"] for x in get(
            f"/dir/ec_lookup?volumeId={vid}").get("shardIdLocations", [])}

    def encode(vid, what):
        before = _counters(urls)["launches"]
        t = time.perf_counter()
        out = commands.run_script(
            env, f"lock; ec.encode -volumeId={vid} -collection={coll}; "
                 f"unlock")
        secs = time.perf_counter() - t
        launches = int(_counters(urls)["launches"] - before)
        check("scatter-encoded 14 shards" in out[1], f"{what}: {out}")
        poll(lambda: sorted(s for ids in ec_locs(vid).values()
                            for s in ids) == list(range(d + p)),
             f"{what}: 14 shards listed")
        return secs, launches, out[1].strip()

    def watch_source(url, samples, stop):
        while not stop.is_set():
            try:
                th = http_json("GET", f"{url}/debug/qos",
                               timeout=10)["throttle"]
                samples.append((time.perf_counter(), th["lastP99Ms"],
                                th["paceMs"]))
            except OSError:
                pass
            stop.wait(0.1)

    def encode_arm(vid, url, what):
        samples: list = []
        stop = threading.Event()
        paced0 = metric(url, "seaweedfs_tpu_qos_ec_paced_total",
                        kind="encode")
        time.sleep(QOS_QUIET_S)
        t_enc = time.perf_counter()
        w = threading.Thread(target=watch_source, args=(url, samples, stop))
        w.start()
        try:
            secs, launches, msg = encode(vid, what)
        finally:
            stop.set()
            w.join(timeout=30)
        t_end = time.perf_counter()
        sig = [s[1] for s in samples if t_enc <= s[0] <= t_end and s[1] > 0]
        return {"volume": vid, "source": url, "seconds": secs,
                "launches": launches, "message": msg,
                "foreground_before": fg_window(t_enc - QOS_QUIET_S, t_enc),
                "foreground_during": fg_window(t_enc, t_end),
                "source_signal_p99_ms": {
                    "samples": len(sig),
                    "median": statistics.median(sig) if sig else 0.0,
                    "max": max(sig) if sig else 0.0},
                "pace_ms_peak": max((s[2] for s in samples), default=0.0),
                "paced_windows": int(metric(
                    url, "seaweedfs_tpu_qos_ec_paced_total",
                    kind="encode") - paced0)}

    furl = ""
    try:
        (murl,) = _start_procs(
            [[*sec, "master", "-port", "0", "-volumeSizeLimitMB",
              str(big_mb)]], [os.path.join(tmp, "master.log")], procs,
            "master")
        urls = _start_procs(
            [[*sec, "volume", "-dir", dd, "-port", "0", "-mserver", murl,
              "-max", str(WRITE_MAX_VOLUMES), "-device", device]
             for dd in dirs], [dd + ".log" for dd in dirs], procs, "volume")
        (furl,) = _start_procs(
            [[*sec, "filer", "-port", "0", "-master", murl, "-store",
              os.path.join(tmp, "filer.db")]],
            [os.path.join(tmp, "filer.log")], procs, "filer",
            line=r"filer listening on (\S+:\d+)\n")
        poll(lambda: len(get("/cluster/status")["dataNodes"]) == len(urls),
             "7 volume servers registered")
        for u in [murl, furl, *urls]:
            snap = http_json("GET", f"{u}/debug/qos", timeout=30)
            check(snap["config"]["tenants"].get("noisy", {}).get("rps") ==
                  QOS_NOISY_RPS and snap["config"]["sloP99Ms"] == 1000,
                  f"{u} did not load [qos]: {snap['config']}")
        env = commands.CommandEnv(murl)
        start_s = time.perf_counter() - phase_t0

        # the foreground's files, and each server's read plane
        t = time.perf_counter()
        with ThreadPoolExecutor(QOS_FG_C) as pool:
            fg_fids = list(pool.map(
                lambda i: operation.submit(murl, _payload(seed + 90, i, 1024),
                                           collection=QOS_FG_COLLECTION),
                range(fg_n)))
        fg_write_s = time.perf_counter() - t
        planes = {u: http_json("GET", f"{u}/status", timeout=30).get(
            "readPlanePort") or int(u.rsplit(":", 1)[1]) for u in urls}
        locs = {}
        fids = []
        for fid in fg_fids:
            vid = int(fid.split(",")[0])
            if vid not in locs:
                locs[vid] = operation.lookup(murl, vid)[0]["url"]
            fids.append((fid, locs[vid]))
        for fid, _u in fids[:64]:
            check(operation.read(murl, fid) ==
                  _payload(seed + 90, fg_fids.index(fid), 1024),
                  f"foreground file {fid}")
        fg_threads = [threading.Thread(target=foreground,
                                       args=(fids, planes, seed + i))
                      for i in range(QOS_FG_C)]
        for th in fg_threads:
            th.start()

        # volumes A-D: a growth of 7, one on each server
        _post(f"{murl}/vol/grow", {"collection": coll, "count": QOS_SERVERS},
              "qos-grow")
        vols = sorted((v["id"], n) for n, v in
                      iter_volume_list_volumes(get("/vol/list"))
                      if v.get("collection") == coll)
        check(len(vols) >= 4, f"the {coll} collection grew {vols}")
        by_vid = {}
        for vid, _n in vols:
            (loc,) = operation.lookup(murl, vid, use_cache=False)
            by_vid[vid] = loc["url"]
        picked, seen_urls = [], set()
        for vid in sorted(by_vid):
            if by_vid[vid] not in seen_urls and len(picked) < 4:
                picked.append(vid)
                seen_urls.add(by_vid[vid])
        check(len(picked) == 4, f"four volumes on four servers: {by_vid}")
        va, vb, vc, vd = picked

        # 1. the unpaced arm
        fill_a, _ = fill(va, by_vid[va], big_mb, 1)
        for u in urls:
            lever(u, "qos", {"sloP99Ms": 0})
        arm1 = encode_arm(va, by_vid[va], "unpaced encode of A")
        arm1["windows"] = enc_windows(fill_a["bytes"])
        arm1["fill"] = fill_a
        check(arm1["launches"] == arm1["windows"],
              f"A: {arm1['launches']} launches, {arm1['windows']} windows")
        check(arm1["paced_windows"] == 0, f"the unpaced arm paced: {arm1}")
        steps["unpaced"] = arm1
        emit({"phase": "qos_chaos", "step": "unpaced", **arm1})

        # 2. the paced arm: the SLO at half the source's signal in step 1
        fill_b, _ = fill(vb, by_vid[vb], big_mb, 2)
        slo = arm1["source_signal_p99_ms"]["median"] / 2
        check(slo > 0, f"step 1 saw no foreground signal: {arm1}")
        for u in urls:
            lever(u, "qos", {"sloP99Ms": slo})
        arm2 = encode_arm(vb, by_vid[vb], "paced encode of B")
        for u in urls:
            lever(u, "qos", {"sloP99Ms": 0})
        arm2["windows"] = enc_windows(fill_b["bytes"])
        arm2["fill"] = fill_b
        arm2["slo_p99_ms"] = slo
        check(arm2["launches"] == arm2["windows"],
              f"B: {arm2['launches']} launches, {arm2['windows']} windows")
        check(arm2["paced_windows"] > 0 and arm2["pace_ms_peak"] > 0,
              f"the SLO loop never paced B's windows: {arm2}")
        steps["paced"] = arm2
        emit({"phase": "qos_chaos", "step": "paced", **arm2})

        # 3. a rebuild of A whose donors truncate their first serve
        t3 = time.perf_counter()
        shard_paths = {}
        for i in QOS_LOST:
            name = f"{coll}_{va}" + ECContext().to_ext(i)
            (path,) = [os.path.join(dd, name) for dd in dirs
                       if os.path.exists(os.path.join(dd, name))]
            shard_paths[i] = (path, sha256_file(path))
        for u, ids in ec_locs(va).items():
            gone = [s for s in ids if s in QOS_LOST]
            if gone:
                _post(f"{u}/admin/ec/delete_shards",
                      {"volumeId": va, "collection": coll,
                       "shardIds": gone}, f"qos-loss-{u}")
        poll(lambda: sorted(s for ids in ec_locs(va).values()
                            for s in ids) ==
             [s for s in range(d + p) if s not in QOS_LOST],
             "the master lists 10 shards of A")
        for u in urls:
            lever(u, "faults", {"spec": "volume.shard_read.serve="
                                        "truncate,n=1"})
        shard_size = int(http_json(
            "GET", f"{next(iter(ec_locs(va)))}/admin/ec/info?volumeId="
                   f"{va}", timeout=30)["shardSize"])
        step = rebuild_step(shard_size, ctx, rebuild_slice_bytes())
        reb_expect = sum(launches_for(d, min(step, shard_size - pos))
                         for pos in range(0, shard_size, step))
        c0 = _counters(urls)
        t = time.perf_counter()
        out = commands.run_script(
            env, f"lock; ec.rebuild -volumeId={va} -collection={coll}; "
                 f"unlock")
        reb_s = time.perf_counter() - t
        dlt = _delta(_counters(urls), c0)
        check(f"rebuilt shards {list(QOS_LOST)} on " in out[1],
              f"rebuild of A: {out}")
        fired = sum(http_json("GET", f"{u}/debug/faults", timeout=30)
                    ["triggered"].get("volume.shard_read.serve", 0)
                    for u in urls)
        clear_faults()
        check(dlt["failovers"] >= 1 and fired >= 1,
              f"no failover in the rebuild: {dlt}, {fired} truncations")
        check(dlt["launches"] == reb_expect,
              f"the rebuild launched {dlt['launches']}, its windows are "
              f"{reb_expect}")
        for i, (path, sha) in shard_paths.items():
            name = os.path.basename(path)
            (now,) = [os.path.join(dd, name) for dd in dirs
                      if os.path.exists(os.path.join(dd, name))]
            check(sha256_file(now) == sha, f"rebuilt shard {i} differs")
        steps["rebuild"] = {
            "volume": va, "lost": list(QOS_LOST), "seconds": reb_s,
            "launches": dlt["launches"], "windows": reb_expect,
            "failovers": dlt["failovers"], "truncations": fired,
            "rebuilt_equal": len(QOS_LOST),
            "foreground": fg_window(t, t + reb_s)}
        emit({"phase": "qos_chaos", "step": "rebuild", **steps["rebuild"]})

        def faulted_scatter(vid, fill_seed, directive, what):
            meta, needles = fill(vid, by_vid[vid], small_mb, fill_seed)
            source = by_vid[vid]
            victim = next(u for u in urls if u != source)
            lever(source, "faults", {"spec": f"ec.encode.window={directive},"
                                             f"n=1,match={victim}"})
            replans0 = metric(source, "volume_server_ec_scatter_replans_total")
            secs, launches, msg = encode(vid, what)
            fired = http_json("GET", f"{source}/debug/faults",
                              timeout=30)["triggered"].get(
                                  "ec.encode.window", 0)
            clear_faults()
            placed = ec_locs(vid)
            windows = enc_windows(meta["bytes"])
            replans = int(metric(
                source, "volume_server_ec_scatter_replans_total") - replans0)
            check(fired >= 1, f"{what}: the {directive} never fired")
            check(victim not in placed, f"{what}: a shard on the victim "
                                        f"{victim}: {placed}")
            check(replans >= 1, f"{what}: no replan counted")
            check(launches >= windows,
                  f"{what}: {launches} launches under {windows} windows")
            vdir = dirs[urls.index(victim)]
            check(not any(n.startswith(f"{coll}_{vid}.")
                          for n in os.listdir(vdir)),
                  f"{what}: files of {vid} on the victim")
            for fid, nid, size in needles[:QOS_SAMPLE]:
                check(operation.read(murl, fid) ==
                      _payload(seed + fill_seed, nid, size),
                      f"{what}: {fid} reads back different")
            return {"volume": vid, "source": source, "victim": victim,
                    "fill": meta, "seconds": secs, "launches": launches,
                    "windows": windows, "replans": replans,
                    "generate_calls": replans + 1,
                    "codec_reruns": launches / max(windows, 1),
                    "fired": fired, "read_back_equal": QOS_SAMPLE,
                    "message": msg}

        # 4. a destination dropped mid-scatter
        steps["scatter_drop"] = faulted_scatter(vc, 3, "drop",
                                                "scatter of C")
        emit({"phase": "qos_chaos", "step": "scatter_drop",
              **steps["scatter_drop"]})

        # 5. a truncated stream, then the commit handshake itself
        trunc = faulted_scatter(vd, 4, "truncate", "scatter of D")
        victim = trunc["victim"]
        st, _ = http_stream_request(
            "POST", f"{victim}/admin/ec/shard_write?volumeId=9999&shardId=0"
                    f"&collection={coll}&uploadId=qoschaos0",
            iter([b"x" * 1024]), timeout=30)
        check(st == 200, f"the short upload: {st}")
        st, body, _ = http_bytes(
            "POST", f"{victim}/admin/ec/shard_write_commit",
            json.dumps({"volumeId": 9999, "collection": coll,
                        "uploadId": "qoschaos0", "shardId": 0, "crc32": 1,
                        "bytes": 4096, "mount": True}).encode(),
            {"Content-Type": "application/json"}, timeout=30)
        check(st == 409 and b"mismatch" in body,
              f"the short shard was not refused: {st} {body[:200]!r}")
        check("error" in http_json("GET", f"{victim}/admin/ec/info?"
                                          f"volumeId=9999", timeout=30),
              "the refused shard was mounted")
        left = [n for dd in dirs for n in os.listdir(dd)
                if ".scatter." in n or ".recv." in n]
        check(not left, f"temp files left: {left}")
        trunc.update({"commit_refused": {"status": st,
                                         "body": body[:120].decode()},
                      "temp_files_left": 0})
        steps["scatter_truncate"] = trunc
        emit({"phase": "qos_chaos", "step": "scatter_truncate", **trunc})

        # 6. lookups through the retry policy
        operation._vid_cache._m.clear()
        retry.reset()
        r0 = stats.PROCESS.counter_sum("retry_attempts_total",
                                       site="httpd.pool")
        faults.arm_spec(f"httpd.pool.request=error,n=3,"
                        f"match={murl}/dir/lookup")
        lever(murl, "faults", {"spec": "master.lookup=delay,ms=100,n=2"})
        t = time.perf_counter()
        sample = fids[:8]
        for fid, _u in sample:
            operation._vid_cache._m.clear()
            check(operation.read(murl, fid) ==
                  _payload(seed + 90, fg_fids.index(fid), 1024),
                  f"lookup retry read {fid}")
        retries = stats.PROCESS.counter_sum("retry_attempts_total",
                                            site="httpd.pool") - r0
        budget = retry.budget_remaining()
        lookup_faults = http_json("GET", f"{murl}/debug/faults",
                                  timeout=30)["triggered"]
        client_fired = faults.triggered().get("httpd.pool.request", 0)
        clear_faults()
        lever(murl, "faults", {"spec": "master.lookup=error,n=2"})
        refused = 0
        for _ in range(3):
            try:
                operation.lookup(murl, va, use_cache=False)
            except LookupError:
                refused += 1
        clear_faults()
        check(client_fired == 3 and retries >= 1,
              f"the lookups rode no retry: {retries}, {client_fired}")
        check(budget < 64, f"the retry budget did not move: {budget}")
        check(refused == 2, f"master.lookup=error,n=2 refused {refused}")
        steps["lookups"] = {"reads": len(sample), "retries": int(retries),
                            "client_faults": client_fired,
                            "master_lookup_delays":
                                lookup_faults.get("master.lookup", 0),
                            "retry_budget_remaining": budget,
                            "lookup_errors_answered": refused,
                            "seconds": time.perf_counter() - t}
        emit({"phase": "qos_chaos", "step": "lookups", **steps["lookups"]})

        # 7. the noisy tenant at twice its rate against the filer
        path = "/qos/noisy.bin"
        st, _, _ = http_bytes("POST", f"{furl}{path}", b"q" * 1024,
                              timeout=30)
        check(st == 201, f"filer POST: {st}")
        codes = []
        retry_after = set()
        t7 = time.perf_counter()
        n7 = 4 * QOS_NOISY_RPS          # two seconds at twice the rate
        for i in range(n7):
            target = t7 + i / (2 * QOS_NOISY_RPS)
            time.sleep(max(0.0, target - time.perf_counter()))
            st, _, hdrs = http_bytes("GET", f"{furl}{path}",
                                     headers={"X-Tenant": "noisy"},
                                     timeout=30)
            codes.append(st)
            if st == 503:
                retry_after.add(hdrs.get("Retry-After"))
        t7e = time.perf_counter()
        anon = [http_bytes("GET", f"{furl}{path}", timeout=30)[0]
                for _ in range(32)]
        rejected = metric(furl, "seaweedfs_tpu_qos_rejected_total",
                          tenant="noisy", reason="rate")
        fgw = fg_window(t7, t7e)
        check(codes.count(503) > 0 and codes.count(200) > 0,
              f"the noisy tenant's codes: {codes}")
        check(all(ra and int(ra) >= 1 for ra in retry_after),
              f"Retry-After: {retry_after}")
        check(rejected >= codes.count(503),
              f"qos_rejected_total {rejected} < {codes.count(503)}")
        check(all(c == 200 for c in anon), f"anonymous filer GETs: {anon}")
        steps["tenant"] = {"noisy_requests": n7,
                           "noisy_rps": n7 / (t7e - t7),
                           "limit_rps": QOS_NOISY_RPS,
                           "admitted": codes.count(200),
                           "rejected_503": codes.count(503),
                           "retry_after": sorted(retry_after),
                           "qos_rejected_total": rejected,
                           "anonymous_filer_503": anon.count(503),
                           "foreground": fgw}
        emit({"phase": "qos_chaos", "step": "tenant", **steps["tenant"]})
    finally:
        fg_stop.set()
        for th in locals().get("fg_threads", []):
            th.join(timeout=60)
        faults.reset()
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"a server of the qos cluster did not stop: {bad}")
    whole = fg_window(0.0, float("inf"))
    check(whole["status_503"] == 0 and whole["errors"] == 0,
          f"the anonymous foreground saw 503s or errors: {whole}")
    out = {"phase": "qos_chaos", "servers": QOS_SERVERS,
           "client_threads": QOS_FG_C, "foreground_files": fg_n,
           "cuts": {"volumes_a_b_mb": big_mb, "volumes_c_d_mb": small_mb,
                    "servers": {"run": QOS_SERVERS, "why": "one host"}},
           "cluster_start_seconds": start_s,
           "foreground_write_seconds": fg_write_s,
           "foreground": whole, "steps": steps,
           "launches": {
               "encode": steps["unpaced"]["launches"] +
               steps["paced"]["launches"],
               "rebuild": steps["rebuild"]["launches"],
               "scatter": steps["scatter_drop"]["launches"] +
               steps["scatter_truncate"]["launches"]},
           "phase_seconds": time.perf_counter() - phase_t0}
    emit(out)
    return out


MAINT_SERVERS = 4
MAINT_MORE = 3                       # config 4's 7 servers after these
MAINT_COLLECTION = "maint"
MAINT_MB = 1024                      # volume A: config 1's volume
MAINT_SMALL = 8                      # small volumes of 1 KiB needles
MAINT_SMALL_N = 64                   # needles in each
MAINT_DELETE = 0.4                   # of A's bytes deleted before vacuum
MAINT_WRITERS = 4                    # threads writing A during the vacuum
MAINT_BIG_DELETES = 16               # large needles they delete at most
MAINT_REPAIR_N = 64                  # 1 KiB needles of the 001 volume
MAINT_REPAIR_DROP = 8                # of them deleted on one replica


def _parity_matches(shards: "list[str]", d: int, p: int,
                    chunk: int = 8 << 20) -> int:
    """Bytes of each parity shard file equal to the host codec's parity
    of the data shard files (the plain version of the kernel's apply,
    `ops/rs_native`, else `ops/rs_cpu`); fails on the first mismatch."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import rs_cpu, rs_native
    codec = rs_native.ReedSolomonNative(d, p) if rs_native.available() \
        else rs_cpu.ReedSolomonCPU(d, p)
    size = os.path.getsize(shards[0])
    check(all(os.path.getsize(f) == size for f in shards),
          "the shard files differ in size")
    files = [open(f, "rb") for f in shards]
    try:
        for off in range(0, size, chunk):
            rows = [np.frombuffer(f.read(chunk), dtype=np.uint8)
                    for f in files]
            want = codec.parity(np.stack(rows[:d]))
            check(np.array_equal(want, np.stack(rows[d:])),
                  f"parity differs at byte {off} of the shards")
    finally:
        for f in files:
            f.close()
    return size


def phase_maintenance(tmp: str, seed: int, big_mb: int = MAINT_MB,
                      small_n: int = MAINT_SMALL_N, device: str = "cuda"
                      ) -> dict:
    """The volume maintenance plane around an ec.encode and an
    ec.rebuild on the card.  A master, 4 `volume` servers, the admin and
    one worker with `-capabilities erasure_coding,vacuum,volume_balance,
    ec_balance`, all `python -m seaweedfs_tpu_torch` processes, on 2
    racks (2 and 2 servers, then 4 and 3).
    Steps, each printed on its JSON line:
    1. volume A filled to 1 GiB with config 1's needles (256 KiB-4 MiB),
       8 small volumes of 1 KiB needles on the first two servers, 40% of
       A's bytes deleted (chosen by seed);
    2. detection proposes the vacuum of A, which runs on the worker while
       4 threads append 1 KiB needles to A and delete older ones; every
       acked needle reads back equal over HTTP and the read plane, every
       deleted one answers 404, and the `.dat` shrank by 95% of the
       deleted bytes at least;
    3. A encoded on the card by the worker's `erasure_coding` job (the
       source's scatter-encode): launches equal to the compacted `.dat`'s
       [4,10] windows, parity equal to the host codec's;
    4. 3 more servers; detection proposes `ec_balance` (no server left
       with more than 2 of A's shards, and the ec_balance detection rule
       proposes nothing more: ROADMAP C19) and `volume_balance` (a
       max-min volume count of at most 2);
    5. a server holding 2 of A's shards stopped, `ec.rebuild` on the
       card: launches equal to the [2,10] windows, the rebuilt shards
       equal to the lost ones, every live needle of A read back from the
       EC volume and the moved volumes' needles from their new servers;
    6. repair: `volume.check.disk` after `/admin/delete_needle` took
       needles from one replica of a 001 volume, `volume.fix.replication`
       after that replica's server was stopped, and `volume.scrub` with
       no error."""
    import numpy as np

    from seaweedfs_tpu_torch import operation
    from seaweedfs_tpu_torch.plugin.handlers.balance import EcBalanceHandler
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.storage.types import FileId, parse_file_id
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes

    phase_t0 = time.perf_counter()
    os.makedirs(tmp)
    d, p = 10, 4
    coll = MAINT_COLLECTION
    va, repair_vid = 1, 200
    small_vids = list(range(100, 100 + MAINT_SMALL))
    dirs = [os.path.join(tmp, f"s{i}") for i in range(MAINT_SERVERS +
                                                       MAINT_MORE)]
    for dd in dirs:
        os.makedirs(dd)
    procs: list = []
    proc_of: dict = {}
    steps: dict = {}
    ctx = ECContext(d, p, device="cpu")

    def get(path):
        return http_json("GET", f"{murl}{path}", timeout=30)


    def admin(method, path, payload=None):
        r = http_json(method, f"{aurl}{path}", payload, timeout=60)
        check("error" not in r, f"admin {path}: {r}")
        return r

    def jobs_of(types_, submit=None, timeout=900.0):
        """Trigger detection (or submit a job) and wait for one new job of
        each type to end, done; their records by type."""
        before = {j["jobId"] for j in admin("GET", "/maintenance/queue")[
            "jobs"]}
        t = time.perf_counter()
        if submit is not None:
            admin("POST", "/maintenance/submit_job", submit)
        else:
            admin("POST", "/maintenance/trigger_detection")
        found: dict = {}

        def new():
            for j in admin("GET", "/maintenance/queue")["jobs"]:
                if j["jobId"] not in before and j["jobType"] in types_:
                    check(j["jobType"] not in found or
                          found[j["jobType"]] == j["jobId"],
                          f"two {j['jobType']} jobs proposed")
                    found[j["jobType"]] = j["jobId"]
            return len(found) == len(types_)
        poll(new, f"jobs {types_} proposed")
        out = {}
        for jt, jid in found.items():
            poll(lambda: admin("GET", f"/maintenance/job?id={jid}")[
                "status"] in ("done", "failed"), f"job {jid} ends", timeout)
            job = admin("GET", f"/maintenance/job?id={jid}")
            check(job["status"] == "done",
                  f"{jt} job: {job['message']} {job['trace'][-3:]}")
            job["wall_s"] = time.perf_counter() - t
            out[jt] = job
        return out

    def metric(url, name):
        text = http_bytes("GET", f"{url}/metrics", timeout=60)[1].decode()
        return sum(v for _lb, v in _full_samples(text, name))

    def ec_locs(vid):
        return {x["url"]: x["shardIds"] for x in get(
            f"/dir/ec_lookup?volumeId={vid}").get("shardIdLocations", [])}

    def volume_counts(live):
        counts = {u: 0 for u in live}
        for n, _v in iter_volume_list_volumes(get("/vol/list")):
            if n["url"] in counts:
                counts[n["url"]] += 1
        return counts

    def plane_get(url, fid):
        """A needle through the server's native read plane; a plane 404
        is replayed on the Python port (which registers it) and asked
        again."""
        host = url.rsplit(":", 1)[0]
        port = planes[url]
        st, body, _ = http_bytes("GET", f"{host}:{port}/{fid}", timeout=60)
        if st == 404:
            http_bytes("GET", f"{url}/{fid}", timeout=60)
            st, body, _ = http_bytes("GET", f"{host}:{port}/{fid}",
                                     timeout=60)
        return st, body

    def read_all(pairs, fn, what):
        """fn(fid) == data for each (fid, data), on 8 threads."""
        with ThreadPoolExecutor(8) as pool:
            bad = [fid for fid, ok in zip(
                [f for f, _ in pairs],
                pool.map(lambda fd: fn(fd[0]) == fd[1], pairs)) if not ok]
        check(not bad, f"{what}: {len(bad)} needles differ, first {bad[:3]}")
        return len(pairs)

    try:
        (murl,) = _start_procs(
            [["master", "-port", "0", "-volumeSizeLimitMB",
              str(2 * big_mb)]], [os.path.join(tmp, "master.log")], procs,
            "master")
        urls = _start_procs(
            [["volume", "-dir", dd, "-port", "0", "-mserver", murl, "-max",
              str(WRITE_MAX_VOLUMES), "-rack", f"r{i % 2}", "-device", device]
             for i, dd in enumerate(dirs[:MAINT_SERVERS])],
            [dd + ".log" for dd in dirs[:MAINT_SERVERS]], procs, "volume")
        proc_of.update(zip(urls, procs[1:]))
        (aurl,) = _start_procs(
            [["admin", "-port", "0", "-master", murl,
              "-detectionInterval", "3600",
              "-dataDir", os.path.join(tmp, "admin")]],
            [os.path.join(tmp, "admin.log")], procs, "admin",
            r"admin listening on (\S+:\d+)\n")
        _start_procs(
            [["worker", "-admin", aurl, "-master", murl,
              "-dir", os.path.join(tmp, "worker"), "-capabilities",
              "erasure_coding,vacuum,volume_balance,ec_balance",
              "-device", device]],
            [os.path.join(tmp, "worker.log")], procs, "worker",
            rf"worker (\w+) polling {re.escape(aurl)}\n")
        poll(lambda: len(get("/cluster/status")["dataNodes"]) == len(urls),
             "4 volume servers registered")
        poll(lambda: {"erasure_coding", "vacuum", "volume_balance",
                      "ec_balance"} <= set(admin(
                          "GET", "/maintenance/config")["jobTypes"]),
             "the worker's schemas")
        # the encode runs on the source server's card (its launches are
        # on its /metrics); the volume balance waits for step 4
        admin("POST", "/maintenance/config",
              {"jobType": "erasure_coding",
               "values": {"encodeMode": "scatter"}})
        admin("POST", "/maintenance/config",
              {"jobType": "volume_balance",
               "values": {"imbalanceThreshold": 1000}})
        env = commands.CommandEnv(murl)
        planes = {u: http_json("GET", f"{u}/status", timeout=30)[
            "readPlanePort"] or int(u.rsplit(":", 1)[1]) for u in urls}
        start_s = time.perf_counter() - phase_t0

        # 1. fill and delete
        ua = urls[0]
        _post(f"{ua}/admin/allocate_volume",
              {"volumeId": va, "collection": coll}, "maint-alloc")
        dat_a = os.path.join(dirs[0], f"{coll}_{va}.dat")
        rng = np.random.default_rng([seed, 77])
        sizes = []
        total = 0
        while total < big_mb << 20:
            sizes.append(int(rng.integers(256 << 10, 4 << 20)))
            total += sizes[-1]
        big = {}                       # fid -> (nid, size)

        def put(nid, size):
            fid = str(FileId(va, nid, _cookie(nid)))
            operation.upload(ua, fid, _payload(seed + 7, nid, size))
            return fid, (nid, size)
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            big.update(pool.map(lambda a: put(*a), enumerate(sizes, 1)))
        fill_s = time.perf_counter() - t
        small = {}                     # fid -> data, by volume
        for i, vid in enumerate(small_vids):
            u = urls[i % 2]
            _post(f"{u}/admin/allocate_volume",
                  {"volumeId": vid, "collection": coll}, "maint-small")
            for nid in range(1, small_n + 1):
                fid = str(FileId(vid, nid, _cookie(nid)))
                data = _payload(seed + vid, nid, 1024)
                operation.upload(u, fid, data)
                small[fid] = data
        order = rng.permutation(sorted(big))
        deleted, deleted_bytes = [], 0
        for fid in order:
            if deleted_bytes >= MAINT_DELETE * total:
                break
            st, _, _ = http_bytes("DELETE", f"{ua}/{fid}", timeout=60)
            check(st == 202, f"delete {fid}: {st}")
            deleted.append(fid)
            deleted_bytes += big[fid][1]
        live = {f: _payload(seed + 7, *big[f]) for f in big
                if f not in set(deleted)}
        poll(lambda: any(v["id"] == va and v.get("deletedByteCount", 0) >=
                         deleted_bytes for _n, v in
                         iter_volume_list_volumes(get("/vol/list"))),
             "the master sees A's garbage")
        steps["fill"] = {"volume": va, "needles": len(big),
                         "bytes": os.path.getsize(dat_a),
                         "fill_seconds": fill_s,
                         "small_volumes": len(small_vids),
                         "small_needles": len(small),
                         "deleted_needles": len(deleted),
                         "deleted_bytes": deleted_bytes,
                         "garbage_ratio": deleted_bytes /
                         (total - deleted_bytes)}
        emit({"phase": "maintenance", "step": "fill", **steps["fill"]})

        # 2. the vacuum, found by detection, under writes and deletes
        before = os.path.getsize(dat_a)
        replayed0 = metric(ua, "seaweedfs_tpu_volume_server_vacuum_"
                               "replayed_entries_total")
        stop = threading.Event()
        lock = threading.Lock()
        acked: dict = {}
        gone: list = []
        counter = itertools.count(1_000_000)
        during = {"writes": 0, "deletes": 0, "bytes": 0, "big_deletes": 0}
        big_live = sorted(live)

        def writer(w):
            mine = []
            i = 0
            while not stop.is_set():
                nid = next(counter)
                fid = str(FileId(va, nid, _cookie(nid)))
                data = _payload(seed + 8, nid, 1024)
                operation.upload(ua, fid, data)
                with lock:
                    acked[fid] = data
                    during["writes"] += 1
                    during["bytes"] += len(data)
                mine.append(fid)
                i += 1
                victim = None
                if i % 4 == 0:
                    victim = mine.pop(0)
                elif i % 16 == 3:
                    with lock:         # a few of the large ones too
                        if big_live and during["big_deletes"] < \
                                MAINT_BIG_DELETES:
                            victim = big_live.pop()
                            during["big_deletes"] += 1
                if victim is not None:
                    st, _, _ = http_bytes("DELETE", f"{ua}/{victim}",
                                          timeout=60)
                    check(st == 202, f"delete {victim}: {st}")
                    with lock:
                        acked.pop(victim, None)
                        live.pop(victim, None)
                        gone.append(victim)
                        during["deletes"] += 1
        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(MAINT_WRITERS)]
        for th in threads:
            th.start()
        try:
            job = jobs_of(["vacuum"])["vacuum"]
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=120)
        check(job["params"] == {"volumeId": va},
              f"the vacuum job is not A's: {job['params']}")
        after = os.path.getsize(dat_a)
        replayed = int(metric(ua, "seaweedfs_tpu_volume_server_vacuum_"
                                  "replayed_entries_total") - replayed0)
        live.update(acked)
        t = time.perf_counter()
        n_http = read_all(list(live.items()), lambda f: http_bytes(
            "GET", f"{ua}/{f}", timeout=60)[1], "A over HTTP")
        n_plane = read_all(list(live.items()), lambda f: plane_get(ua, f)[1],
                           "A through the read plane")
        dead = deleted + gone
        codes = [http_bytes("GET", f"{ua}/{f}", timeout=60)[0] for f in dead]
        check(all(c == 404 for c in codes),
              f"deleted needles answered {sorted(set(codes))}")
        shrink = before - after + during["bytes"]
        check(shrink >= 0.95 * deleted_bytes,
              f"A shrank {shrink} bytes for {deleted_bytes} deleted")
        check(replayed > 0, "the diff replayed nothing")
        steps["vacuum"] = {"volume": va, "wall_s": job["wall_s"],
                           "dat_before": before, "dat_after": after,
                           "reclaimed": before - after,
                           "deleted_bytes": deleted_bytes,
                           "records_replayed": replayed,
                           "writes_during": during["writes"],
                           "deletes_during": during["deletes"],
                           "read_back_http": n_http,
                           "read_back_plane": n_plane,
                           "deleted_404": len(dead),
                           "read_back_seconds": time.perf_counter() - t,
                           "stages": job["trace"][-3:]}
        emit({"phase": "maintenance", "step": "vacuum", **steps["vacuum"]})

        # 3. the encode of the compacted volume on the card
        size_a = os.path.getsize(dat_a)
        windows = sum(launches_for(d, item[3]) for item in
                      ec_encoder._encode_work_items(size_a, ctx))
        c0 = _counters(urls)
        job = jobs_of(["erasure_coding"], submit={
            "jobType": "erasure_coding",
            "params": {"volumeId": va, "collection": coll,
                       "encodeMode": "scatter"}})["erasure_coding"]
        enc = _delta(_counters(urls), c0)
        check(enc["launches"] == windows,
              f"the encode launched {enc['launches']}, the compacted .dat's "
              f"windows are {windows}")
        poll(lambda: sorted(s for ids in ec_locs(va).values()
                            for s in ids) == list(range(d + p)),
             "14 shards of A listed")
        shard_files = []
        for sid in range(d + p):
            name = f"{coll}_{va}" + ctx.to_ext(sid)
            (path,) = [os.path.join(dd, name) for dd in dirs
                       if os.path.exists(os.path.join(dd, name))]
            shard_files.append(path)
        t = time.perf_counter()
        checked = _parity_matches(shard_files, d, p)
        steps["encode"] = {"volume": va, "dat_bytes": size_a,
                           "wall_s": job["wall_s"], "launches":
                           enc["launches"], "windows": windows,
                           "parity_bytes_checked": checked * p,
                           "parity_check_seconds": time.perf_counter() - t,
                           "spread": {u: len(s) for u, s in
                                      ec_locs(va).items()},
                           "message": job["message"][:200],
                           "stages": [(t["event"][:60], t["ts"])
                                      for t in job["trace"]]}
        emit({"phase": "maintenance", "step": "encode", **steps["encode"]})

        # 4. three more servers, then both balances
        more = _start_procs(
            [["volume", "-dir", dd, "-port", "0", "-mserver", murl, "-max",
              str(WRITE_MAX_VOLUMES), "-rack", f"r{(MAINT_SERVERS + i) % 2}",
              "-device", device]
             for i, dd in enumerate(dirs[MAINT_SERVERS:])],
            [dd + ".log" for dd in dirs[MAINT_SERVERS:]], procs, "volume")
        proc_of.update(zip(more, procs[-MAINT_MORE:]))
        urls += more
        for u in more:
            planes[u] = http_json("GET", f"{u}/status", timeout=30)[
                "readPlanePort"] or int(u.rsplit(":", 1)[1])
        poll(lambda: len(get("/cluster/status")["dataNodes"]) == len(urls),
             "7 volume servers registered")
        counts0 = volume_counts(urls)
        admin("POST", "/maintenance/config",
              {"jobType": "volume_balance",
               "values": {"imbalanceThreshold": 2}})
        c0 = _counters(urls)
        bal = jobs_of(["ec_balance", "volume_balance"])
        fair = -(-(d + p) // len(urls))
        poll(lambda: sum(len(s) for s in ec_locs(va).values()) == d + p and
             max(len(s) for s in ec_locs(va).values()) <= fair,
             f"no server with more than {fair} of A's shards")
        spread = {u: len(s) for u, s in ec_locs(va).items()}
        racks = {u: f"r{i % 2}" for i, u in enumerate(urls)}
        rack_spread = {r: sum(n for u, n in spread.items() if racks[u] == r)
                       for r in sorted(set(racks.values()))}
        again = EcBalanceHandler().detect(
            type("Worker", (), {"master": murl})())
        check(again == [], f"ec_balance proposed again after its run: "
                           f"{again} (spread {spread})")
        poll(lambda: max(volume_counts(urls).values()) -
             min(volume_counts(urls).values()) <= 2,
             "a volume count spread of at most 2")
        counts = volume_counts(urls)
        moved_shards = int(re.search(r"moved (\d+) shards",
                                     bal["ec_balance"]["message"]).group(1))
        moved_vols = int(re.search(r"moved (\d+) volumes",
                                   bal["volume_balance"]["message"]).group(1))
        check(_delta(_counters(urls), c0)["launches"] == 0,
              "the balances launched the kernel")
        steps["balance"] = {"servers": len(urls), "fair_share": fair,
                            "shards_moved": moved_shards,
                            "shard_spread": spread,
                            "rack_spread": rack_spread,
                            "ec_balance_proposes_again": bool(again),
                            "ec_balance_wall_s": bal["ec_balance"]["wall_s"],
                            "volumes_moved": moved_vols,
                            "volume_counts_before": list(counts0.values()),
                            "volume_counts_after": list(counts.values()),
                            "volume_balance_wall_s":
                                bal["volume_balance"]["wall_s"]}
        emit({"phase": "maintenance", "step": "balance", **steps["balance"]})

        # 5. a server with 2 of A's shards stopped, and the rebuild
        locs = ec_locs(va)
        victim = min((u for u in urls if len(locs.get(u, [])) == 2),
                     key=lambda u: counts[u])
        lost = sorted(locs[victim])
        vdir = dirs[urls.index(victim)]
        lost_files = {s: os.path.join(vdir, f"{coll}_{va}" + ctx.to_ext(s))
                      for s in lost}
        lost_sha = {s: sha256_file(f) for s, f in lost_files.items()}
        pv = proc_of[victim]
        pv.terminate()
        check(pv.wait(timeout=60) == 0, f"{victim} did not stop cleanly")
        urls.remove(victim)
        poll(lambda: victim not in get("/cluster/status")["dataNodes"],
             "the master dropped the stopped server")
        shard_size = os.path.getsize(lost_files[lost[0]])
        stepb = rebuild_step(shard_size, ctx, rebuild_slice_bytes())
        reb_windows = sum(launches_for(d, min(stepb, shard_size - pos))
                          for pos in range(0, shard_size, stepb))
        c0 = _counters(urls)
        t = time.perf_counter()
        out = commands.run_script(
            env, f"lock; ec.rebuild -volumeId={va} -collection={coll}; "
                 f"unlock")
        reb_s = time.perf_counter() - t
        reb = _delta(_counters(urls), c0)
        check(f"rebuilt shards {lost} on " in out[1], f"rebuild: {out}")
        check(reb["launches"] == reb_windows,
              f"the rebuild launched {reb['launches']}, its [2,10] windows "
              f"are {reb_windows}")
        for sid, sha in lost_sha.items():
            name = os.path.basename(lost_files[sid])
            (now,) = [os.path.join(dd, name) for dd in dirs
                      if dd != vdir and os.path.exists(os.path.join(dd, name))]
            check(sha256_file(now) == sha, f"rebuilt shard {sid} differs")
        operation._vid_cache._m.clear()
        t = time.perf_counter()
        n_ec = read_all(list(live.items()),
                        lambda f: operation.read(murl, f), "A from EC")
        moved = {f: b for f, b in small.items()
                 if any(loc["url"] != victim for loc in
                        operation.lookup(murl, int(f.split(",")[0]),
                                         use_cache=False))}
        n_small = read_all(list(moved.items()),
                           lambda f: operation.read(murl, f),
                           "the small volumes")
        steps["rebuild"] = {"volume": va, "stopped": victim, "lost": lost,
                            "wall_s": reb_s, "launches": reb["launches"],
                            "windows": reb_windows,
                            "rebuilt_equal": len(lost),
                            "read_back_a": n_ec, "read_back_small": n_small,
                            "read_back_seconds": time.perf_counter() - t}
        emit({"phase": "maintenance", "step": "rebuild", **steps["rebuild"]})

        # 6. replica repair, then the scrub
        t6 = time.perf_counter()
        u1, u2 = urls[0], urls[1]
        for u in (u1, u2):
            _post(f"{u}/admin/allocate_volume",
                  {"volumeId": repair_vid, "collection": coll,
                   "replication": "001"}, "maint-repair")
        poll(lambda: len(operation.lookup(murl, repair_vid,
                                          use_cache=False)) == 2,
             "both replicas of the 001 volume listed")
        rep = {}
        for nid in range(1, MAINT_REPAIR_N + 1):
            fid = str(FileId(repair_vid, nid, _cookie(nid)))
            rep[fid] = _payload(seed + repair_vid, nid, 1024)
            st, body, _ = http_bytes("POST", f"{u1}/{fid}", rep[fid],
                                     timeout=60)
            check(st == 201, f"replicated write {fid}: {st} {body[:100]!r}")
        for fid in list(rep)[:MAINT_REPAIR_DROP]:
            r = http_json("POST", f"{u2}/admin/delete_needle",
                          {"volumeId": repair_vid,
                           "key": parse_file_id(fid).key}, timeout=60)
            check(r.get("freed", 0) > 0, f"delete_needle on {u2}: {r}")
        out = commands.run_script(
            env, f"lock; volume.check.disk -volumeId={repair_vid}; unlock")
        check(f"{MAINT_REPAIR_DROP} needles synced" in out[1],
              f"volume.check.disk: {out}")
        read_all(list(rep.items()), lambda f: http_bytes(
            "GET", f"{u2}/{f}", timeout=60)[1], "the synced replica")
        check_disk_s = time.perf_counter() - t6
        p2 = proc_of[u2]
        p2.terminate()
        check(p2.wait(timeout=60) == 0, f"{u2} did not stop cleanly")
        urls.remove(u2)
        poll(lambda: [x["url"] for x in operation.lookup(
            murl, repair_vid, use_cache=False)] == [u1],
            "the master lists one replica")
        t = time.perf_counter()
        out = commands.run_script(env,
                                  "lock; volume.fix.replication; unlock")
        fix_s = time.perf_counter() - t
        check(out[1].startswith("fixed replicas: ['200->"),
              f"volume.fix.replication: {out}")
        new = out[1].split("->")[1].split("'")[0]
        poll(lambda: len(operation.lookup(murl, repair_vid,
                                          use_cache=False)) == 2,
             "two replicas again")
        read_all(list(rep.items()), lambda f: http_bytes(
            "GET", f"{new}/{f}", timeout=60)[1], "the new replica")
        out = commands.run_script(env, "volume.scrub")
        lines = out[0].splitlines()
        errors = [ln for ln in lines if not ln.endswith(", ok")]
        check(lines and not errors, f"volume.scrub: {errors[:3]}")
        steps["repair"] = {"volume": repair_vid, "synced": MAINT_REPAIR_DROP,
                           "check_disk_s": check_disk_s,
                           "stopped": u2, "new_replica": new,
                           "fix_replication_s": fix_s,
                           "scrubbed_replicas": len(lines),
                           "scrub_errors": 0}
        emit({"phase": "maintenance", "step": "repair", **steps["repair"]})
    finally:
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"a process of the maintenance cluster did not stop: "
                   f"{bad}")
    out = {"phase": "maintenance",
           "servers": {"start": MAINT_SERVERS,
                       "after": MAINT_SERVERS + MAINT_MORE},
           "cuts": {"volume_a_mb": big_mb, "small_needles": small_n},
           "cluster_start_seconds": start_s, "steps": steps,
           "launches": {"encode": steps["encode"]["launches"],
                        "rebuild": steps["rebuild"]["launches"]},
           "phase_seconds": time.perf_counter() - phase_t0}
    emit(out)
    return out


HA_MASTERS = 3
HA_SERVERS = 4
HA_COLLECTION = "ha"                 # volume A: config 1's volume
HA_AFTER = "ha2"                     # what the set grows after a failover
HA_FILER_COLLECTION = "hafiler"
HA_MB = 1024
HA_FILES = 512                       # 1 KiB files through the filer
HA_ASSIGNS = 256                     # assigns checked after each fence
HA_SPIKE = 32                        # files read while their server is down
HA_ELECTION_S = 5.0                  # one leader within, of the last start


def _ha_status(urls) -> dict:
    """Each master's /cluster/status (a follower's "not leader" answer
    with its hint; {} for one that does not answer)."""
    from seaweedfs_tpu_torch.server.httpd import http_json
    out = {}
    for u in urls:
        try:
            out[u] = http_json("GET", f"{u}/cluster/status", timeout=5)
        except OSError:
            out[u] = {}
    return out


def _ha_leader(urls) -> "str | None":
    """The one master that leads and that every live master names."""
    st = _ha_status(urls)
    leaders = [u for u, r in st.items() if r.get("isLeader")]
    if len(leaders) != 1:
        return None
    named = [r.get("leader") for r in st.values() if r]
    return leaders[0] if all(n == leaders[0] for n in named) else None


def _start_master_set(tmp: str, procs: list, ports=None, which=None
                      ) -> "tuple[list[str], list, str]":
    """`master -peers m1,m2,m3 -mdir <own dir>` processes: all three, or
    those of `which` (indexes) on `ports`.  Fresh ports are taken until a
    set starts whose ports were all free (a master must know its peers
    before it binds, so a taken port is retried, never reused)."""
    which = list(range(HA_MASTERS)) if which is None else which
    for attempt in range(5):
        ps = ports or [_free_port() for _ in range(HA_MASTERS)]
        peers = ",".join(f"127.0.0.1:{p}" for p in ps)
        started: list = []
        try:
            urls = _start_procs(
                [["master", "-port", str(ps[i]), "-peers", peers,
                  "-mdir", os.path.join(tmp, f"m{i}"),
                  "-volumeSizeLimitMB", str(2 * HA_MB)] for i in which],
                [os.path.join(tmp, f"m{i}.log") for i in which], started,
                "master", log_mode="a")
        except RuntimeError:
            for p in started:
                if p.poll() is None:
                    p.kill()
                p.wait()
                p.stdout.close()
            if attempt == 4:
                raise
            time.sleep(0.5)
            continue
        procs.extend(started)
        return urls, started, peers
    raise RuntimeError("unreachable")


def _retire(procs: list, p, sig) -> "int | None":
    """Send `sig` to a process of the phase and take it off `procs`; its
    exit code."""
    p.send_signal(sig)
    rc = p.wait(timeout=60)
    procs.remove(p)
    if p.stdout is not None:
        p.stdout.close()
    return rc


def phase_master_ha(tmp: str, seed: int, big_mb: int = HA_MB,
                    n_files: int = HA_FILES, n_assigns: int = HA_ASSIGNS,
                    device: str = "cuda") -> dict:
    """The master's raft and the SLO autopilot around an ec.encode and an
    ec.rebuild on the card.  3 `master -peers -mdir`, 4 `volume -mserver
    m1,m2,m3`, a filer in its default configuration (meta plane, native
    planes, autopilot), the admin and a worker with `-capabilities
    erasure_coding`, all `python -m seaweedfs_tpu_torch` processes.
    Steps, each printed on its JSON line:
    1. election: one leader within 5 s of the last start, named by every
       master; each follower answers /dir/assign 503 with the hint;
       `cluster.raft.ps` lists 3 peers with commit = applied;
    2. fill: volume A to 1 GiB with config 1's needles (256 KiB-4 MiB)
       through a client given the seed list with a follower first, every
       key recorded; 512 files of 1 KiB through the filer;
    3. encode across a failover: the worker's `erasure_coding` job on A,
       the leader SIGKILLed once A's server launches the kernel; a new
       leader, the gap from the kill to its first answered assign, the
       job done, launches equal to A's [4,10] windows, the parity equal
       to the host codec's, 14 shards in the new leader's /dir/ec_lookup
       within 3 pulses;
    4. no reuse: 256 assigns above every key issued before the kill; no
       volume grown by the new leader on a vid a server held;
    5. rebuild: the killed master rejoins as a follower; the server with
       the most of A's shards SIGKILLed; `ec.rebuild` from the shell on
       the seed list: launches equal to the windows, the shards equal,
       every needle of A read back;
    6. transfer: `cluster.raft.leader.transfer` to a named follower, the
       filer's follow stream names it within 2 s, the 1 KiB files read
       back 200 and equal throughout;
    7. restart: all three SIGTERMed and started on their -mdir: the same
       topologyId, 256 assigns above every key before, the 3 surviving
       servers registered again;
    8. autopilot: the filer's /debug/autopilot lists its five knobs and
       both guards, each volume server's `cache.needle`, all ticking; the
       server of some 1 KiB files stopped, their reads through the read
       plane trip its guard (the plane's port leaves /status, the action
       counted); the server back, probation over, the guard re-arms and
       the plane serves them again."""
    import numpy as np

    from seaweedfs_tpu_torch import operation
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.shell import commands
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import (
        ECContext)
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        rebuild_step)
    from seaweedfs_tpu_torch.storage.erasure_coding.shard_source import (
        rebuild_slice_bytes)
    from seaweedfs_tpu_torch.topology import iter_volume_list_volumes

    phase_t0 = time.perf_counter()
    os.makedirs(tmp)
    d, p = 10, 4
    coll = HA_COLLECTION
    ctx = ECContext(d, p, device="cpu")
    dirs = [os.path.join(tmp, f"s{i}") for i in range(HA_SERVERS)]
    for dd in dirs:
        os.makedirs(dd)
    procs: list = []
    steps: dict = {}
    keys: "list[int]" = []

    def key_of(fid: str) -> int:
        return int(fid.split(",")[1][:-8], 16)

    def vid_of(fid: str) -> int:
        return int(fid.split(",")[0])

    def admin(method, path, payload=None):
        r = http_json(method, f"{aurl}{path}", payload, timeout=60)
        check("error" not in r, f"admin {path}: {r}")
        return r

    def assigns(n: int, spec: str, collection: str) -> "list[str]":
        out = []
        for _ in range(n):
            a = operation.assign(spec, collection=collection)
            out.append(a.fid)
        return out

    def first_assign(spec: str, collection: str, timeout: float = 60.0
                     ) -> "tuple[str, float]":
        """The first assign that a leader answers, and when."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                a = operation.assign(spec, collection=collection)
                return a.fid, time.perf_counter()
            except (RuntimeError, OSError):
                check(time.monotonic() < deadline, "no assign answered")
                time.sleep(0.02)

    def ec_locs(vid) -> dict:
        r = operation.master_json(seeds, "GET",
                                  f"/dir/ec_lookup?volumeId={vid}",
                                  timeout=30)
        return {x["url"]: x["shardIds"]
                for x in r.get("shardIdLocations", [])}

    def alive() -> "list[str]":
        return operation.master_json(seeds, "GET", "/cluster/status",
                                     timeout=30).get("dataNodes", [])

    def metric(url, name):
        text = http_bytes("GET", f"{url}/metrics", timeout=60)[1].decode()
        return sum(v for _lb, v in _full_samples(text, name))

    def launches(url) -> float:
        return metric(url, "seaweedfs_tpu_gf_kernel_launches")

    def read_all(pairs, fn, what):
        with ThreadPoolExecutor(8) as pool:
            bad = [f for (f, want), got in zip(
                pairs, pool.map(lambda fd: fn(fd[0]), pairs)) if got != want]
        check(not bad, f"{what}: {len(bad)} differ, first {bad[:3]}")
        return len(pairs)

    try:
        # 1. the election
        murls, mprocs, seeds = _start_master_set(tmp, procs)
        mproc = dict(zip(murls, mprocs))
        t_up = time.perf_counter()
        poll(lambda: _ha_leader(murls) is not None, "one agreed leader",
             timeout=30, interval=0.02)
        election_s = time.perf_counter() - t_up
        check(election_s <= HA_ELECTION_S,
              f"the election took {election_s:.2f} s")
        leader = _ha_leader(murls)
        followers = [u for u in murls if u != leader]
        for u in followers:
            st, body, _ = http_bytes("GET", f"{u}/dir/assign", timeout=10)
            hint = json.loads(body)
            check(st == 503 and hint == {"error": "not leader",
                                         "leader": leader},
                  f"follower {u} answered {st} {hint}")
        env = commands.CommandEnv(seeds)
        poll(lambda: re.search(r"commit=(\d+) applied=\1 ",
                               commands.run_script(
                                   env, "cluster.raft.ps")[0]) is not None,
             "commit = applied", timeout=30)
        ps = commands.run_script(env, "cluster.raft.ps")[0]
        check(all(u in ps for u in murls) and
              len(re.findall(r"^  [* ] \S+$", ps, re.M)) == HA_MASTERS,
              f"cluster.raft.ps: {ps}")
        steps["election"] = {"seconds": election_s, "leader": leader,
                             "masters": murls, "raft_ps": ps.splitlines()}
        emit({"phase": "master_ha", "step": "election",
              **steps["election"]})

        urls = _start_procs(
            [["volume", "-dir", dd, "-port", "0", "-mserver", seeds, "-max",
              str(WRITE_MAX_VOLUMES), "-device", device] for dd in dirs],
            [dd + ".log" for dd in dirs], procs, "volume")
        vproc = dict(zip(urls, procs[-HA_SERVERS:]))
        vdir = dict(zip(urls, dirs))
        (furl,) = _start_procs(
            [["filer", "-port", "0", "-master", seeds, "-store",
              os.path.join(tmp, "filer.db"), "-collection",
              HA_FILER_COLLECTION]], [os.path.join(tmp, "filer.log")],
            procs, "filer", line=r"filer listening on (\S+:\d+)\n")
        (aurl,) = _start_procs(
            [["admin", "-port", "0", "-master", seeds,
              "-detectionInterval", "3600",
              "-dataDir", os.path.join(tmp, "admin")]],
            [os.path.join(tmp, "admin.log")], procs, "admin",
            r"admin listening on (\S+:\d+)\n")
        _start_procs(
            [["worker", "-admin", aurl, "-master", seeds,
              "-dir", os.path.join(tmp, "worker"), "-capabilities",
              "erasure_coding", "-device", device]],
            [os.path.join(tmp, "worker.log")], procs, "worker",
            rf"worker (\w+) polling {re.escape(aurl)}\n")
        poll(lambda: len(alive()) == HA_SERVERS, "4 volume servers")
        poll(lambda: "erasure_coding" in admin(
            "GET", "/maintenance/config")["jobTypes"], "the worker")
        admin("POST", "/maintenance/config",
              {"jobType": "erasure_coding",
               "values": {"encodeMode": "scatter"}})

        # 2. the fill, through the seed list with a follower first
        spec = ",".join(followers + [leader])
        r = operation.master_json(spec, "POST", "/vol/grow",
                                  {"collection": coll, "count": 1},
                                  timeout=60)
        check(len(r.get("volumeIds", [])) == 1, f"/vol/grow: {r}")
        (va,) = r["volumeIds"]
        ua = operation.lookup(spec, va, use_cache=False)[0]["url"]
        rng = np.random.default_rng([seed, 91])
        sizes, total = [], 0
        while total < big_mb << 20:
            sizes.append(int(rng.integers(256 << 10, 4 << 20)))
            total += sizes[-1]
        big: dict = {}

        def put(nid, size):
            a = operation.assign(spec, collection=coll)
            check(vid_of(a.fid) == va, f"assign gave {a.fid}, not A")
            operation.upload(a.url, a.fid, _payload(seed + 19, nid, size))
            return a.fid, (nid, size)
        t = time.perf_counter()
        with ThreadPoolExecutor(FILL_WRITERS) as pool:
            big.update(pool.map(lambda x: put(*x), enumerate(sizes, 1)))
        fill_s = time.perf_counter() - t
        keys += [key_of(f) for f in big]
        files = {f"/ha/d{i % 16}/f{i}": _payload(seed + 23, i, 1024)
                 for i in range(n_files)}
        for path, data in files.items():
            st, body, _ = http_bytes("PUT", f"{furl}{path}", data,
                                     timeout=60)
            check(st in (200, 201), f"filer PUT {path}: {st} {body[:100]!r}")
        dat_a = os.path.join(vdir[ua], f"{coll}_{va}.dat")
        steps["fill"] = {"volume": va, "server": ua, "needles": len(big),
                         "bytes": os.path.getsize(dat_a),
                         "fill_seconds": fill_s, "filer_files": len(files),
                         "client_seeds": spec}
        emit({"phase": "master_ha", "step": "fill", **steps["fill"]})

        # 3. the encode, its leader SIGKILLed once the kernel runs
        size_a = os.path.getsize(dat_a)
        windows = sum(launches_for(d, item[3]) for item in
                      ec_encoder._encode_work_items(size_a, ctx))
        vids_before = {v["id"] for _n, v in iter_volume_list_volumes(
            operation.master_json(seeds, "GET", "/vol/list", timeout=30))}
        l0 = {u: launches(u) for u in urls}
        job = admin("POST", "/maintenance/submit_job", {
            "jobType": "erasure_coding",
            "params": {"volumeId": va, "collection": coll,
                       "encodeMode": "scatter"}})
        jid = job.get("jobId") or job.get("id")
        t_job = time.perf_counter()

        def job_status():
            return admin("GET", f"/maintenance/job?id={jid}")["status"]
        # the kill as soon as the kernel runs (a host codec, in a
        # rehearsal off the card, counts nothing: there the job's end)
        poll(lambda: launches(ua) > l0[ua] or
             job_status() in ("done", "failed"),
             "A's server launches the kernel", timeout=300, interval=0.01)
        during = launches(ua) > l0[ua] and job_status() not in (
            "done", "failed")
        check(during or device != "cuda",
              "the encode ended before the leader was killed")
        t_kill = time.perf_counter()
        old = leader
        mproc[old].kill()
        mproc[old].wait(timeout=60)
        procs.remove(mproc[old])
        mproc[old].stdout.close()
        live_m = [u for u in murls if u != old]
        poll(lambda: _ha_leader(live_m) is not None, "a new leader",
             timeout=30, interval=0.02)
        new = _ha_leader(live_m)
        elected_s = time.perf_counter() - t_kill
        gap_fid, t_first = first_assign(seeds, HA_AFTER)
        gap_s = t_first - t_kill
        keys_after = [key_of(gap_fid)]
        poll(lambda: job_status() in ("done", "failed"),
             "the encode job ends", 900)
        jrec = admin("GET", f"/maintenance/job?id={jid}")
        check(jrec["status"] == "done",
              f"the encode job: {jrec['message']} {jrec['trace'][-3:]}")
        job_s = time.perf_counter() - t_job
        t_done = time.monotonic()
        poll(lambda: sorted(s for ids in ec_locs(va).values()
                            for s in ids) == list(range(d + p)),
             "14 shards of A on the new leader", timeout=3.0, interval=0.02)
        listed_s = time.monotonic() - t_done
        enc = int(sum(launches(u) - l0[u] for u in urls))
        check(enc == windows, f"the encode launched {enc}, A's windows "
                              f"are {windows}")
        shard_files = []
        for sid in range(d + p):
            name = f"{coll}_{va}" + ctx.to_ext(sid)
            (path,) = [os.path.join(dd, name) for dd in dirs
                       if os.path.exists(os.path.join(dd, name))]
            shard_files.append(path)
        t = time.perf_counter()
        checked = _parity_matches(shard_files, d, p)
        steps["encode"] = {"volume": va, "dat_bytes": size_a,
                           "killed_leader": old, "new_leader": new,
                           "kill_to_elected_s": elected_s,
                           "kill_to_first_assign_s": gap_s,
                           "kill_after_job_start_s": t_kill - t_job,
                           "killed_while_encoding": during,
                           "job_wall_s": job_s,
                           "ec_lookup_after_job_s": listed_s,
                           "launches": enc, "windows": windows,
                           "parity_bytes_checked": checked * p,
                           "parity_check_seconds": time.perf_counter() - t,
                           "spread": {u: len(x) for u, x in
                                      ec_locs(va).items()},
                           "stages": [(x["event"][:60], x["ts"])
                                      for x in jrec["trace"]]}
        emit({"phase": "master_ha", "step": "encode", **steps["encode"]})

        # 4. no key and no vid issued twice
        t = time.perf_counter()
        fids = assigns(n_assigns, seeds, HA_AFTER)
        rate = n_assigns / (time.perf_counter() - t)
        keys_after += [key_of(f) for f in fids]
        check(min(keys_after) > max(keys),
              f"a key at or below {max(keys)} issued after the kill")
        grown = {vid_of(f) for f in fids} | {vid_of(gap_fid)}
        check(not grown & (vids_before | {va}),
              f"the new leader grew held vids {grown & vids_before}")
        steps["no_reuse"] = {"assigns": n_assigns,
                             "assigns_per_s_seed_list": rate,
                             "max_key_before": max(keys),
                             "min_key_after": min(keys_after),
                             "vids_before": sorted(vids_before),
                             "vids_grown": sorted(grown)}
        emit({"phase": "master_ha", "step": "no_reuse", **steps["no_reuse"]})
        keys += keys_after

        # 5. the killed master back, then a server lost and the rebuild
        oi = murls.index(old)
        (back,), (bproc,), _ = _start_master_set(
            tmp, procs, ports=[int(u.rsplit(":", 1)[1]) for u in murls],
            which=[oi])
        mproc[back] = bproc
        poll(lambda: _ha_status([back])[back].get("leader") == new and
             not _ha_status([back])[back].get("isLeader"),
             "the restarted master follows", timeout=30)
        locs = ec_locs(va)
        filer_vids = set()
        for path in files:
            entry = http_json("GET", f"{furl}/__meta__/lookup?path="
                              + urllib.parse.quote(path), timeout=30)
            filer_vids.add(vid_of(entry["chunks"][0]["fileId"]))
        filer_urls = {loc["url"] for vid in filer_vids for loc in
                      operation.lookup(seeds, vid, use_cache=False)}
        victim = max((u for u in urls if u not in filer_urls and
                      u in locs), key=lambda u: len(locs[u]))
        lost = sorted(locs[victim])
        lost_files = {sid: os.path.join(vdir[victim], f"{coll}_{va}" +
                                        ctx.to_ext(sid)) for sid in lost}
        lost_sha = {sid: sha256_file(f) for sid, f in lost_files.items()}
        _retire(procs, vproc[victim], signal.SIGKILL)
        urls.remove(victim)
        poll(lambda: victim not in alive(), "the leader drops the server")
        shard_size = os.path.getsize(lost_files[lost[0]])
        stepb = rebuild_step(shard_size, ctx, rebuild_slice_bytes())
        reb_windows = sum(launches_for(d, min(stepb, shard_size - pos))
                          for pos in range(0, shard_size, stepb))
        l0 = {u: launches(u) for u in urls}
        t = time.perf_counter()
        out = commands.run_script(
            env, f"lock; ec.rebuild -volumeId={va} -collection={coll}; "
                 f"unlock")
        reb_s = time.perf_counter() - t
        reb = int(sum(launches(u) - l0[u] for u in urls))
        check(f"rebuilt shards {lost} on " in out[1], f"rebuild: {out}")
        check(reb == reb_windows, f"the rebuild launched {reb}, its "
                                  f"windows are {reb_windows}")
        for sid, sha in lost_sha.items():
            name = os.path.basename(lost_files[sid])
            (now,) = [os.path.join(dd, name) for dd in dirs
                      if dd != vdir[victim] and
                      os.path.exists(os.path.join(dd, name))]
            check(sha256_file(now) == sha, f"rebuilt shard {sid} differs")
        operation._vid_cache._m.clear()
        t = time.perf_counter()
        n_read = read_all(
            [(f, _payload(seed + 19, *big[f])) for f in big],
            lambda f: operation.read(seeds, f), "A from EC")
        steps["rebuild"] = {"volume": va, "rejoined": back,
                            "stopped": victim, "lost": lost,
                            "wall_s": reb_s, "launches": reb,
                            "windows": reb_windows,
                            "rebuilt_equal": len(lost),
                            "read_back": n_read,
                            "read_back_seconds": time.perf_counter() - t}
        emit({"phase": "master_ha", "step": "rebuild", **steps["rebuild"]})

        # 6. a transfer to a named follower, under 1 KiB reads
        target = next(u for u in murls if u != new)
        stop = threading.Event()
        seen = {"reads": 0, "bad": []}

        def reader():
            paths = list(files)
            i = 0
            while not stop.is_set():
                path = paths[i % len(paths)]
                try:
                    st, body, _ = http_bytes("GET", f"{furl}{path}",
                                             timeout=60)
                except OSError as e:
                    st, body = repr(e)[:200], b""
                seen["reads"] += 1
                if st != 200 or body != files[path]:
                    seen["bad"].append((path, st))
                i += 1
        th = threading.Thread(target=reader)
        th.start()
        try:
            time.sleep(0.2)
            t = time.perf_counter()
            out = commands.run_script(
                env, f"cluster.raft.leader.transfer -target={target}")
            check("transferred" in out[0], f"transfer: {out}")
            poll(lambda: http_json("GET", f"{furl}/debug/follow",
                                   timeout=10).get("leader") == target,
                 "the filer follows the new leader", timeout=2.0,
                 interval=0.01)
            follow_s = time.perf_counter() - t
            poll(lambda: _ha_leader(murls) == target, "the target leads",
                 timeout=10)
            time.sleep(0.5)
        finally:
            stop.set()
            th.join(timeout=60)
        check(not seen["bad"], f"reads during the transfer: {seen['bad'][:3]}")
        steps["transfer"] = {"from": new, "to": target,
                             "filer_follows_s": follow_s,
                             "reads_during": seen["reads"]}
        emit({"phase": "master_ha", "step": "transfer", **steps["transfer"]})

        # 7. the whole set stopped and started on its -mdir
        tid = operation.master_json(seeds, "GET", "/cluster/status",
                                    timeout=30)["topologyId"]
        for u in murls:
            rc = _retire(procs, mproc[u], signal.SIGTERM)
            check(rc == 0, f"master {u} stopped with {rc}")
        t = time.perf_counter()
        murls2, mprocs2, _ = _start_master_set(
            tmp, procs, ports=[int(u.rsplit(":", 1)[1]) for u in murls])
        check(murls2 == murls, f"the set came back as {murls2}")
        mproc = dict(zip(murls, mprocs2))
        fid0, t_first = first_assign(seeds, HA_AFTER)
        restart_s = t_first - t
        fids = [fid0] + assigns(n_assigns - 1, seeds, HA_AFTER)
        after = [key_of(f) for f in fids]
        check(min(after) > max(keys),
              f"a key at or below {max(keys)} issued after the restart")
        tid2 = operation.master_json(seeds, "GET", "/cluster/status",
                                     timeout=30)["topologyId"]
        check(tid2 == tid, f"topologyId {tid} became {tid2}")
        poll(lambda: sorted(alive()) == sorted(urls),
             "the surviving servers registered again")
        keys += after
        steps["restart"] = {"topology_id": tid,
                            "restart_to_first_assign_s": restart_s,
                            "leader": _ha_leader(murls),
                            "assigns": n_assigns,
                            "min_key_after": min(after),
                            "servers": len(urls)}
        emit({"phase": "master_ha", "step": "restart", **steps["restart"]})

        # 8. the autopilot
        snap = http_json("GET", f"{furl}/debug/autopilot", timeout=30)
        check({"hedge.ratio", "hedge.min_ms", "brownout.factor",
               "cache.chunk", "cache.meta"} <= set(snap["knobs"]),
              f"filer knobs {sorted(snap['knobs'])}")
        check({g["name"] for g in snap["planes"]} == {"meta", "read"} and
              all(g["armed"] for g in snap["planes"]),
              f"filer guards {snap['planes']}")
        vsnaps = {u: http_json("GET", f"{u}/debug/autopilot", timeout=30)
                  for u in urls}
        check(all("cache.needle" in x["knobs"] for x in vsnaps.values()),
              "a volume server without cache.needle")
        time.sleep(1.5)
        snap2 = http_json("GET", f"{furl}/debug/autopilot", timeout=30)
        check(snap["enabled"] and snap2["ticks"] > snap["ticks"],
              "the filer's loop does not tick")
        for u, x in vsnaps.items():
            y = http_json("GET", f"{u}/debug/autopilot", timeout=30)
            check(x["enabled"] and y["ticks"] > x["ticks"],
                  f"{u}'s loop does not tick")
        by_server: dict = {}
        for path in files:
            entry = http_json("GET", f"{furl}/__meta__/lookup?path="
                              + urllib.parse.quote(path), timeout=30)
            fid = entry["chunks"][0]["fileId"]
            (loc,) = operation.lookup(seeds, vid_of(fid), use_cache=False)
            by_server.setdefault(loc["url"], []).append((path, fid))
        x_url = max(by_server, key=lambda u: len(by_server[u]))
        spike = by_server[x_url][:HA_SPIKE]
        rport = http_json("GET", f"{furl}/status",
                          timeout=30)["readPlanePort"]
        check(rport, "the filer's read plane is not up")
        rhost = furl.rsplit(":", 1)[0]

        def plane_get(path):
            return http_bytes("GET", f"{rhost}:{rport}{path}", timeout=30)

        def plane_serves(path, fid) -> bool:
            # the filer's GET fills its plane; a GET on the volume port
            # registers the needle with the volume's read plane
            http_bytes("GET", f"{furl}{path}", timeout=30)
            http_bytes("GET", f"{x_url}/{fid}", timeout=30)
            st, body, _ = plane_get(path)
            return st == 200 and body == files[path]
        for path, fid in spike:
            poll(lambda: plane_serves(path, fid), f"{path} on the plane",
                 timeout=30)
        acts0 = metric(furl, "seaweedfs_tpu_autopilot_actions_total")
        rc = _retire(procs, vproc[x_url], signal.SIGTERM)
        check(rc == 0, f"{x_url} stopped with {rc}")
        t_spike = time.perf_counter()
        errs = 0

        def tripped() -> bool:
            nonlocal errs
            for path, _fid in spike[:8]:
                errs += plane_get(path)[0] != 200
            return http_json("GET", f"{furl}/status",
                             timeout=30)["readPlanePort"] == 0
        poll(tripped, "the read plane's guard disarms it", timeout=30,
             interval=0.02)
        disarm_s = time.perf_counter() - t_spike
        text = http_bytes("GET", f"{furl}/metrics", timeout=60)[1].decode()
        disarms = sum(v for lb, v in _full_samples(
            text, "seaweedfs_tpu_autopilot_actions_total")
            if lb == {"knob": "plane.read", "direction": "disarm"})
        check(disarms >= 1, "the disarm was not counted")
        t_back = time.perf_counter()
        (x2,) = _start_procs(
            [["volume", "-dir", vdir[x_url], "-port",
              x_url.rsplit(":", 1)[1], "-mserver", seeds, "-max",
              str(WRITE_MAX_VOLUMES), "-device", device]],
            [vdir[x_url] + ".log"], procs, "volume", log_mode="a")
        check(x2 == x_url, f"{x_url} came back as {x2}")
        vproc[x_url] = procs[-1]
        poll(lambda: http_json("GET", f"{furl}/status", timeout=30)[
            "readPlanePort"] == rport, "the guard re-arms the plane",
            timeout=120, interval=0.05)
        rearm_s = time.perf_counter() - t_back
        for path, fid in spike:
            poll(lambda: plane_serves(path, fid),
                 f"{path} on the plane again", timeout=30)
        snap3 = http_json("GET", f"{furl}/debug/autopilot", timeout=30)
        steps["autopilot"] = {
            "filer_knobs": snap["knobs"],
            "volume_knobs": {u: x["knobs"] for u, x in vsnaps.items()},
            "stopped": x_url, "plane_reads_failed": errs,
            "disarm_s": disarm_s, "rearm_after_restart_s": rearm_s,
            "disarms_counted": disarms,
            "actions_total_delta": metric(
                furl, "seaweedfs_tpu_autopilot_actions_total") - acts0,
            "served_again": len(spike),
            "plane_actions": [a for a in snap3["actions"]
                              if a["knob"].startswith("plane.")]}
        emit({"phase": "master_ha", "step": "autopilot",
              **steps["autopilot"]})
    finally:
        bad = _stop_peers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not bad, f"a process of the HA cluster did not stop: {bad}")
    out = {"phase": "master_ha",
           "cuts": {"volume_a_mb": big_mb, "filer_files": n_files,
                    "assigns": n_assigns},
           "steps": steps,
           "launches": {"encode": steps["encode"]["launches"],
                        "rebuild": steps["rebuild"]["launches"]},
           "phase_seconds": time.perf_counter() - phase_t0}
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
    walls = {}    # each main-path phase's wall, seconds
    adopt_orphans()
    check(not sweep_children(), "a process was running before the phases")

    def timed(name, fn, *fargs):
        t0 = time.perf_counter()
        try:
            out = fn(*fargs)
        finally:
            walls[name] = time.perf_counter() - t0
            left = sweep_children()
            if left:
                emit({"phase": name, "left_running": left})
        check(not left, f"phase {name} left {len(left)} processes running")
        return out

    try:
        ec, ec_state = timed("ec", phase_ec, args.volume_gib, args.seed,
                             os.path.join(work, "ec"))
        remote = timed("remote", phase_remote, ec_state,
                       os.path.join(work, "remote"))
        cluster = timed("cluster", phase_cluster, ec_state,
                        os.path.join(work, "cluster"))
        batch, batch_state = timed("batch", phase_batch, args.batch_gib,
                                   args.seed, os.path.join(work, "batch"))
        worker = timed("worker", phase_worker, ec_state, batch_state,
                       os.path.join(work, "worker"))
        write = timed("write", phase_write, os.path.join(work, "write"),
                      args.seed)
        read_load = timed("read_load", phase_read_load,
                          os.path.join(work, "read_load"), args.seed)
        filer = timed("filer", phase_filer, os.path.join(work, "filer"),
                      args.seed)
        filer_plane = timed("filer_plane", phase_filer_plane,
                            os.path.join(work, "filer_plane"), args.seed)
        fsync = timed("fsync_tier", phase_fsync_tier,
                      os.path.join(work, "fsync_tier"), args.seed)
        secure = timed("secure_s3", phase_secure_s3,
                       os.path.join(work, "secure_s3"), args.seed)
        fleet = timed("filer_fleet", phase_filer_fleet,
                      os.path.join(work, "filer_fleet"), args.seed)
        qchaos = timed("qos_chaos", phase_qos_chaos,
                       os.path.join(work, "qos_chaos"), args.seed)
        maint = timed("maintenance", phase_maintenance,
                      os.path.join(work, "maintenance"), args.seed)
        ha = timed("master_ha", phase_master_ha,
                   os.path.join(work, "master_ha"), args.seed)
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
              "rs63_reads": read_load["launches"]["reads"],
              "filer_encode": filer["launches"]["encode"],
              "filer_rebuild": filer["launches"]["rebuild"],
              "filer_reads": filer["launches"]["reads"],
              "filer_plane_encode": filer_plane["launches"]["encode"],
              "filer_plane_rebuild": filer_plane["launches"]["rebuild"],
              "filer_plane_reads": filer_plane["launches"]["reads"],
              "fsync_encode": fsync["launches"]["encode"],
              "fsync_reads": fsync["launches"]["reads"],
              "secure_s3_encode": secure["launches"]["encode"],
              "secure_s3_rebuild": secure["launches"]["rebuild"],
              "secure_s3_reads": secure["launches"]["reads"],
              "filer_fleet_encode": fleet["launches"]["encode"],
              "filer_fleet_rebuild": fleet["launches"]["rebuild"],
              "filer_fleet_reads": fleet["launches"]["reads"],
              "qos_chaos_encode": qchaos["launches"]["encode"],
              "qos_chaos_rebuild": qchaos["launches"]["rebuild"],
              "qos_chaos_scatter": qchaos["launches"]["scatter"],
              "maintenance_encode": maint["launches"]["encode"],
              "maintenance_rebuild": maint["launches"]["rebuild"],
              "master_ha_encode": ha["launches"]["encode"],
              "master_ha_rebuild": ha["launches"]["rebuild"]}),
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
    emit({"phase_walls_s": walls})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
