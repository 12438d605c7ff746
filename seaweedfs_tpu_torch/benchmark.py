"""`benchmark` command (weed/command/benchmark.go:28-116;
`seaweedfs_tpu/benchmark.py`): concurrent small-file writes, then reads
of every written fid in a shuffled order, against a cluster, with
latency percentiles a phase."""

from __future__ import annotations

import random
import time
from concurrent.futures import ThreadPoolExecutor

from . import operation


def _percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(p / 100 * len(sorted_vals)))
    return sorted_vals[idx]


def _stats(name: str, latencies: list[float], total_bytes: int,
           wall: float) -> dict:
    lat = sorted(latencies)
    n = len(lat)
    return {
        "op": name,
        "requests": n,
        "seconds": round(wall, 2),
        "req_per_sec": round(n / wall, 1) if wall else 0,
        "kb_per_sec": round(total_bytes / wall / 1024, 1) if wall else 0,
        "avg_ms": round(sum(lat) / n * 1000, 2) if n else 0,
        "p50_ms": round(_percentile(lat, 50) * 1000, 2),
        "p95_ms": round(_percentile(lat, 95) * 1000, 2),
        "p99_ms": round(_percentile(lat, 99) * 1000, 2),
        "max_ms": round(lat[-1] * 1000, 2) if lat else 0,
    }


def run_benchmark(master: str, n_files: int = 1000,
                  file_size: int = 1024, concurrency: int = 16,
                  read_ratio_check: bool = True) -> list[dict]:
    """[write stats, read stats]: `n_files` assign + upload of one seeded
    payload of `file_size` bytes on `concurrency` threads, then a read
    of each fid; a short read raises (with `read_ratio_check`)."""
    rng = random.Random(0)
    payload = bytes(rng.getrandbits(8) for _ in range(file_size))
    fids: list[str] = []
    write_lat: list[float] = []

    def write_one(i: int) -> tuple[str, float]:
        t0 = time.perf_counter()
        a = operation.assign(master)
        operation.upload(a.url, a.fid, payload)
        return a.fid, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        for fid, dt in pool.map(write_one, range(n_files)):
            fids.append(fid)
            write_lat.append(dt)
    write_wall = time.perf_counter() - t0
    results = [_stats("write", write_lat, n_files * file_size,
                      write_wall)]

    def read_one(fid: str) -> float:
        t0 = time.perf_counter()
        data = operation.read(master, fid)
        if read_ratio_check and len(data) != file_size:
            raise RuntimeError(f"short read on {fid}")
        return time.perf_counter() - t0

    order = fids[:]
    rng.shuffle(order)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        read_lat = list(pool.map(read_one, order))
    read_wall = time.perf_counter() - t0
    results.append(_stats("read", read_lat, n_files * file_size,
                          read_wall))
    return results
