"""Device telemetry of the encode/rebuild path (the counterpart of
`seaweedfs_tpu/profiling.py:1374-1463`): host<->device staging windows,
kernel windows, the staging overlap fraction and device memory, under
the reference's metric names and labels, in `stats.PROCESS`.

The reference's sampler, stage tracks and flight recorder come with the
server slice of the port.
"""

from __future__ import annotations

import torch

from . import stats


def device_note(direction: str, nbytes: int,
                seconds: "float | None") -> None:
    """Record one host<->device staging window (direction "h2d" or
    "d2h"): cumulative bytes, a latency histogram and a last-window
    throughput gauge.  seconds=None records bytes only: an enqueue wall
    is not a transfer wall, and a wrong gauge is worse than none."""
    m = stats.PROCESS
    m.counter_add("device_transfer_bytes_total", float(nbytes),
                  help_text="host<->device staging bytes", dir=direction)
    if seconds is None:
        return
    m.histogram_observe("device_transfer_seconds", seconds,
                        help_text="host<->device staging window "
                                  "latency", dir=direction)
    if seconds > 0:
        gauge = "device_h2d_gbps" if direction == "h2d" \
            else "device_d2h_gbps"
        m.gauge_set(gauge, nbytes / seconds / 1e9,
                    help_text="last staging window throughput")


def overlap_note(fraction: float, windows: int,
                 op: str = "encode") -> None:
    """Record one windowed launch's h2d/d2h overlap fraction (0: the
    staging and consume planes ran serially, 1: the wall equalled the
    slower plane alone) and its window count."""
    m = stats.PROCESS
    m.gauge_set("device_h2d_overlap_fraction", fraction,
                help_text="last windowed launch's h2d/d2h overlap "
                          "fraction (0 serial .. 1 fully overlapped)",
                op=op)
    m.counter_add("device_staged_windows_total", float(windows),
                  help_text="h2d staging windows launched", op=op)


def kernel_note(kernel: str, seconds: float, nbytes: int = 0) -> None:
    """Record one kernel's dispatch-to-fetch window."""
    m = stats.PROCESS
    m.histogram_observe("device_kernel_seconds", seconds,
                        help_text="device kernel wall time per launch",
                        kernel=kernel)
    m.gauge_set("device_kernel_last_ms", seconds * 1e3, kernel=kernel)
    if nbytes:
        m.counter_add("device_kernel_bytes_total", float(nbytes),
                      kernel=kernel)


def sample_device_memory() -> "dict[str, dict]":
    """Gauge each CUDA device's memory, labelled `cuda:<i>`:
    bytes_in_use (torch.cuda.memory_allocated), peak_bytes_in_use
    (max_memory_allocated) and bytes_limit (the card's total from
    mem_get_info).  Returns {label: stats}; {} when there is no CUDA
    device, as the reference returns {} for a backend without memory
    stats."""
    out: dict[str, dict] = {}
    if not torch.cuda.is_available():
        return out
    m = stats.PROCESS
    for i in range(torch.cuda.device_count()):
        _free, total = torch.cuda.mem_get_info(i)
        ms = {"bytes_in_use": torch.cuda.memory_allocated(i),
              "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
              "bytes_limit": total}
        label = f"cuda:{i}"
        out[label] = ms
        for key, gauge in (("bytes_in_use", "device_memory_bytes_in_use"),
                           ("peak_bytes_in_use",
                            "device_memory_peak_bytes"),
                           ("bytes_limit", "device_memory_bytes_limit")):
            m.gauge_set(gauge, float(ms[key]),
                        help_text="CUDA device memory stats",
                        device=label)
    return out
