"""A device grid with the reference's two axes (the counterpart of
`seaweedfs_tpu/parallel/mesh.py`):

  * "stripe": data-parallel over stripe columns of the volume stream, or
    over volumes in the batch path;
  * "shard": tensor-parallel over shard rows (the 14 shard files that
    the reference spreads across servers).
"""

from __future__ import annotations

import torch

STRIPE_AXIS = "stripe"
SHARD_AXIS = "shard"


class DeviceGrid:
    """A [stripe][shard] array of torch devices, with one stream per
    distinct CUDA device (each device's part of a sharded call is
    launched on its own stream)."""

    def __init__(self, devices: "list[list[torch.device]]"):
        self.devices = devices
        self.shape = {STRIPE_AXIS: len(devices),
                      SHARD_AXIS: len(devices[0])}
        self._streams: "dict[torch.device, torch.cuda.Stream]" = {}

    def stream(self, dev: torch.device) -> "torch.cuda.Stream | None":
        """The grid's stream on `dev` (None for the CPU)."""
        if dev.type != "cuda":
            return None
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def synchronize(self) -> None:
        for s in self._streams.values():
            s.synchronize()


def make_mesh(devices=None, shard_axis_size: "int | None" = None
              ) -> DeviceGrid:
    """Build a ("stripe", "shard") grid over `devices` (default: every
    CUDA device; raises when there is none).

    shard_axis_size defaults to the largest of 4, 3, 2 that divides the
    device count (RS(10,4) has 4 parity rows to split), else 1; the rest
    is the stripe axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=[...] to "
                               "build a grid of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a grid needs at least one device")
    if shard_axis_size is None:
        shard_axis_size = 1
        for cand in (4, 3, 2):
            if n % cand == 0:
                shard_axis_size = cand
                break
    if n % shard_axis_size:
        raise ValueError(f"{n} devices not divisible by shard axis "
                         f"{shard_axis_size}")
    h = shard_axis_size
    return DeviceGrid([devices[i * h:(i + 1) * h] for i in range(n // h)])
