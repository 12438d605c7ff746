"""Sharded and volume-batched erasure coding over a grid of devices
(the counterpart of `seaweedfs_tpu/parallel/`)."""

from .mesh import SHARD_AXIS, STRIPE_AXIS, DeviceGrid, make_mesh  # noqa: F401
