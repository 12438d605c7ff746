"""FUSE mount (weed/mount): filer-backed op table + ctypes libfuse
bridge, the port's copy of `seaweedfs_tpu/mount/`.  `weedfs.WeedFS` is
the op table over a running filer's HTTP API (kernel-free, driven
directly by tests); `fuse_ctypes` adapts it to libfuse 2.9.  The mount's
gRPC control service and `mount.configure` are not ported: the card's
machine has no `grpc`."""

from .weedfs import FuseError, WeedFS  # noqa: F401
