"""Cluster coordination primitives (weed/cluster analog), the port's copy
of `seaweedfs_tpu/cluster/`: the filer's lock ring."""

from .lock_manager import ClusterLock, LockManager  # noqa: F401
