"""Remote storage gateway (reference: weed/remote_storage/ +
weed/command/filer_remote_mount.go / filer_remote_sync.go), the port's
copy of `seaweedfs_tpu/remote/`.

A filer directory can MOUNT a prefix of a foreign S3-compatible
object store: metadata is pulled into filer entries carrying a remote
pointer (filer_pb.RemoteEntry analog in extended["remote"]) with no
chunks; the filer read path fetches uncached content straight from
the remote (read-through), `remote.cache` materializes it into local
chunks, and RemoteSyncer tails the filer metadata log to push local
writes/deletes back up — the reference's filer.remote.sync loop.

Remote connection configs persist in the filer under
/etc/remote/<name>.conf; mounts in /etc/remote/mounts.json — the
same place the reference keeps them, so every filer/gateway process
sees one truth.
"""

from .remote_storage import (RemoteError, S3RemoteStorage, cache_path,
                             load_conf, load_mounts, mount_remote,
                             remote_for_path, save_conf, save_mounts,
                             uncache_path)
from .sync import RemoteSyncer

__all__ = ["RemoteError", "S3RemoteStorage", "RemoteSyncer",
           "cache_path", "load_conf", "load_mounts", "mount_remote",
           "remote_for_path", "save_conf", "save_mounts",
           "uncache_path"]
