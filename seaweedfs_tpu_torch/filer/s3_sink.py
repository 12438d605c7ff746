"""`filer.backup.s3`: mirror a filer's namespace into an S3-compatible
bucket (weed/replication/sink/s3sink/s3_sink.go), the port's copy of
`seaweedfs_tpu/filer/s3_sink.py`: the shared applier
(`cloud_sinks._CloudSink`) with the tier backend's S3 client
(`storage/backend.S3BackendStorage`) for PUT and DELETE, resumable from
its offset checkpoint.  The bucket is made when it is missing."""

from __future__ import annotations

from ..storage.backend import S3BackendStorage
from .cloud_sinks import _CloudSink


class S3Sink(_CloudSink):
    def __init__(self, source: str, endpoint: str, bucket: str,
                 access_key: str = "", secret_key: str = "",
                 key_prefix: str = "", state_path: "str | None" = None,
                 poll_interval: float = 0.2):
        super().__init__(source, f"s3:{endpoint}/{bucket}/{key_prefix}",
                         key_prefix, state_path, poll_interval)
        self.s3 = S3BackendStorage("s3sink", endpoint, bucket, access_key,
                                   secret_key)
        self.s3.ensure_bucket()

    def _upload(self, key: str, data: bytes) -> None:
        self.s3.put_bytes(key, data)

    def _delete(self, key: str) -> None:
        self.s3.delete(key)
