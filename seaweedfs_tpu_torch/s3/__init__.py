"""S3 API gateway over the filer (weed/s3api), the port's copy of
`seaweedfs_tpu/s3/`."""

from .s3_server import S3ApiServer  # noqa: F401
