"""Servers of the port: the volume server's EC admin routes over a
threaded HTTP server (the subset of `seaweedfs_tpu.server` that
scatter-encode and the streamed rebuild use)."""
