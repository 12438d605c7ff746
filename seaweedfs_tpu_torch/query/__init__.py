"""Query engine (weed/query/engine/), the port's copy of
`seaweedfs_tpu/query/`: the SQL-subset select over stored JSON/CSV
objects that S3 Select runs."""

from .engine import QueryError, run_query  # noqa: F401
