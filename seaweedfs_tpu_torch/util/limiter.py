"""Bounded fan-out (the `bounded_parallel` of
`seaweedfs_tpu/util/limiter.py`; reference weed/util/limited_executor.go).

`bounded_parallel(fn, items, limit)` maps fn over items with at most
`limit` in flight, keeps their order, and re-raises the first failure
in that order.  It runs on one process-wide pool whose threads outlive
the call (the reference's `persistent=True`, the mode its one caller
uses): the pooled HTTP client keeps its keep-alive sockets per thread
(`server/httpd.py`), so a fresh executor per call would re-dial every
peer on every fan-out.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

_SHARED_WORKERS = 16
_shared_pool: "ThreadPoolExecutor | None" = None
_shared_lock = threading.Lock()


def shared_pool() -> ThreadPoolExecutor:
    """The process-wide pool of every fan-out, started at first use."""
    global _shared_pool
    with _shared_lock:
        if _shared_pool is None:
            _shared_pool = ThreadPoolExecutor(
                max_workers=_SHARED_WORKERS,
                thread_name_prefix="weed-funnel")
        return _shared_pool


def bounded_parallel(fn, items, limit: int = 8) -> list:
    """Map fn over items with at most `limit` concurrent calls; results
    in input order.  0 or 1 items run inline on the caller's thread; more
    run on `shared_pool()`, a semaphore bounding this call to `limit` so
    one caller cannot take every shared worker."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    # bound the submission, not the execution: acquiring inside the
    # worker would park pool threads on the semaphore
    slots = threading.Semaphore(max(1, limit))
    pool = shared_pool()
    futures = []

    def run(x):
        try:
            return fn(x)
        finally:
            slots.release()

    for x in items:
        slots.acquire()
        futures.append(pool.submit(run, x))
    return [f.result() for f in futures]
