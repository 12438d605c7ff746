"""Request-id propagation, the port's copy of
`seaweedfs_tpu/util/request_id.py` (reference: weed/util/request_id — a
context key set by middleware and forwarded on outbound calls as the
`X-Request-ID` header).

This is the one request-id contextvar of the port: `tracing` (a span's
trace id), both HTTP fronts (`server/httpd.py`, `server/async_front.py`,
which set it and echo it in the answer) and `util/wlog` (each line)
read it, so a log line, a span and the answer carry the same id.

A contextvar follows the request across the thread handling it; the
HTTP server sets it from the inbound header (or mints one), the
shared HTTP client helpers attach it to outbound hops, and wlog
appends it to every line — one id traces gateway -> filer -> volume.
Contextvars propagate into `threading.Thread` only via
`contextvars.copy_context()`; the data plane handles each request on
one thread, which is the path that matters.
"""

from __future__ import annotations

import contextvars
import itertools
import os

HEADER = "X-Request-ID"

_request_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "weed_request_id", default="")

# fast minting: ids need process-lifetime uniqueness and log
# greppability, not unpredictability — secrets.token_hex per request
# was a measurable slice of the write-path profile.  12 random hex
# chars pin the process, a C-level counter (atomic under the GIL)
# distinguishes requests.
_RID_PREFIX = os.urandom(6).hex()
_rid_counter = itertools.count(int.from_bytes(os.urandom(2), "big"))


def new_request_id() -> str:
    return f"{_RID_PREFIX}{next(_rid_counter) & 0xFFFFFFFF:04x}"


def get_request_id() -> str:
    return _request_id.get()


def set_request_id(rid: str) -> "contextvars.Token":
    return _request_id.set(rid)


def ensure_request_id(inbound: "str | None") -> str:
    """Adopt the caller's id or mint one (request_id middleware
    semantics: ids are created at the edge and preserved through
    every internal hop)."""
    rid = inbound or new_request_id()
    _request_id.set(rid)
    return rid


def reset_request_id(token) -> None:
    _request_id.reset(token)
