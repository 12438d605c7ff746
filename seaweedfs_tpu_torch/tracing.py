"""In-process tracer: spans with explicit parentage in a ring buffer
(the span core of `seaweedfs_tpu/tracing.py`).

A span records one timed unit of work (an EC pipeline stage, a request)
with its trace id and parent, so one operation's tree can be read back
with `spans_for(trace_id)` and show where the time went.

- the ring buffer keeps `SEAWEEDFS_TPU_TRACE_BUFFER` spans (default
  4096); there is no exporter and no background thread;
- `SEAWEEDFS_TPU_TRACE_SAMPLE` (0.0-1.0, default 1.0) drops span
  recording, never id propagation;
- spans at least `SEAWEEDFS_TPU_SLOW_MS` long are logged at WARNING.

The trace id follows the request id of `util/request_id`'s contextvar
(`set_request_id`), the one the HTTP fronts set and `util/wlog` puts on
every line.  Over HTTP the request id rides `X-Request-ID` and
the parent span `X-Trace-Parent` (`<trace_id>-<span_id>`), the
reference's headers, so a trace crosses servers of either package.
A maintenance job carries its trace context in the job message instead:
the worker adopts it (`adopt_remote_parent`) and reports its spans with
the job, and the admin re-records them (`ingest`).

    with tracing.span("ec.encode", role="volume") as sp:
        sp.set("volume", 7)

    tracing.emit_span("encode.read", start, duration, ...)
    # post-hoc emission for work measured elsewhere (pipeline stages)
"""

from __future__ import annotations

import contextvars
import itertools
import os
import random
import secrets
import threading
import time
from collections import deque

from .util import request_id as _request_id
from .util import wlog

HEADER = "X-Trace-Parent"
REQUEST_ID_HEADER = _request_id.HEADER
# the request id is `util/request_id`'s contextvar, the one the HTTP
# fronts set and every log line reads
set_request_id = _request_id.set_request_id
reset_request_id = _request_id.reset_request_id
get_request_id = _request_id.get_request_id


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def buffer_size() -> int:
    """SEAWEEDFS_TPU_TRACE_BUFFER: spans kept per process."""
    return max(16, _env_int("SEAWEEDFS_TPU_TRACE_BUFFER", 4096))


def sample_rate() -> float:
    """SEAWEEDFS_TPU_TRACE_SAMPLE in [0, 1]: fraction of spans
    recorded to the ring buffer."""
    return min(1.0, max(0.0, _env_float("SEAWEEDFS_TPU_TRACE_SAMPLE",
                                        1.0)))


def slow_ms() -> float:
    """SEAWEEDFS_TPU_SLOW_MS: spans at least this slow are logged at
    WARNING; unset or <= 0 disables the slow log."""
    return _env_float("SEAWEEDFS_TPU_SLOW_MS", 0.0)


_buffer: "deque[dict]" = deque(maxlen=buffer_size())
_buffer_lock = threading.Lock()

# (trace_id, span_id, role) of the active span on this context
_current: contextvars.ContextVar["tuple[str, str, str] | None"] = \
    contextvars.ContextVar("weed_trace_span", default=None)

# span ids need uniqueness, not unpredictability: 6 random hex chars
# pin the process, a counter distinguishes spans
_SPAN_PREFIX = secrets.token_hex(3)
_span_counter = itertools.count(1)


def new_span_id() -> str:
    return f"{_SPAN_PREFIX}{next(_span_counter) & 0xFFFFFF:06x}"


class Span:
    """One unit of timed work: plain attributes, no dict allocated
    until an attr is set."""

    __slots__ = ("trace_id", "span_id", "parent_id", "role", "name",
                 "start", "duration", "attrs", "error", "_token",
                 "_t0", "_finished")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str, role: str):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.role = role
        self.start = time.time()
        self.duration = 0.0
        self.attrs: "dict | None" = None
        self.error = False
        self._token = None
        self._t0 = time.perf_counter()
        self._finished = False

    def set(self, key: str, value) -> "Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def set_error(self, err=None) -> "Span":
        self.error = True
        if err is not None:
            self.set("error", f"{type(err).__name__}: {err}")
        return self

    def finish(self) -> None:
        """Close the span: compute its duration, restore the previous
        current span, record it.  A second finish is a no-op."""
        if self._finished:
            return
        self._finished = True
        self.duration = time.perf_counter() - self._t0
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:   # finished on a different context
                pass
            self._token = None
        _record(self.to_dict())

    def to_dict(self) -> dict:
        d = {"traceId": self.trace_id, "spanId": self.span_id,
             "parentId": self.parent_id, "role": self.role,
             "name": self.name, "start": self.start,
             "durationMs": round(self.duration * 1e3, 3)}
        if self.error:
            d["error"] = True
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.set_error(exc)
        self.finish()


def _slow_log_and_sample(doc: dict, threshold: float,
                         rate: float) -> bool:
    """Slow-log the span (whatever the sampling); True when the sample
    keeps it."""
    if threshold > 0 and doc["durationMs"] >= threshold:
        wlog.warning("slow span %s (%s) %.1fms trace=%s span=%s attrs=%s",
                     doc["name"], doc["role"] or "-", doc["durationMs"],
                     doc["traceId"], doc["spanId"], doc.get("attrs") or {},
                     component="trace")
    return not (rate < 1.0 and random.random() >= rate)


def _buffer_extend(docs) -> None:
    global _buffer
    with _buffer_lock:
        if _buffer.maxlen != buffer_size():
            # the knob changed since import: keep the newest spans
            _buffer = deque(_buffer, maxlen=buffer_size())
        _buffer.extend(docs)


def _record(doc: dict) -> None:
    if _slow_log_and_sample(doc, slow_ms(), sample_rate()):
        _buffer_extend((doc,))


def start_span(name: str, role: str = "", parent: "str | None" = None,
               trace_id: "str | None" = None) -> Span:
    """Open a span and make it the context's current span; the caller
    must finish() it (or use `span` as a context manager).

    Parent: explicit `parent`, else the current span.  Trace id:
    explicit, else the current span's, else the request id, else a
    fresh one."""
    cur = _current.get()
    if parent is None:
        parent = cur[1] if cur else ""
    if not role and cur:
        role = cur[2]
    if trace_id is None:
        trace_id = (cur[0] if cur else "") or get_request_id() or \
            secrets.token_hex(8)
    sp = Span(name, trace_id, new_span_id(), parent, role)
    sp._token = _current.set((sp.trace_id, sp.span_id, sp.role))
    return sp


def span(name: str, role: str = "", parent: "str | None" = None,
         trace_id: "str | None" = None) -> Span:
    """Context-manager form (the default way to trace a block)."""
    return start_span(name, role=role, parent=parent, trace_id=trace_id)


def emit_span(name: str, start: float, duration: float,
              role: str = "", parent: str = "",
              trace_id: str = "", attrs: "dict | None" = None,
              error: bool = False) -> dict:
    """Record an already-measured span (work timed outside the tracer,
    such as pipeline stages whose lifetime spans threads).  Returns the
    recorded document."""
    cur = _current.get()
    doc = {
        "traceId": trace_id or (cur[0] if cur else "") or
        get_request_id() or secrets.token_hex(8),
        "spanId": new_span_id(),
        "parentId": parent or (cur[1] if cur else ""),
        "role": role or (cur[2] if cur else ""),
        "name": name, "start": start,
        "durationMs": round(duration * 1e3, 3)}
    if error:
        doc["error"] = True
    if attrs:
        doc["attrs"] = dict(attrs)
    _record(doc)
    return doc


def emit_span_batch(items: "list[dict]") -> None:
    """`emit_span` for many spans at once (a stage track's siblings):
    the knobs are read once a batch, not once a span.  Each item carries
    emit_span's keywords (name, start, duration, role, parent, trace_id,
    attrs, error)."""
    if not items:
        return
    cur = _current.get()
    threshold = slow_ms()
    rate = sample_rate()
    out = []
    for it in items:
        doc = {
            "traceId": it.get("trace_id") or (cur[0] if cur else "")
            or get_request_id() or secrets.token_hex(8),
            "spanId": new_span_id(),
            "parentId": it.get("parent") or (cur[1] if cur else ""),
            "role": it.get("role") or (cur[2] if cur else ""),
            "name": it["name"], "start": it["start"],
            "durationMs": round(it["duration"] * 1e3, 3)}
        if it.get("error"):
            doc["error"] = True
        attrs = it.get("attrs")
        if attrs:
            doc["attrs"] = dict(attrs)
        if _slow_log_and_sample(doc, threshold, rate):
            out.append(doc)
    if out:
        _buffer_extend(out)


def emit_plane_hop(name: str, role: str, trace_id: str,
                   start: float, duration: float,
                   stages: "list[tuple[str, float]]",
                   attrs: "dict | None" = None,
                   error: bool = False) -> dict:
    """One native-plane hop as a span tree: the hop's span and one child
    a non-zero stage, laid back to back from the hop's start (the planes
    time stages as consecutive windows of one pass).  The drainer calls
    it after the fact, so a plane-served request joins the trace of the
    Python hops that share its request id."""
    hop = emit_span(name, start, duration, role=role, parent="",
                    trace_id=trace_id, attrs=attrs, error=error)
    items = []
    at = start
    for stage_name, stage_s in stages:
        if stage_s <= 0.0:
            continue
        items.append({"name": f"plane.{stage_name}", "start": at,
                      "duration": stage_s, "role": role,
                      "parent": hop["spanId"], "trace_id": trace_id})
        at += stage_s
    emit_span_batch(items)
    return hop


def current_ids() -> "tuple[str, str, str] | None":
    """(trace_id, span_id, role) of the active span, or None.  Capture
    this before handing work to another thread (contextvars do not
    follow threading.Thread) and pass it back as the parent."""
    return _current.get()


def traceparent_header() -> str:
    """`<trace_id>-<span_id>` for an outbound X-Trace-Parent header;
    empty when no span is active."""
    cur = _current.get()
    return f"{cur[0]}-{cur[1]}" if cur else ""


def parse_traceparent(value: "str | None") -> "tuple[str, str]":
    """(trace_id, parent_span_id) from an inbound header; ("", "") when
    absent or malformed."""
    if not value or "-" not in value:
        return "", ""
    trace_id, _, span_id = value.rpartition("-")
    if not trace_id or not span_id:
        return "", ""
    return trace_id, span_id


def adopt_remote_parent(header_value: "str | None",
                        role: str = "") -> None:
    """Make an inbound trace parent (`<trace_id>-<span_id>`) the
    context's current span without opening a local span: the worker
    adopts a job's context, then opens its own child spans.  An absent
    or malformed value clears the context instead, so a long-lived loop
    thread never carries one job's ancestry into the next."""
    trace_id, span_id = parse_traceparent(header_value)
    _current.set((trace_id, span_id, role) if trace_id else None)


def ingest(spans: "list[dict]") -> int:
    """Re-record span documents made by another process into this
    process's ring buffer (the admin keeps the spans a worker reports
    with a finished job).  Malformed entries are dropped and span ids
    already buffered skipped, so a report sent twice adds nothing
    twice; returns how many were added."""
    global _buffer
    added = 0
    with _buffer_lock:
        if _buffer.maxlen != buffer_size():
            _buffer = deque(_buffer, maxlen=buffer_size())
        have = {d["spanId"] for d in _buffer}
        for doc in spans or []:
            if not isinstance(doc, dict) or not (
                    doc.get("traceId") and doc.get("spanId") and
                    doc.get("name")) or doc["spanId"] in have:
                continue
            doc = dict(doc)
            doc.setdefault("parentId", "")
            doc.setdefault("role", "")
            doc.setdefault("start", 0.0)
            doc.setdefault("durationMs", 0.0)
            _buffer.append(doc)
            have.add(doc["spanId"])
            added += 1
    return added


def spans_for(trace_id: str) -> "list[dict]":
    with _buffer_lock:
        return [dict(d) for d in _buffer if d["traceId"] == trace_id]


def recent_spans(limit: int = 200) -> "list[dict]":
    with _buffer_lock:
        docs = list(_buffer)
    return [dict(d) for d in docs[-max(1, limit):]]


def reset_buffer() -> None:
    """Empty the ring buffer."""
    with _buffer_lock:
        _buffer.clear()
