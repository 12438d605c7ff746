"""Leveled, structured logging, the port's copy of
`seaweedfs_tpu/util/wlog.py` — the glog analog (reference:
weed/glog/glog.go V-levels + severities, glog_json.go structured
output, glog_file.go file sinks, glog_ctx.go request-id context).

Design, tpu-framework style rather than a Go port:

- severities INFO < WARNING < ERROR < FATAL map onto the stdlib
  logging hierarchy (one root logger "weed", real handlers, no
  custom file format machinery);
- `V(n)` verbosity gates *debug* detail exactly like glog: `if
  wlog.V(2): wlog.info(...)` or the sugar `wlog.v(2, "...")`.
  Verbosity comes from `-v N` on every CLI role (or WEED_V);
- every line carries the active request id (util/request_id
  contextvar) when one is set, so a single request can be traced
  across gateway -> filer -> volume hops;
- `-logtostderr` is the default (tests, containers); `set_output`
  adds a file sink with size-based rotation (glog_file.go role);
- `json_format(True)` switches to one-JSON-object-per-line
  (glog_json.go) for log shippers.
"""

from __future__ import annotations

import io
import json
import logging
import os
import sys
import threading
import time

# the port's own logger, not the JAX package's "weed": a process that
# imports both packages (the tests) keeps their handlers and formats
# apart
_logger = logging.getLogger("seaweedfs_tpu_torch.wlog")
_logger.setLevel(logging.INFO)
_logger.propagate = False
_verbosity = int(os.environ.get("WEED_V", "0") or 0)
_lock = threading.Lock()
_json = False


class _Formatter(logging.Formatter):
    """glog line shape: `I0131 15:04:05.123456 component] msg`
    (severity letter + MMDD HH:MM:SS.micros), with rid= appended
    when a request id is active."""

    def format(self, record: logging.LogRecord) -> str:
        t = time.localtime(record.created)
        micros = int((record.created % 1) * 1e6)
        rid = current_request_id()
        if _json:
            doc = {"severity": record.levelname,
                   "time": time.strftime("%Y-%m-%dT%H:%M:%S",
                                         t) + f".{micros:06d}",
                   "message": record.getMessage()}
            if getattr(record, "component", ""):
                doc["component"] = record.component
            if rid:
                doc["requestId"] = rid
            return json.dumps(doc)
        letter = record.levelname[0]
        stamp = time.strftime("%m%d %H:%M:%S", t)
        comp = getattr(record, "component", "") or record.module
        line = (f"{letter}{stamp}.{micros:06d} {comp}] "
                f"{record.getMessage()}")
        if rid:
            line += f" rid={rid}"
        return line


class _RotatingHandler(logging.Handler):
    """Size-rotated file sink (glog_file.go keeps dated files; a
    simple .1 shift is the same operational contract: bounded disk,
    most-recent-first)."""

    def __init__(self, path: str, max_bytes: int = 64 << 20,
                 backups: int = 3):
        super().__init__()
        self.path = path
        self.max_bytes = max_bytes
        self.backups = backups
        self._f = open(path, "a", buffering=1)

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record) + "\n"
            with _lock:
                if self._f.tell() + len(line) > self.max_bytes:
                    self._rotate()
                self._f.write(line)
        except Exception:     # noqa: BLE001,SWFS004 — logging must
            pass              # never raise into the caller

    def _rotate(self) -> None:
        self._f.close()
        for i in range(self.backups - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "a", buffering=1)

    def close(self) -> None:
        with _lock:
            self._f.close()
        super().close()


_stderr_handler = logging.StreamHandler(sys.stderr)
_stderr_handler.setFormatter(_Formatter())
_logger.addHandler(_stderr_handler)
_file_handler: "_RotatingHandler | None" = None


# -- configuration ---------------------------------------------------------

def set_verbosity(v: int) -> None:
    """The -v flag (glog vmodule-less form)."""
    global _verbosity
    _verbosity = int(v)


def get_verbosity() -> int:
    return _verbosity


def json_format(enabled: bool = True) -> None:
    global _json
    _json = bool(enabled)


def set_output(path: str, max_bytes: int = 64 << 20,
               backups: int = 3, also_stderr: bool = True) -> None:
    """Add (or replace) the rotating file sink (-logdir role)."""
    global _file_handler
    with _lock:
        old, _file_handler = _file_handler, None
    if old is not None:
        # close OUTSIDE the module lock: the handler's own emit/close
        # take the same (non-reentrant) lock
        _logger.removeHandler(old)
        old.close()
    with _lock:
        _file_handler = _RotatingHandler(path, max_bytes, backups)
    _file_handler.setFormatter(_Formatter())
    _logger.addHandler(_file_handler)
    if not also_stderr:
        _logger.removeHandler(_stderr_handler)


# -- emission --------------------------------------------------------------

class _VGate:
    """`wlog.V(2)` is truthy when verbosity >= 2 and exposes the
    severity methods, so both glog idioms work:
        if wlog.V(2): wlog.info("...")
        wlog.V(2).info("...")"""

    def __init__(self, level: int):
        self.level = level

    def __bool__(self) -> bool:
        return _verbosity >= self.level

    def info(self, msg: str, *args, component: str = "") -> None:
        if self:
            _log(logging.INFO, msg, args, component)

    infof = info


def V(level: int) -> _VGate:            # noqa: N802 — glog name
    return _VGate(level)


def _log(level: int, msg: str, args, component: str) -> None:
    _logger.log(level, msg, *args,
                extra={"component": component} if component else None)


def info(msg: str, *args, component: str = "") -> None:
    _log(logging.INFO, msg, args, component)


def v(level: int, msg: str, *args, component: str = "") -> None:
    if _verbosity >= level:
        _log(logging.INFO, msg, args, component)


def warning(msg: str, *args, component: str = "") -> None:
    _log(logging.WARNING, msg, args, component)


def error(msg: str, *args, component: str = "") -> None:
    _log(logging.ERROR, msg, args, component)


def fatal(msg: str, *args, component: str = "") -> None:
    """glog.Fatal: log then exit(255)."""
    _log(logging.CRITICAL, msg, args, component)
    sys.exit(255)


def exception(msg: str, *args, component: str = "") -> None:
    """error + current traceback (the glog.Errorf("%v", err) +
    debug.PrintStack pattern)."""
    import traceback
    buf = io.StringIO()
    traceback.print_exc(file=buf)
    _log(logging.ERROR, msg + "\n" + buf.getvalue(), args, component)


# -- request-id bridge (util/request_id + glog_ctx.go) ---------------------

def current_request_id() -> str:
    try:
        from .request_id import get_request_id
        return get_request_id()
    except ImportError:         # pragma: no cover
        return ""
