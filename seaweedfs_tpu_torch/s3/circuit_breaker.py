"""S3 circuit breaker — concurrent-request admission control
(reference: weed/s3api/s3api_circuit_breaker.go, config shape
s3_pb.S3CircuitBreakerConfig stored at /etc/s3/circuit_breaker.json
per weed/s3api/s3_constants/s3_config.go:8-9).

Limits are on SIMULTANEOUS load, not rates: a request admits by
incrementing in-flight counters (per-bucket and global, request count
and request bytes) and rolls every increment back when it finishes.
Exceeding any limit rejects with the reference's 503 codes
(ErrTooManyRequest / ErrRequestBytesExceed) before any work is done.

Config JSON::

    {"global": {"enabled": true,
                "actions": {"Read:Count": 100, "Write:MB": 64}},
     "buckets": {"img": {"enabled": true,
                         "actions": {"Write:Count": 8}}}}

Action names are the coarse identity actions (Read/Write/List/
Tagging/Admin); limit types are Count and MB (converted to bytes at
load time, matching the reference's LimitTypeBytes counters).

The port's copy of `seaweedfs_tpu/s3/circuit_breaker.py`.
"""

from __future__ import annotations

import json
import threading

CONFIG_DIR = "/etc/s3"
CONFIG_FILE = "circuit_breaker.json"
CONFIG_PATH = CONFIG_DIR + "/" + CONFIG_FILE

_SEP = ":"


def _key(*parts: str) -> str:
    return _SEP.join(parts)


class CircuitBreaker:
    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._limits: dict[str, int] = {}
        self._counters: dict[str, int] = {}

    # -- config -----------------------------------------------------------

    def load(self, doc: dict | None) -> None:
        """Replace limits atomically; unknown keys are rejected so a
        typo'd action name fails loudly at config time, not silently
        at enforcement time."""
        limits: dict[str, int] = {}
        if doc:
            glob = doc.get("global", {}) or {}
            # a disabled global section contributes NO limits (its
            # action entries are kept in the JSON so -disable is
            # reversible, matching the reference config model), and
            # per-bucket sections enable independently of it
            if glob.get("enabled", False):
                for action, value in (glob.get("actions", {}) or
                                      {}).items():
                    limits[_key(*_parse_action(action))] = \
                        _to_bytes(action, value)
            else:
                for action, value in (glob.get("actions", {}) or
                                      {}).items():
                    _parse_action(action)        # still validate
                    _to_bytes(action, value)
            for bucket, cfg in (doc.get("buckets", {}) or {}).items():
                if not (cfg or {}).get("enabled", True):
                    continue
                for action, value in (cfg.get("actions", {}) or
                                      {}).items():
                    limits[_key(bucket, *_parse_action(action))] = \
                        _to_bytes(action, value)
        with self._lock:
            self.enabled = bool(limits)
            self._limits = limits
            # in-flight counters survive a reload: requests admitted
            # under the old config still roll back correctly because
            # rollback closures reference keys, not limits

    def load_bytes(self, content: bytes) -> None:
        self.load(json.loads(content) if content else None)

    # -- admission --------------------------------------------------------

    def admit(self, bucket: str, action: str,
              content_length: int):
        """Returns (rollback, error).  error is None when admitted;
        rollback is a zero-arg callable to run when the request
        finishes (always non-None).  Check order matches the
        reference: bucket count, bucket bytes, global count, global
        bytes — with full rollback of partial increments on trip."""
        if not self.enabled:
            return (lambda: None), None
        checks = [(_key(bucket, action, "Count"), 1,
                   "ErrTooManyRequest"),
                  (_key(bucket, action, "Bytes"),
                   max(content_length, 0), "ErrRequestBytesExceed"),
                  (_key(action, "Count"), 1, "ErrTooManyRequest"),
                  (_key(action, "Bytes"), max(content_length, 0),
                   "ErrRequestBytesExceed")]
        taken: list[tuple[str, int]] = []
        with self._lock:
            for key, inc, code in checks:
                limit = self._limits.get(key)
                if limit is None:
                    continue
                new = self._counters.get(key, 0) + inc
                if new > limit:
                    for k, i in taken:
                        self._counters[k] -= i
                    return None, code
                self._counters[key] = new
                taken.append((key, inc))

        def rollback():
            with self._lock:
                for k, i in taken:
                    self._counters[k] -= i
        return rollback, None

    def in_flight(self) -> dict[str, int]:
        with self._lock:
            return {k: v for k, v in self._counters.items() if v}


def _parse_action(spec: str) -> tuple[str, str]:
    action, _, ltype = spec.partition(_SEP)
    if action not in ("Read", "Write", "List", "Tagging", "Admin"):
        raise ValueError(f"unknown circuit-breaker action {action!r}")
    if ltype not in ("Count", "MB", "Bytes"):
        raise ValueError(f"unknown limit type {ltype!r} "
                         "(use Count or MB)")
    return action, ("Bytes" if ltype in ("MB", "Bytes") else "Count")


def _to_bytes(spec: str, value) -> int:
    v = int(value)
    if v <= 0:
        raise ValueError(f"limit for {spec!r} must be positive")
    return v * (1 << 20) if spec.endswith(_SEP + "MB") else v
