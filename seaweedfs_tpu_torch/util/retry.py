"""Per-peer circuit breakers: the part of `seaweedfs_tpu/util/retry.py`
that the shell's placement planner reads (`peer_available`).

A peer's breaker opens after `BREAKER_THRESHOLD` consecutive failures
and half-opens once `BREAKER_COOLDOWN` seconds have passed; one
success closes it.  The planner never places a shard on an open peer.
The retry loop and the retry budget of the reference are not ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


BREAKER_THRESHOLD = 5
BREAKER_COOLDOWN = 2.0


@dataclass
class _Breaker:
    state: str = CLOSED
    failures: int = 0
    opened_at: float = 0.0


_breakers: "dict[str, _Breaker]" = {}
_lock = threading.Lock()


def record_success(peer: str) -> None:
    with _lock:
        b = _breakers.get(peer)
        if b is not None:
            b.state, b.failures = CLOSED, 0


def record_failure(peer: str) -> None:
    with _lock:
        b = _breakers.setdefault(peer, _Breaker())
        b.failures += 1
        half_open = b.state == OPEN and \
            time.monotonic() >= b.opened_at + BREAKER_COOLDOWN
        if half_open or b.failures >= BREAKER_THRESHOLD:
            b.state = OPEN
            b.opened_at = time.monotonic()


def peer_state(peer: str) -> str:
    with _lock:
        b = _breakers.get(peer)
        if b is None:
            return CLOSED
        if b.state == OPEN and \
                time.monotonic() >= b.opened_at + BREAKER_COOLDOWN:
            return HALF_OPEN  # a probe would be admitted
        return b.state


def peer_available(peer: str) -> bool:
    """False only while the peer's breaker is open with cooldown left
    (a half-open peer is worth a probe)."""
    return peer_state(peer) != OPEN


def health_snapshot() -> "dict[str, dict]":
    """Every peer whose breaker is not closed or has failures counted,
    for `GET /debug/health`."""
    with _lock:
        peers = {p: b.failures for p, b in _breakers.items()
                 if b.state != CLOSED or b.failures}
    return {p: {"state": peer_state(p), "consecutiveFailures": n}
            for p, n in sorted(peers.items())}


def reset(peer: "str | None" = None) -> None:
    with _lock:
        if peer is None:
            _breakers.clear()
        else:
            _breakers.pop(peer, None)
