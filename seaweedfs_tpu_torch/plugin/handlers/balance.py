"""The cluster admin lease for handler executions (the part of
`seaweedfs_tpu/plugin/handlers/balance.py` that the EC handlers use).
A handler that places or moves shards takes the shell's lock first, so
it never interleaves with an operator's `ec.encode` or balance.  The
balance handlers themselves are not ported (ROADMAP A)."""

from __future__ import annotations


class _LockedShellRun:
    """Context manager: a CommandEnv holding the cluster admin lease
    for the duration of a handler execution."""

    def __init__(self, master: str):
        from ...shell import CommandEnv
        self.env = CommandEnv(master)

    def __enter__(self):
        self.env.lock()
        return self.env

    def __exit__(self, *exc):
        try:
            self.env.unlock()
        except (OSError, RuntimeError):
            pass  # the lease expires on its own
