"""Master access for the port's clients: `master_json`, the one call of
`seaweedfs_tpu/operation.py` that the heartbeat, the shell and the
rebuild's survivor lookup make.  The port's master is a single node, so
there is no leader to follow: the seeds of a comma-separated list are
tried in order and the first that answers is used."""

from __future__ import annotations

from .server.httpd import http_json


def master_json(master: str, method: str, path: str,
                payload: dict | None = None, timeout: float = 30.0,
                headers: dict | None = None) -> dict:
    """Call a master endpoint on the first reachable seed of `master`
    (one address or a comma-separated list).  Raises OSError when no
    seed answers; an answer with an "error" key is returned as is."""
    seeds = [s.strip() for s in master.split(",") if s.strip()]
    last = "no masters configured"
    for url in seeds:
        try:
            return http_json(method, f"{url}{path}", payload, timeout,
                             headers=headers)
        except OSError as e:
            last = f"{url}: {e}"
    raise OSError(f"master_json {path}: {last}")
