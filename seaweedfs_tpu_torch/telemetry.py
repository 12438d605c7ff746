"""Opt-in cluster telemetry (the counterpart of
`seaweedfs_tpu/telemetry.py`; reference weed/telemetry/client.go and
collector.go).

`TelemetryClient` folds an anonymous shape report of the cluster
(version, OS, server and volume counts, total size) with this
process's scatter-encode and streamed-rebuild totals (counts and bytes,
no volume ids) and POSTs it as JSON to a collector.  The totals are the
volume server's own `/metrics` counters in `stats.PROCESS`.  It is off
unless enabled (the master's `-telemetry -telemetryUrl`), as the
reference ships it, and its instance id is a random UUID kept in
memory only.
"""

from __future__ import annotations

import json
import platform
import threading
import uuid

from . import __version__, stats
from .server.httpd import http_bytes

VERSION = f"seaweedfs-tpu/{__version__}"


def ec_rebuild_totals() -> dict:
    """Streamed rebuilds run in this process, and the survivor bytes
    read into them."""
    m = stats.PROCESS
    return {"count": int(m.counter_sum("ec_rebuilds_total")),
            "bytesFetched": int(m.counter_sum(
                "ec_rebuild_bytes_fetched_total"))}


def ec_scatter_totals() -> dict:
    """Scatter encodes run in this process, and the shard bytes they
    streamed to remote placement targets."""
    m = stats.PROCESS
    return {"count": int(m.counter_sum("ec_scatter_encodes_total")),
            "bytesScattered": int(m.counter_sum(
                "ec_encode_bytes_scattered_total"))}


class TelemetryClient:
    def __init__(self, url: str, enabled: bool = False,
                 interval: float = 24 * 3600.0):
        self.url = url
        self.enabled = enabled and bool(url)
        self.interval = interval
        self.instance_id = str(uuid.uuid4())   # memory only
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def collect(self, master: str) -> dict:
        """The report (telemetry/collector.go's shape).  A master that
        does not answer leaves the cluster keys out."""
        data = {
            "version": VERSION,
            "os": f"{platform.system()}/{platform.machine()}",
            "instanceId": self.instance_id,
        }
        try:
            from .operation import master_json
            status = master_json(master, "GET", "/cluster/status",
                                 timeout=30)
            vols = master_json(master, "GET", "/vol/list", timeout=30)
            data["clusterId"] = status.get("topologyId", "")
            # the answering master is one, whatever `peers` lists
            data["masterCount"] = max(1, len(status.get("peers") or []))
            data["serverCount"] = len(status.get("dataNodes", []))
            from .topology import iter_volume_list_volumes
            sizes = [int(v.get("size", 0))
                     for _node, v in iter_volume_list_volumes(vols)]
            data["volumeCount"] = len(sizes)
            data["totalSizeBytes"] = sum(sizes)
        except (OSError, ValueError):
            pass
        rep = ec_rebuild_totals()
        data["ecRebuildCount"] = rep["count"]
        data["ecRebuildBytesFetched"] = rep["bytesFetched"]
        sca = ec_scatter_totals()
        data["ecScatterEncodeCount"] = sca["count"]
        data["ecScatterBytes"] = sca["bytesScattered"]
        return data

    def send(self, master: str) -> bool:
        if not self.enabled:
            return False
        try:
            status, _, _ = http_bytes(
                "POST", self.url, json.dumps(self.collect(master)).encode(),
                {"Content-Type": "application/json"}, timeout=60)
            return status < 300
        except OSError:
            return False

    def start(self, master: str) -> "TelemetryClient":
        """Report at once, then every `interval` seconds (client.go
        StartReporting); nothing when disabled."""
        if not self.enabled:
            return self

        def loop():
            self.send(master)
            while not self._stop.wait(self.interval):
                self.send(master)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
