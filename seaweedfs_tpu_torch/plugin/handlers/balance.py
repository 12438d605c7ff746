"""The balance JobHandlers (the counterpart of
`seaweedfs_tpu/plugin/handlers/balance.py`; plugin/worker's
volume_balance and ec_balance handlers, worker/tasks/balance/): detect a
skew of volume counts or of one EC volume's shards across the servers,
and run the shell's balancers, `volume.balance` and `ec.balance`.

An execution takes the cluster admin lease first (the shell's lock), so
a balance never interleaves with an operator's `volume.move` or
`ec.encode`; the EC handlers take it the same way."""

from __future__ import annotations

from ...operation import master_json
from ...topology import iter_volume_list_ec_shards, iter_volume_list_volumes
from ..worker import JobHandler


def _volume_counts(master: str) -> "dict[str, int]":
    """Volumes on each server, servers without one included."""
    counts: dict[str, int] = {}
    vl = master_json(master, "GET", "/vol/list", timeout=30)
    for n, _v in iter_volume_list_volumes(vl):
        counts[n["url"]] = counts.get(n["url"], 0) + 1
    for url in master_json(master, "GET", "/cluster/status",
                           timeout=30).get("dataNodes", []):
        counts.setdefault(url, 0)
    return counts


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


class VolumeBalanceHandler(JobHandler):
    job_type = "volume_balance"
    aliases = ["balance"]

    def __init__(self, imbalance_threshold: int = 2):
        self.imbalance_threshold = imbalance_threshold

    def capability(self) -> dict:
        return {"jobType": self.job_type, "canDetect": True,
                "canExecute": True, "weight": 30}

    def descriptor(self) -> dict:
        return {"jobType": self.job_type, "fields": [
            {"name": "imbalanceThreshold", "type": "int",
             "default": self.imbalance_threshold,
             "help": "propose a balance when max-min volume count "
                     "per server exceeds this"},
        ]}

    def detect(self, worker) -> list[dict]:
        """One cluster-wide job while the max-min spread of volume
        counts passes the threshold."""
        counts = _volume_counts(worker.master)
        if len(counts) < 2:
            return []
        spread = max(counts.values()) - min(counts.values())
        if spread <= self.imbalance_threshold:
            return []
        return [{"jobType": self.job_type, "dedupeKey": "volume_balance",
                 "params": {"spread": spread}}]

    def execute(self, worker, job_id: str, params: dict) -> str:
        from ...shell.commands import cmd_volume_balance
        worker.report_progress(job_id, 0.1, "acquiring cluster lock")
        with _LockedShellRun(worker.master) as env:
            worker.report_progress(job_id, 0.3, "balancing volumes")
            return cmd_volume_balance(env, [])


class EcBalanceHandler(JobHandler):
    job_type = "ec_balance"

    def __init__(self, collection: str = ""):
        self.collection = collection

    def capability(self) -> dict:
        return {"jobType": self.job_type, "canDetect": True,
                "canExecute": True, "weight": 30}

    def descriptor(self) -> dict:
        return {"jobType": self.job_type, "fields": [
            {"name": "collection", "type": "string",
             "default": self.collection},
        ]}

    def detect(self, worker) -> list[dict]:
        """One cluster-wide job when a server holds more shards of one
        EC volume than ceil(its shards / servers) (ec_balance.go's skew
        rule, as the shell's balancer enforces it)."""
        vl = master_json(worker.master, "GET", "/vol/list", timeout=30)
        per_vid: dict[int, dict[str, int]] = {}
        for node, e in iter_volume_list_ec_shards(vl):
            n = bin(e.get("shardBits", 0)).count("1")
            per_vid.setdefault(e["volumeId"], {})[node["url"]] = n
        nodes = master_json(worker.master, "GET", "/cluster/status",
                            timeout=30).get("dataNodes", [])
        if not nodes:
            return []
        for holders in per_vid.values():
            fair = -(-sum(holders.values()) // len(nodes))
            if max(holders.values(), default=0) > fair:
                return [{"jobType": self.job_type,
                         "dedupeKey": "ec_balance",
                         "params": {"collection": self.collection}}]
        return []

    def execute(self, worker, job_id: str, params: dict) -> str:
        from ...shell.commands import cmd_ec_balance
        worker.report_progress(job_id, 0.1, "acquiring cluster lock")
        collection = params.get("collection", self.collection)
        args = [f"-collection={collection}"] if collection else []
        with _LockedShellRun(worker.master) as env:
            worker.report_progress(job_id, 0.3, "balancing ec shards")
            return cmd_ec_balance(env, args)
