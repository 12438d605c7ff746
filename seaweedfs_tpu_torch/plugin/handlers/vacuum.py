"""The vacuum JobHandler (the counterpart of
`seaweedfs_tpu/plugin/handlers/vacuum.py`; plugin/worker's vacuum
handler, worker/tasks/vacuum): propose a compaction of every writable
volume whose garbage, deleted bytes over live bytes, passed the
threshold, and run it on each of the volume's servers
(`/admin/vacuum`)."""

from __future__ import annotations

from ...operation import master_json
from ...server.httpd import http_json
from ...topology import iter_volume_list_volumes
from ..worker import JobHandler, must


class VacuumHandler(JobHandler):
    job_type = "vacuum"

    def __init__(self, garbage_threshold: float = 0.3):
        self.garbage_threshold = garbage_threshold

    def capability(self) -> dict:
        return {"jobType": self.job_type, "canDetect": True,
                "canExecute": True, "weight": 50}

    def descriptor(self) -> dict:
        return {"jobType": self.job_type, "fields": [
            {"name": "garbageThreshold", "type": "float",
             "default": self.garbage_threshold,
             "help": "compact volumes whose garbage ratio exceeds this"},
        ]}

    def detect(self, worker) -> list[dict]:
        """deletedByteCount / (size - deletedByteCount) over the
        threshold, read-only volumes skipped, one proposal a volume."""
        vl = master_json(worker.master, "GET", "/vol/list", timeout=30)
        proposals = []
        seen = set()
        for _node, v in iter_volume_list_volumes(vl):
            vid = v["id"]
            if vid in seen or v.get("readOnly"):
                continue
            seen.add(vid)
            live = max(v.get("size", 0) - v.get("deletedByteCount", 0), 1)
            if v.get("deletedByteCount", 0) / live > self.garbage_threshold:
                proposals.append({"jobType": self.job_type,
                                  "dedupeKey": f"vacuum:{vid}",
                                  "params": {"volumeId": vid}})
        return proposals

    def execute(self, worker, job_id: str, params: dict) -> str:
        vid = int(params["volumeId"])
        locs = master_json(worker.master, "GET",
                           f"/dir/lookup?volumeId={vid}",
                           timeout=30).get("locations", [])
        for i, loc in enumerate(locs):
            worker.report_progress(job_id, 0.1 + 0.8 * i / len(locs),
                                   f"vacuuming volume {vid} on "
                                   f"{loc['url']}")
            must(http_json("POST", f"{loc['url']}/admin/vacuum",
                           {"volumeId": vid}, timeout=3600),
                 f"vacuum on {loc['url']}")
        return f"volume {vid}: vacuumed on {len(locs)} servers"
