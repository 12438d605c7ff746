"""Admin server: the worker registry, detection scheduling and job
dispatch of the maintenance plane, and its browser UI (`admin_ui.py`)
(the counterpart of `seaweedfs_tpu/plugin/admin.py`; reference
weed/admin/maintenance/maintenance_manager.go and admin/plugin/:
PluginRegistry, DetectorScheduler, JobDispatcher, SchemaCoordinator,
ConfigStore).

The reference's worker stream (pb/plugin.proto:12 WorkerStream) is an
HTTP long-poll here: a worker registers (capabilities and config
schemas), then polls `/worker/poll` for the admin's messages
(`runDetection`, `executeJob`) and POSTs its own (detection results,
progress, completion).

    POST /worker/register, /worker/poll, /worker/detection_result,
         /worker/progress, /worker/complete
    POST /maintenance/submit_job, /maintenance/trigger_detection
    GET  /maintenance/job?id=, /maintenance/queue
    GET/POST /maintenance/config
    GET  /debug/traces?request_id=   the spans workers reported
    GET  /, /ui/volumes, /ui/ec, /ui/jobs, /ui/config; POST /ui/config,
         /ui/actions                 the UI (CSRF token, admin key)

With `data_dir` the plane persists under `<data_dir>/plugin/`:
`jobs.jsonl` (an append-only log of job states, folded at load and
compacted when it grows past 4x the live set), `workers.json` (the
registry) and `config.json` (the config values a job type), so jobs,
dedupe keys and config survive a restart.  Each progress report is
kept in the job's trace beside its state changes.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field

from .. import tracing
from ..server.httpd import HttpServer, Request, admin_guard


def _trace_ctx() -> "tuple[str, str]":
    """(request id, trace parent) of the request minting a job, so
    the worker's execution joins the submitter's trace."""
    return tracing.get_request_id(), tracing.traceparent_header()


@dataclass
class WorkerInfo:
    worker_id: str
    capabilities: list[dict] = field(default_factory=list)
    last_seen: float = 0.0
    inflight: int = 0
    max_concurrent: int = 1

    def can(self, job_type: str) -> bool:
        return any(c.get("jobType") == job_type
                   for c in self.capabilities)


@dataclass
class Job:
    job_id: str
    job_type: str
    params: dict
    dedupe_key: str
    status: str = "pending"   # pending -> assigned -> done/failed
    worker_id: str = ""
    progress: float = 0.0
    message: str = ""
    created: float = field(default_factory=time.time)
    updated: float = field(default_factory=time.time)
    # why the job exists, each state change and each progress report
    trace: list = field(default_factory=list)
    # trace context of the request that minted the job, delivered with
    # executeJob
    request_id: str = ""
    trace_parent: str = ""

    def add_trace(self, event: str) -> None:
        self.trace.append({"ts": round(time.time(), 3), "event": event})

    def to_json(self) -> dict:
        return {"jobId": self.job_id, "jobType": self.job_type,
                "params": self.params, "dedupeKey": self.dedupe_key,
                "status": self.status, "workerId": self.worker_id,
                "progress": self.progress, "message": self.message,
                "created": self.created, "updated": self.updated,
                "trace": self.trace, "requestId": self.request_id,
                "traceParent": self.trace_parent}

    @classmethod
    def from_json(cls, d: dict) -> "Job":
        return cls(job_id=d["jobId"], job_type=d["jobType"],
                   params=d.get("params", {}),
                   dedupe_key=d.get("dedupeKey", ""),
                   status=d.get("status", "pending"),
                   worker_id=d.get("workerId", ""),
                   progress=d.get("progress", 0.0),
                   message=d.get("message", ""),
                   created=d.get("created", 0.0),
                   updated=d.get("updated", 0.0),
                   trace=d.get("trace", []),
                   request_id=d.get("requestId", ""),
                   trace_parent=d.get("traceParent", ""))


class AdminServer:
    """The maintenance plane's controller."""

    # a worker silent this long with work in flight is presumed dead;
    # its assigned jobs requeue so their dedupe keys stop blocking
    # detection
    WORKER_DEAD_AFTER = 60.0
    # an assigned job without progress this long requeues even if its
    # worker still polls (a lost completion report)
    JOB_STALL_AFTER = 300.0

    _FIELD_TYPES = {"int": int, "float": float, "string": str,
                    "bool": bool}

    def __init__(self, master: str, host: str = "127.0.0.1", port: int = 0,
                 detection_interval: float = 30.0,
                 data_dir: "str | None" = None):
        self.master = master
        self.detection_interval = detection_interval
        self.workers: dict[str, WorkerInfo] = {}
        self.jobs: dict[str, Job] = {}
        self._dedupe: dict[str, str] = {}  # dedupe key -> job id
        # job type -> descriptor fields (SchemaCoordinator) and
        # job type -> operator values (ConfigStore)
        self.schemas: dict[str, list] = {}
        self.config: dict[str, dict] = {}
        self.lock = threading.RLock()
        self._stop = threading.Event()
        self.data_dir = data_dir
        self._jobs_f = None
        self._job_records = 0
        if data_dir:
            self._plugin_dir = os.path.join(data_dir, "plugin")
            os.makedirs(self._plugin_dir, exist_ok=True)
            with self.lock:
                self._load_state()
        self.http = HttpServer(host, port)
        self.http.role = "admin"
        # the admin JWT on `/debug/*`, as every role has it; the UI's
        # writes check it themselves, before their CSRF token
        self.http.guard = admin_guard
        r = self.http.route
        r("POST", "/worker/register", self._register)
        r("POST", "/worker/poll", self._poll)
        r("POST", "/worker/detection_result", self._detection_result)
        r("POST", "/worker/progress", self._progress)
        r("POST", "/worker/complete", self._complete)
        r("GET", "/maintenance/config", self._get_config)
        r("POST", "/maintenance/config", self._set_config)
        r("GET", "/maintenance/job", self._job_detail)
        r("GET", "/maintenance/queue", self._queue)
        r("POST", "/maintenance/trigger_detection", self._trigger)
        r("POST", "/maintenance/submit_job", self._submit_job)
        r("GET", "/debug/traces", self._traces)
        from .admin_ui import AdminUI
        self.ui = AdminUI(self)
        self._detect_thread: threading.Thread | None = None
        self._pending_detection: list[str] = []  # worker ids to ask

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "AdminServer":
        self.http.start()
        self._detect_thread = threading.Thread(
            target=self._detection_loop, name="admin-detection",
            daemon=True)
        self._detect_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._detect_thread is not None:
            self._detect_thread.join(timeout=10)
        self.http.stop()
        with self.lock:
            if self._jobs_f is not None:
                self._jobs_f.close()
                self._jobs_f = None

    @property
    def url(self) -> str:
        return self.http.url

    # -- persistence (<data_dir>/plugin/) ----------------------------------

    def _load_state(self) -> None:
        """Recovery at start; the caller holds the lock."""
        jobs_path = os.path.join(self._plugin_dir, "jobs.jsonl")
        try:
            with open(jobs_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        d = json.loads(line)
                    except ValueError:
                        break   # a torn tail: its job's older record holds
                    self.jobs[d["jobId"]] = Job.from_json(d)
                    self._job_records += 1
        except OSError:
            pass
        for job in self.jobs.values():
            # the assignment's report channel died with the old process
            if job.status == "assigned":
                job.status = "pending"
                job.worker_id = ""
                job.add_trace("requeued: admin restart")
            self._dedupe[job.dedupe_key] = job.job_id
        try:
            with open(os.path.join(self._plugin_dir, "workers.json")) as f:
                for d in json.load(f):
                    self.workers[d["workerId"]] = WorkerInfo(
                        worker_id=d["workerId"],
                        capabilities=d.get("capabilities", []),
                        last_seen=0.0,
                        max_concurrent=d.get("maxConcurrent", 1))
                    for desc in d.get("descriptors", []):
                        if desc.get("jobType"):
                            self.schemas[desc["jobType"]] = \
                                desc.get("fields", [])
        except (OSError, ValueError):
            pass
        try:
            with open(os.path.join(self._plugin_dir, "config.json")) as f:
                self.config = json.load(f)
        except (OSError, ValueError):
            pass
        if self.jobs:
            self._compact_jobs()

    def _persist_job(self, job: Job) -> None:
        """Append the job's current state; the caller holds the lock."""
        if not self.data_dir:
            return
        if self._jobs_f is None:
            self._jobs_f = open(
                os.path.join(self._plugin_dir, "jobs.jsonl"), "a")
        self._jobs_f.write(json.dumps(job.to_json()) + "\n")
        self._jobs_f.flush()
        self._job_records += 1
        if self._job_records > 4 * max(len(self.jobs), 64):
            self._compact_jobs()

    def _compact_jobs(self) -> None:
        """Rewrite the log as one record a job; the caller holds the
        lock."""
        if self._jobs_f is not None:
            self._jobs_f.close()
        path = os.path.join(self._plugin_dir, "jobs.jsonl")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for j in sorted(self.jobs.values(), key=lambda j: j.created):
                f.write(json.dumps(j.to_json()) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._jobs_f = open(path, "a")
        self._job_records = len(self.jobs)

    def _write_json(self, name: str, doc) -> None:
        """Replace `<data_dir>/plugin/<name>` atomically; the caller
        holds the lock."""
        if not self.data_dir:
            return
        path = os.path.join(self._plugin_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def _persist_workers(self) -> None:
        self._write_json("workers.json", [{
            "workerId": w.worker_id,
            "capabilities": w.capabilities,
            "maxConcurrent": w.max_concurrent,
            "descriptors": [{"jobType": jt, "fields": fields}
                            for jt, fields in self.schemas.items()
                            if w.can(jt)],
        } for w in self.workers.values()])

    # -- worker protocol --------------------------------------------------

    def _register(self, req: Request):
        b = req.json()
        wid = b.get("workerId") or uuid.uuid4().hex[:12]
        with self.lock:
            self.workers[wid] = WorkerInfo(
                worker_id=wid,
                capabilities=b.get("capabilities", []),
                # liveness on the monotonic clock: a clock step must not
                # reap every worker or none
                last_seen=time.monotonic(),
                max_concurrent=int(b.get("maxConcurrent", 1)))
            for desc in b.get("descriptors", []):
                if desc.get("jobType"):
                    self.schemas[desc["jobType"]] = desc.get("fields", [])
            self._persist_workers()
        return 200, {"workerId": wid}

    def _poll(self, req: Request):
        """Long-poll: the next message for this worker (a detection
        request or a job), or `none` when `waitSeconds` runs out."""
        b = req.json()
        wid = b["workerId"]
        deadline = time.monotonic() + float(b.get("waitSeconds", 10.0))
        while time.monotonic() < deadline and not self._stop.is_set():
            with self.lock:
                w = self.workers.get(wid)
                if w is None:
                    return 404, {"error": "unregistered worker"}
                w.last_seen = time.monotonic()
                if wid in self._pending_detection:
                    self._pending_detection.remove(wid)
                    return 200, {"type": "runDetection",
                                 "config": dict(self.config)}
                job = self._next_job_for(w)
                if job is not None:
                    job.status = "assigned"
                    job.worker_id = wid
                    job.updated = time.time()
                    job.add_trace(f"assigned to {wid}")
                    self._persist_job(job)
                    w.inflight += 1
                    return 200, {"type": "executeJob",
                                 "jobId": job.job_id,
                                 "jobType": job.job_type,
                                 "params": job.params,
                                 "requestId": job.request_id,
                                 "traceParent": job.trace_parent}
            time.sleep(0.05)
        return 200, {"type": "none"}

    def _next_job_for(self, w: WorkerInfo) -> "Job | None":
        if w.inflight >= w.max_concurrent:
            return None
        for job in sorted(self.jobs.values(), key=lambda j: j.created):
            if job.status == "pending" and w.can(job.job_type):
                return job
        return None

    def _live_job(self, key: str) -> "str | None":
        """The id of the pending or assigned job holding `key`."""
        jid = self._dedupe.get(key)
        if jid and self.jobs[jid].status in ("pending", "assigned"):
            return jid
        return None

    def _detection_result(self, req: Request):
        """Detection proposals into the job queue, deduped by key."""
        b = req.json()
        accepted = []
        with self.lock:
            for prop in b.get("proposals", []):
                key = prop.get("dedupeKey") or \
                    f"{prop['jobType']}:{prop['params'].get('volumeId')}"
                if self._live_job(key):
                    continue
                rid, tparent = _trace_ctx()
                job = Job(job_id=uuid.uuid4().hex[:12],
                          job_type=prop["jobType"],
                          params=prop["params"], dedupe_key=key,
                          request_id=rid, trace_parent=tparent)
                job.add_trace(
                    f"detected by {b.get('workerId', '?')}"
                    + (f": {prop['reason']}" if prop.get("reason")
                       else ""))
                self.jobs[job.job_id] = job
                self._dedupe[key] = job.job_id
                self._persist_job(job)
                accepted.append(job.job_id)
        return 200, {"accepted": accepted}

    def _submit_job(self, req: Request):
        """An operator's job (e.g. a multi-volume batch EC job)."""
        b = req.json()
        job_type = b.get("jobType")
        if not job_type:
            return 400, {"error": "jobType required"}
        params = b.get("params", {})
        with self.lock:
            # a job nobody can run would sit pending and hold its key
            if not any(w.can(job_type) for w in self.workers.values()):
                return 400, {"error": f"no registered worker has the "
                                      f"{job_type!r} capability"}
            key = b.get("dedupeKey") or uuid.uuid4().hex
            # a batch EC job claims each volume's key too: it must never
            # run beside a single-volume job of one of its volumes (the
            # loser's unwind would delete the winner's mounted shards
            # after the original is gone)
            keys = [key]
            if job_type == "erasure_coding" and \
                    isinstance(params.get("volumeIds"), list):
                keys += [f"ec:{int(v)}" for v in params["volumeIds"]]
            for k in keys:
                existing = self._live_job(k)
                if existing:
                    return 409, {"error": f"conflicts with live job "
                                          f"{existing} ({k})",
                                 "jobId": existing, "deduped": True}
            rid, tparent = _trace_ctx()
            job = Job(job_id=uuid.uuid4().hex[:12], job_type=job_type,
                      params=params, dedupe_key=key,
                      request_id=rid, trace_parent=tparent)
            job.add_trace("submitted by operator")
            self.jobs[job.job_id] = job
            for k in keys:
                self._dedupe[k] = job.job_id
            self._persist_job(job)
        return 200, {"jobId": job.job_id}

    def _touch(self, worker_id: str) -> None:
        w = self.workers.get(worker_id)
        if w is not None:
            w.last_seen = time.monotonic()

    def _progress(self, req: Request):
        b = req.json()
        with self.lock:
            # a worker busy with a job cannot poll: its progress reports
            # are its liveness
            self._touch(b.get("workerId", ""))
            job = self.jobs.get(b["jobId"])
            if job is not None:
                job.progress = float(b.get("progress", 0.0))
                job.message = b.get("message", "")
                job.updated = time.time()
                job.add_trace(f"progress {job.progress:.2f}: "
                              f"{job.message[:200]}")
        return 200, {}

    def _complete(self, req: Request):
        b = req.json()
        # the worker has no listener of its own: its job spans come with
        # the report, and /debug/traces serves them from here
        if b.get("spans"):
            tracing.ingest(b["spans"])
        with self.lock:
            self._touch(b.get("workerId", ""))
            job = self.jobs.get(b["jobId"])
            if job is not None:
                reporter = b.get("workerId", "")
                if job.status != "assigned" or job.worker_id != reporter:
                    # only the owner of a live assignment completes it:
                    # a finished, requeued or reassigned job ignores
                    # the report
                    return 200, {"ignored": True}
                job.status = "done" if b.get("success") else "failed"
                job.message = b.get("message", "")
                job.progress = 1.0
                job.updated = time.time()
                job.add_trace(f"{job.status} by {reporter}: "
                              f"{job.message[:200]}")
                self._persist_job(job)
                w = self.workers.get(reporter)
                if w is not None:
                    w.inflight = max(0, w.inflight - 1)
        return 200, {}

    # -- operator API -----------------------------------------------------

    def _get_config(self, req: Request):
        """Each job type's schema (from worker descriptors) with its
        current values."""
        with self.lock:
            return 200, {"jobTypes": {
                jt: {"fields": fields,
                     "values": dict(self.config.get(jt, {}))}
                for jt, fields in sorted(self.schemas.items())}}

    def _set_config(self, req: Request):
        """A schema-checked update ({jobType, values}), delivered to
        workers with the next runDetection and persisted."""
        b = req.json()
        jt = b.get("jobType", "")
        values = b.get("values", {})
        with self.lock:
            fields = self.schemas.get(jt)
            if fields is None:
                return 404, {"error": f"no schema for job type {jt!r} "
                                      f"(no worker registered it)"}
            by_name = {f["name"]: f for f in fields}
            cleaned = {}
            for name, val in values.items():
                f = by_name.get(name)
                if f is None:
                    return 400, {"error": f"unknown field {name!r} for "
                                          f"{jt} (schema: "
                                          f"{sorted(by_name)})"}
                want = self._FIELD_TYPES.get(f.get("type", "string"), str)
                try:
                    if want is bool:
                        cleaned[name] = val if isinstance(val, bool) \
                            else str(val).lower() in ("1", "true", "yes")
                    else:
                        cleaned[name] = want(val)
                except (TypeError, ValueError):
                    return 400, {"error": f"field {name!r} wants "
                                          f"{f.get('type')}, got {val!r}"}
            self.config.setdefault(jt, {}).update(cleaned)
            self._write_json("config.json", self.config)
            return 200, {"jobType": jt, "values": dict(self.config[jt])}

    def _job_detail(self, req: Request):
        """The whole job record, its trace included."""
        jid = req.query.get("id", "")
        with self.lock:
            job = self.jobs.get(jid)
            if job is None:
                return 404, {"error": f"no job {jid!r}"}
            return 200, job.to_json()

    def _queue(self, req: Request):
        with self.lock:
            return 200, {"jobs": [{
                "jobId": j.job_id, "jobType": j.job_type,
                "status": j.status, "progress": j.progress,
                "message": j.message, "params": j.params,
            } for j in sorted(self.jobs.values(),
                              key=lambda j: j.created)]}

    def _detectors(self) -> "list[str]":
        """Ids of the workers that can detect; the caller holds the
        lock."""
        return [wid for wid, w in self.workers.items()
                if any(c.get("canDetect") for c in w.capabilities)]

    def _trigger(self, req: Request):
        with self.lock:
            self._pending_detection = self._detectors()
            asked = list(self._pending_detection)
        return 200, {"asked": asked}

    def _traces(self, req: Request):
        """The spans of one trace (`request_id`), or the newest
        (`limit`, default 200)."""
        rid = req.query.get("request_id", "")
        if rid:
            spans = tracing.spans_for(rid)
        else:
            spans = tracing.recent_spans(int(req.query.get("limit", 200)))
        return 200, {"requestId": rid, "spans": spans}

    # -- background: detection cadence and the reaper ----------------------

    def _detection_loop(self) -> None:
        tick = min(self.detection_interval, 5.0)
        next_detection = time.monotonic() + self.detection_interval
        while not self._stop.wait(tick):
            self._reap_dead_workers()
            if time.monotonic() >= next_detection:
                next_detection = time.monotonic() + self.detection_interval
                with self.lock:
                    self._pending_detection = self._detectors()

    def _reap_dead_workers(self) -> None:
        now = time.time()        # job.updated is persisted wall time
        mono = time.monotonic()  # worker liveness lives in memory
        with self.lock:
            dead = {wid for wid, w in self.workers.items()
                    if w.inflight > 0 and
                    mono - w.last_seen > self.WORKER_DEAD_AFTER}
            for job in self.jobs.values():
                if job.status != "assigned":
                    continue
                stalled = now - job.updated > self.JOB_STALL_AFTER
                if job.worker_id in dead or stalled:
                    w = self.workers.get(job.worker_id)
                    if w is not None and job.worker_id not in dead:
                        w.inflight = max(0, w.inflight - 1)
                    job.status = "pending"
                    job.worker_id = ""
                    job.updated = now
                    job.message = "requeued: worker lost or stalled"
                    job.add_trace(job.message)
                    self._persist_job(job)
            for wid in dead:
                self.workers[wid].inflight = 0
