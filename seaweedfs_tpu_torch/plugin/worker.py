"""The plugin worker runtime (the counterpart of
`seaweedfs_tpu/plugin/worker.py`; reference weed/plugin/worker/worker.go
and handler_registry.go): it hosts JobHandlers and speaks the worker
protocol with the admin over HTTP long-poll: register, poll, then run
detection or execute a job, and report back."""

from __future__ import annotations

import threading
import time
import traceback

from .. import tracing
from ..server.httpd import http_json


def must(r: dict, what: str) -> dict:
    """An RPC reply with an "error" key aborts the operation."""
    if isinstance(r, dict) and r.get("error"):
        raise RuntimeError(f"{what}: {r['error']}")
    return r


def _post_with_retry(url: str, payload: dict, attempts: int = 30) -> None:
    """Report-back POSTs outlive a short admin outage: about 5 minutes of
    capped backoff.  A report still lost is backstopped by the admin's
    requeue of a stalled job (`AdminServer.JOB_STALL_AFTER`)."""
    for i in range(attempts):
        try:
            http_json("POST", url, payload)
            return
        except OSError:
            time.sleep(min(2.0 ** i, 10.0))


def apply_config_values(handler: "JobHandler", values: dict) -> None:
    """Admin config values onto handler attributes: field names are
    camelCase on the wire, attributes snake_case.  Unknown names are
    ignored (the admin checked them against the handler's schema)."""
    for name, value in values.items():
        attr = PluginWorker._snake(name)
        if hasattr(handler, attr):
            setattr(handler, attr, value)


class JobHandler:
    """The handler contract (erasure_coding_handler.go:48 Capability,
    :61 Descriptor, :187 Detect, :445 Execute)."""

    job_type = "base"
    # other job type names this handler answers (a job of the type
    # "balance" runs on the volume balance handler)
    aliases: "list[str]" = []

    def capability(self) -> dict:
        return {"jobType": self.job_type, "canDetect": True,
                "canExecute": True, "weight": 50}

    def descriptor(self) -> dict:
        """Declarative config schema (plugin.proto descriptor forms)."""
        return {"jobType": self.job_type, "fields": []}

    def detect(self, worker: "PluginWorker") -> list[dict]:
        """Job proposals: [{jobType, params, dedupeKey}]."""
        return []

    def execute(self, worker: "PluginWorker", job_id: str,
                params: dict) -> str:
        raise NotImplementedError


class PluginWorker:
    """A maintenance worker process: registers its handlers with the
    admin, then long-polls it from one loop thread, one job at a
    time."""

    # a busy worker cannot poll, and the admin takes one silent for
    # AdminServer.WORKER_DEAD_AFTER (60 s) for lost: while a job runs,
    # its last progress report is sent again after this many seconds of
    # silence, so a long stage (a 30 GB pull, encode or push) never
    # looks like a dead worker
    KEEPALIVE = 15.0

    def __init__(self, admin: str, master: str, work_dir: str,
                 handlers: list[JobHandler], poll_wait: float = 5.0):
        self.admin = admin
        self.master = master
        self.work_dir = work_dir
        self._registered = list(handlers)
        self.handlers = {h.job_type: h for h in handlers}
        for h in handlers:
            for alias in h.aliases:
                self.handlers.setdefault(alias, h)
        self.poll_wait = poll_wait
        self.worker_id = ""
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the running job's last report (progress, message), and when
        # the admin last heard of it (monotonic)
        self._last_report = (0.0, "")
        self._last_post = 0.0

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "PluginWorker":
        r = must(http_json("POST", f"{self.admin}/worker/register", {
            "capabilities": [h.capability() for h in self._registered],
            "descriptors": [h.descriptor() for h in self._registered],
            "maxConcurrent": 1,
        }), f"register with {self.admin}")
        self.worker_id = r["workerId"]
        self._thread = threading.Thread(target=self._loop,
                                        name="plugin-worker", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop polling (the loop thread is joined for at most 5 s)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- protocol loop ----------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                msg = http_json("POST", f"{self.admin}/worker/poll", {
                    "workerId": self.worker_id,
                    "waitSeconds": self.poll_wait,
                }, timeout=self.poll_wait + 10)
            except OSError:
                if self._stop.wait(1.0):
                    return
                continue
            if msg.get("error"):
                # the admin restarted and lost its registry: register
                # again, with a pause rather than a hot spin
                if self._stop.wait(1.0):
                    return
                try:
                    r = http_json(
                        "POST", f"{self.admin}/worker/register", {
                            "workerId": self.worker_id,
                            "capabilities": [h.capability() for h in
                                             self._registered],
                            "maxConcurrent": 1})
                    self.worker_id = r.get("workerId", self.worker_id)
                except OSError:
                    pass
                continue
            mtype = msg.get("type")
            if mtype == "runDetection":
                self._apply_config(msg.get("config") or {})
                self._run_detection()
            elif mtype == "executeJob":
                self._execute(msg["jobId"], msg["jobType"],
                              msg.get("params", {}),
                              request_id=msg.get("requestId", ""),
                              trace_parent=msg.get("traceParent", ""))

    @staticmethod
    def _snake(name: str) -> str:
        return "".join("_" + c.lower() if c.isupper() else c
                       for c in name)

    def _apply_config(self, config: dict) -> None:
        for job_type, values in config.items():
            h = self.handlers.get(job_type)
            if h is not None:
                apply_config_values(h, values)

    def _run_detection(self) -> None:
        proposals = []
        for h in self._registered:
            try:
                proposals.extend(h.detect(self))
            except Exception:  # noqa: BLE001 — detection must not end
                # the loop; the traceback is the report
                traceback.print_exc()
        if proposals:
            _post_with_retry(f"{self.admin}/worker/detection_result",
                             {"workerId": self.worker_id,
                              "proposals": proposals})

    def _execute(self, job_id: str, job_type: str, params: dict,
                 request_id: str = "", trace_parent: str = "") -> None:
        """Run one job inside a `job:<type>` span that joins the
        submitter's trace (the context rides the job message; a job
        born of detection without one is traced as `job-<id>`), and
        report its end with its spans.  The request id and span context
        are restored afterwards: this loop thread lives on."""
        rid = request_id or f"job-{job_id}"
        token = tracing.set_request_id(rid)
        tracing.adopt_remote_parent(trace_parent, role="worker")
        h = self.handlers.get(job_type)
        self._last_report = (0.0, "started")
        self._last_post = time.monotonic()
        done = threading.Event()
        beat = threading.Thread(target=self._keepalive,
                                args=(job_id, done), daemon=True)
        beat.start()
        try:
            with tracing.span(f"job:{job_type}", role="worker") as sp:
                sp.set("jobId", job_id)
                try:
                    if h is None:
                        raise ValueError(f"no handler for {job_type!r}")
                    message = h.execute(self, job_id, params)
                    success = True
                except Exception as e:  # noqa: BLE001 — a failed job
                    # is reported, and the worker polls on
                    traceback.print_exc()
                    message, success = f"{type(e).__name__}: {e}", False
                    sp.set_error(e)
            done.set()
            beat.join()
            # the worker has no listener of its own, so its spans ride
            # the completion report into the admin's ring buffer
            _post_with_retry(f"{self.admin}/worker/complete", {
                "workerId": self.worker_id, "jobId": job_id,
                "success": success, "message": message,
                "spans": tracing.spans_for(rid)})
        finally:
            done.set()
            tracing.reset_request_id(token)
            tracing.adopt_remote_parent("")

    def _keepalive(self, job_id: str, done: threading.Event) -> None:
        """Repeat the running job's last report once it is KEEPALIVE
        seconds old (the admin's trace shows it as "still running")."""
        while not done.wait(self.KEEPALIVE / 4):
            if time.monotonic() - self._last_post >= self.KEEPALIVE:
                progress, message = self._last_report
                self._post_progress(job_id, progress,
                                    f"{message} (still running)")

    def report_progress(self, job_id: str, progress: float,
                        message: str = "") -> None:
        self._last_report = (progress, message)
        self._post_progress(job_id, progress, message)

    def _post_progress(self, job_id: str, progress: float,
                       message: str) -> None:
        self._last_post = time.monotonic()
        try:
            http_json("POST", f"{self.admin}/worker/progress", {
                "workerId": self.worker_id, "jobId": job_id,
                "progress": progress, "message": message})
        except OSError:
            pass
