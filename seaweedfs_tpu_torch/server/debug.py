"""The debug routes every role serves (the port's copy of
`seaweedfs_tpu/server/debug.py`, itself the analog of the reference's
pprof endpoint).  Every `/debug/` path is an admin path: the owner's
`admin_guard` gates it under `[admin] key`.

  GET /debug/stacks            every thread's current stack (text)
  GET /debug/vars              threads, gc counts, objects, RSS
  GET /debug/profile?seconds=N a one-off sampling profile (text, N <= 30)
  GET /debug/traces?request_id=R  the spans of one trace in this
      process's ring, or the newest (?limit=N, default 200)
  GET /debug/health            the per-peer breakers and the retry
      budget left (util/retry)
  GET/POST /debug/pprof        the sampling profiler (profiling.Sampler):
      POST {"action": "start", "hz": N} arms it, {"action": "stop"}
      disarms it and answers the final snapshot, {"action": "reset"}
      clears it; GET answers the snapshot (?top=N, or ?format=collapsed
      for flamegraph.pl text).  `cluster.profile` drives it on every
      node and merges the folded stacks.
  GET/POST /debug/slow         the flight recorder's ring
      (profiling.FlightRecorder), after a drain of the native planes'
      rings; POST {"clear": true} empties it.  `cluster.slow` merges
      the rings by trace id.
  GET/POST /debug/attribution  the runtime switch of the stage tracks,
      CPU sampling and recorder ({"disarmed": bool, "scope":
      "all"|"plane"|"drain"}).

  GET/POST /debug/faults       the failpoint plane (faults.py): GET lists
      the arms and the trigger counts; POST {"spec": "site=action,..."},
      {"site": ..., "action": ..., "p"/"n"/"ms"/"seed"/"match"} arms,
      {"clear": true} (or a site name) disarms.  A malformed spec
      answers 400.
  GET/POST /debug/qos          the QoS plane (qos.py): GET the admission
      config, the in-flight bytes and the throttle; POST sets a tenant's
      limits ({"tenant", "rps", "burst", "inflightMb"}; "default" or "*"
      for the default; {"remove": name}), {"enabled": bool}, the
      throttle's {"sloP99Ms", "paceMinMs", "paceMaxMs",
      "checkIntervalMs"}, a forced {"paceMs"}, or {"clear": true}, and
      answers what GET does.

Arms, the budget and the QoS controller are per process: a lever moves
the process that serves it.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
import traceback
from collections import Counter

from .. import profiling, tracing
from .httpd import HttpServer, Request


def install_debug_routes(http: HttpServer) -> None:
    http.route("GET", "/debug/stacks", _stacks)
    http.route("GET", "/debug/vars", _vars)
    http.route("GET", "/debug/profile", _profile)
    http.route("GET", "/debug/traces", _traces)
    http.route("GET", "/debug/health", _health)
    http.route("GET", "/debug/pprof", _pprof_get)
    http.route("POST", "/debug/pprof", _pprof_post)
    http.route("GET", "/debug/slow", _slow_get)
    http.route("POST", "/debug/slow", _slow_post)
    http.route("GET", "/debug/attribution", _attr_get)
    http.route("POST", "/debug/attribution", _attr_post)
    http.route("GET", "/debug/faults", _faults_get)
    http.route("POST", "/debug/faults", _faults_post)
    http.route("GET", "/debug/qos", _qos_get)
    http.route("POST", "/debug/qos", _qos_post)


def start_process_probes() -> None:
    """The sampler's boot arming (`SEAWEEDFS_TPU_PROFILE_HZ`) and the
    scheduler probe (`gil_wait_ratio`), once a process.  The volume
    server and the filer call it at start, where the JAX package's
    autopilot routes do (both roles run a loop by default there)."""
    profiling.maybe_autostart()
    profiling.maybe_start_sched_probe()


def _pprof_get(req: Request):
    s = profiling.sampler()
    if req.query.get("format") == "collapsed":
        return 200, (s.collapsed().encode(), "text/plain")
    try:
        top = int(req.query.get("top", 0))
    except ValueError:
        top = 0
    return 200, s.snapshot(top=top)


def _pprof_post(req: Request):
    s = profiling.sampler()
    b = req.json()
    action = str(b.get("action", ""))
    if action == "start":
        hz = b.get("hz")
        try:
            hz = float(hz) if hz is not None else None
        except (TypeError, ValueError):
            return 400, {"error": f"bad hz {b.get('hz')!r}"}
        started = s.start(hz)
        return 200, {"running": s.running, "hz": s.hz,
                     "started": started}
    if action == "stop":
        s.stop()
        return 200, s.snapshot()
    if action == "reset":
        s.reset()
        return 200, s.snapshot()
    return 400, {"error": "body needs action: start|stop|reset"}


def _slow_get(req: Request):
    # drain the native planes' rings first, so a scrape sees the plane
    # requests finished since the drainers' last tick
    profiling.run_scrape_hooks()
    return 200, profiling.flight_recorder().snapshot()


def _slow_post(req: Request):
    if req.json().get("clear"):
        profiling.flight_recorder().reset()
        return 200, profiling.flight_recorder().snapshot()
    return 400, {"error": "body needs clear: true"}


def _attr_state() -> dict:
    scope = profiling.attribution_disarmed()
    return {"disarmed": scope is not None, "scope": scope or "",
            "drainEnabled": profiling.plane_drain_enabled()}


def _attr_get(req: Request):
    return 200, _attr_state()


def _attr_post(req: Request):
    """{"disarmed": bool, "scope": "all"|"plane"|"drain"}: "all" (the
    default) disarms the stage tracks, the CPU clocks and the recorder;
    "plane" only the CPU clocks and the recorder; "drain" only the
    native planes' record drain."""
    b = req.json()
    if "disarmed" not in b:
        return 400, {"error": "body needs disarmed: true|false"}
    scope = str(b.get("scope", "all"))
    if scope == "drain":
        profiling.set_plane_drain_disarmed(bool(b["disarmed"]))
    else:
        profiling.set_attribution_disarmed(bool(b["disarmed"]),
                                           scope=scope)
    return 200, _attr_state()


def _health(req: Request):
    from ..util import retry
    return 200, {"peers": retry.health_snapshot(),
                 "retryBudgetRemaining": retry.budget_remaining()}


def _faults_get(req: Request):
    from .. import faults
    return 200, {"armed": faults.armed(), "triggered": faults.triggered()}


def _faults_post(req: Request):
    from .. import faults
    b = req.json()
    clear = b.get("clear")
    if clear:
        faults.disarm(None if clear is True else str(clear))
        return 200, {"armed": faults.armed()}
    try:
        if "spec" in b:
            n = faults.arm_spec(str(b["spec"]))
        elif "site" in b:
            faults.arm(
                str(b["site"]), str(b.get("action", "error")),
                p=float(b.get("p", 1.0)),
                n=None if b.get("n") is None else int(b["n"]),
                ms=float(b.get("ms", 0.0)),
                seed=None if b.get("seed") is None else int(b["seed"]),
                match=str(b.get("match", "")))
            n = 1
        else:
            return 400, {"error": "body needs spec/site/clear"}
    except ValueError as e:
        return 400, {"error": str(e)}
    return 200, {"armedCount": n, "armed": faults.armed()}


def _qos_get(req: Request):
    from .. import qos
    snap = qos.controller().snapshot()
    snap["throttle"] = qos.throttle().snapshot()
    return 200, snap


def _qos_post(req: Request):
    from .. import qos
    b = req.json()
    ctl = qos.controller()
    try:
        if b.get("clear"):
            qos.configure(None)
            # a forced pace has no watcher to decay it once the config
            # is inert
            qos.throttle().set_pace(0.0)
        if "enabled" in b:
            ctl.set_enabled(bool(b["enabled"]))
        if b.get("remove"):
            ctl.set_tenant(str(b["remove"]), None)
        if b.get("tenant"):
            ctl.set_tenant(str(b["tenant"]), qos.TenantLimit.from_json(b))
        cfg = ctl.config()
        for key, attr in (("sloP99Ms", "slo_p99_ms"),
                          ("paceMinMs", "pace_min_ms"),
                          ("paceMaxMs", "pace_max_ms"),
                          ("checkIntervalMs", "check_interval_ms")):
            if key in b:
                setattr(cfg, attr, float(b[key]))
        if "sloP99Ms" in b:
            if cfg.slo_p99_ms <= 0:
                qos.throttle().set_pace(0.0)
            qos.throttle().maybe_start()
        if "paceMs" in b:
            qos.throttle().set_pace(float(b["paceMs"]) / 1e3)
    except (TypeError, ValueError) as e:
        return 400, {"error": str(e)}
    return _qos_get(req)


def _traces(req: Request):
    rid = req.query.get("request_id", "")
    if rid:
        spans = tracing.spans_for(rid)
    else:
        spans = tracing.recent_spans(int(req.query.get("limit", 200)))
    return 200, {"requestId": rid, "spans": spans}


def _stacks(req: Request):
    out = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
        out.extend(line.rstrip() for line in
                   traceback.format_stack(frame))
    return 200, ("\n".join(out).encode(), "text/plain")


def _vars(req: Request):
    rss_kb = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss_kb = int(line.split()[1])
    except OSError:
        pass
    return 200, {
        "threads": threading.active_count(),
        "gcCounts": list(gc.get_count()),
        "gcObjects": len(gc.get_objects()),
        "rssKb": rss_kb,
        "uptimeHint": time.process_time(),
    }


def _profile(req: Request):
    seconds = min(float(req.query.get("seconds", 2)), 30.0)
    interval = 0.01
    samples: Counter = Counter()
    end = time.monotonic() + seconds
    me = threading.get_ident()
    n = 0
    while time.monotonic() < end:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stack = []
            f = frame
            while f is not None and len(stack) < 24:
                stack.append(f"{f.f_code.co_filename.rsplit('/', 1)[-1]}"
                             f":{f.f_lineno}:{f.f_code.co_name}")
                f = f.f_back
            samples[";".join(reversed(stack))] += 1
        n += 1
        time.sleep(interval)
    lines = [f"samples: {n} over {seconds}s @ {interval * 1000:.0f}ms"]
    for stack, count in samples.most_common(50):
        lines.append(f"{count:6d}  {stack}")
    return 200, ("\n".join(lines).encode(), "text/plain")
