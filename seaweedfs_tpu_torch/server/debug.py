"""The debug routes every role serves (the port's copy of
`seaweedfs_tpu/server/debug.py`, itself the analog of the reference's
pprof endpoint).  Every `/debug/` path is an admin path: the owner's
`admin_guard` gates it under `[admin] key`.

  GET /debug/stacks            every thread's current stack (text)
  GET /debug/vars              threads, gc counts, objects, RSS
  GET /debug/profile?seconds=N a one-off sampling profile (text, N <= 30)
  GET /debug/traces?request_id=R  the spans of one trace in this
      process's ring, or the newest (?limit=N, default 200)
  GET /debug/health            the per-peer breakers (util/retry)
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

`/debug/faults` and `/debug/qos` are not ported: the fault sites and
QoS are not (they answer 404).
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
    # the port has no retry budget (only the breakers): null
    return 200, {"peers": retry.health_snapshot(),
                 "retryBudgetRemaining": None}


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
