"""The observability plane of every role (the counterpart of
`seaweedfs_tpu/profiling.py`): where a request's microseconds go.

1. `Sampler`: an in-process sampling wall-clock profiler.  A daemon
   thread snapshots `sys._current_frames()` and folds each thread's
   stack into collapsed-stack lines (`frame;frame;frame count`, the
   flamegraph.pl input).  Off by default; armed with `POST /debug/pprof`
   (server/debug.py) or at boot with `SEAWEEDFS_TPU_PROFILE_HZ`.  Its
   cost is bounded: a pass that took long buys proportionally more
   sleep, so sampling never spends more than `MAX_OVERHEAD` of a core.
2. `StageTrack`, `track`, `stage`, `use_track`: a request's stage
   decomposition.  A role opens a track around its hot handler
   (`with profiling.track("write", role=..., metrics=...)`); code down
   the call chain times its stages with `with profiling.stage("append")`
   (a contextvar carries the track, so no signature changes).  On
   finish the track observes `<name>_stage_seconds{stage}` (and
   `stage="total"`) into the role's registry, with the thread CPU of
   each stage in `<name>_stage_cpu_seconds` when the request drew the
   CPU sample, and emits one trace span a stage.  Work handed to a pool
   thread re-binds the track with `use_track`.
3. The flight recorder (`FlightRecorder`): a bounded ring of complete
   records of the requests worth keeping (slower than the self-tracked
   p95, errored, deadline-exceeded), each with its span tree, stages,
   deadline and flight notes (`flight_note`).  `GET /debug/slow` serves
   it; the shell's `cluster.slow` merges the rings by trace id.
4. The native planes' record drain (`PlaneRecordSink`,
   `PlaneRecordDrainer`): the C++ planes record every request in a
   ring; a drainer thread a plane pulls it on a tick and at each
   `/debug/slow` scrape into the stage histograms, the latency trackers
   and the recorder.
5. `SchedProbe`: a daemon thread timing short sleeps against their
   deadline, exported as `gil_wait_ratio`.
6. Device telemetry (`device_note`, `overlap_note`, `kernel_note`,
   `sample_device_memory`) into `stats.PROCESS`.
7. Prometheus-text helpers (`parse_prom_text`, `prom_histogram`,
   `histogram_delta`, `histogram_quantile`) and `merge_folded`, the
   client half that `cluster.top` and `cluster.profile` read with.

Knobs (the JAX module's, with its defaults):
  SEAWEEDFS_TPU_PROFILE_HZ       sampling rate; 0 (default) = off
  SEAWEEDFS_TPU_PROFILE_STACKS   distinct folded stacks kept (2048)
  SEAWEEDFS_TPU_STAGE_TIMERS     "0" disables stage tracks entirely
  SEAWEEDFS_TPU_CPU_SAMPLE       every Nth budget-less request pays
                                 the thread-CPU clock (16); deadline-
                                 carrying requests always do; 0 never
  SEAWEEDFS_TPU_FLIGHT_RECORDER  "0" disables the flight recorder
  SEAWEEDFS_TPU_SLOW_RING        records kept per process (64)
  SEAWEEDFS_TPU_SLOW_MIN_MS      slow-capture threshold floor (25)
  SEAWEEDFS_TPU_SLOW_CAPTURE_PER_S  threshold-capture rate cap (20)
  SEAWEEDFS_TPU_PLANE_DRAIN      "0" disables the plane-record drain
  SEAWEEDFS_TPU_PLANE_DRAIN_MS   drainer tick (200)
  SEAWEEDFS_TPU_SCHED_PROBE      "0" disables the scheduler probe
  SEAWEEDFS_TPU_SCHED_PROBE_MS   probe sleep window (50)

Nothing here touches the device but `sample_device_memory`; the module
imports no CUDA state at import time.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import sys
import threading
import time

from . import stats

# finer than stats.DEFAULT_BUCKETS: needle appends and index updates
# live in the 50us-5ms range the request-latency buckets can't resolve
STAGE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)

# the sampler refuses to spend more than this fraction of one core on
# itself: when a pass over every thread costs more than
# MAX_OVERHEAD * interval, the next sleep stretches to compensate
MAX_OVERHEAD = 0.10


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def default_hz() -> float:
    """SEAWEEDFS_TPU_PROFILE_HZ: sampling rate when the profiler is
    armed without an explicit rate; 0 (the default) keeps it off."""
    return max(0.0, _env_float("SEAWEEDFS_TPU_PROFILE_HZ", 0.0))


def max_stacks() -> int:
    """SEAWEEDFS_TPU_PROFILE_STACKS: bound on distinct folded stacks
    kept per process (overflow is counted, not stored)."""
    return max(64, _env_int("SEAWEEDFS_TPU_PROFILE_STACKS", 2048))


# runtime disarm lever (POST /debug/attribution): force-disarm in
# THIS process until restored — a live kill switch that needs no
# restart, and a within-cluster A/B toggle (separate clusters can't
# resolve a ~1% cost under arm-to-arm boot noise).  Scope "all" = the
# whole plane including the wall-stage decomposition; scope "plane" =
# only the CPU clocks and the flight recorder.
_attr_disarmed: "str | None" = None


def set_attribution_disarmed(disarmed: bool,
                             scope: str = "all") -> None:
    global _attr_disarmed
    _attr_disarmed = (scope if scope in ("all", "plane") else "all") \
        if disarmed else None


def attribution_disarmed() -> "str | None":
    return _attr_disarmed


def stage_timers_enabled() -> bool:
    """SEAWEEDFS_TPU_STAGE_TIMERS=0 turns the write-path stage
    decomposition off (the track() call becomes a no-op)."""
    if _attr_disarmed == "all":
        return False
    return os.environ.get("SEAWEEDFS_TPU_STAGE_TIMERS", "1") != "0"


# -- sampling profiler ----------------------------------------------------

class Sampler:
    """Thread-based statistical wall-clock profiler.

    Signal-based sampling (ITIMER_PROF) only interrupts the main
    thread; every role server does its real work on handler/pipeline
    threads, so a dedicated sampler thread walking
    `sys._current_frames()` is the only design that sees the hot
    paths.  Each pass folds every thread's stack root-first into
    `file.py:func;file.py:func;...` and counts it — the collapsed
    stack format any flamegraph renderer takes as-is."""

    MAX_DEPTH = 48

    def __init__(self):
        self._lock = threading.Lock()
        self._folded: dict[str, int] = {}
        self._label_cache: dict[object, str] = {}
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()
        self.hz = 0.0
        self.samples = 0            # sampling passes completed
        self.stacks = 0             # thread stacks recorded
        self.dropped = 0            # stacks lost to the table cap
        self.self_seconds = 0.0     # time spent inside sampling passes
        self.started_wall = 0.0
        self._started_mono = 0.0
        self._stopped_elapsed = 0.0

    # -- control ---------------------------------------------------------

    def start(self, hz: "float | None" = None) -> bool:
        """Arm the sampler at `hz` (default: the env knob, else 100).
        Returns False when already running (the running profile is
        left untouched — two operators arming cluster-wide must not
        reset each other's windows)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            rate = hz if hz and hz > 0 else (default_hz() or 100.0)
            self.hz = min(float(rate), 1000.0)
            self._folded.clear()
            self.samples = self.stacks = self.dropped = 0
            self.self_seconds = 0.0
            self.started_wall = time.time()
            self._started_mono = time.monotonic()
            self._stopped_elapsed = 0.0
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="weed-profiler", daemon=True)
            self._thread.start()
            return True

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            if t is None:
                return
            self._stop.set()
        t.join(timeout=5.0)
        with self._lock:
            if self._thread is t:
                self._stopped_elapsed = \
                    time.monotonic() - self._started_mono
                self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def reset(self) -> None:
        # _label_cache deliberately not cleared here: it is written
        # lock-free by the sampler thread (its only writer — start()
        # joins the old thread before spawning a new one) and bounded
        # by MAX_LABELS in _frame_label, so touching it from a
        # handler thread would be the race, not the hygiene
        with self._lock:
            self._folded.clear()
            self.samples = self.stacks = self.dropped = 0
            self.self_seconds = 0.0

    # -- sampling loop ---------------------------------------------------

    # code objects are cache keys (strong refs): bound the cache so a
    # long-armed process that mints code dynamically cannot
    # pin an unbounded set of them
    MAX_LABELS = 32768

    def _frame_label(self, code) -> str:
        label = self._label_cache.get(code)
        if label is None:
            if len(self._label_cache) >= self.MAX_LABELS:
                self._label_cache.clear()
            label = (f"{code.co_filename.rsplit('/', 1)[-1]}"
                     f":{code.co_name}")
            self._label_cache[code] = label
        return label

    def _run(self) -> None:
        me = threading.get_ident()
        interval = 1.0 / self.hz
        cap = max_stacks()
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                frames = sys._current_frames()
            except RuntimeError:   # pragma: no cover — interp teardown
                break
            new_folded = []
            for tid, frame in frames.items():
                if tid == me:
                    continue
                parts = []
                f = frame
                while f is not None and len(parts) < self.MAX_DEPTH:
                    parts.append(self._frame_label(f.f_code))
                    f = f.f_back
                new_folded.append(";".join(reversed(parts)))
            with self._lock:
                for stack in new_folded:
                    n = self._folded.get(stack)
                    if n is not None:
                        self._folded[stack] = n + 1
                        self.stacks += 1
                    elif len(self._folded) < cap:
                        self._folded[stack] = 1
                        self.stacks += 1
                    else:
                        self.dropped += 1
                self.samples += 1
                cost = time.perf_counter() - t0
                self.self_seconds += cost
            # overhead bound: never let sampling cost exceed
            # MAX_OVERHEAD of one core — a pass that took longer than
            # its budget buys proportionally more sleep
            self._stop.wait(max(interval, cost / MAX_OVERHEAD))

    # -- output ----------------------------------------------------------

    def snapshot(self, top: int = 0) -> dict:
        """JSON-able state + folded table (all stacks, or the `top` N
        by count)."""
        with self._lock:
            elapsed = (time.monotonic() - self._started_mono) \
                if self.running else self._stopped_elapsed
            folded = dict(self._folded)
            doc = {
                "running": self.running,
                "hz": self.hz,
                "samples": self.samples,
                "stacks": self.stacks,
                "droppedStacks": self.dropped,
                "startedAt": self.started_wall,
                "elapsedSeconds": round(elapsed, 3),
                "selfSeconds": round(self.self_seconds, 4),
                "overhead": round(self.self_seconds / elapsed, 4)
                if elapsed > 0 else 0.0,
            }
        if top and top > 0:
            folded = dict(sorted(folded.items(),
                                 key=lambda kv: -kv[1])[:top])
        doc["folded"] = folded
        return doc

    def collapsed(self) -> str:
        """`stack count` lines, most-sampled first — pipe straight
        into flamegraph.pl."""
        with self._lock:
            items = sorted(self._folded.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{stack} {n}" for stack, n in items) + \
            ("\n" if items else "")


_sampler = Sampler()
_autostart_done = False


def sampler() -> Sampler:
    return _sampler


def maybe_autostart() -> None:
    """Boot-time arming: when SEAWEEDFS_TPU_PROFILE_HZ is set > 0 the
    process profiles from startup (once per process — every role's
    install_debug_routes calls this)."""
    global _autostart_done
    if _autostart_done:
        return
    _autostart_done = True
    if default_hz() > 0:
        _sampler.start(default_hz())


def merge_folded(tables: "list[dict]") -> "dict[str, int]":
    """Sum folded-stack tables (cluster.profile merges every node's
    snapshot into one cluster-wide flame view)."""
    out: dict[str, int] = {}
    for t in tables:
        for stack, n in (t or {}).items():
            try:
                out[stack] = out.get(stack, 0) + int(n)
            except (TypeError, ValueError):
                continue
    return out



# -- write-path stage decomposition ---------------------------------------

_track_var: contextvars.ContextVar["StageTrack | None"] = \
    contextvars.ContextVar("weed_stage_track", default=None)

# the finished track's summary, left for the server front's flight
# recorder (finish() runs inside the handler, the capture in the
# front's finally — same thread, so a plain contextvar bridges them)
_last_summary_var: contextvars.ContextVar["dict | None"] = \
    contextvars.ContextVar("weed_last_track_summary", default=None)

# per-request flight notes for requests that carry no stage track
# (reads): armed by the fronts at ingress, read back at capture
_notes_var: contextvars.ContextVar["dict | None"] = \
    contextvars.ContextVar("weed_flight_notes", default=None)


def cpu_sample_every() -> int:
    """SEAWEEDFS_TPU_CPU_SAMPLE: every Nth budget-less request pays
    the thread-CPU clock (default 16); deadline-carrying requests are
    ALWAYS attributed.  On sandboxed kernels CLOCK_THREAD_CPUTIME_ID
    is a trapped syscall (~5us/call measured here, not vDSO), and a
    stage-tracked write makes ~12 of them — unsampled, that alone is
    ~8% of a GIL-saturated role.  Sampling keeps every histogram
    MEAN exact (cpu/req, per-stage cpu) while the requests the
    deadline/hedge planes act on — and the flight recorder explains —
    keep their exact per-request split.  0 disables attribution
    entirely."""
    if _attr_disarmed:
        return 0
    return _env_int("SEAWEEDFS_TPU_CPU_SAMPLE", 16)


# SEPARATE counters for the two draw sites: a request advances the
# front counter once and (when tracked) the track counter once — one
# shared counter would advance by 2 per request and `(2r+1) % k` can
# never hit 0 for even k, i.e. tracks would NEVER draw the sample
_front_tick = itertools.count()
_track_tick = itertools.count()


def cpu_attr_tick() -> bool:
    """The budget-less sampling decision alone (callers that already
    know the deadline state, i.e. the server fronts)."""
    k = cpu_sample_every()
    if k <= 0:
        return False
    return next(_front_tick) % k == 0


def cpu_attr_front(deadline_armed: bool) -> bool:
    """The server fronts' sampling decision.  The k<=0 kill switch
    (SEAWEEDFS_TPU_CPU_SAMPLE=0 / the /debug/attribution disarm
    lever) gates EVERYTHING, deadline-carrying requests included — a
    deadline-default cluster must not pay the trapped clock syscall
    per request under a knob documented as '0 = never'."""
    k = cpu_sample_every()
    if k <= 0:
        return False
    if deadline_armed:
        return True
    return next(_front_tick) % k == 0


def cpu_attr_now() -> bool:
    """Should THIS request pay the thread-CPU clock?  Deadline-
    carrying requests always do; budget-less ones every Nth."""
    k = cpu_sample_every()
    if k <= 0:
        return False
    from .util import deadline as _dl
    if _dl.get() is not None:
        return True
    return next(_track_tick) % k == 0


def take_last_summary() -> "dict | None":
    """The most recent StageTrack summary finished on this context,
    cleared on read (reused handler threads must not attribute the
    previous request's decomposition to this one)."""
    s = _last_summary_var.get()
    if s is not None:
        _last_summary_var.set(None)
    return s


def arm_flight_notes() -> None:
    """Front-ingress arming: give this request a notes dict so
    flight_note() calls down the handler chain have somewhere to land
    even without a stage track."""
    _notes_var.set({})


def take_flight_notes() -> "dict | None":
    d = _notes_var.get()
    if d is not None:
        _notes_var.set(None)
    return d or None


def flight_note(key: str, value) -> None:
    """Attach one fact about the CURRENT request for the flight
    recorder (hedge issued/won, native-plane handoff, QoS verdict,
    degraded EC read...).  Prefers the active stage track (which
    follows use_track() onto pool threads); falls back to the
    front-armed notes dict; a no-op — two contextvar reads — when
    neither is armed (un-instrumented callers, background threads)."""
    trk = _track_var.get()
    if trk is not None:
        trk.note(key, value)
        return
    d = _notes_var.get()
    if d is not None:
        d[key] = value


class StageTrack:
    """Per-request stage accumulator.  Thread-safe: the filer funnel
    records assign/upload stages from limiter pool threads into the
    handler thread's track (see use_track).

    Each stage carries wall AND thread-CPU seconds (_StageCtx samples
    `time.thread_time()` at both boundaries, on whichever thread the
    stage actually ran): `finish()` emits `<name>_stage_cpu_seconds`
    beside the wall histograms, so `wall − cpu` per stage exposes the
    GIL/lock/syscall wait directly.  The track total's CPU is the
    OWNER thread's thread-time delta plus the CPU the stages burned on
    foreign (pool) threads — the request's whole CPU bill, not just
    the instrumented windows."""

    __slots__ = ("name", "role", "metrics", "stages", "notes", "_lock",
                 "_t0", "_owner", "_cpu0", "_cpu_on", "trace_ctx")

    def __init__(self, name: str, role: str = "", metrics=None):
        self.name = name
        self.role = role
        self.metrics = metrics
        # stage -> [wall seconds, calls, first-call wall time,
        #           cpu seconds, foreign-thread cpu seconds]
        self.stages: dict[str, list] = {}
        self.notes: "dict | None" = None
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._owner = threading.get_ident()
        # sampled CPU attribution (cpu_attr_now): the thread-CPU
        # clock is a trapped syscall on sandboxed kernels, so only
        # deadline-carrying and every-Nth budget-less tracks pay it;
        # wall is always measured
        self._cpu_on = cpu_attr_now()
        self._cpu0 = time.thread_time() if self._cpu_on else 0.0
        from . import tracing
        self.trace_ctx = tracing.current_ids()

    def add(self, stage: str, seconds: float,
            cpu_seconds: float = 0.0) -> None:
        foreign = threading.get_ident() != self._owner
        with self._lock:
            rec = self.stages.get(stage)
            if rec is None:
                # span-start RECORD, deliberately wall (trace spans
                # carry wall starts); the duration itself came off
                # perf_counter in _StageCtx
                self.stages[stage] = [
                    seconds, 1, time.time() - seconds,
                    cpu_seconds, cpu_seconds if foreign else 0.0]
            else:
                rec[0] += seconds
                rec[1] += 1
                rec[3] += cpu_seconds
                if foreign:
                    rec[4] += cpu_seconds

    def note(self, key: str, value) -> None:
        """Attach one flight-recorder note to this request (hedge
        verdicts, native-plane handoffs, QoS outcomes — see
        flight_note)."""
        with self._lock:
            if self.notes is None:
                self.notes = {}
            self.notes[key] = value

    def finish(self) -> float:
        """Observe one histogram cell per stage (plus stage="total")
        for wall AND cpu, emit sibling stage spans under the span that
        was active at track start, and stash the finished summary for
        the front's flight recorder (take_last_summary).  Returns the
        track's total seconds."""
        total = time.perf_counter() - self._t0
        # the owner thread's CPU covers everything it ran between
        # track start and finish (instrumented or not); stages that
        # ran on OTHER threads contribute their own thread-time on top
        cpu_on = self._cpu_on
        own_cpu = (time.thread_time() - self._cpu0) \
            if cpu_on and threading.get_ident() == self._owner else 0.0
        with self._lock:
            stages = {k: list(v) for k, v in self.stages.items()}
            notes = dict(self.notes) if self.notes else None
        total_cpu = own_cpu + sum(rec[4] for rec in stages.values())
        hist = f"{self.name}_stage_seconds"
        cpu_hist = f"{self.name}_stage_cpu_seconds"
        if self.metrics is not None:
            # pre-resolved observers (stats.Metrics.observer), memoized on the registry: StageTracks are
            # per-request, so the memo must outlive them; track names
            # are code-site constants ("write"), never request-
            # derived, so cardinality stays bounded by the set of
            # track() call sites x their stage names
            memo = self.metrics.obs_memo
            for stage, rec in list(stages.items()) + [("total", None)]:
                if rec is None:
                    secs, cpu = total, total_cpu
                else:
                    secs, cpu = rec[0], rec[3]
                obs = memo.get((hist, stage))
                if obs is None:
                    obs = memo[(hist, stage)] = self.metrics.observer(
                        hist, buckets=STAGE_BUCKETS,
                        help_text=f"per-request {self.name}-path "
                                  f"stage decomposition", stage=stage)
                obs(secs)
                if cpu_on:
                    cobs = memo.get((cpu_hist, stage))
                    if cobs is None:
                        cobs = memo[(cpu_hist, stage)] = \
                            self.metrics.observer(
                                cpu_hist, buckets=STAGE_BUCKETS,
                                help_text=f"per-request {self.name}-"
                                          f"path stage CPU (thread_"
                                          f"time, sampled — see SEA"
                                          f"WEEDFS_TPU_CPU_SAMPLE); "
                                          f"wall minus this is GIL/"
                                          f"lock/syscall wait",
                                stage=stage)
                    cobs(cpu)
        if self.trace_ctx and stages:
            from . import tracing
            role = self.role or self.trace_ctx[2]
            specs = []
            for stage, rec in stages.items():
                secs, calls, wall0, cpu = rec[0], rec[1], rec[2], rec[3]
                attrs = {"cpuMs": round(cpu * 1e3, 3)} if cpu_on \
                    else {}
                if calls > 1:
                    attrs["calls"] = calls
                specs.append({
                    "name": f"{self.name}.{stage}",
                    "start": wall0, "duration": secs, "role": role,
                    "parent": self.trace_ctx[1],
                    "trace_id": self.trace_ctx[0], "attrs": attrs})
            # one batch: the tracer's knob env-reads are per CALL,
            # not per span (they were 3 env lookups x N stages here)
            tracing.emit_span_batch(specs)
        # leave the finished decomposition where the server front can
        # pick it up for a flight-recorder capture (same thread for
        # both fronts: threaded dispatch / the asyncio pool worker).
        # An unsampled track reports wall only — cpuMs keys are
        # ABSENT, never zero, so a render can't mistake "not
        # measured" for "no CPU"
        summary = {
            "totalMs": round(total * 1e3, 3),
            "cpuSampled": cpu_on,
            "stages": {
                s: dict({"wallMs": round(rec[0] * 1e3, 3),
                         "calls": rec[1]},
                        **({"cpuMs": round(rec[3] * 1e3, 3)}
                           if cpu_on else {}))
                for s, rec in stages.items()},
        }
        if cpu_on:
            summary["cpuMs"] = round(total_cpu * 1e3, 3)
        if notes:
            summary["notes"] = notes
        _last_summary_var.set(summary)
        return total


class _TrackCtx:
    """`with profiling.track(...)`: create + activate + finish."""

    __slots__ = ("_trk", "_token")

    def __init__(self, name: str, role: str, metrics):
        self._trk = StageTrack(name, role=role, metrics=metrics) \
            if stage_timers_enabled() else None
        self._token = None

    def __enter__(self) -> "StageTrack | None":
        if self._trk is not None:
            self._token = _track_var.set(self._trk)
        return self._trk

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._trk is None:
            return
        try:
            _track_var.reset(self._token)
        except ValueError:      # pragma: no cover — cross-context exit
            pass
        self._trk.finish()


def track(name: str, role: str = "", metrics=None) -> _TrackCtx:
    """Open a stage track for the current request and make it the
    context's active track; finished (histograms observed, spans
    emitted) on exit.  Yields None when stage timers are disabled."""
    return _TrackCtx(name, role, metrics)


def current_track() -> "StageTrack | None":
    return _track_var.get()


class _UseTrack:
    """Re-bind an existing track on ANOTHER thread (contextvars do not
    follow threading.Thread): the filer captures its track before
    handing upload work to the limiter pool, and each pool task wraps
    itself in use_track so operation.assign/upload's stage() calls
    find it."""

    __slots__ = ("_trk", "_token")

    def __init__(self, trk: "StageTrack | None"):
        self._trk = trk
        self._token = None

    def __enter__(self):
        if self._trk is not None:
            self._token = _track_var.set(self._trk)
        return self._trk

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            try:
                _track_var.reset(self._token)
            except ValueError:  # pragma: no cover
                pass


def use_track(trk: "StageTrack | None") -> _UseTrack:
    return _UseTrack(trk)


class _StageCtx:
    __slots__ = ("_trk", "_name", "_t0", "_c0")

    def __init__(self, trk: "StageTrack", name: str):
        self._trk = trk
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        # per-THREAD cpu clock: sampled on whichever thread runs the
        # stage, so the use_track() re-bind charges pool-thread CPU to
        # the request exactly — but only when the track drew the CPU
        # attribution sample (the clock is a trapped syscall on
        # sandboxed kernels; see cpu_sample_every)
        self._c0 = time.thread_time() if self._trk._cpu_on else 0.0
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._trk.add(self._name, time.perf_counter() - self._t0,
                      (time.thread_time() - self._c0)
                      if self._trk._cpu_on else 0.0)


class _NoopStage:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NOOP = _NoopStage()


def stage(name: str):
    """Time one stage of the active track; a shared no-op (one
    contextvar read) when no track is active — safe on any hot path."""
    trk = _track_var.get()
    if trk is None:
        return _NOOP
    return _StageCtx(trk, name)


# -- flight recorder (tail-sampled slow-request capture) ------------------

def recorder_enabled() -> bool:
    """SEAWEEDFS_TPU_FLIGHT_RECORDER=0 disarms capture entirely (the
    fronts then skip note arming and the per-request observe); the
    /debug/attribution runtime lever disarms it the same way."""
    if _attr_disarmed:
        return False
    return os.environ.get("SEAWEEDFS_TPU_FLIGHT_RECORDER", "1") \
        not in ("0", "false")


def ring_size() -> int:
    """SEAWEEDFS_TPU_SLOW_RING: flight records kept per process."""
    return max(8, _env_int("SEAWEEDFS_TPU_SLOW_RING", 64))


def slow_floor_s() -> float:
    """SEAWEEDFS_TPU_SLOW_MIN_MS: the slow-capture threshold never
    drops below this — a uniformly-fast role must not spend captures
    on its own p95 noise."""
    return max(0.0, _env_float("SEAWEEDFS_TPU_SLOW_MIN_MS", 25.0)) / 1e3


def capture_rate() -> float:
    """SEAWEEDFS_TPU_SLOW_CAPTURE_PER_S: ceiling on threshold-only
    captures (error/deadline/shed verdicts are never rate-limited —
    they are rare and precious).  Each capture walks the trace ring
    for its span tree, so an unbounded rate would tax exactly the
    overloaded state the recorder exists to explain."""
    return max(1.0, _env_float("SEAWEEDFS_TPU_SLOW_CAPTURE_PER_S",
                               20.0))


class FlightRecorder:
    """Bounded ring of complete slow/error-request records.

    Always-on and self-limiting: every request's wall feeds a
    LatencyTracker (util/hedge — the same ring-quantile the hedge
    threshold and brownout median run on) and only requests beyond
    max(p95, SLOW_MIN_MS) — or with a non-ok verdict — are captured,
    so by construction ~1-in-20 requests pays the capture cost and the
    ring always holds the tail that head-sampled tracing misses."""

    def __init__(self, size: "int | None" = None):
        from .util.hedge import LatencyTracker
        import collections
        self._lock = threading.Lock()
        self._ring = collections.deque(
            maxlen=size if size else ring_size())
        self._tracker = LatencyTracker(size=128, min_samples=32)
        self._notes_since_quantile = 0
        self._threshold: "float | None" = None
        self._rate_window_start = 0.0
        self._rate_window_count = 0
        # injectable for tests: a real-time 1 s window can roll over
        # mid-assertion on a degraded box; pinning the clock makes the
        # rate-cap behavior deterministic
        self._now = time.monotonic
        self.captured = 0
        self.dropped_rate_limited = 0

    def threshold(self) -> "float | None":
        """Current slow-capture threshold in seconds; None while the
        tracker is still warming up (no threshold captures yet —
        error/deadline/shed still capture)."""
        with self._lock:
            return self._threshold

    def _note_wall(self, wall_s: float) -> None:
        self._tracker.note(wall_s)
        with self._lock:
            self._notes_since_quantile += 1
            if self._threshold is None or \
                    self._notes_since_quantile >= 32:
                # the quantile sorts 128 floats — recompute every 32
                # requests, not every request
                self._notes_since_quantile = 0
                p95 = self._tracker.quantile(0.95)
                self._threshold = None if p95 is None else \
                    max(p95, slow_floor_s())

    def note_walls(self, walls: "list[float]") -> None:
        """Bulk _note_wall for the native-plane record drain: train
        the slow threshold on a whole batch with one tracker lock
        round and at most one quantile refresh."""
        if not walls:
            return
        self._tracker.note_many(walls)
        with self._lock:
            self._notes_since_quantile += len(walls)
            if self._threshold is None or \
                    self._notes_since_quantile >= 32:
                self._notes_since_quantile = 0
                p95 = self._tracker.quantile(0.95)
                self._threshold = None if p95 is None else \
                    max(p95, slow_floor_s())

    def _rate_ok(self) -> bool:
        """Token check for threshold-only captures (caller holds no
        lock): a 1-second window capped at capture_rate()."""
        now = self._now()
        with self._lock:
            if now - self._rate_window_start >= 1.0:
                self._rate_window_start = now
                self._rate_window_count = 0
            if self._rate_window_count >= capture_rate():
                self.dropped_rate_limited += 1
                return False
            self._rate_window_count += 1
            return True

    def observe(self, role: str, method: str, path: str, status: int,
                wall_s: float, cpu_s: "float | None" = None,
                verdict: str = "ok", trace_id: str = "",
                deadline: "dict | None" = None,
                stages: "dict | None" = None,
                notes: "dict | None" = None) -> "dict | None":
        """Feed one finished request; returns the captured record (or
        None).  `stages` is a StageTrack summary (take_last_summary),
        `deadline` the {budgetMs, remainingMs} doc from the front,
        `notes` the flight_note dict.  `cpu_s` is None when the
        request didn't draw the CPU-attribution sample (see
        cpu_sample_every) — the record then reports wall only, with
        the cpuMs/waitMs keys ABSENT rather than zero."""
        self._note_wall(wall_s)
        slow = self._threshold is not None and wall_s >= self._threshold
        if verdict == "ok" and status >= 500:
            verdict = "error"
        if verdict == "ok":
            if not slow:
                return None
            if not self._rate_ok():
                return None
            verdict = "slow"
        rec = {
            "ts": time.time(),
            "role": role,
            "method": method,
            "path": path,
            "status": status,
            "verdict": verdict,
            "wallMs": round(wall_s * 1e3, 3),
            "traceId": trace_id,
        }
        if cpu_s is not None:
            rec["cpuMs"] = round(cpu_s * 1e3, 3)
            rec["waitMs"] = round(max(wall_s - cpu_s, 0.0) * 1e3, 3)
        if deadline:
            rec["deadline"] = deadline
        if stages:
            rec["stages"] = stages
        if notes:
            rec["notes"] = notes
        if trace_id:
            # the span tree AS OF capture time: the server span and
            # the track's stage spans are already in the ring (the
            # fronts capture after sp.finish()); downstream hops'
            # spans live in THEIR processes' rings and cluster.slow
            # merges them by trace id
            from . import tracing
            spans = tracing.spans_for(trace_id)
            if spans:
                rec["spans"] = spans
        with self._lock:
            self._ring.append(rec)
            self.captured += 1
        _process_metrics().counter_add(
            "flight_records_total", 1.0,
            help_text="requests captured by the flight recorder",
            verdict=verdict)
        return rec

    def snapshot(self) -> dict:
        with self._lock:
            thr = self._threshold
            return {
                "records": [dict(r) for r in self._ring],
                "captured": self.captured,
                "droppedRateLimited": self.dropped_rate_limited,
                "thresholdMs": round(thr * 1e3, 3)
                if thr is not None else None,
                "ringSize": self._ring.maxlen,
            }

    def reset(self) -> None:
        """Tests only: forget records and latency history."""
        with self._lock:
            self._ring.clear()
            self.captured = 0
            self.dropped_rate_limited = 0
            self._threshold = None
            self._notes_since_quantile = 0
            self._rate_window_count = 0
        self._tracker.reset()


_recorder: "FlightRecorder | None" = None
_recorder_lock = threading.Lock()


def flight_recorder() -> FlightRecorder:
    global _recorder
    r = _recorder
    if r is None:
        with _recorder_lock:
            r = _recorder
            if r is None:
                r = _recorder = FlightRecorder()
    return r


# -- native-plane flight deck ----------------------------------------------
#
# The C++ planes record every request into a lock-free ring (PlaneRec
# in the .cc files / native.PlaneRecord on this side); the drainer
# threads in server/meta_plane_native.py and server/volume_server.py
# pull the rings on a tick + at /debug/slow scrape time and feed each
# record through a PlaneRecordSink — LatencyTracker training, stage
# tail histograms, synthesized trace spans, FlightRecorder captures.
# Python stays off the request path: the plane never waits on the
# drain, and a dead drainer only costs observability.

_plane_drain_disarmed = False


def set_plane_drain_disarmed(disarmed: bool) -> None:
    """Runtime kill switch (POST /debug/attribution scope "drain",
    and a within-cluster drain-on/off A/B lever)."""
    global _plane_drain_disarmed
    _plane_drain_disarmed = bool(disarmed)


def plane_drain_enabled() -> bool:
    """SEAWEEDFS_TPU_PLANE_DRAIN=0 disarms the plane-record drain
    entirely (records still accumulate C-side and fall off the ring);
    the runtime lever disarms it the same way."""
    if _plane_drain_disarmed:
        return False
    return os.environ.get("SEAWEEDFS_TPU_PLANE_DRAIN", "1") \
        not in ("0", "false")


def plane_drain_interval_s() -> float:
    """SEAWEEDFS_TPU_PLANE_DRAIN_MS: drainer tick (how stale the
    Python view of the plane rings may go between scrapes)."""
    return max(10.0,
               _env_float("SEAWEEDFS_TPU_PLANE_DRAIN_MS", 200.0)) / 1e3


# scrape-time hooks: /debug/slow runs these before snapshotting so a
# just-finished plane request is drained into the recorder the scrape
# is about to read, instead of waiting out the drainer tick
_scrape_hooks: "list" = []
_scrape_hooks_lock = threading.Lock()


def register_scrape_hook(fn) -> None:
    with _scrape_hooks_lock:
        if fn not in _scrape_hooks:
            _scrape_hooks.append(fn)


def unregister_scrape_hook(fn) -> None:
    with _scrape_hooks_lock:
        try:
            _scrape_hooks.remove(fn)
        except ValueError:
            pass


def run_scrape_hooks() -> None:
    with _scrape_hooks_lock:
        hooks = list(_scrape_hooks)
    for fn in hooks:
        try:
            fn()
        except Exception:  # noqa: BLE001 — a hook must never 500 a
            pass           # scrape


_PLANE_STAGE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                        0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                        1.0, 2.5)


class PlaneRecordSink:
    """Fan one plane's drained flight records into the Python
    observability planes.

    Per record: the wall (sum of stage ns) trains `tracker` (the
    hedge/brownout/capture LatencyTracker for the role) and the
    per-stage tail histograms; every record feeds
    FlightRecorder.observe so plane traffic trains the slow
    threshold; a span tree is synthesized (tracing.emit_plane_hop)
    only for records that can stitch or will be captured — client-rid
    records, errors, and records at/over the current slow threshold —
    so the lean all-minted-rid drain stays allocation-cheap."""

    def __init__(self, role: str, plane: str, method: str,
                 stage_names: "tuple[str, ...]",
                 fallback_names: "tuple[str, ...]",
                 tracker=None, metrics=None):
        from . import native as _native
        self.role = role
        self.plane = plane
        self.method = method
        self.stage_names = stage_names
        self.fallback_names = fallback_names
        self.tracker = tracker
        self.metrics = metrics if metrics is not None \
            else _process_metrics()
        self._client_rid_flag = _native.PLANE_RECORD_CLIENT_RID
        self._minted_rid_flag = _native.PLANE_RECORD_MINTED_UPSTREAM
        self._stage_obs = [
            self.metrics.observer(
                "plane_stage_seconds", _PLANE_STAGE_BUCKETS,
                help_text="native-plane per-request stage latency "
                          "(drained from the C++ flight ring)",
                plane=plane, stage=s)
            for s in stage_names]
        self._stage_batch_obs = [
            self.metrics.batch_observer(
                "plane_stage_seconds", _PLANE_STAGE_BUCKETS,
                plane=plane, stage=s)
            for s in stage_names]
        # each record's wall on request_seconds' buckets: the foreground
        # signal the QoS throttle samples beside the Python front's
        from .stats import DEFAULT_BUCKETS
        self._wall_obs = self.metrics.observer(
            "plane_request_seconds", DEFAULT_BUCKETS,
            help_text="native-plane request wall (sum of its stages), "
                      "drained from the C++ flight ring", plane=plane)
        self._wall_batch_obs = self.metrics.batch_observer(
            "plane_request_seconds", DEFAULT_BUCKETS, plane=plane)
        self.records = 0
        self.captures = 0

    def _observe_one(self, fr, rid: str, start_s: float,
                     stage_s: "list[float]", wall: float, status: int,
                     fb: int, flags: int, nbytes: int,
                     deadline_ms: int) -> None:
        """The interesting-record path: span synthesis + the
        FlightRecorder capture decision.  Only stitchable (client
        rid), error, and at/over-threshold records reach here — the
        lean minted-rid bulk must never pay these allocations."""
        fb_name = self.fallback_names[fb] \
            if 0 <= fb < len(self.fallback_names) else "?"
        error = status >= 500
        thr = fr.threshold()
        # a forwarded plane-minted rid is not a client trace: it only
        # earns spans when the record is independently interesting
        # (and then the rid still stitches the cross-role tree)
        stitchable = bool(flags & self._client_rid_flag) and \
            not (flags & self._minted_rid_flag)
        if stitchable or error or (thr is not None and wall >= thr):
            from . import tracing
            tracing.emit_plane_hop(
                f"{self.method} [{self.plane}-plane]", self.role,
                rid, start_s, wall,
                list(zip(self.stage_names, stage_s)),
                attrs={"status": status, "bytes": nbytes,
                       "fallback": fb_name},
                error=error)
        notes = {"plane": self.plane, "bytes": nbytes}
        if fb_name != "none":
            notes["fallback"] = fb_name
        deadline = None
        if deadline_ms >= 0:
            deadline = {"remainingMs": int(deadline_ms)}
        # StageTrack-summary shape: _render_slow_hop reads
        # rec["stages"]["stages"]
        stages = {"track": f"{self.plane}_plane",
                  "wallMs": round(wall * 1e3, 3),
                  "stages": {s: {"wallMs": round(v * 1e3, 3)}
                             for s, v in zip(self.stage_names,
                                             stage_s)
                             if v > 0.0}}
        if fr.observe(self.role, self.method,
                      f"[{self.plane}-plane]", status, wall,
                      verdict="error" if error else "ok",
                      trace_id=rid, deadline=deadline,
                      stages=stages, notes=notes) is not None:
            self.captures += 1

    def feed(self, records) -> int:
        """Consume one drained batch (native.PlaneRecord instances);
        returns how many were fed."""
        n = 0
        fr = flight_recorder()
        rec_on = recorder_enabled()
        thr = fr.threshold()
        for rec in records:
            n += 1
            stage_s = [ns / 1e9 for ns in rec.stage_ns]
            wall = sum(stage_s)
            for obs, s in zip(self._stage_obs, stage_s):
                if s > 0.0:
                    obs(s)
            self._wall_obs(wall)
            if self.tracker is not None:
                self.tracker.note(wall)
            if not rec_on:
                continue
            status = int(rec.status)
            flags = int(rec.flags)
            stitch = (flags & self._client_rid_flag) and \
                not (flags & self._minted_rid_flag)
            if status < 500 and not stitch and \
                    (thr is None or wall < thr):
                # the lean bulk: train the slow threshold, skip the
                # rid decode and record-dict allocations entirely
                fr._note_wall(wall)
                continue
            self._observe_one(
                fr, rec.rid.decode("ascii", "replace"),
                rec.start_unix_ns / 1e9, stage_s, wall, status,
                int(rec.fallback), int(rec.flags), int(rec.bytes),
                int(rec.deadline_ms))
        self.records += n
        if n:
            self.metrics.counter_add(
                "plane_records_total", float(n),
                help_text="flight records drained from the native "
                          "plane rings", plane=self.plane)
        return n

    def feed_buffer(self, buf, n: int) -> int:
        """Vectorized drain hot path over the reused ctypes batch
        buffer (native.drain_plane_records hands it straight here).
        Per-record Python fan-out measured ~30% of this box's one
        core at a few thousand plane req/s; the numpy path pays one
        array view, one bincount per stage histogram, and one lock
        round per shared structure, touching Python objects only for
        the rare stitchable/error/slow records."""
        if n <= 0:
            return 0
        try:
            import numpy as np
        except ImportError:  # pragma: no cover — numpy ships here
            return self.feed(buf[i] for i in range(n))
        from . import native as _native
        arr = np.frombuffer(buf, dtype=_native.plane_record_dtype(),
                            count=n)
        stage_s = arr["stage_ns"] / 1e9      # (n, nstages) float64
        wall = stage_s.sum(axis=1)
        for i, obs_b in enumerate(self._stage_batch_obs):
            col = stage_s[:, i]
            obs_b(col[col > 0.0])
        self._wall_batch_obs(wall)
        if self.tracker is not None:
            self.tracker.note_many(wall.tolist())
        self.records += n
        self.metrics.counter_add(
            "plane_records_total", float(n),
            help_text="flight records drained from the native "
                      "plane rings", plane=self.plane)
        fr = flight_recorder()
        if not recorder_enabled():
            return n
        thr = fr.threshold()
        fl = arr["flags"]
        stitch = ((fl & self._client_rid_flag) != 0) & \
            ((fl & self._minted_rid_flag) == 0)
        mask = (arr["status"] >= 500) | stitch
        if thr is not None:
            mask = mask | (wall >= thr)
        fr.note_walls(wall[~mask].tolist())
        for i in np.nonzero(mask)[0].tolist():
            self._observe_one(
                fr,
                bytes(arr["rid"][i]).split(b"\0", 1)[0].decode(
                    "ascii", "replace"),
                float(arr["start_unix_ns"][i]) / 1e9,
                [float(x) for x in stage_s[i]], float(wall[i]),
                int(arr["status"][i]), int(arr["fallback"][i]),
                int(arr["flags"][i]), int(arr["bytes"][i]),
                int(arr["deadline_ms"][i]))
        return n

    def note_dropped(self, total_dropped: int, last_seen: int) -> int:
        """Publish the ring's monotonic dropped count as a counter
        delta; returns the new last-seen value for the caller to
        carry."""
        delta = total_dropped - last_seen
        if delta > 0:
            self.metrics.counter_add(
                "plane_ring_dropped_total", float(delta),
                help_text="flight records overwritten in the native "
                          "ring before the drainer reached them",
                plane=self.plane)
        return max(total_dropped, last_seen)


class PlaneRecordDrainer:
    """Consumer side of one plane's flight ring: a tick thread
    (SEAWEEDFS_TPU_PLANE_DRAIN_MS) plus on-demand pulls at
    /debug/slow scrape time, serialized by a lock — the C ring is
    single-consumer, so every pull path must go through drain_now.

    `drain_fn(sink) -> int` runs one native drain pass (the wrapper
    method, which no-ops after the plane stopped); `dropped_fn()`
    reads the ring's monotonic drop counter."""

    def __init__(self, sink: PlaneRecordSink, drain_fn, dropped_fn):
        self.sink = sink
        self._drain_fn = drain_fn
        self._dropped_fn = dropped_fn
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._dropped_seen = 0
        self._thread: "threading.Thread | None" = None

    def start(self) -> "PlaneRecordDrainer":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"weed-plane-drain-{self.sink.plane}")
        self._thread.start()
        register_scrape_hook(self.drain_now)
        return self

    def drain_now(self) -> int:
        """One drain pass; safe from any thread, any time (including
        after stop — the wrapper's drain_fn checks its handle)."""
        if not plane_drain_enabled():
            return 0
        with self._lock:
            n = self._drain_fn(self.sink)
            self._dropped_seen = self.sink.note_dropped(
                int(self._dropped_fn()), self._dropped_seen)
            return n

    def _run(self) -> None:
        while not self._stop.wait(plane_drain_interval_s()):
            try:
                self.drain_now()
            except Exception:  # noqa: BLE001 — a drain failure
                pass           # costs observability, never the drainer

    def stop(self) -> None:
        """Join the tick thread BEFORE the native server stops: the
        drain callable dereferences the plane handle."""
        unregister_scrape_hook(self.drain_now)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        try:
            self.drain_now()   # final pass: nothing left un-drained
        except Exception:      # noqa: BLE001
            pass


# -- scheduler-delay probe -------------------------------------------------

class SchedProbe:
    """Daemon thread timing short Event.wait sleeps against their
    deadline: the overshoot is how long a runnable thread waited for
    the scheduler AND the GIL after its wakeup — the direct signal for
    'this role is GIL-convoyed', independent of any request being
    instrumented.  Exported as the `gil_wait_ratio` gauge (EWMA of
    overshoot/interval; 0 idle .. ~1 means wakeups routinely wait a
    whole extra interval)."""

    def __init__(self, interval_s: "float | None" = None):
        self.interval = interval_s if interval_s else max(
            0.005, _env_float("SEAWEEDFS_TPU_SCHED_PROBE_MS", 50.0)
            / 1e3)
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.ratio = 0.0
        self.ticks = 0

    def start(self) -> "SchedProbe":
        self._thread = threading.Thread(
            target=self._run, name="weed-sched-probe", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        m = _process_metrics()
        ewma = 0.0
        while True:
            t0 = time.monotonic()
            if self._stop.wait(self.interval):
                return
            overshoot = max(
                0.0, (time.monotonic() - t0) - self.interval)
            ewma = 0.9 * ewma + 0.1 * (overshoot / self.interval)
            self.ratio = ewma
            self.ticks += 1
            if self.ticks == 1 or self.ticks % 10 == 0:
                # first tick immediately (a scrape right after boot
                # must see the gauge), then ~2 writes/second at the
                # default interval
                m.gauge_set(
                    "gil_wait_ratio", round(ewma, 4),
                    help_text="EWMA of scheduler-probe sleep overshoot"
                              " / interval: how late runnable threads "
                              "get the GIL back (0 idle, ~1 = a whole "
                              "extra interval per wakeup)")


_sched_probe: "SchedProbe | None" = None


def sched_probe_enabled() -> bool:
    return os.environ.get("SEAWEEDFS_TPU_SCHED_PROBE", "1") \
        not in ("0", "false")


def maybe_start_sched_probe() -> "SchedProbe | None":
    """Once per process (every role's install_debug_routes calls
    this, like maybe_autostart)."""
    global _sched_probe
    if _sched_probe is not None or not sched_probe_enabled():
        return _sched_probe
    _sched_probe = SchedProbe().start()
    return _sched_probe


def stop_sched_probe() -> None:
    """Stop the process's probe and wait for its thread (tests: a probe
    left running writes `gil_wait_ratio` into whatever registry
    `stats.PROCESS` is by then).  The next `maybe_start_sched_probe`
    starts a fresh one."""
    global _sched_probe
    probe, _sched_probe = _sched_probe, None
    if probe is not None:
        probe.stop()
        if probe._thread is not None:
            probe._thread.join(timeout=5)


# -- device telemetry -------------------------------------------------

def _process_metrics():
    return stats.PROCESS


def device_note(direction: str, nbytes: int,
                seconds: "float | None") -> None:
    """Record one host<->device staging window (direction "h2d" or
    "d2h"): cumulative bytes, a latency histogram and a last-window
    throughput gauge.  seconds=None records bytes only: an enqueue wall
    is not a transfer wall, and a wrong gauge is worse than none."""
    m = stats.PROCESS
    m.counter_add("device_transfer_bytes_total", float(nbytes),
                  help_text="host<->device staging bytes", dir=direction)
    if seconds is None:
        return
    m.histogram_observe("device_transfer_seconds", seconds,
                        help_text="host<->device staging window "
                                  "latency", dir=direction)
    if seconds > 0:
        gauge = "device_h2d_gbps" if direction == "h2d" \
            else "device_d2h_gbps"
        m.gauge_set(gauge, nbytes / seconds / 1e9,
                    help_text="last staging window throughput")


def overlap_note(fraction: float, windows: int,
                 op: str = "encode") -> None:
    """Record one windowed launch's h2d/d2h overlap fraction (0: the
    staging and consume planes ran serially, 1: the wall equalled the
    slower plane alone) and its window count."""
    m = stats.PROCESS
    m.gauge_set("device_h2d_overlap_fraction", fraction,
                help_text="last windowed launch's h2d/d2h overlap "
                          "fraction (0 serial .. 1 fully overlapped)",
                op=op)
    m.counter_add("device_staged_windows_total", float(windows),
                  help_text="h2d staging windows launched", op=op)


def kernel_note(kernel: str, seconds: float, nbytes: int = 0) -> None:
    """Record one kernel's dispatch-to-fetch window."""
    m = stats.PROCESS
    m.histogram_observe("device_kernel_seconds", seconds,
                        help_text="device kernel wall time per launch",
                        kernel=kernel)
    m.gauge_set("device_kernel_last_ms", seconds * 1e3, kernel=kernel)
    if nbytes:
        m.counter_add("device_kernel_bytes_total", float(nbytes),
                      kernel=kernel)


def sample_device_memory() -> "dict[str, dict]":
    """Gauge each CUDA device's memory, labelled `cuda:<i>`:
    bytes_in_use (torch.cuda.memory_allocated), peak_bytes_in_use
    (max_memory_allocated) and bytes_limit (the card's total from
    mem_get_info).  Returns {label: stats}; {} when there is no CUDA
    device, as the reference returns {} for a backend without memory
    stats."""
    import torch
    out: dict[str, dict] = {}
    if not torch.cuda.is_available():
        return out
    m = stats.PROCESS
    for i in range(torch.cuda.device_count()):
        _free, total = torch.cuda.mem_get_info(i)
        ms = {"bytes_in_use": torch.cuda.memory_allocated(i),
              "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
              "bytes_limit": total}
        label = f"cuda:{i}"
        out[label] = ms
        for key, gauge in (("bytes_in_use", "device_memory_bytes_in_use"),
                           ("peak_bytes_in_use",
                            "device_memory_peak_bytes"),
                           ("bytes_limit", "device_memory_bytes_limit")):
            m.gauge_set(gauge, float(ms[key]),
                        help_text="CUDA device memory stats",
                        device=label)
    return out


# -- Prometheus text-format client helpers --------------------------------

_LABEL_ESCAPES = {"n": "\n", "\\": "\\", '"': '"'}


def _unescape_label(v: str) -> str:
    """Single left-to-right pass — sequential str.replace decodes
    `\\\\n` (escaped backslash + literal n) wrongly because the \\n
    replacement consumes the second backslash of the pair."""
    if "\\" not in v:
        return v
    out: list = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append(_LABEL_ESCAPES.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prom_text(text: str) -> "dict[str, list]":
    """Parse Prometheus exposition text into
    {metric_name: [(labels_dict, value), ...]} — the client half of
    stats.Metrics.render, for cluster.top to
    read any node's /metrics without a dependency."""
    out: dict[str, list] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, val = line.rsplit(" ", 1)
            value = float(val)
        except ValueError:
            continue
        labels: dict[str, str] = {}
        name = head
        if "{" in head and head.endswith("}"):
            name, _, rest = head.partition("{")
            body = rest[:-1]
            # split on commas outside quotes; values may hold escaped
            # quotes (stats.escape_label_value)
            parts, cur, quoted, escaped = [], "", False, False
            for ch in body:
                if escaped:
                    cur += ch
                    escaped = False
                elif ch == "\\":
                    cur += ch
                    escaped = True
                elif ch == '"':
                    quoted = not quoted
                    cur += ch
                elif ch == "," and not quoted:
                    parts.append(cur)
                    cur = ""
                else:
                    cur += ch
            if cur:
                parts.append(cur)
            for p in parts:
                k, _, v = p.partition("=")
                v = v.strip()
                if v.startswith('"') and v.endswith('"'):
                    v = _unescape_label(v[1:-1])
                labels[k.strip()] = v
        out.setdefault(name, []).append((labels, value))
    return out


def prom_histogram(metrics: "dict[str, list]", name: str,
                   match: "dict | None" = None) -> "dict | None":
    """Reassemble one histogram from parsed exposition text, merged
    across every label set whose labels include `match`.  Returns
    {"buckets": [...], "counts": [...(per-bucket, non-cumulative)...],
    "sum": s, "count": n} or None."""
    match = match or {}

    def ok(labels: dict) -> bool:
        return all(labels.get(k) == v for k, v in match.items())

    by_le: dict[float, float] = {}
    total_sum = 0.0
    total_count = 0.0
    seen = False
    for labels, value in metrics.get(f"{name}_bucket", []):
        if not ok(labels) or "le" not in labels:
            continue
        le = float("inf") if labels["le"] in ("+Inf", "inf") \
            else float(labels["le"])
        by_le[le] = by_le.get(le, 0.0) + value
        seen = True
    for labels, value in metrics.get(f"{name}_sum", []):
        if ok(labels):
            total_sum += value
            seen = True
    for labels, value in metrics.get(f"{name}_count", []):
        if ok(labels):
            total_count += value
    if not seen:
        return None
    les = sorted(le for le in by_le if le != float("inf"))
    cum = [by_le[le] for le in les] + \
        [by_le.get(float("inf"), total_count)]
    counts = [cum[0]] + [cum[i] - cum[i - 1]
                         for i in range(1, len(cum))]
    return {"buckets": les, "counts": counts,
            "sum": total_sum, "count": total_count}


def histogram_delta(after: "dict | None", before: "dict | None"
                    ) -> "dict | None":
    """after - before for two prom_histogram snapshots (the windowed
    view cluster.top needs: counters are cumulative, the
    last N seconds are a subtraction)."""
    if after is None:
        return None
    if before is None or before.get("buckets") != after.get("buckets"):
        return dict(after)
    return {
        "buckets": list(after["buckets"]),
        "counts": [a - b for a, b in zip(after["counts"],
                                         before["counts"])],
        "sum": after["sum"] - before["sum"],
        "count": after["count"] - before["count"],
    }


def histogram_quantile(hist: "dict | None", q: float) -> float:
    """Linear-interpolated quantile over {buckets, counts} (the
    Prometheus histogram_quantile estimate).  0.0 for empty input."""
    if not hist or hist.get("count", 0) <= 0:
        return 0.0
    target = hist["count"] * min(max(q, 0.0), 1.0)
    cum = 0.0
    lo = 0.0
    for le, n in zip(hist["buckets"] + [float("inf")], hist["counts"]):
        if n <= 0:
            lo = le if le != float("inf") else lo
            continue
        if cum + n >= target:
            if le == float("inf"):
                return lo       # open upper bucket: clamp to its floor
            frac = (target - cum) / n
            return lo + (le - lo) * frac
        cum += n
        lo = le
    return lo if lo != float("inf") else 0.0
