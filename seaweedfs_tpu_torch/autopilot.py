"""The SLO autopilot, the port's copy of `seaweedfs_tpu/autopilot.py`: a
closed loop over the knobs that the hedge, the brownout and the caches
otherwise take from the environment, and a supervisor of the filer's
native planes.

A controller thread a role (`SEAWEEDFS_TPU_AUTOPILOT_TICK_MS`, default
1000) reads counter deltas between its ticks off `stats.PROCESS` and
moves the knobs through a registry of `Actuator`s, the only path by
which the loop changes a knob.  Its rules, every one:

- **bounded**: an actuator has `[lo, hi]`; a move is clamped to it, and
  one already at the bound does not move;
- **damped**: a rule fires after `confirm` ticks in a row
  (`SEAWEEDFS_TPU_AUTOPILOT_CONFIRM`, default 2), and a move smaller than
  the deadband (2%) is skipped;
- **a cooldown a knob** (`SEAWEEDFS_TPU_AUTOPILOT_COOLDOWN_S`, default
  5 s): after a move the knob holds whatever the sensors say;
- **a sensor gap holds**: a failed sample, an absent counter or a window
  with too few events never moves a knob;
- **observable**: each move lands in the bounded action log (`GET
  /debug/autopilot`), `autopilot_actions_total{knob,direction}`,
  `autopilot_knob{knob}` and a `flight_note` on the request, if any.

Kill switches: `SEAWEEDFS_TPU_AUTOPILOT=0` (the loop never starts, and a
running one holds), `POST /debug/autopilot {"enabled": false}`, and a
knob a role never registers.

A `PlaneGuard` watches a native plane's errors (`wal_errors`,
`upstream_errors`, `errors`: the port's plane stats carry the first two)
against its requests: a spike (5 errors at least, half the window's
requests) disarms it through its lever, and after a probation that
doubles with each trip (10 s, up to 300 s) the guard arms it again.  A
guard re-arms only what it disarmed, and the filer's lever refuses to
arm a plane that the port stood down (under `[tls]` or a
`[qos.default]` limit), so probation never brings one back.

Roles: `build_for_filer` (hedge.ratio, hedge.min_ms, brownout.factor,
cache.chunk, cache.meta, the meta and read planes) and `build_for_volume`
(cache.needle).  Only the filer owns `brownout.factor`: the override is
process-global, and a filer and volume servers in one process would
otherwise run two loops on one knob.  The pre-fork filer's parent adds
`workers` (__main__.py).  It imports no torch.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import profiling, stats
from .util import wlog


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def enabled_by_env() -> bool:
    return os.environ.get("SEAWEEDFS_TPU_AUTOPILOT", "1") \
        not in ("0", "false")


def tick_interval() -> float:
    return max(0.05,
               _env_float("SEAWEEDFS_TPU_AUTOPILOT_TICK_MS", 1000.0) / 1e3)


class Actuator:
    """One knob: a getter, a setter, hard bounds and a cooldown.  Only
    `Autopilot.actuate` calls `set`."""

    __slots__ = ("name", "get", "set", "lo", "hi", "cooldown",
                 "last_actuated", "describe")

    def __init__(self, name: str, get, set, lo: float, hi: float,
                 cooldown: "float | None" = None, describe: str = ""):
        if not lo <= hi:
            raise ValueError(f"{name}: lo {lo} > hi {hi}")
        self.name = name
        self.get = get
        self.set = set
        self.lo = float(lo)
        self.hi = float(hi)
        self.cooldown = (cooldown if cooldown is not None else
                         _env_float("SEAWEEDFS_TPU_AUTOPILOT_COOLDOWN_S",
                                    5.0))
        self.last_actuated: "float | None" = None
        self.describe = describe


class PlaneGuard:
    """The supervision of one native plane.  `stats()` gives its
    cumulative counters, `arm(bool)` is its `/debug/*_plane` lever and
    `armed()` its state.  A trip needs `min_errors` errors in the window
    and an error share of `trip_ratio` of the plane's requests; the
    probation doubles a trip in a row, up to `max_backoff`, and a clean
    probation after a re-arm forgets the history."""

    __slots__ = ("name", "stats", "arm", "armed", "trip_ratio",
                 "min_errors", "backoff", "max_backoff", "disarmed_by_us",
                 "probation_until", "trips", "_prev", "_streak", "confirm")

    _ERROR_KEYS = ("wal_errors", "upstream_errors", "errors")

    def __init__(self, name: str, stats, arm, armed,
                 trip_ratio: float = 0.5, min_errors: int = 5,
                 backoff: float = 10.0, max_backoff: float = 300.0,
                 confirm: int = 1):
        self.name = name
        self.stats = stats
        self.arm = arm
        self.armed = armed
        self.trip_ratio = trip_ratio
        self.min_errors = min_errors
        self.backoff = backoff
        self.max_backoff = max_backoff
        self.confirm = max(1, confirm)
        self.disarmed_by_us = False
        self.probation_until = 0.0
        self.trips = 0
        self._streak = 0
        self._prev: "dict | None" = None

    def window(self) -> "tuple[float, float, float] | None":
        """(requests, errors, fallbacks) since the last tick; None on the
        first sample or a failed one (a gap holds)."""
        try:
            cur = dict(self.stats() or {})
        except Exception:
            return None
        prev, self._prev = self._prev, cur
        if prev is None:
            return None
        d = {k: max(0.0, float(cur.get(k, 0)) - float(prev.get(k, 0)))
             for k in cur}
        errors = sum(d.get(k, 0.0) for k in self._ERROR_KEYS)
        return d.get("requests", 0.0), errors, d.get("fallbacks", 0.0)


class Autopilot:
    """A role's controller.  The server registers its actuators and
    planes, then `start()` runs the tick thread; `tick()` may be called by
    hand with a pinned clock (`now`) and a synthetic `sense`, which is how
    the rules are tested."""

    ACTION_LOG = 64
    MIN_HEDGE_WINDOW = 5.0
    MIN_CACHE_WINDOW = 20.0

    def __init__(self, role: str, metrics: "stats.Metrics | None" = None,
                 sense=None, now=time.monotonic,
                 confirm: "int | None" = None):
        self.role = role
        self.metrics = metrics if metrics is not None else stats.PROCESS
        self.now = now
        self.enabled = enabled_by_env()
        self.confirm = confirm if confirm is not None else max(
            1, int(_env_float("SEAWEEDFS_TPU_AUTOPILOT_CONFIRM", 2)))
        self.deadband = 0.02
        self.actuators: "dict[str, Actuator]" = {}
        self.planes: "list[PlaneGuard]" = []
        self.actions: "deque[dict]" = deque(maxlen=self.ACTION_LOG)
        self.ticks = 0
        self.sensor_gaps = 0
        self._sense = sense if sense is not None else self._sense_process
        self._prev_sample: "dict | None" = None
        self._streaks: "dict[str, int]" = {}
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._lock = threading.Lock()
        self._publish_enabled()

    # -- the registry -----------------------------------------------------------

    def register(self, act: Actuator) -> Actuator:
        self.actuators[act.name] = act
        try:
            self.metrics.gauge_set("autopilot_knob", float(act.get()),
                                   help_text="the autopilot's knobs",
                                   knob=act.name)
        except Exception:   # noqa: BLE001 — a gauge must not stop wiring
            pass
        return act

    def register_plane(self, guard: PlaneGuard) -> PlaneGuard:
        self.planes.append(guard)
        return guard

    def actuate(self, name: str, target: float, reason: str,
                force: bool = False) -> bool:
        """Clamp `target` into the knob's bounds and apply it: counted,
        gauged and logged.  `force` (the debug lever) skips the cooldown
        and the deadband, never the bounds."""
        act = self.actuators.get(name)
        if act is None:
            return False
        t = self.now()
        if not force and act.last_actuated is not None and \
                t - act.last_actuated < act.cooldown:
            return False
        try:
            cur = float(act.get())
        except Exception:
            return False                    # a gap holds
        new = min(act.hi, max(act.lo, float(target)))
        if not force and abs(new - cur) <= \
                self.deadband * max(abs(cur), 1e-9):
            return False
        if new == cur:
            return False
        act.set(new)
        act.last_actuated = t
        direction = "up" if new > cur else "down"
        entry = {"t": time.time(), "knob": name, "from": cur, "to": new,
                 "direction": direction, "reason": reason}
        with self._lock:
            self.actions.append(entry)
        self.metrics.counter_add("autopilot_actions_total", 1.0,
                                 help_text="autopilot knob movements",
                                 knob=name, direction=direction)
        self.metrics.gauge_set("autopilot_knob", new, knob=name)
        profiling.flight_note("autopilot", {
            "knob": name, "from": round(cur, 6), "to": round(new, 6),
            "reason": reason})
        wlog.info("autopilot[%s] %s: %.4g -> %.4g (%s)", self.role, name,
                  cur, new, reason, component="autopilot")
        return True

    # -- sensors ----------------------------------------------------------------

    def _sense_process(self) -> dict:
        """Cumulative counters off the registry; a key the process never
        emitted is absent, and its rules hold."""
        m = self.metrics
        s: dict = {
            "hedges_issued": m.counter_sum("hedges_issued_total"),
            "hedges_won": m.counter_sum("hedges_won_total"),
            "brownout_shed": m.counter_sum("qos_rejected_total",
                                           reason="brownout"),
            "deadline_exceeded": m.counter_sum("deadline_exceeded_total"),
        }
        for cache, label in (("chunk", "filer_chunk"),
                             ("needle", "volume_needle"),
                             ("meta", "filer_meta")):
            hits = m.counter_value("read_cache_hits_total", cache=label)
            misses = m.counter_value("read_cache_misses_total", cache=label)
            if hits is None and misses is None:
                continue                    # never served: hold
            s[f"cache.{cache}.hits"] = hits or 0.0
            s[f"cache.{cache}.misses"] = misses or 0.0
            s[f"cache.{cache}.evictions"] = m.counter_value(
                "read_cache_evictions_total", cache=label) or 0.0
        g = m.gauge_value("gil_wait_ratio")
        if g is not None:
            s["gil_wait_ratio"] = g
        return s

    def _streak(self, key: str, cond: bool) -> bool:
        """`cond` for `confirm` ticks in a row; a tick without it resets
        the streak."""
        n = self._streaks.get(key, 0) + 1 if cond else 0
        self._streaks[key] = n
        return n >= self.confirm

    # -- the loop ---------------------------------------------------------------

    def start(self) -> "Autopilot":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"autopilot-{self.role}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(tick_interval()):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — a failed tick holds
                wlog.warning("autopilot tick failed: %s", e,
                             component="autopilot")

    def set_enabled(self, on: bool) -> None:
        self.enabled = bool(on)
        if not on:
            # the first tick after a gap only takes a baseline
            self._prev_sample = None
            self._streaks.clear()
        self._publish_enabled()

    def _publish_enabled(self) -> None:
        try:
            self.metrics.gauge_set(
                "autopilot_enabled", 1.0 if self.enabled else 0.0,
                help_text="1 when the SLO autopilot loop may actuate")
        except Exception:   # noqa: BLE001 — the switch works without it
            pass

    def tick(self) -> None:
        """One step: sense, diff, the rules, the planes.  Deterministic
        given `sense` and `now`."""
        self.ticks += 1
        if not enabled_by_env():
            if self.enabled:
                self.set_enabled(False)
            return
        if not self.enabled:
            return
        try:
            sample = self._sense()
        except Exception:
            sample = None
        if sample is None:
            self.sensor_gaps += 1
            self._prev_sample = None        # the next tick re-baselines
        else:
            prev, self._prev_sample = self._prev_sample, sample
            if prev is not None:
                delta = {k: sample[k] - prev[k] for k in sample
                         if k in prev and
                         isinstance(sample[k], (int, float))}
                self._rule_hedge(delta)
                self._rule_hedge_floor(delta)
                self._rule_brownout(delta)
                self._rule_caches(delta)
                self._rule_workers(sample)
        # the guards read their own counters, baseline ticks included
        self._plane_pass()

    # -- the rules --------------------------------------------------------------

    def _rule_hedge(self, d: dict) -> None:
        """A hedge that usually wins buys tail latency: earn tokens
        faster and fire earlier; one that hardly ever wins is load."""
        if "hedges_issued" not in d or "hedges_won" not in d:
            return
        issued, won = d["hedges_issued"], d["hedges_won"]
        if issued < self.MIN_HEDGE_WINDOW:
            self._streak("hedge.hi", False)
            self._streak("hedge.lo", False)
            return
        rate = won / issued
        if self._streak("hedge.hi", rate > 0.7):
            r = self.actuators.get("hedge.ratio")
            if r is not None:
                self.actuate("hedge.ratio", r.get() * 1.25,
                             f"win rate {rate:.2f} > 0.7")
            m = self.actuators.get("hedge.min_ms")
            if m is not None:
                self.actuate("hedge.min_ms", m.get() * 0.8,
                             f"win rate {rate:.2f} > 0.7")
        elif self._streak("hedge.lo", rate < 0.2):
            r = self.actuators.get("hedge.ratio")
            if r is not None:
                self.actuate("hedge.ratio", r.get() * 0.8,
                             f"win rate {rate:.2f} < 0.2")
            m = self.actuators.get("hedge.min_ms")
            if m is not None:
                self.actuate("hedge.min_ms", m.get() * 1.25,
                             f"win rate {rate:.2f} < 0.2")

    def _rule_hedge_floor(self, d: dict) -> None:
        """Deadlines blow and the hedge never fires: its floor sits above
        where it could still pay out, so halve it (a hedge that never
        issues gives the win-rate rule no evidence)."""
        blown = d.get("deadline_exceeded")
        issued = d.get("hedges_issued")
        if blown is None or issued is None:
            return
        if self._streak("hedge.floor", blown >= 3 and issued == 0):
            m = self.actuators.get("hedge.min_ms")
            if m is not None:
                self.actuate("hedge.min_ms", m.get() * 0.5,
                             f"{blown:.0f} blown deadlines, "
                             f"0 hedges issued")

    def _rule_brownout(self, d: dict) -> None:
        """Deadlines blown with nothing shed: shed earlier; sheds with no
        deadline blown: later."""
        if "brownout_shed" not in d or "deadline_exceeded" not in d:
            return
        shed, blown = d["brownout_shed"], d["deadline_exceeded"]
        act = self.actuators.get("brownout.factor")
        if act is None:
            return
        if self._streak("brownout.up", blown >= 3 and shed == 0):
            self.actuate("brownout.factor", act.get() * 1.25,
                         f"{blown:.0f} blown deadlines, 0 shed")
        elif self._streak("brownout.down", shed >= 3 and blown == 0):
            self.actuate("brownout.factor", act.get() * 0.8,
                         f"{shed:.0f} shed, 0 blown deadlines")

    def _rule_caches(self, d: dict) -> None:
        """A cache that hits well and still evicts grows; a busy one that
        almost never hits while evicting shrinks (a cold cache evicts
        nothing, and is left to warm)."""
        for cache in ("chunk", "needle", "meta"):
            name = f"cache.{cache}"
            act = self.actuators.get(name)
            if act is None:
                continue
            hits = d.get(f"cache.{cache}.hits")
            misses = d.get(f"cache.{cache}.misses")
            ev = d.get(f"cache.{cache}.evictions")
            if hits is None or misses is None:
                continue
            lookups = hits + misses
            if lookups < self.MIN_CACHE_WINDOW:
                self._streak(f"{name}.up", False)
                self._streak(f"{name}.down", False)
                continue
            ratio = hits / lookups
            if self._streak(f"{name}.up", ratio > 0.6 and (ev or 0) > 0):
                self.actuate(name, act.get() * 1.25,
                             f"hit {ratio:.2f} with {ev:.0f} evictions")
            elif self._streak(f"{name}.down",
                              ratio < 0.1 and (ev or 0) > 0):
                self.actuate(name, act.get() * 0.8,
                             f"hit {ratio:.2f} < 0.1 while evicting")

    def _rule_workers(self, sample: dict) -> None:
        """A fleet convoyed on the GIL wants a sibling, an idle one one
        fewer; only a role with a `workers` actuator is moved."""
        act = self.actuators.get("workers")
        if act is None:
            return
        ratio = sample.get("gil_wait_ratio")
        if ratio is None:
            self._streak("workers.up", False)
            self._streak("workers.down", False)
            return
        if self._streak("workers.up", ratio > 0.5):
            self.actuate("workers", act.get() + 1,
                         f"gil_wait_ratio {ratio:.2f} > 0.5")
        elif self._streak("workers.down", ratio < 0.02):
            self.actuate("workers", act.get() - 1,
                         f"gil_wait_ratio {ratio:.2f} < 0.02")

    # -- the planes -------------------------------------------------------------

    def _plane_pass(self) -> None:
        t = self.now()
        for g in self.planes:
            try:
                armed = bool(g.armed())
            except Exception:       # noqa: BLE001 — a gap: hold
                continue
            if armed:
                w = g.window()
                if w is None:
                    g._streak = 0
                    continue
                requests, errors, _fallbacks = w
                spike = errors >= g.min_errors and \
                    errors / max(requests, 1.0) >= g.trip_ratio
                g._streak = g._streak + 1 if spike else 0
                if g._streak < g.confirm:
                    if not spike and g.disarmed_by_us and g.trips and \
                            t >= g.probation_until + g.backoff:
                        # a clean probation after a re-arm: an old
                        # incident must not escalate a new one
                        g.trips = 0
                        g.disarmed_by_us = False
                    continue
                g._streak = 0
                g.trips += 1
                g.disarmed_by_us = True
                g.probation_until = t + min(
                    g.max_backoff, g.backoff * (2 ** (g.trips - 1)))
                try:
                    g.arm(False)
                except Exception:   # noqa: BLE001 — retried next tick
                    continue
                self._note_plane(g, "disarm", f"{errors:.0f} errors / "
                                              f"{requests:.0f} requests")
            elif g.disarmed_by_us and t >= g.probation_until:
                try:
                    g.arm(True)
                except Exception:   # noqa: BLE001 — refused: wait again
                    g.probation_until = t + g.backoff
                    continue
                g._prev = None              # re-baseline the window
                self._note_plane(g, "rearm", f"probation over after trip "
                                             f"#{g.trips}")

    def _note_plane(self, g: PlaneGuard, what: str, reason: str) -> None:
        entry = {"t": time.time(), "knob": f"plane.{g.name}",
                 "direction": what, "reason": reason}
        with self._lock:
            self.actions.append(entry)
        self.metrics.counter_add("autopilot_actions_total", 1.0,
                                 help_text="autopilot knob movements",
                                 knob=f"plane.{g.name}", direction=what)
        profiling.flight_note("autopilot", {"plane": g.name, "action": what,
                                            "reason": reason})
        wlog.warning("autopilot[%s] plane %s: %s (%s)", self.role, g.name,
                     what, reason, component="autopilot")

    # -- introspection ----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            actions = list(self.actions)
        return {
            "role": self.role,
            "enabled": self.enabled and enabled_by_env(),
            "ticks": self.ticks,
            "sensorGaps": self.sensor_gaps,
            "confirm": self.confirm,
            "knobs": {name: {"value": _safe(a.get), "lo": a.lo,
                             "hi": a.hi, "cooldown": a.cooldown,
                             "describe": a.describe}
                      for name, a in sorted(self.actuators.items())},
            "planes": [{"name": g.name, "armed": _safe(g.armed, bool),
                        "disarmedByAutopilot": g.disarmed_by_us,
                        "trips": g.trips,
                        "probationUntil": g.probation_until}
                       for g in self.planes],
            "actions": actions,
        }


def _safe(fn, cast=None):
    try:
        v = fn()
        return cast(v) if cast is not None else v
    except Exception:   # noqa: BLE001 — a snapshot shows a gap as null
        return None


# -- the roles -----------------------------------------------------------------

def build_for_filer(fs) -> Autopilot:
    """The filer's knobs: the hedge's ratio and floor, the brownout
    factor, the chunk and meta caches, and guards over both native
    planes.  `fs.plane_lever(name)` is the lever a guard arms with: it
    refuses to arm a plane the port stood down."""
    from . import qos
    from .util import hedge
    ap = Autopilot("filer")
    ap.register(Actuator("hedge.ratio", get=hedge.effective_ratio,
                         set=hedge.set_ratio, lo=0.02, hi=0.3,
                         describe="hedge tokens earned per primary read"))
    ap.register(Actuator("hedge.min_ms",
                         get=lambda: hedge.min_threshold() * 1e3,
                         set=hedge.set_min_threshold_ms, lo=1.0, hi=50.0,
                         describe="hedge threshold floor (ms)"))
    ap.register(Actuator("brownout.factor",
                         get=qos.effective_brownout_factor,
                         set=qos.set_brownout_factor, lo=0.5, hi=4.0,
                         describe="shed when remaining < estimate * f"))
    flr = getattr(fs, "filer", None)
    cc = getattr(flr, "chunk_cache", None)
    if cc is not None:
        ap.register(Actuator(
            "cache.chunk", get=lambda: cc.mem.limit / (1 << 20),
            set=lambda mb: cc.set_mem_limit(int(mb * (1 << 20))),
            lo=8.0, hi=512.0, describe="filer chunk-body mem cache (MB)"))
    mc = getattr(flr, "meta_cache", None)
    if mc is not None:
        ap.register(Actuator(
            "cache.meta", get=lambda: mc.capacity,
            set=lambda n: mc.set_capacity(int(n)), lo=256.0, hi=65536.0,
            describe="filer metadata cache (entries)"))
    for name, attr in (("meta", "native_meta"), ("read", "native_read")):
        plane = getattr(fs, attr, None)
        if plane is not None:
            # `armed` is a property: read it at each tick
            ap.register_plane(PlaneGuard(
                name, stats=plane.stats, arm=fs.plane_lever(plane),
                armed=lambda p=plane: p.armed))
    return ap


def build_for_volume(vs) -> Autopilot:
    """The volume server's knob: the hot-needle cache.  Not the
    brownout factor, which the filer's loop owns."""
    ap = Autopilot("volume")
    nc = getattr(vs, "needle_cache", None)
    if nc is not None:
        ap.register(Actuator(
            "cache.needle", get=lambda: nc.mem.limit / (1 << 20),
            set=lambda mb: nc.set_mem_limit(int(mb * (1 << 20))),
            lo=8.0, hi=512.0, describe="volume hot-needle mem cache (MB)"))
    return ap
