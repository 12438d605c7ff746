"""The port's SLO autopilot (autopilot.py) against the JAX package's, on
the CPU.

- The same stream through both: each unit test of `tests/test_autopilot.py`
  (the bounds, the forced lever, the cooldown, the hysteresis, the kill
  switches, the sensor gap, the diurnal swing, the overload, the hedge
  floor, the cold cache, the workers, the plane guard's trip, probation
  and gaps) is a scripted sensor stream fed to the JAX `Autopilot` and
  to the port's, with the same actuators on a pinned clock; the action
  logs (knob, from, to, direction, reason) must be equal tick by tick,
  and the JAX test's assertions hold on the port.  Tolerance: exact.
- A port trio (master, volume server, filer) in process: the debug
  lever, the exported metrics, a real meta plane disarmed and re-armed,
  and a real read plane tripped by reads whose volume server is stopped.
- The port's own checks: a plane that the port stands down (a
  `[qos.default]` limit, `[tls]`) is never re-armed by probation; the
  guard reads the error keys the port's planes really have; the fleet's
  `workers` knob and its monitor share one lock; `SEAWEEDFS_TPU_AUTOPILOT=0`
  holds a server's loop.
"""

import os
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from seaweedfs_tpu import autopilot as ref_autopilot
from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu_torch import autopilot, qos, stats
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.util import hedge
from test_torch_profiling import stop_background_probes

REF = SimpleNamespace(Autopilot=ref_autopilot.Autopilot,
                      Actuator=ref_autopilot.Actuator,
                      PlaneGuard=ref_autopilot.PlaneGuard,
                      Metrics=ref_stats.Metrics)
PORT = SimpleNamespace(Autopilot=autopilot.Autopilot,
                       Actuator=autopilot.Actuator,
                       PlaneGuard=autopilot.PlaneGuard,
                       Metrics=stats.Metrics)


@pytest.fixture(autouse=True)
def baseline_knobs():
    """The hedge's and the brownout's overrides are process-global: each
    test starts and ends at the environment's baseline."""
    hedge.reset()
    qos.reset()
    yield
    hedge.reset()
    qos.reset()


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Knob:
    def __init__(self, value: float):
        self.value = float(value)
        self.sets = 0

    def get(self) -> float:
        return self.value

    def set(self, v: float) -> None:
        self.value = float(v)
        self.sets += 1


class Run:
    """One package's autopilot over a scripted sensor dict, a pinned
    clock, and the action log recorded a step at a time."""

    def __init__(self, pkg, sample: dict, confirm: int = 2, sense=None):
        self.pkg = pkg
        self.clock = Clock()
        self.sample = sample
        self.ap = pkg.Autopilot(
            "test", metrics=pkg.Metrics("aptest"),
            sense=sense or (lambda: dict(self.sample)), now=self.clock,
            confirm=confirm)
        self.trace: "list[list[dict]]" = []
        self._seen = 0

    def knob(self, name: str, value: float, lo: float, hi: float,
             cooldown: float = 0.0) -> Knob:
        k = Knob(value)
        self.ap.register(self.pkg.Actuator(name, k.get, k.set, lo=lo,
                                           hi=hi, cooldown=cooldown))
        return k

    def mark(self) -> None:
        acts = list(self.ap.actions)
        self.trace.append([{k: v for k, v in a.items() if k != "t"}
                           for a in acts[self._seen:]])
        self._seen = len(acts)

    def tick(self, dt: float = 10.0) -> None:
        self.clock.advance(dt)
        self.ap.tick()
        self.mark()


class ScriptedPlane:
    def __init__(self):
        self.counters = {"requests": 0.0, "fallbacks": 0.0,
                         "upstream_errors": 0.0, "wal_errors": 0.0}
        self._armed = True
        self.arm_calls: "list[bool]" = []

    def stats(self) -> dict:
        return dict(self.counters)

    def arm(self, on: bool) -> None:
        self._armed = on
        self.arm_calls.append(on)

    def armed(self) -> bool:
        return self._armed


# -- the scenarios: each unit test of tests/test_autopilot.py -------------

def sc_bounds(pkg):
    r = Run(pkg, {})
    k = r.knob("k", 10.0, 1.0, 20.0)
    assert r.ap.actuate("k", 100.0, "test") and k.value == 20.0
    assert not r.ap.actuate("k", 200.0, "test")
    assert k.value == 20.0 and k.sets == 1
    assert r.ap.actuate("k", -5.0, "test") and k.value == 1.0
    r.mark()
    return r.trace


def sc_force(pkg):
    r = Run(pkg, {})
    k = r.knob("k", 10.0, 1.0, 20.0, cooldown=1e9)
    assert r.ap.actuate("k", 12.0, "first", force=True)
    assert r.ap.actuate("k", 500.0, "lever", force=True)
    assert k.value == 20.0
    r.mark()
    return r.trace


def sc_unknown(pkg):
    r = Run(pkg, {})
    assert not r.ap.actuate("nope", 1.0, "test")
    r.mark()
    return r.trace


def sc_cooldown(pkg):
    r = Run(pkg, {})
    k = r.knob("k", 10.0, 0.0, 100.0, cooldown=5.0)
    assert r.ap.actuate("k", 12.0, "test")
    r.clock.advance(1.0)
    assert not r.ap.actuate("k", 14.0, "test") and k.value == 12.0
    r.clock.advance(5.0)
    assert r.ap.actuate("k", 14.0, "test")
    r.mark()
    return r.trace


def sc_flapping(pkg):
    r = Run(pkg, {"brownout_shed": 0.0, "deadline_exceeded": 0.0})
    k = r.knob("brownout.factor", 1.0, 0.5, 4.0)
    r.tick()
    for i in range(10):
        r.sample["deadline_exceeded"] += 5.0 if i % 2 == 0 else 0.0
        r.tick()
    assert k.sets == 0 and k.value == 1.0
    return r.trace


def sc_sustained(pkg):
    r = Run(pkg, {"brownout_shed": 0.0, "deadline_exceeded": 0.0},
            confirm=3)
    k = r.knob("brownout.factor", 1.0, 0.5, 4.0)
    r.tick()
    for _ in range(2):
        r.sample["deadline_exceeded"] += 5.0
        r.tick()
    assert k.sets == 0
    r.sample["deadline_exceeded"] += 5.0
    r.tick()
    assert k.sets == 1 and k.value == pytest.approx(1.25)
    return r.trace


def sc_env_kill(pkg):
    os.environ["SEAWEEDFS_TPU_AUTOPILOT"] = "0"
    try:
        r = Run(pkg, {"brownout_shed": 0.0, "deadline_exceeded": 0.0})
        k = r.knob("brownout.factor", 1.0, 0.5, 4.0)
        for _ in range(6):
            r.sample["deadline_exceeded"] += 10.0
            r.tick()
        assert k.sets == 0
        assert r.ap.snapshot()["enabled"] is False
    finally:
        del os.environ["SEAWEEDFS_TPU_AUTOPILOT"]
    return r.trace


def sc_runtime_disable(pkg):
    r = Run(pkg, {"brownout_shed": 0.0, "deadline_exceeded": 0.0})
    k = r.knob("brownout.factor", 1.0, 0.5, 4.0)
    r.tick()
    r.ap.set_enabled(False)
    for _ in range(5):
        r.sample["deadline_exceeded"] += 10.0
        r.tick()
    assert k.sets == 0
    r.ap.set_enabled(True)
    r.tick()
    assert k.sets == 0
    r.sample["deadline_exceeded"] += 5.0
    r.tick()
    assert k.sets == 0
    r.sample["deadline_exceeded"] += 5.0
    r.tick()
    assert k.sets == 1
    return r.trace


def sc_sensor_gap(pkg):
    state = {"fail": False,
             "sample": {"brownout_shed": 0.0, "deadline_exceeded": 0.0}}

    def sense():
        if state["fail"]:
            raise OSError("scrape failed")
        return dict(state["sample"])
    r = Run(pkg, {}, confirm=1, sense=sense)
    k = r.knob("brownout.factor", 1.0, 0.5, 4.0)
    r.tick()
    state["fail"] = True
    state["sample"]["deadline_exceeded"] += 50.0
    r.tick()
    assert r.ap.sensor_gaps == 1 and k.sets == 0
    state["fail"] = False
    r.tick()
    assert k.sets == 0
    state["sample"]["deadline_exceeded"] += 5.0
    r.tick()
    assert k.sets == 1
    return r.trace


def sc_missing_key(pkg):
    r = Run(pkg, {"gil_wait_ratio": 0.9}, confirm=1)
    k = r.knob("hedge.ratio", 0.1, 0.02, 0.3)
    for _ in range(4):
        r.tick()
    assert k.sets == 0
    return r.trace


def sc_diurnal(pkg):
    r = Run(pkg, {"hedges_issued": 0.0, "hedges_won": 0.0})
    ratio = r.knob("hedge.ratio", 0.1, 0.02, 0.3)
    r.tick()
    for _ in range(8):
        r.sample["hedges_issued"] += 10.0
        r.sample["hedges_won"] += 9.0
        r.tick()
    ramp = ratio.sets
    assert ramp > 0 and 0.02 <= ratio.value <= 0.3
    for _ in range(8):
        r.sample["hedges_issued"] += 10.0
        r.sample["hedges_won"] += 5.0
        r.tick()
    assert ratio.sets == ramp
    for _ in range(8):
        r.tick()
    assert ratio.sets == ramp and 0.02 <= ratio.value <= 0.3
    return r.trace


def sc_overload(pkg):
    r = Run(pkg, {"brownout_shed": 0.0, "deadline_exceeded": 0.0})
    f = r.knob("brownout.factor", 1.0, 0.5, 4.0)
    r.tick()
    for _ in range(30):
        r.sample["deadline_exceeded"] += 10.0
        r.tick()
    assert f.value == 4.0
    at_hi = f.sets
    for _ in range(5):
        r.sample["deadline_exceeded"] += 10.0
        r.tick()
    assert f.sets == at_hi
    for _ in range(30):
        r.sample["brownout_shed"] += 10.0
        r.tick()
    assert f.value == 0.5
    return r.trace


def sc_hedge_floor(pkg):
    r = Run(pkg, {"hedges_issued": 0.0, "hedges_won": 0.0,
                  "deadline_exceeded": 0.0})
    floor = r.knob("hedge.min_ms", 400.0, 1.0, 50.0)
    r.tick()
    for _ in range(2):
        r.sample["deadline_exceeded"] += 5.0
        r.tick()
    assert floor.value == 50.0
    for _ in range(4):
        r.sample["deadline_exceeded"] += 5.0
        r.tick()
    assert 1.0 <= floor.value < 50.0
    sets = floor.sets
    for _ in range(4):
        r.sample["deadline_exceeded"] += 5.0
        r.sample["hedges_issued"] += 2.0
        r.tick()
    assert floor.sets == sets
    return r.trace


def sc_cold_cache(pkg):
    keys = {"cache.chunk.hits": 0.0, "cache.chunk.misses": 0.0,
            "cache.chunk.evictions": 0.0}
    r = Run(pkg, dict(keys))
    mb = r.knob("cache.chunk", 64.0, 8.0, 512.0)
    r.tick()
    for _ in range(6):
        r.sample["cache.chunk.misses"] += 100.0
        r.tick()
    assert mb.sets == 0 and mb.value == 64.0
    for _ in range(3):
        r.sample["cache.chunk.hits"] += 90.0
        r.sample["cache.chunk.misses"] += 10.0
        r.sample["cache.chunk.evictions"] += 5.0
        r.tick()
    assert mb.value > 64.0
    r2 = Run(pkg, dict(keys))
    mb2 = r2.knob("cache.chunk", 64.0, 8.0, 512.0)
    r2.tick()
    for _ in range(3):
        r2.sample["cache.chunk.hits"] += 2.0
        r2.sample["cache.chunk.misses"] += 98.0
        r2.sample["cache.chunk.evictions"] += 50.0
        r2.tick()
    assert mb2.value < 64.0
    return r.trace + r2.trace


def sc_workers(pkg):
    r = Run(pkg, {"gil_wait_ratio": 0.0})
    w = r.knob("workers", 2.0, 1.0, 4.0)
    r.tick()
    r.sample["gil_wait_ratio"] = 0.8
    for _ in range(2):
        r.tick()
    assert w.value == 3.0
    r.sample["gil_wait_ratio"] = 0.0
    for _ in range(2):
        r.tick()
    assert w.value == 2.0
    del r.sample["gil_wait_ratio"]
    sets = w.sets
    for _ in range(4):
        r.tick()
    assert w.sets == sets
    return r.trace


def sc_plane_spike(pkg):
    r = Run(pkg, {})
    p = ScriptedPlane()
    g = r.ap.register_plane(pkg.PlaneGuard(
        "meta", stats=p.stats, arm=p.arm, armed=p.armed, min_errors=5,
        trip_ratio=0.5, backoff=30.0))
    r.tick()
    p.counters["requests"] += 100.0
    r.tick()
    assert p.armed()
    p.counters["requests"] += 20.0
    p.counters["upstream_errors"] += 18.0
    r.tick()
    assert not p.armed() and p.arm_calls == [False]
    assert g.disarmed_by_us and g.trips == 1
    r.clock.advance(5.0)
    r.ap.tick()
    r.mark()
    assert not p.armed()
    r.clock.advance(40.0)
    r.ap.tick()
    r.mark()
    assert p.armed() and p.arm_calls == [False, True]
    for _ in range(2):
        p.counters["requests"] += 20.0
        p.counters["upstream_errors"] += 18.0
        r.tick(dt=1.0)
    assert not p.armed() and g.trips == 2
    assert g.probation_until - r.clock.t == pytest.approx(60.0)
    return r.trace


def sc_operator_disarm(pkg):
    r = Run(pkg, {})
    p = ScriptedPlane()
    r.ap.register_plane(pkg.PlaneGuard("meta", stats=p.stats, arm=p.arm,
                                       armed=p.armed, backoff=0.0))
    r.tick()
    p.arm(False)
    p.arm_calls.clear()
    for _ in range(5):
        r.tick(dt=100.0)
    assert p.arm_calls == [] and not p.armed()
    return r.trace


def sc_plane_gap(pkg):
    r = Run(pkg, {})
    calls = []

    def broken():
        calls.append(1)
        raise OSError("plane stats unreachable")
    p = ScriptedPlane()
    r.ap.register_plane(pkg.PlaneGuard("meta", stats=broken, arm=p.arm,
                                       armed=p.armed))
    for _ in range(4):
        r.tick()
    assert p.arm_calls == [] and p.armed() and calls
    return r.trace


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_bounds, sc_force, sc_unknown, sc_cooldown, sc_flapping,
    sc_sustained, sc_env_kill, sc_runtime_disable, sc_sensor_gap,
    sc_missing_key, sc_diurnal, sc_overload, sc_hedge_floor, sc_cold_cache,
    sc_workers, sc_plane_spike, sc_operator_disarm, sc_plane_gap)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_stream_same_actions_as_the_jax_autopilot(name):
    want = SCENARIOS[name](REF)
    got = SCENARIOS[name](PORT)
    assert got == want
    assert len(got) >= 1


def test_the_scenarios_move_knobs():
    """The comparison is not vacuous: the streams move knobs and planes
    in both directions."""
    moved = [a for name in SCENARIOS for step in SCENARIOS[name](PORT)
             for a in step]
    assert {a["direction"] for a in moved} >= {"up", "down", "disarm",
                                                "rearm"}


# -- the port trio ------------------------------------------------------------

@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    d = tmp_path_factory.mktemp("aptrio")
    m = MasterServer(volume_size_limit_mb=32).start()
    v = VolumeServer([str(d / "v")], device="cpu", master=m.url,
                     pulse_seconds=0.2).start()
    deadline = time.monotonic() + 10
    while not m.topology.alive_nodes() and time.monotonic() < deadline:
        time.sleep(0.02)
    f = FilerServer(m.url, store_path=str(d / "filer.db")).start()
    ns = SimpleNamespace(m=m, v=v, f=f, dir=d)
    yield ns
    f.stop()
    ns.v.stop()           # a test may have restarted the server
    m.stop()
    stop_background_probes()


def test_debug_autopilot_lever_roundtrip(trio):
    f = trio.f
    snap = http_json("GET", f"{f.url}/debug/autopilot", timeout=10)
    assert snap["role"] == "filer" and snap["enabled"] is True
    assert {"hedge.ratio", "hedge.min_ms", "brownout.factor", "cache.chunk",
            "cache.meta"} <= set(snap["knobs"])
    assert {p["name"] for p in snap["planes"]} == {"meta", "read"}
    for k in snap["knobs"].values():
        assert k["lo"] <= k["hi"]
    vol = http_json("GET", f"{trio.v.url}/debug/autopilot", timeout=10)
    assert vol["role"] == "volume" and set(vol["knobs"]) == {"cache.needle"}
    # the loops tick on their own
    t0 = snap["ticks"]
    deadline = time.monotonic() + 10
    while http_json("GET", f"{f.url}/debug/autopilot",
                    timeout=10)["ticks"] <= t0:
        assert time.monotonic() < deadline, "the filer's loop never ticked"
        time.sleep(0.1)
    off = http_json("POST", f"{f.url}/debug/autopilot", {"enabled": False},
                    timeout=10)
    assert off["enabled"] is False
    r = http_json("POST", f"{f.url}/debug/autopilot",
                  {"knob": "brownout.factor", "value": 99.0}, timeout=10)
    got = r["knobs"]["brownout.factor"]
    assert got["value"] == got["hi"] == qos.effective_brownout_factor()
    assert any(a["knob"] == "brownout.factor" for a in r["actions"])
    r = http_json("POST", f"{f.url}/debug/autopilot",
                  {"knob": "hedge.ratio", "value": 0.2}, timeout=10)
    assert hedge.effective_ratio() == pytest.approx(0.2)
    r = http_json("POST", f"{f.url}/debug/autopilot",
                  {"knob": "cache.chunk", "value": 16}, timeout=10)
    assert trio.f.filer.chunk_cache.mem.limit == 16 << 20
    r = http_json("POST", f"{f.url}/debug/autopilot",
                  {"knob": "cache.meta", "value": 300}, timeout=10)
    assert trio.f.filer.meta_cache.capacity == 300
    r = http_json("POST", f"{trio.v.url}/debug/autopilot",
                  {"knob": "cache.needle", "value": 9}, timeout=10)
    assert trio.v.needle_cache.mem.limit == 9 << 20
    assert "error" in http_json("POST", f"{f.url}/debug/autopilot",
                                {"knob": "not.a.knob", "value": 1.0},
                                timeout=10)
    on = http_json("POST", f"{f.url}/debug/autopilot", {"enabled": True},
                   timeout=10)
    assert on["enabled"] is True
    # back to the baseline, for the tests after
    hedge.reset()
    qos.reset()
    assert hedge.effective_ratio() == pytest.approx(0.1)
    assert qos.effective_brownout_factor() == 1.0


def test_autopilot_metrics_exported(trio):
    cap = trio.f.filer.meta_cache.capacity
    r = http_json("POST", f"{trio.f.url}/debug/autopilot",
                  {"knob": "cache.meta", "value": cap + 64}, timeout=10)
    assert r["knobs"]["cache.meta"]["value"] == cap + 64
    st, body, _ = http_bytes("GET", f"{trio.f.url}/metrics", timeout=10)
    assert st == 200
    text = body.decode()
    assert "seaweedfs_tpu_autopilot_enabled 1" in text
    assert 'seaweedfs_tpu_autopilot_knob{knob="hedge.ratio"}' in text
    assert "seaweedfs_tpu_autopilot_actions_total" in text


def _spiked_guard(f, name: str):
    guard = next(g for g in f.autopilot.planes if g.name == name)
    real = guard.stats
    inject = {"upstream_errors": 0.0, "requests": 0.0}

    def spiked():
        s = dict(real())
        for k, v in inject.items():
            s[k] = s.get(k, 0) + v
        return s
    guard.stats = spiked
    return guard, real, inject


def test_real_meta_plane_disarms_on_error_spike_and_rearms(trio):
    f = trio.f
    nm = f.native_meta
    assert nm is not None, "the native meta plane did not start"
    ap = f.autopilot
    guard, real, inject = _spiked_guard(f, "meta")
    guard.backoff = 1.5
    try:
        ap.tick()
        inject["requests"] += 20.0
        inject["upstream_errors"] += 18.0
        deadline = time.monotonic() + 10.0
        while nm.armed and time.monotonic() < deadline:
            ap.tick()
            time.sleep(0.02)
        assert not nm.armed, "the guard never disarmed the plane"
        st = http_json("GET", f"{f.url}/status", timeout=10)
        assert st.get("metaPlanePort", 0) == 0
        deadline = time.monotonic() + 10.0
        while not nm.armed and time.monotonic() < deadline:
            time.sleep(0.05)
            ap.tick()
        assert nm.armed, "the guard never re-armed after probation"
        assert http_json("GET", f"{f.url}/status",
                         timeout=10).get("metaPlanePort", 0) != 0
    finally:
        guard.stats = real
        guard.backoff = 10.0
        if not nm.armed:
            nm.arm(True)


def test_probation_never_rearms_a_plane_the_port_stands_down(
        trio, monkeypatch):
    """A guard that disarmed the read plane, then a `[qos.default]`
    limit (and, alone, `[tls]`): probation passes, the lever refuses,
    and the plane stays down until the stand-down ends."""
    from seaweedfs_tpu_torch.server import filer_server
    f = trio.f
    nr = f.native_read
    assert nr is not None, "the native read plane did not start"
    ap = f.autopilot
    guard, real, inject = _spiked_guard(f, "read")
    guard.backoff = 0.2
    try:
        ap.tick()
        inject["requests"] += 20.0
        inject["upstream_errors"] += 18.0
        deadline = time.monotonic() + 10.0
        while nr.armed and time.monotonic() < deadline:
            ap.tick()
            time.sleep(0.02)
        assert not nr.armed and guard.disarmed_by_us
        inject["upstream_errors"] = inject["requests"] = 0.0
        for stand_down in ("qos", "tls"):
            if stand_down == "qos":
                qos.configure(qos.QosConfig(
                    enabled=True, default=qos.TenantLimit(rps=1.0,
                                                          burst=1.0)))
            else:
                qos.reset()
                # `[tls]`, as the filer's module sees the configuration
                monkeypatch.setattr(filer_server, "security", SimpleNamespace(
                    current=lambda: SimpleNamespace(tls=object())))
            assert f.planes_stood_down() == stand_down
            for _ in range(5):
                time.sleep(0.25)
                ap.tick()
                assert not nr.armed, f"re-armed under {stand_down}"
            assert http_json("GET", f"{f.url}/status", timeout=10).get(
                "readPlanePort", 0) == 0
        monkeypatch.undo()
        assert f.planes_stood_down() is None
        deadline = time.monotonic() + 10.0
        while not nr.armed and time.monotonic() < deadline:
            time.sleep(0.05)
            ap.tick()
        assert nr.armed, "never re-armed once the stand-down ended"
    finally:
        qos.reset()
        guard.stats = real
        guard.backoff = 10.0
        if not nr.armed:
            nr.arm(True)


def test_guard_keys_are_the_port_planes_stats_keys():
    """A guard reading keys the planes do not have never trips."""
    from seaweedfs_tpu_torch.server import (filer_read_plane_native,
                                            meta_plane_native)
    errors = set(autopilot.PlaneGuard._ERROR_KEYS)
    for mod in (meta_plane_native, filer_read_plane_native):
        keys = set(mod.STATS_KEYS)
        assert {"requests", "fallbacks"} <= keys
        assert errors & keys, mod.__name__


def test_real_read_plane_trips_on_a_stopped_volume_server(trio):
    """Reads through the read plane of a file whose only volume server
    is stopped count `upstream_errors`; the guard disarms the plane; with
    the server back and probation over it re-arms, and reads come
    through the plane again."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    f, m = trio.f, trio.m
    nr = f.native_read
    assert nr is not None
    ap = f.autopilot
    guard = next(g for g in ap.planes if g.name == "read")
    guard.backoff = 1.0
    body = os.urandom(1024)
    st, _, _ = http_bytes("PUT", f"{f.url}/ap/one.bin", body, timeout=10)
    assert st in (200, 201)
    port = http_json("GET", f"{f.url}/status", timeout=10)["readPlanePort"]
    plane = f"127.0.0.1:{port}/ap/one.bin"

    def plane_get():
        return http_bytes("GET", plane, timeout=10)

    def plane_serves() -> bool:
        # the Python front's GET fills the plane's entry
        http_bytes("GET", f"{f.url}/ap/one.bin", timeout=10)
        st, got, _ = plane_get()
        return st == 200 and got == body

    deadline = time.monotonic() + 10
    while not plane_serves():
        assert time.monotonic() < deadline, "the plane never served"
        time.sleep(0.05)
    trio.v.stop()
    try:
        ap.tick()                  # the guard's baseline
        codes = [plane_get()[0] for _ in range(12)]
        assert codes.count(404) == 12
        assert nr.stats()["upstream_errors"] >= 12
        ap.tick()
        assert not nr.armed, "a real error spike did not trip the guard"
        assert any(a["knob"] == "plane.read" and a["direction"] == "disarm"
                   for a in ap.snapshot()["actions"])
    finally:
        trio.v = VolumeServer([str(trio.dir / "v")], device="cpu",
                              master=m.url, pulse_seconds=0.2).start()
    deadline = time.monotonic() + 15
    while not nr.armed:
        assert time.monotonic() < deadline, "never re-armed"
        time.sleep(0.1)
        ap.tick()
    # the Python front's GET refills the plane with the server's new
    # address (its old /status is dropped with the stale registration);
    # the restarted server's read plane learns the needle from a GET on
    # its own port, as a client's replay of a plane 404 does
    fid = f.filer.find_entry("/ap/one.bin").chunks[0].file_id
    deadline = time.monotonic() + 15
    while not plane_serves():
        assert time.monotonic() < deadline, "the plane never served again"
        http_bytes("GET", f"{trio.v.url}/{fid}", timeout=10)
        time.sleep(0.1)
    guard.backoff = 10.0


# -- the fleet's workers knob and its monitor -------------------------------

def test_workers_knob_and_monitor_share_one_lock():
    from seaweedfs_tpu_torch.__main__ import _Fleet
    fl = _Fleet([sys.executable, "-c", "import time; time.sleep(120)"], 2)
    ap = autopilot.Autopilot("filer", metrics=stats.Metrics("aptest"))
    fl.start()
    try:
        fl.register_knob(ap)
        act = ap.actuators["workers"]
        assert (act.lo, act.hi, act.cooldown) == (1.0, 4.0, 30.0)
        assert act.get() == 2.0
        # the cooldown runs from the start: an idle fleet at boot keeps
        # the -workers its operator asked for
        assert not ap.actuate("workers", 1.0, "idle at boot")
        assert act.get() == 2.0
        done = []
        with fl.lock:
            t1 = threading.Thread(target=lambda: done.append(
                ap.actuate("workers", 3.0, "test", force=True)))
            t2 = threading.Thread(target=lambda: done.append(
                fl.monitor_once()))
            t1.start()
            t2.start()
            time.sleep(0.3)
            assert done == [], "the knob or the monitor ran without the lock"
        t1.join(10)
        t2.join(10)
        assert len(done) == 2 and fl.size() == 3.0
        # a drained sibling is never respawned by the monitor
        assert ap.actuate("workers", 1.0, "test", force=True)
        drained = [p for p in fl.procs if p.pid in fl.drained]
        assert len(drained) == 2
        for p in drained:
            p.wait(timeout=10)
        fl.monitor_once()
        assert fl.size() == 1.0 and fl.respawns == 0
    finally:
        fl.stop()
    assert all(p.poll() is not None for p in fl.procs)


def test_env_kill_switch_holds_a_servers_loop(tmp_path, monkeypatch):
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    monkeypatch.setenv("SEAWEEDFS_TPU_AUTOPILOT", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_AUTOPILOT_TICK_MS", "50")
    v = VolumeServer([str(tmp_path)], device="cpu").start()
    try:
        time.sleep(0.3)
        snap = http_json("GET", f"{v.url}/debug/autopilot", timeout=10)
        assert snap["enabled"] is False and snap["ticks"] == 0
        assert v.autopilot._thread is None
    finally:
        v.stop()
        stop_background_probes()
