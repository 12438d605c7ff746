"""The port's debug routes (`server/debug.py`) on every role, the
observability plane they read (the flight recorder, the stage tracks,
the plane drains) and the shell's `cluster.top`, `cluster.slow` and
`cluster.profile`, on a port cluster; bad input to the levers is
refused as the JAX package refuses it.
"""

import json
import socket
import time

import pytest

from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu_torch import operation, profiling, security
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv
from seaweedfs_tpu_torch.shell.commands import run_script
from test_torch_profiling import stop_background_probes

PULSE = 0.2
GET_ROUTES = ("/debug/stacks", "/debug/vars", "/debug/profile?seconds=0.05",
              "/debug/traces?limit=5", "/debug/health", "/debug/pprof",
              "/debug/pprof?format=collapsed", "/debug/slow",
              "/debug/attribution")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_debug")
    master = MasterServer(pulse_seconds=PULSE).start()
    vs = VolumeServer([str(tmp / "v0")], device="cpu", master=master.url,
                      pulse_seconds=PULSE).start()
    deadline = time.monotonic() + 15
    while not http_json("GET", f"{master.url}/cluster/status")["dataNodes"]:
        assert time.monotonic() < deadline, "the volume server registered"
        time.sleep(0.05)
    fs = FilerServer(master.url, store_path=str(tmp / "filer.db")).start()
    try:
        yield master, vs, fs
    finally:
        fs.stop()
        vs.stop()
        master.stop()
        profiling.sampler().stop()
        profiling.flight_recorder().reset()
        stop_background_probes()


def _raw_status(url: str, method: str, path: str,
                body: bytes = b"") -> "tuple[int, bytes]":
    """A request without the port client's admin JWT."""
    host, port = url.split(":")
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(body)}\r\nConnection: close"
                  f"\r\n\r\n".encode() + body)
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


def test_every_role_serves_the_debug_routes(cluster):
    for server in cluster:
        for route in GET_ROUTES:
            st, body, _ = http_bytes("GET", f"{server.url}{route}",
                                     timeout=30)
            assert st == 200, (server.url, route, body[:200])
        # the fault and QoS levers answer on every role
        for route in ("/debug/faults", "/debug/qos"):
            assert http_bytes("GET", f"{server.url}{route}")[0] == 200
    st, body, _ = http_bytes("GET", f"{cluster[2].url}/debug/vars")
    assert json.loads(body)["threads"] > 1


def test_the_debug_routes_sit_behind_the_admin_guard(cluster):
    security.configure(security.SecurityConfig(admin_key="k" * 16))
    try:
        for server in cluster:
            for route in ("/debug/vars", "/debug/slow", "/debug/pprof"):
                st, _ = _raw_status(server.url, "GET", route)
                assert st == 401, (server.url, route)
            # the process's own calls carry the admin JWT
            st, _, _ = http_bytes("GET", f"{server.url}/debug/vars")
            assert st == 200
    finally:
        security.configure(None)


def _bad_inputs():
    return [("POST", "/debug/pprof", b"{}"),
            ("POST", "/debug/pprof", b'{"action": "start", "hz": "x"}'),
            ("POST", "/debug/pprof", b'{"action": "explode"}'),
            ("POST", "/debug/slow", b'{"clear": false}'),
            ("POST", "/debug/attribution", b"{}")]


def test_bad_lever_input_is_refused_as_the_reference_refuses_it(
        cluster, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_SCHED_PROBE", "0")
    ref = RefMaster().start()
    try:
        for method, path, body in _bad_inputs():
            port = _raw_status(cluster[0].url, method, path, body)
            assert port[0] == 400
            assert port == _raw_status(ref.url, method, path, body), path
    finally:
        ref.stop()


def test_pprof_post_round_trip(cluster):
    _m, _v, fs = cluster
    url = f"{fs.url}/debug/pprof"
    r = http_json("POST", url, {"action": "start", "hz": 250})
    assert r == {"running": True, "hz": 250.0, "started": True}
    again = http_json("POST", url, {"action": "start", "hz": 10})
    assert again["started"] is False and again["hz"] == 250.0
    deadline = time.monotonic() + 10
    while http_json("GET", f"{url}?top=2")["samples"] < 5:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    snap = http_json("GET", f"{url}?top=2")
    assert snap["running"] and len(snap["folded"]) <= 2
    st, text, hdrs = http_bytes("GET", f"{url}?format=collapsed")
    assert st == 200 and hdrs["Content-Type"] == "text/plain"
    assert text.decode().splitlines()[0].rsplit(" ", 1)[1].isdigit()
    final = http_json("POST", url, {"action": "stop"})
    assert final["running"] is False and final["samples"] >= 5
    assert http_json("POST", url, {"action": "reset"})["samples"] == 0


def test_attribution_lever_round_trip(cluster):
    url = f"{cluster[2].url}/debug/attribution"
    try:
        r = http_json("POST", url, {"disarmed": True, "scope": "plane"})
        assert r == {"disarmed": True, "scope": "plane",
                     "drainEnabled": True}
        assert profiling.cpu_sample_every() == 0
        assert not profiling.recorder_enabled()
        assert profiling.stage_timers_enabled()
        r = http_json("POST", url, {"disarmed": True, "scope": "drain"})
        assert r["drainEnabled"] is False
    finally:
        http_json("POST", url, {"disarmed": False, "scope": "drain"})
        r = http_json("POST", url, {"disarmed": False})
    assert r == {"disarmed": False, "scope": "", "drainEnabled": True}


def test_the_recorder_tracks_and_drains_run_by_default(cluster):
    """A spent budget is captured with its deadline verdict; a filer PUT
    fills the write track's stages; plane traffic is drained into the
    volume's plane_stage_seconds; cluster.slow renders the incident."""
    master, vs, fs = cluster
    profiling.flight_recorder().reset()
    st, _, _ = http_bytes("PUT", f"{fs.url}/dbg/late", b"x" * 10,
                          {"X-Weed-Deadline-Ms": "0"})
    assert st == 504
    snap = http_json("GET", f"{fs.url}/debug/slow")
    recs = [r for r in snap["records"] if r["path"] == "/dbg/late"]
    assert recs and recs[0]["verdict"] == "deadline"
    assert recs[0]["deadline"]["budgetMs"] == 0
    for i in range(6):
        st, _, _ = http_bytes("PUT", f"{fs.url}/dbg/f{i}", b"y" * 5000,
                              {"X-Weed-Deadline-Ms": "30000"})
        assert st == 201
    text = http_bytes("GET", f"{fs.url}/metrics")[1].decode()
    for stage in ("recv", "assign", "upload", "meta", "total"):
        assert f'filer_write_stage_seconds_count{{stage="{stage}"}}' \
            in text, stage
    assert "filer_write_stage_cpu_seconds" in text
    assert "filer_request_cpu_seconds" in text
    assert "seaweedfs_tpu_gil_wait_ratio" in text
    # a named needle rides the volume's Python write path and its track
    fid = operation.assign(master.url).fid
    operation.upload(vs.url, fid, b"z" * 100, name="n.bin")
    vtext = http_bytes("GET", f"{vs.url}/metrics")[1].decode()
    for stage in ("recv", "prep", "lock", "index", "append", "flush"):
        assert f'volume_server_write_stage_seconds_count{{stage="{stage}"' \
            in vtext, stage
    # plane traffic: a plain needle written and read through the planes
    fid = operation.submit(master.url, b"p" * 3000)
    assert operation.read(master.url, fid) == b"p" * 3000
    deadline = time.monotonic() + 10
    while True:
        http_json("GET", f"{vs.url}/debug/slow")     # the scrape hooks
        vtext = http_bytes("GET", f"{vs.url}/metrics")[1].decode()
        if 'plane_records_total{plane="read"}' in vtext and \
                'plane_records_total{plane="write"}' in vtext:
            break
        assert time.monotonic() < deadline, "the planes were not drained"
        time.sleep(0.05)
    assert 'plane_stage_seconds_count{plane="write",stage="append"}' \
        in vtext
    out = run_script(CommandEnv(master.url, filer=fs.url),
                     "cluster.slow -verdict=deadline -top=3")[0]
    assert "verdict=deadline" in out and "/dbg/late" in out
    assert "deadline=0ms" in out


def test_cluster_views_render_and_skip_an_unreachable_node(cluster):
    master, vs, fs = cluster
    env = CommandEnv(master.url, filer=fs.url)
    dead = "127.0.0.1:1"
    top = run_script(env, f"cluster.top -interval=0.3 -nodes={dead}")[0]
    assert top.startswith("cluster.top — 4 nodes")
    assert f"{dead}: unreachable" in top
    for server, ns in ((master, "master"), (vs, "volume_server"),
                       (fs, "filer")):
        assert f"{server.url} [{ns}]" in top
    assert "tree=" in top and "gil-wait=" in top
    slow = run_script(env, f"cluster.slow -top=2 -nodes={dead}")[0]
    assert slow.startswith("cluster.slow — ")
    assert f"{dead}: scrape failed, skipped" in slow
    prof = run_script(
        env, f"cluster.profile -duration=0.3 -hz=200 -top=5 "
             f"-nodes={dead}")[0]
    assert prof.startswith("cluster.profile — 0.3s @ 200Hz, 3/4 nodes")
    assert f"{dead}: unreachable" in prof
    assert not profiling.sampler().running
    cleared = run_script(env, f"cluster.slow -clear -nodes={dead}")[0]
    assert cleared.startswith("cluster.slow — cleared 3/4 rings")
