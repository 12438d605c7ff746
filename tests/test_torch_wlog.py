"""The port's log (`seaweedfs_tpu_torch/util/wlog.py`) and request id
(`util/request_id.py`) on the CPU, against the JAX package's.
Tolerance: exact equality of every line once its clock is fixed.

- the same calls (each severity, `v` and `V` at and past the
  verbosity, `exception`, `fatal`, a component, arguments, a request id)
  give the same text lines and the same JSON lines from both packages,
  and the `V` gates answer alike;
- `set_output` rotates at `max_bytes` into the same files, keeping
  `backups` of them;
- a line logged inside a request carries the request id that the span
  records as its trace id and the answer echoes in `X-Request-ID`,
  whether the caller sent one or the server minted it, on either
  package's HTTP server;
- `-v 2 -logdir D -logJson master` on both packages writes `D/weed.log`
  of JSON lines with the same keys, the `env override` line among them.
"""

import json
import logging
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from seaweedfs_tpu import tracing as ref_tracing
from seaweedfs_tpu.server import httpd as ref_httpd
from seaweedfs_tpu.util import request_id as ref_request_id
from seaweedfs_tpu.util import wlog as ref_wlog
from seaweedfs_tpu_torch import tracing
from seaweedfs_tpu_torch.server import httpd
from seaweedfs_tpu_torch.util import request_id, wlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED = 1_760_000_123.456789        # the clock every captured line shows
PACKAGES = {"port": (wlog, request_id), "ref": (ref_wlog, ref_request_id)}


class _Capture(logging.Handler):
    """The lines one package's logger writes, each formatted by that
    package's own formatter at the fixed clock."""

    def __init__(self, mod):
        super().__init__()
        self.lines: list = []
        self.setFormatter(mod._Formatter())

    def emit(self, record):
        record.created = FIXED
        self.lines.append(self.format(record))


@pytest.fixture
def captured():
    """A capture handler on each package's logger; the verbosity, the
    format, the sinks and the request id put back afterwards."""
    caps = {}
    saved = {}
    for name, (mod, rid) in PACKAGES.items():
        saved[name] = (mod.get_verbosity(), mod._json,
                       rid.set_request_id(""))
        caps[name] = _Capture(mod)
        mod._logger.addHandler(caps[name])
    yield caps
    for name, (mod, rid) in PACKAGES.items():
        mod._logger.removeHandler(caps[name])
        v, js, token = saved[name]
        mod.set_verbosity(v)
        mod.json_format(js)
        rid.reset_request_id(token)
        if mod._file_handler is not None:
            mod._logger.removeHandler(mod._file_handler)
            mod._file_handler.close()
            mod._file_handler = None
        if mod._stderr_handler not in mod._logger.handlers:
            mod._logger.addHandler(mod._stderr_handler)


def _calls(mod, rid) -> dict:
    """The same calls on one package; what its V gates answered."""
    mod.set_verbosity(2)
    mod.info("plain %s %d", "x", 3)
    mod.warning("a warning", component="volume")
    mod.error("an error %r", {"a": 1}, component="filer")
    mod.v(1, "v1 at verbosity 2")
    mod.v(3, "v3 is not logged")
    mod.V(2).info("gated %s", "in", component="gate")
    mod.V(3).info("gated out")
    try:
        raise ValueError("boom")
    except ValueError:
        mod.exception("caught %s", "it", component="x")
    token = rid.set_request_id("rid-0123")
    mod.info("inside a request", component="s3")
    rid.reset_request_id(token)
    with pytest.raises(SystemExit) as e:
        mod.fatal("the end")
    return {"gates": [bool(mod.V(n)) for n in range(5)],
            "verbosity": mod.get_verbosity(), "exit": e.value.code}


@pytest.mark.parametrize("as_json", [False, True])
def test_the_same_calls_give_the_same_lines(captured, as_json):
    got = {}
    for name, (mod, rid) in PACKAGES.items():
        mod.json_format(as_json)
        got[name] = _calls(mod, rid)
    assert got["port"] == got["ref"] == {
        "gates": [True, True, True, False, False], "verbosity": 2,
        "exit": 255}
    assert captured["port"].lines == captured["ref"].lines
    lines = captured["port"].lines
    assert len(lines) == 8
    if as_json:
        docs = [json.loads(ln) for ln in lines]
        assert [d["severity"] for d in docs] == [
            "INFO", "WARNING", "ERROR", "INFO", "INFO", "ERROR", "INFO",
            "CRITICAL"]
        assert [d.get("requestId") for d in docs] == \
            [None] * 6 + ["rid-0123", None]
        assert docs[5]["message"].startswith("caught it\nTraceback")
    else:
        assert re.fullmatch(r"I\d{4} \d\d:\d\d:\d\d\.456789 "
                            r"wlog\] plain x 3", lines[0])
        assert lines[1].endswith(" volume] a warning")
        assert lines[6].endswith(" s3] inside a request rid=rid-0123")
        assert lines[7].startswith("C") and lines[7].endswith("the end")


def test_verbosity_comes_from_weed_v():
    code = ("import sys; sys.path.insert(0, {!r}); "
            "from {} import wlog; print(wlog.get_verbosity(), "
            "bool(wlog.V(3)), bool(wlog.V(4)))")
    outs = [subprocess.run(
        [sys.executable, "-c", code.format(REPO, pkg)],
        env={**os.environ, "WEED_V": "3", "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=60).stdout
        for pkg in ("seaweedfs_tpu_torch.util", "seaweedfs_tpu.util")]
    assert outs[0] == outs[1] == "3 True False\n"


def _strip_clock(text: str) -> str:
    return re.sub(r"^[IWEC]\d{4} \d\d:\d\d:\d\d\.\d{6} ", "", text,
                  flags=re.M)


def test_rotation_at_max_bytes(captured, tmp_path):
    files = {}
    for name, (mod, _) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        mod.set_output(str(d / "weed.log"), max_bytes=400, backups=2,
                       also_stderr=False)
        for i in range(40):
            mod.info("line %02d of the rotation test", i, component="rot")
        mod._file_handler.close()
        files[name] = {f: _strip_clock(open(d / f).read())
                       for f in sorted(os.listdir(d))}
    assert files["port"] == files["ref"]
    assert sorted(files["port"]) == ["weed.log", "weed.log.1",
                                     "weed.log.2"]
    for f in files["port"].values():
        assert 0 < len(f) <= 400
    # the newest lines are in weed.log, the oldest kept in weed.log.2
    assert "line 39" in files["port"]["weed.log"]
    assert "line 00" not in "".join(files["port"].values())


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("sent", [True, False])
def test_the_request_id_on_a_line_is_the_spans_and_the_answers(
        captured, pkg, sent):
    mod, _ = PACKAGES[pkg]
    http, tr = (httpd, tracing) if pkg == "port" else (ref_httpd,
                                                       ref_tracing)
    mod.json_format(True)
    srv = http.HttpServer()

    def handle(req):
        mod.warning("handling %s", req.path, component="test")
        return 200, {"ok": True}
    srv.route("GET", "/x", handle)
    srv.start()
    try:
        headers = {"X-Request-ID": f"rid-sent-{pkg}"} if sent else None
        st, _, h = httpd.http_bytes("GET", f"{srv.url}/x",
                                    headers=headers)
    finally:
        srv.stop()
    assert st == 200
    rid = h["X-Request-ID"]
    if sent:
        assert rid == f"rid-sent-{pkg}"
    mine = [json.loads(ln) for ln in captured[pkg].lines
            if "handling /x" in ln]
    assert [d["requestId"] for d in mine] == [rid]
    assert any(s["traceId"] == rid for s in tr.spans_for(rid))


def _master_log(module: str, tmp_path) -> "list[dict]":
    d = tmp_path / module
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "WEED_MASTER_DEFAULTREPLICATION": "001"}
    p = subprocess.Popen(
        [sys.executable, "-m", module, "-v", "2", "-logdir", str(d),
         "-logJson", "master", "-port", "0", "-mdir", str(d / "m")],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        first = p.stdout.readline()
        assert "listening on" in first, p.stderr.read()
        time.sleep(0.5)
    finally:
        p.send_signal(signal.SIGTERM)
        try:
            p.wait(60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        p.stdout.close()
        p.stderr.close()
    with open(d / "weed.log") as f:
        return [json.loads(ln) for ln in f]


def test_the_master_writes_the_same_json_log(tmp_path):
    logs = {m: _master_log(m, tmp_path)
            for m in ("seaweedfs_tpu_torch", "seaweedfs_tpu")}
    for docs in logs.values():
        assert docs
        assert {k for d in docs for k in d} <= {
            "severity", "time", "message", "component", "requestId"}
    port, ref = logs["seaweedfs_tpu_torch"], logs["seaweedfs_tpu"]
    override = [(d["severity"], d["component"], d["message"])
                for d in port if d["message"].startswith("env override")]
    assert override == [("INFO", "config", "env override: "
                         "master-defaultReplication=001")]
    assert override == [(d["severity"], d["component"], d["message"])
                        for d in ref
                        if d["message"].startswith("env override")]
    assert {k for d in port for k in d} == {k for d in ref for k in d}
