"""Metadata notification on the CPU, the port against the JAX package:
`notification.from_spec`, the webhook, log-file, SQS and Pub/Sub
publishers, and `NotificationTailer` over a filer's metalog, with a port
filer (`notification=`) over a port cluster beside a JAX filer over a JAX
cluster.  Tolerance: exact equality of request bodies and log lines
(event stamps and fids masked where two clusters mint their own); the
mutations are seeded with numpy.

- each spec parses to the same publisher, an unknown kind fails with the
  JAX message, and `mq:` / `kafka:` are refused as not ported;
- the same events give byte-identical bodies on every publisher;
- a filer publishes one event a mutation, in order, the same events as
  the JAX filer's for the same mutations, and through a webhook outage
  loses none (at least once: the offset moves after a publish);
- the tailer's `notify.offset` resumes a restarted filer where it
  stopped, and the file is the JAX tailer's.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu import notification as ref_notification
from seaweedfs_tpu.filer.meta_log import MetaLog as RefMetaLog
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu_torch import notification
from seaweedfs_tpu_torch.filer.meta_log import MetaLog
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import HttpServer, http_bytes

from test_torch_filer import _mask
from test_torch_profiling import stop_background_probes
from test_torch_write_path import Cluster, _wait


class Collector:
    """An endpoint that keeps every POST body (and can fail a while)."""

    def __init__(self):
        self.bodies = []
        self.headers = []
        self.fail_until = 0.0
        self.lock = threading.Lock()
        self.http = HttpServer()
        self.http.fallback = self._take
        self.http.start()

    def _take(self, req):
        if time.time() < self.fail_until:
            return 503, {"error": "induced failure"}
        with self.lock:
            self.bodies.append(req.body)
            self.headers.append(dict(req.headers))
        return 200, {}

    @property
    def url(self) -> str:
        return f"http://{self.http.url}"

    def events(self) -> list:
        with self.lock:
            return [json.loads(b) for b in self.bodies]

    def stop(self) -> None:
        self.http.stop()


@pytest.fixture
def collector():
    c = Collector()
    yield c
    c.stop()


def _events(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        path = f"/n/{int(rng.integers(0, 9))}/f{i}"
        e = {"fullPath": path, "isDirectory": False,
             "attributes": {"mtime": 1.5, "mode": 420},
             "chunks": [{"fileId": f"3,0{i}ab", "size": int(
                 rng.integers(1, 1 << 20))}]}
        op = ["create", "update", "delete", "rename"][int(rng.integers(4))]
        out.append({"tsNs": 1_700_000_000_000_000_000 + i, "op": op,
                    "newEntry": None if op == "delete" else e,
                    "oldEntry": e if op in ("delete", "rename") else None})
    return out


SPECS = ["webhook:http://127.0.0.1:9/hook", "logfile:{tmp}/ev.jsonl",
         "sqs:https://sqs.eu-west-1.amazonaws.com/123/q",
         "sqs:http://127.0.0.1:9/q",
         "pubsub:http://127.0.0.1:9/projects/p1/topics/t1",
         "bogus:x", "pubsub:http://h/topics/t", "sqs:no-scheme", "nocolon"]


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_as_the_jax_specs(spec, tmp_path):
    spec = spec.format(tmp=tmp_path)
    out = []
    for mod in (notification, ref_notification):
        try:
            p = mod.from_spec(spec)
        except ValueError as e:
            out.append(("error", str(e)))
            continue
        out.append((type(p).__name__, {k: v for k, v in vars(p).items()
                                       if not k.startswith("_")}))
        p.close()
    assert out[0] == out[1]


@pytest.mark.parametrize("kind", ["mq", "kafka"])
def test_mq_and_kafka_are_refused_as_not_ported(kind):
    with pytest.raises(notification.NotPorted, match=f"-notification "
                       f"{kind}: not ported"):
        notification.from_spec(f"{kind}:127.0.0.1:9/ns/t")


@pytest.mark.parametrize("kind", ["webhook", "sqs", "pubsub"])
def test_publishers_send_the_jax_bodies(kind, collector, monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "")
    spec = {"webhook": f"webhook:{collector.url}/hook",
            "sqs": f"sqs:{collector.url}/123/queue",
            "pubsub": f"pubsub:{collector.url}/projects/p/topics/t"}[kind]
    evs = _events(1, 12)
    for mod in (notification, ref_notification):
        p = mod.from_spec(spec)
        for ev in evs:
            p.publish(ev)
        p.close()
    n = len(evs)
    assert collector.bodies[:n] == collector.bodies[n:]
    assert [h.get("Content-Type") for h in collector.headers[:n]] == \
        [h.get("Content-Type") for h in collector.headers[n:]]


def test_logfile_lines_are_the_jax_lines(tmp_path):
    evs = _events(2, 40)
    for name, mod in (("port", notification), ("jax", ref_notification)):
        p = mod.from_spec(f"logfile:{tmp_path}/{name}/ev.jsonl")
        for ev in evs:
            p.publish(ev)
        p.close()
    assert (tmp_path / "port/ev.jsonl").read_bytes() == \
        (tmp_path / "jax/ev.jsonl").read_bytes()


def test_tailer_offsets_match_and_resume(tmp_path):
    """Both tailers over one metalog publish every event once in order
    and leave the same `notify.offset`; a new tailer on the port's offset
    publishes only what came after."""
    log = MetaLog(str(tmp_path / "log"))
    for i in range(30):
        log.append({"op": "create", "newEntry": {"fullPath": f"/t/{i}"}})
    out = {}
    for name, mod in (("port", notification), ("jax", ref_notification)):
        state = str(tmp_path / f"{name}.offset")
        t = mod.NotificationTailer(
            log, mod.from_spec(f"logfile:{tmp_path}/{name}.jsonl"),
            state_path=state, poll_interval=0.02).start()
        _wait(lambda: os.path.exists(state) and json.load(open(state))[
            "sinceNs"] == log.last_ts(), f"{name} tailer caught up")
        t.stop()
        out[name] = (open(state).read(),
                     (tmp_path / f"{name}.jsonl").read_bytes())
    assert out["port"] == out["jax"]
    for i in range(30, 35):
        log.append({"op": "create", "newEntry": {"fullPath": f"/t/{i}"}})
    state = str(tmp_path / "port.offset")
    t = notification.NotificationTailer(
        log, notification.from_spec(f"logfile:{tmp_path}/again.jsonl"),
        state_path=state, poll_interval=0.02).start()
    _wait(lambda: json.load(open(state))["sinceNs"] == log.last_ts(),
          "resumed tailer caught up")
    t.stop()
    lines = (tmp_path / "again.jsonl").read_text().splitlines()
    assert [json.loads(x)["newEntry"]["fullPath"] for x in lines] == \
        [f"/t/{i}" for i in range(30, 35)]
    log.close()
    # the JAX log reader sees the same events the tailers published
    ref = RefMetaLog(str(tmp_path / "log"))
    assert [e["newEntry"]["fullPath"] for e in ref.events_since(0)] == \
        [f"/t/{i}" for i in range(35)]
    ref.close()


def _mutate(url: str, seed: int) -> int:
    """Seeded creates, overwrites, renames and deletes; the number of
    mutations."""
    rng = np.random.default_rng(seed)
    n = 0
    for i in range(24):
        body = rng.integers(0, 256, int(rng.integers(1, 3000)),
                            dtype=np.uint8).tobytes()
        assert http_bytes("PUT", f"{url}/w/{i % 9}.bin", body)[0] == 201
        n += 1
    assert http_bytes("POST", f"{url}/__meta__/rename", json.dumps(
        {"oldPath": "/w/1.bin", "newPath": "/w/moved.bin"}).encode(),
        {"Content-Type": "application/json"})[0] == 200
    assert http_bytes("DELETE", f"{url}/w/2.bin")[0] == 204
    return n + 2


def test_filers_publish_the_jax_events(tmp_path, collector, monkeypatch):
    """A port filer and a JAX filer, each with `webhook:` to one
    collector and each over a cluster of its own package, under the same
    mutations: one event a mutation (the parent directory's creation
    first), in order, equal once fids and stamps are masked; a webhook
    outage mid-run loses nothing."""
    for k in ("SEAWEEDFS_TPU_FILER_META_PLANE",
              "SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE"):
        monkeypatch.delenv(k, raising=False)
    got = {}
    try:
        for kind in ("port", "jax"):
            c = Cluster(tmp_path / kind, "port" if kind == "port" else "ref",
                        racks=("r1",), size_limit_mb=64)
            cls = FilerServer if kind == "port" else RefFilerServer
            fs = cls(c.url, store_path=str(tmp_path / kind / "f.db"),
                     notification=f"webhook:{collector.url}/{kind}").start()
            try:
                collector.fail_until = time.time() + 0.5
                n = _mutate(fs.url, 4)
                want = len(fs.filer.events_since(0))
                _wait(lambda: sum(1 for h in collector.bodies) >= want,
                      f"{kind} events delivered", timeout=30)
                time.sleep(0.3)             # nothing more may come
                got[kind] = collector.events()
                collector.bodies.clear()
                assert len(got[kind]) == want >= n
                assert got[kind] == fs.filer.events_since(0)
                assert os.path.exists(os.path.join(
                    fs.filer.meta_log.dir, "notify.offset"))
            finally:
                fs.stop()
                c.close()
    finally:
        stop_background_probes()
    assert _mask(got["port"]) == _mask(got["jax"])
