"""The volume server's `/admin/query` (volume_server.proto Query) on the
port, on the CPU, against the JAX server's.  Tolerance: exact equality of
statuses and answers.

- the JAX suite's `test_query.py::test_volume_query_rpc` on a port
  cluster (`jax_suite.load_suite`);
- eight expressions over seeded JSON-lines and CSV needles (selects,
  aggregates, group by, headerless CSV, a bad expression, a missing
  needle) give the same answers on both servers, and the port's engine's
  rows on the same bytes.
"""

import json

import numpy as np

from jax_suite import load_suite, port_volume_server
from seaweedfs_tpu_torch.query import run_query
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json

from test_torch_write_path import Cluster

PORTED = ("seaweedfs_tpu.s3", "seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server", "seaweedfs_tpu.filer",
          "seaweedfs_tpu.query")



globals().update(load_suite(
    "test_query", PORTED, fixtures=("cluster",),
    overrides={"VolumeServer": port_volume_server},
    only=("test_volume_query_rpc",)))


ROWS = [{"name": f"n{i}", "size": int(s), "tier": t}
        for i, (s, t) in enumerate(zip(
            np.random.default_rng(12).integers(1, 500, 40),
            np.random.default_rng(13).choice(["hot", "cold", "warm"], 40)))]
JSONL = b"".join(json.dumps(r).encode() + b"\n" for r in ROWS)
CSV = ("name,size,tier\n" + "".join(f"{r['name']},{r['size']},{r['tier']}\n"
                                    for r in ROWS)).encode()
ASKS = [
    (1, "select name from s3object where size > 250", "json", True),
    (1, "select count(*) from s3object where tier = 'hot'", "json", True),
    (1, "select tier, count(*) from s3object group by tier", "json", True),
    (2, "select name, size from s3object where size < 100 limit 5",
     "csv", True),
    (2, "select avg(size), max(size) from s3object", "csv", True),
    (2, "select _1 from s3object where _3 = 'cold'", "csv", False),
    (1, "garbage", "json", True),
    (9, "select * from s3object", "json", True),
]


def test_admin_query_answers_as_the_jax_server(tmp_path):
    """The same needles (JSON lines and CSV of seeded rows) in a volume of
    each package's server: `/admin/query` gives the same status and
    answer for each expression, a bad one and a missing needle too, and
    the rows equal the port's engine on the same bytes."""
    answers = {}
    for kind in ("port", "ref"):
        c = Cluster(tmp_path / kind, kind, racks=("r1",), size_limit_mb=64)
        try:
            vs = c.servers[0]
            http_json("POST", f"{vs.url}/admin/allocate_volume",
                      {"volumeId": 3})
            for key, body in ((1, JSONL), (2, CSV)):
                st, _, _ = http_bytes("POST", f"{vs.url}/3,{key:x}00000001",
                                      body)
                assert st == 201
            got = []
            for key, expr, fmt, header in ASKS:
                st, body, _ = http_bytes(
                    "POST", f"{vs.url}/admin/query", json.dumps({
                        "volumeId": 3, "key": key, "expression": expr,
                        "inputFormat": fmt, "csvHeader": header}).encode(),
                    {"Content-Type": "application/json"})
                got.append((st, json.loads(body)))
            answers[kind] = got
        finally:
            c.close()
    assert answers["port"] == answers["ref"]
    assert [st for st, _ in answers["port"]] == [200] * 6 + [400, 404]
    for (key, expr, fmt, header), (_st, ans) in zip(ASKS[:6],
                                                   answers["port"]):
        assert ans["rows"] == run_query(expr, JSONL if key == 1 else CSV,
                                        fmt, header)
        assert ans["count"] == len(ans["rows"])
