"""The port's S3 Tables plane (`seaweedfs_tpu_torch/s3/s3tables.py`, the
gateway's `S3Tables.*` target and table-bucket write guard, the shell's
four `s3tables.*` verbs) on the CPU, against the JAX package's.
Tolerance: exact equality (statuses and JSON answers, verb outputs,
filer entries) under one deterministic `secrets` and clock.

- the JAX suite `tests/test_s3tables.py` runs whole on a port cluster
  (`jax_suite.load_suite`);
- one sequence of 33 S3 Tables operations and object writes (errors,
  version-token conflicts, policies, tags, the write guard) and 10
  `s3tables.*` verbs through each package's gateway and shell: the same
  answers;
- a table made through either package's gateway reads the same through
  the other package's `S3TablesStore` over that filer.
"""

import json
import re
import secrets
import time
import types

import pytest

from jax_suite import load_suite, port_volume_server
from seaweedfs_tpu.filer.client import FilerClient as RefClient
from seaweedfs_tpu.s3 import S3ApiServer as RefS3
from seaweedfs_tpu.s3 import s3tables as ref_tables
from seaweedfs_tpu.server.filer_server import FilerServer as RefFiler
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.shell.commands import CommandEnv as RefEnv
from seaweedfs_tpu_torch.filer.client import FilerClient as PortClient
from seaweedfs_tpu_torch.s3 import S3ApiServer, auth
from seaweedfs_tpu_torch.s3 import s3tables as port_tables
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.commands import CommandEnv

from test_torch_profiling import stop_background_probes
from test_torch_write_path import Cluster

PORTED = ("seaweedfs_tpu.s3", "seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server", "seaweedfs_tpu.filer",
          "seaweedfs_tpu.shell")


globals().update(load_suite("test_s3tables", PORTED, fixtures=("cluster",),
                            overrides={"VolumeServer": port_volume_server}))


# --- the two packages' gateways, side by side ---------------------------------

AK, SK = "AKIDEXAMPLE", "secretkey123"
CREDS = {AK: SK}


@pytest.fixture(scope="module")
def gateways(tmp_path_factory):
    """Each package's cluster, filer (the synchronous commit) and gateway
    with flat credentials."""
    tmp = tmp_path_factory.mktemp("tables")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_FILER_META_PLANE", "0")
        for kind, (F, S, Env) in {
                "port": (FilerServer, S3ApiServer, CommandEnv),
                "ref": (RefFiler, RefS3, RefEnv)}.items():
            c = Cluster(tmp / kind, kind, racks=("r1",), size_limit_mb=64)
            fs = F(c.url).start()
            gw = S(fs.filer, credentials=CREDS).start()
            out[kind] = types.SimpleNamespace(
                cluster=c, filer=fs, gw=gw, env=Env(c.url, filer=fs.url))
    yield out
    for x in out.values():
        x.gw.stop()
        x.filer.stop()
        x.cluster.close()
    stop_background_probes()


class _Secrets:
    """`secrets.token_hex` drawing the same values in the same order in
    both packages (the version tokens)."""

    def __init__(self):
        self.n = 0

    def token_hex(self, nbytes: int = 16) -> str:
        self.n += 1
        return f"{self.n:0{2 * nbytes}x}"


@pytest.fixture
def fixed(monkeypatch):
    """One deterministic `secrets` and one clock for both packages'
    S3 Tables modules."""
    def use():
        fake = _Secrets()
        monkeypatch.setattr(secrets, "token_hex", fake.token_hex)
        clock = types.SimpleNamespace(time=lambda: 1_700_000_000.0,
                                      strftime=time.strftime,
                                      gmtime=time.gmtime)
        for mod in (port_tables, ref_tables):
            monkeypatch.setattr(mod, "time", clock)
    return use


def _tables(url: str, op: str, body) -> tuple:
    payload = body if isinstance(body, bytes) else json.dumps(body).encode()
    h = auth.sign_request("POST", url, "/", {}, {"X-Amz-Target":
                                                  f"S3Tables.{op}"},
                          payload, AK, SK)
    h["X-Amz-Target"] = f"S3Tables.{op}"
    st, resp, _ = http_bytes("POST", f"{url}/", payload, h)
    return op, st, json.loads(resp) if resp else {}


def _object_put(url: str, path: str, body: bytes) -> tuple:
    h = auth.sign_request("PUT", url, path, {}, {}, body, AK, SK)
    st, resp, _ = http_bytes("PUT", f"{url}{auth.uri_encode(path, False)}",
                             body, h)
    code = re.search(rb"<Code>([^<]*)</Code>", resp)
    return path, st, code.group(1).decode() if code else ""


def _script(gw_url: str, env, run) -> list:
    """One sequence of S3 Tables operations, object writes into the table
    bucket and `s3tables.*` verbs: every answer, in order."""
    bkt = "arn:aws:s3tables:us-east-1:000000000000:bucket/lake"
    tbl = bkt + "/table/raw/clicks"
    meta = {"iceberg": {"schema": {"fields": [{"name": "ts",
                                                "type": "timestamp"}]}}}
    out = [_tables(gw_url, "CreateTableBucket",
                   {"name": "lake", "tags": {"env": "dev"}}),
           _tables(gw_url, "CreateTableBucket", {"name": "lake"}),
           _tables(gw_url, "CreateTableBucket", {"name": "Bad_Name"}),
           _tables(gw_url, "ListTableBuckets", {}),
           _tables(gw_url, "GetTableBucket", {"tableBucketARN": bkt}),
           _tables(gw_url, "CreateNamespace",
                   {"tableBucketARN": bkt, "namespace": ["raw"]}),
           _tables(gw_url, "CreateNamespace",
                   {"tableBucketARN": bkt, "namespace": ["raw"]}),
           _tables(gw_url, "ListNamespaces", {"tableBucketARN": bkt}),
           _tables(gw_url, "GetNamespace",
                   {"tableBucketARN": bkt, "namespace": ["raw"]}),
           _tables(gw_url, "CreateTable",
                   {"tableBucketARN": bkt, "namespace": ["raw"],
                    "name": "clicks", "metadata": meta})]
    token = out[-1][2].get("versionToken", "")
    out += [_tables(gw_url, "GetTable", {"tableARN": tbl}),
            _tables(gw_url, "ListTables", {"tableBucketARN": bkt}),
            _tables(gw_url, "UpdateTable",
                    {"tableBucketARN": bkt, "namespace": ["raw"],
                     "name": "clicks", "versionToken": "stale"}),
            _tables(gw_url, "UpdateTable",
                    {"tableBucketARN": bkt, "namespace": ["raw"],
                     "name": "clicks", "versionToken": token,
                     "metadataLocation": "s3://lake/raw/clicks/metadata/"
                                         "v1.metadata.json"})]
    token = out[-1][2].get("versionToken", "")
    out += [_tables(gw_url, "PutTableBucketPolicy",
                    {"tableBucketARN": bkt, "resourcePolicy": '{"a": 1}'}),
            _tables(gw_url, "GetTableBucketPolicy", {"tableBucketARN": bkt}),
            _tables(gw_url, "DeleteTableBucketPolicy",
                    {"tableBucketARN": bkt}),
            _tables(gw_url, "GetTableBucketPolicy", {"tableBucketARN": bkt}),
            _tables(gw_url, "TagResource",
                    {"resourceArn": tbl, "tags": {"tier": "hot"}}),
            _tables(gw_url, "ListTagsForResource", {"resourceArn": tbl}),
            _tables(gw_url, "UntagResource",
                    {"resourceArn": tbl, "tagKeys": ["tier"]}),
            _tables(gw_url, "ListTagsForResource", {"resourceArn": tbl}),
            _object_put(gw_url, "/lake/raw/clicks/metadata/v1.metadata.json",
                        b'{"format-version": 2}'),
            _object_put(gw_url, "/lake/raw/clicks/data/year=2024/p.parquet",
                        b"PAR1"),
            _object_put(gw_url, "/lake/raw/clicks/notes.txt", b"no"),
            _object_put(gw_url, "/lake/raw/other/data/p.parquet", b"no"),
            _tables(gw_url, "DeleteNamespace",
                    {"tableBucketARN": bkt, "namespace": ["raw"]}),
            _tables(gw_url, "DeleteTable",
                    {"tableBucketARN": bkt, "namespace": ["raw"],
                     "name": "clicks", "versionToken": "stale"}),
            _tables(gw_url, "DeleteTable",
                    {"tableBucketARN": bkt, "namespace": ["raw"],
                     "name": "clicks", "versionToken": token}),
            _tables(gw_url, "DeleteNamespace",
                    {"tableBucketARN": bkt, "namespace": ["raw"]}),
            _tables(gw_url, "DeleteTableBucket", {"tableBucketARN": bkt}),
            _tables(gw_url, "NoSuchOperation", {}),
            _tables(gw_url, "ListTableBuckets", b"{not json")]
    for line in ("s3tables.bucket -create -name=shlake -tags=env=dev",
                 "s3tables.bucket -list",
                 "s3tables.namespace -bucket=shlake -create -name=raw",
                 "s3tables.namespace -bucket=shlake -list",
                 "s3tables.table -bucket=shlake -namespace=raw -create "
                 "-name=clicks",
                 "s3tables.table -bucket=shlake -namespace=raw -list",
                 "s3tables.table -bucket=shlake -namespace=raw -get "
                 "-name=clicks",
                 "s3tables.tag -resource=shlake -set=owner=me",
                 "s3tables.tag -resource=shlake -list",
                 "s3tables.bucket -delete -name=shlake"):
        try:
            out.append((line, run(env, line)))
        except RuntimeError as e:
            out.append((line, "error", str(e)))
    return out


def test_the_tables_plane_answers_as_the_jax_gateway(gateways, fixed):
    """The same S3 Tables operations, object writes into the table bucket
    and `s3tables.*` verbs, under one `secrets` and clock, give the same
    statuses and answers through both packages' gateways."""
    got = {}
    for kind, run in (("port", run_command), ("ref", ref_run_command)):
        fixed()
        got[kind] = _script(gateways[kind].gw.url, gateways[kind].env, run)
    for i, (p, r) in enumerate(zip(got["port"], got["ref"])):
        assert p == r, i
    assert len(got["port"]) == len(got["ref"]) == 43
    assert [x[1] for x in got["port"][:33]] == [
        200, 409, 400, 200, 200, 200, 409, 200, 200, 200, 200, 200, 409,
        200, 200, 200, 200, 404, 200, 200, 200, 200, 200, 200, 403, 403,
        409, 409, 200, 200, 200, 400, 400]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_table_made_by_one_package_reads_in_the_other(gateways, writer):
    """A table bucket, namespace and table made through one package's
    gateway read the same through the other package's `S3TablesStore`
    over the same filer: the extended attributes are the same keys and
    JSON."""
    reader = "ref" if writer == "port" else "port"
    g = gateways[writer]
    name = f"x{writer}"
    bkt = f"arn:aws:s3tables:us-east-1:000000000000:bucket/{name}"
    assert _tables(g.gw.url, "CreateTableBucket",
                   {"name": name, "tags": {"k": "v"}})[1] == 200
    assert _tables(g.gw.url, "CreateNamespace",
                   {"tableBucketARN": bkt, "namespace": ["ns"]})[1] == 200
    assert _tables(g.gw.url, "CreateTable",
                   {"tableBucketARN": bkt, "namespace": ["ns"],
                    "name": "t", "metadata": {"m": [1, 2]}})[1] == 200
    stores = {"port": port_tables.S3TablesStore(PortClient(g.filer.url)),
              "ref": ref_tables.S3TablesStore(RefClient(g.filer.url))}

    def reads(st):
        return [st.get_table_bucket(bkt), st.list_namespaces(bkt),
                st.get_namespace(bkt, ["ns"]),
                st.get_table(bkt, ["ns"], "t"), st.list_tables(bkt),
                st.list_tags(bkt)]
    assert reads(stores[reader]) == reads(stores[writer])
    stores[reader].delete_table(bkt, ["ns"], "t")
    stores[reader].delete_namespace(bkt, ["ns"])
    stores[reader].delete_table_bucket(bkt)
    assert _tables(g.gw.url, "GetTableBucket",
                   {"tableBucketARN": bkt})[1] == 404
