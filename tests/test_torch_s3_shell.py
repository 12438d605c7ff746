"""The port's `s3.*` shell verbs (`seaweedfs_tpu_torch/shell/s3_commands.py`,
`s3_iam_commands.py`) on the CPU, against the JAX package's.  Tolerance:
exact equality of every output line, error and identities JSON (the
secrets they mint drawn from one deterministic stand-in in both
packages, the config paths masked).

- the s3 tests of the JAX suite `tests/test_shell_breadth.py` run on a
  port cluster with the port's shell (`jax_suite.load_suite`);
- one scripted sequence of 55 verbs (users, keys, grants, anonymous
  access, managed policies, groups, service accounts, buckets,
  versioning, owner, access, lock, quota, lifecycle, uploads, the
  circuit breaker, export and import) on both packages, each over its
  own filer: the same outputs and the same identities JSON;
- each package's gateway enforcing the shell's changes at once (grants,
  disable, rotation), with the same statuses;
- quota enforcement: an over-quota bucket read-only at the gateway, and
  writable again under its quota;
- the four `s3tables.*` verbs: a missing table bucket refused, and the
  usage line, as the JAX verbs answer.
"""

import json
import os
import re
import time
import types

import pytest

from jax_suite import load_suite
from seaweedfs_tpu.iam.identity import IdentityStore as RefIdentityStore
from seaweedfs_tpu.s3 import S3ApiServer as RefS3
from seaweedfs_tpu.server.filer_server import FilerServer as RefFiler
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.shell import s3_iam_commands as ref_iam_commands
from seaweedfs_tpu.shell.commands import CommandEnv as RefEnv
from seaweedfs_tpu_torch.iam.identity import IdentityStore
from seaweedfs_tpu_torch.s3 import S3ApiServer, auth
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell import s3_iam_commands
from seaweedfs_tpu_torch.shell.commands import CommandEnv

PORTED = ("seaweedfs_tpu.iam", "seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server", "seaweedfs_tpu.shell")
PULSE = 0.3


def _port_volume_server(dirs, master, **kw):
    return VolumeServer(dirs, device="cpu", master=master, **kw)


globals().update(load_suite(
    "test_shell_breadth", PORTED, fixtures=("cluster",),
    overrides={"VolumeServer": _port_volume_server},
    exclude=("test_command_count_at_least_100",
             "test_fs_cd_pwd_meta_family",
             "test_fs_verify_reports_broken_chunk",
             "test_volume_server_state_and_vacuum_gate",
             "test_volume_replica_check_flags_divergence",
             "test_volume_server_leave", "test_mq_balance_and_truncate",
             "test_mq_balance_spreads_single_partition_topics")))


def _wait_nodes(url: str, n: int = 1) -> None:
    deadline = time.monotonic() + 15
    while len(http_json("GET", f"{url}/cluster/status")["dataNodes"]) < n:
        assert time.monotonic() < deadline, "volume servers registered"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def filers(tmp_path_factory):
    """A port cluster and a JAX cluster, each with a filer and a gateway
    whose identities are a file of its own."""
    tmp = tmp_path_factory.mktemp("s3shell")
    out = {}
    for name, (M, V, F, S, Store, Env) in {
            "port": (MasterServer, _port_volume_server, FilerServer,
                     S3ApiServer, IdentityStore, CommandEnv),
            "ref": (RefMaster, RefServer, RefFiler, RefS3,
                    RefIdentityStore, RefEnv)}.items():
        master = M(pulse_seconds=PULSE).start()
        vs = V([str(tmp / f"{name}-v")], master.url,
               pulse_seconds=PULSE).start()
        _wait_nodes(master.url)
        filer = F(master.url).start()
        cfg = str(tmp / f"{name}-s3.json")
        gw = S(filer.filer, iam=Store(cfg)).start()
        out[name] = types.SimpleNamespace(
            master=master, vs=vs, filer=filer, gw=gw, cfg=cfg, tmp=tmp,
            env=Env(master.url, filer=filer.http.url))
    yield out
    for c in out.values():
        c.gw.stop()
        c.filer.stop()
        c.vs.stop()
        c.master.stop()


class _Secrets:
    """The `secrets` functions the verbs call, deterministic: the same
    call sequence draws the same values in both packages."""

    def __init__(self):
        self.n = 0

    def token_hex(self, nbytes: int = 16) -> str:
        self.n += 1
        return f"{self.n:0{2 * nbytes}x}"

    def token_urlsafe(self, nbytes: int = 16) -> str:
        self.n += 1
        return f"u{self.n:0{nbytes}d}"


def _fixed_secrets(monkeypatch):
    for mod in (s3_iam_commands, ref_iam_commands):
        monkeypatch.setattr(mod, "secrets", _Secrets())
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: 1_760_000_000.0))


def _run(c, run, line: str) -> str:
    """One verb's output, or its error, with this cluster's paths
    masked."""
    line = line.replace("{cfg}", c.cfg).replace("{tmp}", str(c.tmp))
    try:
        out = run(c.env, line)
    except (RuntimeError, ValueError) as e:
        out = f"error {type(e).__name__}: {e}"
    return out.replace(c.cfg, "CFG").replace(str(c.tmp), "TMP")


POLICY = json.dumps({"Statement": [{
    "Effect": "Allow", "Action": ["s3:GetObject", "s3:PutObject",
                                  "s3:ListBucket"],
    "Resource": "arn:aws:s3:::shared/*"}]}, separators=(",", ":"))

SCRIPT = [
    "s3.configure -config={cfg}",
    "s3.user.create -user=alice -actions=Read:shared",
    "s3.user.create -user=alice",
    "s3.accesskey.create -user=alice",
    "s3.accesskey.list",
    "s3.policy.attach -user=alice -actions=Write:shared,List:shared",
    "s3.policy.detach -user=alice -actions=List:shared",
    "s3.user.show -user=alice",
    "s3.user.disable -user=alice",
    "s3.user.list",
    "s3.user.enable -user=alice",
    "s3.user.show -user=nobody",
    "s3.anonymous.set -actions=Read:public",
    "s3.anonymous.get",
    "s3.anonymous.list",
    f"s3.policy -name=rw -content={POLICY}",
    "s3.policy -list",
    "s3.policy -name=rw",
    "s3.group.create -name=devs -policies=rw",
    "s3.group.create -name=bad -policies=missing",
    "s3.group.add.user -name=devs -user=alice",
    "s3.group.list",
    "s3.group.show -name=devs",
    "s3.serviceaccount.create -user=alice -actions=Write:shared "
    "-expiry=1h",
    "s3.serviceaccount.create -user=alice -actions=Admin",
    "s3.serviceaccount.list",
    "s3.bucket.create -name=shared",
    "s3.bucket.create -name=Bad_Name",
    "s3.bucket.list",
    "s3.bucket.versioning -bucket=shared -status=Enabled",
    "s3.bucket.versioning -bucket=shared",
    "s3.bucket.owner -bucket=shared -owner=acct-1",
    "s3.bucket.owner -bucket=shared",
    "s3.bucket.access -name=shared -user=carol -access=Read,List",
    "s3.bucket.access -name=shared -user=alice",
    "s3.bucket.lock -name=shared",
    "s3.bucket.lock -name=shared -enable",
    "s3.bucket.lock -name=shared -enable",
    "s3.bucket.quota -bucket=shared -limitMB=1",
    "s3.bucket.quota -bucket=shared",
    "s3.bucket.quota.enforce",
    "s3.lifecycle.apply",
    "s3.clean.uploads -timeAgo=1h",
    "s3.circuitBreaker -global -type=count -actions=Read,Write "
    "-values=500,200",
    "s3.user.provision -user=bob",
    "s3.accesskey.rotate -user=bob",
    "s3.iam.export -file={tmp}/export.json",
    "s3.group.remove.user -name=devs -user=alice",
    "s3.group.delete -name=devs",
    "s3.serviceaccount.delete -id=sa-000000000005",
    "s3.user.delete -user=alice",
    "s3.iam.import -file={tmp}/export.json -merge",
    "s3.config.show",
    "s3.bucket.delete -name=bob",
    "s3.bucket.quota -bucket=shared -remove",
]


def test_one_script_on_both_shells(filers, monkeypatch):
    _fixed_secrets(monkeypatch)
    for c in filers.values():
        st, _, _ = http_bytes(
            "PUT", f"{c.filer.url}/buckets/shared/seed.txt", b"x" * 100)
        assert st == 201
    outs = {"port": [], "ref": []}
    for line in SCRIPT:
        for name, run in (("port", run_command),
                          ("ref", ref_run_command)):
            outs[name].append(_run(filers[name], run, line))
        assert outs["port"][-1] == outs["ref"][-1], line
    assert any(o.startswith("id: sa-000000000005")
               for o in outs["port"]), outs["port"]
    with open(filers["port"].cfg) as a, open(filers["ref"].cfg) as b:
        assert json.load(a) == json.load(b)
    assert sum(o.startswith("error") for o in outs["port"]) == 5


def _keys(out: str) -> "tuple[str, str]":
    vals = dict(ln.split(": ", 1) for ln in out.splitlines()
                if ln.startswith(("accessKey: ", "secretKey: ")))
    return vals["accessKey"], vals["secretKey"]


def _s3(gw, method, path, keys, body=b""):
    h = auth.sign_request(method, gw.url, path, {}, {}, body, *keys)
    return http_bytes(method, f"{gw.url}{path}", body or None, h)[0]


def test_the_gateway_enforces_shell_changes_live(filers):
    got = {}
    for name, run in (("port", run_command), ("ref", ref_run_command)):
        c = filers[name]
        cfg = f"-config={c.cfg}"
        admin = _keys(run(c.env, f"s3.user.create -user=ops "
                                 f"-actions=Admin {cfg}"))
        steps = [_s3(c.gw, "PUT", "/live", admin),
                 _s3(c.gw, "PUT", "/live/a.txt", admin, b"a")]
        dave = _keys(run(c.env, f"s3.user.create -user=dave "
                                f"-actions=Read:live {cfg}"))
        steps += [_s3(c.gw, "GET", "/live/a.txt", dave),
                  _s3(c.gw, "PUT", "/live/d.txt", dave, b"d")]
        run(c.env, f"s3.policy.attach -user=dave -actions=Write:live {cfg}")
        steps.append(_s3(c.gw, "PUT", "/live/d.txt", dave, b"d"))
        run(c.env, f"s3.user.disable -user=dave {cfg}")
        steps.append(_s3(c.gw, "GET", "/live/a.txt", dave))
        run(c.env, f"s3.user.enable -user=dave {cfg}")
        steps.append(_s3(c.gw, "GET", "/live/a.txt", dave))
        out = run(c.env, f"s3.accesskey.rotate -user=dave {cfg}")
        new = (out.split()[3], out.splitlines()[1].split(": ", 1)[1])
        steps += [_s3(c.gw, "GET", "/live/a.txt", dave),
                  _s3(c.gw, "GET", "/live/a.txt", new)]
        run(c.env, f"s3.bucket.access -name=live -user=dave -access=none "
                   f"{cfg}")
        steps.append(_s3(c.gw, "GET", "/live/a.txt", new))
        got[name] = steps
    assert got["port"] == got["ref"] == [200, 200, 200, 403, 200, 403,
                                         200, 403, 200, 403]


def test_quota_enforcement_at_the_gateway(filers):
    got = {}
    for name, run in (("port", run_command), ("ref", ref_run_command)):
        c = filers[name]
        keys = _keys(run(c.env, f"s3.user.create -user=q "
                                f"-actions=Admin -config={c.cfg}"))
        steps = [_s3(c.gw, "PUT", "/quota", keys)]
        for i in range(3):
            steps.append(_s3(c.gw, "PUT", f"/quota/o{i}", keys,
                             os.urandom(200_000)))
        lines = [run(c.env, "s3.bucket.quota -bucket=quota -limitMB=0.5"),
                 run(c.env, "s3.bucket.quota.enforce")]
        steps += [_s3(c.gw, "PUT", "/quota/o9", keys, b"more"),
                  _s3(c.gw, "GET", "/quota/o0", keys),
                  _s3(c.gw, "DELETE", "/quota/o0", keys)]
        lines.append(run(c.env, "s3.bucket.quota.enforce"))
        steps.append(_s3(c.gw, "PUT", "/quota/o9", keys, b"more"))
        lines.append(run(c.env, "s3.bucket.quota -bucket=quota"))
        got[name] = (steps, [re.sub(r"used=\d+", "used=N", ln)
                             for ln in lines])
    assert got["port"] == got["ref"]
    steps, lines = got["port"]
    assert steps == [200, 200, 200, 200, 403, 200, 204, 200]
    assert "READ-ONLY" in lines[1] and "ok" in lines[2]


@pytest.mark.parametrize("verb", ["s3tables.bucket", "s3tables.namespace",
                                  "s3tables.table", "s3tables.tag"])
def test_s3tables_verbs_are_refused(verb, filers):
    """Each `s3tables.*` verb (refused outright while S3 Tables was not
    ported) refuses an operation on a table bucket that does not exist
    with the JAX verb's error, and with no operation flag prints the JAX
    verb's usage line."""
    args = {"s3tables.bucket": "-get -name=nosuch",
            "s3tables.namespace": "-bucket=nosuch -list",
            "s3tables.table": "-bucket=nosuch -namespace=ns -list",
            "s3tables.tag": "-resource=nosuch -list"}[verb]
    got = {}
    for name, run in (("port", run_command), ("ref", ref_run_command)):
        with pytest.raises(RuntimeError) as e:
            run(filers[name].env, f"{verb} {args}")
        usage = run(filers[name].env, verb)
        got[name] = (str(e.value), usage)
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("NotFoundException: table bucket nosuch "
                              "not found")
    assert got["port"][1].startswith(f"usage: {verb} ")
