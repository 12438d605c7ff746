"""The port's security plane (`seaweedfs_tpu_torch/security.py` and its
call sites) on the CPU, against the JAX package's.
Tolerance: exact equality (tokens byte for byte, verdicts, statuses).

- tokens: both packages mint the same HS256 token for one key, claims
  and frozen clock; each decodes the other's; tamper, expiry and `nbf`;
- the guard's tables: `ip_whitelisted`, `check_admin`, `is_admin_path`
  and `check_path_fields` give the same answers in both packages;
- `load_security_toml`: the same dataclass fields for the same files;
- a port cluster under `security.toml` keys: admin routes and
  heartbeats without the admin JWT get 401, a write needs its fid's
  JWT, a read a read JWT, a token for another fid gets 401; replication,
  deletes, `ec.encode` and `ec.rebuild` (CPU codec) run signed; a
  whitelist without a key gates only the admin plane;
- the planes stand down under each key (`/status` ports 0, counted);
- mixed: the JAX client against a port volume server and the port's
  client against a JAX one, under one configuration.

Each test configures both packages' process-global security and resets
them after.
"""

import base64
import hashlib
import hmac
import json
import os
import time
import urllib.request

import pytest

from seaweedfs_tpu import operation as ref_operation
from seaweedfs_tpu import security as ref_security
from seaweedfs_tpu.server import httpd as ref_httpd
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu_torch import operation, security
from seaweedfs_tpu_torch.security import (JwtError, SecurityConfig,
                                          decode_jwt, gen_jwt)
from seaweedfs_tpu_torch.server import httpd
from seaweedfs_tpu_torch.server.httpd import http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import CommandEnv
from seaweedfs_tpu_torch.shell.commands import run_script
from seaweedfs_tpu_torch.storage.erasure_coding import ec_context

PULSE = 0.2
SEC_KW = dict(volume_write_key="write-secret",
              volume_read_key="read-secret", admin_key="admin-secret")


def raw_request(method, url, body=None, headers=None):
    """A request with no automatic admin JWT: an outsider."""
    req = urllib.request.Request("http://" + url, data=body,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(cond, what: str, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


@pytest.fixture
def both_configured():
    """Configure both packages alike; reset after."""
    def configure(**kw):
        security.configure(SecurityConfig(**kw))
        ref_security.configure(ref_security.SecurityConfig(**kw))
    yield configure
    security.configure(None)
    ref_security.configure(None)


@pytest.fixture(autouse=True)
def small_sizes(monkeypatch):
    monkeypatch.setattr(ec_context, "DEVICE_BATCH_SIZE", 1 << 20)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_REBUILD_SLICE_MB", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "1")


# -- tokens -----------------------------------------------------------------

CLAIM_SETS = [
    {"fid": "3,01637037d6"},
    {"admin": True},
    {"fid": ""},
    {"fid": "7,ff00000001deadbeef", "nbf": 1_700_000_000, "extra": [1, 2]},
]


@pytest.mark.parametrize("claims", CLAIM_SETS)
@pytest.mark.parametrize("expires", [0, 10, 60])
def test_tokens_equal_byte_for_byte(claims, expires, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.75)
    port_tok = gen_jwt("key-a", claims, expires)
    ref_tok = ref_security.gen_jwt("key-a", claims, expires)
    assert port_tok == ref_tok
    # each decodes the other's
    assert decode_jwt("key-a", ref_tok) == \
        ref_security.decode_jwt("key-a", port_tok)
    assert gen_jwt("", claims, expires) == "" == \
        ref_security.gen_jwt("", claims, expires)


def _forge(key: str, claims: dict) -> str:
    head = base64.urlsafe_b64encode(json.dumps(
        {"alg": "HS256", "typ": "JWT"},
        separators=(",", ":")).encode()).rstrip(b"=").decode()
    body = base64.urlsafe_b64encode(json.dumps(
        claims, separators=(",", ":"),
        sort_keys=True).encode()).rstrip(b"=").decode()
    sig = base64.urlsafe_b64encode(hmac.new(
        key.encode(), f"{head}.{body}".encode(),
        hashlib.sha256).digest()).rstrip(b"=").decode()
    return f"{head}.{body}.{sig}"


BAD_TOKENS = [
    ("wrong key", lambda: gen_jwt("other", {"fid": "1,01"}, 60)),
    ("tampered", lambda: (lambda t: t[:-3] + ("AAA" if t[-3:] != "AAA"
                                              else "BBB"))(
        gen_jwt("k", {"fid": "1,01"}, 60))),
    ("malformed", lambda: "a.b"),
    ("undecodable", lambda: "!!.??.**"),
    ("expired", lambda: _forge("k", {"fid": "1,01",
                                     "exp": int(time.time()) - 5})),
    ("not yet valid", lambda: _forge("k", {"fid": "1,01",
                                           "nbf": int(time.time()) + 60})),
    ("alg none", lambda: base64.urlsafe_b64encode(
        b'{"alg":"none"}').decode().rstrip("=") + "." +
        gen_jwt("k", {"fid": "1,01"}).split(".", 1)[1]),
]


@pytest.mark.parametrize("name,make", BAD_TOKENS,
                         ids=[b[0] for b in BAD_TOKENS])
def test_bad_tokens_refused_alike(name, make):
    tok = make()
    with pytest.raises(JwtError) as port_err:
        decode_jwt("k", tok)
    with pytest.raises(ref_security.JwtError) as ref_err:
        ref_security.decode_jwt("k", tok)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("query,headers", [
    ({"jwt": "q"}, {"Authorization": "Bearer h"}),
    ({}, {"Authorization": "Bearer h"}),
    ({}, {"Authorization": "bearer lower"}),
    ({}, {"Authorization": "Basic xyz"}),
    ({"jwt": ""}, {}),
])
def test_get_jwt_lookup_order(query, headers):
    assert security.get_jwt(query, headers) == \
        ref_security.get_jwt(query, headers)


# -- the guard's tables -------------------------------------------------------

WHITE = ["10.0.0.1", "192.168.0.0/16", "fd00::/8", "not-a-cidr/xx"]
IPS = ["10.0.0.1", "10.0.0.2", "192.168.5.9", "192.169.0.1", "fd00::1",
       "::1", "127.0.0.1", "", "garbage"]


@pytest.mark.parametrize("ip", IPS)
@pytest.mark.parametrize("admin_key,white", [
    ("", []), ("a", []), ("", WHITE), ("a", WHITE)])
def test_whitelist_and_check_admin_agree(ip, admin_key, white):
    port = SecurityConfig(admin_key=admin_key, white_list=list(white))
    ref = ref_security.SecurityConfig(admin_key=admin_key,
                                      white_list=list(white))
    assert port.ip_whitelisted(ip) == ref.ip_whitelisted(ip)
    assert port.enabled == ref.enabled
    good = ref.admin_jwt()
    for q, h in [({}, {}), ({"jwt": good}, {}),
                 ({}, {"Authorization": f"Bearer {good}"}),
                 ({}, {"Authorization": "Bearer " +
                       gen_jwt("a", {"admin": False}, 60)}),
                 ({}, {"Authorization": "Bearer " +
                       gen_jwt("b", {"admin": True}, 60)})]:
        assert port.check_admin(q, h, ip) == ref.check_admin(q, h, ip)


ROUTES = ["/admin/delete_volume", "/admin/ec/shard_read", "/admin",
          "/cluster/raft/vote", "/debug/traces", "/debug", "/vol/grow",
          "/vol/grow/x", "/cluster/lease_admin_token",
          "/cluster/release_admin_token", "/heartbeat", "/heartbeat/",
          "/dir/assign", "/dir/lookup", "/3,01637037d6", "/status",
          "/metrics", "/cluster/status", "/cluster/watch", "/vol/list"]


@pytest.mark.parametrize("path", ROUTES)
def test_is_admin_path_agrees(path):
    assert httpd.is_admin_path(path) == ref_httpd.is_admin_path(path)


@pytest.mark.parametrize("collection,ext", [
    ("", None), ("pics", ".dat"), ("a.b-c_d", ".ec13"), ("../x", None),
    ("a/b", None), ("ok", "/../../etc"), ("ok", ".ec1"), ("ok", ".ecx"),
    ("ok", ".vif"), ("ok", ".idx\x00"), ("x y", None), ("ok", ".dat/")])
def test_check_path_fields_agrees(collection, ext):
    def verdict(fn):
        try:
            fn(collection, ext)
            return None
        except ValueError as e:
            return str(e)
    assert verdict(security.check_path_fields) == \
        verdict(ref_security.check_path_fields)


# -- security.toml -------------------------------------------------------------

TOMLS = [
    "",
    '[jwt.signing]\nkey = "wkey"\nexpires_after_seconds = 11\n'
    '[jwt.signing.read]\nkey = "rkey"\n[admin]\nkey = "akey"\n'
    '[access]\nwhite_list = ["127.0.0.1/32"]\n',
    '[access]\nadmin_key = "legacy"\n',
    '[admin]\nkey = "new"\nexpires_after_seconds = 5\n'
    '[access]\nadmin_key = "legacy"\n',
    '[jwt.signing.read]\nkey = "r"\nexpires_after_seconds = 7\n',
    '[tls]\ncert = "only.crt"\n',
    '[tls]\nca = "a"\ncert = "b"\n',
    '[tls]\nca = "ca.crt"\ncert = "n.crt"\nkey = "n.key"\nmtls = true\n',
    '[tls]\nca = "ca.crt"\ncert = "n.crt"\nkey = "n.key"\n',
]


def _fields(cfg) -> dict:
    d = {k: v for k, v in vars(cfg).items() if k != "tls"}
    d["tls"] = None if cfg.tls is None else {
        k: v for k, v in vars(cfg.tls).items() if not k.startswith("_")}
    return d


@pytest.mark.parametrize("text", TOMLS)
def test_load_security_toml_agrees(text, tmp_path):
    p = tmp_path / "security.toml"
    p.write_text(text)

    def load(fn):
        try:
            return _fields(fn(str(p)))
        except ValueError as e:
            return str(e)
    assert load(security.load_security_toml) == \
        load(ref_security.load_security_toml)


# -- a port cluster under security.toml keys -----------------------------------

def _secure_cluster(tmp_path, n: int):
    master = MasterServer(volume_size_limit_mb=64).start()
    servers = []
    for i in range(n):
        d = tmp_path / f"vol{i}"
        d.mkdir()
        servers.append(VolumeServer([str(d)], device="cpu",
                                    master=master.url,
                                    pulse_seconds=PULSE).start())
    _wait(lambda: len(http_json("GET", f"{master.url}/cluster/status")
                      ["dataNodes"]) == n, f"{n} volume servers")
    return master, servers


@pytest.fixture
def secure_cluster(tmp_path, both_configured, request):
    """A master and 3 volume servers (7 for `pipeline` tests: RS(10,4)
    must survive a lost server) under the keys of SEC_KW."""
    both_configured(**SEC_KW)
    n = 7 if "pipeline" in request.node.name else 3
    master, servers = _secure_cluster(tmp_path, n)
    yield master, servers
    for vs in servers:
        vs.stop()
    master.stop()


def test_unauthenticated_admin_rejected(secure_cluster):
    master, servers = secure_cluster
    vs = servers[0]
    for method, url, body in [
            ("POST", f"{vs.url}/admin/delete_volume", b'{"volumeId": 1}'),
            ("GET", f"{vs.url}/admin/volume_file?volumeId=1&ext=.dat",
             None),
            ("POST", f"{vs.url}/admin/ec/rebuild", b'{"volumeId": 1}'),
            ("POST", f"{master.url}/vol/grow", b"{}"),
            ("POST", f"{master.url}/heartbeat", b'{"ip": "1.2.3.4"}'),
            ("POST", f"{master.url}/cluster/lease_admin_token", b"{}")]:
        status, got = raw_request(method, url, body,
                                  {"Content-Type": "application/json"})
        assert status == 401, (url, status, got)
        # a forged admin token (the wrong key) too
        bad = gen_jwt("wrong-key", {"admin": True}, 60)
        status, _ = raw_request(method, url, body,
                                {"Content-Type": "application/json",
                                 "Authorization": f"Bearer {bad}"})
        assert status == 401, url
    # a heartbeat without the admin JWT registers nothing
    st = http_json("GET", f"{master.url}/cluster/status")
    assert "1.2.3.4:0" not in st["dataNodes"]
    # the process's admin JWT rides the client's admin calls
    r = http_json("GET", f"{vs.url}/admin/ec/info?volumeId=77")
    assert "admin" not in r.get("error", "")


def test_write_requires_fid_jwt(secure_cluster):
    master, _ = secure_cluster
    a = operation.assign(master.url)
    assert a.auth, "the master minted no write token"
    assert ref_security.decode_jwt("write-secret", a.auth)["fid"] == a.fid
    status, body = raw_request("POST", f"{a.url}/{a.fid}", b"data")
    assert status == 401 and b"missing jwt" in body
    other = gen_jwt("write-secret", {"fid": "999,deadbeef"}, 10)
    status, body = raw_request("POST", f"{a.url}/{a.fid}", b"data",
                               {"Authorization": f"Bearer {other}"})
    assert status == 401 and b"used for" in body
    read_tok = gen_jwt("read-secret", {"fid": a.fid}, 10)
    status, _ = raw_request("POST", f"{a.url}/{a.fid}", b"data",
                            {"Authorization": f"Bearer {read_tok}"})
    assert status == 401
    status, body = raw_request("POST", f"{a.url}/{a.fid}", b"data",
                               {"Authorization": f"Bearer {a.auth}"})
    assert status == 201, body
    # ?jwt= is looked up first
    status, _ = raw_request("POST", f"{a.url}/{a.fid}?jwt={a.auth}",
                            b"data2")
    assert status == 201


def test_read_requires_read_jwt(secure_cluster):
    master, _ = secure_cluster
    fid = operation.submit(master.url, b"locked-read")
    assert operation.read(master.url, fid) == b"locked-read"
    loc = operation.lookup(master.url, int(fid.split(",")[0]))[0]
    status, _ = raw_request("GET", f"{loc['url']}/{fid}")
    assert status == 401
    status, _ = raw_request("GET", f"{loc['url']}/{fid}", headers={
        "Authorization": "Bearer " + gen_jwt("read-secret",
                                             {"fid": "1,ffff"}, 30)})
    assert status == 401
    rtok = gen_jwt("read-secret", {"fid": fid}, 30)
    status, body = raw_request("GET", f"{loc['url']}/{fid}",
                               headers={"Authorization": f"Bearer {rtok}"})
    assert status == 200 and body == b"locked-read"
    # a ranged read signs too
    assert operation.read(master.url, fid, 2, 4) == b"cked"
    # deletes need the write key
    status, _ = raw_request("DELETE", f"{loc['url']}/{fid}")
    assert status == 401
    operation.delete(master.url, fid)
    status, _ = raw_request("GET", f"{loc['url']}/{fid}",
                            headers={"Authorization": f"Bearer {rtok}"})
    assert status == 404


def test_planes_stand_down_under_keys(secure_cluster):
    master, servers = secure_cluster
    for vs in servers:
        st = http_json("GET", f"{vs.url}/status")
        assert st.get("readPlanePort", 0) == 0
        assert st.get("writePlanePort", 0) == 0
        assert not st.get("udsPath")
        assert vs.read_plane is None and vs.write_plane is None and \
            vs.uds_server is None
    from seaweedfs_tpu_torch import stats
    text = stats.PROCESS.render()
    for plane in ("uds", "read", "write"):
        assert f'volume_server_plane_stood_down_total{{plane="{plane}",' \
               f'reason="jwt"}}' in text


@pytest.mark.parametrize("kw,down", [
    ({"volume_read_key": "r"}, {"uds", "read"}),
    ({"volume_write_key": "w"}, {"write"}),
    ({"admin_key": "a"}, set()),
])
def test_planes_stand_down_under_each_key(kw, down, tmp_path,
                                          both_configured):
    both_configured(**kw)
    vs = VolumeServer([str(tmp_path)], device="cpu").start()
    try:
        up = {"uds": vs.uds_server, "read": vs.read_plane,
              "write": vs.write_plane}
        assert {k for k, v in up.items() if v is None} == down
    finally:
        vs.stop()


def test_filer_planes_stand_down_under_keys(secure_cluster, tmp_path):
    """A filer over a cluster with write and read keys: its native meta
    plane's fid pool stays dry (assigns carry a write JWT) and its read
    plane takes no entry (reads need a read JWT), each counted; files
    still write and read on its Python port, signed."""
    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    master, _ = secure_cluster
    fs = FilerServer(master.url, store_path=str(tmp_path / "f.db")).start()
    try:
        for i in range(4):
            st, body, _ = httpd.http_bytes("PUT", f"{fs.url}/d/f{i}",
                                           b"x" * (100 + i))
            assert st == 201, body
            st, body, _ = httpd.http_bytes("GET", f"{fs.url}/d/f{i}")
            assert (st, body) == (200, b"x" * (100 + i))

        def counted(plane):
            return stats.PROCESS.counter_value(
                "filer_native_plane_stood_down_total", plane=plane,
                reason="jwt") or 0
        assert fs.native_meta is not None and fs.native_read is not None
        _wait(lambda: counted("meta") > 0, "the meta plane's dry pool")
        assert counted("read") > 0
    finally:
        fs.stop()


def test_secure_cluster_full_pipeline(secure_cluster):
    """Replication, delete fan-out and the EC shell pipeline (encode,
    rebuild after a lost server, reads across it) under full lockdown:
    every internal hop carries a token."""
    master, servers = secure_cluster
    a = operation.assign(master.url, replication="001")
    operation.upload(a.url, a.fid, b"sec-rep", auth=a.auth)
    _wait(lambda: len(operation.lookup(master.url, int(a.fid.split(",")[0]),
                                       use_cache=False)) == 2, "replicas")
    for loc in operation.lookup(master.url, int(a.fid.split(",")[0])):
        rtok = gen_jwt("read-secret", {"fid": a.fid}, 30)
        status, body = raw_request(
            "GET", f"{loc['url']}/{a.fid}",
            headers={"Authorization": f"Bearer {rtok}"})
        assert (status, body) == (200, b"sec-rep"), loc
    operation.delete(master.url, a.fid)

    payloads = {operation.submit(master.url, os.urandom(3000 + i),
                                 collection="sec"): None
                for i in range(40)}
    fids = list(payloads)
    for f in fids:
        payloads[f] = operation.read(master.url, f)
    vid = int(fids[0].split(",")[0])
    env = CommandEnv(master.url)
    out = run_script(env, f"lock; ec.encode -volumeId={vid} "
                          f"-collection=sec; unlock")
    assert any(f"volume {vid}" in o for o in out), out
    _wait(lambda: http_json("GET", f"{master.url}/dir/ec_lookup?"
                                   f"volumeId={vid}").get(
        "shardIdLocations"), "ec registered")
    for f in fids:
        if int(f.split(",")[0]) == vid:
            assert operation.read(master.url, f) == payloads[f]
    # lose a shard holder that is not the reader, then rebuild
    locs = http_json("GET", f"{master.url}/dir/ec_lookup?volumeId={vid}")
    holders = sorted({x["url"] for x in locs["shardIdLocations"]})
    victim = next(vs for vs in servers if vs.url == holders[-1])
    victim.stop()
    servers.remove(victim)
    _wait(lambda: victim.url not in http_json(
        "GET", f"{master.url}/cluster/status")["dataNodes"],
        "victim dropped", timeout=20)
    out = run_script(env, "lock; ec.rebuild -collection=sec; unlock")
    assert not any("error" in o.lower() for o in out), out
    for vs in servers:
        vs.ec_reader.forget(vid)
        vs._nc_drop_volume(vid)
    for f in fids:
        if int(f.split(",")[0]) == vid:
            assert operation.read(master.url, f) == payloads[f]


def test_worker_ec_job_pipeline_on_secured_cluster(secure_cluster,
                                                   tmp_path):
    """The maintenance plane under full lockdown: the worker pulls the
    volume off its server, encodes it and spreads the shards with the
    admin JWT its process holds; every needle reads back signed."""
    from seaweedfs_tpu_torch.plugin import (AdminServer, EcEncodeHandler,
                                            EcRebuildHandler, PluginWorker)
    master, _ = secure_cluster
    fids = {operation.submit(master.url, os.urandom(2000 + i),
                             collection="job"): None for i in range(24)}
    for f in fids:
        fids[f] = operation.read(master.url, f)
    vid = int(next(iter(fids)).split(",")[0])
    admin = AdminServer(master.url, detection_interval=3600).start()
    worker = PluginWorker(admin.url, master.url, str(tmp_path / "worker"),
                          [EcEncodeHandler(device="cpu"),
                           EcRebuildHandler()], poll_wait=1.0).start()
    try:
        status, _ = raw_request("GET", f"{admin.url}/debug/traces")
        assert status == 401
        r = http_json("POST", f"{admin.url}/maintenance/submit_job",
                      {"jobType": "erasure_coding",
                       "params": {"volumeId": vid,
                                  "collection": "job"}})
        assert "jobId" in r, r
        _wait(lambda: http_json("GET", f"{admin.url}/maintenance/job?id="
                                       f"{r['jobId']}")["status"]
              in ("done", "failed"), "job ends", timeout=120)
        job = http_json("GET", f"{admin.url}/maintenance/job?id="
                               f"{r['jobId']}")
        assert job["status"] == "done", job
        _wait(lambda: len({s for loc in http_json(
            "GET", f"{master.url}/dir/ec_lookup?volumeId={vid}").get(
                "shardIdLocations", []) for s in loc["shardIds"]}) == 14,
            "14 shards registered")
        for f, data in fids.items():
            if int(f.split(",")[0]) == vid:
                assert operation.read(master.url, f) == data
    finally:
        worker.stop()
        admin.stop()


def test_assign_rejects_traversal_collection(secure_cluster):
    master, _ = secure_cluster
    status, body = raw_request(
        "GET", f"{master.url}/dir/assign?collection=../../tmp/evil")
    assert status == 400 and b"unacceptable" in body


def test_whitelist_only_gates_admin(tmp_path, both_configured):
    """guard.go: a whitelist without a key is a gate for the admin
    plane, and only for it."""
    both_configured(white_list=["10.9.9.9"])
    master = MasterServer().start()
    vs = VolumeServer([str(tmp_path)], device="cpu").start()
    try:
        status, body = raw_request(
            "POST", f"{vs.url}/admin/delete_volume", b'{"volumeId":1}',
            {"Content-Type": "application/json"})
        assert status == 401 and b"white list" in body
        status, _ = raw_request("GET", f"{master.url}/cluster/status")
        assert status == 200
        status, _ = raw_request("GET", f"{vs.url}/status")
        assert status == 200
    finally:
        vs.stop()
        master.stop()


# -- across packages -------------------------------------------------------------

@pytest.mark.parametrize("ctl", ["port", "ref"])
def test_clients_cross_packages(ctl, tmp_path, both_configured):
    """The other package's client writes, reads and deletes on a cluster
    under one security configuration: the tokens are the same."""
    both_configured(**SEC_KW)
    if ctl == "port":
        master = MasterServer().start()
        vs = VolumeServer([str(tmp_path)], device="cpu", master=master.url,
                          pulse_seconds=PULSE).start()
        client = ref_operation
    else:
        master = RefMaster().start()
        vs = RefServer([str(tmp_path)], master.url,
                       pulse_seconds=PULSE).start()
        client = operation
    try:
        _wait(lambda: vs.url in http_json(
            "GET", f"{master.url}/cluster/status")["dataNodes"],
            "volume server registered")
        fid = client.submit(master.url, b"across")
        assert client.read(master.url, fid) == b"across"
        other = operation if client is ref_operation else ref_operation
        assert other.read(master.url, fid) == b"across"
        client.delete(master.url, fid)
        loc = client.lookup(master.url, int(fid.split(",")[0]))[0]
        status, _ = raw_request("GET", f"{loc['url']}/{fid}")
        assert status == 401
    finally:
        vs.stop()
        master.stop()
