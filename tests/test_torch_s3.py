"""The port's S3 gateway (`seaweedfs_tpu_torch/s3/`) on the CPU, against
the JAX package's.  Tolerance: exact equality (signatures, statuses,
bytes, and the XML bodies once request-specific values are masked).

- the JAX suites `tests/test_s3.py` and `tests/test_s3_advanced.py` run
  on the port's gateway over a port cluster, in both attachments (an
  in-process `Filer` and the `FilerClient` of `s3 -filer`): their
  sources are loaded with the server classes taken from the port
  (`load_jax_suite`), and their clients (the JAX SigV4 signer and HTTP
  client) are kept, so every request crosses packages;
- SigV4: the same header signature, presigned URL and chunk signatures
  from both `auth.py`s for one fixed date, and each verifier accepts the
  other's requests;
- one scripted request sequence against a JAX gateway and a port
  gateway: equal status codes and equal XML once request ids, ETags of
  random data, version ids, upload ids and dates are masked;
- the port's gateway over a secured port cluster (TLS with mTLS and the
  three JWT keys): a PUT runs the whole signed write path (gateway,
  filer, assign with its JWT, volume checking it) and reads come back
  with read JWTs;
- `s3` on the command line: each flag of the identity and metrics
  planes (`-stsKey`, `-rolesFile`, `-kmsEndpoint`, `-kmsCloud`,
  `-metricsPort`, `-metricsAddress`) run against its local stand-in.
"""

import os
import re
import subprocess
import sys
import time
import types
import urllib.parse

import pytest

from jax_suite import load_suite
from seaweedfs_tpu.s3 import S3ApiServer as RefS3
from seaweedfs_tpu.s3 import auth as ref_auth
from seaweedfs_tpu.s3 import chunked as ref_chunked
from seaweedfs_tpu.server.filer_server import FilerServer as RefFiler
from seaweedfs_tpu.server.httpd import http_bytes as ref_http_bytes
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu_torch import security
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.s3 import auth, chunked
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
AK, SK = "AKIDEXAMPLE", "secretkey123"
CREDS = {AK: SK}
PULSE = 0.3

# the server side of a JAX suite comes from the port; the clients (the
# SigV4 signer, the HTTP client, the shell) stay the JAX package's
_PORTED = ("seaweedfs_tpu.s3", "seaweedfs_tpu.iam",
           "seaweedfs_tpu.server.filer_server",
           "seaweedfs_tpu.server.master_server",
           "seaweedfs_tpu.filer.client")


def port_volume_server(dirs, master, **kw):
    """The JAX suites' `VolumeServer(dirs, master, ...)` call on a port
    volume server with the CPU codec."""
    return VolumeServer(dirs, device="cpu", master=master, **kw)


def load_jax_suite(name: str, exclude=()) -> dict:
    """The test functions of `tests/<name>.py`, its source executed with
    the server classes imported from the port (`jax_suite.load_suite`):
    {exported name: fn}.  The suite's own fixtures are not exported; the
    importing module provides them, built on the port.  `exclude` names
    tests of what the port does not have (each with its reason at the
    call)."""
    return load_suite(name, _PORTED, exclude,
                      overrides={"VolumeServer": port_volume_server})


def _start_cluster(tmp_path, n_volumes=2):
    master = MasterServer(pulse_seconds=PULSE).start()
    servers = [VolumeServer([str(tmp_path / f"v{i}")], device="cpu",
                            master=master.url, pulse_seconds=PULSE).start()
               for i in range(n_volumes)]
    deadline = time.monotonic() + 15
    while len(http_json("GET", f"{master.url}/cluster/status")
              ["dataNodes"]) < n_volumes:
        assert time.monotonic() < deadline, "volume servers registered"
        time.sleep(0.05)
    filer = FilerServer(master.url).start()
    return master, servers, filer


def _stop_cluster(master, servers, filer):
    filer.stop()
    for vs in servers:
        vs.stop()
    master.stop()


@pytest.fixture(params=["inprocess", "remote"])
def s3(tmp_path, request):
    """The port's gateway in both attachments over a port cluster."""
    master, servers, filer = _start_cluster(tmp_path)
    backend = filer.filer if request.param == "inprocess" \
        else FilerClient(filer.url)
    gw = S3ApiServer(backend, credentials=CREDS).start()
    yield gw
    gw.stop()
    _stop_cluster(master, servers, filer)


globals().update(load_jax_suite("test_s3"))
globals().update(load_jax_suite("test_s3_advanced"))


# -- SigV4 across packages -----------------------------------------------------

DATE = "20260317T101112Z"
REQUESTS = [
    ("GET", "/", {}, {}, b""),
    ("PUT", "/bkt", {}, {}, b""),
    ("PUT", "/bkt/a b/ü.txt", {}, {"Content-Type": "text/plain",
                                    "x-amz-meta-k": "v"}, b"hello"),
    ("GET", "/bkt", {"list-type": "2", "prefix": "a b/",
                     "max-keys": "7"}, {}, b""),
    ("POST", "/bkt/k", {"uploads": ""}, {}, b""),
    ("DELETE", "/bkt/k", {"versionId": "x~y"}, {}, b""),
]


@pytest.mark.parametrize("method,path,query,headers,body", REQUESTS)
def test_sigv4_signatures_equal(method, path, query, headers, body,
                                monkeypatch):
    host = "127.0.0.1:8333"
    port_h = auth.sign_request(method, host, path, query, headers, body,
                               AK, SK, amz_date=DATE)
    ref_h = ref_auth.sign_request(method, host, path, query, headers,
                                  body, AK, SK, amz_date=DATE)
    assert port_h == ref_h
    assert auth.presign_url(method, host, path, query, AK, SK, 600,
                            amz_date=DATE) == \
        ref_auth.presign_url(method, host, path, query, AK, SK, 600,
                             amz_date=DATE)
    # each verifier accepts the other's signature (the clock frozen at
    # the signing date)
    import datetime as dt
    frozen = dt.datetime(2026, 3, 17, 10, 11, 30,
                         tzinfo=dt.timezone.utc)

    class _Frozen(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return frozen
    monkeypatch.setattr(auth, "datetime", _Frozen)
    monkeypatch.setattr(ref_auth, "datetime", _Frozen)
    wire = auth.uri_encode(path, False)
    for verifier, hdrs in ((auth.SigV4Verifier(CREDS), ref_h),
                           (ref_auth.SigV4Verifier(CREDS), port_h)):
        ok, who, _ = verifier.verify(method, wire, query, hdrs, body)
        assert (ok, who) == (True, AK)
    url = auth.presign_url(method, host, path, query, AK, SK, 600,
                           amz_date=DATE)
    q = dict(urllib.parse.parse_qsl(url.split("?", 1)[1],
                                    keep_blank_values=True))
    for verifier in (auth.SigV4Verifier(CREDS),
                     ref_auth.SigV4Verifier(CREDS)):
        ok, who, _ = verifier.verify(method, wire, q, {"host": host}, b"")
        assert (ok, who) == (True, AK)


@pytest.mark.parametrize("size,chunk", [(0, 8192), (100, 64),
                                        (51200, 8192), (70000, 65536)])
def test_chunk_signatures_equal(size, chunk):
    payload = bytes(range(256)) * (size // 256) + b"x" * (size % 256)
    key = auth.signing_key(SK, DATE[:8], "us-east-1")
    scope = f"{DATE[:8]}/us-east-1/s3/aws4_request"
    ctx = auth.AuthContext(AK, "ab" * 32, key, DATE, scope,
                           auth.STREAMING_PAYLOAD)
    rctx = ref_auth.AuthContext(AK, "ab" * 32, key, DATE, scope,
                                ref_auth.STREAMING_PAYLOAD)
    body = chunked.encode_streaming_body(payload, ctx, chunk)
    assert body == ref_chunked.encode_streaming_body(payload, rctx, chunk)
    assert chunked.decode_streaming_body(body, rctx) == payload
    assert ref_chunked.decode_streaming_body(body, ctx) == payload
    bad = body.replace(b"chunk-signature=", b"chunk-signature=0", 1)
    with pytest.raises(chunked.ChunkedDecodeError):
        chunked.decode_streaming_body(bad, ctx)


# -- one scripted sequence on a JAX gateway and a port gateway -------------------

_MASKS = [
    (rb"<ETag>[^<]*</ETag>", b"<ETag>*</ETag>"),
    (rb"<LastModified>[^<]*</LastModified>", b"<LastModified>*"
                                            b"</LastModified>"),
    (rb"<CreationDate>[^<]*</CreationDate>", b"<CreationDate>*"
                                            b"</CreationDate>"),
    (rb"<UploadId>[^<]*</UploadId>", b"<UploadId>*</UploadId>"),
    (rb"<VersionId>[^<]*</VersionId>", b"<VersionId>*</VersionId>"),
    (rb"<NextVersionIdMarker>[^<]*</NextVersionIdMarker>",
     b"<NextVersionIdMarker>*</NextVersionIdMarker>"),
    (rb"<RequestId>[^<]*</RequestId>", b"<RequestId>*</RequestId>"),
    (rb"<RetainUntilDate>[^<]*</RetainUntilDate>",
     b"<RetainUntilDate>*</RetainUntilDate>"),
]


def _mask(body: bytes) -> bytes:
    for pat, rep in _MASKS:
        body = re.sub(pat, rep, body)
    return body


def _script():
    """(method, path, query, headers, body) in order: buckets, objects,
    ranges, listings, copy, batch delete, multipart, versioning with
    delete markers, ACLs, object lock, CORS, lifecycle, policy and the
    refusals.  (Tagging differs by design: `test_tagging_c8`.)"""
    mp = b"M" * (5 << 20)
    cors = (b"<CORSConfiguration><CORSRule><AllowedOrigin>"
            b"https://a.example</AllowedOrigin><AllowedMethod>GET"
            b"</AllowedMethod></CORSRule></CORSConfiguration>")
    life = (b"<LifecycleConfiguration><Rule><ID>r1</ID><Filter><Prefix>"
            b"tmp/</Prefix></Filter><Status>Enabled</Status><Expiration>"
            b"<Days>3</Days></Expiration></Rule></LifecycleConfiguration>")
    delete = (b"<Delete><Object><Key>d/1</Key></Object><Object><Key>d/2"
              b"</Key></Object><Object><Key>nope</Key></Object></Delete>")
    policy = (b'{"Version":"2012-10-17","Statement":[{"Effect":"Allow",'
              b'"Principal":"*","Action":"s3:GetObject","Resource":'
              b'"arn:aws:s3:::pub/*"}]}')
    steps = [
        ("GET", "/", {}, {}, b""),
        ("PUT", "/alpha", {}, {}, b""),
        ("PUT", "/alpha", {}, {}, b""),
        ("PUT", "/Bad_Name", {}, {}, b""),
        ("HEAD", "/alpha", {}, {}, b""),
        ("HEAD", "/missing", {}, {}, b""),
        ("GET", "/", {}, {}, b""),
        ("PUT", "/alpha/k1", {}, {"Content-Type": "text/plain"},
         b"hello world"),
        ("GET", "/alpha/k1", {}, {}, b""),
        ("GET", "/alpha/k1", {}, {"Range": "bytes=2-6"}, b""),
        ("GET", "/alpha/k1", {}, {"Range": "bytes=-3"}, b""),
        ("GET", "/alpha/k1", {}, {"Range": "bytes=99-"}, b""),
        ("HEAD", "/alpha/k1", {}, {}, b""),
        ("GET", "/alpha/nokey", {}, {}, b""),
    ]
    for i in range(12):
        steps.append(("PUT", f"/alpha/dir{i % 3}/f{i:02d}", {}, {},
                      b"%d" % i * (i + 1)))
    steps += [
        ("GET", "/alpha", {"list-type": "2"}, {}, b""),
        ("GET", "/alpha", {"list-type": "2", "delimiter": "/"}, {}, b""),
        ("GET", "/alpha", {"list-type": "2", "prefix": "dir1/",
                           "max-keys": "2"}, {}, b""),
        ("GET", "/alpha", {"prefix": "dir2/", "max-keys": "3"}, {}, b""),
        ("GET", "/alpha", {"list-type": "2", "start-after": "dir1/f07"},
         {}, b""),
        ("PUT", "/alpha/copy", {}, {"x-amz-copy-source": "/alpha/k1"},
         b""),
        ("GET", "/alpha/copy", {}, {}, b""),
        ("PUT", "/alpha/d/1", {}, {}, b"one"),
        ("PUT", "/alpha/d/2", {}, {}, b"two"),
        ("POST", "/alpha", {"delete": ""}, {}, delete),
        ("GET", "/alpha", {"list-type": "2", "prefix": "d/"}, {}, b""),
        ("GET", "/alpha/k1", {"acl": ""}, {}, b""),
        ("PUT", "/alpha/k1", {"acl": ""}, {"x-amz-acl": "public-read"},
         b""),
        ("GET", "/alpha/k1", {"acl": ""}, {}, b""),
        ("PUT", "/alpha", {"cors": ""}, {}, cors),
        ("GET", "/alpha", {"cors": ""}, {}, b""),
        ("PUT", "/alpha", {"lifecycle": ""}, {}, life),
        ("GET", "/alpha", {"lifecycle": ""}, {}, b""),
        ("DELETE", "/alpha", {"lifecycle": ""}, {}, b""),
        ("POST", "/alpha/big", {"uploads": ""}, {}, b""),
        # multipart continues in _run with the upload id
        ("PUT", "/ver", {}, {}, b""),
        ("PUT", "/ver", {"versioning": ""}, {},
         b"<VersioningConfiguration><Status>Enabled</Status>"
         b"</VersioningConfiguration>"),
        ("GET", "/ver", {"versioning": ""}, {}, b""),
        ("PUT", "/ver/x", {}, {}, b"v1"),
        ("PUT", "/ver/x", {}, {}, b"v2"),
        ("GET", "/ver/x", {}, {}, b""),
        ("DELETE", "/ver/x", {}, {}, b""),
        ("GET", "/ver/x", {}, {}, b""),
        ("GET", "/ver", {"versions": ""}, {}, b""),
        ("GET", "/ver", {"list-type": "2"}, {}, b""),
        ("PUT", "/locked", {}, {"x-amz-bucket-object-lock-enabled":
                                "true"}, b""),
        ("GET", "/locked", {"object-lock": ""}, {}, b""),
        ("PUT", "/pub", {}, {}, b""),
        ("PUT", "/pub", {"policy": ""}, {}, policy),
        ("PUT", "/pub/open", {}, {}, b"public"),
        ("DELETE", "/alpha", {}, {}, b""),
        ("DELETE", "/nosuch", {}, {}, b""),
        ("DELETE", "/alpha/k1", {}, {}, b""),
        ("DELETE", "/alpha/k1", {}, {}, b""),
        ("GET", "/", {}, {"X-Amz-Target": "S3Tables.ListTableBuckets"},
         b""),
    ]
    return steps, mp


def _run(url: str) -> list:
    """The script against the gateway at `url`: (status, masked body)
    of each step, plus the unsigned and multipart legs."""
    steps, mp = _script()
    out = []
    upload = None

    def send(method, path, query, headers, body, signed=True):
        if signed:
            headers = ref_auth.sign_request(method, url, path, query,
                                            headers, body, AK, SK)
        qs = urllib.parse.urlencode(query)
        wire = ref_auth.uri_encode(path, False)
        return ref_http_bytes(method, f"{url}{wire}" +
                              (f"?{qs}" if qs else ""),
                              body or None, headers)

    for method, path, query, headers, body in steps:
        st, b, h = send(method, path, query, headers, body)
        if query == {"uploads": ""}:
            upload = re.search(rb"<UploadId>([^<]*)</UploadId>", b)
            upload = upload.group(1).decode() if upload else ""
            parts = []
            for n in (1, 2):
                pst, _, ph = send("PUT", path, {"partNumber": str(n),
                                                "uploadId": upload},
                                  {}, mp if n == 1 else b"tail")
                out.append(("part", pst))
                parts.append(ph.get("ETag", ""))
            lst, lb, _ = send("GET", path, {"uploadId": upload}, {}, b"")
            out.append(("list parts", lst, _mask(lb)))
            done = ("<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag>"
                f"</Part>" for n, e in enumerate(parts, 1)) +
                "</CompleteMultipartUpload>").encode()
            cst, cb, _ = send("POST", path, {"uploadId": upload}, {}, done)
            out.append(("complete", cst, _mask(cb)))
            gst, gb, _ = send("GET", path, {}, {}, b"")
            out.append(("get mp", gst, gb == mp + b"tail"))
        out.append((method, path, sorted(query), st,
                    _mask(b) if method != "GET" or b.startswith(b"<?xml")
                    else b))
    # the refusals: unsigned, a bad signature, the public policy
    out.append(("unsigned", send("GET", "/", {}, {}, b"",
                                 signed=False)[0]))
    bad = ref_auth.sign_request("GET", url, "/", {}, {}, b"", AK, "WRONG")
    out.append(("bad sig", ref_http_bytes("GET", f"{url}/", None,
                                          bad)[0]))
    out.append(("anon policy read", send("GET", "/pub/open", {}, {}, b"",
                                         signed=False)[:2]))
    out.append(("anon policy write", send("PUT", "/pub/x", {}, {}, b"x",
                                          signed=False)[0]))
    return out


@pytest.mark.parametrize("attachment", ["inprocess", "remote"])
def test_scripted_sequence_same_on_both_gateways(attachment, tmp_path,
                                                 monkeypatch):
    from seaweedfs_tpu.filer.client import FilerClient as RefClient
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE", "0")
    rm = RefMaster().start()
    rvs = [RefServer([str(tmp_path / f"r{i}")], rm.url,
                     pulse_seconds=PULSE).start() for i in range(2)]
    master, servers, filer = _start_cluster(tmp_path)
    deadline = time.monotonic() + 15
    while len(http_json("GET", f"{rm.url}/cluster/status")
              ["dataNodes"]) < 2:
        assert time.monotonic() < deadline, "JAX volume servers registered"
        time.sleep(0.05)
    rf = RefFiler(rm.url).start()
    if attachment == "inprocess":
        rgw = RefS3(rf.filer, credentials=CREDS).start()
        gw = S3ApiServer(filer.filer, credentials=CREDS).start()
    else:
        rgw = RefS3(RefClient(rf.url), credentials=CREDS).start()
        gw = S3ApiServer(FilerClient(filer.url), credentials=CREDS).start()
    try:
        ref_out = _run(rgw.url)
        port_out = _run(gw.url)
        assert len(ref_out) == len(port_out) > 70
        for r, p in zip(ref_out, port_out):
            assert r == p
    finally:
        rgw.stop()
        gw.stop()
        rf.stop()
        for vs in rvs:
            vs.stop()
        rm.stop()
        _stop_cluster(master, servers, filer)


TAGS = (b"<Tagging><TagSet><Tag><Key>k</Key><Value>v</Value></Tag>"
        b"</TagSet></Tagging>")


def test_tagging_c8(s3, tmp_path):
    """C8: the JAX gateway has no tagging and takes `?tagging` for a
    plain object request, so a PUT of a tag set overwrites the object and
    a DELETE deletes it; the port answers 501 and the object stays."""
    def send(url, method, path, query=None, body=b""):
        query = query or {}
        h = ref_auth.sign_request(method, url, path, query, {}, body,
                                  AK, SK)
        qs = urllib.parse.urlencode(query)
        return ref_http_bytes(method, f"{url}{path}" +
                              (f"?{qs}" if qs else ""), body or None, h)
    for method, body in (("PUT", TAGS), ("GET", b""), ("DELETE", b"")):
        send(s3.url, "PUT", "/tg")
        send(s3.url, "PUT", "/tg/obj", body=b"precious")
        st, got, _ = send(s3.url, method, "/tg/obj", {"tagging": ""}, body)
        assert st == 501 and b"NotImplemented" in got
        assert send(s3.url, "GET", "/tg/obj")[:2] == (200, b"precious")
    # the JAX gateway's fault, shown on its own cluster
    rm = RefMaster().start()
    rvs = RefServer([str(tmp_path / "ref")], rm.url,
                    pulse_seconds=PULSE).start()
    deadline = time.monotonic() + 15
    while not http_json("GET", f"{rm.url}/cluster/status")["dataNodes"]:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    rf = RefFiler(rm.url).start()
    rgw = RefS3(rf.filer, credentials=CREDS).start()
    try:
        send(rgw.url, "PUT", "/tg")
        send(rgw.url, "PUT", "/tg/obj", body=b"precious")
        assert send(rgw.url, "PUT", "/tg/obj", {"tagging": ""},
                    TAGS)[0] == 200
        assert send(rgw.url, "GET", "/tg/obj")[1] == TAGS
    finally:
        rgw.stop()
        rf.stop()
        rvs.stop()
        rm.stop()


# -- the gateway on a secured cluster ----------------------------------------------

def test_gateway_on_secured_cluster(tmp_path):
    """TLS with mTLS and all three keys: the gateway's PUTs run the
    signed write path end to end and come back with read JWTs; the
    gateway itself answers over TLS and reports aws:SecureTransport."""
    pytest.importorskip("cryptography")
    from seaweedfs_tpu_torch.tls import TlsConfig, generate_cluster_certs
    p = generate_cluster_certs(str(tmp_path / "pki"))
    security.configure(security.SecurityConfig(
        volume_write_key="w", volume_read_key="r", admin_key="a",
        tls=TlsConfig(p["ca"], p["cert"], p["key"],
                      require_client_cert=True)))
    try:
        master, servers, filer = _start_cluster(tmp_path)
        gw = S3ApiServer(FilerClient(filer.url), credentials=CREDS).start()
        try:
            def send(method, path, body=b""):
                h = auth.sign_request(method, gw.url, path, {}, {}, body,
                                      AK, SK)
                return http_bytes(method, f"{gw.url}{path}", body or None, h)
            assert send("PUT", "/sec")[0] == 200
            blobs = {f"/sec/o{i}": os.urandom(1000 + 4096 * i)
                     for i in range(6)}
            blobs["/sec/big"] = os.urandom(9 << 20)   # several chunks
            for path, data in blobs.items():
                assert send("PUT", path, data)[0] == 200
            for path, data in blobs.items():
                st, body, _ = send("GET", path)
                assert (st, body) == (200, data)
            # a read straight off a volume needs a read JWT
            e = filer.filer.find_entry("/buckets/sec/o0")
            fid = e.chunks[0].fid if hasattr(e.chunks[0], "fid") else \
                e.chunks[0].file_id
            vid = int(fid.split(",")[0])
            loc = http_json("GET", f"{master.url}/dir/lookup?volumeId="
                                   f"{vid}")["locations"][0]["url"]
            assert http_bytes("GET", f"{loc}/{fid}")[0] == 401
            # the policy context sees TLS
            assert gw._policy_context(types.SimpleNamespace(
                remote_ip="127.0.0.1", headers={}, query={}))[
                "aws:SecureTransport"] == "true"
        finally:
            gw.stop()
            _stop_cluster(master, servers, filer)
    finally:
        security.configure(None)


# -- the command line -------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


@pytest.mark.parametrize("flag", ["-stsKey", "-rolesFile", "-kmsEndpoint",
                                  "-kmsCloud", "-metricsPort",
                                  "-metricsAddress"])
def test_s3_runs_each_flag_against_its_stand_in(flag, tmp_path):
    """`s3 -filer F` with each flag of the identity and metrics planes,
    driven against its local stand-in: temporary credentials minted
    under `-stsKey` (with the roles of `-rolesFile`), SSE-KMS through a
    KMS stub (`-kmsEndpoint`) and an OpenBao fake (`-kmsCloud`), the
    per-bucket metrics on their own listener (`-metricsPort`) and pushes
    to a pushgateway stand-in (`-metricsAddress`)."""
    import signal
    from seaweedfs_tpu_torch.iam import kms_aws, kms_cloud
    from seaweedfs_tpu_torch.iam.kms import LocalKms
    from seaweedfs_tpu_torch.iam.sts import RoleStore, StsService
    from seaweedfs_tpu_torch.iam.identity import Identity
    from seaweedfs_tpu_torch.server.httpd import HttpServer
    master, servers, filer = _start_cluster(tmp_path)
    extra, stand_in, pushes = [], None, []
    sts_key, roles = "sts-key", str(tmp_path / "roles.json")
    if flag in ("-stsKey", "-rolesFile"):
        extra = ["-stsKey", sts_key]
        if flag == "-rolesFile":
            RoleStore(roles).put("writer", ["Admin"], trust=[AK])
            extra += ["-rolesFile", roles]
    elif flag == "-kmsEndpoint":
        backend = LocalKms(str(tmp_path / "kms.json"))
        backend.create_key(alias="aws/s3")
        stand_in = kms_aws.KmsStubServer(backend).start()
        extra = ["-kmsEndpoint", f"{stand_in.url},AK,SK"]
    elif flag == "-kmsCloud":
        stand_in = kms_cloud.FakeOpenBaoServer().start()
        extra = ["-kmsCloud", f"openbao:{stand_in.url},transit-key,"
                              f"{stand_in.token}"]
    elif flag == "-metricsPort":
        mport = _free_port()
        extra = ["-metricsPort", str(mport)]
    else:
        stand_in = HttpServer()
        stand_in.fallback = lambda req: (pushes.append(req.path) or 200,
                                         {})
        stand_in.start()
        extra = ["-metricsAddress", stand_in.url, "-metricsIntervalSec",
                 "1"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "s3", "-port", "0",
         "-filer", filer.url, "-accessKey", AK, "-secretKey", SK] + extra,
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"s3 gateway listening on (\S+)", line)
        assert m, line
        url = m.group(1)

        def send(method, path, body=b"", headers=None, keys=(AK, SK)):
            h = auth.sign_request(method, url, path, {}, dict(headers or {}),
                                  body, *keys)
            return http_bytes(method, f"{url}{path}", body or None, h)
        assert send("PUT", "/flags")[0] == 200
        if flag in ("-stsKey", "-rolesFile"):
            store = RoleStore(roles if flag == "-rolesFile" else None)
            if flag == "-stsKey":
                store.put("writer", ["Admin"], trust=[AK])
            creds = StsService(sts_key, store).assume_role(
                Identity(AK), "writer")
            keys = (creds["AccessKeyId"], creds["SecretAccessKey"])
            tok = {"x-amz-security-token": creds["SessionToken"]}
            assert send("PUT", "/flags/t.txt", b"temp", tok, keys)[0] == 200
            assert send("GET", "/flags/t.txt", b"", tok, keys)[:2] == \
                (200, b"temp")
            assert send("GET", "/flags/t.txt", b"", None, keys)[0] == 403
            other = StsService("another-key", store).assume_role(
                Identity(AK), "writer")
            assert send("GET", "/flags/t.txt", b"", {
                "x-amz-security-token": other["SessionToken"]},
                (other["AccessKeyId"], other["SecretAccessKey"]))[0] == 403
        elif flag in ("-kmsEndpoint", "-kmsCloud"):
            body = os.urandom(100_000)
            st, _, h = send("PUT", "/flags/sec.bin", body, {
                "x-amz-server-side-encryption": "aws:kms"})
            assert st == 200
            assert h.get("x-amz-server-side-encryption") == "aws:kms"
            assert send("GET", "/flags/sec.bin")[:2] == (200, body)
            stored = filer.filer.read_file("/buckets/flags/sec.bin")
            assert len(stored) == len(body) and stored != body
        elif flag == "-metricsPort":
            assert f"(metrics 127.0.0.1:{mport}/metrics)" in line
            st, text, _ = http_bytes("GET", f"127.0.0.1:{mport}/metrics")
            assert st == 200
            assert b'bucket="flags"' in text and b"process_cpu" in text
        else:
            assert proc.stdout.readline() == \
                f"pushing metrics to {stand_in.url} every 1s\n"
            deadline = time.monotonic() + 30
            want = ("/metrics/job/s3/instance/" +
                    urllib.parse.quote(url))
            while want not in pushes:
                assert time.monotonic() < deadline, pushes
                time.sleep(0.05)
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        proc.stdout.close()
        if stand_in is not None:
            stand_in.stop()
        _stop_cluster(master, servers, filer)


def test_s3_command_serves(tmp_path):
    """`s3 -filer F` prints its address, answers a signed request, and
    stops on SIGTERM with 0."""
    import signal
    master, servers, filer = _start_cluster(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "s3", "-port", "0",
         "-filer", filer.url, "-accessKey", AK, "-secretKey", SK],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"s3 gateway listening on (\S+)", line)
        assert m, line
        url = m.group(1)
        h = auth.sign_request("PUT", url, "/clib", {}, {}, b"", AK, SK)
        assert http_bytes("PUT", f"{url}/clib", None, h)[0] == 200
        assert filer.filer.find_entry("/buckets/clib") is not None
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        _stop_cluster(master, servers, filer)
