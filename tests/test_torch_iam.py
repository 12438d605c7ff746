"""The port's identity plane (`seaweedfs_tpu_torch/iam/`: STS, OIDC, the
IAM API, the AWS and cloud KMS providers) on the CPU, against the JAX
package's.  Tolerance: exact equality (verdicts, statuses, derived
secrets, plaintexts, and the XML answers once request-specific values
are masked).

- the JAX suites `tests/test_iam.py` and `tests/test_iam_breadth.py`
  run on the port: their sources are loaded with the IAM, S3, filer,
  master and shell modules taken from the port (`jax_suite.load_suite`);
- a table of OIDC tokens (HS256, RS256, a wrong issuer, a wrong
  audience, an expired token, `alg: none`, a tampered signature) minted
  by either package and validated by both providers alike;
- STS session tokens that each package mints and the other resolves
  under one signing key, to the same secret and identity;
- one scripted IAM sequence (CreateUser, CreateAccessKey,
  PutUserPolicy, ListUsers, AssumeRole, AssumeRoleWithWebIdentity,
  DeleteUser) against a JAX and a port IAM server: equal statuses and
  equal XML once ids, keys, tokens and dates are masked;
- `AwsKms` and each cloud KMS provider of one package against the
  other package's fake server, a data key from one decrypting through
  the other;
- the port's gateway accepting a SigV4 request signed with temporary
  credentials the JAX STS minted, and refusing a tampered or an expired
  session token (403).
"""

import base64
import json
import re
import time
import urllib.parse
import xml.etree.ElementTree as ET

import pytest

from conftest import needs_crypto
from jax_suite import load_suite
from seaweedfs_tpu import security as ref_security
from seaweedfs_tpu.iam import kms_aws as ref_kms_aws
from seaweedfs_tpu.iam import kms_cloud as ref_kms_cloud
from seaweedfs_tpu.iam import oidc as ref_oidc
from seaweedfs_tpu.iam import sts as ref_sts
from seaweedfs_tpu.iam.iamapi import IamApiServer as RefIamApiServer
from seaweedfs_tpu.iam.identity import (Credential as RefCredential,
                                        Identity as RefIdentity,
                                        IdentityStore as RefIdentityStore)
from seaweedfs_tpu.iam.kms import KmsError as RefKmsError
from seaweedfs_tpu.iam.kms import LocalKms as RefLocalKms
from seaweedfs_tpu_torch import security
from seaweedfs_tpu_torch.iam import kms_aws, kms_cloud, oidc, sts
from seaweedfs_tpu_torch.iam.iamapi import IamApiServer
from seaweedfs_tpu_torch.iam.identity import (Credential, Identity,
                                              IdentityStore)
from seaweedfs_tpu_torch.iam.kms import KmsError, LocalKms
from seaweedfs_tpu_torch.s3 import S3ApiServer, auth
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

STS_KEY = "sts-signing-key-for-tests"
ISSUER = "https://idp.example"
PORTED = ("seaweedfs_tpu.iam", "seaweedfs_tpu.s3",
          "seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server", "seaweedfs_tpu.filer",
          "seaweedfs_tpu.shell")


def _port_volume_server(dirs, master, **kw):
    """The JAX suites' `VolumeServer(dirs, master, ...)` on a port volume
    server with the CPU codec."""
    return VolumeServer(dirs, device="cpu", master=master, **kw)


globals().update(load_suite("test_iam", PORTED, fixtures=("cluster",),
                            overrides={"VolumeServer":
                                       _port_volume_server}))
globals().update(load_suite("test_iam_breadth", PORTED,
                            fixtures=("env",)))


# -- OIDC --------------------------------------------------------------------

def _rsa_pair():
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pem = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo)
    return key, pem


def _alg_none(claims: dict) -> str:
    def seg(d):
        return base64.urlsafe_b64encode(
            json.dumps(d).encode()).rstrip(b"=").decode()
    return f"{seg({'alg': 'none', 'typ': 'JWT'})}.{seg(claims)}."


CASES = ["hs256", "rs256", "wrong_issuer", "wrong_audience", "expired",
         "no_exp", "alg_none", "tampered", "other_rsa_key"]


@needs_crypto
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("minter", ["port", "ref"])
def test_oidc_tokens_are_judged_alike(case, minter):
    key, pem = _rsa_pair()
    now = int(time.time())
    good = {"iss": ISSUER, "aud": "s3-app", "sub": "alice",
            "email": "a@example.com", "groups": ["eng"],
            "exp": now + 600}
    mint = (oidc if minter == "port" else ref_oidc).mint_test_token
    claims = {"wrong_issuer": {**good, "iss": "https://evil.example"},
              "wrong_audience": {**good, "aud": "other-app"},
              "expired": {**good, "exp": now - 10},
              "no_exp": {k: v for k, v in good.items() if k != "exp"}
              }.get(case, good)
    if case == "alg_none":
        token = _alg_none(claims)
    elif case in ("hs256", "no_exp"):
        token = mint(claims, hs256_secret="hs-secret")
    elif case == "other_rsa_key":
        token = mint(claims, rsa_private_key=_rsa_pair()[0])
    else:
        token = mint(claims, rsa_private_key=key)
    if case == "tampered":
        token = token[:-6] + "AAAAAA"
    verdicts = []
    for mod in (oidc, ref_oidc):
        prov = mod.OidcProvider("corp", ISSUER, "s3-app",
                                rsa_public_keys_pem=[pem],
                                hs256_secret="hs-secret")
        try:
            ext = prov.validate(token)
            verdicts.append(("ok", ext.principal, ext.email, ext.groups))
        except mod.OidcError as e:
            verdicts.append(("refused", str(e)))
    assert verdicts[0] == verdicts[1]
    assert (verdicts[0][0] == "ok") == (case in ("hs256", "rs256"))


def test_minted_tokens_are_byte_identical():
    claims = {"iss": ISSUER, "sub": "bob", "exp": 2_000_000_000}
    assert oidc.mint_test_token(claims, hs256_secret="k") == \
        ref_oidc.mint_test_token(claims, hs256_secret="k")


# -- STS ---------------------------------------------------------------------

@pytest.mark.parametrize("minter", ["port", "ref"])
def test_sts_sessions_cross_packages(minter):
    roles = {"port": sts.RoleStore(), "ref": ref_sts.RoleStore()}
    for r in roles.values():
        r.put("writer", ["Write:b", "Read:b"], trust=["root"])
    svc = {"port": sts.StsService(STS_KEY, roles["port"]),
           "ref": ref_sts.StsService(STS_KEY, roles["ref"])}
    caller = (Identity if minter == "port" else RefIdentity)("root")
    creds = svc[minter].assume_role(caller, "writer", "s1", 1800)
    assert creds["AccessKeyId"].startswith("STS")
    got = {}
    for name, s in svc.items():
        secret, ident = s.resolve(creds["AccessKeyId"],
                                  creds["SessionToken"])
        got[name] = (secret, ident.name, ident.actions,
                     ident.principal_arn)
    assert got["port"] == got["ref"]
    assert got["port"][0] == creds["SecretAccessKey"]
    assert got["port"][1:] == ("root@writer", ["Write:b", "Read:b"],
                               "arn:aws:sts:::assumed-role/writer/s1")
    # another key, another access key, a tampered token: refused alike
    bad_token = creds["SessionToken"][:-4] + "AAAA"
    for s in svc.values():
        assert s.resolve(creds["AccessKeyId"], bad_token) is None
        assert s.resolve("STS0000", creds["SessionToken"]) is None
    for mod in (sts, ref_sts):
        other = mod.StsService("another-key")
        assert other.resolve(creds["AccessKeyId"],
                             creds["SessionToken"]) is None
    # trust: an untrusted caller is refused by both
    for name, s in svc.items():
        with pytest.raises((sts.StsError, ref_sts.StsError)):
            s.assume_role((Identity if name == "port" else RefIdentity)(
                "stranger"), "writer")


def test_role_store_files_are_shared(tmp_path):
    path = str(tmp_path / "roles.json")
    sts.RoleStore(path).put("r1", ["Read"], trust=["oidc:corp#*"])
    ref_sts.RoleStore(path).put("r2", ["Admin"])
    port, ref = sts.RoleStore(path), ref_sts.RoleStore(path)
    assert dict(port) == dict(ref) == {
        "r1": {"actions": ["Read"], "trust": ["oidc:corp#*"]},
        "r2": {"actions": ["Admin"], "trust": ["*"]}}


# -- the IAM API -------------------------------------------------------------

MASK = re.compile(r"<(RequestId|AccessKeyId|SecretAccessKey|SessionToken|"
                  r"Expiration)>[^<]*</")


def _iam_call(url: str, form: dict, access="ADMINKEY", secret="adminsec",
              sign=True) -> "tuple[int, str]":
    body = urllib.parse.urlencode(form).encode()
    headers = {"content-type": "application/x-www-form-urlencoded"}
    if sign:
        headers = auth.sign_request("POST", url, "/", {}, headers, body,
                                    access, secret)
    st, out, _ = http_bytes("POST", f"{url}/", body, headers)
    return st, out.decode()


@needs_crypto
def test_iam_servers_answer_alike(tmp_path):
    key, pem = _rsa_pair()
    token = oidc.mint_test_token(
        {"iss": ISSUER, "sub": "dev-1", "exp": int(time.time()) + 600},
        rsa_private_key=key)
    servers = {}
    for name, (Store, Ident, Cred, smod, omod, Server) in {
            "port": (IdentityStore, Identity, Credential, sts, oidc,
                     IamApiServer),
            "ref": (RefIdentityStore, RefIdentity, RefCredential,
                    ref_sts, ref_oidc, RefIamApiServer)}.items():
        store = Store(str(tmp_path / f"{name}.json"))
        store.put(Ident("root", [Cred("ADMINKEY", "adminsec")],
                        actions=["Admin"]))
        roles = smod.RoleStore(str(tmp_path / f"{name}-roles.json"))
        roles.put("writer", ["Write:shared"], trust=["root"])
        roles.put("web", ["Read:shared"], trust=["oidc:corp#*"])
        svc = smod.StsService(STS_KEY, roles)
        svc.add_provider(omod.OidcProvider("corp", ISSUER,
                                           rsa_public_keys_pem=[pem]))
        servers[name] = Server(store, svc).start()
    policy = json.dumps({"Statement": [{
        "Effect": "Allow", "Action": ["s3:GetObject", "s3:PutObject"],
        "Resource": "arn:aws:s3:::shared/*"}]})
    script = [
        ({"Action": "CreateUser", "UserName": "alice"}, True),
        ({"Action": "CreateUser", "UserName": "alice"}, True),
        ({"Action": "CreateAccessKey", "UserName": "alice"}, True),
        ({"Action": "PutUserPolicy", "UserName": "alice",
          "PolicyName": "p1", "PolicyDocument": policy}, True),
        ({"Action": "GetUserPolicy", "UserName": "alice",
          "PolicyName": "p1"}, True),
        ({"Action": "ListUsers"}, True),
        ({"Action": "ListAccessKeys", "UserName": "alice"}, True),
        ({"Action": "AssumeRole", "RoleArn": "arn:aws:iam:::role/writer",
          "RoleSessionName": "s1"}, True),
        ({"Action": "AssumeRole", "RoleName": "web"}, True),
        ({"Action": "AssumeRoleWithWebIdentity", "RoleName": "web",
          "WebIdentityToken": token}, False),
        ({"Action": "AssumeRoleWithWebIdentity", "RoleName": "writer",
          "WebIdentityToken": token}, False),
        ({"Action": "AssumeRoleWithWebIdentity", "RoleName": "web",
          "WebIdentityToken": "not.a.jwt"}, False),
        ({"Action": "NoSuchAction"}, True),
        ({"Action": "ListUsers"}, False),
        ({"Action": "DeleteUser", "UserName": "alice"}, True),
        ({"Action": "DeleteUser", "UserName": "alice"}, True),
        ({"Action": "ListUsers"}, True),
    ]
    try:
        for form, sign in script:
            got = {}
            for name, srv in servers.items():
                st, xml = _iam_call(srv.url, form, sign=sign)
                got[name] = (st, MASK.sub(r"<\1>*</", xml))
            assert got["port"] == got["ref"], form
        # the web identity's credentials carry the role's actions
        st, xml = _iam_call(servers["port"].url, {
            "Action": "AssumeRoleWithWebIdentity", "RoleName": "web",
            "WebIdentityToken": token}, sign=False)
        vals = {e.tag.rsplit("}", 1)[-1]: e.text
                for e in ET.fromstring(xml).iter()}
        resolved = ref_sts.StsService(STS_KEY).resolve(
            vals["AccessKeyId"], vals["SessionToken"])
        assert resolved[0] == vals["SecretAccessKey"]
        assert resolved[1].name == "oidc:corp#dev-1@web"
        assert resolved[1].actions == ["Read:shared"]
    finally:
        for srv in servers.values():
            srv.stop()


# -- KMS providers against the other package's fakes -------------------------

@needs_crypto
@pytest.mark.parametrize("client", ["port", "ref"])
def test_aws_kms_against_the_other_stub(client, tmp_path):
    server_mod, client_mod = (ref_kms_aws, kms_aws) if client == "port" \
        else (kms_aws, ref_kms_aws)
    Backend = RefLocalKms if client == "port" else LocalKms
    backend = Backend(str(tmp_path / "kms.json"))
    kid = backend.create_key(alias="primary")
    stub = server_mod.KmsStubServer(backend).start()
    try:
        remote = client_mod.AwsKms(stub.url, "AK", "SK")
        assert remote.get_key_id("primary") == kid
        assert remote.describe_key("alias/primary")["KeyId"] == kid
        dk = remote.generate_data_key("primary", {"aws:s3:arn": "arn:z"})
        assert len(dk["Plaintext"]) == 32
        out = remote.decrypt(dk["CiphertextBlob"], {"aws:s3:arn": "arn:z"})
        assert out == {"KeyId": kid, "Plaintext": dk["Plaintext"]}
        # the blob is the backend's: it decrypts there directly
        assert backend.decrypt(dk["CiphertextBlob"], {
            "aws:s3:arn": "arn:z"})["Plaintext"] == dk["Plaintext"]
        with pytest.raises((KmsError, RefKmsError)):
            remote.decrypt(dk["CiphertextBlob"], {"aws:s3:arn": "other"})
        bad = client_mod.AwsKms(stub.url, "AK", "wrong-secret")
        with pytest.raises((KmsError, RefKmsError)) as e:
            bad.generate_data_key("primary")
        assert "IncompleteSignatureException" in str(e.value)
    finally:
        stub.stop()


@needs_crypto
@pytest.mark.parametrize("client", ["port", "ref"])
@pytest.mark.parametrize("provider,fake,key_name", [
    ("GcpKms", "FakeGcpKmsServer",
     "projects/p/locations/l/keyRings/r/cryptoKeys/k"),
    ("AzureKms", "FakeAzureKeyVaultServer", "mykey"),
    ("OpenBaoKms", "FakeOpenBaoServer", "transit-key")])
def test_cloud_kms_against_the_other_fake(client, provider, fake,
                                          key_name):
    server_mod, client_mod = (ref_kms_cloud, kms_cloud) \
        if client == "port" else (kms_cloud, ref_kms_cloud)
    server = getattr(server_mod, fake)().start()
    try:
        ctor = getattr(client_mod, provider)
        mine = ctor(server.url, key_name, token=server.token)
        theirs = getattr(server_mod, provider)(server.url, key_name,
                                               token=server.token)
        dk = mine.generate_data_key("", context={"arn": "a/b"})
        assert len(dk["Plaintext"]) == 32
        # the envelope each package writes, the other opens
        for reader in (mine, theirs):
            out = reader.decrypt(dk["CiphertextBlob"],
                                 context={"arn": "a/b"})
            assert out["Plaintext"] == dk["Plaintext"]
        back = theirs.generate_data_key("", context={"arn": "c"})
        assert mine.decrypt(back["CiphertextBlob"], context={
            "arn": "c"})["Plaintext"] == back["Plaintext"]
        kms_error = (KmsError, RefKmsError)
        with pytest.raises(kms_error):
            mine.decrypt("bm90LWpzb24=")
        with pytest.raises(kms_error):
            ctor(server.url, key_name, token="wrong").generate_data_key("")
    finally:
        server.stop()


# -- temporary credentials at the port's gateway -----------------------------

@pytest.fixture
def sts_gateway(tmp_path):
    master = MasterServer(pulse_seconds=0.3).start()
    vs = VolumeServer([str(tmp_path / "v0")], device="cpu",
                      master=master.url, pulse_seconds=0.3).start()
    deadline = time.monotonic() + 15
    while not http_json("GET", f"{master.url}/cluster/status")["dataNodes"]:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    filer = FilerServer(master.url).start()
    store = IdentityStore(str(tmp_path / "ids.json"))
    store.put(Identity("root", [Credential("ADMINKEY", "adminsec")],
                       actions=["Admin"]))
    gw = S3ApiServer(filer.filer, iam=store,
                     sts=sts.StsService(STS_KEY)).start()
    yield gw
    gw.stop()
    filer.stop()
    vs.stop()
    master.stop()


def _signed(gw, method, path, body=b"", access="ADMINKEY",
            secret="adminsec", token=None):
    headers = {"x-amz-security-token": token} if token else {}
    h = auth.sign_request(method, gw.url, path, {}, headers, body, access,
                          secret)
    return http_bytes(method, f"{gw.url}{path}", body or None, h)


def test_gateway_takes_temporary_credentials(sts_gateway):
    gw = sts_gateway
    assert _signed(gw, "PUT", "/tmpb")[0] == 200
    roles = ref_sts.RoleStore()
    roles.put("rw", ["Read:tmpb", "Write:tmpb", "List:tmpb"],
              trust=["root"])
    creds = ref_sts.StsService(STS_KEY, roles).assume_role(
        RefIdentity("root"), "rw", "chip")
    ak, sk, tok = (creds["AccessKeyId"], creds["SecretAccessKey"],
                   creds["SessionToken"])
    assert _signed(gw, "PUT", "/tmpb/o", b"temp", ak, sk, tok)[0] == 200
    assert _signed(gw, "GET", "/tmpb/o", b"", ak, sk, tok)[:2] == \
        (200, b"temp")
    # the role grants no access to another bucket
    assert _signed(gw, "PUT", "/other", b"", ak, sk, tok)[0] == 403
    # no token, a tampered token, an expired token: 403
    assert _signed(gw, "GET", "/tmpb/o", b"", ak, sk)[0] == 403
    assert _signed(gw, "GET", "/tmpb/o", b"", ak, sk,
                   tok[:-4] + "AAAA")[0] == 403
    claims = security.decode_jwt(STS_KEY, tok)
    claims["exp"] = int(time.time()) - 60
    expired = ref_security.gen_jwt(STS_KEY, claims)
    assert _signed(gw, "GET", "/tmpb/o", b"", ak, sk, expired)[0] == 403
