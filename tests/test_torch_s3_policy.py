"""The port's S3 authorization and admission (`s3/policy.py`,
`s3/cors.py`, `s3/lifecycle.py`, `s3/circuit_breaker.py`,
`iam/identity.py`, `s3/sse.py`) on the CPU, against the JAX package's.
Tolerance: exact equality (decisions, statuses, bytes).

- the JAX suites `tests/test_s3_acl_conditions.py` and
  `tests/test_s3_circuit_breaker.py` on the port's gateway over a port
  cluster (`test_torch_s3.load_jax_suite`), the identity gateways in
  both attachments;
- shared tables: bucket-policy decisions with every condition operator,
  `action_for` and `coarse_action`, `Identity.can_do`, CORS rule
  matching, lifecycle parsing and expiry, circuit-breaker admission, and
  SSE-C / KMS envelopes that each package opens for the other.
"""

import json

import pytest

from seaweedfs_tpu.iam import identity as ref_identity
from seaweedfs_tpu.s3 import circuit_breaker as ref_cb
from seaweedfs_tpu.s3 import cors as ref_cors
from seaweedfs_tpu.s3 import lifecycle as ref_lifecycle
from seaweedfs_tpu.s3 import policy as ref_policy
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.iam import Credential, Identity, IdentityStore
from seaweedfs_tpu_torch.iam import identity
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.s3 import circuit_breaker, cors, lifecycle, policy
from test_torch_s3 import (CREDS, _start_cluster, _stop_cluster,
                           load_jax_suite)


def _identity_store():
    store = IdentityStore()
    store.put(Identity("root", [Credential("ADMINKEY", "adminsecret")],
                       actions=["Admin"]))
    store.put(Identity("limited", [Credential("LIMKEY", "limsecret")],
                       actions=["Read:own"]))
    return store


@pytest.fixture(params=["inprocess", "remote"])
def gw(tmp_path, request):
    master, servers, filer = _start_cluster(tmp_path)
    backend = filer.filer if request.param == "inprocess" \
        else FilerClient(filer.url)
    srv = S3ApiServer(backend, iam=_identity_store()).start()
    yield srv
    srv.stop()
    _stop_cluster(master, servers, filer)


@pytest.fixture
def gw_kms(tmp_path):
    from seaweedfs_tpu_torch.iam.kms import LocalKms
    master, servers, filer = _start_cluster(tmp_path)
    store = IdentityStore()
    store.put(Identity("root", [Credential("ADMINKEY", "adminsecret")],
                       actions=["Admin"]))
    srv = S3ApiServer(filer.filer, iam=store,
                      kms=LocalKms(str(tmp_path / "kms.json"))).start()
    yield srv
    srv.stop()
    _stop_cluster(master, servers, filer)


@pytest.fixture
def cluster(tmp_path):
    """The circuit-breaker suite's (gateway, filer, shell env); the
    port's gateway serves its per-bucket metrics on its own port, which
    stands in for the JAX gateway's side listener."""
    from seaweedfs_tpu.shell.commands import CommandEnv
    master, servers, filer = _start_cluster(tmp_path, n_volumes=1)
    srv = S3ApiServer(filer.filer, credentials=CREDS).start()
    srv.metrics_http = srv.http
    yield srv, filer, CommandEnv(master.url, filer=filer.http.url)
    srv.stop()
    _stop_cluster(master, servers, filer)


globals().update(load_jax_suite("test_s3_acl_conditions"))
globals().update(load_jax_suite("test_s3_circuit_breaker"))


# -- shared tables --------------------------------------------------------------

POLICIES = [
    {"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
     "Resource": "arn:aws:s3:::b/*"},
    {"Effect": "Deny", "Principal": {"AWS": ["AK1"]}, "Action": "s3:*",
     "Resource": ["arn:aws:s3:::b", "arn:aws:s3:::b/*"]},
    {"Effect": "Allow", "Principal": "*", "Action": ["s3:Get*",
                                                     "s3:List*"],
     "Resource": "arn:aws:s3:::b/pub/*",
     "Condition": {"IpAddress": {"aws:SourceIp": ["10.0.0.0/8"]}}},
    {"Effect": "Deny", "Principal": "*", "Action": "s3:PutObject",
     "Resource": "arn:aws:s3:::b/*",
     "Condition": {"Bool": {"aws:SecureTransport": "false"}}},
    {"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
     "Resource": "arn:aws:s3:::b/*",
     "Condition": {"StringLike": {"aws:Referer": "https://x.example/*"},
                   "DateLessThan": {"aws:CurrentTime":
                                    "2030-01-01T00:00:00Z"}}},
    {"Effect": "Allow", "Principal": "*", "Action": "s3:ListBucket",
     "Resource": "arn:aws:s3:::b",
     "Condition": {"NumericLessThanEquals": {"s3:max-keys": ["10", "20"]},
                   "StringEqualsIfExists": {"s3:prefix": "home/"}}},
    {"Effect": "Deny", "Principal": "*", "Action": "s3:DeleteObject",
     "Resource": "arn:aws:s3:::b/*",
     "Condition": {"Null": {"aws:username": "true"},
                   "StringNotEquals": {"aws:UserAgent": "ok"}}},
]
CONTEXTS = [
    {},
    {"aws:SourceIp": "10.1.2.3", "aws:SecureTransport": "true"},
    {"aws:SourceIp": "192.168.0.1", "aws:SecureTransport": "false",
     "aws:Referer": "https://x.example/p",
     "aws:CurrentTime": "2026-07-30T00:00:00Z"},
    {"s3:max-keys": "15", "s3:prefix": "home/", "aws:username": "u",
     "aws:UserAgent": "ok"},
    {"s3:max-keys": "50", "aws:UserAgent": "curl"},
]
ACTIONS = [("GET", "b", "k", {}), ("GET", "b", "pub/k", {}),
           ("PUT", "b", "k", {}), ("DELETE", "b", "k", {}),
           ("GET", "b", "", {"list-type": "2"}), ("GET", "b", "k",
                                                   {"acl": ""}),
           ("PUT", "b", "", {"policy": ""}), ("HEAD", "b", "k", {}),
           ("POST", "b", "", {"delete": ""}), ("GET", "", "", {})]


@pytest.mark.parametrize("stmt", POLICIES)
def test_policy_decisions_agree(stmt):
    doc = json.dumps({"Version": "2012-10-17",
                      "Statement": [stmt]}).encode()
    port_stmts = policy.parse_policy(doc)
    ref_stmts = ref_policy.parse_policy(doc)
    for method, bucket, key, query in ACTIONS:
        act = policy.action_for(method, bucket, key, query)
        assert act == ref_policy.action_for(method, bucket, key, query)
        arn = policy.resource_arn(bucket, key)
        assert arn == ref_policy.resource_arn(bucket, key)
        for principal in ("*", "AK1", "anonymous"):
            for ctx in CONTEXTS:
                assert policy.evaluate(port_stmts, principal, act, arn,
                                       dict(ctx)) == \
                    ref_policy.evaluate(ref_stmts, principal, act, arn,
                                        dict(ctx))


@pytest.mark.parametrize("doc", [b"{", b'{"Statement": 3}',
                                 b'{"Statement": [{"Effect": "Maybe"}]}',
                                 json.dumps({"Statement": [{
                                     "Effect": "Allow", "Principal": "*",
                                     "Action": "s3:GetObject",
                                     "Resource": "arn:aws:s3:::b/*",
                                     "Condition": {"Fancy": {"a": "b"}}}]}
                                 ).encode()])
def test_bad_policies_refused_alike(doc):
    def verdict(mod):
        try:
            mod.parse_policy(doc)
            return None
        except mod.PolicyError as e:
            return str(e)
    assert verdict(policy) == verdict(ref_policy) is not None


@pytest.mark.parametrize("method,bucket,key,query", ACTIONS)
def test_coarse_action_and_can_do_agree(method, bucket, key, query):
    act = policy.action_for(method, bucket, key, query)
    assert identity.coarse_action(act, method, query) == \
        ref_identity.coarse_action(act, method, query)
    grants = [["Admin"], ["Read"], ["Read:b"], ["Write:b/k"],
              ["List:b", "Read:b/pub"], ["Tagging"], []]
    for actions in grants:
        mine = Identity("u", actions=list(actions))
        theirs = ref_identity.Identity("u", actions=list(actions))
        for coarse in ("Read", "Write", "List", "Tagging", "Admin"):
            assert mine.can_do(coarse, bucket, key) == \
                theirs.can_do(coarse, bucket, key)


CORS_DOCS = [
    b"<CORSConfiguration><CORSRule><AllowedOrigin>*</AllowedOrigin>"
    b"<AllowedMethod>GET</AllowedMethod></CORSRule></CORSConfiguration>",
    b"<CORSConfiguration><CORSRule><AllowedOrigin>https://*.example"
    b"</AllowedOrigin><AllowedMethod>PUT</AllowedMethod><AllowedMethod>"
    b"GET</AllowedMethod><AllowedHeader>x-amz-*</AllowedHeader>"
    b"<ExposeHeader>ETag</ExposeHeader><MaxAgeSeconds>30</MaxAgeSeconds>"
    b"</CORSRule></CORSConfiguration>",
]


@pytest.mark.parametrize("doc", CORS_DOCS)
def test_cors_agrees(doc):
    mine = cors.parse_cors_config(doc)
    theirs = ref_cors.parse_cors_config(doc)
    for origin in ("https://a.example", "http://a.example", "null", ""):
        for method in ("GET", "PUT", "DELETE"):
            for hdrs in ("", "x-amz-date", "authorization, x-amz-date"):
                assert cors.evaluate(mine, origin, method, hdrs) == \
                    ref_cors.evaluate(theirs, origin, method, hdrs)


LIFECYCLES = [
    b"<LifecycleConfiguration><Rule><ID>a</ID><Filter><Prefix>tmp/"
    b"</Prefix></Filter><Status>Enabled</Status><Expiration><Days>3"
    b"</Days></Expiration></Rule></LifecycleConfiguration>",
    b"<LifecycleConfiguration><Rule><ID>b</ID><Prefix>logs/</Prefix>"
    b"<Status>Disabled</Status><Expiration><Date>2026-01-01T00:00:00Z"
    b"</Date></Expiration></Rule></LifecycleConfiguration>",
    b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
    b"</Rule></LifecycleConfiguration>",
    b"<nope",
]


@pytest.mark.parametrize("doc", LIFECYCLES)
def test_lifecycle_agrees(doc):
    def parsed(mod):
        try:
            rules = mod.parse_lifecycle(doc)
        except mod.LifecycleError as e:
            return str(e)
        now = 1_800_000_000.0
        return [(vars(r), r.expires_before(now)) for r in rules]
    assert parsed(lifecycle) == parsed(ref_lifecycle)


CB_CONFIGS = [
    {"global": {"enabled": True, "actions": {"Write:Count": 2,
                                             "Read:MB": 1}}},
    {"global": {"enabled": True, "actions": {"Write:MB": 1}},
     "buckets": {"b": {"enabled": True, "actions": {"Write:Count": 3}}}},
    {"global": {"enabled": False, "actions": {"Write:Count": 1}},
     "buckets": {"b": {"enabled": True, "actions": {"List:Count": 1}}}},
]


@pytest.mark.parametrize("cfg", CB_CONFIGS)
def test_circuit_breaker_admission_agrees(cfg):
    mine, theirs = circuit_breaker.CircuitBreaker(), ref_cb.CircuitBreaker()
    mine.load(cfg)
    theirs.load(cfg)
    held = []
    for bucket, action, n in [("b", "Write", 10), ("b", "Write", 10),
                              ("b", "Write", 10), ("c", "Write", 2 << 20),
                              ("b", "Read", 600 << 10),
                              ("b", "Read", 600 << 10), ("b", "List", 0),
                              ("b", "List", 0)]:
        rm, em = mine.admit(bucket, action, n)
        rt, et = theirs.admit(bucket, action, n)
        assert em == et
        assert mine.in_flight() == theirs.in_flight()
        if rm is not None:
            held.append((rm, rt))
    for rm, rt in held:
        rm()
        rt()
    assert mine.in_flight() == theirs.in_flight() == {}


def test_sse_envelopes_open_across_packages(tmp_path):
    """SSE-C bodies and KMS data-key envelopes made by one package open
    in the other (the stored form is the same)."""
    pytest.importorskip("cryptography")
    from seaweedfs_tpu.iam import kms as ref_kms
    from seaweedfs_tpu.s3 import sse as ref_sse
    from seaweedfs_tpu_torch.iam import kms
    from seaweedfs_tpu_torch.s3 import sse
    key = bytes(range(32))
    body = b"customer data " * 1000
    ct, iv = sse.encrypt(key, body)
    assert ref_sse.decrypt(key, iv, ct) == body
    ct2, iv2 = ref_sse.encrypt(key, body)
    assert sse.decrypt(key, iv2, ct2) == body
    store = str(tmp_path / "keys.json")
    k1 = kms.LocalKms(store)
    kid = k1.create_key("alias/s3")
    dk = k1.generate_data_key(kid, {"bucket": "b"})
    k2 = ref_kms.LocalKms(store)
    assert k2.decrypt(dk["CiphertextBlob"], {"bucket": "b"}) == \
        k1.decrypt(dk["CiphertextBlob"], {"bucket": "b"})
