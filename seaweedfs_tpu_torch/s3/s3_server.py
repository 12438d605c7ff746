"""S3 REST gateway over the filer (weed/s3api/s3api_server.go and
handler files; buckets live under /buckets/<name> as in the reference's
filer layout).

Implemented surface (the core the reference's s3tests exercise first):
  ListBuckets, Create/Delete/Head bucket, Put/Get/Head/Delete object,
  batch DeleteObjects, ListObjectsV2 (prefix/delimiter/continuation),
  multipart (initiate/uploadPart/complete/abort/listParts), SigV4 auth
  (header + presigned query), streaming-chunked uploads
  (chunked_reader_v4.go), object versioning with delete markers
  (s3api_object_versioning.go — versions archived under
  `<key>.versions/`, newest-first by inverted-timestamp id), and
  bucket CORS incl. preflight (s3api/cors/).

The port's copy of `seaweedfs_tpu/s3/s3_server.py`, with STS session
credentials (`sts=`) and the separate metrics listener
(`metrics_port=`); the per-bucket families are on the gateway's own
`GET /metrics` too, and the S3 Tables plane (`s3tables.py`: the
`X-Amz-Target: S3Tables.<Op>` target, and the write guard that holds
object writes into a table bucket to the Iceberg layout of an existing
table).  Not here: the IAM gRPC cache (no gRPC).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from ..filer import Entry, Filer
from ..filer.filechunks import total_size
from ..server.httpd import HttpServer, Request
from .auth import SigV4Verifier
from .chunked import ChunkedDecodeError, decode_streaming_body
from .cors import evaluate as cors_evaluate, parse_cors_config
from ..util import wlog

BUCKETS_ROOT = "/buckets"
UPLOADS_DIR = "/.uploads"
VERSIONS_EXT = ".versions"
S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


def new_version_id() -> str:
    """Inverted-timestamp version id: lexicographically ascending =
    newest first, so a plain sorted listing of `<key>.versions/` yields
    newest-first order (the reference's 'inverted format',
    s3api_object_versioning.go generateVersionId)."""
    # not a duration: a DESCENDING sort key derived from the wall
    # clock (newest version lists first, s3 semantics)
    return (f"{(1 << 63) - time.time_ns():016x}"  # noqa: SWFS011
            f"{os.urandom(3).hex()}")


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + \
        ET.tostring(root)


def _elem(parent, tag, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


def _error(status: int, code: str, message: str):
    root = ET.Element("Error")
    _elem(root, "Code", code)
    _elem(root, "Message", message)
    return status, (_xml(root), "application/xml")


def _with_headers(resp, extra: dict):
    """Merge extra response headers into any handler return shape."""
    status, payload = resp
    if isinstance(payload, tuple):
        body, second = payload
        if isinstance(second, dict):
            merged = dict(second)
            merged.update(extra)
            return status, (body, merged)
        h = dict(extra)
        h["Content-Type"] = second
        return status, (body, h)
    if isinstance(payload, (bytes, str)):
        body = payload if isinstance(payload, bytes) \
            else str(payload).encode()
        return status, (body, dict(extra))
    return resp  # JSON dict/list: headers not applicable


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


class S3ApiServer:
    def __init__(self, filer: Filer, host: str = "127.0.0.1",
                 port: int = 0,
                 credentials: dict[str, str] | None = None,
                 iam=None, sts=None, kms=None,
                 metrics_port: int | None = None):
        """`credentials` is the legacy flat access->secret dict (every
        key acts as admin).  `iam` is an iam.IdentityStore: identities
        then carry coarse actions enforced per request
        (auth_credentials.go CanDo), `sts` an iam.StsService whose
        temporary credentials the verifier honors, `kms` a KMS provider
        (iam.kms.LocalKms, iam.kms_aws.AwsKms, a iam.kms_cloud provider)
        enabling SSE-KMS, and `metrics_port` a separate listener for
        the per-bucket metrics (`-metricsPort`)."""
        self.filer = filer
        self.iam = iam
        self.kms = kms
        creds = iam.secrets_view() if iam is not None else credentials
        self.verifier = SigV4Verifier(creds, sts=sts) \
            if creds is not None else None
        self.http = HttpServer(host, port)
        self.http.fallback = self._dispatch
        self.http.role = "s3"
        # striped per-key locks: versioned mutations are
        # archive-then-write sequences; two concurrent PUTs to one key
        # must not interleave or the loser's acknowledged version is
        # silently lost (bounded stripe count — no per-key leak)
        self._stripes = [threading.Lock() for _ in range(64)]
        self._cors_cache: dict[str, tuple[str, list]] = {}
        self._policy_cache: dict[str, tuple[str, list]] = {}
        self._tbkt_cache: dict[str, tuple[float, bool]] = {}
        # admission control + per-bucket observability
        # (s3api_circuit_breaker.go; stats/metrics.go S3 families)
        from ..stats import Metrics
        from .circuit_breaker import CircuitBreaker
        self.circuit_breaker = CircuitBreaker()
        self._cb_stamp = (0.0, -1.0)     # (checked-at, entry-mtime)
        self.metrics = Metrics("s3")
        # the per-bucket families on the gateway's own port (an exact
        # route, so a bucket named "metrics" lists only with a prefix)
        # and, given `metrics_port`, with the process's on a separate
        # listener, as the reference's `weed s3 -metricsPort` serves them
        self.http.route(
            "GET", "/metrics",
            lambda req: (200, (self.metrics.render().encode(),
                               {"Content-Type":
                                "text/plain; version=0.0.4"})))
        self.metrics_http = None
        if metrics_port is not None:
            from ..stats import render_process
            self.metrics_http = HttpServer(host, metrics_port)
            self.metrics_http.route(
                "GET", "/metrics",
                lambda req: (200, ((self.metrics.render() +
                                    render_process()).encode(),
                                   "text/plain; version=0.0.4")))
        # QoS: tenant admission at the tenant-facing edge (the tenant is
        # the SigV4 access key), and this gateway's request_seconds is a
        # foreground source of the process's EC throttle
        from .. import qos
        qos.install(self.http, "s3")
        qos.throttle().add_metrics(f"s3:{self.http.port}", self.metrics)
        qos.throttle().maybe_start()

    def _path_lock(self, path: str) -> "threading.Lock":
        return self._stripes[hash(path) % len(self._stripes)]

    def start(self):
        self.http.start()
        if self.metrics_http is not None:
            self.metrics_http.start()
        return self

    def stop(self):
        from .. import qos
        qos.throttle().remove_source(f"s3:{self.http.port}")
        if self.metrics_http is not None:
            self.metrics_http.stop()
        self.http.stop()

    @property
    def url(self) -> str:
        return self.http.url

    # -- dispatch ---------------------------------------------------------

    def _observe(self, req: Request, bucket: str, action: str,
                 resp) -> None:
        """Per-bucket request/byte counters (stats/metrics.go
        S3RequestCounter / S3 bytes families), served by the side
        metrics server (`weed s3 -metricsPort` analog)."""
        status = resp[0] if isinstance(resp, tuple) else 200
        # label-cardinality guard: only successful requests and
        # authenticated callers mint per-bucket label values — an
        # unauthenticated loop over random names must not grow the
        # registry without bound
        authed = bool(getattr(req, "s3_identity", None))
        blabel = bucket if bucket and \
            (authed or (isinstance(status, int) and status < 400)) \
            else "-"
        self.metrics.counter_add(
            "request_total", 1.0, "s3 requests",
            bucket=blabel, action=action, code=str(status))
        n_in = len(req.body or b"")
        if n_in:
            self.metrics.counter_add(
                "received_bytes_total", float(n_in),
                "request payload bytes", bucket=blabel)
        payload = resp[1] if isinstance(resp, tuple) and \
            len(resp) > 1 else b""
        if isinstance(payload, tuple):
            payload = payload[0]
        if isinstance(payload, (bytes, str)) and payload:
            self.metrics.counter_add(
                "sent_bytes_total", float(len(payload)),
                "response payload bytes", bucket=blabel)

    def _refresh_circuit_breaker(self) -> None:
        """Lazy 2s-TTL reload of /etc/s3/circuit_breaker.json from
        the filer (the reference subscribes to filer metadata; a TTL
        poll gives the same operator experience without a stream)."""
        import time as _t
        from .circuit_breaker import CONFIG_PATH
        now = _t.monotonic()
        checked, mtime = self._cb_stamp
        if now - checked < 2.0:
            return
        e = self.filer.find_entry(CONFIG_PATH)
        new_mtime = e.attributes.mtime if e is not None else 0
        if new_mtime != mtime:
            try:
                content = self.filer.read_file(CONFIG_PATH) \
                    if e is not None else b""
                self.circuit_breaker.load_bytes(content)
            except Exception as e:  # noqa: BLE001 — any malformed
                # config or unreachable chunk (read_file raises
                # RuntimeError/LookupError when the hosting volume is
                # down; load() raises on wrong-shape JSON) must keep
                # the last good config, never crash the request path
                wlog.warning(f"s3: circuit-breaker config unreadable; "
                             f"keeping previous: {e}", component="s3")
        self._cb_stamp = (now, new_mtime)

    def _dispatch(self, req: Request):
        parts = req.path.lstrip("/").split("/", 1)
        bucket = urllib.parse.unquote(parts[0]) if parts[0] else ""
        key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
        origin = req.headers.get("Origin", "")
        if req.method == "OPTIONS":
            # CORS preflight: unauthenticated by design (browsers send
            # no credentials on preflights)
            return self._preflight(req, bucket)
        from ..iam import coarse_action
        from .policy import action_for
        cb_action = coarse_action(
            action_for(req.method, bucket, key, req.query),
            req.method, req.query)
        self._refresh_circuit_breaker()
        rollback, err = self.circuit_breaker.admit(
            bucket, cb_action, len(req.body or b""))
        if err is not None:
            # falls through to the CORS tail below: a throttled
            # browser request must still read the 503 (else it sees
            # an opaque CORS failure instead of a retryable error)
            resp = _error(503, err,
                          "simultaneous request limit reached")
        else:
            try:
                resp = self._handle(req, bucket, key)
            finally:
                rollback()
        self._observe(req, bucket, cb_action, resp)
        if origin and bucket:
            cors = cors_evaluate(self._cors_rules(bucket), origin,
                                 req.method)
            if cors:
                resp = _with_headers(resp, cors)
        return resp

    def _handle(self, req: Request, bucket: str, key: str):
        from .policy import action_for, evaluate, resource_arn
        identity = "*"
        ctx = None
        stmts = self._policy_rules(bucket) if bucket else []
        decision = None
        action = action_for(req.method, bucket, key, req.query)
        arn = resource_arn(bucket, key)
        pctx = self._policy_context(req)
        ident_obj = None          # iam.Identity once resolved
        if self.verifier is not None:
            ok, who, ctx = self.verifier.verify(
                req.method, req.path, req.query,
                {k.lower(): v for k, v in req.headers.items()},
                req.body)
            if ok:
                identity = who
                if ctx is not None and ctx.sts_identity is not None:
                    ident_obj = ctx.sts_identity
                elif self.iam is not None:
                    ident_obj = self.iam.by_access_key(who)
                if ident_obj is not None:
                    identity = ident_obj.name
                req.s3_identity = identity
            else:
                # unsigned/invalid: an "anonymous" identity
                # (auth_credentials.go) or the bucket policy may still
                # open this resource (public-read buckets)
                anon = self.iam.anonymous() if self.iam else None
                decision = evaluate(stmts, "anonymous", action,
                                    arn, pctx) if stmts else None
                if decision == "Deny":
                    # explicit policy Deny binds the anonymous
                    # identity too — it can widen access, never
                    # override a Deny
                    return _error(403, "AccessDenied",
                                  "denied by bucket policy")
                acl_open = decision != "Allow" and anon is None and \
                    self._acl_allows(bucket, key, action, False)
                if decision != "Allow" and anon is None and \
                        not acl_open:
                    return _error(403, "AccessDenied", who)
                identity = "anonymous"
                ident_obj = anon
                if acl_open:
                    decision = "Allow"   # canned-ACL grant
        if self.iam is not None and self.verifier is not None and \
                decision != "Allow":
            # first authorization layer: coarse identity actions
            # (auth_credentials.go CanDo) — bucket policy can still
            # explicitly deny below, but cannot widen a missing grant
            # except for the anonymous-Allow path above
            from ..iam import coarse_action
            if not bucket:
                # ListAllMyBuckets: any authenticated identity may
                # call it; _list_buckets filters to visible buckets
                if ident_obj is None:
                    return _error(403, "AccessDenied", identity)
            elif ident_obj is None or not ident_obj.can_do(
                    coarse_action(action, req.method, req.query),
                    bucket, key):
                # canned ACLs (authenticated-read / public-*) can
                # still open reads to identities with no grant —
                # "authenticated" means a real signed principal, NOT
                # the anonymous fallback identity
                if not self._acl_allows(bucket, key, action,
                                        identity != "anonymous"):
                    return _error(403, "AccessDenied",
                                  f"{identity} may not "
                                  f"{coarse_action(action)} {bucket}")
            req.s3_identity_obj = ident_obj
        if stmts and decision is None:
            pctx["aws:username"] = identity
            if evaluate(stmts, identity, action, arn,
                        pctx) == "Deny":
                # explicit Deny beats a valid signature
                return _error(403, "AccessDenied",
                              "denied by bucket policy")
        sha = req.headers.get("x-amz-content-sha256", "")
        if sha.startswith("STREAMING-"):
            # aws-chunked framing (chunked_reader_v4.go): verify chunk
            # signatures when we hold credentials, then unwrap.  A
            # presigned-URL context carries no signing key — strip the
            # framing unverified, as before
            try:
                req._body = decode_streaming_body(
                    req.body,
                    ctx if ctx is not None and ctx.signing_key
                    else None)
            except ChunkedDecodeError as e:
                return _error(403, "SignatureDoesNotMatch", str(e))
        if not bucket:
            target = req.headers.get("X-Amz-Target", "")
            if req.method == "POST" and \
                    target.startswith("S3Tables."):
                return self._s3tables_op(req, target.split(".", 1)[1])
            if req.method == "GET":
                return self._list_buckets(
                    getattr(req, "s3_identity_obj", None))
            return _error(405, "MethodNotAllowed", req.method)
        if "tagging" in req.query:
            # object and bucket tagging are not implemented: answered as
            # such, never taken for a plain object PUT, GET or DELETE
            # that would overwrite or delete the object (ROADMAP C8)
            return _error(501, "NotImplemented",
                          "tagging is not implemented on this gateway")
        if not key:
            return self._bucket_op(req, bucket)
        if key and req.method in ("PUT", "DELETE", "POST"):
            err = self._table_bucket_write_guard(req, bucket, key)
            if err is not None:
                return err
        return self._object_op(req, bucket, key)

    def _s3tables_op(self, req: Request, operation: str):
        """The S3 Tables plane (`s3tables.py`; the reference's
        weed/s3api/s3tables/handler.go): POST / with `X-Amz-Target:
        S3Tables.<Op>` and a JSON body.  A mutating operation needs the
        coarse Admin action on its table bucket, a Get or List needs Read
        (or Admin); with flat credentials every valid signature is
        admin."""
        from .s3tables import (S3TablesError, S3TablesStore,
                               handle_request, parse_bucket_arn,
                               parse_table_arn)

        def answer(status: int, doc: dict):
            return status, (json.dumps(doc).encode(),
                            "application/x-amz-json-1.1")
        try:
            body = json.loads(req.body or b"{}")
        except ValueError as e:
            return answer(400, {"__type": "InvalidRequest",
                                "message": f"bad JSON body: {e}"})
        ident = getattr(req, "s3_identity_obj", None)
        if self.verifier is not None:
            # the target bucket, for grants scoped to one
            tbkt = ""
            try:
                if body.get("tableBucketARN"):
                    tbkt = parse_bucket_arn(body["tableBucketARN"])
                elif body.get("tableARN"):
                    tbkt = parse_table_arn(body["tableARN"])[0]
                elif body.get("resourceArn"):
                    tbkt = parse_bucket_arn(
                        body["resourceArn"].split("/table/")[0])
                elif body.get("name") and operation == "CreateTableBucket":
                    tbkt = body["name"]
            except S3TablesError:
                tbkt = ""
            needed = "Read" if operation.startswith(("Get", "List")) \
                else "Admin"
            legacy_admin = self.iam is None and \
                bool(getattr(req, "s3_identity", None))
            if not legacy_admin and (ident is None or not (
                    ident.can_do(needed, tbkt) or ident.is_admin)):
                return answer(403, {"__type": "AccessDeniedException",
                                    "message": f"not authorized to "
                                               f"{operation}"})
        try:
            resp = handle_request(S3TablesStore(self.filer), operation, body)
        except S3TablesError as e:
            return answer(e.status, {"__type": e.code, "message": e.message})
        if operation in ("CreateTableBucket", "DeleteTableBucket"):
            # a cached "not a table bucket" would let any object into a
            # bucket just made a table bucket for the cache's 2 s
            if body.get("name"):
                self._tbkt_cache.pop(body["name"], None)
            if body.get("tableBucketARN"):
                try:
                    self._tbkt_cache.pop(
                        parse_bucket_arn(body["tableBucketARN"]), None)
                except S3TablesError:
                    pass
        return answer(200, resp)

    def _is_table_bucket(self, bucket: str) -> bool:
        """Whether `bucket` is a table bucket, cached 2 s: the write guard
        runs on every object write, and a plain bucket must not pay a
        filer round trip a request (a bucket's kind changes only on its
        create or delete, which drop the entry)."""
        from .s3tables import is_table_bucket
        now = time.monotonic()
        hit = self._tbkt_cache.get(bucket)
        if hit is not None and now - hit[0] < 2.0:
            return hit[1]
        val = is_table_bucket(self.filer.find_entry(self._bucket_path(bucket)))
        self._tbkt_cache[bucket] = (now, val)
        if len(self._tbkt_cache) > 4096:    # unauthenticated-probe cap
            self._tbkt_cache.clear()
        return val

    def _table_bucket_write_guard(self, req: Request, bucket: str,
                                  key: str):
        """An object write into a table bucket must be a file of the
        Iceberg layout (s3tables/iceberg_layout.go) under an existing
        table: anything else would break the catalog's invariants (403).
        Deletes pass.  Returns the error answer, or None."""
        from .s3tables import X_METADATA, validate_iceberg_key
        if not self._is_table_bucket(bucket):
            return None
        reason = validate_iceberg_key(key)
        if reason is None:
            ns, table = key.split("/")[:2]
            t = self.filer.find_entry(
                f"{self._bucket_path(bucket)}/{ns}/{table}")
            if t is None or X_METADATA not in t.extended:
                reason = f"no table {ns}/{table} in bucket {bucket}"
        if reason is not None and req.method != "DELETE":
            return _error(403, "AccessDenied",
                          f"table bucket {bucket}: {reason}")
        return None

    # -- CORS (s3api/cors/) -----------------------------------------------

    def _cors_rules(self, bucket: str):
        e = self.filer.find_entry(self._bucket_path(bucket))
        xml_text = (e.extended.get("cors") if e else None) or ""
        if not xml_text:
            return []
        if isinstance(xml_text, bytes):
            xml_text = xml_text.decode()
        cached = self._cors_cache.get(bucket)
        if cached is not None and cached[0] == xml_text:
            return cached[1]  # skip the per-request XML re-parse
        try:
            rules = parse_cors_config(xml_text.encode())
        except ValueError:
            rules = []
        self._cors_cache[bucket] = (xml_text, rules)
        return rules

    def _preflight(self, req: Request, bucket: str):
        origin = req.headers.get("Origin", "")
        want_method = req.headers.get("Access-Control-Request-Method",
                                      "")
        want_headers = req.headers.get("Access-Control-Request-Headers",
                                       "")
        if not origin or not want_method or not bucket:
            return _error(400, "BadRequest", "not a CORS preflight")
        headers = cors_evaluate(self._cors_rules(bucket), origin,
                                want_method, want_headers)
        if headers is None:
            return _error(403, "AccessForbidden",
                          "CORSResponse: no matching rule")
        return 200, (b"", headers)

    # -- ACLs (s3api_acp.go / s3acl; canned grants) -----------------------

    CANNED_ACLS = ("private", "public-read", "public-read-write",
                   "authenticated-read")
    _READ_ACTIONS = {"s3:GetObject", "s3:GetObjectVersion",
                     "s3:HeadObject", "s3:ListBucket",
                     "s3:ListBucketVersions"}
    _WRITE_ACTIONS = {"s3:PutObject", "s3:DeleteObject",
                      "s3:DeleteObjectVersion"}

    def _stored_acl(self, bucket: str, key: str = "") -> str:
        """Effective canned ACL: the object's own, else the bucket's
        (the reference consults both, object first)."""
        if key:
            e = self.filer.find_entry(
                f"{self._bucket_path(bucket)}/{key}")
            if e is not None and e.extended.get("acl"):
                return e.extended["acl"]
        e = self.filer.find_entry(self._bucket_path(bucket))
        return (e.extended.get("acl") if e else "") or "private"

    def _acl_allows(self, bucket: str, key: str, action: str,
                    authenticated: bool) -> bool:
        """Does the canned ACL open this request to a principal with
        no other grant? (public-read / public-read-write /
        authenticated-read semantics)."""
        if not bucket:
            return False
        acl = self._stored_acl(bucket, key)
        if acl == "public-read-write":
            return action in self._READ_ACTIONS | self._WRITE_ACTIONS
        if acl == "public-read":
            return action in self._READ_ACTIONS
        if acl == "authenticated-read":
            return authenticated and action in self._READ_ACTIONS
        return False

    def _acl_op(self, req: Request, bucket: str, key: str):
        """Get/Put{Bucket,Object}Acl (?acl): canned ACLs via the
        x-amz-acl header; GET renders the grant set the canned value
        implies (s3api_acp.go)."""
        path = f"{self._bucket_path(bucket)}/{key}" if key else \
            self._bucket_path(bucket)
        entry = self.filer.find_entry(path)
        if entry is None:
            return _error(404, "NoSuchKey" if key else "NoSuchBucket",
                          key or bucket)
        if req.method == "PUT":
            canned = req.headers.get("x-amz-acl", "")
            if not canned:
                # grant-body form: accept only documents expressing a
                # canned set; arbitrary grantees are out of scope.
                # Neither header nor body is AWS's MissingSecurityHeader
                # — NOT a silent reset to private
                return _error(
                    501 if req.body else 400,
                    "NotImplemented" if req.body
                    else "MissingSecurityHeader",
                    "only canned ACLs (x-amz-acl) are supported"
                    if req.body else
                    "PUT ?acl needs an x-amz-acl header")
            if canned not in self.CANNED_ACLS:
                return _error(400, "InvalidArgument",
                              f"unsupported ACL {canned!r}")
            entry.extended["acl"] = canned
            self.filer.create_entry(entry, create_parents=False)
            return 200, (b"", {})
        if req.method != "GET":
            return _error(405, "MethodNotAllowed", req.method)
        acl = entry.extended.get("acl", "") or "private"
        root = ET.Element("AccessControlPolicy", xmlns=S3_NS)
        owner = _elem(root, "Owner")
        _elem(owner, "ID", "seaweedfs-tpu")
        grants = _elem(root, "AccessControlList")

        def grant(grantee_uri, permission):
            g = _elem(grants, "Grant")
            ge = _elem(g, "Grantee")
            ge.set("{http://www.w3.org/2001/XMLSchema-instance}type",
                   "Group" if grantee_uri else "CanonicalUser")
            if grantee_uri:
                _elem(ge, "URI", grantee_uri)
            else:
                _elem(ge, "ID", "seaweedfs-tpu")
            _elem(g, "Permission", permission)

        grant("", "FULL_CONTROL")
        groups = "http://acs.amazonaws.com/groups/global/"
        if acl in ("public-read", "public-read-write"):
            grant(groups + "AllUsers", "READ")
        if acl == "public-read-write":
            grant(groups + "AllUsers", "WRITE")
        if acl == "authenticated-read":
            grant(groups + "AuthenticatedUsers", "READ")
        return 200, (_xml(root), "application/xml")

    @staticmethod
    def _policy_context(req: Request) -> dict:
        """Per-request condition context (policy_engine/engine.go
        buildConditionContext): the keys Condition blocks evaluate
        against."""
        from .. import security
        ctx = {
            "aws:SourceIp": req.remote_ip,
            "aws:SecureTransport":
                "true" if security.current().tls else "false",
            "aws:CurrentTime": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        ua = req.headers.get("User-Agent")
        if ua:
            ctx["aws:UserAgent"] = ua
        referer = req.headers.get("Referer")
        if referer:
            ctx["aws:Referer"] = referer
        for qk, ck in (("prefix", "s3:prefix"),
                       ("delimiter", "s3:delimiter"),
                       ("max-keys", "s3:max-keys")):
            if qk in req.query:
                ctx[ck] = req.query[qk]
        acl = req.headers.get("x-amz-acl")
        if acl:
            ctx["s3:x-amz-acl"] = acl
        return ctx

    def _policy_rules(self, bucket: str) -> list:
        from .policy import PolicyError, parse_policy
        e = self.filer.find_entry(self._bucket_path(bucket))
        doc = (e.extended.get("policy") if e else None) or ""
        if not doc:
            return []
        cached = self._policy_cache.get(bucket)
        if cached is not None and cached[0] == doc:
            return cached[1]
        try:
            stmts = parse_policy(doc.encode()
                                 if isinstance(doc, str) else doc)
        except PolicyError:
            stmts = []
        self._policy_cache[bucket] = (doc, stmts)
        return stmts

    def _bucket_lifecycle_op(self, req: Request, bucket: str):
        """Put/Get/DeleteBucketLifecycleConfiguration
        (s3api_bucket_handlers.go:800): rules persist on the bucket
        entry; the shell's s3.lifecycle.apply pass enforces them."""
        e = self.filer.find_entry(self._bucket_path(bucket))
        if e is None:
            return _error(404, "NoSuchBucket", bucket)
        if req.method == "PUT":
            # like _bucket_policy_op: lifecycle mutation is
            # destructive config — anonymous principals (even on
            # policy-opened buckets) may not install rules that
            # delete data
            if self.verifier is not None and \
                    not getattr(req, "s3_identity", None):
                return _error(403, "AccessDenied",
                              "lifecycle mutation requires a signed "
                              "request")
            from .lifecycle import LifecycleError, parse_lifecycle
            try:
                parse_lifecycle(req.body)
                doc = req.body.decode()
            except (LifecycleError, UnicodeDecodeError) as err:
                return _error(400, "MalformedXML", str(err))
            e.extended["lifecycle"] = doc
            self.filer.create_entry(e, create_parents=False)
            return 200, b""
        if req.method == "GET":
            doc = e.extended.get("lifecycle", "")
            if not doc:
                return _error(404,
                              "NoSuchLifecycleConfiguration", bucket)
            return 200, (doc.encode(), "application/xml")
        if req.method == "DELETE":
            if self.verifier is not None and \
                    not getattr(req, "s3_identity", None):
                return _error(403, "AccessDenied",
                              "lifecycle mutation requires a signed "
                              "request")
            e.extended.pop("lifecycle", None)
            self.filer.create_entry(e, create_parents=False)
            return 204, b""
        return _error(405, "MethodNotAllowed", req.method)

    def _bucket_policy_op(self, req: Request, bucket: str):
        """Put/Get/DeleteBucketPolicy (s3api policy_engine).  Policy
        mutation itself requires a SIGNED request — an anonymous
        principal must never be able to rewrite the policy that grants
        it access (checked here because _handle's anonymous path can
        reach bucket ops when a policy allows)."""
        from .policy import PolicyError, parse_policy
        e = self.filer.find_entry(self._bucket_path(bucket))
        if e is None:
            return _error(404, "NoSuchBucket", bucket)
        if req.method in ("PUT", "DELETE") and \
                self.verifier is not None and \
                not getattr(req, "s3_identity", None):
            return _error(403, "AccessDenied",
                          "policy mutation requires a signed request")
        if req.method == "PUT":
            try:
                parse_policy(req.body)
            except PolicyError as err:
                return _error(400, "MalformedPolicy", str(err))
            e.extended["policy"] = req.body.decode()
            self.filer.create_entry(e, create_parents=False)
            return 204, b""
        if req.method == "GET":
            doc = e.extended.get("policy", "")
            if not doc:
                return _error(404, "NoSuchBucketPolicy", bucket)
            return 200, (doc.encode(), "application/json")
        if req.method == "DELETE":
            e.extended.pop("policy", None)
            self.filer.create_entry(e, create_parents=False)
            return 204, b""
        return _error(405, "MethodNotAllowed", req.method)

    def _bucket_cors_op(self, req: Request, bucket: str):
        path = self._bucket_path(bucket)
        e = self.filer.find_entry(path)
        if e is None:
            return _error(404, "NoSuchBucket", bucket)
        if req.method == "PUT":
            try:
                parse_cors_config(req.body)
            except (ValueError, ET.ParseError) as err:
                return _error(400, "MalformedXML", str(err))
            e.extended["cors"] = req.body.decode()
            self.filer.create_entry(e, create_parents=False)
            return 200, b""
        if req.method == "GET":
            xml_text = e.extended.get("cors", "")
            if not xml_text:
                return _error(404, "NoSuchCORSConfiguration", bucket)
            return 200, (xml_text.encode(), "application/xml")
        if req.method == "DELETE":
            e.extended.pop("cors", None)
            self.filer.create_entry(e, create_parents=False)
            return 204, b""
        return _error(405, "MethodNotAllowed", req.method)

    # -- object lock (s3api_object_retention.go, object lock) -------------

    LOCK_MODES = ("GOVERNANCE", "COMPLIANCE")

    def _bucket_object_lock_op(self, req: Request, bucket: str):
        path = self._bucket_path(bucket)
        e = self.filer.find_entry(path)
        if e is None:
            return _error(404, "NoSuchBucket", bucket)
        if req.method == "PUT":
            if self._versioning_state(bucket) != "Enabled":
                return _error(409, "InvalidBucketState",
                              "object lock requires versioning")
            try:
                root = ET.fromstring(req.body)
            except ET.ParseError as err:
                return _error(400, "MalformedXML", str(err))
            mode, days = "", 0
            try:
                for el in root.iter():
                    tag = el.tag.rsplit("}", 1)[-1]
                    if tag == "Mode":
                        mode = (el.text or "").strip().upper()
                    elif tag in ("Days", "Years"):
                        days = int(el.text or 0) * \
                            (365 if tag == "Years" else 1)
            except ValueError as err:
                return _error(400, "MalformedXML", str(err))
            if mode and mode not in self.LOCK_MODES:
                return _error(400, "MalformedXML",
                              f"bad retention mode {mode!r}")
            if mode and days <= 0:
                return _error(400, "MalformedXML",
                              "retention needs positive Days/Years")
            e.extended["objectLock"] = "Enabled"
            # PUT replaces the WHOLE configuration: a config without a
            # Rule removes any previous default retention
            if mode:
                e.extended["lockDefaultMode"] = mode
                e.extended["lockDefaultDays"] = str(days)
            else:
                e.extended.pop("lockDefaultMode", None)
                e.extended.pop("lockDefaultDays", None)
            self.filer.create_entry(e, create_parents=False)
            return 200, b""
        if req.method == "GET":
            if e.extended.get("objectLock") != "Enabled":
                return _error(404,
                              "ObjectLockConfigurationNotFoundError",
                              bucket)
            root = ET.Element("ObjectLockConfiguration", xmlns=S3_NS)
            _elem(root, "ObjectLockEnabled", "Enabled")
            if e.extended.get("lockDefaultMode"):
                rule = _elem(root, "Rule")
                ret = _elem(rule, "DefaultRetention")
                _elem(ret, "Mode", e.extended["lockDefaultMode"])
                _elem(ret, "Days", e.extended.get("lockDefaultDays",
                                                  "0"))
            return 200, (_xml(root), "application/xml")
        return _error(405, "MethodNotAllowed", req.method)

    @staticmethod
    def _parse_retain_until(text: str) -> float:
        import calendar
        # timegm, NOT mktime-timezone: the date is UTC; mktime reads
        # the struct in LOCAL time and is an hour off under DST
        return calendar.timegm(time.strptime(
            text.split(".")[0].rstrip("Z"), "%Y-%m-%dT%H:%M:%S"))

    def _lock_for_put(self, req: Request, bucket: str,
                      state: str) -> "dict | tuple":
        """Resolve the retention to stamp on a new object version:
        explicit x-amz-object-lock-* headers, else the bucket default.
        Returns extended-dict updates, or an error response tuple.
        `state` is the caller's already-fetched versioning state (no
        redundant bucket lookups on the hot write path)."""
        lower = {k.lower(): v for k, v in req.headers.items()}
        mode = lower.get("x-amz-object-lock-mode", "").upper()
        until_raw = lower.get("x-amz-object-lock-retain-until-date",
                              "")
        if mode or until_raw:
            if mode not in self.LOCK_MODES or not until_raw:
                return _error(400, "InvalidArgument",
                              "object-lock mode AND retain-until-date "
                              "are both required")
            if state != "Enabled":
                return _error(400, "InvalidRequest",
                              "object lock requires versioning")
            try:
                until = self._parse_retain_until(until_raw)
            except ValueError:
                return _error(400, "InvalidArgument",
                              f"bad retain-until date {until_raw!r}")
            return {"lockMode": mode, "lockRetainUntil": str(until)}
        if state != "Enabled":
            # defaults only stamp real versions; never 'null' ones a
            # suspended bucket could silently destroy
            return {}
        b = self.filer.find_entry(self._bucket_path(bucket))
        if b is not None and b.extended.get("lockDefaultMode"):
            days = int(b.extended.get("lockDefaultDays", 0))
            return {"lockMode": b.extended["lockDefaultMode"],
                    "lockRetainUntil":
                        str(time.time() + days * 86400)}
        return {}

    @classmethod
    def _retention_active(cls, extended: dict) -> "str | None":
        """The active lock mode, or None when unlocked/expired."""
        mode = extended.get("lockMode", "")
        try:
            until = float(extended.get("lockRetainUntil", 0))
        except ValueError:
            until = 0
        if mode in cls.LOCK_MODES and time.time() < until:
            return mode
        return None

    def _check_version_deletable(self, req: Request, extended: dict):
        """403 response tuple when retention forbids deleting this
        version; None when allowed.  GOVERNANCE yields to the bypass
        header (the AWS permission model's s3:BypassGovernanceRetention
        reduced to the header check our auth model supports)."""
        mode = self._retention_active(extended)
        if mode is None:
            return None
        if mode == "GOVERNANCE":
            lower = {k.lower(): v for k, v in req.headers.items()}
            if lower.get("x-amz-bypass-governance-retention",
                         "").lower() == "true":
                return None
        return _error(403, "AccessDenied",
                      f"version is locked ({mode}) until "
                      f"{extended.get('lockRetainUntil')}")

    # -- versioning state (s3api_bucket_handlers.go) ----------------------

    def _versioning_state(self, bucket: str) -> str:
        e = self.filer.find_entry(self._bucket_path(bucket))
        return (e.extended.get("versioning", "") if e else "") or ""

    def _bucket_versioning_op(self, req: Request, bucket: str):
        path = self._bucket_path(bucket)
        e = self.filer.find_entry(path)
        if e is None:
            return _error(404, "NoSuchBucket", bucket)
        if req.method == "PUT":
            status = ""
            try:
                for el in ET.fromstring(req.body).iter():
                    if el.tag.endswith("Status"):
                        status = (el.text or "").strip()
            except ET.ParseError as err:
                return _error(400, "MalformedXML", str(err))
            if status not in ("Enabled", "Suspended"):
                return _error(400, "MalformedXML",
                              f"bad versioning status {status!r}")
            if status == "Suspended" and \
                    e.extended.get("objectLock") == "Enabled":
                # AWS forbids this: suspension would let 'null'
                # versions overwrite/delete locked data
                return _error(409, "InvalidBucketState",
                              "versioning cannot be suspended on an "
                              "object-lock-enabled bucket")
            e.extended["versioning"] = status
            self.filer.create_entry(e, create_parents=False)
            return 200, b""
        if req.method == "GET":
            root = ET.Element("VersioningConfiguration", xmlns=S3_NS)
            state = self._versioning_state(bucket)
            if state:
                _elem(root, "Status", state)
            return 200, (_xml(root), "application/xml")
        return _error(405, "MethodNotAllowed", req.method)

    # -- buckets ----------------------------------------------------------

    def _bucket_path(self, bucket: str) -> str:
        return f"{BUCKETS_ROOT}/{bucket}"

    def _list_buckets(self, ident=None):
        """With an IAM identity, only buckets it can Read or List are
        shown (s3api_bucket_handlers.go ListBucketsHandler filters the
        same way)."""
        root = ET.Element("ListAllMyBucketsResult", xmlns=S3_NS)
        owner = _elem(root, "Owner")
        _elem(owner, "ID", "seaweedfs-tpu")
        buckets = _elem(root, "Buckets")
        for e in self.filer.list_directory(BUCKETS_ROOT):
            if not e.is_directory:
                continue
            if ident is not None and not (
                    ident.can_do("Read", e.name) or
                    ident.can_do("List", e.name)):
                continue
            b = _elem(buckets, "Bucket")
            _elem(b, "Name", e.name)
            _elem(b, "CreationDate", _iso(e.attributes.crtime))
        return 200, (_xml(root), "application/xml")

    # -- bucket default encryption (s3api_bucket_handlers.go
    #    PutBucketEncryption; applied at PUT when the request carries
    #    no SSE headers of its own) --------------------------------------

    def _bucket_encryption_op(self, req: Request, bucket: str):
        path = self._bucket_path(bucket)
        e = self.filer.find_entry(path)
        if e is None:
            return _error(404, "NoSuchBucket", bucket)
        if req.method == "PUT":
            algo, kms_key = "", ""
            try:
                for el in ET.fromstring(req.body).iter():
                    tag = el.tag.rsplit("}", 1)[-1]
                    if tag == "SSEAlgorithm":
                        algo = (el.text or "").strip()
                    elif tag == "KMSMasterKeyID":
                        kms_key = (el.text or "").strip()
            except ET.ParseError as err:
                return _error(400, "MalformedXML", str(err))
            if algo not in ("AES256", "aws:kms"):
                return _error(400, "MalformedXML",
                              f"unsupported SSEAlgorithm {algo!r}")
            if self.kms is None:
                # both modes envelope-encrypt through the KMS here;
                # accepting the config would make every subsequent
                # object PUT fail 501 — reject the misconfiguration
                # at the source instead
                return _error(501, "NotImplemented",
                              "no KMS configured on this gateway")
            e.extended["encryptionConfig"] = json.dumps(
                {"algorithm": algo, "kmsKeyId": kms_key})
            self.filer.create_entry(e, create_parents=False)
            return 200, b""
        if req.method == "GET":
            raw = e.extended.get("encryptionConfig", "")
            if not raw:
                return _error(
                    404, "ServerSideEncryptionConfigurationNotFound"
                    "Error", "no default encryption configuration")
            cfg = json.loads(raw)
            root = ET.Element("ServerSideEncryptionConfiguration",
                              xmlns=S3_NS)
            rule = _elem(root, "Rule")
            by_default = _elem(rule,
                               "ApplyServerSideEncryptionByDefault")
            _elem(by_default, "SSEAlgorithm", cfg["algorithm"])
            if cfg.get("kmsKeyId"):
                _elem(by_default, "KMSMasterKeyID", cfg["kmsKeyId"])
            return 200, (_xml(root), "application/xml")
        if req.method == "DELETE":
            e.extended.pop("encryptionConfig", None)
            self.filer.create_entry(e, create_parents=False)
            return 204, b""
        return _error(405, "MethodNotAllowed", req.method)

    def _default_encryption(self, bucket: str
                            ) -> "tuple[str, str] | None":
        """The bucket's default-SSE setting in parse_sse_kms_headers'
        (mode, key_id) shape; None when unconfigured."""
        e = self.filer.find_entry(self._bucket_path(bucket))
        raw = e.extended.get("encryptionConfig", "") if e else ""
        if not raw:
            return None
        try:
            cfg = json.loads(raw)
            return cfg["algorithm"], cfg.get("kmsKeyId", "")
        except (ValueError, KeyError):
            return None

    def _bucket_op(self, req: Request, bucket: str):
        path = self._bucket_path(bucket)
        if "encryption" in req.query:
            return self._bucket_encryption_op(req, bucket)
        if "versioning" in req.query:
            return self._bucket_versioning_op(req, bucket)
        if "object-lock" in req.query:
            return self._bucket_object_lock_op(req, bucket)
        if "policy" in req.query:
            return self._bucket_policy_op(req, bucket)
        if "lifecycle" in req.query:
            return self._bucket_lifecycle_op(req, bucket)
        if "cors" in req.query:
            return self._bucket_cors_op(req, bucket)
        if "acl" in req.query:
            return self._acl_op(req, bucket, "")
        if "versions" in req.query and req.method == "GET":
            if self.filer.find_entry(path) is None:
                return _error(404, "NoSuchBucket", bucket)
            return self._list_versions(req, bucket)
        if req.method == "PUT":
            # idempotent re-PUT must keep the existing entry: a fresh
            # Entry would wipe extended (policy/cors/acl configs)
            e = self.filer.find_entry(path) or \
                Entry(path, is_directory=True)
            canned = req.headers.get("x-amz-acl", "")
            if canned and canned not in self.CANNED_ACLS:
                # silently ignoring would store a different ACL than
                # the client believes it set
                return _error(400, "InvalidArgument",
                              f"unsupported ACL {canned!r}")
            if canned:
                e.extended["acl"] = canned
            self.filer.create_entry(e)
            return 200, b""
        if req.method == "HEAD":
            if self.filer.find_entry(path) is None:
                return _error(404, "NoSuchBucket", bucket)
            return 200, b""
        if req.method == "DELETE":
            if self.filer.find_entry(path) is None:
                return _error(404, "NoSuchBucket", bucket)
            # only the reserved .uploads scratch dir is not bucket content
            children = self.filer.list_directory(path, limit=1000)
            if any(c.name != UPLOADS_DIR[1:] for c in children):
                return _error(409, "BucketNotEmpty", bucket)
            self.filer.delete_entry(path, recursive=True)
            return 204, b""
        if req.method == "GET":
            if self.filer.find_entry(path) is None:
                return _error(404, "NoSuchBucket", bucket)
            return self._list_objects(req, bucket)
        if req.method == "POST" and "delete" in req.query:
            return self._delete_objects(req, bucket)
        return _error(405, "MethodNotAllowed", req.method)

    # -- objects ----------------------------------------------------------

    def _object_op(self, req: Request, bucket: str, key: str):
        bucket_entry = self.filer.find_entry(
            self._bucket_path(bucket))
        if bucket_entry is None:
            return _error(404, "NoSuchBucket", bucket)
        if any(seg.endswith(VERSIONS_EXT)
               for seg in key.split("/") if seg):
            # the version-archive namespace is reserved
            # (s3_constants.VersionsFolder)
            return _error(400, "InvalidArgument",
                          f"key may not contain a segment ending "
                          f"{VERSIONS_EXT}")
        if "acl" in req.query:
            return self._acl_op(req, bucket, key)
        if "select" in req.query and req.method == "POST":
            return self._select_object(req, bucket, key)
        if req.method == "PUT" or ("uploads" in req.query or
                                   "uploadId" in req.query):
            # quota enforcement (s3.bucket.quota.enforce): an
            # over-quota bucket is read-only — writes refused,
            # deletes still allowed so users can free space
            if bucket_entry.extended.get("readOnly") == "true" and \
                    req.method in ("PUT", "POST"):
                return _error(403, "AccessDenied",
                              f"bucket {bucket} is read-only "
                              f"(quota exceeded)")
        if "uploads" in req.query and req.method == "POST":
            return self._initiate_multipart(req, bucket, key)
        if "uploadId" in req.query:
            return self._multipart_op(req, bucket, key)
        path = f"{self._bucket_path(bucket)}/{key}"
        state = self._versioning_state(bucket)
        if req.method == "PUT":
            src = req.headers.get("x-amz-copy-source")
            if src:
                return self._copy_object(req, src, path, bucket)
            from .policy import resource_arn
            from .sse import (ALGO_HEADER, KEY_MD5_HEADER, SseError,
                              encrypt, kms_encrypt,
                              kms_response_headers,
                              parse_sse_c_headers,
                              parse_sse_kms_headers)
            lower = {k.lower(): v for k, v in req.headers.items()}
            canned_acl = req.headers.get("x-amz-acl", "")
            if canned_acl and canned_acl not in self.CANNED_ACLS:
                # rejecting beats storing a different ACL than the
                # client believes it set
                return _error(400, "InvalidArgument",
                              f"unsupported ACL {canned_acl!r}")
            kms_headers = {}
            try:
                sse = parse_sse_c_headers(lower)
                kms_req = parse_sse_kms_headers(lower)
            except SseError as e:
                return _error(e.status, e.code, str(e))
            if sse is None and kms_req is None:
                # bucket-default encryption: a PUT with no SSE headers
                # inherits the bucket's configured default (SSE-S3 or
                # SSE-KMS), exactly AWS's PutBucketEncryption behavior
                kms_req = self._default_encryption(bucket)
            body = req.body
            sse_ext = {}
            if sse is not None:
                key_bytes, key_md5 = sse
                body, iv_hex = encrypt(key_bytes, body)
                sse_ext = {"sseKeyMd5": key_md5, "sseIv": iv_hex}
            elif kms_req is not None:
                if self.kms is None:
                    return _error(501, "NotImplemented",
                                  "no KMS configured on this gateway")
                try:
                    body, sse_ext = kms_encrypt(
                        self.kms, kms_req[0], kms_req[1],
                        resource_arn(bucket, key), body)
                except SseError as e:
                    return _error(e.status, e.code, str(e))
                kms_headers = kms_response_headers(sse_ext)
            lock_ext = self._lock_for_put(req, bucket, state)
            if not isinstance(lock_ext, dict):
                return lock_ext  # error response
            with self._path_lock(path):
                vid = self._pre_write_archive(path, state)
                # SSE-C etag covers the CIPHERTEXT (a plaintext md5
                # would leak content equality; AWS's SSE-C etag is
                # likewise not the plaintext md5)
                etag = hashlib.md5(body).hexdigest()
                entry = self.filer.write_file(
                    path, body,
                    mime=req.headers.get("Content-Type", ""))
                entry.extended["etag"] = etag
                entry.extended.update(sse_ext)
                entry.extended.update(lock_ext)
                if vid is not None:
                    entry.extended["versionId"] = vid
                amz = {k: v for k, v in req.headers.items()
                       if k.lower().startswith("x-amz-meta-")}
                entry.extended.update(amz)
                if canned_acl:
                    entry.extended["acl"] = canned_acl
                self.filer.create_entry(entry)
            headers = {"ETag": f'"{etag}"'}
            headers.update(kms_headers)
            if sse is not None:
                headers["x-amz-server-side-encryption-customer-"
                        "algorithm"] = "AES256"
                headers[KEY_MD5_HEADER] = sse[1]
            if vid:
                headers["x-amz-version-id"] = vid
            return 200, (b"", headers)
        if req.method in ("GET", "HEAD"):
            return self._get_object(req, bucket, key, path)
        if req.method == "DELETE":
            return self._delete_object(req, bucket, key, path, state)
        return _error(405, "MethodNotAllowed", req.method)

    def _select_object(self, req: Request, bucket: str, key: str):
        """SelectObjectContent (POST /bucket/key?select&select-type=2):
        SQL-subset over a JSON-lines/CSV object (weed/query/engine/).
        Results stream back in genuine AWS event-stream framing
        (Records/Stats/End messages, CRC'd — s3/eventstream.py), with
        newline-delimited JSON records inside the Records payloads —
        the reference's own engine output shape."""
        from ..query import QueryError, run_query
        from .sse import SseError, check_read_key, decrypt_entry
        path = f"{self._bucket_path(bucket)}/{key}"
        entry = self.filer.find_entry(path)
        if entry is None or entry.is_directory:
            return _error(404, "NoSuchKey", key)
        # SSE-C: select is a READ — it must enforce and use the
        # customer key exactly like GET (querying raw ciphertext would
        # both leak it and never match)
        lower = {k.lower(): v for k, v in req.headers.items()}
        try:
            sse_key = check_read_key(entry.extended, lower)
        except SseError as e:
            return _error(e.status, e.code, str(e))
        try:
            root = ET.fromstring(req.body)
        except ET.ParseError as e:
            return _error(400, "MalformedXML", str(e))
        expression = ""
        input_format = "json"
        csv_header = True
        for el in root.iter():
            tag = el.tag.rsplit("}", 1)[-1]
            if tag == "Expression":
                expression = el.text or ""
            elif tag == "InputSerialization":
                # only the INPUT block decides the source format
                # (OutputSerialization may also contain <CSV>)
                for sub in el.iter():
                    stag = sub.tag.rsplit("}", 1)[-1]
                    if stag == "CSV":
                        input_format = "csv"
                    elif stag == "Parquet":
                        input_format = "parquet"
                    elif stag == "FileHeaderInfo":
                        csv_header = \
                            (sub.text or "").upper() != "NONE"
        if not expression:
            return _error(400, "MissingRequiredParameter",
                          "Expression is required")
        data = self.filer.read_file(path)
        if sse_key is not None and data:
            data = decrypt_entry(sse_key, entry.extended, data)
        elif entry.extended.get("sseKmsBlob") and data:
            data, kms_err = self._kms_read(entry, path, data)
            if kms_err is not None:
                return kms_err
        try:
            rows = run_query(expression, data, input_format,
                             csv_header)
        except QueryError as e:
            return _error(400, "InvalidTextEncoding", str(e))
        import json as _json
        from .eventstream import end_event, records_event, stats_event
        payload = b"".join(_json.dumps(r, separators=(",", ":"))
                           .encode() + b"\n" for r in rows)
        # AWS event-stream framing (Records* -> Stats -> End), 64KB
        # Records chunks like the reference's streaming writer
        events = [records_event(payload[off:off + 65536])
                  for off in range(0, len(payload), 65536)]
        events.append(stats_event(len(data), len(payload)))
        events.append(end_event())
        return 200, (b"".join(events),
                     "application/vnd.amazon.eventstream")

    # -- versioning core (s3api_object_versioning.go) ---------------------

    def _pre_write_archive(self, path: str, state: str) -> str | None:
        """Before a plain-path write: archive the current entry into
        `<key>.versions/` according to the bucket's versioning state.
        Returns the new content's version id (None = unversioned).

        Enabled: always archive the incumbent (its chunks move with the
        rename — never deleted), new content gets a fresh id.
        Suspended: a real-id incumbent is archived, a 'null' incumbent
        is simply overwritten; new content is the 'null' version."""
        if state == "Enabled":
            self._archive_current(path)
            return new_version_id()
        if state == "Suspended":
            cur = self.filer.find_entry(path)
            if cur is not None and not cur.is_directory and \
                    cur.extended.get("versionId", "null") != "null":
                self._archive_current(path)
            return "null"
        return None

    def _archive_current(self, path: str) -> None:
        cur = self.filer.find_entry(path)
        if cur is None or cur.is_directory:
            return
        vid = cur.extended.get("versionId", "null")
        cur.extended["versionId"] = vid
        self.filer.create_entry(cur, create_parents=False)
        self.filer.rename(path, f"{path}{VERSIONS_EXT}/{vid}")

    @staticmethod
    def _recency_key(e: Entry):
        """Version recency: newest first.  mtime is the truth — the
        inverted-timestamp id gives lexical newest-first for Enabled-era
        versions, but the suspended-era 'null' id sorts after every hex
        id and would otherwise always rank oldest (letting a
        null-marker-deleted object resurrect)."""
        return (-e.attributes.mtime, e.name)

    def _promote_latest(self, path: str) -> None:
        """After a specific-version delete: if the plain path is gone
        and the newest surviving archived version is REAL, it becomes
        the plain entry again (AWS latest-version semantics)."""
        if self.filer.find_entry(path) is not None:
            return
        vdir = path + VERSIONS_EXT
        versions = [e for e in self.filer.list_directory(vdir)
                    if not e.is_directory]
        if not versions:
            if self.filer.find_entry(vdir) is not None:
                self.filer.delete_entry(vdir, recursive=True)
            return
        newest = min(versions, key=self._recency_key)
        if newest.extended.get("deleteMarker") == "true":
            return
        self.filer.rename(f"{vdir}/{newest.name}", path)

    def _kms_read(self, entry: Entry, path: str, data: bytes):
        """Decrypt an SSE-KMS body on a read path; (data, None) on
        success, (None, error_response) otherwise — one place for the
        no-KMS/ bad-seal handling every read path needs."""
        from .sse import SseError, kms_decrypt
        if self.kms is None:
            return None, _error(501, "NotImplemented",
                                "object is SSE-KMS encrypted but "
                                "this gateway has no KMS")
        try:
            return kms_decrypt(self.kms, entry.extended,
                               self._arn_for_path(path), data), None
        except SseError as e:
            return None, _error(e.status, e.code, str(e))

    @staticmethod
    def _arn_for_path(path: str) -> str:
        """Object ARN from a filer path, versioned or not: all
        versions of a key share the key's ARN (the KMS encryption
        context must match what PUT bound)."""
        rel = path.removeprefix(BUCKETS_ROOT + "/")
        if VERSIONS_EXT + "/" in rel:
            rel = rel.split(VERSIONS_EXT + "/", 1)[0].rstrip("/")
        return f"arn:aws:s3:::{rel}"

    def _serve_entry(self, req: Request, path: str, entry: Entry):
        from .sse import (KEY_MD5_HEADER, SseError, check_read_key,
                          decrypt_entry, kms_response_headers)
        lower = {k.lower(): v for k, v in req.headers.items()}
        try:
            sse_key = check_read_key(entry.extended, lower)
        except SseError as e:
            return _error(e.status, e.code, str(e))
        # zero-copy plain-object GETs: no SSE transform means nothing
        # needs the whole body in memory — stream chunk views lazily
        # through the filer's hot chunk cache instead of buffering a
        # multi-GB object per request (SWFS013's reason to exist).
        # SSE-C/KMS objects still buffer: decryption wants the full
        # ciphertext.
        plain = sse_key is None and \
            not entry.extended.get("sseKmsBlob")
        stream_open = getattr(self.filer, "open_read_stream", None) \
            if plain and req.method == "GET" else None
        data = b"" if req.method == "HEAD" or stream_open else \
            self.filer.read_file(path)
        if sse_key is not None and data:
            data = decrypt_entry(sse_key, entry.extended, data)
        elif entry.extended.get("sseKmsBlob") and data:
            data, kms_err = self._kms_read(entry, path, data)
            if kms_err is not None:
                return kms_err
        etag = entry.extended.get("etag", "")
        mime = entry.attributes.mime or "application/octet-stream"
        headers = {"Content-Type": mime,
                   "ETag": f'"{etag}"',
                   "Content-Length": str(total_size(entry.chunks)),
                   "Last-Modified": _iso(entry.attributes.mtime)}
        if entry.extended.get("sseKeyMd5"):
            headers["x-amz-server-side-encryption-customer-"
                    "algorithm"] = "AES256"
            headers[KEY_MD5_HEADER] = entry.extended["sseKeyMd5"]
        headers.update(kms_response_headers(entry.extended))
        if entry.extended.get("lockMode"):
            headers["x-amz-object-lock-mode"] = \
                entry.extended["lockMode"]
            until = float(entry.extended.get("lockRetainUntil", 0))
            headers["x-amz-object-lock-retain-until-date"] = \
                time.strftime("%Y-%m-%dT%H:%M:%SZ",
                              time.gmtime(until))
        vid = entry.extended.get("versionId")
        if vid:
            headers["x-amz-version-id"] = vid
        if stream_open is not None:
            from ..server.httpd import parse_range
            total = total_size(entry.chunks)
            parsed = parse_range(req.headers.get("Range", ""), total)
            if parsed == "unsatisfiable":
                return 416, (b"", {"Content-Range":
                                   f"bytes */{total}"})
            start, size = parsed if parsed is not None else (0, total)
            from .. import qos
            release, deny = qos.charge_response(req, size, "s3")
            if deny is not None:
                return deny
            body = stream_open(entry, start, size, on_close=release)
            headers["Content-Length"] = str(size)
            if parsed is not None:
                headers["Content-Range"] = \
                    f"bytes {start}-{start + size - 1}/{total}"
                return 206, (body, headers)
            return 200, (body, headers)
        if req.method == "GET":
            # ranged GetObject over the BUFFERED (SSE) path: ranges
            # apply AFTER decryption — CTR mode could seek, but
            # correctness first; shared parser keeps semantics
            # identical with the filer paths
            from ..server.httpd import parse_range
            total = len(data)
            status = 200
            parsed = parse_range(req.headers.get("Range", ""), total)
            if parsed == "unsatisfiable":
                return 416, (b"", {"Content-Range":
                                   f"bytes */{total}"})
            if parsed is not None:
                start, size = parsed
                data = data[start:start + size]
                headers["Content-Range"] = \
                    f"bytes {start}-{start + len(data) - 1}/{total}"
                status = 206
            # the buffered (SSE) read is the MOST expensive shape on
            # the server — full ciphertext + plaintext resident — so
            # it must spend the same in-flight-byte budget the
            # streamed path does, not evade it
            from .. import qos
            release, deny = qos.charge_response(req, len(data), "s3")
            if deny is not None:
                return deny
            headers["Content-Length"] = str(len(data))
            if release is not None:
                return status, (qos.MeteredBody(data, release), headers)
            return status, (data, headers)
        return 200, (data, headers)

    def _get_object(self, req: Request, bucket: str, key: str,
                    path: str):
        vid = req.query.get("versionId", "")
        if vid:
            entry = self.filer.find_entry(path)
            if entry is not None and \
                    entry.extended.get("versionId", "null") == vid:
                return self._serve_entry(req, path, entry)
            vpath = f"{path}{VERSIONS_EXT}/{vid}"
            entry = self.filer.find_entry(vpath)
            if entry is None:
                return _error(404, "NoSuchVersion", vid)
            if entry.extended.get("deleteMarker") == "true":
                # GET on a delete marker: 405 (AWS behavior)
                return 405, (b"", {"x-amz-delete-marker": "true",
                                   "x-amz-version-id": vid,
                                   "Allow": "DELETE"})
            return self._serve_entry(req, vpath, entry)
        entry = self.filer.find_entry(path)
        if entry is None or entry.is_directory:
            newest = self._newest_version(path)
            if newest is not None and \
                    newest.extended.get("deleteMarker") == "true":
                return 404, (_error(404, "NoSuchKey", key)[1][0],
                             {"x-amz-delete-marker": "true",
                              "Content-Type": "application/xml"})
            return _error(404, "NoSuchKey", key)
        return self._serve_entry(req, path, entry)

    def _newest_version(self, path: str) -> Entry | None:
        versions = [e for e in
                    self.filer.list_directory(path + VERSIONS_EXT)
                    if not e.is_directory]
        return min(versions, key=self._recency_key) if versions \
            else None

    def _delete_object(self, req: Request, bucket: str, key: str,
                       path: str, state: str):
        with self._path_lock(path):
            return self._delete_object_locked(req, bucket, key, path,
                                              state)

    def _delete_object_locked(self, req: Request, bucket: str,
                              key: str, path: str, state: str):
        vid = req.query.get("versionId", "")
        if vid:
            return self._delete_specific_version(bucket, path, vid,
                                                 req)
        if state in ("Enabled", "Suspended"):
            # archive the incumbent and leave a delete marker
            # (createDeleteMarker, s3api_object_versioning.go:160)
            cur = self.filer.find_entry(path)
            if cur is not None and not cur.is_directory:
                if state == "Suspended" and \
                        cur.extended.get("versionId", "null") == "null":
                    self.filer.delete_entry(path)
                else:
                    self._archive_current(path)
            marker_vid = new_version_id() if state == "Enabled" \
                else "null"
            mpath = f"{path}{VERSIONS_EXT}/{marker_vid}"
            if self.filer.find_entry(mpath) is not None:
                self.filer.delete_entry(mpath)
            marker = Entry(mpath)
            marker.extended["deleteMarker"] = "true"
            marker.extended["versionId"] = marker_vid
            self.filer.create_entry(marker)
            return 204, (b"", {"x-amz-delete-marker": "true",
                               "x-amz-version-id": marker_vid})
        entry = self.filer.find_entry(path)
        if entry is not None:
            self.filer.delete_entry(path)
            self._prune_empty_dirs(path, bucket)
        return 204, b""

    def _delete_specific_version(self, bucket: str, path: str,
                                 vid: str, req: "Request | None" = None):
        was_marker = False
        cur = self.filer.find_entry(path)
        if cur is not None and not cur.is_directory and \
                cur.extended.get("versionId", "null") == vid:
            if req is not None:
                blocked = self._check_version_deletable(
                    req, cur.extended)
                if blocked is not None:
                    return blocked
            self.filer.delete_entry(path)
        else:
            vpath = f"{path}{VERSIONS_EXT}/{vid}"
            e = self.filer.find_entry(vpath)
            if e is not None:
                if req is not None:
                    blocked = self._check_version_deletable(
                        req, e.extended)
                    if blocked is not None:
                        return blocked
                was_marker = e.extended.get("deleteMarker") == "true"
                self.filer.delete_entry(vpath)
        self._promote_latest(path)
        self._prune_empty_dirs(path, bucket)
        headers = {"x-amz-version-id": vid}
        if was_marker:
            headers["x-amz-delete-marker"] = "true"
        return 204, (b"", headers)

    # -- ListObjectVersions (GET /bucket?versions) ------------------------

    def _list_versions(self, req: Request, bucket: str):
        """s3api_object_versioning.go listObjectVersions.  Collected
        per key (latest first), emitted in key order; supports prefix +
        max-keys truncation with key/version markers."""
        prefix = req.query.get("prefix", "")
        max_keys = int(req.query.get("max-keys", 1000))
        key_marker = req.query.get("key-marker", "")
        vid_marker = req.query.get("version-id-marker", "")
        base = self._bucket_path(bucket)
        per_key: dict[str, list[Entry]] = {}

        def walk(dir_path: str, key_prefix: str):
            if prefix and not (key_prefix.startswith(prefix) or
                               prefix.startswith(key_prefix)):
                return
            for e in self.filer.list_directory(dir_path,
                                               limit=1_000_000):
                if e.is_directory:
                    if e.name.endswith(VERSIONS_EXT):
                        obj_key = key_prefix + \
                            e.name[:-len(VERSIONS_EXT)]
                        if obj_key.startswith(prefix):
                            vs = [v for v in self.filer.list_directory(
                                f"{dir_path}/{e.name}")
                                if not v.is_directory]
                            per_key.setdefault(obj_key, []).extend(
                                sorted(vs, key=self._recency_key))
                    elif not (key_prefix == "" and
                              e.name == UPLOADS_DIR[1:]):
                        walk(f"{dir_path}/{e.name}",
                             key_prefix + e.name + "/")
                else:
                    obj_key = key_prefix + e.name
                    if obj_key.startswith(prefix):
                        per_key.setdefault(obj_key, []).insert(0, e)

        walk(base, "")
        root = ET.Element("ListVersionsResult", xmlns=S3_NS)
        _elem(root, "Name", bucket)
        _elem(root, "Prefix", prefix)
        _elem(root, "MaxKeys", max_keys)
        count = 0
        truncated = False
        skipping = bool(key_marker)
        for obj_key in sorted(per_key):
            if key_marker and obj_key < key_marker:
                continue
            if key_marker and obj_key == key_marker and \
                    not vid_marker:
                # key-marker alone means "begin AFTER this key"
                continue
            for i, e in enumerate(per_key[obj_key]):
                e_vid = e.extended.get("versionId", "null")
                if skipping and obj_key == key_marker:
                    if e_vid == vid_marker:
                        skipping = False
                    continue  # markers are exclusive
                if count >= max_keys:
                    truncated = True
                    _elem(root, "NextKeyMarker", obj_key)
                    _elem(root, "NextVersionIdMarker", e_vid)
                    break
                is_marker = e.extended.get("deleteMarker") == "true"
                v = _elem(root,
                          "DeleteMarker" if is_marker else "Version")
                _elem(v, "Key", obj_key)
                _elem(v, "VersionId", e_vid)
                _elem(v, "IsLatest",
                      "true" if i == 0 else "false")
                _elem(v, "LastModified", _iso(e.attributes.mtime))
                if not is_marker:
                    _elem(v, "ETag",
                          f'"{e.extended.get("etag", "")}"')
                    _elem(v, "Size", total_size(e.chunks))
                    _elem(v, "StorageClass", "STANDARD")
                count += 1
            if truncated:
                break
        _elem(root, "IsTruncated", "true" if truncated else "false")
        return 200, (_xml(root), "application/xml")

    def _prune_empty_dirs(self, path: str, bucket: str) -> None:
        """Remove now-empty parent directories up to the bucket root
        (S3 has no directories — an emptied prefix must disappear;
        s3api/s3api_object_handlers_delete.go doDeleteEmptyDirectories)."""
        stop = self._bucket_path(bucket)
        parent = path.rsplit("/", 1)[0]
        while parent != stop and parent.startswith(stop + "/"):
            if self.filer.list_directory(parent, limit=1):
                break
            try:
                self.filer.delete_entry(parent)
            except IsADirectoryError:
                break  # concurrent PUT repopulated it — keep it
            parent = parent.rsplit("/", 1)[0]

    def _copy_object(self, req: Request, src: str, dst_path: str,
                     bucket: str):
        from .sse import (SseError, check_read_key, decrypt_entry,
                          encrypt, kms_encrypt, parse_sse_c_headers,
                          parse_sse_kms_headers)
        src = urllib.parse.unquote(src.lstrip("/"))
        src_path = f"{BUCKETS_ROOT}/{src}"
        entry = self.filer.find_entry(src_path)
        if entry is None:
            return _error(404, "NoSuchKey", src)
        lower = {k.lower(): v for k, v in req.headers.items()}
        # SSE-C source: the copy-source key headers are REQUIRED to
        # decrypt; copying raw ciphertext while dropping the SSE
        # metadata would serve garbage as if it were plaintext
        src_sse = {k.replace("x-amz-copy-source-server-side-"
                             "encryption-customer-",
                             "x-amz-server-side-encryption-customer-"):
                   v for k, v in lower.items()
                   if k.startswith("x-amz-copy-source-server-side-")}
        try:
            src_key = check_read_key(entry.extended, src_sse)
            dst_sse = parse_sse_c_headers(lower)
            dst_kms = parse_sse_kms_headers(lower)
        except SseError as e:
            return _error(e.status, e.code, str(e))
        if dst_sse is None and dst_kms is None:
            # the destination is a new object: the bucket's default
            # encryption applies exactly like a plain PUT
            dst_kms = self._default_encryption(bucket)
        data = self.filer.read_file(src_path)
        if src_key is not None:
            data = decrypt_entry(src_key, entry.extended, data)
        elif entry.extended.get("sseKmsBlob"):
            data, kms_err = self._kms_read(entry, src_path, data)
            if kms_err is not None:
                return kms_err
        sse_ext = {}
        if dst_sse is not None:
            dst_key, dst_md5 = dst_sse
            data, iv_hex = encrypt(dst_key, data)
            sse_ext = {"sseKeyMd5": dst_md5, "sseIv": iv_hex}
        elif dst_kms is not None:
            if self.kms is None:
                return _error(501, "NotImplemented",
                              "no KMS configured on this gateway")
            from .policy import resource_arn
            dst_key_part = dst_path.removeprefix(
                f"{self._bucket_path(bucket)}/")
            try:
                data, sse_ext = kms_encrypt(
                    self.kms, dst_kms[0], dst_kms[1],
                    resource_arn(bucket, dst_key_part), data)
            except SseError as e:
                return _error(e.status, e.code, str(e))
        # the copy is a new version: retention headers / bucket default
        # apply exactly like a plain PUT (silently skipping them would
        # bypass the bucket's retention policy)
        lock_ext = self._lock_for_put(
            req, bucket, self._versioning_state(bucket))
        if not isinstance(lock_ext, dict):
            return lock_ext
        etag = hashlib.md5(data).hexdigest()
        with self._path_lock(dst_path):
            vid = self._pre_write_archive(
                dst_path, self._versioning_state(bucket))
            new = self.filer.write_file(dst_path, data,
                                        mime=entry.attributes.mime)
            new.extended["etag"] = etag
            new.extended.update(sse_ext)
            new.extended.update(lock_ext)
            if vid is not None:
                new.extended["versionId"] = vid
            self.filer.create_entry(new)
        root = ET.Element("CopyObjectResult", xmlns=S3_NS)
        _elem(root, "ETag", f'"{etag}"')
        _elem(root, "LastModified", _iso(time.time()))
        resp = 200, (_xml(root), "application/xml")
        return _with_headers(resp, {"x-amz-version-id": vid}) if vid \
            else resp

    def _delete_objects(self, req: Request, bucket: str):
        """POST /bucket?delete — batch delete (versioning-aware: each
        key routes through the same delete path as single DELETE)."""
        root = ET.fromstring(req.body)
        result = ET.Element("DeleteResult", xmlns=S3_NS)
        state = self._versioning_state(bucket)
        for obj in root.iter():
            if not obj.tag.endswith("Object"):
                continue
            key = vid = ""
            for child in obj:
                if child.tag.endswith("Key"):
                    key = child.text or ""
                elif child.tag.endswith("VersionId"):
                    vid = child.text or ""
            if not key:
                continue
            path = f"{self._bucket_path(bucket)}/{key}"
            failed = None
            if vid:
                with self._path_lock(path):
                    r = self._delete_specific_version(bucket, path,
                                                      vid, req)
                if r[0] >= 300:
                    failed = r
            elif state in ("Enabled", "Suspended"):
                self._delete_object(req, bucket, key, path, state)
            else:
                self.filer.delete_entry(path)
                self._prune_empty_dirs(path, bucket)
            if failed is not None:
                # a locked version is NOT deleted — reporting
                # <Deleted> would lie to lifecycle/cleanup clients
                err = _elem(result, "Error")
                _elem(err, "Key", key)
                if vid:
                    _elem(err, "VersionId", vid)
                _elem(err, "Code", "AccessDenied")
                _elem(err, "Message", "version is locked")
                continue
            d = _elem(result, "Deleted")
            _elem(d, "Key", key)
            if vid:
                _elem(d, "VersionId", vid)
        return 200, (_xml(result), "application/xml")

    # -- ListObjectsV2 (s3api_objects_list_handlers.go) -------------------

    def _list_objects(self, req: Request, bucket: str):
        prefix = req.query.get("prefix", "")
        delimiter = req.query.get("delimiter", "")
        max_keys = int(req.query.get("max-keys", 1000))
        token = req.query.get("continuation-token", "")
        start_after = req.query.get("start-after", "")
        start = max(token, start_after)
        base = self._bucket_path(bucket)

        contents: list[tuple[str, Entry]] = []
        common: set[str] = set()

        def walk_sorted(dir_path: str, key_prefix: str):
            """Yield (key, entry) in global lexicographic key order.

            Children sort by their *effective* key start (name for
            files, name + "/" for directories — "a!" must come before
            "a/b"); each directory pages through the store so listings
            beyond one page are never dropped.
            """
            # prune: subtree can't contain the prefix, or every key in
            # it (all sharing key_prefix) sorts <= start
            if prefix and not (key_prefix.startswith(prefix) or
                               prefix.startswith(key_prefix)):
                return
            if start and key_prefix and key_prefix < start and \
                    not start.startswith(key_prefix):
                return
            page: list = []
            last = ""
            while True:
                batch = self.filer.list_directory(
                    dir_path, start_file=last, limit=1000)
                page.extend(batch)
                if len(batch) < 1000:
                    break
                last = batch[-1].name
            def eff(e):
                return e.name + ("/" if e.is_directory else "")
            for e in sorted(page, key=eff):
                if e.is_directory:
                    # hide the reserved multipart scratch dir at the
                    # bucket root and version-archive dirs anywhere;
                    # other dot-prefixed path segments are legal S3
                    # keys (e.g. ".well-known/acme")
                    if e.name.endswith(VERSIONS_EXT):
                        continue
                    if not (key_prefix == "" and
                            e.name == UPLOADS_DIR[1:]):
                        yield from walk_sorted(
                            f"{dir_path}/{e.name}",
                            key_prefix + e.name + "/")
                    continue
                yield key_prefix + e.name, e

        truncated = False
        for key, e in walk_sorted(base, ""):
            if not key.startswith(prefix) or key <= start:
                continue
            # AWS counts Keys + CommonPrefixes toward MaxKeys
            if len(contents) + len(common) >= max_keys:
                truncated = True
                break
            if delimiter:
                rest = key[len(prefix):]
                if delimiter in rest:
                    common.add(prefix + rest.split(delimiter, 1)[0] +
                               delimiter)
                    continue
            contents.append((key, e))

        root = ET.Element("ListBucketResult", xmlns=S3_NS)
        _elem(root, "Name", bucket)
        _elem(root, "Prefix", prefix)
        _elem(root, "MaxKeys", max_keys)
        _elem(root, "KeyCount", len(contents) + len(common))
        _elem(root, "IsTruncated", "true" if truncated else "false")
        if truncated:
            token_key = contents[-1][0] if contents else \
                (sorted(common)[-1] if common else "")
            if token_key:
                _elem(root, "NextContinuationToken", token_key)
        for key, e in contents:
            c = _elem(root, "Contents")
            _elem(c, "Key", key)
            _elem(c, "LastModified", _iso(e.attributes.mtime))
            _elem(c, "ETag", f'"{e.extended.get("etag", "")}"')
            _elem(c, "Size", total_size(e.chunks))
            _elem(c, "StorageClass", "STANDARD")
        for p in sorted(common):
            cp = _elem(root, "CommonPrefixes")
            _elem(cp, "Prefix", p)
        return 200, (_xml(root), "application/xml")

    # -- multipart (filer_multipart.go) -----------------------------------

    def _uploads_path(self, bucket: str, upload_id: str) -> str:
        return f"{self._bucket_path(bucket)}{UPLOADS_DIR}/{upload_id}"

    def _initiate_multipart(self, req: Request, bucket: str,
                            key: str):
        from .policy import resource_arn
        from .sse import (SseError, parse_sse_c_headers,
                          parse_sse_kms_headers)
        upload_id = uuid.uuid4().hex
        marker = Entry(self._uploads_path(bucket, upload_id),
                       is_directory=True)
        marker.extended["key"] = key
        # SSE intent binds at initiation (s3api_object_multipart.go):
        # SSE-C remembers only MD5(key) — each UploadPart must present
        # the key again; SSE-KMS mints the data key NOW so every part
        # encrypts under one key (per-part IVs)
        lower = {k.lower(): v for k, v in req.headers.items()}
        try:
            sse_c = parse_sse_c_headers(lower)
            sse_kms = parse_sse_kms_headers(lower)
        except SseError as e:
            return _error(e.status, e.code, str(e))
        if sse_c is None and sse_kms is None:
            # bucket-default encryption binds at initiation too (AWS
            # applies PutBucketEncryption defaults to multipart)
            sse_kms = self._default_encryption(bucket)
        if sse_c is not None:
            marker.extended["sseKeyMd5"] = sse_c[1]
        elif sse_kms is not None:
            if self.kms is None:
                return _error(501, "NotImplemented",
                              "no KMS configured on this gateway")
            from .sse import kms_encrypt
            try:
                # encrypt an empty body just to mint+seal a data key
                _, sse_ext = kms_encrypt(
                    self.kms, sse_kms[0], sse_kms[1],
                    resource_arn(bucket, key), b"")
            except SseError as e:
                return _error(e.status, e.code, str(e))
            sse_ext.pop("sseIv", None)
            marker.extended.update(sse_ext)
        self.filer.create_entry(marker)
        root = ET.Element("InitiateMultipartUploadResult", xmlns=S3_NS)
        _elem(root, "Bucket", bucket)
        _elem(root, "Key", key)
        _elem(root, "UploadId", upload_id)
        return 200, (_xml(root), "application/xml")

    def _multipart_op(self, req: Request, bucket: str, key: str):
        upload_id = req.query["uploadId"]
        updir = self._uploads_path(bucket, upload_id)
        marker = self.filer.find_entry(updir)
        if marker is None:
            return _error(404, "NoSuchUpload", upload_id)
        if req.method == "PUT":
            from .sse import (SseError, encrypt,
                              parse_sse_c_headers)
            part = int(req.query["partNumber"])
            body = req.body
            etag = hashlib.md5(body).hexdigest()
            part_iv = ""
            if not (marker.extended.get("sseKeyMd5") or
                    marker.extended.get("sseKmsBlob")) and any(
                    k.lower().startswith(
                        "x-amz-server-side-encryption")
                    for k in req.headers):
                # SSE headers on a part of a NON-SSE upload: refusing
                # beats silently storing plaintext the client believes
                # is encrypted (AWS rejects the mismatch too)
                return _error(400, "InvalidRequest",
                              "upload was not initiated with SSE")
            if marker.extended.get("sseKeyMd5"):
                # SSE-C upload: the part must present the SAME key
                lower = {k.lower(): v
                         for k, v in req.headers.items()}
                try:
                    sse = parse_sse_c_headers(lower)
                except SseError as e:
                    return _error(e.status, e.code, str(e))
                if sse is None or sse[1] !=                         marker.extended["sseKeyMd5"]:
                    return _error(400, "InvalidRequest",
                                  "UploadPart needs the initiate-"
                                  "time SSE-C key")
                body, part_iv = encrypt(sse[0], body)
            elif marker.extended.get("sseKmsBlob"):
                if self.kms is None:
                    return _error(501, "NotImplemented",
                                  "SSE-KMS upload but no KMS here")
                from ..iam.kms import KmsError
                from .policy import resource_arn
                try:
                    dk = self.kms.decrypt(
                        marker.extended["sseKmsBlob"],
                        {"aws:s3:arn": resource_arn(
                            bucket, marker.extended.get("key", key))})
                except KmsError as e:
                    return _error(403, "AccessDenied", str(e))
                body, part_iv = encrypt(dk["Plaintext"], body)
            e = self.filer.write_file(f"{updir}/{part:05d}.part",
                                      body)
            e.extended["etag"] = etag
            if part_iv:
                e.extended["sseIv"] = part_iv
            self.filer.create_entry(e)
            return 200, (b"", {"ETag": f'"{etag}"'})
        if req.method == "GET":
            root = ET.Element("ListPartsResult", xmlns=S3_NS)
            _elem(root, "Bucket", bucket)
            _elem(root, "Key", key)
            _elem(root, "UploadId", upload_id)
            for e in self.filer.list_directory(updir):
                if e.name.endswith(".part"):
                    p = _elem(root, "Part")
                    _elem(p, "PartNumber", int(e.name.split(".")[0]))
                    _elem(p, "ETag",
                          f'"{e.extended.get("etag", "")}"')
                    _elem(p, "Size", total_size(e.chunks))
            return 200, (_xml(root), "application/xml")
        if req.method == "DELETE":
            self.filer.delete_entry(updir, recursive=True)
            return 204, b""
        if req.method == "POST":
            # CompleteMultipartUpload: stitch the parts the CLIENT's
            # manifest commits (strays from retried attempts are
            # dropped), without copying data (filer_multipart.go)
            manifest: list[int] | None = None
            if req.body.strip():
                manifest = sorted(
                    int(el.text) for el in ET.fromstring(req.body).iter()
                    if el.tag.endswith("PartNumber"))
            parts = sorted(
                (e for e in self.filer.list_directory(updir)
                 if e.name.endswith(".part")),
                key=lambda e: int(e.name.split(".")[0]))
            if manifest is not None:
                parts = [p for p in parts
                         if int(p.name.split(".")[0]) in manifest]
            chunks = []
            offset = 0
            etags = b""
            sse_parts = []
            for p in parts:
                if p.extended.get("sseIv"):
                    sse_parts.append({"offset": offset,
                                      "iv": p.extended["sseIv"]})
                for c in p.chunks:
                    chunks.append(type(c)(c.file_id,
                                          offset + c.offset, c.size,
                                          c.e_tag, c.mtime_ns))
                offset += total_size(p.chunks)
                etags += bytes.fromhex(p.extended.get("etag", ""))
            final_path = f"{self._bucket_path(bucket)}/{key}"
            mp_state = self._versioning_state(bucket)
            # the assembled object is a new version: bucket-default
            # retention applies here too, or multipart becomes a
            # retention-policy bypass
            lock_ext = self._lock_for_put(req, bucket, mp_state)
            if not isinstance(lock_ext, dict):
                return lock_ext
            with self._path_lock(final_path):
                vid = self._pre_write_archive(final_path, mp_state)
                final = Entry(final_path, chunks=chunks)
                final_etag = (hashlib.md5(etags).hexdigest() +
                              f"-{len(parts)}")
                final.extended["etag"] = final_etag
                if sse_parts:
                    import json as _json
                    final.extended["sseParts"] = \
                        _json.dumps(sse_parts)
                    for k in ("sseKeyMd5", "sseAlgorithm",
                              "sseKmsKeyId", "sseKmsBlob"):
                        if marker.extended.get(k):
                            final.extended[k] = marker.extended[k]
                final.extended.update(lock_ext)
                if vid is not None:
                    final.extended["versionId"] = vid
                self.filer.create_entry(final)
            self.filer.delete_entry(updir, recursive=True,
                                    delete_chunks=False)
            root = ET.Element("CompleteMultipartUploadResult",
                              xmlns=S3_NS)
            _elem(root, "Bucket", bucket)
            _elem(root, "Key", key)
            _elem(root, "ETag", f'"{final_etag}"')
            resp = 200, (_xml(root), "application/xml")
            return _with_headers(resp, {"x-amz-version-id": vid}) \
                if vid else resp
        return _error(405, "MethodNotAllowed", req.method)
