"""AWS Signature V4 signing + verification
(weed/s3api/auth_signature_v4.go).

Implements the standard SigV4 flow: canonical request -> string to sign
-> derived signing key -> HMAC signature.  The same primitives serve
both the server-side verifier and the client-side signer used by tests
and tools (the cross-checking the reference gets from s3tests).

The port's copy of `seaweedfs_tpu/s3/auth.py`: a request signed with
an STS session's temporary key is verified against the secret that
`iam/sts.StsService` derives from its `x-amz-security-token`.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from datetime import datetime, timezone

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def canonical_request(method: str, canonical_uri: str, query: dict,
                      headers: dict, signed_headers: list[str],
                      payload_hash: str) -> str:
    """canonical_uri must be the WIRE form of the path (already
    percent-encoded once) — re-encoding here would double-encode keys
    with spaces/unicode and break verification for real clients."""
    cq = "&".join(
        f"{uri_encode(k)}={uri_encode(str(v))}"
        for k, v in sorted(query.items()))
    ch = "".join(
        f"{h}:{' '.join(str(headers.get(h, '')).split())}\n"
        for h in signed_headers)
    return "\n".join([
        method,
        canonical_uri or "/",
        cq,
        ch,
        ";".join(signed_headers),
        payload_hash,
    ])


def signing_key(secret: str, date: str, region: str,
                service: str = "s3") -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = hmac.new(k, region.encode(), hashlib.sha256).digest()
    k = hmac.new(k, service.encode(), hashlib.sha256).digest()
    return hmac.new(k, b"aws4_request", hashlib.sha256).digest()


def string_to_sign(amz_date: str, scope: str, creq: str) -> str:
    return "\n".join([ALGORITHM, amz_date, scope, _sha256(creq.encode())])


def sign_request(method: str, host: str, path: str, query: dict,
                 headers: dict, payload: bytes, access_key: str,
                 secret_key: str, region: str = "us-east-1",
                 amz_date: str | None = None,
                 service: str = "s3") -> dict:
    """Client-side signer: returns headers with Authorization added.
    `path` is the raw (unencoded) path; the request must be sent to
    its once-encoded form (`uri_encode(path, False)`)."""
    if amz_date is None:
        amz_date = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    payload_hash = _sha256(payload)
    headers = {k.lower(): v for k, v in headers.items()}
    headers.setdefault("host", host)
    headers["x-amz-date"] = amz_date
    headers["x-amz-content-sha256"] = payload_hash
    signed = sorted(h for h in headers
                    if h in ("host", "content-type") or
                    h.startswith("x-amz-"))
    creq = canonical_request(method, uri_encode(path, False), query,
                             headers, signed, payload_hash)
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = string_to_sign(amz_date, scope, creq)
    sig = hmac.new(signing_key(secret_key, date, region, service),
                   sts.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"


def presign_url(method: str, host: str, path: str, query: dict,
                access_key: str, secret_key: str, expires: int = 3600,
                region: str = "us-east-1",
                amz_date: str | None = None) -> str:
    """Client-side presigner (the URL form of SigV4 — what
    `aws s3 presign` emits; verified by s3api auth query-string path).
    Returns the full URL (without scheme)."""
    if amz_date is None:
        amz_date = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    q = dict(query)
    q.update({
        "X-Amz-Algorithm": ALGORITHM,
        "X-Amz-Credential": f"{access_key}/{scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    })
    creq = canonical_request(method, uri_encode(path, False), q,
                             {"host": host}, ["host"],
                             UNSIGNED_PAYLOAD)
    sts = string_to_sign(amz_date, scope, creq)
    sig = hmac.new(signing_key(secret_key, date, region),
                   sts.encode(), hashlib.sha256).hexdigest()
    q["X-Amz-Signature"] = sig
    qs = "&".join(f"{uri_encode(k)}={uri_encode(v)}"
                  for k, v in sorted(q.items()))
    return f"{host}{uri_encode(path, False)}?{qs}"


def chunk_string_to_sign(prev_signature: str, amz_date: str, scope: str,
                         chunk_data: bytes) -> str:
    """Per-chunk string-to-sign of the streaming-chunked upload format
    (s3api/chunked_reader_v4.go buildChunkStringToSign)."""
    return "\n".join([
        "AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev_signature,
        _sha256(b""), _sha256(chunk_data)])


class AuthContext:
    """What a successful header-auth verification learned — the seed
    the streaming-chunked body verifier needs
    (chunked_reader_v4.go newSignV4ChunkedReader)."""

    def __init__(self, identity: str, seed_signature: str,
                 signing_key: bytes, amz_date: str, scope: str,
                 payload_hash: str, sts_identity=None):
        self.identity = identity
        self.seed_signature = seed_signature
        self.signing_key = signing_key
        self.amz_date = amz_date
        self.scope = scope
        self.payload_hash = payload_hash
        # ephemeral iam.Identity resolved from an STS session token —
        # authorization must use its role actions, not a store lookup
        self.sts_identity = sts_identity

    @property
    def is_streaming(self) -> bool:
        return self.payload_hash == STREAMING_PAYLOAD


class SigV4Verifier:
    """Server-side verification (auth_signature_v4.go doesSignatureMatch
    + the reference's 15-minute request-time window).  Handles both
    header auth (Authorization) and query auth (presigned URLs,
    auth_signature_v4.go doesPresignedSignatureMatch)."""

    MAX_SKEW_SECONDS = 15 * 60

    def __init__(self, credentials, sts=None):
        # anything with .get(access_key) -> secret: a plain dict or an
        # IdentityStore.secrets_view()
        self.credentials = credentials
        self.sts = sts  # optional iam.StsService for temp credentials

    def _lookup_secret(self, access_key: str, token: str
                       ) -> "tuple[str | None, object | None]":
        """(secret, sts_identity): static store first, then STS
        session-token resolution (s3api auth: x-amz-security-token)."""
        secret = self.credentials.get(access_key)
        if secret is not None:
            return secret, None
        if self.sts is not None and token:
            resolved = self.sts.resolve(access_key, token)
            if resolved is not None:
                return resolved
        return None, None

    def verify(self, method: str, path: str, query: dict,
               headers: dict, payload: bytes
               ) -> "tuple[bool, str, AuthContext | None]":
        """Returns (ok, identity-or-error, context).  `path` is the
        wire form (still percent-encoded) — used verbatim as the
        canonical URI.  Query-auth (presigned) requests are routed by
        the presence of X-Amz-Signature in the query."""
        if "X-Amz-Signature" in query:
            ok, who, sts_ident = self._verify_presigned(
                method, path, query, headers)
            ctx = AuthContext(who, "", b"", "", "", UNSIGNED_PAYLOAD,
                              sts_identity=sts_ident) if ok else None
            return ok, who, ctx
        auth = headers.get("authorization", "")
        if not auth.startswith(ALGORITHM):
            return False, "unsupported authorization", None
        try:
            parts = dict(
                p.strip().split("=", 1)
                for p in auth[len(ALGORITHM):].strip().split(","))
            cred = parts["Credential"]
            signed = parts["SignedHeaders"].split(";")
            got_sig = parts["Signature"]
            access_key, date, region, service, _ = cred.split("/")
        except (KeyError, ValueError):
            return False, "malformed authorization header", None
        secret, sts_ident = self._lookup_secret(
            access_key, headers.get("x-amz-security-token", ""))
        if secret is None:
            return False, "unknown access key", None
        amz_date = headers.get("x-amz-date", "")
        skew_err = self._check_date(amz_date, date)
        if skew_err:
            return False, skew_err, None
        payload_hash = headers.get("x-amz-content-sha256") or \
            UNSIGNED_PAYLOAD
        if payload_hash not in (UNSIGNED_PAYLOAD, STREAMING_PAYLOAD):
            if payload_hash != _sha256(payload):
                return False, "payload checksum mismatch", None
        creq = canonical_request(
            method, path, query,
            {k.lower(): v for k, v in headers.items()}, signed,
            payload_hash)
        scope = f"{date}/{region}/{service}/aws4_request"
        sts = string_to_sign(amz_date, scope, creq)
        key = signing_key(secret, date, region, service)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, got_sig):
            return False, "signature mismatch", None
        return True, access_key, AuthContext(
            access_key, got_sig, key, amz_date, scope, payload_hash,
            sts_identity=sts_ident)

    def _verify_presigned(self, method: str, path: str, query: dict,
                          headers: dict
                          ) -> "tuple[bool, str, object | None]":
        try:
            if query.get("X-Amz-Algorithm") != ALGORITHM:
                return False, "unsupported algorithm", None
            cred = query["X-Amz-Credential"]
            amz_date = query["X-Amz-Date"]
            expires = int(query["X-Amz-Expires"])
            signed = query["X-Amz-SignedHeaders"].split(";")
            got_sig = query["X-Amz-Signature"]
            access_key, date, region, service, _ = cred.split("/")
        except (KeyError, ValueError):
            return False, "malformed presigned query", None
        secret, sts_ident = self._lookup_secret(
            access_key, query.get("X-Amz-Security-Token", ""))
        if secret is None:
            return False, "unknown access key", None
        # expiry: valid from X-Amz-Date for X-Amz-Expires seconds
        # (and Expires itself is capped at 7 days, as AWS does)
        if not 0 < expires <= 7 * 24 * 3600:
            return False, "invalid X-Amz-Expires", None
        try:
            t0 = datetime.strptime(
                amz_date, "%Y%m%dT%H%M%SZ").replace(tzinfo=timezone.utc)
        except ValueError:
            return False, "malformed X-Amz-Date", None
        if amz_date[:8] != date:
            return False, "credential scope date mismatch", None
        now = datetime.now(timezone.utc)
        if (now - t0).total_seconds() > expires:
            return False, "request has expired", None
        if (t0 - now).total_seconds() > self.MAX_SKEW_SECONDS:
            return False, "request time too skewed", None
        # canonical query = all X-Amz-* params EXCEPT the signature
        q = {k: v for k, v in query.items() if k != "X-Amz-Signature"}
        creq = canonical_request(
            method, path, q,
            {k.lower(): v for k, v in headers.items()}, signed,
            UNSIGNED_PAYLOAD)
        scope = f"{date}/{region}/{service}/aws4_request"
        sts = string_to_sign(amz_date, scope, creq)
        want = hmac.new(signing_key(secret, date, region, service),
                        sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, got_sig):
            return False, "signature mismatch", None
        return True, access_key, sts_ident

    def _check_date(self, amz_date: str, scope_date: str) -> str | None:
        """Replay window: x-amz-date within 15 minutes of now and
        consistent with the credential scope date."""
        try:
            req_time = datetime.strptime(
                amz_date, "%Y%m%dT%H%M%SZ").replace(tzinfo=timezone.utc)
        except ValueError:
            return "malformed x-amz-date"
        if amz_date[:8] != scope_date:
            return "credential scope date mismatch"
        now = datetime.now(timezone.utc)
        if abs((now - req_time).total_seconds()) > self.MAX_SKEW_SECONDS:
            return "request time too skewed"
        return None
