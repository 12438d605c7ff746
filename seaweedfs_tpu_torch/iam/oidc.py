"""OIDC identity provider, the port's copy of `seaweedfs_tpu/iam/oidc.py`
(reference: weed/iam/oidc/oidc_provider.go + providers/provider.go).

Validates OIDC ID tokens (JWTs) against a configured issuer,
audience, and key set — RS256 with PEM public keys or HS256 with a
shared secret (the reference fetches JWKS over HTTP; this image has
zero egress, so keys are provisioned in the provider config, which
its mock/test providers do too).  A validated token becomes an
ExternalIdentity that STS trust policies can admit via
AssumeRoleWithWebIdentity."""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import json
import time


class OidcError(Exception):
    pass


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class ExternalIdentity:
    """providers/provider.go ExternalIdentity."""

    def __init__(self, provider: str, sub: str, email: str = "",
                 groups: "list[str] | None" = None,
                 claims: "dict | None" = None):
        self.provider = provider
        self.sub = sub
        self.email = email
        self.groups = groups or []
        self.claims = claims or {}

    @property
    def principal(self) -> str:
        """The trust-policy name: oidc:<provider>#<sub>."""
        return f"oidc:{self.provider}#{self.sub}"


class OidcProvider:
    def __init__(self, name: str, issuer: str, audience: str = "",
                 rsa_public_keys_pem: "list[bytes] | None" = None,
                 hs256_secret: str = ""):
        self.name = name
        self.issuer = issuer
        self.audience = audience
        self.hs256_secret = hs256_secret
        self._rsa_keys = []
        for pem in rsa_public_keys_pem or []:
            from cryptography.hazmat.primitives import serialization
            self._rsa_keys.append(
                serialization.load_pem_public_key(pem))

    # -- token validation (oidc_provider.go ValidateToken) ----------------

    def validate(self, token: str) -> ExternalIdentity:
        parts = token.split(".")
        if len(parts) != 3:
            raise OidcError("malformed id token")
        try:
            header = json.loads(_b64url_decode(parts[0]))
            claims = json.loads(_b64url_decode(parts[1]))
            sig = _b64url_decode(parts[2])
        except (ValueError, TypeError):
            raise OidcError("undecodable id token")
        if not isinstance(header, dict) or \
                not isinstance(claims, dict):
            # valid JSON that is not an object (e.g. "[1]") must be a
            # 403-class rejection, not an AttributeError-500
            raise OidcError("undecodable id token")
        signing_input = f"{parts[0]}.{parts[1]}".encode()
        alg = header.get("alg", "")
        if alg == "RS256":
            self._verify_rs256(signing_input, sig)
        elif alg == "HS256" and self.hs256_secret:
            want = hmac_mod.new(self.hs256_secret.encode(),
                                signing_input,
                                hashlib.sha256).digest()
            if not hmac_mod.compare_digest(want, sig):
                raise OidcError("bad token signature")
        else:
            raise OidcError(f"unsupported token alg {alg!r}")
        # issuer / audience / expiry (oidc_provider.go claim checks)
        if claims.get("iss") != self.issuer:
            raise OidcError(
                f"issuer mismatch: {claims.get('iss')!r}")
        if self.audience:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise OidcError("audience mismatch")
        now = time.time()
        try:
            exp = float(claims["exp"])   # exp is REQUIRED (OIDC core)
        except KeyError:
            raise OidcError("id token carries no exp")
        except (TypeError, ValueError):
            raise OidcError("id token exp undecodable")
        if now > exp:
            raise OidcError("id token expired")
        if "nbf" in claims:
            try:
                if now < float(claims["nbf"]):
                    raise OidcError("id token not yet valid")
            except (TypeError, ValueError):
                raise OidcError("id token nbf undecodable")
        sub = claims.get("sub", "")
        if not sub:
            raise OidcError("id token carries no sub")
        groups = claims.get("groups", [])
        if not isinstance(groups, list):
            groups = [str(groups)] if groups else []
        return ExternalIdentity(
            self.name, str(sub), str(claims.get("email", "") or ""),
            [str(g) for g in groups], claims)

    def _verify_rs256(self, signing_input: bytes,
                      sig: bytes) -> None:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding
        if not self._rsa_keys:
            raise OidcError("no RS256 keys configured")
        for key in self._rsa_keys:
            try:
                key.verify(sig, signing_input, padding.PKCS1v15(),
                           hashes.SHA256())
                return
            except InvalidSignature:
                continue
        raise OidcError("bad token signature")


def mint_test_token(claims: dict, hs256_secret: str = "",
                    rsa_private_key=None) -> str:
    """Token minting for tests/tools (the reference ships
    oidc/mock_provider.go for the same reason)."""
    alg = "HS256" if hs256_secret else "RS256"
    header = base64.urlsafe_b64encode(json.dumps(
        {"alg": alg, "typ": "JWT"}).encode()).rstrip(b"=")
    payload = base64.urlsafe_b64encode(json.dumps(
        claims, sort_keys=True).encode()).rstrip(b"=")
    signing_input = header + b"." + payload
    if hs256_secret:
        sig = hmac_mod.new(hs256_secret.encode(), signing_input,
                           hashlib.sha256).digest()
    else:
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding
        sig = rsa_private_key.sign(signing_input, padding.PKCS1v15(),
                                   hashes.SHA256())
    return (signing_input + b"." +
            base64.urlsafe_b64encode(sig).rstrip(b"=")).decode()
