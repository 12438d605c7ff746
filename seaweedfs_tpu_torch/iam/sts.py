"""Stateless STS, the port's copy of `seaweedfs_tpu/iam/sts.py`
(reference: weed/iam/sts/sts_service.go, token_utils.go).

The reference's design point — kept here — is that NO session state is
stored anywhere: the session token is a signed JWT carrying the whole
session (principal, role, expiry), and the temporary SECRET key is
derived deterministically from the session id with the STS signing
key.  Any gateway holding the signing key can therefore verify a
SigV4 request made with temporary credentials: it reads the session
token from x-amz-security-token, validates the JWT, re-derives the
secret, and runs normal SigV4 verification.

Roles live in a small JSON store (iam/integration/role_store.go):
name -> {actions, trust: [identity names or * patterns]}.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import threading
import time

from ..security import JwtError, decode_jwt, gen_jwt
from .identity import Identity

ACCESS_KEY_PREFIX = "STS"          # temp keys are recognizable by shape
DEFAULT_DURATION = 3600
MAX_DURATION = 12 * 3600


class StsError(Exception):
    pass


class RoleStore:
    """iam/integration/role_store.go: role name -> definition."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._roles: dict[str, dict] = {}
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            with open(path) as f:
                self._roles = json.load(f)

    def put(self, name: str, actions: list[str],
            trust: list[str] | None = None) -> None:
        with self._lock:
            self._roles[name] = {"actions": actions,
                                 "trust": trust or ["*"]}
            self._save()

    def get(self, name: str) -> dict | None:
        return self._roles.get(name)

    def delete(self, name: str) -> None:
        with self._lock:
            self._roles.pop(name, None)
            self._save()

    def _save(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._roles, f, indent=1)
        os.replace(tmp, self.path)

    def __iter__(self):
        return iter(self._roles.items())


class StsService:
    """Mint and verify temporary credentials."""

    def __init__(self, signing_key: str, roles: RoleStore | None = None,
                 issuer: str = "seaweedfs-sts"):
        if not signing_key:
            raise ValueError("sts requires a signing key")
        self.signing_key = signing_key
        self.roles = roles or RoleStore()
        self.issuer = issuer
        self.providers: dict[str, object] = {}  # OIDC by name

    def add_provider(self, provider) -> None:
        """Register an identity provider (iam/oidc.OidcProvider) for
        AssumeRoleWithWebIdentity."""
        self.providers[provider.name] = provider

    # -- minting -----------------------------------------------------------

    def assume_role(self, caller: Identity, role_name: str,
                    session_name: str = "session",
                    duration: int = DEFAULT_DURATION,
                    external: bool = False) -> dict:
        """sts_service.go AssumeRoleWithCredentials: the caller must be
        trusted by the role; returns AWS-shaped Credentials.

        `external` marks federated (web-identity) callers: they are
        admitted ONLY by trust entries that explicitly name the
        federation namespace ("oidc:..."), never by a bare "*" — the
        wildcard predates federation and means "any AUTHENTICATED
        LOCAL identity"; letting any IdP token satisfy it would be a
        silent privilege escalation."""
        role = self.roles.get(role_name)
        if role is None:
            raise StsError(f"no such role {role_name}")
        import fnmatch
        trust = role.get("trust", [])
        if external:
            trust = [p for p in trust if p.startswith("oidc:")]
        if not any(fnmatch.fnmatchcase(caller.name, pat)
                   for pat in trust):
            raise StsError(
                f"identity {caller.name} not trusted by {role_name}")
        duration = max(900, min(int(duration), MAX_DURATION))
        session_id = secrets.token_hex(8)
        access_key = f"{ACCESS_KEY_PREFIX}{session_id}"
        now = int(time.time())
        token = gen_jwt(self.signing_key, {
            "iss": self.issuer,
            "sub": caller.name,
            "role": role_name,
            "sessionName": session_name,
            "accessKey": access_key,
            "actions": role["actions"],
            "principalArn": (f"arn:aws:sts:::assumed-role/"
                             f"{role_name}/{session_name}"),
            "iat": now,
        }, expires_sec=duration)
        return {
            "AccessKeyId": access_key,
            "SecretAccessKey": self._derive_secret(access_key),
            "SessionToken": token,
            "Expiration": now + duration,
        }

    def assume_role_with_web_identity(self, token: str,
                                      role_name: str,
                                      session_name: str = "web",
                                      duration: int = DEFAULT_DURATION
                                      ) -> dict:
        """sts_service.go:431 AssumeRoleWithWebIdentity: validate the
        OIDC id token against every registered provider; the role's
        trust list must admit the external principal
        (oidc:<provider>#<sub>, wildcards allowed)."""
        from .oidc import OidcError
        reasons = []
        for name, provider in self.providers.items():
            try:
                ext = provider.validate(token)
            except OidcError as e:
                reasons.append(f"{name}: {e}")
                continue
            caller = Identity(ext.principal, actions=[])
            return self.assume_role(caller, role_name,
                                    session_name, duration,
                                    external=True)
        raise StsError("web identity rejected: " + (
            "; ".join(reasons) or "no identity providers registered"))

    def _derive_secret(self, access_key: str) -> str:
        """token_utils.go: secret = KDF(signing key, access key) —
        deterministic, so verification needs no session store."""
        mac = hmac.new(self.signing_key.encode(),
                       b"sts-secret:" + access_key.encode(),
                       hashlib.sha256).digest()
        return base64.urlsafe_b64encode(mac).decode().rstrip("=")

    # -- verification (gateway side) --------------------------------------

    def resolve(self, access_key: str, session_token: str
                ) -> tuple[str, Identity] | None:
        """Validate the session token and return (secret, ephemeral
        Identity) — or None if the token is invalid, expired, or does
        not belong to `access_key`."""
        if not access_key.startswith(ACCESS_KEY_PREFIX) or \
                not session_token:
            return None
        try:
            claims = decode_jwt(self.signing_key, session_token)
        except JwtError:
            return None
        if claims.get("accessKey") != access_key or \
                claims.get("iss") != self.issuer:
            return None
        ident = Identity(
            f"{claims.get('sub', '?')}@{claims.get('role', '?')}",
            actions=list(claims.get("actions", [])),
            principal_arn=claims.get("principalArn", ""))
        return self._derive_secret(access_key), ident
