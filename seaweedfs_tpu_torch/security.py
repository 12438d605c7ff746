"""Security plane: HS256 JWTs for the data path, admin-plane auth, and
the process-global security configuration.

Mirrors weed/security/jwt.go:18 (GenJwtForVolumeServer: per-fid claims
signed by the master, verified by volume servers; separate write and
read keys with independent expiries) and weed/security/guard.go (Guard:
whitelist + JWT gate).  Like the reference — where security.toml is
loaded once into a process-global viper config
(util/config.go:34 LoadSecurityConfiguration) — the configuration here
is a module-level singleton that servers and the client SDK consult by
default; individual servers may override it for mixed-cluster tests.

JWT wire format is standard RFC 7519 HS256 (base64url(header).
base64url(claims).base64url(hmac-sha256)) so tokens interoperate with
any JWT tooling.

The port's copy of `seaweedfs_tpu/security.py`: tokens are byte for
byte the JAX package's, so either package's clients and servers accept
the other's.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import ipaddress
import json
import time
from dataclasses import dataclass, field

# the request fields that name files: one check, shared with the volume
# admin routes and the master's assign and grow front door
from .storage.types import check_path_fields  # noqa: F401


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


_HEADER = _b64url(json.dumps(
    {"alg": "HS256", "typ": "JWT"}, separators=(",", ":")).encode())


class JwtError(Exception):
    pass


def gen_jwt(key: str, claims: dict, expires_sec: int = 0) -> str:
    """Sign claims with HS256 (jwt.go GenJwtForVolumeServer shape:
    empty key -> empty token, exp only when expires_sec > 0)."""
    if not key:
        return ""
    claims = dict(claims)
    if expires_sec > 0:
        claims["exp"] = int(time.time()) + expires_sec
    payload = _b64url(json.dumps(claims, separators=(",", ":"),
                                 sort_keys=True).encode())
    signing_input = f"{_HEADER}.{payload}".encode()
    sig = hmac.new(key.encode(), signing_input, hashlib.sha256).digest()
    return f"{_HEADER}.{payload}.{_b64url(sig)}"


def decode_jwt(key: str, token: str) -> dict:
    """Verify signature + exp/nbf and return the claims
    (jwt.go DecodeJwt)."""
    parts = token.split(".")
    if len(parts) != 3:
        raise JwtError("malformed token")
    try:
        header = json.loads(_b64url_decode(parts[0]))
        claims = json.loads(_b64url_decode(parts[1]))
        sig = _b64url_decode(parts[2])
    except (ValueError, TypeError) as e:
        raise JwtError(f"undecodable token: {e}") from None
    if header.get("alg") != "HS256":
        raise JwtError("unknown token method")
    want = hmac.new(key.encode(), f"{parts[0]}.{parts[1]}".encode(),
                    hashlib.sha256).digest()
    if not hmac.compare_digest(sig, want):
        raise JwtError("bad signature")
    now = time.time()
    if "exp" in claims and now > float(claims["exp"]):
        raise JwtError("token expired")
    if "nbf" in claims and now < float(claims["nbf"]):
        raise JwtError("token not yet valid")
    return claims


def get_jwt(query: dict, headers: dict) -> str:
    """Extract a token from a request: ?jwt= then Authorization: Bearer
    (jwt.go GetJwt order; the cookie path is not mirrored — no browser
    UI on these servers)."""
    token = query.get("jwt", "")
    if not token:
        bearer = headers.get("Authorization", "")
        if bearer[:7].upper() == "BEARER ":
            token = bearer[7:]
    return token


@dataclass
class SecurityConfig:
    """The security.toml surface (command/scaffold/security.toml):
    [jwt.signing] gates volume writes, [jwt.signing.read] gates volume
    reads, admin_key gates the admin/maintenance plane (the guard's
    grpc/TLS role in this HTTP build), white_list bypasses all checks
    by source IP/CIDR."""

    volume_write_key: str = ""
    volume_write_expires_sec: int = 10
    volume_read_key: str = ""
    volume_read_expires_sec: int = 60
    admin_key: str = ""
    admin_expires_sec: int = 60
    white_list: list[str] = field(default_factory=list)
    # TLS/mTLS for the whole plane (weed/security/tls.go; [tls] in
    # security.toml).  When set, every HttpServer wraps its socket and
    # every client helper dials https with the cluster CA pinned.
    tls: "object | None" = None  # tls.TlsConfig

    # -- data-path tokens (per-fid claims, jwt.go SeaweedFileIdClaims) --

    def write_jwt(self, fid: str) -> str:
        return gen_jwt(self.volume_write_key, {"fid": fid},
                       self.volume_write_expires_sec)

    def read_jwt(self, fid: str) -> str:
        return gen_jwt(self.volume_read_key, {"fid": fid},
                       self.volume_read_expires_sec)

    def write_headers(self, fid: str) -> dict[str, str]:
        """Authorization header for a data-path write/delete on fid."""
        tok = self.write_jwt(fid)
        return {"Authorization": f"Bearer {tok}"} if tok else {}

    def check_fid_jwt(self, key: str, query: dict, headers: dict,
                      fid: str) -> str | None:
        """Returns an error string, or None when authorized."""
        if not key:
            return None
        token = get_jwt(query, headers)
        if not token:
            return "missing jwt"
        try:
            claims = decode_jwt(key, token)
        except JwtError as e:
            return str(e)
        # the claim restricts the token to one file id; an empty claim
        # fid is a wildcard the reference allows for chunked manifests
        if claims.get("fid", "") not in ("", fid):
            return f"jwt for {claims.get('fid')!r} used for {fid!r}"
        return None

    # -- admin plane -----------------------------------------------------

    def admin_jwt(self) -> str:
        return gen_jwt(self.admin_key, {"admin": True},
                       self.admin_expires_sec)

    def admin_headers(self) -> dict[str, str]:
        if not self.admin_key:
            return {}
        return {"Authorization": f"Bearer {self.admin_jwt()}"}

    def check_admin(self, query: dict, headers: dict,
                    remote_ip: str = "") -> str | None:
        """guard.go order: the whitelist is checked first; with a
        whitelist configured but no key, non-whitelisted IPs are
        REJECTED (the whitelist is a gate, not only a bypass)."""
        if not self.admin_key and not self.white_list:
            return None
        if self.white_list and remote_ip and \
                self.ip_whitelisted(remote_ip):
            return None
        if not self.admin_key:
            return f"ip {remote_ip} not in white list"
        token = get_jwt(query, headers)
        if not token:
            return "missing admin jwt"
        try:
            claims = decode_jwt(self.admin_key, token)
        except JwtError as e:
            return str(e)
        if not claims.get("admin"):
            return "not an admin token"
        return None

    # -- whitelist (guard.go checkWhiteList) ----------------------------

    def ip_whitelisted(self, ip: str) -> bool:
        if not self.white_list:
            return False
        for entry in self.white_list:
            if entry == ip:
                return True
            if "/" in entry:
                try:
                    if ipaddress.ip_address(ip) in \
                            ipaddress.ip_network(entry, strict=False):
                        return True
                except ValueError:
                    continue
        return False

    @property
    def enabled(self) -> bool:
        return bool(self.volume_write_key or self.volume_read_key or
                    self.admin_key or self.white_list)


# -- process-global config (util/config.go LoadSecurityConfiguration) ---

_config = SecurityConfig()


def configure(cfg: SecurityConfig | None) -> None:
    global _config
    _config = cfg or SecurityConfig()


def current() -> SecurityConfig:
    return _config


def load_security_toml(path: str) -> SecurityConfig:
    """Load the reference's security.toml layout
    (command/scaffold/security.toml: [jwt.signing].key,
    [jwt.signing.read].key, [access].white_list; admin_key is this
    build's HTTP analog of [grpc].ca-gated admin access)."""
    try:
        import tomllib
    except ModuleNotFoundError:      # py<3.11: the tomli backport
        import tomli as tomllib
    with open(path, "rb") as f:
        t = tomllib.load(f)
    jwt_t = t.get("jwt", {})
    signing = jwt_t.get("signing", {})
    read = signing.get("read", {})
    access = t.get("access", {})
    admin = t.get("admin", {})
    tls_t = t.get("tls", {})
    tls_cfg = None
    if tls_t:
        missing = [k for k in ("ca", "cert", "key")
                   if not tls_t.get(k)]
        if missing:
            # failing HERE names the security.toml key; failing later
            # would be an opaque OpenSSL error deep inside a request
            raise ValueError(
                f"security.toml [tls] requires ca/cert/key; "
                f"missing: {', '.join(missing)}")
        from .tls import TlsConfig
        tls_cfg = TlsConfig(
            ca_cert=tls_t["ca"],
            cert=tls_t["cert"],
            key=tls_t["key"],
            require_client_cert=bool(tls_t.get("mtls", False)))
    return SecurityConfig(
        tls=tls_cfg,
        volume_write_key=signing.get("key", ""),
        volume_write_expires_sec=int(
            signing.get("expires_after_seconds", 10)),
        volume_read_key=read.get("key", ""),
        volume_read_expires_sec=int(
            read.get("expires_after_seconds", 60)),
        # [admin] key is canonical; [access] admin_key is accepted
        # because an earlier scaffold template printed that spelling
        admin_key=admin.get("key", "") or access.get("admin_key", ""),
        admin_expires_sec=int(admin.get("expires_after_seconds", 60)),
        white_list=list(access.get("white_list", [])),
    )
