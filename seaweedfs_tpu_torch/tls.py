"""TLS/mTLS for the control+data plane (weed/security/tls.go).

The reference mutually authenticates its gRPC plane with certificates
from security.toml ([grpc] ca/cert/key sections).  This build wires
the same trust model through Python's ssl: every HttpServer wraps its
socket when a TlsConfig is active, and every client helper
(httpd.http_bytes / http_json — the single funnel all roles dial
through) switches to https with the cluster CA pinned.  With
require_client_cert (mTLS), servers accept only peers presenting a
certificate signed by the cluster CA.

`generate_cluster_certs` mints a self-contained PKI (CA + server +
client certs) with `cryptography` — the analog of the reference's
`weed scaffold` + openssl recipes.

The port's copy of `seaweedfs_tpu/tls.py`.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from dataclasses import dataclass


@dataclass
class TlsConfig:
    ca_cert: str            # PEM path: cluster CA certificate
    cert: str               # PEM path: this node's certificate chain
    key: str                # PEM path: this node's private key
    require_client_cert: bool = False  # mTLS (tls.go VerifyClientCert)

    def server_context(self) -> ssl.SSLContext:
        # cached: contexts are built once per config, not per request —
        # every heartbeat/read/raft RPC re-reading three PEM files and
        # forfeiting TLS session resumption would dominate latency
        ctx = self.__dict__.get("_server_ctx")
        if ctx is None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.cert, self.key)
            if self.require_client_cert:
                ctx.load_verify_locations(self.ca_cert)
                ctx.verify_mode = ssl.CERT_REQUIRED
            self.__dict__["_server_ctx"] = ctx
        return ctx

    def client_context(self) -> ssl.SSLContext:
        ctx = self.__dict__.get("_client_ctx")
        if ctx is None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.load_verify_locations(self.ca_cert)
            # cluster nodes address each other by IP:port; the SAN
            # carries the IPs, hostname verification stays on
            ctx.load_cert_chain(self.cert, self.key)
            self.__dict__["_client_ctx"] = ctx
        return ctx


def generate_cluster_certs(directory: str,
                           hosts: "list[str] | None" = None) -> dict:
    """Mint CA + node certificates; returns {"ca": ..., "cert": ...,
    "key": ...} paths.  One shared node cert serves both server and
    client roles (every role dials every other role)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    hosts = hosts or ["127.0.0.1", "localhost"]
    os.makedirs(directory, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)

    def _name(cn):
        return x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, cn)])

    def _write(path, data):
        with open(path, "wb") as f:
            f.write(data)
        return path

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_cert = (x509.CertificateBuilder()
               .subject_name(_name("seaweedfs-tpu CA"))
               .issuer_name(_name("seaweedfs-tpu CA"))
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now - datetime.timedelta(minutes=5))
               .not_valid_after(now + datetime.timedelta(days=3650))
               .add_extension(x509.BasicConstraints(ca=True,
                                                    path_length=0),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))

    node_key = ec.generate_private_key(ec.SECP256R1())
    san = []
    for h in hosts:
        try:
            san.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            san.append(x509.DNSName(h))
    node_cert = (x509.CertificateBuilder()
                 .subject_name(_name("seaweedfs-tpu node"))
                 .issuer_name(ca_cert.subject)
                 .public_key(node_key.public_key())
                 .serial_number(x509.random_serial_number())
                 .not_valid_before(now - datetime.timedelta(minutes=5))
                 .not_valid_after(now + datetime.timedelta(days=825))
                 .add_extension(x509.SubjectAlternativeName(san),
                                critical=False)
                 .add_extension(
                     x509.ExtendedKeyUsage(
                         [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH,
                          x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]),
                     critical=False)
                 .sign(ca_key, hashes.SHA256()))

    pem = serialization.Encoding.PEM
    paths = {
        "ca": _write(os.path.join(directory, "ca.crt"),
                     ca_cert.public_bytes(pem)),
        "cert": _write(os.path.join(directory, "node.crt"),
                       node_cert.public_bytes(pem)),
        "key": _write(
            os.path.join(directory, "node.key"),
            node_key.private_bytes(
                pem, serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption())),
    }
    os.chmod(paths["key"], 0o600)
    return paths
