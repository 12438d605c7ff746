"""SSH transport layer (RFC 4253) + curve25519-sha256 kex (RFC 8731),
usable in both server and client roles (the port's copy of
`seaweedfs_tpu/sftp/transport.py`).

The reference's server gets this from golang.org/x/crypto/ssh
(sftpd/sftp_service.go handleSSHConnection); the from-scratch analog
here negotiates exactly one suite:

    kex        curve25519-sha256          (RFC 8731)
    host key   ssh-ed25519                (RFC 8709)
    cipher     aes128-ctr                 (RFC 4344)
    mac        hmac-sha2-256              (RFC 6668)
    compression none

Rekeying (RFC 4253 §9) is not implemented: connections are expected to
move well under the 2**32-packet / 1 GB-per-key guidance for gateway
sessions; a peer-initiated KEXINIT raises and drops the connection
rather than silently continuing on stale keys.
"""

from __future__ import annotations

import hashlib
import os

from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey, Ed25519PublicKey)
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey, X25519PublicKey)
from cryptography.hazmat.primitives import serialization

from .ssh_wire import (PacketStream, Reader, derive_key, mpint, name_list,
                       ssh_string, u32, u8)

# RFC 4253 §12 message numbers
MSG_DISCONNECT = 1
MSG_IGNORE = 2
MSG_UNIMPLEMENTED = 3
MSG_DEBUG = 4
MSG_SERVICE_REQUEST = 5
MSG_SERVICE_ACCEPT = 6
MSG_KEXINIT = 20
MSG_NEWKEYS = 21
MSG_KEX_ECDH_INIT = 30
MSG_KEX_ECDH_REPLY = 31

KEX_ALGOS = ["curve25519-sha256", "curve25519-sha256@libssh.org"]
HOSTKEY_ALGOS = ["ssh-ed25519"]
CIPHERS = ["aes128-ctr"]
MACS = ["hmac-sha2-256"]
COMPRESSION = ["none"]

VERSION = "SSH-2.0-SeaweedFSTPU_1.0"


def ed25519_blob(pub: Ed25519PublicKey) -> bytes:
    raw = pub.public_bytes(serialization.Encoding.Raw,
                           serialization.PublicFormat.Raw)
    return ssh_string("ssh-ed25519") + ssh_string(raw)


def ed25519_from_blob(blob: bytes) -> Ed25519PublicKey:
    r = Reader(blob)
    alg = r.text()
    if alg != "ssh-ed25519":
        raise ValueError(f"unsupported host key algorithm {alg}")
    return Ed25519PublicKey.from_public_bytes(r.string())


class SshError(ConnectionError):
    pass


class Transport:
    """One SSH connection after key exchange: encrypted packet IO plus
    the negotiated session_id (needed by publickey userauth)."""

    def __init__(self, sock, server: bool,
                 host_key: Ed25519PrivateKey | None = None,
                 expected_host_key: bytes | None = None):
        """Server role needs `host_key`; client role may pin the
        server's raw ed25519 public key via `expected_host_key`
        (trust-on-first-use when None — the reference's client side,
        pkg/sftp tests, does the same with InsecureIgnoreHostKey)."""
        self.stream = PacketStream(sock)
        self.server = server
        self.host_key = host_key
        self.expected_host_key = expected_host_key
        self.session_id = b""
        self.peer_version = ""
        self._kex()

    # -- key exchange ------------------------------------------------------

    def _kexinit_payload(self) -> bytes:
        return (u8(MSG_KEXINIT) + os.urandom(16) +
                name_list(KEX_ALGOS) + name_list(HOSTKEY_ALGOS) +
                name_list(CIPHERS) + name_list(CIPHERS) +
                name_list(MACS) + name_list(MACS) +
                name_list(COMPRESSION) + name_list(COMPRESSION) +
                name_list([]) + name_list([]) +
                b"\x00" + b"\x00\x00\x00\x00")

    @staticmethod
    def _check_negotiation(peer_kexinit: bytes) -> None:
        """RFC 4253 §7.1: first match of the client list present in the
        server list.  With single-algorithm lists, membership suffices."""
        r = Reader(peer_kexinit)
        r.u8()
        r._take(16)
        offered = [r.name_list() for _ in range(8)]
        for ours, name in ((KEX_ALGOS, "kex"), (HOSTKEY_ALGOS, "hostkey"),
                           (CIPHERS, "cipher c2s"), (CIPHERS, "cipher s2c"),
                           (MACS, "mac c2s"), (MACS, "mac s2c"),
                           (COMPRESSION, "compression c2s"),
                           (COMPRESSION, "compression s2c")):
            peer = offered.pop(0)
            if not any(a in peer for a in ours):
                raise SshError(f"no common {name} algorithm: peer offers "
                               f"{peer}")

    def _kex(self) -> None:
        st = self.stream
        st.write_version_line(VERSION)
        self.peer_version = st.read_version_line()
        if not self.peer_version.startswith("SSH-2.0-"):
            raise SshError(f"unsupported peer {self.peer_version}")

        my_kexinit = self._kexinit_payload()
        st.send(my_kexinit)
        peer_kexinit = st.recv()
        if peer_kexinit[0] != MSG_KEXINIT:
            raise SshError("expected KEXINIT")
        self._check_negotiation(peer_kexinit)

        eph = X25519PrivateKey.generate()
        q_mine = eph.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)

        if self.server:
            i_c, i_s = peer_kexinit, my_kexinit
            v_c, v_s = self.peer_version, VERSION
            pkt = st.recv()
            r = Reader(pkt)
            if r.u8() != MSG_KEX_ECDH_INIT:
                raise SshError("expected KEX_ECDH_INIT")
            q_c = r.string()
            q_s = q_mine
            shared = eph.exchange(X25519PublicKey.from_public_bytes(q_c))
            k_s = ed25519_blob(self.host_key.public_key())
            h = self._exchange_hash(v_c, v_s, i_c, i_s, k_s, q_c, q_s,
                                    shared)
            sig = (ssh_string("ssh-ed25519") +
                   ssh_string(self.host_key.sign(h)))
            st.send(u8(MSG_KEX_ECDH_REPLY) + ssh_string(k_s) +
                    ssh_string(q_s) + ssh_string(sig))
        else:
            i_c, i_s = my_kexinit, peer_kexinit
            v_c, v_s = VERSION, self.peer_version
            st.send(u8(MSG_KEX_ECDH_INIT) + ssh_string(q_mine))
            r = Reader(st.recv())
            if r.u8() != MSG_KEX_ECDH_REPLY:
                raise SshError("expected KEX_ECDH_REPLY")
            k_s, q_s, sig_blob = r.string(), r.string(), r.string()
            q_c = q_mine
            shared = eph.exchange(X25519PublicKey.from_public_bytes(q_s))
            h = self._exchange_hash(v_c, v_s, i_c, i_s, k_s, q_c, q_s,
                                    shared)
            host_pub = ed25519_from_blob(k_s)
            sr = Reader(sig_blob)
            if sr.text() != "ssh-ed25519":
                raise SshError("unexpected signature algorithm")
            host_pub.verify(sr.string(), h)   # raises InvalidSignature
            if self.expected_host_key is not None:
                raw = host_pub.public_bytes(
                    serialization.Encoding.Raw,
                    serialization.PublicFormat.Raw)
                if raw != self.expected_host_key:
                    raise SshError("server host key mismatch")

        self.session_id = h
        self.host_key_blob = k_s

        # RFC 8731 §3: K is the X25519 output interpreted as an integer
        k_mpint = mpint(int.from_bytes(shared, "big"))
        st.send(u8(MSG_NEWKEYS))
        if st.recv() != u8(MSG_NEWKEYS):
            raise SshError("expected NEWKEYS")

        def dk(letter, n):
            return derive_key(hashlib.sha256, k_mpint, h, letter, h, n)

        iv_c2s, iv_s2c = dk(b"A", 16), dk(b"B", 16)
        key_c2s, key_s2c = dk(b"C", 16), dk(b"D", 16)
        mac_c2s, mac_s2c = dk(b"E", 32), dk(b"F", 32)
        if self.server:
            st.arm(key_s2c, iv_s2c, key_c2s, iv_c2s, mac_s2c, mac_c2s)
        else:
            st.arm(key_c2s, iv_c2s, key_s2c, iv_s2c, mac_c2s, mac_s2c)

    @staticmethod
    def _exchange_hash(v_c, v_s, i_c, i_s, k_s, q_c, q_s, shared) -> bytes:
        return hashlib.sha256(
            ssh_string(v_c) + ssh_string(v_s) +
            ssh_string(i_c) + ssh_string(i_s) +
            ssh_string(k_s) + ssh_string(q_c) + ssh_string(q_s) +
            mpint(int.from_bytes(shared, "big"))).digest()

    # -- post-kex IO -------------------------------------------------------

    def send(self, payload: bytes) -> None:
        self.stream.send(payload)

    def recv(self) -> bytes:
        """Next payload, with transport-generic messages handled here:
        IGNORE/DEBUG dropped, DISCONNECT surfaced, a mid-session
        KEXINIT (rekey request) rejected per the module policy."""
        while True:
            p = self.stream.recv()
            t = p[0]
            if t in (MSG_IGNORE, MSG_DEBUG):
                continue
            if t == MSG_DISCONNECT:
                r = Reader(p)
                r.u8()
                code = r.u32()
                raise SshError(f"peer disconnected ({code}): {r.text()}")
            if t == MSG_KEXINIT:
                raise SshError("peer requested rekey (unsupported)")
            return p

    def disconnect(self, code: int = 11, msg: str = "bye") -> None:
        """Best-effort SSH_MSG_DISCONNECT (code 11 = by-application)."""
        try:
            self.send(u8(MSG_DISCONNECT) + u32(code) + ssh_string(msg) +
                      ssh_string(""))
        except OSError:
            pass    # best-effort goodbye on a dying socket

    # -- service negotiation ----------------------------------------------

    def request_service(self, name: str) -> None:
        self.send(u8(MSG_SERVICE_REQUEST) + ssh_string(name))
        r = Reader(self.recv())
        if r.u8() != MSG_SERVICE_ACCEPT or r.text() != name:
            raise SshError(f"service {name} refused")

    def accept_service(self, allowed: str) -> None:
        r = Reader(self.recv())
        if r.u8() != MSG_SERVICE_REQUEST:
            raise SshError("expected SERVICE_REQUEST")
        name = r.text()
        if name != allowed:
            raise SshError(f"unsupported service {name}")
        self.send(u8(MSG_SERVICE_ACCEPT) + ssh_string(name))
