"""SFTP service: TCP accept loop → SSH transport → userauth →
session channel → sftp subsystem (reference: weed/sftpd/sftp_server.go
+ sftp_service.go + auth/); the port's copy of
`seaweedfs_tpu/sftp/server.py`.

Auth mirrors auth/password.go and auth/publickey.go: password checks
against the user store; publickey first answers the signature-less
probe with PK_OK, then verifies an ed25519 signature over
session_id || userauth-request (RFC 4252 §7).
"""

from __future__ import annotations

import base64
import socket
import threading

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey, Ed25519PublicKey)
from cryptography.hazmat.primitives import serialization

from .handlers import SftpHandlers
from .ssh_wire import Reader, name_list, ssh_bool, ssh_string, u32, u8
from .transport import SshError, Transport
from .users import UserStore

# RFC 4252
MSG_USERAUTH_REQUEST = 50
MSG_USERAUTH_FAILURE = 51
MSG_USERAUTH_SUCCESS = 52
MSG_USERAUTH_BANNER = 53
MSG_USERAUTH_PK_OK = 60

# RFC 4254
MSG_CHANNEL_OPEN = 90
MSG_CHANNEL_OPEN_CONFIRMATION = 91
MSG_CHANNEL_OPEN_FAILURE = 92
MSG_CHANNEL_WINDOW_ADJUST = 93
MSG_CHANNEL_DATA = 94
MSG_CHANNEL_EOF = 96
MSG_CHANNEL_CLOSE = 97
MSG_CHANNEL_REQUEST = 98
MSG_CHANNEL_SUCCESS = 99
MSG_CHANNEL_FAILURE = 100

WINDOW = 1 << 22
MAX_PACKET = 1 << 15


class SftpService:
    """sftp_service.go SFTPService: options + user store + accept loop.
    `fs` is an in-process Filer or a FilerClient (weed sftp -filer)."""

    def __init__(self, fs, user_store: UserStore,
                 host_key: Ed25519PrivateKey | None = None,
                 port: int = 0, ip: str = "127.0.0.1",
                 auth_methods: tuple = ("password", "publickey"),
                 max_auth_tries: int = 6, banner: str = "",
                 ldap=None):
        self.fs = fs
        self.users = user_store
        # optional LDAP provider (iam/ldap.py): password auth consults
        # the directory when the local store has no such user — the
        # reference's ldap identity provider role (iam/ldap/
        # ldap_provider.go) applied to the sftp gateway
        self.ldap = ldap
        self.host_key = host_key or Ed25519PrivateKey.generate()
        self.port = port
        self.ip = ip
        self.auth_methods = list(auth_methods)
        self.max_auth_tries = max_auth_tries
        self.banner = banner
        self._sock = None
        self._threads: list[threading.Thread] = []
        self._stopping = False

    @property
    def host_public_raw(self) -> bytes:
        return self.host_key.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)

    def start(self) -> "SftpService":
        self._sock = socket.create_server((self.ip, self.port))
        self.port = self._sock.getsockname()[1]
        t = threading.Thread(target=self._accept_loop,
                             name="sftp-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stopping = True
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # daemon threads, deliberately untracked: appending every
            # connection's thread would leak one object per session
            # over the gateway's lifetime
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(60)
            # a 32 KiB DATA reply leaves as two channel packets; without
            # NODELAY the second waits for the peer's delayed ACK (~40 ms
            # a READ)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            tr = Transport(conn, server=True, host_key=self.host_key)
            tr.accept_service("ssh-userauth")
            user = self._authenticate(tr)
            if user is None:
                return
            _Session(tr, SftpHandlers(self.fs, user)).run()
        except (SshError, ConnectionError, ValueError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- userauth (RFC 4252; auth/password.go, auth/publickey.go) ---------

    def _authenticate(self, tr: Transport):
        if self.banner:
            tr.send(u8(MSG_USERAUTH_BANNER) + ssh_string(self.banner) +
                    ssh_string(""))
        tries = 0
        while tries < self.max_auth_tries:
            r = Reader(tr.recv())
            if r.u8() != MSG_USERAUTH_REQUEST:
                raise SshError("expected USERAUTH_REQUEST")
            username, service, method = r.text(), r.text(), r.text()
            if service != "ssh-connection":
                raise SshError(f"unsupported service {service}")
            user = self.users.get(username)
            ok = False
            if method == "none":
                # method discovery (RFC 4252 §5.2): answer with the
                # available list without burning a try
                tr.send(u8(MSG_USERAUTH_FAILURE) +
                        name_list(self.auth_methods) + ssh_bool(False))
                continue
            tries += 1
            if method == "password" and "password" in self.auth_methods:
                r.boolean()
                password = r.text()
                ok = user is not None and user.check_password(password)
                if not ok and user is None and self.ldap is not None:
                    # directory-backed users (iam/ldap.py): the bind
                    # IS the credential check on every login — nothing
                    # is written to the local user store, so the
                    # directory stays the source of truth and repeat
                    # logins re-bind.  An LDAP OUTAGE (LdapError or
                    # socket-level OSError) reads as auth failure, not
                    # a dropped session; the try still burns.
                    from ..iam.ldap import LdapError
                    try:
                        ident = self.ldap.authenticate(username,
                                                       password)
                    except (LdapError, OSError):
                        ident = None
                    if ident is not None:
                        from .users import User
                        user = User(username)  # session-scoped only
                        ok = True
            elif (method == "publickey" and
                  "publickey" in self.auth_methods):
                has_sig = r.boolean()
                alg = r.text()
                blob = r.string()
                known = (user is not None and alg == "ssh-ed25519" and
                         user.has_public_key(
                             alg, base64.b64encode(blob).decode()))
                if not has_sig:
                    # signature-less probe (RFC 4252 §7) — not a real
                    # attempt: clients cycling an agent's keys need
                    # probes free, or the matching key is never reached
                    tries -= 1
                    if known:
                        tr.send(u8(MSG_USERAUTH_PK_OK) +
                                ssh_string(alg) + ssh_string(blob))
                        continue
                    # fall through to FAILURE so the client moves on
                if known and has_sig:
                    sig = r.string()
                    sr = Reader(sig)
                    if sr.text() == "ssh-ed25519":
                        signed = (ssh_string(tr.session_id) +
                                  u8(MSG_USERAUTH_REQUEST) +
                                  ssh_string(username) +
                                  ssh_string(service) +
                                  ssh_string("publickey") +
                                  ssh_bool(True) + ssh_string(alg) +
                                  ssh_string(blob))
                        pub = Ed25519PublicKey.from_public_bytes(
                            _pub_raw_from_blob(blob))
                        try:
                            pub.verify(sr.string(), signed)
                            ok = True
                        except InvalidSignature:
                            ok = False
            if ok:
                tr.send(u8(MSG_USERAUTH_SUCCESS))
                return user
            tr.send(u8(MSG_USERAUTH_FAILURE) +
                    name_list(self.auth_methods) + ssh_bool(False))
        return None


def _pub_raw_from_blob(blob: bytes) -> bytes:
    r = Reader(blob)
    if r.text() != "ssh-ed25519":
        raise ValueError("not an ed25519 key blob")
    return r.string()


class _Session:
    """One authenticated connection's channel layer: a single session
    channel carrying the sftp subsystem (RFC 4254 §5-6)."""

    def __init__(self, tr: Transport, handlers: SftpHandlers):
        self.tr = tr
        self.handlers = handlers
        self.chan_peer = None
        self.peer_window = 0
        self.peer_max_packet = MAX_PACKET
        self.recv_window = WINDOW
        self._inbuf = b""

    def run(self) -> None:
        while True:
            r = Reader(self.tr.recv())
            t = r.u8()
            if t == MSG_CHANNEL_OPEN:
                self._open(r)
            elif t == MSG_CHANNEL_REQUEST:
                self._request(r)
            elif t == MSG_CHANNEL_DATA:
                r.u32()
                self._data(r.string())
            elif t == MSG_CHANNEL_WINDOW_ADJUST:
                r.u32()
                self.peer_window += r.u32()
            elif t in (MSG_CHANNEL_EOF, MSG_CHANNEL_CLOSE):
                if t == MSG_CHANNEL_CLOSE:
                    self.tr.send(u8(MSG_CHANNEL_CLOSE) + u32(
                        self.chan_peer or 0))
                    return
            else:
                raise SshError(f"unexpected channel message {t}")

    def _open(self, r: Reader) -> None:
        ctype = r.text()
        peer_id = r.u32()
        self.peer_window = r.u32()
        self.peer_max_packet = min(r.u32(), 1 << 20)
        if ctype != "session" or self.chan_peer is not None:
            self.tr.send(u8(MSG_CHANNEL_OPEN_FAILURE) + u32(peer_id) +
                         u32(1) + ssh_string("only one session") +
                         ssh_string(""))
            return
        self.chan_peer = peer_id
        self.tr.send(u8(MSG_CHANNEL_OPEN_CONFIRMATION) + u32(peer_id) +
                     u32(0) + u32(WINDOW) + u32(MAX_PACKET))

    def _request(self, r: Reader) -> None:
        r.u32()
        rtype = r.text()
        want_reply = r.boolean()
        ok = rtype == "subsystem" and r.text() == "sftp"
        if want_reply:
            self.tr.send(u8(MSG_CHANNEL_SUCCESS if ok else
                            MSG_CHANNEL_FAILURE) +
                         u32(self.chan_peer))

    def _data(self, data: bytes) -> None:
        self.recv_window -= len(data)
        if self.recv_window < WINDOW // 2:
            grow = WINDOW - self.recv_window
            self.tr.send(u8(MSG_CHANNEL_WINDOW_ADJUST) +
                         u32(self.chan_peer) + u32(grow))
            self.recv_window += grow
        self._inbuf += data
        # SFTP packets: uint32 length || body — may arrive split or
        # coalesced across CHANNEL_DATA boundaries
        while len(self._inbuf) >= 4:
            n = int.from_bytes(self._inbuf[:4], "big")
            if len(self._inbuf) < 4 + n:
                break
            body, self._inbuf = self._inbuf[4:4 + n], self._inbuf[4 + n:]
            resp = self.handlers.handle(body)
            self._send_sftp(resp)

    def _send_sftp(self, resp: bytes) -> None:
        out = u32(len(resp)) + resp
        # respect the peer's max packet; window handling is lenient on
        # the server side (our responses are small except DATA, and the
        # client grows its window aggressively)
        step = max(1024, self.peer_max_packet - 16)
        for i in range(0, len(out), step):
            self.tr.send(u8(MSG_CHANNEL_DATA) + u32(self.chan_peer) +
                         ssh_string(out[i:i + step]))
