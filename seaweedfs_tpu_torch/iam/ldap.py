"""LDAP identity provider (weed/iam/ldap/ldap_provider.go), the port's
copy of `seaweedfs_tpu/iam/ldap.py`: the same BER on the wire, so either
package's client binds and searches against either package's server.

Authenticates users against an external LDAP v3 server by simple bind
and maps directory attributes onto an identity, the way the
reference's provider does with go-ldap: resolve the user's DN (direct
template or subtree search), bind with the supplied password, read the
mapped attributes.  No LDAP library exists in this environment, so the
wire protocol (RFC 4511 over BER) is implemented here directly —
exactly the subset the provider needs: BindRequest/Response,
SearchRequest (equality filter) / SearchResultEntry / Done, and
UnbindRequest.
"""

from __future__ import annotations

import socket
import threading

class LdapError(RuntimeError):
    pass


# -- BER (X.690) minimal codec -------------------------------------------


def ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def tlv(tag: int, body: bytes) -> bytes:
    return bytes([tag]) + ber_len(len(body)) + body


def ber_int(v: int, tag: int = 0x02) -> bytes:
    if v == 0:
        return tlv(tag, b"\x00")
    body = v.to_bytes((v.bit_length() // 8) + 1, "big")
    return tlv(tag, body)


def ber_str(s: "str | bytes", tag: int = 0x04) -> bytes:
    return tlv(tag, s.encode() if isinstance(s, str) else s)


def ber_seq(body: bytes, tag: int = 0x30) -> bytes:
    return tlv(tag, body)


class BerReader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def read_tlv(self) -> "tuple[int, bytes]":
        # malformed/truncated BER from a misbehaving peer must raise a
        # protocol error the callers handle (LdapError), never an
        # IndexError that kills the calling thread
        if self.pos + 2 > len(self.buf):
            raise LdapError("truncated BER element")
        tag = self.buf[self.pos]
        self.pos += 1
        first = self.buf[self.pos]
        self.pos += 1
        if first < 0x80:
            n = first
        else:
            k = first & 0x7F
            if self.pos + k > len(self.buf):
                raise LdapError("truncated BER length")
            n = int.from_bytes(self.buf[self.pos:self.pos + k], "big")
            self.pos += k
        if self.pos + n > len(self.buf):
            raise LdapError("BER length exceeds message")
        body = self.buf[self.pos:self.pos + n]
        self.pos += n
        return tag, body


MAX_MESSAGE = 1 << 20  # a bind/search reply is tiny; a peer claiming
# multi-MB (or GB) frames is hostile or not LDAP at all


def read_message(sock_file) -> "tuple[int, int, bytes]":
    """One LDAPMessage: returns (message_id, op_tag, op_body)."""
    head = sock_file.read(2)
    if len(head) < 2:
        raise OSError("ldap: connection closed")
    first = head[1]
    if first < 0x80:
        total = first
        prefix = b""
    else:
        k = first & 0x7F
        if k > 4:
            raise LdapError("ldap: absurd length-of-length")
        prefix = sock_file.read(k)
        total = int.from_bytes(prefix, "big")
    if total > MAX_MESSAGE:
        raise LdapError(f"ldap: message claims {total} bytes "
                        f"(cap {MAX_MESSAGE})")
    body = sock_file.read(total)
    if len(body) < total:
        raise OSError("ldap: short message")
    r = BerReader(body)
    tag, mid_body = r.read_tlv()
    mid = int.from_bytes(mid_body, "big") if mid_body else 0
    op_tag, op_body = r.read_tlv()
    return mid, op_tag, op_body


# -- client ---------------------------------------------------------------

class LdapClient:
    """One connection; bind/search/unbind (RFC 4511 subset).
    `use_tls` wraps the connection in TLS (ldaps) — simple binds carry
    the password in cleartext, so any non-loopback directory should be
    reached over TLS."""

    def __init__(self, host: str, port: int = 389,
                 timeout: float = 10.0, use_tls: bool = False,
                 tls_verify: bool = True):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        if use_tls:
            import ssl
            ctx = ssl.create_default_context()
            if not tls_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self.sock = ctx.wrap_socket(self.sock,
                                        server_hostname=host)
        self.f = self.sock.makefile("rb")
        self._mid = 0

    def close(self) -> None:
        try:
            self.sock.sendall(ber_seq(
                ber_int(self._mid + 1) + tlv(0x42, b"")))  # unbind
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def _send(self, op: bytes) -> int:
        self._mid += 1
        self.sock.sendall(ber_seq(ber_int(self._mid) + op))
        return self._mid

    def bind(self, dn: str, password: str) -> bool:
        """Simple bind; True on success, False on invalid
        credentials (resultCode 49); raises on anything else."""
        op = tlv(0x60, ber_int(3) + ber_str(dn) +
                 ber_str(password, tag=0x80))
        self._send(op)
        _mid, op_tag, body = read_message(self.f)
        if op_tag != 0x61:
            raise LdapError(f"unexpected bind reply tag {op_tag:#x}")
        r = BerReader(body)
        _t, code_b = r.read_tlv()
        code = int.from_bytes(code_b, "big") if code_b else 0
        if code == 0:
            return True
        if code == 49:  # invalidCredentials
            return False
        raise LdapError(f"bind failed: resultCode {code}")

    def search_one(self, base_dn: str, attr: str, value: str,
                   want_attrs: "list[str]"
                   ) -> "tuple[str, dict] | None":
        """Subtree search with an equality filter; returns
        (dn, {attr: [values]}) for the first entry, or None."""
        flt = tlv(0xA3, ber_str(attr) + ber_str(value))
        attrs = ber_seq(b"".join(ber_str(a) for a in want_attrs))
        op = tlv(0x63, ber_str(base_dn) +
                 ber_int(2, tag=0x0A) +      # scope wholeSubtree
                 ber_int(3, tag=0x0A) +      # derefAlways
                 ber_int(100) + ber_int(10) +  # size/time limits
                 tlv(0x01, b"\x00") +        # typesOnly FALSE
                 flt + attrs)
        self._send(op)
        found = None
        while True:
            _mid, op_tag, body = read_message(self.f)
            if op_tag == 0x64 and found is None:  # SearchResultEntry
                r = BerReader(body)
                _t, dn = r.read_tlv()
                attrs_out: dict = {}
                _t, attr_list = r.read_tlv()
                ar = BerReader(attr_list)
                while not ar.eof():
                    _t, one = ar.read_tlv()
                    er = BerReader(one)
                    _t, name = er.read_tlv()
                    _t, vals = er.read_tlv()
                    vr = BerReader(vals)
                    out = []
                    while not vr.eof():
                        _t, v = vr.read_tlv()
                        out.append(v.decode(errors="replace"))
                    attrs_out[name.decode()] = out
                found = (dn.decode(), attrs_out)
            elif op_tag == 0x65:  # SearchResultDone
                return found
            elif op_tag == 0x64:
                continue  # further entries: first wins
            else:
                raise LdapError(
                    f"unexpected search reply tag {op_tag:#x}")


class LdapProvider:
    """ldap_provider.go Authenticate: resolve DN, bind with the user's
    password, map attributes -> identity."""

    def __init__(self, host: str, port: int = 389,
                 base_dn: str = "",
                 user_dn_template: str = "",      # e.g. uid={},ou=...
                 bind_dn: str = "", bind_password: str = "",
                 user_attr: str = "uid",
                 attr_map: "dict[str, str] | None" = None,
                 use_tls: bool = False, tls_verify: bool = True):
        self.host, self.port = host, port
        self.use_tls = use_tls
        self.tls_verify = tls_verify
        self.base_dn = base_dn
        self.user_dn_template = user_dn_template
        self.bind_dn = bind_dn
        self.bind_password = bind_password
        self.user_attr = user_attr
        # identity field -> ldap attribute
        self.attr_map = attr_map or {"displayName": "cn",
                                     "email": "mail"}

    def authenticate(self, username: str, password: str
                     ) -> "dict | None":
        """None on bad credentials; raises LdapError on server
        problems (callers must not treat an outage as a rejection)."""
        if not password:
            return None  # RFC 4513: empty password would be an
            # unauthenticated bind that "succeeds"
        c = LdapClient(self.host, self.port, use_tls=self.use_tls,
                       tls_verify=self.tls_verify)
        try:
            if self.user_dn_template:
                dn = self.user_dn_template.replace("{}", username)
                attrs: dict = {}
            else:
                # service bind, then locate the user's entry
                if self.bind_dn and not c.bind(self.bind_dn,
                                               self.bind_password):
                    raise LdapError("service bind rejected")
                hit = c.search_one(self.base_dn, self.user_attr,
                                   username,
                                   list(self.attr_map.values()))
                if hit is None:
                    return None
                dn, attrs = hit
            if not c.bind(dn, password):
                return None
            ident = {"name": username, "dn": dn}
            for field, attr in self.attr_map.items():
                if attrs.get(attr):
                    ident[field] = attrs[attr][0]
            return ident
        finally:
            c.close()


# -- test/dev server ------------------------------------------------------

class MiniLdapServer:
    """A tiny LDAP v3 server for tests and air-gapped dev: a DN ->
    (password, attrs) table, simple bind + equality subtree search —
    enough to exercise every code path of the provider against a real
    socket (the role the reference's docker'd openldap plays in its
    integration tests)."""

    def __init__(self, users: "dict[str, tuple[str, dict]]",
                 host: str = "127.0.0.1", port: int = 0):
        self.users = users
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET,
                             socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> "MiniLdapServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _result(self, tag: int, code: int) -> bytes:
        return tlv(tag, ber_int(code, tag=0x0A) + ber_str("") +
                   ber_str(""))

    def _serve(self, conn) -> None:
        f = conn.makefile("rb")
        bound_dn = ""
        try:
            while True:
                mid, op_tag, body = read_message(f)
                if op_tag == 0x60:  # bind
                    r = BerReader(body)
                    r.read_tlv()               # version
                    _t, dn = r.read_tlv()
                    _t, pw = r.read_tlv()
                    dn_s, pw_s = dn.decode(), pw.decode()
                    rec = self.users.get(dn_s)
                    ok = rec is not None and pw_s and rec[0] == pw_s
                    code = 0 if ok else 49
                    if ok:
                        bound_dn = dn_s
                    conn.sendall(ber_seq(
                        ber_int(mid) + self._result(0x61, code)))
                elif op_tag == 0x63:  # search
                    r = BerReader(body)
                    _t, base = r.read_tlv()
                    r.read_tlv(); r.read_tlv()  # scope, deref
                    r.read_tlv(); r.read_tlv()  # size, time
                    r.read_tlv()               # typesOnly
                    ftag, fbody = r.read_tlv()
                    if ftag == 0xA3:
                        fr = BerReader(fbody)
                        _t, fattr = fr.read_tlv()
                        _t, fval = fr.read_tlv()
                        for dn_s, (_pw, attrs) in self.users.items():
                            if not dn_s.endswith(base.decode()):
                                continue
                            vals = attrs.get(fattr.decode(), [])
                            if fval.decode() not in vals:
                                continue
                            attr_body = b"".join(
                                ber_seq(ber_str(a) + tlv(0x31, b"".join(
                                    ber_str(v) for v in vs)))
                                for a, vs in attrs.items())
                            conn.sendall(ber_seq(ber_int(mid) + tlv(
                                0x64, ber_str(dn_s) +
                                ber_seq(attr_body))))
                            break
                    conn.sendall(ber_seq(
                        ber_int(mid) + self._result(0x65, 0)))
                elif op_tag == 0x42:  # unbind
                    return
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
