"""The port's LDAP client, provider and stand-in server
(`seaweedfs_tpu_torch/iam/ldap.py`) on the CPU, against the JAX
package's.  Tolerance: exact equality of the bytes on the wire and of
every answer.

- the JAX suite `test_ldap.py` runs whole on the port
  (`jax_suite.load_suite`), its SFTP login over the port's gateway;
- both ways over sockets: each package's `LdapClient` and
  `LdapProvider` against the other package's `MiniLdapServer` bind,
  search, map attributes and refuse alike;
- the bytes: both clients send byte-equal BER for the same bind, search
  and unbind, both servers answer the same request with byte-equal
  replies, and the BER helpers agree on every length form.
"""

import socket

import pytest

from jax_suite import load_suite
from seaweedfs_tpu.iam import ldap as ref_ldap
from seaweedfs_tpu_torch.iam import ldap as port_ldap

PORTED = ("seaweedfs_tpu.iam", "seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server",
          "seaweedfs_tpu.server.volume_server", "seaweedfs_tpu.sftp",
          "seaweedfs_tpu.filer")

globals().update(load_suite(
    "test_ldap", PORTED, fixtures=("ldap_server",),
    replace={"from seaweedfs_tpu.server.volume_server import VolumeServer":
             "from jax_suite import port_volume_server as VolumeServer"}))

PKG = {"port": port_ldap, "jax": ref_ldap}
USERS = {
    "uid=ada,ou=people,dc=example,dc=com": (
        "lovelace", {"uid": ["ada"], "cn": ["Ada Lovelace"],
                     "mail": ["ada@example.com"]}),
    "uid=alan,ou=people,dc=example,dc=com": (
        "turing1912", {"uid": ["alan"], "cn": ["Alan Turing"]}),
    "cn=svc,dc=example,dc=com": ("svcpass", {"cn": ["svc"]}),
}
BASE = "dc=example,dc=com"
ADA = "uid=ada,ou=people,dc=example,dc=com"


@pytest.fixture(scope="module")
def servers():
    out = {k: m.MiniLdapServer(USERS).start() for k, m in PKG.items()}
    yield out
    for s in out.values():
        s.stop()


def _session(mod, port: int) -> dict:
    """One client's view of a directory: binds, searches, refusals."""
    c = mod.LdapClient("127.0.0.1", port)
    try:
        out = {"bind": c.bind(ADA, "lovelace"),
               "hit": c.search_one(BASE, "uid", "ada", ["cn", "mail"]),
               "miss": c.search_one(BASE, "uid", "nobody", ["cn"]),
               "alan": c.search_one(BASE, "uid", "alan", ["cn", "uid"])}
    finally:
        c.close()
    c = mod.LdapClient("127.0.0.1", port)
    try:
        out["wrong"] = c.bind(ADA, "wrong")
        out["unknown"] = c.bind("uid=eve,dc=example,dc=com", "x")
    finally:
        c.close()
    tmpl = mod.LdapProvider("127.0.0.1", port,
                            user_dn_template="uid={},ou=people," + BASE)
    search = mod.LdapProvider("127.0.0.1", port, base_dn=BASE,
                              bind_dn="cn=svc," + BASE,
                              bind_password="svcpass", user_attr="uid")
    out["provider"] = [
        p.authenticate(u, pw) for p in (tmpl, search)
        for u, pw in (("ada", "lovelace"), ("ada", "wrong"), ("ada", ""),
                      ("alan", "turing1912"), ("ghost", "x"))]
    return out


@pytest.mark.parametrize("client,server", [("jax", "port"),
                                           ("port", "jax")])
def test_client_and_provider_against_the_other_server(servers, client,
                                                      server):
    got = _session(PKG[client], servers[server].port)
    same = _session(PKG[server], servers[server].port)
    assert got == same
    assert got["bind"] and not got["wrong"] and not got["unknown"]
    assert got["hit"] == (ADA, {"uid": ["ada"], "cn": ["Ada Lovelace"],
                                "mail": ["ada@example.com"]})
    assert got["miss"] is None
    assert got["provider"][0] == {"name": "ada", "dn": ADA}
    assert got["provider"][5] == {"name": "ada", "dn": ADA,
                                  "displayName": "Ada Lovelace",
                                  "email": "ada@example.com"}
    assert got["provider"][1] is got["provider"][2] is None


@pytest.mark.parametrize("client", ["jax", "port"])
def test_provider_outage_raises_against_no_server(client):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    p = PKG[client].LdapProvider("127.0.0.1", port,
                                 user_dn_template="uid={},dc=x")
    with pytest.raises(OSError):
        p.authenticate("ada", "pw")


class _Tap:
    """A socket stand-in that records what a client sends."""

    def __init__(self, sock, sent: list):
        self._sock = sock
        self._sent = sent

    def sendall(self, data: bytes) -> None:
        self._sent.append(bytes(data))
        self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _wire(mod, port: int) -> list:
    sent: list = []
    c = mod.LdapClient("127.0.0.1", port)
    c.sock = _Tap(c.sock, sent)
    c.bind(ADA, "lovelace")
    c.search_one(BASE, "uid", "ada", ["cn", "mail", "uid"])
    c.bind("cn=svc," + BASE, "wrong")
    c.close()
    return sent


def test_clients_send_byte_equal_ber(servers):
    port = servers["port"].port
    assert _wire(port_ldap, port) == _wire(ref_ldap, port)
    assert len(_wire(port_ldap, port)) == 4


def _raw(port: int, requests: "list[bytes]") -> "list[bytes]":
    """Each request's raw reply bytes from a server."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        f = s.makefile("rb")
        for req in requests:
            s.sendall(req)
            replies = []
            while True:
                mid, tag, body = ref_ldap.read_message(f)
                replies.append(ref_ldap.ber_seq(ref_ldap.ber_int(mid) +
                                                ref_ldap.tlv(tag, body)))
                if tag in (0x61, 0x65):
                    break
            out.append(b"".join(replies))
    return out


def test_servers_answer_byte_equal(servers):
    reqs = _wire(ref_ldap, servers["jax"].port)[:3]
    assert _raw(servers["port"].port, reqs) == \
        _raw(servers["jax"].port, reqs)


@pytest.mark.parametrize("n", [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF,
                               0x10000, 1 << 24])
def test_ber_helpers_agree(n):
    assert port_ldap.ber_len(n) == ref_ldap.ber_len(n)
    assert port_ldap.ber_int(n) == ref_ldap.ber_int(n)
    assert port_ldap.ber_int(n, tag=0x0A) == ref_ldap.ber_int(n, tag=0x0A)
    body = bytes(range(256)) * (min(n, 1 << 16) // 256 + 1)
    assert port_ldap.tlv(0x04, body) == ref_ldap.tlv(0x04, body)
    assert port_ldap.BerReader(port_ldap.tlv(0x30, body)).read_tlv() == \
        ref_ldap.BerReader(ref_ldap.tlv(0x30, body)).read_tlv()
