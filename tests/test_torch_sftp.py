"""The port's SFTP gateway (`seaweedfs_tpu_torch/sftp/`) on the CPU,
against the JAX package's.  Tolerance: exact equality of file bytes,
listings, exception types, status codes and their messages.  Payloads
are seeded with numpy.

- the JAX suite `test_sftp.py` runs whole on the port
  (`jax_suite.load_suite`): both attachment modes;
- both ways over sockets: the JAX `SftpClient` against the port's
  `SftpService` over a port filer, and the port's client against the JAX
  service over a JAX filer, logging in by password, by publickey and
  through LDAP, writing and reading byte-equal files; a wrong password,
  an unknown user, a wrong key and a write outside the user's prefix are
  refused alike (the same exception, status code and message as the
  service's own package's client gets);
- user stores and host keys: a store written by either package's
  `sftp.user` loads in the other (passwords, keys, permissions), and a
  host key PEM written by either package's `sftp` is the key the other
  package's `sftp` serves;
- stale reads: right after an SFTP RENAME or REMOVE, the old path reads
  404 through the filer's Python port, its native read plane and SFTP,
  and the new path its bytes.
"""

import os
import subprocess
import sys

import pytest
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey)

from jax_suite import load_suite, port_volume_server
from seaweedfs_tpu.filer.client import FilerClient as RefFilerClient
from seaweedfs_tpu.iam import ldap as ref_ldap
from seaweedfs_tpu.sftp import SftpService as RefSftpService
from seaweedfs_tpu.sftp import UserStore as RefUserStore
from seaweedfs_tpu.sftp import client as ref_client
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.iam import ldap
from seaweedfs_tpu_torch.sftp import SftpService, User, UserStore
from seaweedfs_tpu_torch.sftp import client as port_client

from test_torch_gateways import (LDAP_DN, LDAP_USERS, REPO, assert_gone,
                                 assert_moved, filer_rig, seeded,
                                 warm_plane)

PORTED = ("seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server",
          "seaweedfs_tpu.server.volume_server", "seaweedfs_tpu.sftp",
          "seaweedfs_tpu.filer")

globals().update(load_suite("test_sftp", PORTED, fixtures=("sftp",),
                            overrides={"VolumeServer": port_volume_server}))

CLIENT = {"port": port_client, "jax": ref_client}
HOST_KEY = Ed25519PrivateKey.from_private_bytes(seeded(270, 32))
KIM_KEY = Ed25519PrivateKey.from_private_bytes(seeded(271, 32))
OTHER_KEY = Ed25519PrivateKey.from_private_bytes(seeded(272, 32))
LOGINS = {"password": {"username": "alice", "password": "alicepw"},
          "publickey": {"username": "kim", "key": KIM_KEY},
          "ldap": {"username": "ada", "password": "lovelace"}}
HOMES = {"alice": "/home/alice", "kim": "/home/kim", "ada": "/home/ada"}


def _write_store(path: str) -> None:
    """alice (password), kim (publickey only), bob (password, and a
    read grant under alice's home), written by the port's store."""
    store = UserStore(path)
    alice = User("alice", "/home/alice")
    alice.set_password("alicepw")
    store.put(alice)
    kim = User("kim", "/home/kim")
    kim.add_public_key(port_client.openssh_pubkey(KIM_KEY, "kim@test"))
    store.put(kim)
    bob = User("bob", "/home/bob")
    bob.set_password("bobpw")
    bob.permissions["/home/alice/pub"] = ["read", "list"]
    store.put(bob)


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """kind -> (SftpService, filer url): each package's service over its
    own package's filer through its `FilerClient` (as `sftp -filer`
    attaches), one store file written by the port and read by both, and
    one LDAP stand-in of the JAX package."""
    tmp = tmp_path_factory.mktemp("sftp_x")
    store = str(tmp / "users.json")
    _write_store(store)
    srv = ref_ldap.MiniLdapServer(LDAP_USERS).start()
    with filer_rig(tmp, "port") as (_c, pfs), \
            filer_rig(tmp, "jax") as (_rc, rfs):
        out = {
            "port": (SftpService(FilerClient(pfs.url), UserStore(store),
                                 host_key=HOST_KEY,
                                 ldap=ldap.LdapProvider(
                                     "127.0.0.1", srv.port,
                                     user_dn_template=LDAP_DN)).start(),
                     pfs.url),
            "jax": (RefSftpService(RefFilerClient(rfs.url),
                                   RefUserStore(store), host_key=HOST_KEY,
                                   ldap=ref_ldap.LdapProvider(
                                       "127.0.0.1", srv.port,
                                       user_dn_template=LDAP_DN)).start(),
                    rfs.url)}
        try:
            yield out
        finally:
            for svc, _ in out.values():
                svc.stop()
            srv.stop()


def _connect(pkg: str, svc, **kw):
    return CLIENT[pkg].SftpClient("127.0.0.1", svc.port,
                                  expected_host_key=svc.host_public_raw,
                                  **kw)


@pytest.mark.parametrize("login", sorted(LOGINS))
@pytest.mark.parametrize("client,service", [("jax", "port"),
                                            ("port", "jax")])
def test_logins_and_files_across_packages(services, client, service,
                                          login):
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    svc, furl = services[service]
    user = LOGINS[login]["username"]
    home = HOMES[user]
    files = {f"{home}/{client}/f{i}.bin": seeded(280 + i, n)
             for i, n in enumerate((0, 1, 100_000, (1 << 20) + 17))}
    c = _connect(client, svc, **LOGINS[login])
    try:
        assert c.realpath(".") == home
        c.mkdir(f"{home}/{client}")
        for p, body in files.items():
            c.write_file(p, body)
        for p, body in files.items():
            assert c.read_file(p, chunk=32 << 10) == body
            assert http_bytes("GET", furl + p)[1] == body
        listed = dict(c.listdir(f"{home}/{client}"))
        assert {n: a["size"] for n, a in listed.items()} == \
            {p.rsplit("/", 1)[1]: len(b) for p, b in files.items()}
        for p in files:
            c.remove(p)
        c.rmdir(f"{home}/{client}")
    finally:
        c.close()


def _refusals(client: str, svc) -> list:
    out = []
    for kw in ({"username": "alice", "password": "wrong"},
               {"username": "mallory", "password": "x"},
               {"username": "kim", "key": OTHER_KEY},
               {"username": "ada", "password": "wrong"}):
        try:
            _connect(client, svc, **kw).close()
            out.append("accepted")
        except Exception as e:  # noqa: BLE001 — the refusal is the answer
            out.append((type(e).__name__, str(e)))
    for user, pw, path in (("alice", "alicepw", "/etc/passwd"),
                           ("bob", "bobpw", "/home/alice/pub/evil.txt"),
                           ("ada", "lovelace", "/home/alice/x")):
        c = _connect(client, svc, username=user, password=pw)
        try:
            c.write_file(path, b"nope")
            out.append("written")
        except Exception as e:  # noqa: BLE001
            out.append((type(e).__name__, getattr(e, "code", None),
                        str(e)))
        finally:
            c.close()
    return out


@pytest.mark.parametrize("client,service", [("jax", "port"),
                                            ("port", "jax")])
def test_refusals_match_across_packages(services, client, service):
    svc, _ = services[service]
    got = _refusals(client, svc)
    assert got == _refusals(service, svc)
    assert [x[0] for x in got[:4]] == ["PermissionError"] * 4
    assert [x[1] for x in got[4:]] == [3, 3, 3]


# --- user stores and host keys ----------------------------------------------

PKGS = {"port": "seaweedfs_tpu_torch", "jax": "seaweedfs_tpu"}
STORES = {"port": UserStore, "jax": RefUserStore}


def _run(pkg: str, *argv: str) -> str:
    r = subprocess.run([sys.executable, "-m", PKGS[pkg], *argv],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=120, env=dict(os.environ, PYTHONPATH=REPO,
                                             JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_user_store_written_by_one_loads_in_the_other(tmp_path, writer,
                                                      reader):
    path = str(tmp_path / "users.json")
    key = port_client.openssh_pubkey(KIM_KEY, "kim@test")
    _run(writer, "sftp.user", "-store", path, "add", "-name", "carol",
         "-password", "carolpw", "-home", "/data/carol", "-perm",
         "/pub:read,list", "-perm", "/drop:write")
    _run(writer, "sftp.user", "-store", path, "add", "-name", "kim",
         "-pubkey", key)
    _run(writer, "sftp.user", "-store", path, "add", "-name", "gone",
         "-password", "x")
    _run(writer, "sftp.user", "-store", path, "delete", "-name", "gone")
    assert _run(writer, "sftp.user", "-store", path, "list") == \
        _run(reader, "sftp.user", "-store", path, "list")
    store = STORES[reader](path)
    carol, kim = store.get("carol"), store.get("kim")
    assert store.get("gone") is None
    assert carol.check_password("carolpw")
    assert not carol.check_password("other")
    assert carol.home_dir == "/data/carol"
    assert carol.permissions == {"/pub": ["read", "list"],
                                 "/drop": ["write"]}
    assert kim.public_keys == [" ".join(key.split()[:2])]
    assert kim.has_public_key(*key.split()[:2])
    other = STORES[writer](path)
    assert [u.to_json() for u in store] == [u.to_json() for u in other]


def _serve_sftp(pkg: str, tmp, furl: str, key_file: str):
    """`sftp -hostKeyFile key_file` of `pkg` on a free port: (process,
    port)."""
    store = str(tmp / f"{pkg}_store.json")
    if not os.path.exists(store):
        _write_store(store)
    p = subprocess.Popen(
        [sys.executable, "-m", PKGS[pkg], "sftp", "-port", "0", "-filer",
         furl, "-userStoreFile", store, "-hostKeyFile", key_file],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           JAX_PLATFORMS="cpu"))
    line = p.stdout.readline()
    assert line.startswith("sftp on 127.0.0.1:"), p.stderr.read()
    return p, int(line.split()[2].rsplit(":", 1)[1])


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_host_key_written_by_one_is_served_by_the_other(services,
                                                        tmp_path, writer,
                                                        reader):
    key_file = str(tmp_path / "host.pem")
    furl = services[reader][1]
    raws = []
    for pkg in (writer, reader):
        p, port = _serve_sftp(pkg, tmp_path, furl, key_file)
        try:
            with open(key_file, "rb") as f:
                key = serialization.load_pem_private_key(f.read(), None)
            raw = key.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw)
            raws.append(raw)
            c = CLIENT[reader].SftpClient("127.0.0.1", port, "alice",
                                          password="alicepw",
                                          expected_host_key=raw)
            assert c.realpath(".") == "/home/alice"
            c.close()
        finally:
            p.terminate()
            # the port's command stops on SIGTERM and exits 0; the JAX
            # one has no handler and dies of the signal
            assert p.wait(timeout=30) == (0 if pkg == "port" else -15)
            p.stdout.close()
            p.stderr.close()
    assert raws[0] == raws[1]


# --- stale reads after a rename or a remove -----------------------------------

def test_rename_and_remove_are_seen_at_once(services):
    from seaweedfs_tpu_torch.server.httpd import http_bytes
    svc, furl = services["port"]
    body = seeded(290, 50_000)
    c = _connect("port", svc, username="alice", password="alicepw")
    try:
        for i in range(3):
            old, new = f"/home/alice/st/a{i}.bin", f"/home/alice/st/b{i}.bin"
            c.write_file(old, body)
            warm_plane(furl, old, body)
            c.rename(old, new)
            assert_moved(furl, old, new, body)
            with pytest.raises(port_client.SftpError) as e:
                c.stat(old)
            assert e.value.code == 2
            assert c.read_file(new) == body
            warm_plane(furl, new, body)
            c.remove(new)
            assert_gone(furl, new, body)
            assert http_bytes("GET", furl + new)[0] == 404
            assert "b%d.bin" % i not in dict(c.listdir("/home/alice/st"))
    finally:
        c.close()
