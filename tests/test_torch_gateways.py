"""The file gateways as one slice: the port's WebDAV, SFTP (with LDAP) and
mount op table over the port's filer, on the CPU, against the JAX
package.  Tolerance: exact equality of bytes, statuses and exit codes.
Payloads are seeded with numpy.

- end to end on a port cluster on `device="cpu"`: files written through
  WebDAV, SFTP (a store user and an LDAP user) and `WeedFS` land in one
  volume of the filer's collection; `ec.encode` turns it into 14 shards
  byte-equal to the JAX encoder's shards of the same `.dat`; 4 shards
  are lost and `ec.rebuild` brings them back byte-equal; every file reads
  back whole and ranged through all three gateways;
- under `security.toml`'s `[jwt.signing]`, `[jwt.signing.read]` and
  `[admin] key` (the sections both packages read; neither reads a
  `[jwt.filer_signing]`), a port WebDAV and SFTP over a secured port
  filer write, list, rename and read as the JAX gateways do over a
  secured JAX filer;
- the command line: `webdav`, `mount`, `sftp` and `sftp.user` argv
  through both packages give the same exit code, the same refusal and
  the same output.

The helpers here (`filer_rig`, `seeded`, `read_everywhere`) serve the
gateway files `test_torch_webdav.py`, `test_torch_sftp.py` and
`test_torch_mount.py` too.
"""

from __future__ import annotations

import contextlib
import http.client
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu import security as ref_security
from seaweedfs_tpu.filer.client import FilerClient as RefFilerClient
from seaweedfs_tpu.iam import ldap as ref_ldap
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.server.webdav_server import WebDavServer as RefWebDav
from seaweedfs_tpu.sftp import SftpService as RefSftpService
from seaweedfs_tpu.sftp import User as RefUser
from seaweedfs_tpu.sftp import UserStore as RefUserStore
from seaweedfs_tpu_torch import operation
from seaweedfs_tpu_torch import security
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.iam import ldap
from seaweedfs_tpu_torch.mount import WeedFS
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.server.webdav_server import WebDavServer
from seaweedfs_tpu_torch.sftp import SftpService, User, UserStore
from seaweedfs_tpu_torch.sftp.client import SftpClient
from seaweedfs_tpu_torch.shell import CommandEnv
from seaweedfs_tpu_torch.shell.commands import run_script

from test_torch_ec_files import EXTS, _encode_ref, _read
from test_torch_profiling import stop_background_probes
from test_torch_write_path import Cluster, _wait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANE_ENV = ("SEAWEEDFS_TPU_FILER_META_PLANE",
             "SEAWEEDFS_TPU_FILER_META_PLANE_NATIVE",
             "SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE")
LDAP_USERS = {"uid=ada,ou=people,dc=example,dc=com": (
    "lovelace", {"uid": ["ada"], "cn": ["Ada Lovelace"]})}
LDAP_DN = "uid={},ou=people,dc=example,dc=com"


def seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@contextlib.contextmanager
def filer_rig(tmp, kind: str, collection: str = "", **cluster_kw):
    """A cluster of `kind` ("port" or "jax") in this process and its
    package's filer over a sqlite file, in the default configuration
    (the meta plane and the native planes on): (cluster, filer server)."""
    saved = {k: os.environ.pop(k, None) for k in PLANE_ENV}
    cluster_kw.setdefault("racks", ("r1", "r1"))
    c = Cluster(tmp, "port" if kind == "port" else "ref", **cluster_kw)
    fs = None
    try:
        cls = FilerServer if kind == "port" else RefFilerServer
        fs = cls(c.url, store_path=str(tmp / f"{kind}_filer.db"),
                 collection=collection).start()
        yield c, fs
    finally:
        if fs is not None:
            fs.stop()
        c.close()
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
        stop_background_probes()


def _plane_get(port: int, path: str) -> "tuple[int, bytes]":
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def warm_plane(furl: str, path: str, want: bytes) -> None:
    """Until the filer's native read plane serves `path`: a plane GET, and
    on its fallback the same GET on the Python port (which fills it)."""
    port = http_json("GET", f"{furl}/status")["readPlanePort"]
    assert port > 0, "the filer's native read plane is off"
    for _ in range(100):
        st, body = _plane_get(port, path)
        if st == 200:
            assert body == want
            return
        assert http_bytes("GET", furl + path)[1] == want
        time.sleep(0.05)
    raise AssertionError(f"the read plane never served {path}")


def read_everywhere(furl: str, path: str) -> dict:
    """`path` through the filer's Python port and its native read plane:
    {"filer": (status, body), "plane": (status, body)}."""
    port = http_json("GET", f"{furl}/status")["readPlanePort"]
    st, body, _ = http_bytes("GET", furl + path)
    return {"filer": (st, body), "plane": _plane_get(port, path)}


def assert_moved(furl: str, old: str, new: str, want: bytes) -> None:
    """Right after a rename of `old` to `new`: the old path reads 404 on
    the Python port and never its bytes on the plane (a fallback 404);
    the new path reads `want` on the Python port, and on the plane either
    `want` or a fallback."""
    got = read_everywhere(furl, old)
    assert got["filer"][0] == 404
    assert got["plane"][0] == 404 and got["plane"][1] != want
    got = read_everywhere(furl, new)
    assert got["filer"] == (200, want)
    assert got["plane"] in ((200, want),
                            (404, b'{"error":"read plane fallback"}'))


def assert_gone(furl: str, path: str, want: bytes) -> None:
    got = read_everywhere(furl, path)
    assert got["filer"][0] == 404
    assert got["plane"][0] == 404 and got["plane"][1] != want


# --- the slice end to end ---------------------------------------------------

COLL = "gw"


def _chunk_vids(furl: str, paths) -> set:
    vids = set()
    for p in paths:
        e = http_json("GET", f"{furl}/__meta__/lookup?path={p}")
        vids |= {int(c["fileId"].split(",")[0]) for c in e["chunks"]}
    return vids


def _shards(c: Cluster, vid: int) -> dict:
    """ext -> bytes of every shard file of the volume on any server."""
    out = {}
    for d in c.dirs:
        for ext in EXTS[2:]:
            p = os.path.join(d, f"{COLL}_{vid}{ext}")
            if os.path.exists(p):
                out[ext] = _read(p)
    return out


def test_gateways_write_encode_lose_rebuild_and_read_back(tmp_path):
    srv = ldap.MiniLdapServer(LDAP_USERS).start()
    made = []
    with filer_rig(tmp_path, "port", collection=COLL,
                   racks=("r1",) * 4, max_volumes=3) as (c, fs):
        try:
            furl = fs.url
            dav = WebDavServer("", FilerClient(furl)).start()
            made.append(dav)
            store = UserStore(str(tmp_path / "users.json"))
            alice = User("alice", "/gw/sftp")
            alice.set_password("alicepw")
            store.put(alice)
            svc = SftpService(FilerClient(furl), store, ldap=ldap.LdapProvider(
                "127.0.0.1", srv.port, user_dn_template=LDAP_DN)).start()
            made.append(svc)
            files = {}
            # WebDAV: a collection and three files
            assert http_bytes("MKCOL", f"{dav.url}/gw/dav")[0] == 201
            for i, n in enumerate((1, 300_000, 1_500_000)):
                files[f"/gw/dav/f{i}.bin"] = seeded(230 + i, n)
                assert http_bytes("PUT", f"{dav.url}/gw/dav/f{i}.bin",
                                  files[f"/gw/dav/f{i}.bin"])[0] == 201
            # SFTP: the store's user and the directory's user
            for user, pw, home, sizes in (
                    ("alice", "alicepw", "/gw/sftp", (70_000, 900_000)),
                    ("ada", "lovelace", "/home/ada", (400_000,))):
                cl = SftpClient("127.0.0.1", svc.port, user, password=pw,
                                expected_host_key=svc.host_public_raw)
                for i, n in enumerate(sizes):
                    p = f"{home}/s{i}.bin"
                    files[p] = seeded(240 + len(files), n)
                    cl.write_file(p, files[p])
                cl.close()
            # the mount's op table: create, 256 KiB writes, release
            w = WeedFS(furl, attr_ttl=0.2)
            made.append(w)
            for i, n in enumerate((600_000, 1_100_000)):
                p = f"/gw/mnt/m{i}.bin"
                files[p] = seeded(250 + i, n)
                w.create(p)
                for off in range(0, n, 256 << 10):
                    w.write(p, files[p][off:off + (256 << 10)], off)
                w.release(p)
            (vid,) = _chunk_vids(furl, files)
            holder = operation.lookup(c.url, vid, use_cache=False)[0]["url"]
            src = os.path.join(c.dir_of(holder), f"{COLL}_{vid}")
            ref = tmp_path / "ref"
            os.makedirs(ref)
            for ext in (".dat", ".idx"):
                with open(src + ext, "rb") as f, \
                        open(ref / f"{COLL}_{vid}{ext}", "wb") as g:
                    g.write(f.read())
            _encode_ref(str(ref / f"{COLL}_{vid}"))
            want = {ext: _read(str(ref / f"{COLL}_{vid}{ext}"))
                    for ext in EXTS[2:]}

            env = CommandEnv(c.url, filer=furl)
            out = run_script(env, f"lock; ec.encode -volumeId={vid} "
                                  f"-collection={COLL}; unlock")
            assert "scatter-encoded 14 shards" in out[1], out
            _wait(lambda: len(_shards(c, vid)) == 14, "14 shard files")
            assert _shards(c, vid) == want

            locs = {x["url"]: x["shardIds"] for x in http_json(
                "GET", f"{c.url}/dir/ec_lookup?volumeId={vid}")[
                "shardIdLocations"]}
            victim = max(locs, key=lambda u: len(locs[u]))
            lost = sorted(locs[victim])[:4]
            assert len(lost) == 4, locs
            r = http_json("POST", f"{victim}/admin/ec/delete_shards",
                          {"volumeId": vid, "collection": COLL,
                           "shardIds": lost})
            assert "error" not in r, r
            assert len(_shards(c, vid)) == 10
            out = run_script(env, f"lock; ec.rebuild -volumeId={vid} "
                                  f"-collection={COLL}; unlock")
            assert f"rebuilt shards {lost} on " in out[1], out
            assert _shards(c, vid) == want
            operation._vid_cache = operation.VidCache()

            # every file back through the three gateways
            for p, body in files.items():
                st, got, _ = http_bytes("GET", f"{dav.url}{p}")
                assert (st, got == body) == (200, True), p
            p = "/gw/dav/f2.bin"
            st, got, _ = http_bytes("GET", f"{dav.url}{p}", headers={
                "Range": "bytes=1000-600999"})
            assert (st, got == files[p][1000:601000]) == (206, True)
            for user, pw, home in (("alice", "alicepw", "/gw/sftp"),
                                   ("ada", "lovelace", "/home/ada")):
                cl = SftpClient("127.0.0.1", svc.port, user, password=pw,
                                expected_host_key=svc.host_public_raw)
                for p, body in files.items():
                    if p.startswith(home + "/"):
                        assert cl.read_file(p, chunk=32 << 10) == body, p
                cl.close()
            w2 = WeedFS(furl, attr_ttl=0.2)
            made.append(w2)
            for p, body in files.items():
                d, name = p.rsplit("/", 1)
                assert name in w2.readdir(d)
                assert w2.getattr(p)["st_size"] == len(body)
                got = b"".join(w2.read(p, 1 << 20, off)
                               for off in range(0, len(body), 1 << 20))
                assert got == body, p
        finally:
            for m in reversed(made):
                (m.close if isinstance(m, WeedFS) else m.stop)()
            srv.stop()


# --- a secured filer ----------------------------------------------------------

ADMIN, WRITE, READ = "gw-admin-key", "gw-write-key", "gw-read-key"


def _secured_transcript(kind: str, tmp) -> list:
    """WebDAV and SFTP over `kind`'s secured filer, through `kind`'s
    `FilerClient` as the `webdav` and `sftp` commands attach."""
    port = kind == "port"
    out = []
    with filer_rig(tmp, kind) as (c, fs):
        client = (FilerClient if port else RefFilerClient)(fs.url)
        dav = (WebDavServer if port else RefWebDav)("", client).start()
        store = (UserStore if port else RefUserStore)(
            str(tmp / f"{kind}_users.json"))
        u = (User if port else RefUser)("alice", "/sec")
        u.set_password("pw")
        store.put(u)
        svc = (SftpService if port else RefSftpService)(client,
                                                        store).start()
        try:
            body = seeded(260, 700_000)
            for method, path, data, headers in (
                    ("MKCOL", "/sec/d", None, {}),
                    ("PUT", "/sec/d/a.bin", body, {}),
                    ("GET", "/sec/d/a.bin", None, {}),
                    ("GET", "/sec/d/a.bin", None,
                     {"Range": "bytes=10-99"}),
                    ("MOVE", "/sec/d/a.bin", None,
                     {"Destination": "/sec/d/b.bin"}),
                    ("GET", "/sec/d/a.bin", None, {}),
                    ("GET", "/sec/d/b.bin", None, {})):
                st, got, _ = http_bytes(method, f"{dav.url}{path}", data,
                                        headers)
                out.append((method, path, st, len(got),
                            got == body or got == body[10:100]))
            cl = SftpClient("127.0.0.1", svc.port, "alice", password="pw",
                            expected_host_key=svc.host_public_raw)
            cl.write_file("/sec/s.bin", body)
            cl.rename("/sec/s.bin", "/sec/t.bin")
            out.append(sorted(n for n, _ in cl.listdir("/sec")))
            out.append(cl.read_file("/sec/t.bin") == body)
            cl.close()
            # the volume's needles really are gated: no token, no write
            fid = http_json("GET", f"{fs.url}/__meta__/lookup?path="
                                   f"/sec/t.bin")["chunks"][0]["fileId"]
            loc = http_json("GET", f"{c.url}/dir/lookup?volumeId="
                                   f"{fid.split(',')[0]}")["locations"][0]
            out.append(http_bytes("POST", f"{loc['url']}/{fid}",
                                  b"x")[0])
        finally:
            svc.stop()
            dav.stop()
    return out


def test_gateways_over_a_secured_filer_match_the_jax_gateways(tmp_path):
    for sec, Cfg in ((security, security.SecurityConfig),
                     (ref_security, ref_security.SecurityConfig)):
        sec.configure(Cfg(volume_write_key=WRITE, volume_read_key=READ,
                          admin_key=ADMIN))
    try:
        port = _secured_transcript("port", tmp_path)
        ref = _secured_transcript("jax", tmp_path)
    finally:
        security.configure(None)
        ref_security.configure(None)
    assert port == ref
    assert [x[2] for x in port[:7]] == [201, 201, 200, 206, 201, 404, 200]
    assert port[7:9] == [["d", "t.bin"], True]
    assert port[9] == 401


# --- the command line -----------------------------------------------------

CLI_CASES = [
    (["sftp", "-filer", "127.0.0.1:1"], 2),
    (["sftp", "-userStoreFile", "{d}/u.json", "-port", "nope"], 2),
    (["sftp.user", "list"], 2),
    (["sftp.user", "-store", "{d}/u.json", "rename"], 2),
    (["sftp.user", "-store", "{d}/u.json", "list"], 0),
    (["sftp.user", "-store", "{d}/u.json", "add", "-name", "carol",
      "-password", "pw", "-home", "/c", "-perm", "/data:read,list"], 0),
    (["sftp.user", "-store", "{d}/u.json", "delete", "-name", "carol"], 0),
    (["webdav", "-port", "x"], 2),
    (["mount", "-filer", "127.0.0.1:1"], 2),
]


def _cli(pkg: str, argv: list, d) -> "tuple[int, str, str]":
    r = subprocess.run([sys.executable, "-m", pkg] +
                       [a.replace("{d}", str(d)) for a in argv],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=120, env=dict(os.environ, PYTHONPATH=REPO,
                                             JAX_PLATFORMS="cpu"))
    err = r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ""
    # argparse names each package's program its own way
    err = re.sub(r"^.*? (\S+): error: ", r"\1: error: ", err)
    return r.returncode, err, r.stdout


@pytest.mark.parametrize("case", range(len(CLI_CASES)))
def test_cli_matches_the_jax_cli(case, tmp_path):
    argv, rc = CLI_CASES[case]
    dirs = {k: tmp_path / k for k in ("port", "jax")}
    for d in dirs.values():
        os.makedirs(d)
    if "delete" in argv or "list" in argv[-1:]:
        for pkg, d in (("seaweedfs_tpu_torch", dirs["port"]),
                       ("seaweedfs_tpu", dirs["jax"])):
            assert _cli(pkg, CLI_CASES[5][0], d)[0] == 0
    port = _cli("seaweedfs_tpu_torch", argv, dirs["port"])
    ref = _cli("seaweedfs_tpu", argv, dirs["jax"])
    assert port[0] == ref[0] == rc, (port, ref)
    assert port[1] == ref[1]
    if rc == 0:
        assert port[2].replace(str(dirs["port"]), "D") == \
            ref[2].replace(str(dirs["jax"]), "D")
