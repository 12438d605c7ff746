"""Remote mounts on the CPU, the port against the JAX package: the conf's
`RemoteConf` wire bytes, the `remote.*` shell verbs, the filer's
read-through of uncached remote entries, `remote.cache` / `.uncache` /
`.meta.sync` / `.copy.local` / `.mount.buckets` / `.unmount`, and
`filer.remote.sync`'s `RemoteSyncer`.  The foreign store is an S3 gateway
of the port over a filer of its own (the reference's own trick); each
package mounts a bucket of its own from it into a local filer over a
cluster of its package.  Tolerance: exact equality of the verbs' output
(bucket names masked), status codes and bytes; payloads seeded with
numpy.

- `conf_to_pb_bytes` writes the bytes of the JAX package's protobuf
  encoder, `remote_pb2` parses them, and a conf saved by either package
  (its JSON or its wire twin alone) loads in the other;
- the same script of verbs and reads gives the same transcript on both
  packages' filers;
- a read-through and `remote.cache` write the same metalog events on
  both packages' filers.
"""

import json
import urllib.parse

import numpy as np
import pytest

from seaweedfs_tpu import remote as ref_remote
from seaweedfs_tpu.pb import remote_pb2
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.shell import COMMANDS as REF_COMMANDS
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu_torch import remote
from seaweedfs_tpu_torch.remote import remote_storage
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes
from seaweedfs_tpu_torch.shell import COMMANDS, CommandEnv

from test_torch_profiling import stop_background_probes
from test_torch_write_path import Cluster

ACCESS, SECRET = "REMOTEKEY", "remotesecret"


def _seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


CONFS = [{"type": "s3", "endpoint": "127.0.0.1:8333", "accessKey": "AK",
          "secretKey": "SK"},
         {"type": "s3", "endpoint": "h:1", "region": "eu-west-1",
          "forcePathStyle": False, "v4Signature": False},
         {"endpoint": "é.example:9", "accessKey": "x" * 300},
         {"type": "s3"}]


@pytest.mark.parametrize("i", range(len(CONFS)))
def test_remote_conf_bytes_are_the_jax_bytes(i):
    conf = CONFS[i]
    port = remote_storage.conf_to_pb_bytes("cloud1", conf)
    ref = ref_remote.remote_storage.conf_to_pb_bytes("cloud1", conf)
    assert port == ref
    pb = remote_pb2.RemoteConf.FromString(port)
    assert (pb.name, pb.s3_endpoint, pb.s3_access_key) == \
        ("cloud1", conf.get("endpoint", ""), conf.get("accessKey", ""))
    assert remote_storage.conf_from_pb_bytes(ref) == \
        ref_remote.remote_storage.conf_from_pb_bytes(port)
    # every field of the message, and one this encoder does not know
    full = remote_pb2.RemoteConf(
        type="s3", name="n", s3_access_key="a", s3_secret_key="s",
        s3_region="r", s3_endpoint="e", s3_storage_class="c",
        s3_force_path_style=True, s3_v4_signature=True,
        gcs_google_application_credentials="g", gcs_project_id="p",
        azure_account_name="an", azure_account_key="ak",
        backblaze_key_id="b1", backblaze_application_key="b2",
        backblaze_endpoint="b3", backblaze_region="b4")
    raw = full.SerializeToString()
    fields = remote_storage.decode_remote_conf(raw + b"\xa0\x06\x01")
    assert remote_storage.encode_remote_conf(fields) == raw


@pytest.fixture(scope="module")
def foreign(tmp_path_factory):
    """The foreign object store: a port S3 gateway over a port filer."""
    tmp = tmp_path_factory.mktemp("foreign")
    c = Cluster(tmp, "port", racks=("r1",), size_limit_mb=64)
    fs = FilerServer(c.url, store_path=str(tmp / "f.db")).start()
    s3 = S3ApiServer(fs.filer, credentials={ACCESS: SECRET}).start()
    yield s3
    s3.stop()
    fs.stop()
    c.close()
    stop_background_probes()


PKGS = {
    "port": {"remote": remote, "COMMANDS": COMMANDS, "Env": CommandEnv,
             "Filer": FilerServer, "cluster": "port"},
    "jax": {"remote": ref_remote, "COMMANDS": REF_COMMANDS, "Env": RefEnv,
            "Filer": RefFilerServer, "cluster": "ref"},
}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_saved_conf_loads_in_the_other_package(writer, foreign,
                                                 tmp_path):
    c = Cluster(tmp_path, "port", racks=("r1",), size_limit_mb=64)
    fs = FilerServer(c.url, store_path=str(tmp_path / "f.db")).start()
    try:
        reader = "jax" if writer == "port" else "port"
        conf = {"type": "s3", "endpoint": foreign.url,
                "accessKey": ACCESS, "secretKey": SECRET}
        PKGS[writer]["remote"].save_conf(fs.url, "c1", conf)
        wire = http_bytes("GET", f"{fs.url}/etc/remote/c1.remote.conf")
        assert wire[0] == 200 and wire[1] == \
            remote_storage.conf_to_pb_bytes("c1", conf)
        want = PKGS[writer]["remote"].load_conf(fs.url, "c1")
        assert PKGS[reader]["remote"].load_conf(fs.url, "c1") == want
        # the wire twin alone (a tree configured by the reference)
        assert http_bytes("DELETE", f"{fs.url}/etc/remote/c1.conf")[0] \
            == 204
        assert PKGS[reader]["remote"].load_conf(fs.url, "c1") == \
            PKGS[writer]["remote"].load_conf(fs.url, "c1") == \
            {**conf, "region": "", "forcePathStyle": True,
             "v4Signature": True}
    finally:
        fs.stop()
        c.close()


def _get(url, path, headers=None):
    st, body, _ = http_bytes("GET", url + urllib.parse.quote(path), None,
                             headers)
    return st, body


def _script(kind: str, foreign, tmp_path) -> list:
    pkg = PKGS[kind]
    r = pkg["remote"]
    cmd = pkg["COMMANDS"]
    bucket = f"cloud{kind}"
    client = remote_storage.S3RemoteStorage(foreign.url, ACCESS, SECRET,
                                            bucket)
    client.create_bucket()
    objects = {"archive/a.txt": b"alpha from the cloud",
               "archive/sub/b.bin": _seeded(1, 2000),
               "archive/big.bin": _seeded(2, (3 << 20) + 5),
               "other/ignored.txt": b"outside the prefix"}
    for k, v in objects.items():
        client.write(k, v)
    c = Cluster(tmp_path / kind, pkg["cluster"], racks=("r1",),
                size_limit_mb=64)
    local = pkg["Filer"](c.url, store_path=str(tmp_path / kind / "f.db"))
    local.start()
    out = []
    try:
        env = pkg["Env"](c.url, filer=local.url)
        out.append(cmd["remote.configure"](env, [
            "-name=cloud1", "-type=s3", f"-endpoint={foreign.url}",
            f"-accessKey={ACCESS}", f"-secretKey={SECRET}"]))
        out.append(cmd["remote.configure"](env, []))
        out.append(cmd["remote.mount"](
            env, ["-dir=/mnt/c", f"-remote=cloud1/{bucket}/archive"]))
        out.append(cmd["remote.mount"](env, []))
        e = json.loads(http_bytes(
            "GET", f"{local.url}/__meta__/lookup?path=/mnt/c/a.txt")[1])
        out.append((e.get("chunks"), e["extended"]["remote"]))
        out.append(_get(local.url, "/mnt/c/a.txt"))
        out.append(_get(local.url, "/mnt/c/big.bin")[1] ==
                   objects["archive/big.bin"])
        out.append(_get(local.url, "/mnt/c/sub/b.bin",
                        {"Range": "bytes=100-109"}))
        out.append(_get(local.url, "/mnt/c/sub/b.bin",
                        {"Range": "bytes=5000-"})[0])
        out.append(_get(local.url, "/mnt/c/ignored.txt")[0])
        out.append(cmd["remote.cache"](env, ["-dir=/mnt/c",
                                             "-include=big"]))
        out.append(cmd["remote.cache"](env, ["-dir=/mnt/c"]))
        out.append(_get(local.url, "/mnt/c/big.bin")[1] ==
                   objects["archive/big.bin"])
        out.append(cmd["remote.uncache"](env, ["-dir=/mnt/c",
                                               "-include=a.txt"]))
        out.append(_get(local.url, "/mnt/c/a.txt"))
        client.write("archive/new.txt", b"fresh")
        client.write("archive/a.txt", b"remote v2 content!")
        out.append(cmd["remote.meta.sync"](env, ["-dir=/mnt/c"]))
        out.append(_get(local.url, "/mnt/c/new.txt"))
        out.append(_get(local.url, "/mnt/c/a.txt"))
        # local writes: copy.local, then the sync loop
        for p, body in (("/mnt/c/l1.txt", b"local one"),
                        ("/mnt/c/sub/l2.txt", b"local two")):
            assert http_bytes("PUT", local.url + p, body)[0] == 201
        out.append(cmd["remote.copy.local"](env, ["-dir=/mnt/c",
                                                  "-dryRun=true"]))
        out.append(cmd["remote.copy.local"](env, ["-dir=/mnt/c"]))
        out.append(client.read("archive/sub/l2.txt"))
        syncer = r.RemoteSyncer(local.url, "/mnt/c",
                                str(tmp_path / kind / "sync.offset"))
        syncer.run_once()
        assert http_bytes("PUT", local.url + "/mnt/c/pushed.bin",
                          _seeded(3, 70000))[0] == 201
        assert http_bytes("DELETE", local.url + "/mnt/c/l1.txt")[0] == 204
        out.append(syncer.run_once() >= 2)
        out.append(client.read("archive/pushed.bin") == _seeded(3, 70000))
        out.append(client.stat("archive/l1.txt"))
        out.append(cmd["remote.mount.buckets"](
            env, ["-remote=cloud1", f"-bucketPattern={bucket}"]))
        out.append(_get(local.url, f"/buckets/{bucket}/archive/new.txt"))
        out.append(cmd["remote.unmount"](env, ["-dir=/mnt/c"]))
        out.append(cmd["remote.unmount"](env, ["-dir=/mnt/c"]))
        out.append(_get(local.url, "/mnt/c/new.txt"))
    finally:
        local.stop()
        c.close()
    return json.loads(json.dumps(out, default=repr).replace(bucket, "B"))


def test_the_remote_verbs_answer_as_the_jax_verbs(foreign, tmp_path):
    got = {k: _script(k, foreign, tmp_path) for k in ("port", "jax")}
    for i, (a, b) in enumerate(zip(got["port"], got["jax"])):
        assert a == b, i
    assert len(got["port"]) == len(got["jax"])


def _cache_events(kind: str, foreign, tmp_path) -> list:
    """The metalog events a remote mount's read-through and `remote.cache`
    write on `kind`'s filer, from after the mount: (op, path, chunks,
    extended keys, remote entry) each."""
    pkg = PKGS[kind]
    cmd = pkg["COMMANDS"]
    bucket = f"events{kind}"
    client = remote_storage.S3RemoteStorage(foreign.url, ACCESS, SECRET,
                                            bucket)
    client.create_bucket()
    objects = {"archive/a.txt": b"alpha", "archive/sub/b.bin": _seeded(1, 2000),
               "archive/big.bin": _seeded(2, (3 << 20) + 5)}
    for k, v in objects.items():
        client.write(k, v)
    c = Cluster(tmp_path / kind, pkg["cluster"], racks=("r1",),
                size_limit_mb=64)
    local = pkg["Filer"](c.url, store_path=str(tmp_path / kind / "f.db"))
    local.start()

    def events() -> list:
        return json.loads(http_bytes(
            "GET", f"{local.url}/__meta__/events?sinceNs=0")[1])["events"]
    try:
        env = pkg["Env"](c.url, filer=local.url)
        cmd["remote.configure"](env, [
            "-name=cloud1", "-type=s3", f"-endpoint={foreign.url}",
            f"-accessKey={ACCESS}", f"-secretKey={SECRET}"])
        cmd["remote.mount"](env, ["-dir=/mnt/c",
                                  f"-remote=cloud1/{bucket}/archive"])
        start = len(events())
        for path in ("/mnt/c/a.txt", "/mnt/c/big.bin", "/mnt/c/sub/b.bin"):
            assert _get(local.url, path)[1] == objects["archive" + path[6:]]
        cmd["remote.cache"](env, ["-dir=/mnt/c"])
        got = events()[start:]
    finally:
        local.stop()
        c.close()

    def sig(ev):
        e = ev.get("newEntry") or ev.get("oldEntry") or {}
        ext = e.get("extended") or {}
        return [ev.get("op"), e.get("fullPath"), len(e.get("chunks") or []),
                sorted(ext), ext.get("remote")]
    return json.loads(json.dumps([sig(ev) for ev in got]).replace(bucket,
                                                                   "B"))


def test_the_remote_cache_writes_the_jax_filers_events(foreign, tmp_path):
    """A remote mount's read-through of three files, then `remote.cache`,
    write the same metalog events on both packages' filers: each file's
    entry is written twice (its chunks, then its remote record), in the
    same order, with the same chunk counts and extended attributes.
    (PR 20's `filer_rest` counted 16 such second writes on the port; the
    JAX filer writes them alike, so they are no fault.)"""
    got = {k: _cache_events(k, foreign, tmp_path) for k in ("port", "jax")}
    assert got["port"] == got["jax"]
    assert [(op, path) for op, path, *_ in got["port"]] == [
        ("update", p) for p in ("/mnt/c/a.txt", "/mnt/c/a.txt",
                                "/mnt/c/big.bin", "/mnt/c/big.bin",
                                "/mnt/c/sub/b.bin", "/mnt/c/sub/b.bin")]
