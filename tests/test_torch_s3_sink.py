"""`filer.backup.s3` on the port (`seaweedfs_tpu_torch/filer/s3_sink.py`
over `cloud_sinks._CloudSink`), on the CPU, against the JAX package's.
Tolerance: exact equality of the mirrored objects, the offset and the
command's line (addresses masked).

- the JAX suite's `test_notification.py::test_s3_sink_mirrors_filer` on
  a port cluster (`jax_suite.load_suite`);
- both packages' `filer.backup.s3` commands mirror one filer's creates,
  overwrites, renames and deletes into buckets of a port gateway alike.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

from jax_suite import load_suite, port_volume_server
from seaweedfs_tpu_torch.filer.client import FilerClient as PortClient
from seaweedfs_tpu_torch.remote.remote_storage import S3RemoteStorage
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes

from test_torch_write_path import Cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = {"seaweedfs_tpu_torch": "port-mirror",
           "seaweedfs_tpu": "jax-mirror"}

PORTED = ("seaweedfs_tpu.s3", "seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server", "seaweedfs_tpu.filer")



globals().update(load_suite(
    "test_notification", PORTED, fixtures=("cluster",),
    overrides={"VolumeServer": port_volume_server},
    only=("test_s3_sink_mirrors_filer",)))


AK, SK = "SINKAK", "sinksecret"


def _objects(gw, bucket: str) -> dict:
    client = S3RemoteStorage(gw.url, AK, SK, bucket)
    return {key: client.read(key) for key, *_ in client.traverse()}


def test_filer_backup_s3_mirrors_as_the_jax_command(tmp_path, monkeypatch):
    """`filer.backup.s3` of either package, run as a command against one
    port filer, mirrors its creates, overwrites, renames and deletes into
    a bucket of its own on a port gateway: the same objects, the same
    offset file, and SIGTERM stops the port's with exit 0."""
    monkeypatch.setenv("SEAWEEDFS_TPU_FILER_META_PLANE", "0")
    c = Cluster(tmp_path, "port", racks=("r1",), size_limit_mb=64)
    src = FilerServer(c.url, store_path=str(tmp_path / "src.db")).start()
    dst = FilerServer(c.url, store_path=str(tmp_path / "dst.db")).start()
    gw = S3ApiServer(dst.filer, credentials={AK: SK}).start()
    procs, lines = {}, {}
    rng = np.random.default_rng(17)
    try:
        for module, bucket in BUCKETS.items():
            d = tmp_path / module
            d.mkdir()
            procs[module] = subprocess.Popen(
                [sys.executable, "-m", module, "filer.backup.s3", "-filer",
                 src.url, "-endpoint", gw.url, "-bucket", bucket,
                 "-accessKey", AK, "-secretKey", SK, "-prefix", "bk",
                 "-state", str(d / "s3.offset"), "-interval", "0.1"],
                cwd=str(d), stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True,
                env={**os.environ, "JAX_PLATFORMS": "cpu",
                     "PYTHONPATH": REPO})
            lines[module] = procs[module].stdout.readline()
        files = {f"/docs/f{i}.bin": rng.integers(
            0, 256, int(rng.integers(10, 300_000)), dtype=np.uint8).tobytes()
            for i in range(6)}
        for path, body in files.items():
            assert http_bytes("PUT", src.url + path, body)[0] == 201
        assert http_bytes("PUT", src.url + "/docs/f0.bin", b"v2")[0] == 201
        assert http_bytes("DELETE", src.url + "/docs/f1.bin")[0] == 204
        PortClient(src.url).rename("/docs/f2.bin", "/docs/moved.bin")
        want = {f"bk{p}": b for p, b in files.items()}
        want["bk/docs/f0.bin"] = b"v2"
        want.pop("bk/docs/f1.bin")
        want["bk/docs/moved.bin"] = want.pop("bk/docs/f2.bin")
        deadline = time.monotonic() + 30
        while any(_objects(gw, b) != want for b in BUCKETS.values()):
            assert time.monotonic() < deadline, {
                b: sorted(_objects(gw, b)) for b in BUCKETS.values()}
            time.sleep(0.2)
    finally:
        rcs = {}
        for module, p in procs.items():
            p.send_signal(signal.SIGTERM)
            try:
                rcs[module] = p.wait(60)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                p.stdout.close()
        gw.stop()
        dst.stop()
        src.stop()
        c.close()
    masked = {m: re.sub(r"\S+:\d+|/\S+offset", "X",
                        ln.replace(BUCKETS[m], "B"))
              for m, ln in lines.items()}
    assert masked["seaweedfs_tpu_torch"] == masked["seaweedfs_tpu"] == \
        "filer.backup.s3 X -> X/B/bk (offset state: X)\n"
    assert rcs["seaweedfs_tpu_torch"] == 0
    offsets = {m: json.loads((tmp_path / m / "s3.offset").read_text())
               for m in BUCKETS}
    assert offsets["seaweedfs_tpu_torch"]["sinceNs"] == \
        offsets["seaweedfs_tpu"]["sinceNs"] > 0
