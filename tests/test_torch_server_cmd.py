"""The port's all-in-one `server` and `version` commands on the CPU,
against the JAX package's.  Tolerance: exact equality of the banner
lines (addresses masked), of the bytes read back and of every shard
file.

- `server -filer -s3` of both packages (the port's with `-device cpu`):
  the same banner lines; an object PUT through the gateway reads back
  the same through the gateway and through the filer; `ec.encode`
  through each package's shell writes shards equal, byte for byte, to
  the other package's encoder run on a copy of the same `.dat`; SIGTERM
  stops the server with exit 0;
- `version` prints `<name> <version> (python <version>)` in both;
- `server -tierBackend` starts with the JAX package's banner.
"""

import os
import re
import shutil
import signal
import subprocess
import sys

import pytest

from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.shell.commands import CommandEnv as RefEnv
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as ref_encoder
from seaweedfs_tpu.storage.erasure_coding.ec_context import (
    ECContext as RefContext)
from seaweedfs_tpu_torch.s3 import auth
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.commands import CommandEnv
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import ECContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AK, SK = "SERVERAK", "serversecret"
MODULES = ("seaweedfs_tpu_torch", "seaweedfs_tpu")


def _start(module: str, d: str) -> "tuple[subprocess.Popen, list]":
    argv = [sys.executable, "-m", module, "server", "-filer", "-s3",
            "-s3.accessKey", AK, "-s3.secretKey", SK, "-dir", d,
            "-master.port", "0", "-volume.port", "0", "-filer.port", "0",
            "-s3.port", "0"]
    if module == "seaweedfs_tpu_torch":
        argv += ["-device", "cpu"]
    p = subprocess.Popen(argv, cwd=d, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu",
                              "PYTHONPATH": REPO})
    lines = [p.stdout.readline() for _ in range(3)]
    return p, lines


def _stop(p) -> int:
    p.send_signal(signal.SIGTERM)
    try:
        return p.wait(60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stdout.close()


def _shards(base: str) -> dict:
    out = {}
    for ext in [".ecx"] + [f".ec{i:02d}" for i in range(14)]:
        with open(base + ext, "rb") as f:
            out[ext] = f.read()
    return out


def test_server_runs_the_published_s3_deployment(tmp_path):
    banners, shards, twins, rcs = {}, {}, {}, {}
    payload = os.urandom(3 << 20) + b"tail"
    for module in MODULES:
        d = tmp_path / module
        d.mkdir()
        p, lines = _start(module, str(d))
        try:
            banners[module] = [re.sub(r"127\.0\.0\.1:\d+", "ADDR", ln)
                               for ln in lines]
            urls = dict(re.findall(r"(\w+) on (127\.0\.0\.1:\d+)",
                                   "".join(lines)))
            gw, filer, master = urls["s3"], urls["filer"], urls["master"]

            def s3(method, path, body=b""):
                h = auth.sign_request(method, gw, path, {}, {}, body, AK,
                                      SK)
                return http_bytes(method, f"{gw}{path}", body or None, h)
            assert s3("PUT", "/pub")[0] == 200
            assert s3("PUT", "/pub/obj.bin", payload)[0] == 200
            assert s3("GET", "/pub/obj.bin")[:2] == (200, payload)
            assert http_bytes("GET", f"{filer}/buckets/pub/obj.bin")[:2] \
                == (200, payload)
            e = http_json("GET", f"{filer}/__meta__/lookup?path="
                                 f"/buckets/pub/obj.bin")
            vids = {int(c["fileId"].split(",")[0]) for c in e["chunks"]}
            assert len(vids) == 1
            (vid,) = vids
            # the volume sealed (its index flushed), and a copy of it as
            # it stands for the other encoder
            r = http_json("POST", f"{urls['volume']}/admin/set_readonly",
                          {"volumeId": vid, "readOnly": True})
            assert "error" not in r, r
            twin = tmp_path / f"{module}-twin"
            twin.mkdir()
            for ext in (".dat", ".idx"):
                shutil.copy(d / f"{vid}{ext}", twin / f"{vid}{ext}")
            twins[module] = str(twin / str(vid))
            line = f"lock; ec.encode -volumeId={vid}; unlock"
            if module == "seaweedfs_tpu_torch":
                env = CommandEnv(master, filer=filer)
                outs = [run_command(env, c.strip())
                        for c in line.split(";")]
            else:
                env = RefEnv(master, filer=filer)
                outs = [ref_run_command(env, c.strip())
                        for c in line.split(";")]
            assert "14 shards" in outs[1], outs
            shards[module] = _shards(str(d / str(vid)))
            # the object reads back from the EC volume
            assert s3("GET", "/pub/obj.bin")[:2] == (200, payload)
        finally:
            rcs[module] = _stop(p)
    assert banners["seaweedfs_tpu_torch"] == banners["seaweedfs_tpu"] == [
        "master on ADDR, volume on ADDR\n", "filer on ADDR\n",
        "s3 on ADDR\n"]
    assert rcs["seaweedfs_tpu_torch"] == 0
    # each package's shards equal the other's encoder on the same .dat
    base = twins["seaweedfs_tpu_torch"]
    ref_encoder.write_sorted_file_from_idx(base)
    ref_encoder.write_ec_files(base, RefContext(10, 4))
    assert _shards(base) == shards["seaweedfs_tpu_torch"]
    base = twins["seaweedfs_tpu"]
    ec_encoder.write_sorted_file_from_idx(base)
    ec_encoder.write_ec_files(base, ECContext(10, 4, device="cpu"))
    assert _shards(base) == shards["seaweedfs_tpu"]


def test_version_format():
    outs = [subprocess.run([sys.executable, "-m", m, "version"],
                           capture_output=True, text=True, timeout=120,
                           cwd=REPO, env={**os.environ,
                                          "JAX_PLATFORMS": "cpu"}).stdout
            for m in MODULES]
    py = sys.version.split()[0]
    assert re.fullmatch(rf"seaweedfs-tpu-torch \d+\.\d+\.\d+ "
                        rf"\(python {re.escape(py)}\)\n", outs[0])
    assert re.fullmatch(rf"seaweedfs-tpu \d+\.\d+\.\d+ "
                        rf"\(python {re.escape(py)}\)\n", outs[1])
    assert outs[0].split()[1:] == outs[1].split()[1:]


@pytest.mark.parametrize("spec", ["127.0.0.1:9000,tier", "x"])
def test_server_refuses_the_tier_backend(spec, tmp_path):
    """`server -tierBackend` (refused while the tiers were not ported)
    registers the backend and starts as the JAX package's `server` does:
    the same banner, and SIGTERM stops it with exit 0."""
    banners, rcs = {}, {}
    for module in MODULES:
        d = tmp_path / module
        d.mkdir()
        argv = [sys.executable, "-m", module, "server", "-tierBackend", spec,
                "-dir", str(d), "-master.port", "0", "-volume.port", "0"]
        if module == "seaweedfs_tpu_torch":
            argv += ["-device", "cpu"]
        p = subprocess.Popen(argv, cwd=str(d), stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, text=True,
                             env={**os.environ, "JAX_PLATFORMS": "cpu",
                                  "PYTHONPATH": REPO})
        banners[module] = re.sub(r"\S+:\d+", "ADDR", p.stdout.readline())
        rcs[module] = _stop(p)
    assert banners["seaweedfs_tpu_torch"] == banners["seaweedfs_tpu"] == \
        "master on ADDR, volume on ADDR\n"
    assert rcs["seaweedfs_tpu_torch"] == 0
