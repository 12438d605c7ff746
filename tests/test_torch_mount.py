"""The port's mount (`seaweedfs_tpu_torch/mount/`) on the CPU, against
the JAX package's.  Tolerance: exact equality of `getattr` (times
masked), `readdir`, `read` and errno results.  Payloads are seeded with
numpy.

- the JAX suite `test_mount.py` runs whole on the port
  (`jax_suite.load_suite`), its kernel mount through `python -m
  seaweedfs_tpu_torch mount` where mount(2) is permitted;
- across the packages: one op sequence (create, writes of 1 MiB and less,
  read-back while dirty, release, a writable reopen that patches in
  place, truncate, mkdir, rename, chmod, unlink, rmdir and the errnos of
  the refused ops) driven by each package's `WeedFS` over each package's
  filer gives the same `getattr`, `readdir` and `read` results;
- stale reads: right after a mount `rename` or `unlink`, the old path
  reads 404 through the filer's Python port and its native read plane,
  ENOENT through the op table's attribute cache, and the new path its
  bytes.
"""

import errno
import os

import pytest

from jax_suite import load_suite, port_volume_server
from seaweedfs_tpu.mount import FuseError as RefFuseError
from seaweedfs_tpu.mount import WeedFS as RefWeedFS
from seaweedfs_tpu_torch.mount import FuseError, WeedFS

from test_torch_gateways import (assert_gone, assert_moved, filer_rig,
                                 seeded, warm_plane)

PORTED = ("seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server",
          "seaweedfs_tpu.server.volume_server", "seaweedfs_tpu.mount",
          "seaweedfs_tpu.filer")

globals().update(load_suite(
    "test_mount", PORTED, fixtures=("cluster", "fs"),
    overrides={"VolumeServer": port_volume_server},
    replace={'"-m", "seaweedfs_tpu", "mount"':
             '"-m", "seaweedfs_tpu_torch", "mount"'}))

WEEDFS = {"port": (WeedFS, FuseError), "jax": (RefWeedFS, RefFuseError)}


@pytest.fixture(scope="module")
def filers(tmp_path_factory):
    """kind -> filer url: a port and a JAX filer, each over its own
    package's cluster."""
    tmp = tmp_path_factory.mktemp("mount_x")
    with filer_rig(tmp, "port") as (_c, pfs), \
            filer_rig(tmp, "jax") as (_rc, rfs):
        yield {"port": pfs.url, "jax": rfs.url}


def _stat(st: dict) -> dict:
    return {k: v for k, v in st.items() if not k.endswith("time")}


def _ops(kind: str, furl: str, root: str) -> list:
    """One op sequence under `root`; every result that reads back."""
    cls, err = WEEDFS[kind]
    w = cls(furl, attr_ttl=0.2)
    out = []

    def rec(fn, *a):
        try:
            r = fn(*a)
        except err as e:
            r = ("errno", e.errno)
        out.append(_stat(r) if isinstance(r, dict) else r)

    big = seeded(310, 3 * (1 << 20) + 4097)
    small = seeded(311, 5000)
    try:
        w.mkdir(root)
        rec(w.mkdir, root)
        w.create(f"{root}/big.bin")
        for off in range(0, len(big), 1 << 20):
            w.write(f"{root}/big.bin", big[off:off + (1 << 20)], off)
        rec(w.read, f"{root}/big.bin", 4096, (1 << 20) - 10)
        rec(w.getattr, f"{root}/big.bin")
        w.release(f"{root}/big.bin")
        w.create(f"{root}/s.txt", 0o640)
        w.write(f"{root}/s.txt", small, 0)
        w.release(f"{root}/s.txt")
        w.open(f"{root}/s.txt", os.O_RDWR)
        w.write(f"{root}/s.txt", b"PATCH", 100)
        w.release(f"{root}/s.txt")
        rec(w.read, f"{root}/s.txt", 200, 0)
        w.truncate(f"{root}/s.txt", 3000)
        rec(w.getattr, f"{root}/s.txt")
        w.mkdir(f"{root}/d")
        w.rename(f"{root}/s.txt", f"{root}/d/t.txt")
        w.chmod(f"{root}/d/t.txt", 0o600)
        rec(w.getattr, f"{root}/d/t.txt")
        rec(w.getattr, f"{root}/s.txt")
        rec(w.readdir, root)
        rec(w.readdir, f"{root}/d")
        rec(w.readdir, f"{root}/big.bin")
        rec(w.getattr, root)
        rec(w.rmdir, f"{root}/d")
        rec(w.unlink, f"{root}/d")
        rec(w.read, f"{root}/d/t.txt", 10_000, 0)
        rec(w.read, f"{root}/big.bin", 1 << 20, 2 << 20)
        rec(w.read, f"{root}/big.bin", 100, len(big) + 5)
        w.unlink(f"{root}/d/t.txt")
        rec(w.rmdir, f"{root}/d")
        rec(w.readdir, root)
        rec(w.open, f"{root}/nope", os.O_RDONLY)
        rec(w.write, f"{root}/nope", b"x", 0)
        rec(w.statfs, root)
    finally:
        w.close()
    return out


@pytest.mark.parametrize("filer", ["port", "jax"])
def test_op_sequence_matches_across_packages(filers, filer):
    """Each package's op table over `filer`'s filer: the port's over the
    JAX filer and the JAX one over the port's are held to the other."""
    port = _ops("port", filers[filer], "/ops_port")
    ref = _ops("jax", filers[filer], "/ops_jax")
    assert port == ref
    assert port[0] == ("errno", errno.EEXIST)
    big = seeded(310, 3 * (1 << 20) + 4097)
    assert port[1] == big[(1 << 20) - 10:(1 << 20) + 4086]
    assert port[2]["st_size"] == len(big)
    assert port[4]["st_size"] == 3000
    assert port[5]["st_mode"] & 0o777 == 0o600
    assert port[6] == ("errno", errno.ENOENT)
    assert port[9] == ("errno", errno.ENOTDIR)
    assert port[11] == ("errno", errno.ENOTEMPTY)
    assert port[14] == big[2 << 20:3 << 20] and port[15] == b""


def test_rename_and_unlink_are_seen_at_once(filers):
    furl = filers["port"]
    body = seeded(312, 70_000)
    w = WeedFS(furl, attr_ttl=5.0)
    try:
        w.mkdir("/mst")
        for i in range(3):
            old, new = f"/mst/a{i}.bin", f"/mst/b{i}.bin"
            w.create(old)
            w.write(old, body, 0)
            w.release(old)
            warm_plane(furl, old, body)
            assert w.getattr(old)["st_size"] == len(body)   # cached
            w.rename(old, new)
            assert_moved(furl, old, new, body)
            with pytest.raises(FuseError) as e:
                w.getattr(old)
            assert e.value.errno == errno.ENOENT
            assert w.getattr(new)["st_size"] == len(body)
            assert w.read(new, len(body), 0) == body
            warm_plane(furl, new, body)
            w.unlink(new)
            assert_gone(furl, new, body)
            with pytest.raises(FuseError):
                w.getattr(new)
            assert f"b{i}.bin" not in w.readdir("/mst")
    finally:
        w.close()
