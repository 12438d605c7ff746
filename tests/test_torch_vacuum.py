"""The port's volume vacuum core (`seaweedfs_tpu_torch/storage/volume.py`)
and its offline tools on the CPU, against the JAX package's.
Tolerance: exact equality (bytes of `.dat`, `.idx` and `.vif`, live
needle sets, counts, error lists, tool output).

- compaction of copied inputs: byte-identical `.dat` and `.idx`, with
  the compaction revision + 1 and the 8-byte pad after a superblock
  extra blob of another length;
- writes, overwrites and deletes between `compact()` and
  `commit_compact()` (the `_makeup_diff` replay): the same live
  (key, bytes) set;
- `merge_from` of two diverged replicas, the newest tombstone included:
  byte-identical;
- `scrub` over a corrupted needle, `configure_replication` with
  `save_volume_info`, `walk_dat` over a deleted-marked record,
  `garbage_level`, and the discard of stale shadows;
- the offline `fix`, `compact` and `export` tools on copied volumes.

Volumes of 60-120 needles of up to 20 KB, written by the JAX package's
`Volume` under one fixed clock (`fixed_clock`), so both packages stamp
the same AppendAtNs.
"""

import contextlib
import io
import itertools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu import __main__ as ref_main
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.super_block import SuperBlock as RefSuperBlock
from seaweedfs_tpu_torch import __main__ as port_main
from seaweedfs_tpu_torch.storage import idx, types
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import SuperBlock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VID = 7


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages' volumes stamp AppendAtNs from one fixed clock that
    moves on at every stamp (a volume reopened later stamps after what
    it holds, as with the wall clock)."""
    ticks = itertools.count(1_700_000_000_000_000_000)

    def stamp(self):
        self.last_append_at_ns = max(next(ticks),
                                     self.last_append_at_ns + 1)
        return self.last_append_at_ns
    monkeypatch.setattr(port_volume.Volume, "_next_append_at_ns", stamp)
    monkeypatch.setattr(ref_volume.Volume, "_next_append_at_ns", stamp)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _seed(d: str, seed: int = 0, n: int = 80, extra: bytes = b"",
          collection: str = "") -> dict:
    """A volume written by the JAX package: needles of 1 B-20 KB (some
    named, some with a mime type), a third deleted, a few overwritten.
    Returns the live {key: data}."""
    os.makedirs(d, exist_ok=True)
    if extra:
        name = (f"{collection}_" if collection else "") + f"{VID}.dat"
        with open(os.path.join(d, name), "wb") as f:
            f.write(RefSuperBlock(extra=extra).to_bytes())
    rng = np.random.default_rng(seed)
    v = ref_volume.Volume(d, VID, collection=collection)
    live = {}
    for key in range(1, n + 1):
        nd = RefNeedle(cookie=key, id=key,
                       data=rng.bytes(int(rng.integers(1, 20_000))))
        if key % 5 == 0:
            nd.set_name(f"file-{key}.bin".encode())
        if key % 7 == 0:
            nd.set_mime(b"image/png")
        v.write_needle(nd)
        live[key] = nd.data
    for key in range(1, n + 1, 3):
        v.delete_needle(RefNeedle(cookie=key, id=key))
        live.pop(key)
    for key in range(2, n + 1, 11):
        if key in live:
            nd = RefNeedle(cookie=key, id=key, data=rng.bytes(300))
            v.write_needle(nd)
            live[key] = nd.data
    v.close()
    return live


def _pair(tmp_path, **kw) -> "tuple[str, str, dict]":
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    live = _seed(a, **kw)
    shutil.copytree(a, b)
    return a, b, live


def _files(d: str, exts=(".dat", ".idx")) -> dict:
    return {ext: _read(os.path.join(d, f"{VID}{ext}")) for ext in exts}


def _live(v) -> dict:
    return {key: v.read_needle(key).data for key, _o, _s in v.nm.items()}


@pytest.mark.parametrize("extra", [b"", b"\x01\x02\x03\x04\x05"],
                         ids=["plain", "extra5"])
def test_compaction_is_byte_identical(tmp_path, fixed_clock, extra):
    a, b, live = _pair(tmp_path, extra=extra)
    before = os.path.getsize(os.path.join(b, f"{VID}.dat"))
    for d, cls in ((a, ref_volume.Volume), (b, port_volume.Volume)):
        v = cls(d, VID)
        v.vacuum()
        v.vacuum()                   # the revision counts each commit
        v.close()
    assert _files(a) == _files(b)
    dat = _files(b)[".dat"]
    sb = SuperBlock.parse(dat)
    assert sb.compaction_revision == 2 and sb.extra == extra
    first = (sb.block_size() + 7) // 8 * 8
    assert dat[sb.block_size():first] == b"\x00" * (first - sb.block_size())
    assert len(dat) < before
    v = port_volume.Volume(b, VID)
    assert _live(v) == live
    assert v.garbage_level() == 0.0
    v.close()


def test_makeup_diff_replays_the_same_live_set(tmp_path, fixed_clock):
    a, b, live = _pair(tmp_path, seed=1)
    results = []
    for d, cls, ncls in ((a, ref_volume.Volume, RefNeedle),
                         (b, port_volume.Volume, Needle)):
        rng = np.random.default_rng(9)
        v = cls(d, VID)
        v.compact()
        # between the snapshot and the commit: new keys, an overwrite,
        # deletes of an old key and of a key written after the snapshot
        for key in range(200, 220):
            v.write_needle(ncls(cookie=key, id=key, data=rng.bytes(
                int(rng.integers(1, 5000)))))
        v.write_needle(ncls(cookie=2, id=2, data=b"overwritten"))
        v.delete_needle(ncls(cookie=5, id=5))
        v.delete_needle(ncls(cookie=205, id=205))
        replayed = v.commit_compact()
        results.append((_live(v), replayed))
        v.close()
    (ref_live, _), (port_live, replayed) = results
    assert port_live == ref_live
    assert replayed == 20 + 1 + 2
    assert port_live[2] == b"overwritten" and 5 not in port_live \
        and 205 not in port_live and 219 in port_live
    # what the port wrote reads back the same in the JAX package
    v = ref_volume.Volume(b, VID)
    assert _live(v) == port_live
    v.close()


def test_merge_is_byte_identical_and_keeps_the_newest_tombstone(
        tmp_path, fixed_clock):
    r0 = str(tmp_path / "r0")
    live = _seed(r0, seed=2, n=40)
    r1 = str(tmp_path / "r1")
    shutil.copytree(r0, r1)
    shared = next(iter(live))
    v = ref_volume.Volume(r0, VID)
    v.write_needle(RefNeedle(cookie=900, id=900, data=b"only-on-r0"))
    v.close()
    v = ref_volume.Volume(r1, VID)
    v.write_needle(RefNeedle(cookie=901, id=901, data=b"only-on-r1"))
    v.delete_needle(RefNeedle(cookie=shared, id=shared))
    v.close()
    outs = {}
    for name, cls in (("ref", ref_volume.Volume), ("port", port_volume.Volume)):
        d = str(tmp_path / f"merge-{name}")
        shutil.copytree(r0, d)
        v = cls(d, VID)
        v.read_only = True
        merged = v.merge_from([os.path.join(r1, f"{VID}.dat")])
        outs[name] = (merged, _live(v), _files(d))
        v.close()
    assert outs["port"] == outs["ref"]
    merged, got, _ = outs["port"]
    assert got[900] == b"only-on-r0" and got[901] == b"only-on-r1"
    assert shared not in got and merged == len(live) - 1 + 2
    v = port_volume.Volume(str(tmp_path / "merge-port"), VID)
    with pytest.raises(PermissionError):
        v.merge_from([])             # writable: refused
    v.close()


def test_scrub_reports_the_same_errors(tmp_path):
    a, b, live = _pair(tmp_path, seed=3)
    victim = sorted(live)[len(live) // 2]
    for d in (a, b):
        entries = idx.live_entries(_read(os.path.join(d, f"{VID}.idx")))
        off = types.to_actual_offset(entries[victim][0])
        with open(os.path.join(d, f"{VID}.dat"), "r+b") as f:
            f.seek(off + types.NEEDLE_HEADER_SIZE + 8)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
    got = []
    for d, cls in ((a, ref_volume.Volume), (b, port_volume.Volume)):
        v = cls(d, VID)
        got.append(v.scrub())
        v.close()
    assert got[0] == got[1]
    count, errors = got[1]
    assert count == len(live) and len(errors) == 1
    assert errors[0].startswith(f"needle {victim:x}: ")


def test_configure_replication_and_volume_info(tmp_path):
    a, b, _ = _pair(tmp_path, seed=4)
    for d, cls in ((a, ref_volume.Volume), (b, port_volume.Volume)):
        v = cls(d, VID)
        v.configure_replication("010")
        v.save_volume_info()
        assert v.volume_info.replication == "010"
        v.close()
    assert _files(a, (".dat", ".idx", ".vif")) == \
        _files(b, (".dat", ".idx", ".vif"))
    v = port_volume.Volume(b, VID)
    assert str(v.super_block.replica_placement) == "010"
    assert v.volume_info.replication == "010"   # read back from the .vif
    v.close()


def test_walk_dat_and_garbage_level(tmp_path):
    a, b, live = _pair(tmp_path, seed=5, n=30)
    # a record deleted in place: its size's high bit set
    key = sorted(live)[0]
    for d in (a, b):
        entries = idx.live_entries(_read(os.path.join(d, f"{VID}.idx")))
        off = types.to_actual_offset(entries[key][0])
        with open(os.path.join(d, f"{VID}.dat"), "r+b") as f:
            f.seek(off + 12)
            size = int.from_bytes(f.read(4), "big")
            f.seek(off + 12)
            f.write((size | 0x80000000).to_bytes(4, "big"))

    def scan(mod, d):
        return [(n.id, n.size, n.data, n.cookie, n.append_at_ns, off)
                for n, off in mod.walk_dat(os.path.join(d, f"{VID}.dat"))]
    ref_recs, port_recs = scan(ref_volume, a), scan(port_volume, b)
    assert port_recs == ref_recs
    assert any(r[0] == key and r[2] == b"" and r[1] > 0 for r in port_recs)
    levels = []
    for d, cls in ((a, ref_volume.Volume), (b, port_volume.Volume)):
        v = cls(d, VID)
        levels.append((v.garbage_level(), v.content_size(),
                       v.deleted_bytes()))
        v.close()
    assert levels[0] == levels[1] and levels[1][0] > 0


@pytest.mark.parametrize("cls", [ref_volume.Volume, port_volume.Volume],
                         ids=["ref", "port"])
def test_compact_discards_stale_shadow(tmp_path, cls):
    v = cls(str(tmp_path), 20)
    v.write_needle(Needle(cookie=1, id=1, data=b"live"))
    # shadows of a crashed earlier compaction
    with open(v.file_name(".cpx"), "wb") as f:
        f.write(b"\x00" * 32)
    with open(v.file_name(".cpd"), "wb") as f:
        f.write(b"garbage")
    v.vacuum()
    assert v.read_needle(1).data == b"live"
    assert v.nm.metrics.file_count == 1
    v.close()


def _run_tool(main, argv) -> "tuple[int, str]":
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("tool", ["fix", "compact", "export", "export_tar"])
def test_offline_tools_match_the_reference(tmp_path, tool):
    a, b, live = _pair(tmp_path, seed=6, collection="")
    if tool == "fix":
        for d in (a, b):
            os.remove(os.path.join(d, f"{VID}.idx"))
    outs = []
    for d, main in ((a, ref_main.main), (b, port_main.main)):
        argv = [tool.split("_")[0], "-dir", d, "-volumeId", str(VID)]
        if tool == "export_tar":
            argv += ["-o", os.path.join(d, "out.tar")]
        rc, text = _run_tool(main, argv)
        outs.append((rc, text.replace(d, "D")))
    assert outs[1] == outs[0] and outs[1][0] == 0
    exts = {"fix": (".idx",), "compact": (".dat", ".idx")}.get(tool, ())
    assert _files(a, exts) == _files(b, exts)
    if tool == "export_tar":
        assert _read(os.path.join(a, "out.tar")) == \
            _read(os.path.join(b, "out.tar"))
    if tool == "export":
        assert f"{len(live)} live files" in outs[1][1]
    v = port_volume.Volume(b, VID)
    assert _live(v) == live
    v.close()


def test_offline_tool_command_line(tmp_path):
    """`python -m seaweedfs_tpu_torch compact` as a user runs it, and a
    volume id with no files refused without creating any."""
    _seed(str(tmp_path), seed=8, n=20)
    r = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "compact", "-dir",
         str(tmp_path), "-volumeId", str(VID)],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"compacted volume {VID}: ")
    r = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "fix", "-dir",
         str(tmp_path), "-volumeId", "99"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 1 and "no " in r.stderr
    assert not any(n.startswith("99.") for n in os.listdir(tmp_path))
