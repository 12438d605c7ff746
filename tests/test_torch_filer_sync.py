"""filer.sync, filer.backup, filer.meta.tail and the filer's metadata
shell verbs on the CPU, the port against the JAX package: each package's
sync and backup between two filers over a cluster of its own package,
both filers in their default configuration (meta plane and native planes
on over sqlite files).  Tolerance: exact equality of bytes, listings
(fids and clocks masked where two clusters mint their own), offsets'
shape and the verbs' output; mutations seeded with numpy.

- a seeded history (files of 1 B - 9 MiB, directories, overwrites, a
  rename, a delete, attributes) converges on the target filer and in the
  backup directory byte for byte, with the JAX sync's listings, and a
  second pass applies nothing;
- an interrupted sync resumes from its state file (advanced after each
  applied event only, none when the target is down), and a state file of
  another direction is refused with the JAX message;
- the port's sync and backup read a JAX filer and write a JAX filer;
- `filer.meta.tail -once` prints the JAX command's lines;
- fs.meta.save / .load / .cat / .notify, fs.log, fs.verify,
  fs.meta.change.volume.id and fs.merge.volumes print what the JAX
  shell prints on the same history.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu.filer.filer_backup import FilerBackup as RefBackup
from seaweedfs_tpu.filer.filer_sync import FilerSync as RefSync
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.shell import CommandEnv as RefEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu_torch.filer.filer_backup import FilerBackup
from seaweedfs_tpu_torch.filer.filer_sync import FilerSync
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.shell import CommandEnv, run_command

from test_torch_filer import _mask
from test_torch_profiling import stop_background_probes
from test_torch_write_path import Cluster, _wait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": {"Filer": FilerServer, "Sync": FilerSync,
                 "Backup": FilerBackup, "Env": CommandEnv,
                 "run": run_command, "cluster": "port",
                 "module": "seaweedfs_tpu_torch"},
        "jax": {"Filer": RefFilerServer, "Sync": RefSync,
                "Backup": RefBackup, "Env": RefEnv,
                "run": ref_run_command, "cluster": "ref",
                "module": "seaweedfs_tpu"}}


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    """A cluster a package, with a source filer and a target filer."""
    saved = {k: os.environ.pop(k, None) for k in (
        "SEAWEEDFS_TPU_FILER_META_PLANE",
        "SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE")}
    made = []
    out = {}
    try:
        for kind, pkg in PKGS.items():
            tmp = tmp_path_factory.mktemp(f"sync_{kind}")
            c = Cluster(tmp, pkg["cluster"], racks=("r1", "r1"),
                        size_limit_mb=64)
            made.append(c)
            src = pkg["Filer"](c.url, store_path=str(tmp / "a.db")).start()
            made.append(src)
            dst = pkg["Filer"](c.url, store_path=str(tmp / "b.db")).start()
            made.append(dst)
            out[kind] = {"cluster": c, "src": src, "dst": dst, "tmp": tmp}
        yield out
    finally:
        for m in reversed(made):
            (m.close if isinstance(m, Cluster) else m.stop)()
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
        stop_background_probes()


def _history(url: str, root: str, seed: int) -> dict:
    """Seeded mutations under `root`; path -> the bytes it ends with."""
    rng = np.random.default_rng(seed)
    files = {}
    sizes = [1, 700, 4 << 20, (9 << 20) + 3] + \
        [int(rng.integers(1, 40000)) for _ in range(12)]
    for i, n in enumerate(sizes):
        path = f"{root}/d{i % 3}/f{i:02d}.bin"
        body = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert http_bytes("PUT", url + path, body,
                          {"Content-Type": "application/x-seeded"})[0] == 201
        files[path] = body
    assert http_bytes("PUT", f"{url}{root}/empty/")[0] == 201
    body = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    assert http_bytes("PUT", f"{url}{root}/d0/f00.bin", body)[0] == 201
    files[f"{root}/d0/f00.bin"] = body
    assert http_json("POST", f"{url}/__meta__/rename", {
        "oldPath": f"{root}/d1/f01.bin",
        "newPath": f"{root}/d2/renamed.bin"}) == {}
    files[f"{root}/d2/renamed.bin"] = files.pop(f"{root}/d1/f01.bin")
    assert http_bytes("DELETE", f"{url}{root}/d2/f02.bin")[0] == 204
    files.pop(f"{root}/d2/f02.bin")
    assert http_json("POST", f"{url}/__meta__/set_attrs", {
        "path": f"{root}/d0/f03.bin",
        "attributes": {"mode": 0o600, "mtime": 1.5, "crtime": 1.25,
                       "mime": "text/x"}}) == {}
    return files


def _tree(url: str, root: str) -> list:
    out = []
    for e in http_json("GET", f"{url}{root}/?limit=1000")["entries"]:
        j = _mask(e)
        j.get("attributes", {}).pop("mtime", None)
        out.append(j)
        if e.get("isDirectory"):
            out += _tree(url, e["fullPath"])
    return out


def _drain(syncer) -> int:
    n, total = 1, 0
    while n:
        n = syncer.sync_once()
        total += n
    return total


def test_sync_and_backup_converge_as_the_jax_ones(rigs, tmp_path):
    got = {}
    for kind, r in rigs.items():
        pkg = PKGS[kind]
        files = _history(r["src"].url, "/conv", 11)
        sync = pkg["Sync"](r["src"].url, r["dst"].url,
                           str(tmp_path / f"{kind}.sync"))
        bak = pkg["Backup"](r["src"].url, str(tmp_path / f"{kind}.bak"),
                            str(tmp_path / f"{kind}.bakstate"))
        applied = (_drain(sync), _drain(bak))
        for path, body in files.items():
            assert http_bytes("GET", r["dst"].url + path)[1] == body, path
            with open(str(tmp_path / f"{kind}.bak") + path, "rb") as f:
                assert f.read() == body, path
        mode = os.stat(str(tmp_path / f"{kind}.bak") +
                       "/conv/d0/f03.bin").st_mode & 0o777
        got[kind] = (applied, _tree(r["dst"].url, "/conv"),
                     sorted(os.path.relpath(os.path.join(d, f),
                                            tmp_path / f"{kind}.bak")
                            for d, _, fs in os.walk(
                                tmp_path / f"{kind}.bak") for f in fs),
                     mode, (sync.sync_once(), bak.sync_once()),
                     sorted(json.load(open(tmp_path / f"{kind}.sync"))))
    assert got["port"] == got["jax"]
    assert got["port"][3] == 0o600


def test_an_interrupted_sync_resumes_and_never_skips(rigs, tmp_path,
                                                   monkeypatch):
    r = rigs["port"]
    files = _history(r["src"].url, "/res", 12)
    state = str(tmp_path / "res.sync")
    first = FilerSync(r["src"].url, r["dst"].url, state)
    since = first.offset()
    assert first.sync_once(batch=5) == 5
    assert first.offset() > since
    # the target refuses every write: the batch fails, the offset stays
    from seaweedfs_tpu_torch.filer import filer_sync

    def refused(method, url, *a, **k):
        if url.startswith(r["dst"].url):
            raise OSError("target down")
        return http_bytes(method, url, *a, **k)
    monkeypatch.setattr(filer_sync, "http_bytes", refused)
    at = first.offset()
    with pytest.raises(OSError):
        first.sync_once(batch=5)
    assert first.offset() == at
    monkeypatch.undo()
    # a new syncer on the same state file picks up the rest
    _drain(FilerSync(r["src"].url, r["dst"].url, state))
    for path, body in files.items():
        assert http_bytes("GET", r["dst"].url + path)[1] == body
    # a state file of another direction is refused, as the JAX one is
    msgs = []
    for cls in (FilerSync, RefSync):
        with pytest.raises(RuntimeError) as e:
            cls(r["dst"].url, r["src"].url, state).offset()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "belongs to" in msgs[0]


def test_the_port_syncs_between_jax_filers(rigs, tmp_path):
    r = rigs["jax"]
    files = _history(r["src"].url, "/cross", 13)
    _drain(FilerSync(r["src"].url, r["dst"].url,
                     str(tmp_path / "cross.sync")))
    _drain(FilerBackup(r["src"].url, str(tmp_path / "bak"),
                       str(tmp_path / "bak.state")))
    for path, body in files.items():
        assert http_bytes("GET", r["dst"].url + path)[1] == body
        assert open(str(tmp_path / "bak") + path, "rb").read() == body


def _tail(module: str, url: str, *extra) -> list:
    p = subprocess.run([sys.executable, "-m", module, "filer.meta.tail",
                        "-filer", url, "-once", *extra],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr
    return p.stdout.splitlines()


def test_meta_tail_prints_the_jax_lines(rigs):
    r = rigs["port"]
    _history(r["src"].url, "/tail", 14)
    for extra in ((), ("-pathPrefix", "/tail/d1")):
        port = _tail("seaweedfs_tpu_torch", r["src"].url, *extra)
        ref = _tail("seaweedfs_tpu", r["src"].url, *extra)
        assert port == ref and port
    assert len(_tail("seaweedfs_tpu_torch", r["src"].url)) == \
        len(r["src"].filer.events_since(0))


def _verbs(kind: str, r, tmp_path) -> list:
    pkg = PKGS[kind]
    u = r["src"].url
    _history(u, "/verbs", 15)
    env = pkg["Env"](r["cluster"].url, filer=u)

    def run(line, raw=False):
        try:
            out = pkg["run"](env, line)
        except (RuntimeError, OSError, ValueError) as e:
            out = f"error: {e}"
        if raw:
            return out
        out = re.sub(r"\b\d{19}\b", "T", out)       # event stamps
        out = re.sub(r"\b\d+,[0-9a-f]{8,}\b", "FID", out)
        return out.replace(saved, "SAVED")
    saved = str(tmp_path / f"{kind}.jsonl")
    out = [run(f"fs.meta.save -o={saved} /verbs"),
           sorted(json.dumps(_mask(json.loads(x))) for x in
                  open(saved).read().splitlines()),
           _mask(json.loads(run("fs.meta.cat /verbs/d0/f03.bin",
                               raw=True))),
           run("fs.verify /verbs"),
           run("fs.log -n=4"),
           run("fs.meta.notify /verbs/d1"),
           run("fs.log -n=3")]
    # the metadata alone removed: fs.meta.load brings the entry back
    assert http_bytes("DELETE", f"{u}/verbs/d2/renamed.bin"
                                "?ignoreChunks=true")[0] == 204
    out.append(run(f"fs.meta.load {saved}"))
    out.append(http_bytes("GET", f"{u}/verbs/d2/renamed.bin")[0])
    vids = sorted({int(c["fileId"].split(",")[0])
                   for line in open(saved) for c in
                   json.loads(line).get("chunks") or []})
    out.append(run(f"fs.meta.change.volume.id -dir=/verbs "
                   f"-fromVolumeId={vids[0]} -toVolumeId=99"))
    out.append(run("fs.merge.volumes -fromVolumeId=5 -toVolumeId=5"))
    out.append(run("fs.meta.change.volume.id -dir=/verbs"))
    return out


def test_fs_verbs_print_what_the_jax_shell_prints(rigs, tmp_path):
    got = {k: _verbs(k, r, tmp_path) for k, r in rigs.items()}
    for i, (a, b) in enumerate(zip(got["port"], got["jax"])):
        assert a == b, i
    assert "0 broken" in got["port"][3]


def test_fs_merge_volumes_moves_chunks_and_keeps_bytes(rigs):
    """fs.merge.volumes -apply on the port: every chunk of the source
    volume rewritten onto the target volume, the files' bytes kept, the
    source needles deleted."""
    r = rigs["port"]
    u, m = r["src"].url, r["cluster"].url
    bodies = {f"/merge/f{i}": np.random.default_rng(i).integers(
        0, 256, 3000 + i, dtype=np.uint8).tobytes() for i in range(30)}
    for p, b in bodies.items():
        assert http_bytes("PUT", u + p, b)[0] == 201
    by_vid = {}
    for p in bodies:
        for c in http_json("GET", f"{u}/__meta__/lookup?path={p}")[
                "chunks"]:
            by_vid.setdefault(int(c["fileId"].split(",")[0]), set()).add(p)
    src = sorted(by_vid)[0]
    # a target volume the files do not use, grown for the merge
    dst = http_json("POST", f"{m}/vol/grow",
                    {"collection": "", "count": 1})["volumeIds"][0]
    _wait(lambda: dst in r["cluster"].volumes(), "the grown volume listed")
    env = CommandEnv(m, filer=u)
    out = run_command(env, f"fs.merge.volumes -fromVolumeId={src} "
                           f"-toVolumeId={dst} -dir=/merge -apply")
    assert out.startswith(f"moved {len(by_vid[src])} chunks"), out
    for p, b in bodies.items():
        assert http_bytes("GET", u + p)[1] == b
        assert all(int(c["fileId"].split(",")[0]) != src for c in
                   http_json("GET", f"{u}/__meta__/lookup?path={p}")[
                       "chunks"])


def _until_offset(state: str, ts: int) -> None:
    def reached():
        try:
            return json.load(open(state))["sinceNs"] >= ts
        except (OSError, ValueError, KeyError):
            return False
    _wait(reached, f"{state} reaches {ts}", timeout=120)


def test_the_sync_and_backup_commands_run_until_sigterm(rigs, tmp_path):
    """`filer.sync` and `filer.backup` on the command line: their first
    lines, their offsets reaching the source's last event, the bytes on
    the target and in the directory, and exit 0 on SIGTERM."""
    import signal
    r = rigs["port"]
    files = _history(r["src"].url, "/cli", 16)
    last = r["src"].filer.events_since(0)[-1]["tsNs"]
    runs = []
    for argv, first in (
            (["filer.sync", "-from", r["src"].url, "-to", r["dst"].url,
              "-state", str(tmp_path / "s.offset"), "-interval", "0.1"],
             f"filer.sync {r['src'].url} -> {r['dst'].url} (offset "
             f"state: {tmp_path / 's.offset'})"),
            (["filer.backup", "-filer", r["src"].url, "-dir",
              str(tmp_path / "bak"), "-state", str(tmp_path / "b.offset"),
              "-interval", "0.1"],
             f"filer.backup {r['src'].url} -> {tmp_path / 'bak'} (offset "
             f"state: {tmp_path / 'b.offset'})")):
        p = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch",
                              *argv], cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
        runs.append(p)
        assert p.stdout.readline().strip() == first
    try:
        _until_offset(str(tmp_path / "s.offset"), last)
        _until_offset(str(tmp_path / "b.offset"), last)
        for path, body in files.items():
            assert http_bytes("GET", r["dst"].url + path)[1] == body
            assert open(str(tmp_path / "bak") + path, "rb").read() == body
    finally:
        for p in runs:
            p.send_signal(signal.SIGTERM)
    assert [p.wait(30) for p in runs] == [0, 0]
