"""TUS resumable uploads through the port's filer on the CPU, against the
JAX filer: each over a cluster of its own package, both in their default
configuration (the meta plane and the native planes on over a sqlite
file).  Tolerance: exact equality of status codes, the protocol's headers
and the bytes read back; only the upload id in `Location` differs.
Payloads are seeded with numpy.

- the protocol: creation, PATCHes at the offset (a stale offset 409),
  the HEAD probe, termination, an upload past its length (413), unknown
  and empty ids (404), OPTIONS;
- the stitched file is visible to the very next GET on this filer and
  on a sibling filer over the same store, byte for byte, and its staging
  directory is gone;
- an upload resumes after the filer restarts over its store, and an
  upload that a JAX filer staged resumes on the port's filer over the
  same store and metalog;
- an overwrite by TUS reclaims the replaced file's chunks.
"""

import os

import numpy as np
import pytest

from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu_torch import operation
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json

from test_torch_profiling import stop_background_probes
from test_torch_write_path import Cluster, _wait

TUS = {"Tus-Resumable": "1.0.0"}
PROTO = ("Tus-Resumable", "Tus-Version", "Tus-Extension", "Upload-Offset",
         "Upload-Length", "Cache-Control")


def _seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    """A port cluster with a port filer and a JAX cluster with a JAX
    filer, each over a sqlite file, meta plane and native planes on."""
    saved = {k: os.environ.pop(k, None) for k in (
        "SEAWEEDFS_TPU_FILER_META_PLANE",
        "SEAWEEDFS_TPU_FILER_READ_PLANE_NATIVE")}
    made = []
    out = {}
    try:
        for kind in ("port", "jax"):
            tmp = tmp_path_factory.mktemp(f"tus_{kind}")
            c = Cluster(tmp, "port" if kind == "port" else "ref",
                        racks=("r1", "r1"), size_limit_mb=64)
            made.append(c)
            cls = FilerServer if kind == "port" else RefFilerServer
            fs = cls(c.url, store_path=str(tmp / "filer.db")).start()
            made.append(fs)
            out[kind] = {"cluster": c, "filer": fs, "tmp": tmp, "cls": cls}
        yield out
    finally:
        for m in reversed(made):
            (m.close if isinstance(m, Cluster) else m.stop)()
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
        stop_background_probes()


def _req(url, method, path, body=None, headers=None):
    st, data, h = http_bytes(method, f"{url}{path}", body,
                             {**TUS, **(headers or {})}, timeout=30)
    return st, data, {k: h[k] for k in PROTO if k in h}, h.get("Location")


def _script(url: str, payload: bytes, target: str) -> list:
    """The protocol's answers over one upload, Location masked."""
    out = []
    st, _, h, loc = _req(url, "POST", f"/__tus__/?path={target}", None,
                         {"Upload-Length": str(len(payload))})
    out.append((st, h, loc.startswith("/__tus__/")))
    third = len(payload) // 3
    for lo, hi in ((0, third), (0, 5), (third, 2 * third)):
        out.append(_req(url, "PATCH", loc, payload[lo:hi],
                        {"Upload-Offset": str(lo)})[:3])
    out.append(_req(url, "HEAD", loc)[::2])
    out.append(_req(url, "PATCH", loc, payload[2 * third:],
                    {"Upload-Offset": str(2 * third)})[::2])
    # the very next GET sees the stitched file
    st, body, _ = http_bytes("GET", f"{url}{target}", timeout=30)
    out.append((st, body == payload, len(body)))
    out.append(_req(url, "HEAD", loc)[0])
    out.append(http_json("GET", f"{url}/.tus/").get("entries"))
    return out


@pytest.mark.parametrize("seed,size", [(0, 1000), (1, 3 << 20),
                                       (2, 9 << 20 | 77)])
def test_upload_answers_as_the_jax_filer(rigs, seed, size):
    payload = _seeded(seed, size)
    got = {k: _script(r["filer"].url, payload, f"/up/s{seed}.bin")
           for k, r in rigs.items()}
    assert got["port"] == got["jax"]
    assert got["port"][-3] == (200, True, size)


def test_overflow_abort_and_unknown_ids_answer_as_the_jax_filer(rigs):
    got = {}
    for kind, r in rigs.items():
        u = r["filer"].url
        _, _, _, loc = _req(u, "POST", "/__tus__/?path=/up/x.bin", None,
                            {"Upload-Length": "10"})
        got[kind] = [
            _req(u, "OPTIONS", "/__tus__/")[::2],
            _req(u, "POST", "/__tus__/?path=/up/y", None, {})[0],
            _req(u, "PATCH", loc, b"0123456789AB",
                 {"Upload-Offset": "0"})[0],
            _req(u, "PATCH", loc, b"01234", {"Upload-Offset": "x"})[::2],
            _req(u, "GET", loc)[0],
            _req(u, "DELETE", loc)[::2],
            _req(u, "HEAD", loc)[0],
            _req(u, "DELETE", "/__tus__/")[0],
            _req(u, "HEAD", "/__tus__/nope")[0],
            _req(u, "HEAD", "/__tus__/a/b")[0],
            http_json("GET", f"{u}/.tus/").get("entries")]
    assert got["port"] == got["jax"]


def test_a_sibling_filer_reads_the_stitched_file_at_once(rigs):
    """A second port filer over the same store (a fleet sibling's shape,
    on a port of its own): the file stitched through the first answers
    on the second's very next GET, as on the first's."""
    r = rigs["port"]
    sib = FilerServer(r["cluster"].url,
                      store_path=str(r["tmp"] / "filer.db")).start()
    try:
        for i in range(4):
            payload = _seeded(10 + i, (1 << 20) + i)
            u = r["filer"].url
            _, _, _, loc = _req(u, "POST", f"/__tus__/?path=/sib/f{i}",
                                None, {"Upload-Length": str(len(payload))})
            assert _req(u, "PATCH", loc, payload,
                        {"Upload-Offset": "0"})[0] == 204
            st, body, _ = http_bytes("GET", f"{sib.url}/sib/f{i}")
            assert (st, body == payload) == (200, True)
            st, body, _ = http_bytes("GET", f"{u}/sib/f{i}")
            assert (st, body == payload) == (200, True)
    finally:
        sib.stop()


@pytest.mark.parametrize("first", ["port", "jax"])
def test_an_upload_resumes_after_a_restart(rigs, first, tmp_path):
    """Half an upload staged, the filer stopped; a port filer started
    over the same store and metalog answers the HEAD probe with the
    staged offset and takes the rest (the first filer a port or a JAX
    one: its staging opens in the port's filer)."""
    r = rigs["port"]
    db = str(tmp_path / "resume.db")
    cls = FilerServer if first == "port" else RefFilerServer
    fs = cls(r["cluster"].url, store_path=db).start()
    payload = _seeded(7, (5 << 20) + 3)
    half = len(payload) // 2
    _, _, _, loc = _req(fs.url, "POST", "/__tus__/?path=/r/big", None,
                        {"Upload-Length": str(len(payload))})
    assert _req(fs.url, "PATCH", loc, payload[:half],
                {"Upload-Offset": "0"})[0] == 204
    fs.stop()
    fs = FilerServer(r["cluster"].url, store_path=db).start()
    try:
        st, _, h, _ = _req(fs.url, "HEAD", loc)
        assert (st, h["Upload-Offset"], h["Upload-Length"]) == \
            (200, str(half), str(len(payload)))
        assert _req(fs.url, "PATCH", loc, payload[half:],
                    {"Upload-Offset": str(half)})[2]["Upload-Offset"] == \
            str(len(payload))
        st, body, _ = http_bytes("GET", f"{fs.url}/r/big")
        assert (st, body == payload) == (200, True)
    finally:
        fs.stop()


def test_a_tus_overwrite_reclaims_the_old_chunks(rigs):
    r = rigs["port"]
    u, m = r["filer"].url, r["cluster"].url
    assert http_bytes("PUT", f"{u}/ow/f", _seeded(3, 4096))[0] == 201
    old = http_json("GET", f"{u}/__meta__/lookup?path=/ow/f")["chunks"]
    payload = _seeded(4, 5000)
    _, _, _, loc = _req(u, "POST", "/__tus__/?path=/ow/f", None,
                        {"Upload-Length": str(len(payload))})
    assert _req(u, "PATCH", loc, payload, {"Upload-Offset": "0"})[0] == 204
    assert http_bytes("GET", f"{u}/ow/f")[1] == payload

    def gone():
        try:
            operation.read(m, old[0]["fileId"])
        except (OSError, RuntimeError, LookupError):
            return True
        return False
    _wait(gone, "the replaced chunk deleted")
