"""The port's WebDAV gateway (`seaweedfs_tpu_torch/server/webdav_server.py`)
on the CPU, against the JAX package's.  Tolerance: exact equality of
statuses, of the headers that carry content (`Content-Range`,
`Content-Length`, `Content-Type`, `DAV`, `Allow`), of bodies, and of
multistatus documents with their dates masked.  Payloads are seeded with
numpy.

- the JAX suite `test_webdav.py` runs whole on the port
  (`jax_suite.load_suite`): both attachment modes (an in-process `Filer`
  and the `FilerClient` that `webdav -filer` uses);
- one request sequence (OPTIONS, MKCOL, PUT, PROPFIND at depths 0 and 1,
  whole, ranged, suffix and unsatisfiable GETs, HEAD, MOVE, COPY with and
  without `Overwrite: F`, DELETE) against both packages' gateways, each
  over its own package's filer through its `FilerClient`, gives the same
  transcript;
- stale reads: right after a WebDAV MOVE or DELETE, the old path reads
  404 through the filer's Python port, its native read plane and the
  gateway, and the new path its bytes.
"""

import re

import pytest

from jax_suite import load_suite, port_volume_server
from seaweedfs_tpu.filer.client import FilerClient as RefFilerClient
from seaweedfs_tpu.server.webdav_server import WebDavServer as RefWebDav
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.server.httpd import http_bytes
from seaweedfs_tpu_torch.server.webdav_server import WebDavServer

from test_torch_gateways import (assert_gone, assert_moved, filer_rig,
                                 seeded, warm_plane)

PORTED = ("seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server",
          "seaweedfs_tpu.server.volume_server",
          "seaweedfs_tpu.server.webdav_server", "seaweedfs_tpu.filer",
          "seaweedfs_tpu.security", "seaweedfs_tpu import security")

globals().update(load_suite("test_webdav", PORTED, fixtures=("dav",),
                            overrides={"VolumeServer": port_volume_server}))

KEEP = ("Content-Range", "Content-Length", "Content-Type", "DAV", "Allow",
        "MS-Author-Via")
DATE = re.compile(rb"<D:getlastmodified>[^<]*</D:getlastmodified>")


@pytest.fixture(scope="module")
def gateways(tmp_path_factory):
    """kind -> (WebDAV gateway url, filer url), each package's gateway
    over its own package's filer through its `FilerClient`."""
    tmp = tmp_path_factory.mktemp("dav_x")
    with filer_rig(tmp, "port") as (_c, pfs), \
            filer_rig(tmp, "jax") as (_rc, rfs):
        davs = {"port": WebDavServer("", FilerClient(pfs.url)).start(),
                "jax": RefWebDav("", RefFilerClient(rfs.url)).start()}
        try:
            yield {"port": (davs["port"].url, pfs.url),
                   "jax": (davs["jax"].url, rfs.url)}
        finally:
            for d in davs.values():
                d.stop()


A = seeded(300, 1_500_000)
B = seeded(301, 4_000)
SEQUENCE = [
    ("OPTIONS", "/", None, {}),
    ("MKCOL", "/x/docs", None, {}),
    ("MKCOL", "/x/docs", None, {}),
    ("PUT", "/x/docs/a.bin", A, {"Content-Type": "application/x-a"}),
    ("PUT", "/x/docs/b.txt", B, {"Content-Type": "text/plain"}),
    ("PUT", "/x/docs/sub/c.bin", B[:10], {}),
    ("PROPFIND", "/x/docs", None, {"Depth": "0"}),
    ("PROPFIND", "/x/docs", None, {"Depth": "1"}),
    ("PROPFIND", "/x/docs/a.bin", None, {"Depth": "1"}),
    ("PROPFIND", "/x/none", None, {"Depth": "1"}),
    ("GET", "/x/docs/a.bin", None, {}),
    ("GET", "/x/docs/a.bin", None, {"Range": "bytes=1000-600999"}),
    ("GET", "/x/docs/a.bin", None, {"Range": "bytes=-100"}),
    ("GET", "/x/docs/a.bin", None, {"Range": "bytes=2000000-"}),
    ("HEAD", "/x/docs/b.txt", None, {"Range": "bytes=2-5"}),
    ("GET", "/x/docs", None, {}),
    ("MOVE", "/x/docs/b.txt", None, {"Destination": "/x/docs/m.txt"}),
    ("GET", "/x/docs/b.txt", None, {}),
    ("COPY", "/x/docs/m.txt", None, {"Destination": "/x/docs/c.txt"}),
    ("COPY", "/x/docs/m.txt", None, {"Destination": "/x/docs/c.txt",
                                     "Overwrite": "F"}),
    ("MOVE", "/x/docs/a.bin", None, {"Destination": "/x/docs/c.txt"}),
    ("GET", "/x/docs/c.txt", None, {}),
    ("DELETE", "/x/docs/c.txt", None, {}),
    ("DELETE", "/x/docs/c.txt", None, {}),
    ("MOVE", "/x/docs/none", None, {"Destination": "/x/docs/n2"}),
    ("MOVE", "/x/docs/m.txt", None, {}),
    ("PROPFIND", "/x/docs", None, {"Depth": "1"}),
    ("DELETE", "/x/docs", None, {}),
    ("PROPFIND", "/x", None, {"Depth": "1"}),
]


def _transcript(dav: str) -> list:
    out = []
    for method, path, body, headers in SEQUENCE:
        st, got, h = http_bytes(method, dav + path, body, headers)
        out.append((method, path, st, {k: h[k] for k in KEEP if k in h},
                    DATE.sub(b"<D:getlastmodified/>", got)))
    return out


def test_request_sequence_matches_the_jax_gateway(gateways):
    port = _transcript(gateways["port"][0])
    ref = _transcript(gateways["jax"][0])
    assert port == ref
    assert [x[2] for x in port] == [
        200, 201, 405, 201, 201, 201, 207, 207, 207, 404, 200, 206, 206,
        416, 206, 405, 201, 404, 201, 412, 204, 200, 204, 404, 404, 400,
        207, 204, 207]
    assert port[10][4] == A and port[11][4] == A[1000:601000]
    assert port[12][4] == A[-100:] and port[21][4] == A


def test_move_and_delete_are_seen_at_once(gateways):
    dav, furl = gateways["port"]
    body = seeded(302, 60_000)
    for i in range(3):
        old, new = f"/st/d{i}/a.bin", f"/st/d{i}/b.bin"
        assert http_bytes("PUT", dav + old, body)[0] == 201
        warm_plane(furl, old, body)
        assert http_bytes("MOVE", dav + old, None,
                          {"Destination": new})[0] == 201
        assert_moved(furl, old, new, body)
        assert http_bytes("GET", dav + old)[0] == 404
        assert http_bytes("GET", dav + new)[1] == body
        warm_plane(furl, new, body)
        assert http_bytes("DELETE", dav + new)[0] == 204
        assert_gone(furl, new, body)
        assert http_bytes("GET", dav + new)[0] == 404
        st, listing, _ = http_bytes("PROPFIND", dav + f"/st/d{i}", None,
                                    {"Depth": "1"})
        assert st == 207 and b"b.bin" not in listing
