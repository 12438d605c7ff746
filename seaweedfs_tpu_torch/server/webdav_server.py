"""WebDAV gateway over the filer (weed/server/webdav_server.go — the
reference serves golang.org/x/net/webdav on a filer-backed FileSystem),
the port's copy of `seaweedfs_tpu/server/webdav_server.py`.  `filer` is
an in-process `Filer` or a `FilerClient` of a running filer (`webdav
-filer`); the gateway imports no torch.

Implemented verbs (RFC 4918 level 1 + MOVE/COPY):
  OPTIONS                — capability advertisement (DAV: 1)
  PROPFIND (Depth 0/1)   — multistatus with resourcetype/length/dates
  GET / HEAD             — ranged file reads via the filer
  PUT                    — file upload (auto-chunked by the filer)
  MKCOL                  — directory creation
  DELETE                 — file / recursive directory delete
  MOVE                   — atomic rename (filer AtomicRenameEntry)
  COPY                   — read-through copy
"""

from __future__ import annotations

import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import formatdate

from ..filer import Entry, Filer
from ..filer.filechunks import total_size
from .httpd import HttpServer, Request

DAV_NS = "DAV:"


def _href(path: str, is_dir: bool) -> str:
    out = urllib.parse.quote(path)
    if is_dir and not out.endswith("/"):
        out += "/"
    return out


def _prop_response(parent: ET.Element, entry: Entry) -> None:
    resp = ET.SubElement(parent, f"{{{DAV_NS}}}response")
    ET.SubElement(resp, f"{{{DAV_NS}}}href").text = \
        _href(entry.full_path, entry.is_directory)
    propstat = ET.SubElement(resp, f"{{{DAV_NS}}}propstat")
    prop = ET.SubElement(propstat, f"{{{DAV_NS}}}prop")
    rt = ET.SubElement(prop, f"{{{DAV_NS}}}resourcetype")
    if entry.is_directory:
        ET.SubElement(rt, f"{{{DAV_NS}}}collection")
    else:
        ET.SubElement(prop, f"{{{DAV_NS}}}getcontentlength").text = \
            str(total_size(entry.chunks))
        mime = entry.attributes.mime or "application/octet-stream"
        ET.SubElement(prop, f"{{{DAV_NS}}}getcontenttype").text = mime
    ET.SubElement(prop, f"{{{DAV_NS}}}getlastmodified").text = \
        formatdate(entry.attributes.mtime, usegmt=True)
    ET.SubElement(prop, f"{{{DAV_NS}}}displayname").text = entry.name
    ET.SubElement(propstat, f"{{{DAV_NS}}}status").text = \
        "HTTP/1.1 200 OK"


class WebDavServer:
    def __init__(self, master: str, filer: Filer | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.filer = filer or Filer(master)
        self.http = HttpServer(host, port)
        self.http.fallback = self._dispatch

    def start(self) -> "WebDavServer":
        self.http.start()
        return self

    def stop(self) -> None:
        self.http.stop()

    @property
    def url(self) -> str:
        return self.http.url

    # -- dispatch ---------------------------------------------------------

    def _dispatch(self, req: Request):
        path = urllib.parse.unquote(req.path).rstrip("/") or "/"
        method = req.method
        if method == "OPTIONS":
            return 200, (b"", {"DAV": "1,2", "MS-Author-Via": "DAV",
                               "Allow": "OPTIONS, PROPFIND, GET, HEAD,"
                               " PUT, DELETE, MKCOL, MOVE, COPY"})
        if method == "PROPFIND":
            return self._propfind(req, path)
        if method in ("GET", "HEAD"):
            return self._get(req, path)
        if method == "PUT":
            entry = self.filer.write_file(
                path, req.body,
                mime=req.headers.get("Content-Type", ""))
            return 201, (b"", {"ETag":
                               f'"{entry.attributes.mtime}"'})
        if method == "MKCOL":
            if self.filer.find_entry(path) is not None:
                return 405, {"error": "already exists"}
            self.filer.create_entry(Entry(path, is_directory=True))
            return 201, b""
        if method == "DELETE":
            entry = self.filer.find_entry(path)
            if entry is None:
                return 404, b""
            self.filer.delete_entry(path, recursive=True)
            return 204, b""
        if method in ("MOVE", "COPY"):
            return self._move_copy(req, path, copy=(method == "COPY"))
        return 405, {"error": f"method {method} not allowed"}

    def _propfind(self, req: Request, path: str):
        entry = self.filer.find_entry(path)
        if entry is None:
            return 404, b""
        depth = req.headers.get("Depth", "1")
        root = ET.Element(f"{{{DAV_NS}}}multistatus")
        _prop_response(root, entry)
        if depth != "0" and entry.is_directory:
            last = ""
            while True:
                batch = self.filer.list_directory(
                    path, start_file=last, limit=1000)
                for child in batch:
                    _prop_response(root, child)
                if len(batch) < 1000:
                    break
                last = batch[-1].name
        ET.register_namespace("D", DAV_NS)
        body = b'<?xml version="1.0" encoding="utf-8"?>' + \
            ET.tostring(root)
        return 207, (body, "application/xml; charset=utf-8")

    def _get(self, req: Request, path: str):
        entry = self.filer.find_entry(path)
        if entry is None:
            return 404, b""
        if entry.is_directory:
            return 405, {"error": "is a collection; use PROPFIND"}
        size = total_size(entry.chunks)
        rng = req.headers.get("Range", "")
        offset, want = 0, None
        if rng.startswith("bytes="):
            try:
                lo, _, hi = rng[6:].partition("-")
                if lo:
                    offset = int(lo)
                    want = (int(hi) - offset + 1) if hi else None
                elif hi:
                    want = min(int(hi), size)
                    offset = size - want
                else:
                    raise ValueError(rng)
            except ValueError:
                offset, want = 0, None
                rng = ""
        if rng and (offset >= size or (want is not None and want <= 0)):
            # unsatisfiable range (RFC 9110 §15.5.17) — a fabricated
            # 206 with end < start would make resume-probing clients
            # (davfs2 HEAD+Range) conclude the resource is empty
            return 416, (b"", {"Content-Range": f"bytes */{size}"})
        length = min(want if want is not None else size - offset,
                     size - offset)
        data = b"" if req.method == "HEAD" else \
            self.filer.read_file(path, offset, want)
        mime = entry.attributes.mime or "application/octet-stream"
        headers = {"Content-Type": mime,
                   "Content-Length": str(length if rng or
                                         req.method == "HEAD"
                                         else len(data)),
                   "Last-Modified": formatdate(entry.attributes.mtime,
                                               usegmt=True)}
        if rng:
            headers["Content-Range"] = \
                f"bytes {offset}-{offset + length - 1}/{size}"
            return 206, (data, headers)
        return 200, (data, headers)

    def _move_copy(self, req: Request, path: str, copy: bool):
        dest = req.headers.get("Destination", "")
        if not dest:
            return 400, {"error": "missing Destination header"}
        # Destination is an absolute URL or absolute path
        parsed = urllib.parse.urlparse(dest)
        dst = urllib.parse.unquote(parsed.path).rstrip("/") or "/"
        overwrite = req.headers.get("Overwrite", "T") != "F"
        existing = self.filer.find_entry(dst)
        if existing is not None and not overwrite:
            return 412, {"error": "destination exists (Overwrite: F)"}
        src = self.filer.find_entry(path)
        if src is None:
            return 404, b""
        if copy:
            if src.is_directory:
                return 501, {"error": "COPY of collections "
                                      "not implemented"}
            data = self.filer.read_file(path)
            self.filer.write_file(dst, data,
                                  mime=src.attributes.mime)
        else:
            if existing is not None and not existing.is_directory:
                # rename replaces the destination ENTRY only; the old
                # file's chunks must be reclaimed or every
                # save-via-rename cycle leaks needles forever
                self.filer.delete_entry(dst)
            try:
                self.filer.rename(path, dst)
            except FileNotFoundError:
                return 404, b""
        return 204 if existing is not None else 201, b""
