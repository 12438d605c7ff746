"""SFTP v3 protocol (draft-ietf-secsh-filexfer-02) over the filer —
the analog of weed/sftpd/sftp_filer.go (op table), sftp_file_reader.go
(ranged reads) and sftp_file_writer.go (buffer + flush on close); the
port's copy of `seaweedfs_tpu/sftp/handlers.py`.

Each authenticated session gets one `SftpHandlers` bound to its User;
every operation runs the sftp_permissions.go longest-prefix check
before touching the filer.
"""

from __future__ import annotations

import stat as statmod
import time

from ..filer.entry import Entry
from .ssh_wire import Reader, ssh_string, u32, u8
from . import users as perm

# packet types
FXP_INIT, FXP_VERSION = 1, 2
FXP_OPEN, FXP_CLOSE, FXP_READ, FXP_WRITE = 3, 4, 5, 6
FXP_LSTAT, FXP_FSTAT, FXP_SETSTAT, FXP_FSETSTAT = 7, 8, 9, 10
FXP_OPENDIR, FXP_READDIR, FXP_REMOVE, FXP_MKDIR, FXP_RMDIR = 11, 12, 13, 14, 15
FXP_REALPATH, FXP_STAT, FXP_RENAME, FXP_READLINK, FXP_SYMLINK = \
    16, 17, 18, 19, 20
FXP_STATUS, FXP_HANDLE, FXP_DATA, FXP_NAME, FXP_ATTRS = 101, 102, 103, 104, 105

# status codes
FX_OK, FX_EOF, FX_NO_SUCH_FILE, FX_PERMISSION_DENIED, FX_FAILURE = 0, 1, 2, 3, 4
FX_OP_UNSUPPORTED = 8

# open pflags
FXF_READ, FXF_WRITE, FXF_APPEND = 0x01, 0x02, 0x04
FXF_CREAT, FXF_TRUNC, FXF_EXCL = 0x08, 0x10, 0x20

# attr flags
ATTR_SIZE, ATTR_UIDGID, ATTR_PERMISSIONS, ATTR_ACMODTIME = 1, 2, 4, 8


def encode_attrs(entry: Entry) -> bytes:
    a = entry.attributes
    mode = a.mode & 0o7777
    mode |= statmod.S_IFDIR if entry.is_directory else statmod.S_IFREG
    return (u32(ATTR_SIZE | ATTR_UIDGID | ATTR_PERMISSIONS |
                ATTR_ACMODTIME) +
            entry.total_size().to_bytes(8, "big") +
            u32(a.uid) + u32(a.gid) + u32(mode) +
            u32(int(a.mtime)) + u32(int(a.mtime)))


def decode_attrs(r: Reader) -> dict:
    flags = r.u32()
    out = {}
    if flags & ATTR_SIZE:
        out["size"] = r.u64()
    if flags & ATTR_UIDGID:
        out["uid"], out["gid"] = r.u32(), r.u32()
    if flags & ATTR_PERMISSIONS:
        out["mode"] = r.u32()
    if flags & ATTR_ACMODTIME:
        out["atime"], out["mtime"] = r.u32(), r.u32()
    return out


class _OpenFile:
    """sftp_file_writer.go SeaweedSftpFileWriter: random-access writes
    land in a sparse buffer, flushed to the filer as one entry on
    close.  Reads on a read-opened handle go straight to the filer
    with Range headers (sftp_file_reader.go)."""

    def __init__(self, path: str, pflags: int, base: bytes):
        self.path = path
        self.pflags = pflags
        self.buf = bytearray(base)
        self.dirty = False

    def write_at(self, offset: int, data: bytes) -> None:
        if self.pflags & FXF_APPEND:
            offset = len(self.buf)
        if offset + len(data) > len(self.buf):
            self.buf.extend(b"\x00" * (offset + len(data) - len(self.buf)))
        self.buf[offset:offset + len(data)] = data
        self.dirty = True


class SftpHandlers:
    """One SFTP session: handle table + dispatch.  `fs` is a Filer or
    FilerClient (duck-typed, same as WebDavServer)."""

    def __init__(self, fs, user):
        self.fs = fs
        self.user = user
        self._handles: dict[bytes, object] = {}
        self._next = 0

    # -- plumbing ----------------------------------------------------------

    def _alloc(self, obj) -> bytes:
        h = f"h{self._next}".encode()
        self._next += 1
        self._handles[h] = obj
        return h

    def _resolve(self, raw: str) -> str:
        """Absolute-ise against the user's home (reference resolves
        relative paths against HomeDir), squeeze dot segments."""
        p = raw if raw.startswith("/") else \
            self.user.home_dir.rstrip("/") + "/" + raw
        parts = []
        for seg in p.split("/"):
            if seg in ("", "."):
                continue
            if seg == "..":
                if parts:
                    parts.pop()
                continue
            parts.append(seg)
        return "/" + "/".join(parts)

    @staticmethod
    def _status(req_id: int, code: int, msg: str = "") -> bytes:
        return (u8(FXP_STATUS) + u32(req_id) + u32(code) +
                ssh_string(msg or {FX_OK: "ok", FX_EOF: "eof"}.get(
                    code, "error")) + ssh_string(""))

    def _check(self, path: str, p: str) -> bool:
        return self.user.allowed(path, p)

    # -- dispatch ----------------------------------------------------------

    def handle(self, packet: bytes) -> bytes:
        """One request in, one response out."""
        r = Reader(packet)
        t = r.u8()
        if t == FXP_INIT:
            return u8(FXP_VERSION) + u32(3)
        req_id = r.u32()
        try:
            fn = {
                FXP_OPEN: self._open, FXP_CLOSE: self._close,
                FXP_READ: self._read, FXP_WRITE: self._write,
                FXP_LSTAT: self._stat, FXP_STAT: self._stat,
                FXP_FSTAT: self._fstat, FXP_SETSTAT: self._setstat,
                FXP_FSETSTAT: self._fsetstat,
                FXP_OPENDIR: self._opendir, FXP_READDIR: self._readdir,
                FXP_REMOVE: self._remove, FXP_MKDIR: self._mkdir,
                FXP_RMDIR: self._rmdir, FXP_REALPATH: self._realpath,
                FXP_RENAME: self._rename,
            }.get(t)
            if fn is None:
                return self._status(req_id, FX_OP_UNSUPPORTED,
                                    f"sftp op {t}")
            return fn(req_id, r)
        except FileNotFoundError as e:
            return self._status(req_id, FX_NO_SUCH_FILE, str(e))
        except PermissionError as e:
            return self._status(req_id, FX_PERMISSION_DENIED, str(e))
        except Exception as e:                  # noqa: BLE001
            return self._status(req_id, FX_FAILURE,
                                f"{type(e).__name__}: {e}")

    # -- file ops ----------------------------------------------------------

    def _open(self, req_id: int, r: Reader) -> bytes:
        path = self._resolve(r.text())
        pflags = r.u32()
        decode_attrs(r)
        entry = self.fs.find_entry(path)
        if pflags & (FXF_WRITE | FXF_APPEND):
            if not self._check(path, perm.PERM_WRITE):
                raise PermissionError(path)
        else:
            if not self._check(path, perm.PERM_READ):
                raise PermissionError(path)
        if entry and entry.is_directory:
            return self._status(req_id, FX_FAILURE, "is a directory")
        if entry is None:
            if not pflags & FXF_CREAT:
                raise FileNotFoundError(path)
            base = b""
        elif pflags & FXF_EXCL:
            return self._status(req_id, FX_FAILURE, "file exists")
        elif pflags & FXF_TRUNC:
            base = b""
        elif pflags & (FXF_WRITE | FXF_APPEND):
            base = self.fs.read_file(path)
        else:
            base = b""                   # read handles stream on demand
        f = _OpenFile(path, pflags, base)
        # creating an empty file must materialise it even if never
        # written (touch semantics), and TRUNC on an existing file must
        # persist the truncation even if nothing lands in the buffer
        f.dirty = (entry is None and bool(pflags & FXF_CREAT)) or \
            (entry is not None and bool(pflags & FXF_TRUNC))
        return u8(FXP_HANDLE) + u32(req_id) + ssh_string(self._alloc(f))

    def _write_preserving_attrs(self, path: str, data: bytes) -> None:
        """Content writes rebuild the entry with default attributes, so
        carry mode/uid/gid across the PUT — otherwise a chmod would
        silently revert on the next upload (mount/weedfs.py flush()
        does the same for the same reason)."""
        prev = self.fs.find_entry(path)
        self.fs.write_file(path, data)
        if prev is not None and hasattr(self.fs, "update_attrs"):
            a = prev.attributes
            self.fs.update_attrs(path, mode=a.mode, uid=a.uid, gid=a.gid)

    def _close(self, req_id: int, r: Reader) -> bytes:
        h = r.string()
        obj = self._handles.pop(h, None)
        if isinstance(obj, _OpenFile) and obj.dirty:
            self._write_preserving_attrs(obj.path, bytes(obj.buf))
        return self._status(req_id, FX_OK)

    def _read(self, req_id: int, r: Reader) -> bytes:
        h, offset, length = r.string(), r.u64(), r.u32()
        f = self._handles.get(h)
        if not isinstance(f, _OpenFile):
            return self._status(req_id, FX_FAILURE, "bad handle")
        if f.dirty:
            data = bytes(f.buf[offset:offset + length])
        else:
            data = self.fs.read_file(f.path, offset,
                                     min(length, 1 << 20))
        if not data:
            return self._status(req_id, FX_EOF)
        return u8(FXP_DATA) + u32(req_id) + ssh_string(data)

    def _write(self, req_id: int, r: Reader) -> bytes:
        h, offset, data = r.string(), r.u64(), r.string()
        f = self._handles.get(h)
        if not isinstance(f, _OpenFile):
            return self._status(req_id, FX_FAILURE, "bad handle")
        f.write_at(offset, data)
        return self._status(req_id, FX_OK)

    # -- stat family -------------------------------------------------------

    def _entry_or_raise(self, path: str) -> Entry:
        e = self.fs.find_entry(path)
        if e is None:
            raise FileNotFoundError(path)
        return e

    def _stat(self, req_id: int, r: Reader) -> bytes:
        path = self._resolve(r.text())
        if not self._check(path, perm.PERM_READ):
            raise PermissionError(path)
        e = self._entry_or_raise(path)
        return u8(FXP_ATTRS) + u32(req_id) + encode_attrs(e)

    def _fstat(self, req_id: int, r: Reader) -> bytes:
        f = self._handles.get(r.string())
        if not isinstance(f, _OpenFile):
            return self._status(req_id, FX_FAILURE, "bad handle")
        if f.dirty:
            # unflushed handle: size comes from the write buffer
            return (u8(FXP_ATTRS) + u32(req_id) +
                    u32(ATTR_SIZE) + len(f.buf).to_bytes(8, "big"))
        e = self._entry_or_raise(f.path)
        return u8(FXP_ATTRS) + u32(req_id) + encode_attrs(e)

    def _apply_setstat(self, path: str, attrs: dict) -> None:
        if not self._check(path, perm.PERM_WRITE):
            raise PermissionError(path)
        e = self._entry_or_raise(path)
        if "size" in attrs and not e.is_directory:
            data = self.fs.read_file(path)
            size = attrs["size"]
            data = data[:size] + b"\x00" * (size - len(data))
            self._write_preserving_attrs(path, data)
        if hasattr(self.fs, "update_attrs"):
            kw = {}
            if "mode" in attrs:
                kw["mode"] = attrs["mode"] & 0o7777
            if "mtime" in attrs:
                kw["mtime"] = attrs["mtime"]
            if "uid" in attrs:
                kw["uid"], kw["gid"] = attrs["uid"], attrs["gid"]
            if kw:
                self.fs.update_attrs(path, **kw)

    def _setstat(self, req_id: int, r: Reader) -> bytes:
        path = self._resolve(r.text())
        self._apply_setstat(path, decode_attrs(r))
        return self._status(req_id, FX_OK)

    def _fsetstat(self, req_id: int, r: Reader) -> bytes:
        f = self._handles.get(r.string())
        if not isinstance(f, _OpenFile):
            return self._status(req_id, FX_FAILURE, "bad handle")
        attrs = decode_attrs(r)
        if "size" in attrs and f.pflags & (FXF_WRITE | FXF_APPEND):
            size = attrs.pop("size")
            del f.buf[size:]
            if size > len(f.buf):
                f.buf.extend(b"\x00" * (size - len(f.buf)))
            f.dirty = True
        if attrs:
            self._apply_setstat(f.path, attrs)
        return self._status(req_id, FX_OK)

    # -- directory ops -----------------------------------------------------

    def _opendir(self, req_id: int, r: Reader) -> bytes:
        path = self._resolve(r.text())
        if not self._check(path, perm.PERM_LIST):
            raise PermissionError(path)
        e = self._entry_or_raise(path)
        if not e.is_directory:
            return self._status(req_id, FX_FAILURE, "not a directory")
        return (u8(FXP_HANDLE) + u32(req_id) +
                ssh_string(self._alloc(self._dir_batches(path))))

    def _dir_batches(self, path: str, batch: int = 100):
        """Page the filer listing and yield READDIR batches small
        enough that one FXP_NAME reply stays far under the 256 KB
        message cap common in clients; no entry-count ceiling."""
        last = ""
        while True:
            page = self.fs.list_directory(path, start_file=last,
                                          limit=batch)
            if not page:
                return
            yield page
            last = page[-1].name
            if len(page) < batch:
                return

    def _readdir(self, req_id: int, r: Reader) -> bytes:
        it = self._handles.get(r.string())
        if it is None:
            return self._status(req_id, FX_FAILURE, "bad handle")
        batch = next(it, None)
        if batch is None:
            return self._status(req_id, FX_EOF)
        out = u8(FXP_NAME) + u32(req_id) + u32(len(batch))
        for e in batch:
            kind = "d" if e.is_directory else "-"
            longname = (f"{kind}rw-r--r-- 1 {e.attributes.uid} "
                        f"{e.attributes.gid} {e.total_size()} "
                        f"{time.strftime('%b %d %H:%M')} {e.name}")
            out += (ssh_string(e.name) + ssh_string(longname) +
                    encode_attrs(e))
        return out

    def _mkdir(self, req_id: int, r: Reader) -> bytes:
        path = self._resolve(r.text())
        if not self._check(path, perm.PERM_MKDIR):
            raise PermissionError(path)
        self.fs.create_entry(Entry(path, is_directory=True))
        return self._status(req_id, FX_OK)

    def _rmdir(self, req_id: int, r: Reader) -> bytes:
        path = self._resolve(r.text())
        if not self._check(path, perm.PERM_DELETE):
            raise PermissionError(path)
        e = self._entry_or_raise(path)
        if not e.is_directory:
            return self._status(req_id, FX_FAILURE, "not a directory")
        if self.fs.list_directory(path, limit=1):
            return self._status(req_id, FX_FAILURE,
                                "directory not empty")
        self.fs.delete_entry(path)
        return self._status(req_id, FX_OK)

    def _remove(self, req_id: int, r: Reader) -> bytes:
        path = self._resolve(r.text())
        if not self._check(path, perm.PERM_DELETE):
            raise PermissionError(path)
        e = self._entry_or_raise(path)
        if e.is_directory:
            return self._status(req_id, FX_FAILURE, "is a directory")
        self.fs.delete_entry(path)
        return self._status(req_id, FX_OK)

    def _realpath(self, req_id: int, r: Reader) -> bytes:
        raw = r.text()
        path = self.user.home_dir if raw in (".", "") \
            else self._resolve(raw)
        fake = Entry(path, is_directory=True)
        return (u8(FXP_NAME) + u32(req_id) + u32(1) +
                ssh_string(path) + ssh_string(path) +
                encode_attrs(fake))

    def _rename(self, req_id: int, r: Reader) -> bytes:
        old = self._resolve(r.text())
        new = self._resolve(r.text())
        if not (self._check(old, perm.PERM_RENAME) and
                self._check(new, perm.PERM_WRITE)):
            raise PermissionError(f"{old} -> {new}")
        self.fs.rename(old, new)
        return self._status(req_id, FX_OK)
