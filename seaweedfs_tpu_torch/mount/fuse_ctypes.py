"""ctypes bridge to libfuse.so.2 (the kernel-facing half of the mount),
the port's copy of `seaweedfs_tpu/mount/fuse_ctypes.py` without its gRPC
control service.

The environment ships libfuse 2.9 and /dev/fuse but neither headers
nor pybind11, so the `fuse_operations` table (FUSE_USE_VERSION 26) and
the x86-64 glibc `struct stat` are declared by hand — their layouts
are fixed ABI.  Runs `fuse_main_real` foreground + single-threaded;
every callback trampoline is pinned on the instance so the C side can
never call into a collected object.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno

from .weedfs import FuseError, WeedFS

c_off_t = ctypes.c_longlong
c_mode_t = ctypes.c_uint
c_dev_t = ctypes.c_ulonglong


class Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


class Stat(ctypes.Structure):
    """x86-64 glibc struct stat."""
    _fields_ = [
        ("st_dev", c_dev_t),
        ("st_ino", ctypes.c_ulong),
        ("st_nlink", ctypes.c_ulong),
        ("st_mode", c_mode_t),
        ("st_uid", ctypes.c_uint),
        ("st_gid", ctypes.c_uint),
        ("__pad0", ctypes.c_int),
        ("st_rdev", c_dev_t),
        ("st_size", c_off_t),
        ("st_blksize", ctypes.c_long),
        ("st_blocks", ctypes.c_long),
        ("st_atim", Timespec),
        ("st_mtim", Timespec),
        ("st_ctim", Timespec),
        ("__unused", ctypes.c_long * 3),
    ]


class Statvfs(ctypes.Structure):
    _fields_ = [
        ("f_bsize", ctypes.c_ulong),
        ("f_frsize", ctypes.c_ulong),
        ("f_blocks", ctypes.c_ulong),
        ("f_bfree", ctypes.c_ulong),
        ("f_bavail", ctypes.c_ulong),
        ("f_files", ctypes.c_ulong),
        ("f_ffree", ctypes.c_ulong),
        ("f_favail", ctypes.c_ulong),
        ("f_fsid", ctypes.c_ulong),
        ("f_flag", ctypes.c_ulong),
        ("f_namemax", ctypes.c_ulong),
        ("__spare", ctypes.c_int * 6),
    ]


_getattr_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(Stat))
_readlink_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
    ctypes.c_size_t)
_open_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)
_read_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
    ctypes.c_size_t, c_off_t, ctypes.c_void_p)
_statfs_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(Statvfs))
_mkdir_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, c_mode_t)
_path_t = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p)
_rename_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
_chmod_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, c_mode_t)
_chown_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_uint, ctypes.c_uint)
_truncate_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, c_off_t)
_write_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
    ctypes.c_size_t, c_off_t, ctypes.c_void_p)
_fi_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)
_create_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, c_mode_t, ctypes.c_void_p)
_ftruncate_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, c_off_t, ctypes.c_void_p)
_utimens_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(Timespec))
# int (*filler)(void *buf, const char *name, const struct stat *, off_t)
_fill_dir_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
    ctypes.POINTER(Stat), c_off_t)
_readdir_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p, _fill_dir_t,
    c_off_t, ctypes.c_void_p)
_voidp_t = ctypes.c_void_p


class FuseOperations(ctypes.Structure):
    """fuse.h FUSE_USE_VERSION 26 operation table (libfuse 2.9)."""
    _fields_ = [
        ("getattr", _getattr_t),
        ("readlink", _readlink_t),
        ("getdir", _voidp_t),
        ("mknod", _voidp_t),
        ("mkdir", _mkdir_t),
        ("unlink", _path_t),
        ("rmdir", _path_t),
        ("symlink", _voidp_t),
        ("rename", _rename_t),
        ("link", _voidp_t),
        ("chmod", _chmod_t),
        ("chown", _chown_t),
        ("truncate", _truncate_t),
        ("utime", _voidp_t),
        ("open", _open_t),
        ("read", _read_t),
        ("write", _write_t),
        ("statfs", _statfs_t),
        ("flush", _fi_t),
        ("release", _fi_t),
        ("fsync", _voidp_t),
        ("setxattr", _voidp_t),
        ("getxattr", _voidp_t),
        ("listxattr", _voidp_t),
        ("removexattr", _voidp_t),
        ("opendir", _voidp_t),
        ("readdir", _readdir_t),
        ("releasedir", _voidp_t),
        ("fsyncdir", _voidp_t),
        ("init", _voidp_t),
        ("destroy", _voidp_t),
        ("access", _voidp_t),
        ("create", _create_t),
        ("ftruncate", _ftruncate_t),
        ("fgetattr", _voidp_t),
        ("lock", _voidp_t),
        ("utimens", _utimens_t),
        ("bmap", _voidp_t),
        ("flags", ctypes.c_uint),  # flag_nullpath_ok etc. bitfield
        ("ioctl", _voidp_t),
        ("poll", _voidp_t),
        ("write_buf", _voidp_t),
        ("read_buf", _voidp_t),
        ("flock", _voidp_t),
        ("fallocate", _voidp_t),
    ]


def _fill_stat(st: Stat, d: dict) -> None:
    ctypes.memset(ctypes.byref(st), 0, ctypes.sizeof(st))
    st.st_mode = d["st_mode"]
    st.st_size = d["st_size"]
    st.st_nlink = d.get("st_nlink", 1)
    st.st_uid = d.get("st_uid", 0)
    st.st_gid = d.get("st_gid", 0)
    st.st_blksize = 4096
    st.st_blocks = (d["st_size"] + 511) // 512
    for name, key in (("st_atim", "st_atime"), ("st_mtim", "st_mtime"),
                      ("st_ctim", "st_ctime")):
        t = float(d.get(key, 0) or 0)
        ts = getattr(st, name)
        ts.tv_sec = int(t)
        ts.tv_nsec = int((t - int(t)) * 1e9)


class FuseMount:
    def __init__(self, fs: WeedFS):
        self.fs = fs
        path = ctypes.util.find_library("fuse") or "libfuse.so.2"
        self._lib = ctypes.CDLL(path)
        self.ops = FuseOperations()
        # pin the trampolines on self — libfuse keeps raw pointers
        self._cbs = {
            "getattr": _getattr_t(self._getattr),
            "readlink": _readlink_t(self._readlink),
            "open": _open_t(self._open),
            "read": _read_t(self._read),
            "statfs": _statfs_t(self._statfs),
            "readdir": _readdir_t(self._readdir),
            # write path
            "create": _create_t(self._create),
            "write": _write_t(self._write),
            "truncate": _truncate_t(self._truncate),
            "ftruncate": _ftruncate_t(self._ftruncate),
            "flush": _fi_t(self._flush),
            "release": _fi_t(self._release),
            "mkdir": _mkdir_t(self._mkdir),
            "unlink": _path_t(self._unlink),
            "rmdir": _path_t(self._rmdir),
            "rename": _rename_t(self._rename),
            "chmod": _chmod_t(self._chmod),
            # owner/time updates: accepted without persistence (the
            # filer keeps authoritative attrs; tar/cp must not fail)
            "chown": _chown_t(lambda p, u, g: 0),
            "utimens": _utimens_t(lambda p, ts: 0),
        }
        for name, cb in self._cbs.items():
            setattr(self.ops, name, cb)

    # -- callbacks (errno-style returns) ----------------------------------

    def _guard(self, fn, *args):
        try:
            return fn(*args)
        except FuseError as e:
            return -e.errno
        except Exception:  # noqa: BLE001 — never unwind into C
            return -errno.EIO

    def _getattr(self, path, stp):
        def run():
            _fill_stat(stp.contents,
                       self.fs.getattr(path.decode()))
            return 0
        return self._guard(run)

    def _readlink(self, path, buf, size):
        def run():
            target = self.fs.readlink(path.decode()).encode()
            n = min(len(target), size - 1)
            ctypes.memmove(buf, target, n)
            buf[n] = b"\x00"
            return 0
        return self._guard(run)

    @staticmethod
    def _fi_flags(fip) -> int:
        """fuse_file_info.flags is the struct's FIRST field (an int)."""
        if not fip:
            return 0
        return ctypes.cast(fip,
                           ctypes.POINTER(ctypes.c_int)).contents.value

    def _open(self, path, fip):
        return self._guard(
            lambda: self.fs.open(path.decode(),
                                 self._fi_flags(fip)) and 0)

    def _create(self, path, mode, fip):
        return self._guard(
            lambda: self.fs.create(path.decode(), mode) and 0)

    def _write(self, path, buf, size, offset, fip):
        def run():
            data = ctypes.string_at(buf, size)
            return self.fs.write(path.decode(), data, offset)
        return self._guard(run)

    def _truncate(self, path, length):
        return self._guard(
            lambda: self.fs.truncate(path.decode(), length) or 0)

    def _ftruncate(self, path, length, fip):
        return self._truncate(path, length)

    def _flush(self, path, fip):
        return self._guard(
            lambda: self.fs.flush(path.decode()) or 0)

    def _release(self, path, fip):
        import os as _os
        flags = self._fi_flags(fip)
        writable = bool(flags & (_os.O_WRONLY | _os.O_RDWR))
        return self._guard(
            lambda: self.fs.release(path.decode(), writable) or 0)

    def _chmod(self, path, mode):
        return self._guard(
            lambda: self.fs.chmod(path.decode(), mode) or 0)

    def _mkdir(self, path, mode):
        return self._guard(
            lambda: self.fs.mkdir(path.decode(), mode) or 0)

    def _unlink(self, path):
        return self._guard(
            lambda: self.fs.unlink(path.decode()) or 0)

    def _rmdir(self, path):
        return self._guard(
            lambda: self.fs.rmdir(path.decode()) or 0)

    def _rename(self, old, new):
        return self._guard(
            lambda: self.fs.rename(old.decode(), new.decode()) or 0)

    def _read(self, path, buf, size, offset, fip):
        def run():
            data = self.fs.read(path.decode(), size, offset)
            ctypes.memmove(buf, data, len(data))
            return len(data)
        return self._guard(run)

    def _statfs(self, path, svp):
        def run():
            d = self.fs.statfs(path.decode())
            ctypes.memset(ctypes.byref(svp.contents), 0,
                          ctypes.sizeof(svp.contents))
            for k, v in d.items():
                setattr(svp.contents, k, v)
            return 0
        return self._guard(run)

    def _readdir(self, path, buf, filler, offset, fip):
        def run():
            for name in self.fs.readdir(path.decode()):
                if filler(buf, name.encode(), None, 0):
                    break
            return 0
        return self._guard(run)

    # -- main loop --------------------------------------------------------

    def run(self, mountpoint: str, foreground: bool = True) -> int:
        """fuse_main_real: mounts and serves until unmounted
        (fusermount -u) or killed."""
        args = [b"seaweedfs-tpu", mountpoint.encode(), b"-s",
                b"-o", b"default_permissions"]
        if foreground:
            args.insert(2, b"-f")
        argv = (ctypes.c_char_p * len(args))(*args)
        return self._lib.fuse_main_real(
            len(args), argv, ctypes.byref(self.ops),
            ctypes.sizeof(self.ops), None)


def mount(filer: str, mountpoint: str) -> int:
    """Mount `filer`'s namespace at `mountpoint` and serve it until
    unmounted (no gRPC control service: see the package docstring)."""
    fs = WeedFS(filer)
    try:
        return FuseMount(fs).run(mountpoint)
    finally:
        fs.close()
