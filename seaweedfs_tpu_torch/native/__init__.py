"""The host's native libraries, built with g++ at first use.

Six C++ sources, each compiled into a shared library with a plain C
interface and loaded with ctypes (the loader of
`seaweedfs_tpu/native/__init__.py`, without its volume tool):
- `gf_rs.cc`, the GF(2^8) codec of degraded reads (`load`);
- `crc32c.cc`, the needle CRC32-C where `google_crc32c` is absent
  (`load_crc32c`);
- `read_plane.cc` and `write_plane.cc`, the volume server's epoll
  needle planes (`load_read_plane`, `load_write_plane`);
- `meta_plane.cc` and `filer_read_plane.cc`, the filer's epoll write
  and read planes (`load_meta_plane`, `load_filer_read_plane`), which
  both include `plane_pool.h`.
Each library lands in `seaweedfs_tpu_torch/_build/` under a name that
carries a hash of the source and the headers it includes, the flags
and the host CPU's feature flags, so an edited source is rebuilt, an
unchanged one is loaded as it is, and a library built with
`-march=native` on one CPU is never loaded on another.  Nothing is
built when the package is imported.  `BUILD_INFO[stem]` says what the
last build or load of each did.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "gf_rs.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
# stem -> the loaded library, or None once a build or load failed
_libs: "dict[str, ctypes.CDLL | None]" = {}
# stem -> what its last build or load did: {"path", "seconds",
# "march_native", "error"}; read by chip_smoke.py and the tests
BUILD_INFO: "dict[str, dict]" = {}


def _cpu_flags() -> str:
    """The host CPU's feature flags (empty where /proc/cpuinfo has none):
    part of the library's name, because `-march=native` code may not run
    on another CPU."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def _build_if_stale(src_path: str, info: dict,
                    deps: "tuple[str, ...]" = ()) -> "str | None":
    """Build `src_path` with g++ unless a library of this exact source
    and `deps` (the headers it includes), these flags and this CPU is
    already in BUILD_DIR: `-march=native`
    first, then without it.  Each attempt writes a per-process temp file
    renamed into place, so concurrent builders never publish half a
    library.  The library's path, or None when g++ is missing or fails
    (the reason in info["error"])."""
    digest = hashlib.sha256()
    try:
        for path in (src_path, *deps):
            with open(path, "rb") as f:
                digest.update(f.read())
    except OSError as e:
        info["error"] = str(e)
        return None
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(_cpu_flags().encode())
    stem = os.path.splitext(os.path.basename(src_path))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        info.update(path=out, seconds=0.0)
        return out
    t0 = time.perf_counter()
    err = ""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError as e:
        info["error"] = str(e)
        return None
    for march in (["-march=native"], []):
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, *march, src_path, "-o", tmp],
                capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            err = str(e)
            continue
        if proc.returncode != 0:
            err = proc.stderr[-2000:]
            continue
        os.replace(tmp, out)
        info.update(path=out, seconds=time.perf_counter() - t0,
                    march_native=bool(march))
        return out
    info["error"] = err or "g++ failed"
    return None


def _load(stem: str, bind, deps: "tuple[str, ...]" = ()
          ) -> "ctypes.CDLL | None":
    """Build (if needed) and load `<stem>.cc` once a process, with its
    signatures set by `bind`; None when it cannot be built or loaded.
    Callers must never see an exception from here."""
    with _lock:
        if stem in _libs:
            return _libs[stem]
        _libs[stem] = None
        info = BUILD_INFO.setdefault(stem, {})
        so = _build_if_stale(os.path.join(_DIR, stem + ".cc"), info,
                             tuple(os.path.join(_DIR, d) for d in deps))
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            info["error"] = str(e)
            return None
        bind(lib)
        _libs[stem] = lib
        return lib


def _sig(fn, argtypes: list, restype=None) -> None:
    fn.argtypes = argtypes
    fn.restype = restype


# -- the GF(2^8) codec (gf_rs.cc) ----------------------------------------

def _bind_gf_rs(lib: ctypes.CDLL) -> None:
    _sig(lib.gf_matrix_apply, [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t, ctypes.c_int])
    _sig(lib.gf_mul_slice_acc, [ctypes.c_uint8, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_size_t])
    _sig(lib.gf_native_simd, [], ctypes.c_int)


def load() -> "ctypes.CDLL | None":
    """The native codec; None where it does not build (callers then use
    the numpy codec)."""
    return _load("gf_rs", _bind_gf_rs)


def available() -> bool:
    return load() is not None


# -- CRC32-C (crc32c.cc) -------------------------------------------------

def _bind_crc32c(lib: ctypes.CDLL) -> None:
    _sig(lib.crc32c_simd, [], ctypes.c_int)
    for fn in (lib.crc32c_extend, lib.crc32c_extend_sw):
        _sig(fn, [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t],
             ctypes.c_uint32)


def load_crc32c() -> "ctypes.CDLL | None":
    """The native CRC32-C; None where it does not build (storage/crc.py
    then uses its numpy form)."""
    return _load("crc32c", _bind_crc32c)


# -- the read plane (read_plane.cc) --------------------------------------

def _bind_read_plane(lib: ctypes.CDLL) -> None:
    _sig(lib.rp_start, [ctypes.c_char_p, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int)], ctypes.c_int)
    _sig(lib.rp_stop, [ctypes.c_int])
    _sig(lib.rp_add_volume, [ctypes.c_int, ctypes.c_uint,
                             ctypes.c_char_p], ctypes.c_int)
    _sig(lib.rp_remove_volume, [ctypes.c_int, ctypes.c_uint])
    _sig(lib.rp_put, [ctypes.c_int, ctypes.c_uint, ctypes.c_ulonglong,
                      ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_uint],
         ctypes.c_int)
    _sig(lib.rp_del, [ctypes.c_int, ctypes.c_uint, ctypes.c_ulonglong])
    _sig(lib.rp_served, [ctypes.c_int], ctypes.c_ulonglong)


def load_read_plane() -> "ctypes.CDLL | None":
    """The native epoll read plane; None where it does not build."""
    return _load("read_plane", _bind_read_plane)


# -- the write plane (write_plane.cc) ------------------------------------

class WpEntry(ctypes.Structure):
    """One completed native append, drained back to the Python index
    (the layout of write_plane.cc's WpEntry)."""

    _fields_ = [("key", ctypes.c_uint64),
                ("offset", ctypes.c_uint64),
                ("append_ns", ctypes.c_uint64),
                ("vid", ctypes.c_uint32),
                ("cookie", ctypes.c_uint32),
                ("size", ctypes.c_int32),
                ("data_len", ctypes.c_uint32)]


def _bind_write_plane(lib: ctypes.CDLL) -> None:
    h, vid = ctypes.c_int, ctypes.c_uint
    _sig(lib.wp_start, [ctypes.c_char_p, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int)], ctypes.c_int)
    _sig(lib.wp_stop, [h])
    _sig(lib.wp_add_volume, [h, vid, ctypes.c_char_p, ctypes.c_ulonglong,
                             ctypes.c_ulonglong, ctypes.c_int],
         ctypes.c_int)
    _sig(lib.wp_mark_keys, [h, vid, ctypes.POINTER(ctypes.c_ulonglong),
                            ctypes.c_int], ctypes.c_int)
    _sig(lib.wp_arm, [h, vid], ctypes.c_int)
    _sig(lib.wp_remove_volume, [h, vid])
    _sig(lib.wp_append, [h, vid, ctypes.c_ulonglong, ctypes.c_char_p,
                         ctypes.c_ulonglong, ctypes.c_ulonglong],
         ctypes.c_longlong)
    _sig(lib.wp_drain, [h, vid, ctypes.POINTER(WpEntry), ctypes.c_int],
         ctypes.c_int)
    _sig(lib.wp_pending, [h, vid], ctypes.c_int)
    _sig(lib.wp_requests, [h], ctypes.c_ulonglong)
    _sig(lib.wp_fallbacks, [h], ctypes.c_ulonglong)
    _sig(lib.wp_latency, [h, ctypes.POINTER(ctypes.c_ulonglong)],
         ctypes.c_int)
    # the -fsync tier's epoch handshake: the plane parks an ack until
    # Python has run the volume's barrier for its epoch.  A library
    # without it still serves the default tier (`epoch_handshake`
    # False: server/write_plane.py then refuses -fsync volumes)
    try:
        _sig(lib.wp_wait_epoch, [h, ctypes.c_int, ctypes.POINTER(vid),
                                 ctypes.POINTER(ctypes.c_ulonglong)],
             ctypes.c_int)
        _sig(lib.wp_epoch_done, [h, vid, ctypes.c_ulonglong])
        lib.epoch_handshake = True
    except AttributeError:
        lib.epoch_handshake = False


def load_write_plane() -> "ctypes.CDLL | None":
    """The native epoll write plane; None where it does not build."""
    return _load("write_plane", _bind_write_plane)


# -- the filer's meta plane (meta_plane.cc) ------------------------------

def _bind_meta_plane(lib: ctypes.CDLL) -> None:
    h, u64p = ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)
    _sig(lib.mp_start, [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                        ctypes.c_char_p, ctypes.c_char_p,
                        ctypes.POINTER(ctypes.c_int)], ctypes.c_int)
    _sig(lib.mp_stop, [h])
    _sig(lib.mp_arm, [h, ctypes.c_int])
    _sig(lib.mp_feed_fids, [h, ctypes.c_char_p], ctypes.c_int)
    _sig(lib.mp_fid_level, [h], ctypes.c_int)
    _sig(lib.mp_mark_dir, [h, ctypes.c_char_p])
    _sig(lib.mp_mark_path, [h, ctypes.c_char_p])
    _sig(lib.mp_clear_dirs, [h])
    _sig(lib.mp_requests, [h], ctypes.c_ulonglong)
    _sig(lib.mp_latency, [h, u64p], ctypes.c_int)
    _sig(lib.mp_stats, [h, u64p], ctypes.c_int)


def load_meta_plane() -> "ctypes.CDLL | None":
    """The filer's native meta plane; None where it does not build (the
    filer then serves every write from Python, and says why)."""
    return _load("meta_plane", _bind_meta_plane, deps=("plane_pool.h",))


# -- the filer's read plane (filer_read_plane.cc) ------------------------

def _bind_filer_read_plane(lib: ctypes.CDLL) -> None:
    h, u64p = ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)
    _sig(lib.frp_start, [ctypes.c_char_p, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int)], ctypes.c_int)
    _sig(lib.frp_stop, [h])
    _sig(lib.frp_arm, [h, ctypes.c_int])
    _sig(lib.frp_gen, [h], ctypes.c_ulonglong)
    _sig(lib.frp_put_entry, [h, ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_ulonglong, ctypes.c_ulonglong],
         ctypes.c_int)
    _sig(lib.frp_invalidate, [h, ctypes.c_char_p])
    _sig(lib.frp_entries, [h], ctypes.c_int)
    _sig(lib.frp_requests, [h], ctypes.c_ulonglong)
    _sig(lib.frp_latency, [h, u64p], ctypes.c_int)
    _sig(lib.frp_stats, [h, u64p], ctypes.c_int)


def load_filer_read_plane() -> "ctypes.CDLL | None":
    """The filer's native read plane; None where it does not build (the
    filer then serves every read from Python, and says why)."""
    return _load("filer_read_plane", _bind_filer_read_plane,
                 deps=("plane_pool.h",))
