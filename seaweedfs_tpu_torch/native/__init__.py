"""The host's native GF(2^8) codec, built with g++ at first use.

`gf_rs.cc` (the port's copy of `seaweedfs_tpu/native/gf_rs.cc`) is
compiled into a shared library with a plain C interface and loaded with
ctypes (the loader of `seaweedfs_tpu/native/__init__.py`, without its
read, write and meta planes).  The library lands in
`seaweedfs_tpu_torch/_build/` under a name that carries a hash of the
source, the flags and the host CPU's feature flags, so an edited source
is rebuilt, an unchanged one is loaded as it is, and a library built
with `-march=native` on one CPU is never loaded on another.  Nothing is
built when the package is imported.
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
_lib: "ctypes.CDLL | None" = None
_tried = False
# what the last build or load did: {"path", "seconds", "march_native",
# "error"}; read by chip_smoke.py and the tests
BUILD_INFO: dict = {}


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


def _build_if_stale(src_path: str) -> "str | None":
    """Build `src_path` with g++ unless a library of this exact source,
    these flags and this CPU is already in BUILD_DIR: `-march=native`
    first, then without it.  Each attempt writes a per-process temp file
    renamed into place, so concurrent builders never publish half a
    library.  The library's path, or None when g++ is missing or fails
    (the reason in BUILD_INFO["error"])."""
    try:
        with open(src_path, "rb") as f:
            digest = hashlib.sha256(f.read())
    except OSError as e:
        BUILD_INFO["error"] = str(e)
        return None
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(_cpu_flags().encode())
    stem = os.path.splitext(os.path.basename(src_path))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        BUILD_INFO.update(path=out, seconds=0.0)
        return out
    t0 = time.perf_counter()
    err = ""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError as e:
        BUILD_INFO["error"] = str(e)
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
        BUILD_INFO.update(path=out, seconds=time.perf_counter() - t0,
                          march_native=bool(march))
        return out
    BUILD_INFO["error"] = err or "g++ failed"
    return None


def load() -> "ctypes.CDLL | None":
    """Build (if needed) and load the native codec, once a process; None
    when it cannot be built or loaded.  Callers then use the numpy codec
    and must never see an exception from here."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build_if_stale(SOURCE)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            BUILD_INFO["error"] = str(e)
            return None
        lib.gf_matrix_apply.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t, ctypes.c_int]
        lib.gf_matrix_apply.restype = None
        lib.gf_mul_slice_acc.argtypes = [
            ctypes.c_uint8, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t]
        lib.gf_mul_slice_acc.restype = None
        lib.gf_native_simd.argtypes = []
        lib.gf_native_simd.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
