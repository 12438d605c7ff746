"""The port's native CRC32-C (`native/crc32c.cc`), both its SSE4.2 path
and its slice-by-8 table loop, against the port's `crc32c_loop` and
`crc32c_numpy` and the JAX package's `storage.crc.crc32c`.  Tolerance:
exact equality.  Seeded numpy buffers of 0 to 1 MiB, unaligned starts
and running values."""

import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage import crc as ref_crc
from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.storage import crc

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the native CRC")

SIZES = [0, 1, 7, 8, 9, 63, 64, 65, 4095, 4097, 65_537, 1 << 20]


def _buf(n: int, seed: int) -> bytes:
    return np.random.default_rng([seed, n]).bytes(n)


def crc32c_sw(data, value: int = 0) -> int:
    """The native slice-by-8 loop, the path of a CPU without SSE4.2."""
    return crc._native_call("crc32c_extend_sw", data, value)


ENTRIES = pytest.mark.parametrize("entry", [crc.crc32c_native, crc32c_sw],
                                  ids=["dispatch", "sw"])


@pytest.fixture(scope="module")
def lib():
    lib = native.load_crc32c()
    assert lib is not None, native.BUILD_INFO.get("crc32c")
    return lib


@needs_gxx
@pytest.mark.parametrize("n", SIZES)
@ENTRIES
def test_native_matches_the_jax_crc_and_the_loops(lib, entry, n):
    data = _buf(n, 11)
    want = ref_crc.crc32c(data)
    assert entry(data) == want
    assert crc.crc32c_numpy(data) == want
    if n <= 65_537:
        assert crc.crc32c_loop(data) == want


@needs_gxx
@ENTRIES
@pytest.mark.parametrize("start", [1, 3, 5, 7])
def test_unaligned_starts_and_running_values(lib, entry, start):
    data = _buf(200_003, 12)
    view = memoryview(data)[start:]
    value = ref_crc.crc32c(data[:start])
    # a running value continues the CRC, as google_crc32c.extend does
    assert entry(view, value) == ref_crc.crc32c(data)
    # and any value, from any kind of buffer
    arr = np.frombuffer(data, dtype=np.uint8)[start:start + 70_001]
    seed = 0xDEADBEEF ^ start
    want = ref_crc.crc32c(arr.tobytes(), seed)
    assert entry(arr, seed) == want
    assert entry(bytearray(arr.tobytes()), seed) == want
    assert crc.crc32c_numpy(arr, seed) == want


@needs_gxx
def test_split_anywhere_equals_whole(lib):
    data = _buf(1 << 16, 13)
    rng = np.random.default_rng(14)
    for cut in rng.integers(0, len(data), 16):
        cut = int(cut)
        for entry in (crc.crc32c_native, crc32c_sw):
            assert entry(data[cut:], entry(data[:cut])) == \
                ref_crc.crc32c(data)


@needs_gxx
def test_the_dispatch_names_the_cpu_path(lib):
    with open("/proc/cpuinfo") as f:
        sse42 = " sse4_2" in f.read()
    assert bool(lib.crc32c_simd()) == sse42
    info = native.BUILD_INFO["crc32c"]
    assert info["path"].startswith(native.BUILD_DIR)


def test_engine_is_chosen_at_the_first_checksum(monkeypatch):
    """google_crc32c where it is installed (as the JAX package), else
    the native library, else numpy; the module names its choice."""
    monkeypatch.setattr(crc, "_chosen", None)
    monkeypatch.setattr(crc, "_google", lambda: None)
    if native.load_crc32c() is not None:
        want = "sse4.2" if native.load_crc32c().crc32c_simd() else "sw"
    else:
        want = "numpy"
    assert crc.engine() == want
    data = _buf(4099, 15)
    assert crc.crc32c(data, 5) == ref_crc.crc32c(data, 5)
    monkeypatch.setattr(crc, "_chosen", None)
    monkeypatch.setattr(native, "load_crc32c", lambda: None)
    assert crc.engine() == "numpy"
    assert crc.crc32c(data, 5) == ref_crc.crc32c(data, 5)


def test_google_crc32c_comes_first_where_installed(monkeypatch):
    monkeypatch.setattr(crc, "_chosen", None)
    monkeypatch.setattr(crc, "_google", lambda: ref_crc.crc32c)
    assert crc.engine() == "google_crc32c"
    assert crc.crc32c(b"abc", 9) == ref_crc.crc32c(b"abc", 9)
