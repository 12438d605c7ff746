"""CRC32-Castagnoli needle checksums (weed/storage/needle/crc.go).

`crc32c` uses the C-accelerated google_crc32c when present (as the JAX
package does), else the port's native `native/crc32c.cc` (the SSE4.2
instruction, or its slice-by-8 loop on a CPU without it), built with g++
at the first checksum, else a vectorised numpy form.  `engine()` names
the one chosen: "google_crc32c", "sse4.2", "sw" or "numpy".

The numpy form has the same values: the
buffer is cut into 2^n equal lanes, every lane's CRC register is
advanced one byte column at a time (one table lookup per lane per step),
and the lanes are folded pairwise with the CRC's shift operator (the
GF(2) matrix that feeds a register n zero bytes).  Short buffers use the
per-byte table loop.
"""

from __future__ import annotations

import functools

import numpy as np

_POLY = 0x82F63B78  # reflected Castagnoli


def _gen_table() -> "list[int]":
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _gen_table()
_TABLE_NP = np.asarray(_TABLE, dtype=np.uint32)

# lanes are at least this many bytes long, and at most this many lanes
_MIN_LANE_BYTES = 16
_MAX_LANES = 1 << 16


def _crc32c_register(c: int, data) -> int:
    """Advance a raw CRC register over `data`, one byte at a time."""
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c


def crc32c_loop(data: bytes, value: int = 0) -> int:
    """The per-byte table-driven CRC32-C (the reference form)."""
    return _crc32c_register(value ^ 0xFFFFFFFF, bytes(data)) ^ 0xFFFFFFFF


# --- the shift operator: a register fed n zero bytes -----------------------
#
# The register update c' = T[(c ^ b) & 0xFF] ^ (c >> 8) is linear over
# GF(2) in (c, b) jointly, so for data A||B:
#     reg(c, A||B) = Z^|B| reg(c, A)  ^  reg(0, B)
# where Z^n is the 32x32 matrix of n zero bytes.  A matrix is kept as
# its 32 columns (the images of the basis registers 1 << i).

def _apply_cols(cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(32):
        bit = (x >> np.uint32(i)) & np.uint32(1)
        out ^= cols[i] * bit
    return out


@functools.lru_cache(maxsize=64)
def _zero_operator(n: int) -> np.ndarray:
    """Columns of Z^n."""
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    if n == 0:
        return basis
    if n == 1:
        return np.asarray([_crc32c_register(int(v), b"\x00")
                           for v in basis], dtype=np.uint32)
    half = _zero_operator(n // 2)
    cols = _apply_cols(half, half)          # Z^(2*(n//2))
    if n % 2:
        cols = _apply_cols(_zero_operator(1), cols)
    return cols


@functools.lru_cache(maxsize=64)
def _zero_tables(n: int) -> np.ndarray:
    """Z^n as four 256-entry byte tables: Z^n x = XOR_j tab[j][byte_j(x)]."""
    cols = _zero_operator(n)
    v = np.arange(256, dtype=np.uint32)
    tabs = np.zeros((4, 256), dtype=np.uint32)
    for j in range(4):
        for i in range(8):
            tabs[j] ^= cols[8 * j + i] * ((v >> np.uint32(i)) & np.uint32(1))
    return tabs


def _shift(x: np.ndarray, n: int) -> np.ndarray:
    t = _zero_tables(n)
    return (t[0][x & 0xFF] ^ t[1][(x >> 8) & 0xFF] ^
            t[2][(x >> 16) & 0xFF] ^ t[3][x >> 24])


def crc32c_numpy(data, value: int = 0) -> int:
    """CRC32-C of `data` continuing from `value`, vectorised over lanes."""
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    n = buf.size
    lanes = 1
    while lanes * 2 <= _MAX_LANES and lanes * 2 * _MIN_LANE_BYTES <= n:
        lanes *= 2
    if lanes == 1:
        return crc32c_loop(buf.tobytes(), value)
    m = n // lanes                           # bytes per lane
    body = lanes * m
    cols = buf[:body].reshape(lanes, m).T.copy()  # [m, lanes]
    reg = np.zeros(lanes, dtype=np.uint32)
    for j in range(m):
        reg = _TABLE_NP[(reg ^ cols[j]) & 0xFF] ^ (reg >> np.uint32(8))
    width = m
    while reg.size > 1:                      # fold neighbouring lanes
        reg = _shift(reg[0::2], width) ^ reg[1::2]
        width *= 2
    start = np.asarray([value ^ 0xFFFFFFFF], dtype=np.uint32)
    c = int(_shift(start, body)[0] ^ reg[0])
    # the tail is shorter than `lanes`: it takes fewer, shorter lanes
    return crc32c_numpy(buf[body:], c ^ 0xFFFFFFFF)


def _native_call(entry: str, data, value: int) -> int:
    from .. import native
    lib = native.load_crc32c()
    if lib is None:
        raise RuntimeError("native CRC32-C unavailable: "
                           f"{native.BUILD_INFO['crc32c'].get('error')}")
    if isinstance(data, bytes):
        return getattr(lib, entry)(value, data, len(data))
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    return getattr(lib, entry)(value, buf.ctypes.data, buf.size)


def crc32c_native(data, value: int = 0) -> int:
    """CRC32-C on the native library: the SSE4.2 instruction where the
    CPU has it, else the table loop (`crc32c_extend_sw` alone runs the
    loop whatever the CPU).  Raises RuntimeError where the library does
    not build."""
    return _native_call("crc32c_extend", data, value)


def _google():
    try:
        import google_crc32c
    except ImportError:
        return None

    def crc32c_google(data, value: int = 0) -> int:
        return google_crc32c.extend(value, bytes(data))
    return crc32c_google


_chosen: "tuple[str, object] | None" = None


def _choose() -> "tuple[str, object]":
    """(engine name, function), resolved at the first checksum: nothing
    is built when the module is imported."""
    global _chosen
    if _chosen is None:
        from .. import native
        fn = _google()
        lib = native.load_crc32c() if fn is None else None
        if fn is not None:
            _chosen = ("google_crc32c", fn)
        elif lib is not None:
            _chosen = ("sse4.2" if lib.crc32c_simd() else "sw",
                       crc32c_native)
        else:
            _chosen = ("numpy", crc32c_numpy)
    return _chosen


def engine() -> str:
    """The engine `crc32c` runs on: google_crc32c, sse4.2, sw or numpy."""
    return _choose()[0]


def crc32c(data, value: int = 0) -> int:
    """CRC32-C of `data` continuing from `value` (google_crc32c.extend)."""
    return _choose()[1](data, value)


def crc_value(c: int) -> int:
    """Deprecated legacy .Value() transform kept for pre-3.09 volumes
    (crc.go:25-27): rotl17(c) + 0xa282ead8 mod 2^32."""
    rot = ((c >> 15) | (c << 17)) & 0xFFFFFFFF
    return (rot + 0xA282EAD8) & 0xFFFFFFFF
