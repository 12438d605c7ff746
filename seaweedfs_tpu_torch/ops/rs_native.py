"""Reed-Solomon on the host's native C++ codec (`native/gf_rs.cc`): the
engine of degraded needle reads when it builds (the port's copy of
`seaweedfs_tpu/ops/rs_native.py`).

Same API as `rs_cpu.ReedSolomonCPU`: `parity`, `encode`, `apply_matrix`,
`reconstruct`, `verify`, byte for byte the same answers.  Check
`available()` before constructing one; `server/store_ec.EcReader` takes
the numpy codec when it is false.  `gf_native_simd()` names the tier the
library runs on this CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from . import rs_matrix

# gf_native_simd()'s codes (native/gf_rs.cc)
SIMD_TIERS = {4: "gfni-avx512", 3: "avx512bw", 2: "avx2", 1: "scalar"}


def available() -> bool:
    return native.available()


def gf_native_simd() -> "str | None":
    """The SIMD tier the native codec runs on this CPU (GFNI + AVX512,
    AVX512BW or AVX2 nibble tables, scalar), or None when it does not
    build."""
    lib = native.load()
    return None if lib is None else SIMD_TIERS[lib.gf_native_simd()]


def _row_ptrs(arr2d: np.ndarray) -> "ctypes.Array":
    n = arr2d.shape[0]
    ptrs = (ctypes.c_void_p * n)()
    base = arr2d.ctypes.data
    stride = arr2d.strides[0]
    for i in range(n):
        ptrs[i] = base + i * stride
    return ptrs


class ReedSolomonNative:
    """RS(data, parity) over GF(2^8) on the native library, with shards as
    uint8 arrays of equal length."""

    def __init__(self, data_shards: int, parity_shards: int):
        self._lib = native.load()
        if self._lib is None:
            err = native.BUILD_INFO.get("gf_rs", {}).get("error", "")
            raise RuntimeError(f"native GF library unavailable: {err}")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = rs_matrix.build_matrix(data_shards, self.total_shards)
        self.parity_rows = np.ascontiguousarray(self.matrix[data_shards:])

    def _apply(self, mat: np.ndarray, data: np.ndarray) -> np.ndarray:
        mat = np.ascontiguousarray(mat, dtype=np.uint8)
        data = np.ascontiguousarray(data, dtype=np.uint8)
        r, k = mat.shape
        if data.ndim != 2 or data.shape[0] != k:
            raise ValueError(f"expected [{k}, B] input rows, got "
                             f"{data.shape}")
        # accumulate=0: the library overwrites, so no zero fill
        out = np.empty((r, data.shape[1]), dtype=np.uint8)
        self._lib.gf_matrix_apply(
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            r, k, _row_ptrs(data), _row_ptrs(out), data.shape[1], 0)
        return out

    def apply_matrix(self, mat: np.ndarray, data: np.ndarray
                     ) -> np.ndarray:
        """out[r] = XOR_k mat[r,k] * data[k]: the generic apply the
        streamed degraded read drives window by window."""
        return self._apply(mat, data)

    def parity(self, data: np.ndarray) -> np.ndarray:
        """data: [data, B] -> parity [parity, B]."""
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != self.data_shards:
            raise ValueError(f"expected [{self.data_shards}, B], "
                             f"got {data.shape}")
        return self._apply(self.parity_rows, data)

    def encode(self, shards: np.ndarray) -> np.ndarray:
        """shards: [total, B] with data in rows [:data]; returns a new
        array with the parity rows filled in."""
        shards = np.asarray(shards, dtype=np.uint8)
        out = shards.copy()
        out[self.data_shards:] = self.parity(shards[: self.data_shards])
        return out

    def verify(self, shards: np.ndarray) -> bool:
        shards = np.asarray(shards, dtype=np.uint8)
        return bool(np.array_equal(
            self.parity(shards[: self.data_shards]),
            shards[self.data_shards:]))

    def reconstruct(self, shards: np.ndarray, present,
                    data_only: bool = False) -> np.ndarray:
        """Fill the rows of `shards` [total, B] where `present` is False;
        `data_only` leaves missing parity rows as they are (the
        reference's ReconstructData, store_ec.go:435)."""
        shards = np.asarray(shards, dtype=np.uint8)
        present = list(present)
        if len(present) != self.total_shards:
            raise ValueError("presence mask length must equal total shards")
        missing_data = [i for i in range(self.data_shards)
                        if not present[i]]
        missing_parity = [i for i in
                          range(self.data_shards, self.total_shards)
                          if not present[i]]
        out = shards.copy()
        if missing_data:
            m, rows = rs_matrix.cached_reconstruction_matrix(
                self.data_shards, self.parity_shards, tuple(present),
                tuple(missing_data))
            out[missing_data] = self._apply(m, shards[list(rows)])
        if missing_parity and not data_only:
            sel = self.parity_rows[
                [i - self.data_shards for i in missing_parity]]
            out[missing_parity] = self._apply(sel, out[: self.data_shards])
        return out
