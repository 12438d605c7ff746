"""Reed-Solomon on the host CPU with numpy: the engine of degraded needle
reads (`seaweedfs_tpu/ops/rs_cpu.py`, `ReedSolomonCPU`).

A single-needle read that must rebuild a lost interval is bound by its
latency, not by throughput: the reference reconstructs it on a CPU
codec (weed/storage/store_ec.go:366), and so does the port's
`server/store_ec.EcReader`.  The card's batched kernel is kept for bulk
encode and rebuild.  This is not the plain version of the CUDA kernel
(`rs_cuda.gf_apply_matrix_words_plain`): it works on bytes, with
256-entry product tables (`gf256.gf_apply_matrix`).
"""

from __future__ import annotations

import numpy as np

from . import gf256, rs_matrix


class ReedSolomonCPU:
    """Encoder/decoder for RS(data, parity) over GF(2^8), numpy-based,
    with shards as uint8 arrays of equal length (ec_encoder.go:265
    Encode, :360 Reconstruct, store_ec.go:435 ReconstructData)."""

    def __init__(self, data_shards: int, parity_shards: int):
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = rs_matrix.build_matrix(data_shards, self.total_shards)
        self.parity_rows = self.matrix[data_shards:].copy()

    # -- encode ------------------------------------------------------------

    def _check_shards(self, shards: np.ndarray, rows: int) -> np.ndarray:
        shards = np.asarray(shards)
        if shards.dtype != np.uint8:
            raise TypeError(f"shards must be uint8, got {shards.dtype}")
        if shards.ndim != 2 or shards.shape[0] != rows:
            raise ValueError(
                f"expected [{rows}, B] shard array, got {shards.shape}")
        return shards

    def encode(self, shards: np.ndarray) -> np.ndarray:
        """shards: [total, B] uint8 with data in rows [:data]; returns a new
        array with parity rows filled in."""
        shards = self._check_shards(shards, self.total_shards)
        out = shards.copy()
        out[self.data_shards:] = gf256.gf_apply_matrix(
            self.parity_rows, shards[: self.data_shards])
        return out

    def parity(self, data: np.ndarray) -> np.ndarray:
        """data: [data, B] -> parity [parity, B]."""
        data = self._check_shards(data, self.data_shards)
        return gf256.gf_apply_matrix(self.parity_rows, data)

    def apply_matrix(self, mat: np.ndarray, data: np.ndarray
                     ) -> np.ndarray:
        """out[r] = XOR_k mat[r,k] * data[k]: the generic apply the
        streamed degraded read drives window by window."""
        return gf256.gf_apply_matrix(mat, data)

    # -- verify ------------------------------------------------------------

    def verify(self, shards: np.ndarray) -> bool:
        shards = self._check_shards(shards, self.total_shards)
        expected = self.parity(shards[: self.data_shards])
        return bool(np.array_equal(expected, shards[self.data_shards:]))

    # -- reconstruct -------------------------------------------------------

    def reconstruct(self, shards: np.ndarray, present, data_only: bool = False
                    ) -> np.ndarray:
        """Fill missing rows of `shards` given presence mask `present`.

        shards: [total, B]; rows where present[i] is False are ignored on
        input and overwritten on output.  data_only is the reference's
        ReconstructData (store_ec.go:435): parity rows are left untouched.
        """
        shards = self._check_shards(shards, self.total_shards)
        present = list(present)
        if len(present) != self.total_shards:
            raise ValueError("presence mask length must equal total shards")
        missing_data = [i for i in range(self.data_shards) if not present[i]]
        missing_parity = [i for i in range(self.data_shards, self.total_shards)
                          if not present[i]]
        out = shards.copy()
        if missing_data:
            m, rows = rs_matrix.cached_reconstruction_matrix(
                self.data_shards, self.parity_shards, tuple(present),
                tuple(missing_data))
            out[missing_data] = gf256.gf_apply_matrix(m, shards[list(rows)])
        if missing_parity and not data_only:
            rows_needed = self.parity_rows[
                [i - self.data_shards for i in missing_parity]]
            out[missing_parity] = gf256.gf_apply_matrix(
                rows_needed, out[: self.data_shards])
        return out
