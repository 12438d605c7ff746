"""Reed-Solomon codec on PyTorch: the GF(2^8) constant-matrix apply runs
as the CUDA kernel of `rs_cuda` on the card, or as its plain version on
the CPU.

The counterpart of `seaweedfs_tpu/ops/rs_jax.py` (`ReedSolomonJax`),
with the same API and the same bytes out.  Host buffers are packed to
32-bit words (a free numpy view), so the device never relayouts bytes.

A lazy launch (`parity_lazy`, `apply_matrix_lazy`) of a batch larger
than one staging window is a `staging.WindowedLaunch`: a staging thread
copies window after window into pinned buffers and to the device on the
codec's copy stream, and the kernel and the copy back run on its compute
stream, while the caller's writer drains the finished windows.  A batch
within one window (or any batch with SEAWEEDFS_TPU_H2D_WINDOW_MB=0) is
copied, launched and copied back in one shot on the compute stream, and
`materialize()` waits on its event.  Streams are passed explicitly
everywhere: PyTorch's current stream is per thread.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import profiling
from . import rs_cuda, rs_matrix, staging

# Pack batches to 16-byte multiples: rows of W words are then 16-byte
# aligned and the kernel takes its uint4 path.
PACK_MULTIPLE = 16


def pack_words(data: np.ndarray, multiple: int = 4) -> np.ndarray:
    """Host-side [K, B] uint8 -> [K, ceil(B/4)] uint32 (pads B up to
    `multiple` bytes; multiple must itself be a multiple of 4)."""
    if multiple % 4:
        raise ValueError(f"multiple={multiple} is not a multiple of 4")
    data = np.ascontiguousarray(data)
    k, b = data.shape
    pad = (-b) % multiple
    if pad:
        data = np.pad(data, ((0, 0), (0, pad)))
    return data.view(np.uint32)


def unpack_words(data32: np.ndarray, b: int) -> np.ndarray:
    """Host-side [R, W] uint32 -> [R, b] uint8."""
    return np.ascontiguousarray(data32).view(np.uint8)[:, :b]


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the codec on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def gf_apply_matrix(mat, data, device="cuda"):
    """out[r] = XOR_k mat[r,k] * data[k] over GF(2^8), computed on
    `device`: the CUDA card unless the caller passes "cpu" (raises when
    there is no card; never falls back to the CPU).

    mat: [R, K] uint8.  data: [K, ...] uint8, numpy (packed on the host;
    returns numpy) or a torch tensor (packed where it lies; returns a
    uint8 tensor on `device`).  The batch is padded to a word multiple
    internally and cut back."""
    dev = _resolve_device(device)
    mat = np.asarray(mat, dtype=np.uint8)
    k = data.shape[0]
    batch_shape = tuple(data.shape[1:])
    tables = rs_cuda.tables_from_numpy(mat, dev)
    if isinstance(data, np.ndarray):
        flat = pack_words(data.reshape(k, -1).astype(np.uint8, copy=False),
                          PACK_MULTIPLE)
        b = int(np.prod(batch_shape))
        words = torch.from_numpy(flat.view(np.int32)).to(dev)
        out32 = rs_cuda.gf_apply_matrix_words(tables, words)
        out = unpack_words(out32.cpu().numpy(), b)
        return out.reshape((mat.shape[0],) + batch_shape)
    flat = data.to(dev, torch.uint8).reshape(k, -1)
    b = flat.shape[1]
    pad = (-b) % PACK_MULTIPLE
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    out32 = rs_cuda.gf_apply_matrix_words(
        tables, flat.contiguous().view(torch.int32))
    out = out32.view(torch.uint8)[:, :b]
    return out.reshape((mat.shape[0],) + batch_shape)


def _windowed_wanted(flat: np.ndarray) -> bool:
    """Take the windowed staging path (ops.staging)?  Yes when windowing
    is on and the batch spans more than one window; a batch within one
    window gains nothing from a staging thread and launches in one shot.
    """
    wb = staging.window_bytes()
    return wb > 0 and flat.nbytes > wb


class _PendingParity:
    """An in-flight one-shot codec launch (see ReedSolomonTorch.
    parity_lazy): the whole batch in one h2d copy, one kernel launch and
    one d2h copy, or the plain version's result on the CPU."""

    def __init__(self, nbytes: int, host: torch.Tensor, dispatched_at: float,
                 event=None, pinned_in=None, keep=()):
        self._nbytes = nbytes
        self._host = host            # [R, W] int32 output (pinned on CUDA)
        self._dispatched_at = dispatched_at
        self._event = event
        self._pinned_in = pinned_in
        self._keep = keep            # device tensors the launch uses
        self._result: "np.ndarray | None" = None

    def _release(self) -> None:
        if self._event is not None:
            self._event.synchronize()
            staging.POOL.give(self._pinned_in, pinned=True)
            staging.POOL.give(self._host, pinned=True)
            self._event = None
        self._pinned_in = None
        self._host = None
        self._keep = ()

    def materialize(self) -> np.ndarray:
        """Wait for the launch; returns uint8 [R, B] (a copy: the pinned
        buffer goes back to the pool).  Records the d2h wait and the
        dispatch-to-fetch kernel window, as the reference's
        _PendingParity.materialize does."""
        if self._result is None:
            t0 = time.perf_counter()
            if self._event is not None:
                self._event.synchronize()
            fetch = time.perf_counter() - t0
            host = self._host.numpy()
            self._result = unpack_words(host, self._nbytes).copy()
            profiling.device_note("d2h", host.nbytes, fetch)
            profiling.kernel_note("gf_apply_matrix",
                                  t0 + fetch - self._dispatched_at,
                                  host.nbytes)
            self._release()
        return self._result

    def abort(self) -> None:
        """Drop a launch whose result is not wanted, once the device is
        done with its buffers."""
        self._release()


class ReedSolomonTorch:
    """RS(data, parity) codec on `device` ("cuda" by default, or "cpu"),
    API-compatible with `seaweedfs_tpu.ops.rs_jax.ReedSolomonJax`.
    Raises when asked for CUDA and none is present."""

    _MAX_CACHED_MATRICES = 64

    def __init__(self, data_shards: int, parity_shards: int,
                 device="cuda"):
        self.device = _resolve_device(device)
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = rs_matrix.build_matrix(data_shards, self.total_shards)
        self._parity_rows = np.ascontiguousarray(self.matrix[data_shards:])
        self._stream = None          # compute: kernels and d2h copies
        self._copy_stream = None     # windowed h2d copies
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
        self._tables_lock = threading.Lock()
        self._tables: dict[bytes, torch.Tensor] = {}
        self._parity_tables = self._device_tables(self._parity_rows)

    def _device_tables(self, mat: np.ndarray) -> torch.Tensor:
        """The bit tables of `mat` on the device (cached: a rebuild
        applies one matrix to every batch)."""
        mat = np.ascontiguousarray(mat, dtype=np.uint8)
        key = bytes(mat.shape) + mat.tobytes()
        with self._tables_lock:
            tab = self._tables.get(key)
            if tab is None:
                if len(self._tables) >= self._MAX_CACHED_MATRICES:
                    self._tables.clear()
                if self._stream is None:
                    tab = rs_cuda.tables_from_numpy(mat)
                else:
                    with torch.cuda.stream(self._stream):
                        tab = rs_cuda.tables_from_numpy(mat, self.device)
                    self._stream.synchronize()
                self._tables[key] = tab
            return tab

    def _check(self, arr, rows: int):
        """Validate without converting: numpy stays numpy so the host
        word-packing path is taken."""
        if not hasattr(arr, "dtype"):
            arr = np.asarray(arr, dtype=np.uint8)
        want = torch.uint8 if isinstance(arr, torch.Tensor) else np.uint8
        if arr.dtype != want:
            raise TypeError(f"shards must be uint8, got {arr.dtype}")
        if arr.ndim != 2 or arr.shape[0] != rows:
            raise ValueError(
                f"expected [{rows}, B] shard array, got {tuple(arr.shape)}")
        return arr

    def _launch(self, tables: torch.Tensor, data, op: str):
        data = np.ascontiguousarray(data)
        b = data.shape[1]
        flat = pack_words(data, PACK_MULTIPLE).view(np.int32)
        r = tables.numel() // (data.shape[0] * 8)
        if _windowed_wanted(flat):
            return staging.WindowedLaunch(
                tables, flat, r, b, self.device, op=op,
                streams=(self._copy_stream, self._stream))
        profiling.device_note("h2d", flat.nbytes, None)
        if self._stream is None:
            t_dispatch = time.perf_counter()
            out32 = rs_cuda.gf_apply_matrix_words(
                tables, torch.from_numpy(flat))
            return _PendingParity(b, out32, t_dispatch)
        pin_in = staging.POOL.take(flat.shape, pinned=True)
        pin_out = staging.POOL.take((r, flat.shape[1]), pinned=True)
        pin_in.copy_(torch.from_numpy(flat))
        s = self._stream
        with torch.cuda.stream(s):
            dev_in = pin_in.to(self.device, non_blocking=True)
            t_dispatch = time.perf_counter()
            out32 = rs_cuda.gf_apply_matrix_words(tables, dev_in, stream=s)
            pin_out.copy_(out32, non_blocking=True)
            event = torch.cuda.Event(blocking=True)
            event.record(s)
        return _PendingParity(b, pin_out, t_dispatch, event=event,
                              pinned_in=pin_in, keep=(dev_in, out32))

    # -- encode ------------------------------------------------------------

    def parity(self, data):
        """data: [data_shards, B] uint8 -> parity [parity_shards, B]."""
        data = self._check(data, self.data_shards)
        return gf_apply_matrix(self._parity_rows, data, self.device)

    def parity_lazy(self, data):
        """Launch the parity computation WITHOUT waiting for it.

        Returns a handle whose .materialize() waits for the device and
        yields the [parity_shards, B] uint8 numpy array, so a pipeline
        overlaps launch k's d2h with launch k+1's h2d and kernel.  A
        batch larger than one staging window gives a
        staging.WindowedLaunch, whose .windows() also yields the parity
        window by window as it lands.

        Aliasing contract: callers recycle `data` only after
        materialize() returns or windows() is drained
        (ec_encoder._staged_run)."""
        data = self._check(data, self.data_shards)
        return self._launch(self._parity_tables, data, "encode")

    def apply_matrix(self, mat, data) -> np.ndarray:
        """out[r] = XOR_k mat[r,k] * data[k] — public generic apply."""
        return gf_apply_matrix(mat, data, self.device)

    def apply_matrix_lazy(self, mat, data):
        """Generic apply launched without waiting (same contract and the
        same staging as parity_lazy)."""
        mat = np.asarray(mat, dtype=np.uint8)
        data = self._check(data, mat.shape[1])
        return self._launch(self._device_tables(mat), data, "rebuild")

    def encode(self, shards) -> np.ndarray:
        """shards: [total, B] with data rows filled; returns the full
        array with parity rows computed."""
        shards = self._check(shards, self.total_shards)
        data = shards[: self.data_shards]
        par = gf_apply_matrix(self._parity_rows, data, self.device)
        if isinstance(shards, np.ndarray):
            return np.concatenate([data, par], axis=0)
        return torch.cat([data.to(par.device), par], dim=0)

    def verify(self, shards) -> bool:
        shards = self._check(shards, self.total_shards)
        par = gf_apply_matrix(self._parity_rows, shards[: self.data_shards],
                              self.device)
        if isinstance(shards, np.ndarray):
            return bool(np.array_equal(par, shards[self.data_shards:]))
        return bool(torch.equal(par.cpu(), shards[self.data_shards:].cpu()))

    # -- reconstruct -------------------------------------------------------

    def reconstruct_onto(self, survivors, survivor_indices, present,
                         targets):
        """Compute shard rows `targets` from surviving shards.

        survivors: [data_shards, B] uint8 shard rows, in the order named
        by survivor_indices, which must be the first `data_shards`
        present shard ids in ascending order (the order the decode
        matrix is built for); anything else raises rather than silently
        producing corrupt output.  present: total-length bool mask.
        targets: shard ids to produce (data and/or parity)."""
        m, rows = rs_matrix.cached_reconstruction_matrix(
            self.data_shards, self.parity_shards,
            tuple(bool(x) for x in present), tuple(int(t) for t in targets))
        if tuple(int(i) for i in survivor_indices) != rows:
            raise ValueError(
                f"survivors must be shards {list(rows)} in that order, "
                f"got {list(survivor_indices)}")
        survivors = self._check(survivors, self.data_shards)
        return gf_apply_matrix(m, survivors, self.device)

    def reconstruct(self, shards, present, data_only: bool = False
                    ) -> np.ndarray:
        """Fill missing rows of `shards` (host array in, host array out);
        mirrors rs_cpu.ReedSolomonCPU.reconstruct."""
        shards = np.asarray(shards, dtype=np.uint8)
        present = [bool(x) for x in present]
        if shards.shape[0] != self.total_shards or \
                len(present) != self.total_shards:
            raise ValueError("bad shard array / presence mask")
        survivor_rows = [i for i in range(self.total_shards) if present[i]]
        if len(survivor_rows) < self.data_shards:
            raise ValueError("too few shards present to reconstruct")
        survivor_rows = survivor_rows[: self.data_shards]
        targets = [i for i in range(self.total_shards) if not present[i]]
        if data_only:
            targets = [i for i in targets if i < self.data_shards]
        if not targets:
            return shards.copy()
        rec = self.reconstruct_onto(
            shards[survivor_rows], survivor_rows, present, targets)
        out = shards.copy()
        out[targets] = rec
        return out
