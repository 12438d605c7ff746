"""The GF(2^8) constant-matrix apply on packed words: the CUDA kernel's
wrapper and its plain PyTorch version.

    out[r] = XOR_k mat[r,k] * data[k]      (4 GF bytes per 32-bit word)

`gf_apply_matrix_words` launches `csrc/gf_apply.cu` for tensors on a
CUDA device and runs `gf_apply_matrix_words_plain` for tensors on the
CPU; it never falls back from one to the other.  The kernel replaces
the TPU kernel `seaweedfs_tpu/ops/rs_pallas.py:_rs_kernel` and the XLA
network `rs_jax._packed_xor_network`; the plain version is that
network written in torch ops.  `gf_apply_matrix_words_batch` is the
same apply over V volumes in one launch (the volumes' columns indexed
linearly over one grid), in place of the reference's `vmap` over
volumes (`parallel/ec_sharded.py:_apply_tables_batch_local`).

The kernel takes its tables twice: on the device (the generic body
reads them into shared memory) and on the host, copied into the launch
parameters of the specialised templates (`SPECIALISED`), which read
them from the constant bank.  `tables_from_numpy` keeps the host copy
of every table tensor it makes beside it (`host_tables`), so a launch
never copies tables back from the device.

Words are int32 here: PyTorch has no `>>` for uint32 on the CPU.  The
lane mask drops the sign-extended bits of an arithmetic shift and the
product wraps, so every output bit equals the uint32 result.
"""

from __future__ import annotations

import ctypes
import threading
import weakref

import numpy as np
import torch

from . import _build, gf256

SOURCE = "gf_apply.cu"
MAX_SHARDS = 32          # ShardBits is uint32 (ec_context.MAX_SHARD_COUNT)
MAX_VOLUMES = 65535      # volumes a batched launch takes
LANE_MASK = 0x01010101
# (R, K) shapes with a kernel template of their own: RS(10,4)'s encode and
# its rebuilds of 4, 3, 2 and 1 lost shards, and RS(6,3)'s encode and its
# rebuilds of 3, 2 and 1.  Every other shape runs the kernel's generic
# body (runtime K, row groups of <= 8).
SPECIALISED = frozenset([(r, 10) for r in (1, 2, 3, 4)] +
                        [(r, 6) for r in (1, 2, 3)])

# Kernel launches made by gf_apply_matrix_words and by
# gf_apply_matrix_words_batch (one per call on a CUDA tensor).  Read and
# reset by chip_smoke.py to show that the main path went through the
# kernel.
LAUNCHES = 0
LAUNCHES_BATCHED = 0


_host_lock = threading.Lock()
# id(device tables) -> (weak reference, tensor version, host copy)
_host: "dict[int, tuple]" = {}


def _forget(key: int) -> None:
    with _host_lock:
        _host.pop(key, None)


def _remember(tables: torch.Tensor, host: torch.Tensor) -> None:
    key = id(tables)
    with _host_lock:
        _host[key] = (weakref.ref(tables), tables._version, host)
    weakref.finalize(tables, _forget, key)


def host_tables(tables: torch.Tensor) -> torch.Tensor:
    """The host copy (CPU int32) of a table tensor: the tensor itself on
    the CPU, the copy `tables_from_numpy` kept for a tensor it made, or
    else a copy from the device (a synchronising copy, kept for the next
    launch until the tensor changes or is freed)."""
    if tables.device.type == "cpu":
        return tables
    with _host_lock:
        entry = _host.get(id(tables))
    if entry is not None and entry[0]() is tables and \
            entry[1] == tables._version:
        return entry[2]
    host = tables.cpu()
    _remember(tables, host)
    return host


def tables_from_numpy(mat: np.ndarray, device="cpu") -> torch.Tensor:
    """[R, K] uint8 coding matrix -> flat [R*K*8] int32 bit tables,
    tab[(r*K + k)*8 + b] = mat[r,k] * 2^b in GF(2^8) (the layout of
    rs_pallas.expand_tables; every value is < 256), on `device`, with
    its host copy kept for the launches (`host_tables`)."""
    tab = gf256.MUL_BY_POW2[np.asarray(mat, dtype=np.uint8)]
    host = torch.from_numpy(tab.astype(np.int32).reshape(-1))
    if torch.device(device).type == "cpu":
        return host
    out = host.to(device)
    _remember(out, host)
    return out


def specialised(r: int, k: int) -> bool:
    """Does an [R, K] launch run a template of its own (else the
    generic body)?"""
    return (r, k) in SPECIALISED


def kernel_symbol(r: int, k: int, aligned: bool) -> str:
    """A piece of the mangled name of the kernel an [R, K] launch runs,
    on 16-byte-aligned rows (uint4 columns) or not (word columns).  The
    generic body's first row group is named."""
    if specialised(r, k):
        return f"gf_apply_specILi{r}ELi{k}ELb{int(aligned)}E"
    return f"gf_apply_genericILi{min(r, 8)}ELb{int(aligned)}E"


def launch_plan(r: int, k: int, w: int, v: int = 1,
                aligned: bool = True) -> dict:
    """How the kernel launches V [R, K] x W-word applies on the current
    CUDA device: template or generic body, threads a block, resident
    blocks an SM (the occupancy API), SMs, blocks launched, launches
    (row groups), and the columns each thread walks.  Needs the card."""
    info = (ctypes.c_longlong * 6)()
    fn = _build.load(SOURCE).gf_apply_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(v, r, k, w, int(aligned), ctypes.addressof(info))
    if err:
        raise RuntimeError(f"gf_apply_plan failed: cudaError {err}")
    spec, threads, resident, sms, grid, groups = (int(x) for x in info)
    columns = v * (w // 4 if aligned and w % 4 == 0 else w)
    return {"specialised": bool(spec), "threads": threads,
            "resident_blocks_per_sm": resident, "sms": sms,
            "grid_blocks": grid, "launches": groups,
            "waves": grid / (sms * resident),
            "columns_per_thread": columns / (grid * threads)}


def gf_apply_matrix_words_plain(tables: torch.Tensor,
                                data32: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops on any device: tables
    [R*K*8] int32, data32 [K, W] int32 -> [R, W] int32."""
    k, w = data32.shape
    r = tables.numel() // (k * 8)
    tab = tables.view(r, k, 8).to(torch.int32)
    out = torch.zeros((r, w), dtype=torch.int32, device=data32.device)
    for ki in range(k):
        d = data32[ki]
        for b in range(8):
            mask = (d >> b) & LANE_MASK
            out ^= mask.unsqueeze(0) * tab[:, ki, b].unsqueeze(1)
    return out


def gf_apply_matrix_words_batch_plain(tables: torch.Tensor,
                                      batch32: torch.Tensor) -> torch.Tensor:
    """The batched kernel's function in torch ops: tables [R*K*8] int32,
    batch32 [V, K, W] int32 -> [V, R, W] int32."""
    v, k, w = batch32.shape
    r = tables.numel() // (k * 8)
    tab = tables.view(r, k, 8).to(torch.int32)
    out = torch.zeros((v, r, w), dtype=torch.int32, device=batch32.device)
    for ki in range(k):
        d = batch32[:, ki].unsqueeze(1)               # [V, 1, W]
        for b in range(8):
            mask = (d >> b) & LANE_MASK
            out ^= mask * tab[:, ki, b].view(1, r, 1)
    return out


def _check(tables: torch.Tensor, data32: torch.Tensor,
           dims: int = 2) -> "tuple[int, int]":
    """Validate tables [R*K*8] against data [K, W] (dims=2) or a batch
    [V, K, W] (dims=3); returns (R, K)."""
    if tables.device != data32.device:
        raise ValueError(
            f"tables on {tables.device}, data on {data32.device}")
    if tables.dtype != torch.int32 or data32.dtype != torch.int32:
        raise TypeError(
            f"expected int32 tables and words, got {tables.dtype} and "
            f"{data32.dtype}")
    if data32.dim() != dims or tables.dim() != 1:
        want = "[K, W]" if dims == 2 else "[V, K, W]"
        raise ValueError(
            f"expected tables [R*K*8] and data {want}, got "
            f"{tuple(tables.shape)} and {tuple(data32.shape)}")
    k = data32.shape[-2]
    if not 0 < k <= MAX_SHARDS or tables.numel() % (k * 8):
        raise ValueError(
            f"{tables.numel()} table entries do not fit K={k}")
    r = tables.numel() // (k * 8)
    if not 0 < r <= MAX_SHARDS:
        raise ValueError(f"R={r} output rows; at most {MAX_SHARDS}")
    if not (tables.is_contiguous() and data32.is_contiguous()):
        raise ValueError("tables and data must be contiguous")
    return r, k


def _kernel(batched: bool = False):
    lib = _build.load(SOURCE)
    ptrs = [ctypes.c_void_p] * 4      # tables, host tables, data, out
    if batched:
        fn = lib.gf_apply_words_batched
        fn.argtypes = ptrs + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_void_p]
    else:
        fn = lib.gf_apply_words
        fn.argtypes = ptrs + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gf_apply_matrix_words(tables: torch.Tensor, data32: torch.Tensor,
                          stream: "torch.cuda.Stream | None" = None
                          ) -> torch.Tensor:
    """tables [R*K*8] int32 (`tables_from_numpy`), data32 [K, W] int32
    -> [R, W] int32, on the device the inputs lie on.

    On a CUDA device it launches the kernel on `stream` (default: the
    current stream of the calling thread) and raises if the launch
    fails; the output is allocated on that stream.  On the CPU it runs
    the plain version."""
    global LAUNCHES
    r, k = _check(tables, data32)
    if data32.device.type == "cpu":
        return gf_apply_matrix_words_plain(tables, data32)
    if data32.device.type != "cuda":
        raise ValueError(f"no kernel for device {data32.device}")
    fn = _kernel()
    if stream is None:
        stream = torch.cuda.current_stream(data32.device)
    w = data32.shape[1]
    # the kernel's host code reads the SM count from the CURRENT device,
    # and CUDA refuses a launch onto another device's stream: make the
    # data's device current for the allocation and the launch
    with torch.cuda.device(data32.device), torch.cuda.stream(stream):
        out = torch.empty((r, w), dtype=torch.int32, device=data32.device)
        err = fn(tables.data_ptr(), host_tables(tables).data_ptr(),
                 data32.data_ptr(), out.data_ptr(), r, k, w,
                 stream.cuda_stream)
    if err:
        raise RuntimeError(
            f"gf_apply_words launch failed: cudaError {err} "
            f"(R={r} K={k} W={w})")
    LAUNCHES += 1
    return out


def gf_apply_matrix_words_generic(tables: torch.Tensor,
                                  data32: torch.Tensor) -> torch.Tensor:
    """The single apply through the kernel's generic body whatever the
    shape, on the current stream of a CUDA device: the yardstick a
    template is timed against (chip_smoke.py's kernel phase).  Never on
    the main path, so it counts no launch."""
    r, k = _check(tables, data32)
    if data32.device.type != "cuda":
        raise ValueError(f"no kernel for device {data32.device}")
    fn = _build.load(SOURCE).gf_apply_words_generic
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    w = data32.shape[1]
    with torch.cuda.device(data32.device):
        stream = torch.cuda.current_stream(data32.device)
        out = torch.empty((r, w), dtype=torch.int32, device=data32.device)
        err = fn(tables.data_ptr(), data32.data_ptr(), out.data_ptr(), r, k,
                 w, stream.cuda_stream)
    if err:
        raise RuntimeError(f"gf_apply_words_generic launch failed: "
                           f"cudaError {err} (R={r} K={k} W={w})")
    return out


def gf_apply_matrix_words_batch(tables: torch.Tensor, batch32: torch.Tensor,
                                stream: "torch.cuda.Stream | None" = None
                                ) -> torch.Tensor:
    """tables [R*K*8] int32, batch32 [V, K, W] int32 -> [V, R, W] int32:
    the same matrix applied to each of V volumes, in ONE kernel launch
    on a CUDA device (on `stream`, default the calling thread's current
    stream; raises if the launch fails), or the plain version on the
    CPU."""
    global LAUNCHES_BATCHED
    r, k = _check(tables, batch32, dims=3)
    v, _k, w = batch32.shape
    if not 0 < v <= MAX_VOLUMES:
        raise ValueError(f"V={v} volumes; at most {MAX_VOLUMES} a launch")
    if batch32.device.type == "cpu":
        return gf_apply_matrix_words_batch_plain(tables, batch32)
    if batch32.device.type != "cuda":
        raise ValueError(f"no kernel for device {batch32.device}")
    fn = _kernel(batched=True)
    if stream is None:
        stream = torch.cuda.current_stream(batch32.device)
    with torch.cuda.device(batch32.device), torch.cuda.stream(stream):
        out = torch.empty((v, r, w), dtype=torch.int32,
                          device=batch32.device)
        err = fn(tables.data_ptr(), host_tables(tables).data_ptr(),
                 batch32.data_ptr(), out.data_ptr(), v, r, k, w,
                 stream.cuda_stream)
    if err:
        raise RuntimeError(
            f"gf_apply_words_batched launch failed: cudaError {err} "
            f"(V={v} R={r} K={k} W={w})")
    LAUNCHES_BATCHED += 1
    return out
