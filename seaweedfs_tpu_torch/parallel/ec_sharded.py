"""Sharded erasure coding over a device grid (the counterpart of
`seaweedfs_tpu/parallel/ec_sharded.py`, whose shard_map and ppermute
become explicit per-device launches and peer copies).

  * encode: parity rows split over the "shard" axis, stripe columns (or
    volumes) over the "stripe" axis.  No exchange is needed: GF parity
    is column-independent, so each device computes its block.
  * reconstruct: survivor shard rows split over the "shard" axis (one
    group of shards per device, the storage layout).  Each device
    computes its partial XOR-sum of coefficient x shard terms, and a
    ring of peer copies XOR-reduces them (NCCL has no XOR reduction);
    XOR is associative and commutative, so the result is bit-exact.

Each device's part is launched on that device's own stream
(`DeviceGrid.stream`) through the CUDA kernel's wrappers
(`ops.rs_cuda`), or their plain versions on CPU devices.  Data rides as
packed 32-bit words ([K, W], 4 GF bytes a word).  Results land on the
grid's first device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import rs_cuda, rs_matrix
from .mesh import SHARD_AXIS, STRIPE_AXIS, DeviceGrid


def _words(x) -> torch.Tensor:
    """Packed words as an int32 tensor: numpy uint32/int32 is viewed,
    a tensor must already be int32."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"expected int32 words, got {x.dtype}")
        return x
    x = np.ascontiguousarray(x)
    if x.dtype not in (np.uint32, np.int32):
        raise TypeError(f"expected 32-bit words, got {x.dtype}")
    return torch.from_numpy(x.view(np.int32))


@contextlib.contextmanager
def _on(mesh: DeviceGrid, dev: torch.device):
    """Run the block on `dev`'s grid stream, after the work already
    queued on that device's current stream."""
    s = mesh.stream(dev)
    if s is None:
        yield None
        return
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        yield s


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} ({n}) is not divisible by the grid "
                         f"axis ({parts})")
    return n // parts


def _ring_xor(parts: "list[torch.Tensor]", devices: "list[torch.device]"
              ) -> "list[torch.Tensor]":
    """XOR all-reduce over one shard-axis row of the grid by a ring of
    peer copies: s-1 hops, in each of which every device receives its
    left neighbour's block (`.to(next_device, non_blocking=True)`) and
    XORs it into its sum.  Every device ends with the XOR of all s
    blocks.  On a grid of one device there are no hops."""
    s = len(parts)
    acc = list(parts)
    t = list(parts)
    for _ in range(s - 1):
        t = [t[(j - 1) % s].to(devices[j], non_blocking=True)
             for j in range(s)]
        acc = [acc[j] ^ t[j] for j in range(s)]
    return acc


def encode_sharded(mesh: DeviceGrid, mat, data32) -> torch.Tensor:
    """Distributed parity computation.

    mat: [R, K] uint8 parity rows (R divisible by the "shard" axis).
    data32: [K, W] packed words (W divisible by the "stripe" axis).
    Returns [R, W] int32 on the grid's first device."""
    mat = np.asarray(mat, dtype=np.uint8)
    x = _words(data32)
    r, k = mat.shape
    if x.dim() != 2 or x.shape[0] != k:
        raise ValueError(f"data {tuple(x.shape)} does not fit [{k}, W]")
    s, h = mesh.shape[STRIPE_AXIS], mesh.shape[SHARD_AXIS]
    rl = _split(r, h, "parity rows")
    wl = _split(x.shape[1], s, "word columns")
    parts = [[None] * h for _ in range(s)]
    for i in range(s):
        for j in range(h):
            dev = mesh.devices[i][j]
            with _on(mesh, dev) as st:
                tab = rs_cuda.tables_from_numpy(
                    mat[j * rl:(j + 1) * rl], dev)
                cols = x[:, i * wl:(i + 1) * wl].to(dev).contiguous()
                parts[i][j] = rs_cuda.gf_apply_matrix_words(tab, cols,
                                                            stream=st)
    mesh.synchronize()
    out = mesh.devices[0][0]
    return torch.cat([torch.cat([parts[i][j].to(out) for i in range(s)],
                                dim=1) for j in range(h)], dim=0)


def reconstruct_sharded(mesh: DeviceGrid, coeffs, survivors32
                        ) -> torch.Tensor:
    """Distributed reconstruction: survivor rows split over the "shard"
    axis, the target rows produced on every shard-axis device by the
    ring XOR.

    coeffs: [T, K] uint8 reconstruction matrix (targets x survivors); K
    must be divisible by the shard axis (pad with `pad_survivors`: zero
    coefficients add nothing to the XOR).  survivors32: [K, W] packed
    words.  Returns [T, W] int32 on the grid's first device."""
    coeffs = np.asarray(coeffs, dtype=np.uint8)
    x = _words(survivors32)
    t, k = coeffs.shape
    if x.dim() != 2 or x.shape[0] != k:
        raise ValueError(f"survivors {tuple(x.shape)} do not fit [{k}, W]")
    s, h = mesh.shape[STRIPE_AXIS], mesh.shape[SHARD_AXIS]
    kl = _split(k, h, "survivor rows")
    wl = _split(x.shape[1], s, "word columns")
    partial = [[None] * h for _ in range(s)]
    for i in range(s):
        for j in range(h):
            dev = mesh.devices[i][j]
            with _on(mesh, dev) as st:
                tab = rs_cuda.tables_from_numpy(
                    np.ascontiguousarray(coeffs[:, j * kl:(j + 1) * kl]),
                    dev)
                rows = x[j * kl:(j + 1) * kl,
                         i * wl:(i + 1) * wl].to(dev).contiguous()
                partial[i][j] = rs_cuda.gf_apply_matrix_words(tab, rows,
                                                              stream=st)
    mesh.synchronize()
    out = mesh.devices[0][0]
    return torch.cat([_ring_xor(partial[i], mesh.devices[i])[0].to(out)
                      for i in range(s)], dim=1)


def encode_volume_batch(mesh: DeviceGrid, mat, batch32) -> torch.Tensor:
    """Batch-of-volumes encode (BASELINE.json config 3): volumes split
    over the "stripe" axis, parity rows over the "shard" axis; each
    device's block is ONE batched kernel launch.

    mat: [R, K] uint8; batch32: [V, K, W] packed words, V divisible by
    the stripe axis.  Returns [V, R, W] int32 on the grid's first
    device."""
    mat = np.asarray(mat, dtype=np.uint8)
    x = _words(batch32)
    r, k = mat.shape
    if x.dim() != 3 or x.shape[1] != k:
        raise ValueError(f"batch {tuple(x.shape)} does not fit [V, {k}, W]")
    s, h = mesh.shape[STRIPE_AXIS], mesh.shape[SHARD_AXIS]
    rl = _split(r, h, "parity rows")
    vl = _split(x.shape[0], s, "volumes")
    parts = [[None] * h for _ in range(s)]
    for i in range(s):
        for j in range(h):
            dev = mesh.devices[i][j]
            with _on(mesh, dev) as st:
                tab = rs_cuda.tables_from_numpy(
                    mat[j * rl:(j + 1) * rl], dev)
                vols = x[i * vl:(i + 1) * vl].to(dev).contiguous()
                parts[i][j] = rs_cuda.gf_apply_matrix_words_batch(
                    tab, vols, stream=st)
    mesh.synchronize()
    out = mesh.devices[0][0]
    return torch.cat([torch.cat([parts[i][j].to(out) for j in range(h)],
                                dim=1) for i in range(s)], dim=0)


def pad_survivors(coeffs: np.ndarray, survivors32: np.ndarray,
                  multiple: int):
    """Pad the survivor dimension up to `multiple` with zero rows and
    columns (zero GF coefficients contribute nothing to the XOR sum)."""
    t, k = coeffs.shape
    pad = (-k) % multiple
    if pad == 0:
        return coeffs, survivors32
    coeffs = np.pad(coeffs, ((0, 0), (0, pad)))
    survivors32 = np.pad(survivors32, ((0, pad), (0, 0)))
    return coeffs, survivors32


def distributed_ec_step(mesh: DeviceGrid, data32, data_shards: int = 10,
                        parity_shards: int = 4, lost=(0, 11)):
    """One full distributed EC step: encode a striped batch over the
    grid, lose shards `lost`, reconstruct them distributed, and return
    (parity, reconstructed, max_abs_error) as host uint32 arrays and an
    int (0 when every lost row came back bit for bit)."""
    total = data_shards + parity_shards
    shard_ax = mesh.shape[SHARD_AXIS]
    x = _words(data32)
    if x.dim() != 2 or x.shape[0] != data_shards:
        raise ValueError(f"data {tuple(x.shape)} does not fit "
                         f"[{data_shards}, W]")
    parity_mat = rs_matrix.parity_matrix(data_shards, parity_shards)
    present = [i not in lost for i in range(total)]
    coeffs, rows = rs_matrix.reconstruction_matrix(
        data_shards, parity_shards, present, list(lost))
    pad = (-len(rows)) % shard_ax
    coeffs, _ = pad_survivors(
        coeffs, np.zeros((len(rows), 0), np.uint32), shard_ax)
    par = encode_sharded(mesh, parity_mat, x)
    all_shards = torch.cat([x.to(par.device), par], dim=0)
    survivors = all_shards[list(rows)]
    if pad:
        survivors = torch.cat(
            [survivors, torch.zeros((pad, survivors.shape[1]),
                                    dtype=torch.int32,
                                    device=survivors.device)], dim=0)
    rec = reconstruct_sharded(mesh, coeffs, survivors)
    # the difference of the words read as uint32, as the reference's
    lost_rows = all_shards[list(lost)].to(torch.int64) & 0xFFFFFFFF
    err = int((lost_rows - (rec.to(torch.int64) & 0xFFFFFFFF))
              .abs().max().item())
    return (par.cpu().numpy().view(np.uint32),
            rec.cpu().numpy().view(np.uint32), err)
