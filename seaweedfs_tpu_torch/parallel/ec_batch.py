"""Multi-volume batched EC file encode over a device grid (the
counterpart of `seaweedfs_tpu/parallel/ec_batch.py`).

BASELINE.json config 3 is a 64-volume `ec.encode` batch.  The reference
encodes volumes one at a time on whatever worker picks them up
(worker/tasks/erasure_coding/ec_task.go:426); on the card one launch
carries every volume's stripe rows (`ec_sharded.encode_volume_batch`,
one batched kernel launch per device), with volumes on the grid's
"stripe" axis and parity rows on its "shard" axis.

Output is byte-identical to `write_ec_files` per volume: every volume
keeps the reference's small-row geometry (ec_encoder.go:304-319), rows
are stacked per step as in the single-volume aggregated path, and only
each volume's real bytes are written.  Volumes large enough to hold 1GB
large-block rows (>= 10GB) take the per-volume path.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import rs_matrix
from ..storage.erasure_coding.ec_context import (DEVICE_BATCH_SIZE,
                                                 LARGE_BLOCK_SIZE,
                                                 SMALL_BLOCK_SIZE,
                                                 ECContext)


def encode_volume_files_batch(bases: "list[str]", ctx: ECContext,
                              mesh=None) -> None:
    """Encode every `<base>.dat` into `<base>.ec00..ecNN`, all volumes in
    one device launch per step.

    Device bytes per launch stay about DEVICE_BATCH_SIZE * data_shards by
    shrinking each volume's row group as the batch widens
    (rows_per_step = DEVICE_BATCH_SIZE / (block * n_volumes)).

    The grid path is taken when `mesh` is given or `ctx.device` is CUDA
    (then over every CUDA device); a CPU context without a grid, and
    volumes large enough for 1GB rows, take the per-volume pipeline,
    which is byte-identical.

    File handles are opened per step, not held for the whole batch:
    (total+1) x 64 volumes of open files would brush the default
    1024-descriptor limit."""
    d = ctx.data_shards
    block = SMALL_BLOCK_SIZE
    large_row = LARGE_BLOCK_SIZE * d
    small_row = block * d
    sizes = [os.path.getsize(b + ".dat") for b in bases]
    if (mesh is None and torch.device(ctx.device).type != "cuda") or \
            any(s >= large_row for s in sizes):
        from ..storage.erasure_coding import ec_encoder
        for b in bases:
            ec_encoder.write_ec_files(b, ctx)
        return

    from .ec_sharded import encode_volume_batch
    from .mesh import STRIPE_AXIS, make_mesh

    if mesh is None:
        mesh = make_mesh()
    stripe = mesh.shape[STRIPE_AXIS]
    v = len(bases)
    v_pad = -(-v // stripe) * stripe  # zero volumes pad the stripe axis
    rows_per_step = max(1, DEVICE_BATCH_SIZE // (block * v_pad))
    step_bytes = rows_per_step * block
    n_rows = [-(-s // small_row) for s in sizes]
    n_steps = max((-(-r // rows_per_step) for r in n_rows), default=0)

    mat = rs_matrix.parity_matrix(d, ctx.parity_shards)
    for b in bases:  # truncate any stale outputs once
        for i in range(ctx.total):
            open(b + ctx.to_ext(i), "wb").close()
    for s in range(n_steps):
        batch = np.zeros((v_pad, d, step_bytes), dtype=np.uint8)
        reals = []
        for vi in range(v):
            rows_left = n_rows[vi] - s * rows_per_step
            real_rows = max(0, min(rows_per_step, rows_left))
            reals.append(real_rows * block)
            if real_rows == 0:
                continue
            with open(bases[vi] + ".dat", "rb") as dat:
                dat.seek(s * rows_per_step * small_row)
                for r in range(real_rows):
                    base_off = r * block
                    for i in range(d):
                        got = dat.readinto(memoryview(
                            batch[vi, i])[base_off:base_off + block])
                        if got < block:
                            break   # EOF: the rest stays zero
        batch32 = batch.reshape(v_pad, d, -1).view(np.uint32)
        par = encode_volume_batch(mesh, mat, batch32).cpu().numpy()
        par8 = par.view(np.uint8).reshape(
            v_pad, ctx.parity_shards, step_bytes)
        for vi in range(v):
            real = reals[vi]
            if real == 0:
                continue
            for i in range(d):
                with open(bases[vi] + ctx.to_ext(i), "ab") as f:
                    f.write(batch[vi, i, :real].data)
            for j in range(ctx.parity_shards):
                with open(bases[vi] + ctx.to_ext(d + j), "ab") as f:
                    f.write(par8[vi, j, :real].data)
