"""The port's codec `ReedSolomonTorch(device="cpu")` against the JAX
package's `ReedSolomonJax` and the numpy `ReedSolomonCPU`: every case of
tests/test_rs_jax.py, byte for byte (tolerance 0), with the lazy
handles (`parity_lazy`, `apply_matrix_lazy`) beside the eager calls."""

import itertools

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256
from seaweedfs_tpu.ops.rs_cpu import ReedSolomonCPU
from seaweedfs_tpu.ops.rs_jax import ReedSolomonJax
from seaweedfs_tpu.ops.rs_jax import gf_apply_matrix as jax_apply
from seaweedfs_tpu_torch.ops import rs_matrix
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch, gf_apply_matrix


def _torch(d, p):
    return ReedSolomonTorch(d, p, device="cpu")


@pytest.mark.parametrize("d,p", [(10, 4), (6, 3), (3, 2)])
def test_parity_bit_identical_to_cpu(d, p):
    rng = np.random.default_rng(d + p)
    cpu = ReedSolomonCPU(d, p)
    tpu = ReedSolomonJax(d, p)
    port = _torch(d, p)
    data = rng.integers(0, 256, size=(d, 4096), dtype=np.uint8)
    want = cpu.parity(data)
    assert np.array_equal(np.asarray(tpu.parity(data)), want)
    assert np.array_equal(port.parity(data), want)
    assert np.array_equal(port.parity_lazy(data).materialize(), want)
    assert np.array_equal(
        port.apply_matrix_lazy(rs_matrix.parity_matrix(d, p),
                               data).materialize(), want)


def test_gf_apply_matrix_arbitrary():
    rng = np.random.default_rng(11)
    mat = rng.integers(0, 256, size=(7, 5), dtype=np.uint8)
    data = rng.integers(0, 256, size=(5, 513), dtype=np.uint8)
    got = gf_apply_matrix(mat, data, device="cpu")
    assert np.array_equal(got, gf256.gf_apply_matrix(mat, data))
    assert np.array_equal(got, np.asarray(jax_apply(mat, data)))
    port = _torch(5, 2)
    assert np.array_equal(port.apply_matrix(mat, data), got)
    assert np.array_equal(port.apply_matrix_lazy(mat, data).materialize(),
                          got)


def test_gf_apply_matrix_batched_3d():
    rng = np.random.default_rng(12)
    mat = rng.integers(0, 256, size=(4, 10), dtype=np.uint8)
    data = rng.integers(0, 256, size=(10, 3, 257), dtype=np.uint8)
    got = gf_apply_matrix(mat, data, device="cpu")
    want = gf256.gf_apply_matrix(mat, data.reshape(10, -1)).reshape(4, 3, 257)
    assert got.shape == (4, 3, 257)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jax_apply(mat, data)))


def test_encode_verify():
    rng = np.random.default_rng(13)
    tpu = ReedSolomonJax(10, 4)
    port = _torch(10, 4)
    shards = np.zeros((14, 1024), dtype=np.uint8)
    shards[:10] = rng.integers(0, 256, size=(10, 1024))
    enc = np.array(port.encode(shards))
    assert np.array_equal(enc, np.array(tpu.encode(shards)))
    assert port.verify(enc)
    enc[3, 17] ^= 0x40
    assert not port.verify(enc)
    assert not tpu.verify(enc)


@pytest.mark.parametrize("lost", list(itertools.combinations(range(14), 4))[::37])
def test_reconstruct_matches_cpu(lost):
    rng = np.random.default_rng(sum(lost))
    cpu = ReedSolomonCPU(10, 4)
    tpu = ReedSolomonJax(10, 4)
    port = _torch(10, 4)
    shards = np.zeros((14, 256), dtype=np.uint8)
    shards[:10] = rng.integers(0, 256, size=(10, 256))
    enc = cpu.encode(shards)
    damaged = enc.copy()
    present = [True] * 14
    for i in lost:
        damaged[i] = 0
        present[i] = False
    got = port.reconstruct(damaged, present)
    assert np.array_equal(got, enc)
    assert np.array_equal(got, tpu.reconstruct(damaged, present))
    # the rebuild pipeline's form: one lazy apply of the reconstruction
    # matrix over the first 10 survivors
    m, rows = rs_matrix.cached_reconstruction_matrix(
        10, 4, tuple(present), tuple(lost))
    rec = port.apply_matrix_lazy(m, enc[list(rows)]).materialize()
    assert np.array_equal(rec, enc[list(lost)])


def test_reconstruct_data_only():
    rng = np.random.default_rng(14)
    cpu = ReedSolomonCPU(6, 3)
    tpu = ReedSolomonJax(6, 3)
    port = _torch(6, 3)
    shards = np.zeros((9, 128), dtype=np.uint8)
    shards[:6] = rng.integers(0, 256, size=(6, 128))
    enc = cpu.encode(shards)
    damaged = enc.copy()
    present = [True] * 9
    for i in (2, 8):
        damaged[i] = 0
        present[i] = False
    got = port.reconstruct(damaged, present, data_only=True)
    assert np.array_equal(got[:6], enc[:6])
    assert not got[8].any()  # parity untouched
    assert np.array_equal(got, tpu.reconstruct(damaged, present,
                                               data_only=True))


def test_device_array_input_unaligned():
    # torch tensor inputs are packed where they lie, incl. pad/slice
    rng = np.random.default_rng(21)
    mat = np.asarray([[1, 2, 3], [4, 5, 6]], dtype=np.uint8)
    data = rng.integers(0, 256, size=(3, 1001), dtype=np.uint8)
    got = gf_apply_matrix(mat, torch.from_numpy(data), device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    want = gf256.gf_apply_matrix(mat, data)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jax_apply(mat, data)))


def test_reconstruct_onto_rejects_misordered_survivors():
    rng = np.random.default_rng(22)
    port = _torch(4, 2)
    tpu = ReedSolomonJax(4, 2)
    shards = np.zeros((6, 32), dtype=np.uint8)
    shards[:4] = rng.integers(0, 256, size=(4, 32))
    enc = np.array(port.encode(shards))
    present = [True, False, True, True, True, True]
    with pytest.raises(ValueError, match="in that order"):
        port.reconstruct_onto(enc[[2, 0, 3, 4]], [2, 0, 3, 4], present, [1])
    # correct order works
    rec = port.reconstruct_onto(enc[[0, 2, 3, 4]], [0, 2, 3, 4], present,
                                [1])
    assert np.array_equal(rec[0], enc[1])
    assert np.array_equal(rec, np.asarray(tpu.reconstruct_onto(
        enc[[0, 2, 3, 4]], [0, 2, 3, 4], present, [1])))


def test_verify_rejects_wrong_shapes():
    port = _torch(4, 2)
    with pytest.raises(ValueError):
        port.verify(np.zeros((4, 8), dtype=np.uint8))
    with pytest.raises(TypeError):
        port.parity(np.zeros((4, 8), dtype=np.int64))
    with pytest.raises(TypeError):
        port.parity_lazy(np.zeros((4, 8), dtype=np.int64))


def test_errors():
    port = _torch(4, 2)
    with pytest.raises(ValueError):
        port.parity(np.zeros((3, 8), dtype=np.uint8))
    with pytest.raises(ValueError):
        port.reconstruct(np.zeros((6, 8), dtype=np.uint8),
                         [False] * 3 + [True] * 3)
    with pytest.raises(ValueError):
        port.apply_matrix_lazy(np.ones((2, 4), np.uint8),
                               np.zeros((3, 8), dtype=np.uint8))
