"""The port's sharded and volume-batched EC (`seaweedfs_tpu_torch.parallel`)
on a grid of eight CPU devices, shape {stripe: 2, shard: 4}, against the
JAX package's `parallel.ec_sharded` on the conftest's eight virtual
devices and against the CPU twin, bit for bit (the cases of
tests/test_parallel.py, bar the JAX NamedSharding one), plus the batched
kernel entry's plain version.

On the card the same functions launch the CUDA kernel on each grid
device's stream; tests/test_torch_cuda.py holds the batched entry there.
"""

import os

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs_cpu
from seaweedfs_tpu.ops.rs_jax import pack_words, unpack_words
from seaweedfs_tpu.parallel import ec_batch as ref_batch
from seaweedfs_tpu.parallel import ec_sharded as ref_sharded
from seaweedfs_tpu.parallel import make_mesh as ref_make_mesh
from seaweedfs_tpu.storage import erasure_coding as ec_ref
from seaweedfs_tpu.storage.erasure_coding import ECContext as RefContext
from seaweedfs_tpu_torch.ops import rs_cuda, rs_matrix
from seaweedfs_tpu_torch.parallel import (SHARD_AXIS, STRIPE_AXIS,
                                          DeviceGrid, ec_batch, ec_sharded,
                                          make_mesh)
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import ECContext

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def grid():
    return make_mesh([CPU] * 8)


@pytest.fixture(scope="module")
def ref_mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return ref_make_mesh()


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# -- the grid ------------------------------------------------------------------

def test_mesh_shape(grid, ref_mesh):
    assert grid.shape == {"stripe": 2, "shard": 4}
    assert grid.shape == dict(ref_mesh.shape)
    assert (STRIPE_AXIS, SHARD_AXIS) == ("stripe", "shard")
    assert all(d == CPU for row in grid.devices for d in row)
    assert grid.stream(CPU) is None


@pytest.mark.parametrize("n,shard", [(1, None), (2, None), (3, None),
                                     (6, None), (7, None), (12, None),
                                     (8, 2), (9, 3)])
def test_shard_axis_rule_matches_reference(n, shard):
    got = make_mesh([CPU] * n, shard_axis_size=shard)
    want = ref_make_mesh(jax.devices()[:1] * n, shard_axis_size=shard)
    assert got.shape == dict(want.shape)
    assert sum(len(row) for row in got.devices) == n


def test_make_mesh_errors(monkeypatch):
    with pytest.raises(ValueError):
        make_mesh([CPU] * 6, shard_axis_size=4)
    with pytest.raises(ValueError):
        make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_ring_xor_reduces_every_device():
    rng = np.random.default_rng(20)
    for s in (1, 2, 3, 4):
        parts = [torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(3, 17), dtype=np.int64).astype(np.int32))
            for _ in range(s)]
        want = parts[0].clone()
        for p in parts[1:]:
            want ^= p
        out = ec_sharded._ring_xor(parts, [CPU] * s)
        assert len(out) == s
        for o in out:
            assert torch.equal(o, want)


# -- encode and reconstruct over the grid ------------------------------------

def test_encode_sharded_matches_jax_and_cpu(grid, ref_mesh):
    rng = np.random.default_rng(0)
    d, p, nbytes = 10, 4, 4096 * 8
    data = rng.integers(0, 256, size=(d, nbytes), dtype=np.uint8)
    want = rs_cpu.ReedSolomonCPU(d, p).parity(data)
    mat = rs_matrix.parity_matrix(d, p)
    got32 = ec_sharded.encode_sharded(grid, mat, pack_words(data))
    assert got32.dtype == torch.int32 and got32.device == CPU
    np.testing.assert_array_equal(unpack_words(_np32(got32), nbytes), want)
    ref32 = ref_sharded.encode_sharded(ref_mesh, mat, pack_words(data))
    np.testing.assert_array_equal(_np32(got32), np.asarray(ref32))


def test_reconstruct_sharded_with_padding(grid, ref_mesh):
    rng = np.random.default_rng(1)
    d, p, nbytes = 10, 4, 4096 * 8
    data = rng.integers(0, 256, size=(d, nbytes), dtype=np.uint8)
    cpu = rs_cpu.ReedSolomonCPU(d, p)
    full = cpu.encode(np.concatenate(
        [data, np.zeros((p, nbytes), np.uint8)], axis=0))
    lost = [1, 12]
    present = [i not in lost for i in range(d + p)]
    coeffs, rows = rs_matrix.reconstruction_matrix(d, p, present, lost)
    survivors32 = pack_words(full[rows])
    coeffs_p, survivors32_p = ec_sharded.pad_survivors(
        coeffs, survivors32, grid.shape["shard"])
    assert coeffs_p.shape == (2, 12) and survivors32_p.shape[0] == 12
    got32 = ec_sharded.reconstruct_sharded(grid, coeffs_p, survivors32_p)
    np.testing.assert_array_equal(unpack_words(_np32(got32), nbytes),
                                  full[lost])
    ref32 = ref_sharded.reconstruct_sharded(ref_mesh, coeffs_p,
                                            survivors32_p)
    np.testing.assert_array_equal(_np32(got32), np.asarray(ref32))


def test_pad_survivors_matches_reference():
    coeffs = np.arange(20, dtype=np.uint8).reshape(2, 10)
    surv = np.arange(30, dtype=np.uint32).reshape(10, 3)
    for multiple in (1, 3, 4, 5):
        got = ec_sharded.pad_survivors(coeffs, surv, multiple)
        want = ref_sharded.pad_survivors(coeffs, surv, multiple)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lost", [(0, 11), (3, 7), (10, 13), (0, 1)])
def test_distributed_ec_step(grid, ref_mesh, lost):
    rng = np.random.default_rng(2)
    d, nbytes = 10, 1024 * 8
    data = rng.integers(0, 256, size=(d, nbytes), dtype=np.uint8)
    par, rec, err = ec_sharded.distributed_ec_step(
        grid, pack_words(data), data_shards=d, parity_shards=4, lost=lost)
    assert err == 0
    np.testing.assert_array_equal(
        unpack_words(par, nbytes), rs_cpu.ReedSolomonCPU(d, 4).parity(data))
    ref_par, ref_rec, ref_err = ref_sharded.distributed_ec_step(
        ref_mesh, pack_words(data), data_shards=d, parity_shards=4,
        lost=lost)
    assert ref_err == 0
    np.testing.assert_array_equal(par, ref_par)
    np.testing.assert_array_equal(rec, ref_rec)


def test_distributed_ec_step_reports_a_wrong_rebuild(grid, monkeypatch):
    """err is the reconstruction's real difference, not a constant."""
    real = ec_sharded.reconstruct_sharded
    monkeypatch.setattr(ec_sharded, "reconstruct_sharded",
                        lambda *a: real(*a) ^ 1)
    data = np.random.default_rng(21).integers(0, 256, (10, 4096),
                                              dtype=np.uint8)
    _par, _rec, err = ec_sharded.distributed_ec_step(grid,
                                                     pack_words(data))
    assert err == 1


def test_rs63_scheme(grid):
    """RS(6,3) (BASELINE.json config 5): 3 parity rows padded to the
    shard axis with a zero coefficient row, dropped after."""
    rng = np.random.default_rng(3)
    d, p, nbytes = 6, 3, 2048 * 8
    data = rng.integers(0, 256, size=(d, nbytes), dtype=np.uint8)
    want = rs_cpu.ReedSolomonCPU(d, p).parity(data)
    mat = np.pad(rs_matrix.parity_matrix(d, p), ((0, 1), (0, 0)))
    got32 = ec_sharded.encode_sharded(grid, mat, pack_words(data))
    np.testing.assert_array_equal(
        unpack_words(_np32(got32), nbytes)[:p], want)


def test_encode_rejects_indivisible_shapes(grid):
    mat = rs_matrix.parity_matrix(10, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ec_sharded.encode_sharded(grid, mat, np.zeros((10, 5), np.uint32))
    with pytest.raises(ValueError, match="not divisible"):
        ec_sharded.encode_sharded(grid, mat[:3], np.zeros((10, 8),
                                                          np.uint32))
    with pytest.raises(ValueError):
        ec_sharded.encode_sharded(grid, mat, np.zeros((9, 8), np.uint32))
    with pytest.raises(TypeError):
        ec_sharded.encode_sharded(grid, mat, np.zeros((10, 8), np.uint8))


def test_encode_volume_batch(grid, ref_mesh):
    """BASELINE config 3: volumes over "stripe", parity rows over
    "shard"."""
    rng = np.random.default_rng(4)
    v, d, p, nbytes = 4, 10, 4, 1024 * 4
    batch = rng.integers(0, 256, size=(v, d, nbytes), dtype=np.uint8)
    cpu = rs_cpu.ReedSolomonCPU(d, p)
    mat = rs_matrix.parity_matrix(d, p)
    batch32 = np.stack([pack_words(b) for b in batch])
    got = _np32(ec_sharded.encode_volume_batch(grid, mat, batch32))
    assert got.shape == (v, p, nbytes // 4)
    for i in range(v):
        np.testing.assert_array_equal(
            unpack_words(got[i], nbytes), cpu.parity(batch[i]),
            err_msg=f"volume {i}")
    ref = np.asarray(ref_sharded.encode_volume_batch(ref_mesh, mat,
                                                     batch32))
    np.testing.assert_array_equal(got, ref)


def test_one_batched_call_per_grid_device(grid, monkeypatch):
    """Each grid device's block of the volume batch is ONE call of the
    batched entry; the single-volume entry is never looped."""
    calls = []
    real = rs_cuda.gf_apply_matrix_words_batch

    def counted(tables, batch32, stream=None):
        calls.append(tuple(batch32.shape))
        return real(tables, batch32, stream=stream)

    def single(*_a, **_k):
        raise AssertionError("the single-volume entry was called")

    monkeypatch.setattr(rs_cuda, "gf_apply_matrix_words_batch", counted)
    monkeypatch.setattr(rs_cuda, "gf_apply_matrix_words", single)
    batch32 = np.zeros((6, 10, 32), dtype=np.uint32)
    ec_sharded.encode_volume_batch(grid, rs_matrix.parity_matrix(10, 4),
                                   batch32)
    assert calls == [(3, 10, 32)] * 8


# -- the batched kernel entry's plain version -----------------------------

@pytest.mark.parametrize("v", [1, 3, 8])
@pytest.mark.parametrize("r,k,w", [(4, 10, 1001), (3, 6, 7), (16, 16, 33)])
def test_batch_plain_matches_per_volume(v, r, k, w):
    rng = np.random.default_rng(v * 1000 + r * 100 + k + w)
    mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
    tables = rs_cuda.tables_from_numpy(mat)
    batch = torch.from_numpy(rng.integers(
        -2**31, 2**31, size=(v, k, w), dtype=np.int64).astype(np.int32))
    got = rs_cuda.gf_apply_matrix_words_batch_plain(tables, batch)
    assert got.shape == (v, r, w) and got.dtype == torch.int32
    for i in range(v):
        assert torch.equal(got[i], rs_cuda.gf_apply_matrix_words_plain(
            tables, batch[i].contiguous()))
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(rs_cuda.gf_apply_matrix_words_batch(tables, batch),
                       got)


def test_batch_wrapper_checks_inputs():
    tables = rs_cuda.tables_from_numpy(np.ones((2, 3), np.uint8))
    with pytest.raises(ValueError):     # not a [V, K, W] batch
        rs_cuda.gf_apply_matrix_words_batch(
            tables, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):     # 48 entries do not fit K=5
        rs_cuda.gf_apply_matrix_words_batch(
            tables, torch.zeros((2, 5, 8), dtype=torch.int32))
    with pytest.raises(ValueError):     # no volumes
        rs_cuda.gf_apply_matrix_words_batch(
            tables, torch.zeros((0, 3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):     # more volumes than the grid's y
        rs_cuda.gf_apply_matrix_words_batch(
            tables, torch.zeros((65536, 3, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        rs_cuda.gf_apply_matrix_words_batch(
            tables, torch.zeros((2, 3, 8), dtype=torch.int64))
    with pytest.raises(ValueError):     # no kernel for this device
        rs_cuda.gf_apply_matrix_words_batch(
            tables.to("meta"), torch.zeros((2, 3, 8), dtype=torch.int32,
                                           device="meta"))


# -- the multi-volume file batch ----------------------------------------------

@pytest.fixture
def shrunk(monkeypatch):
    """Shrunk geometry (as tests/test_parallel.py) in both packages, so
    several rows and steps exercise the batching."""
    monkeypatch.setattr(ec_batch, "SMALL_BLOCK_SIZE", 1024)
    monkeypatch.setattr(ec_batch, "DEVICE_BATCH_SIZE", 4096)
    monkeypatch.setattr(ec_encoder, "SMALL_BLOCK_SIZE", 1024)
    monkeypatch.setattr(ref_batch, "SMALL_BLOCK_SIZE", 1024)
    monkeypatch.setattr(ref_batch, "TPU_BATCH_SIZE", 4096)
    monkeypatch.setattr(ec_ref.ec_encoder, "SMALL_BLOCK_SIZE", 1024)
    return monkeypatch


def _volumes(tmp_path, kinds, sizes, seed=11):
    rng = np.random.default_rng(seed)
    bases = {k: [] for k in kinds}
    for i, size in enumerate(sizes):
        blob = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for kind in kinds:
            base = str(tmp_path / f"{kind}{i}")
            with open(base + ".dat", "wb") as f:
                f.write(blob)
            bases[kind].append(base)
    return bases


def _same_shards(a_bases, b_bases, total=14):
    for a, b in zip(a_bases, b_bases):
        for i in range(total):
            with open(a + f".ec{i:02d}", "rb") as fa, \
                    open(b + f".ec{i:02d}", "rb") as fb:
                assert fa.read() == fb.read(), f"{a} shard {i}"


def test_encode_volume_files_batch_byte_identical(grid, ref_mesh, shrunk,
                                                  tmp_path):
    """Volumes of different sizes (ragged tails, 5/4/2 rows, a zero
    volume padding the stripe axis): the grid batch equals the port's
    per-volume encode and the JAX package's batch, file for file."""
    bases = _volumes(tmp_path, ("b", "r", "j"), [50_000, 31_000, 12_345])
    ctx = ECContext(device="cpu")
    ec_batch.encode_volume_files_batch(bases["b"], ctx, grid)
    for base in bases["r"]:
        ec_encoder.write_ec_files(base, ctx)
    ref_batch.encode_volume_files_batch(bases["j"], RefContext(backend="cpu"),
                                        ref_mesh)
    _same_shards(bases["b"], bases["r"])
    _same_shards(bases["b"], bases["j"])


def test_files_batch_one_batched_call_per_step(shrunk, tmp_path):
    """On a one-device grid (the card's shape) every step is one call
    of the batched entry, whatever the number of volumes."""
    calls = []
    real = rs_cuda.gf_apply_matrix_words_batch

    def counted(tables, batch32, stream=None):
        calls.append(tuple(batch32.shape))
        return real(tables, batch32, stream=stream)

    shrunk.setattr(rs_cuda, "gf_apply_matrix_words_batch", counted)
    sizes = [9_000, 41_000, 20_480, 7]
    bases = _volumes(tmp_path, ("b", "r"), sizes, seed=12)
    ctx = ECContext(device="cpu")
    ec_batch.encode_volume_files_batch(bases["b"], ctx,
                                       make_mesh([CPU]))
    rows_per_step = max(1, 4096 // (1024 * len(sizes)))
    n_steps = max(-(-(-(-s // 10240)) // rows_per_step) for s in sizes)
    assert calls == [(len(sizes), 10, rows_per_step * 1024 // 4)] * n_steps
    for base in bases["r"]:
        ec_encoder.write_ec_files(base, ctx)
    _same_shards(bases["b"], bases["r"])


def test_files_batch_cpu_context_takes_per_volume_path(shrunk, tmp_path):
    """A CPU context without a grid encodes volume by volume, as the
    reference does for its cpu/native backends."""
    def no_grid(*_a, **_k):
        raise AssertionError("the grid path was taken")

    shrunk.setattr(ec_sharded, "encode_volume_batch", no_grid)
    bases = _volumes(tmp_path, ("b", "r"), [30_000, 5_000], seed=13)
    ctx = ECContext(device="cpu")
    ec_batch.encode_volume_files_batch(bases["b"], ctx)
    for base in bases["r"]:
        ec_encoder.write_ec_files(base, ctx)
    _same_shards(bases["b"], bases["r"])


def test_files_batch_large_volumes_take_per_volume_path(grid, shrunk,
                                                        tmp_path):
    """A volume large enough for a large-block row encodes alone, even
    with a grid."""
    def no_grid(*_a, **_k):
        raise AssertionError("the grid path was taken")

    shrunk.setattr(ec_sharded, "encode_volume_batch", no_grid)
    shrunk.setattr(ec_batch, "LARGE_BLOCK_SIZE", 4096)
    shrunk.setattr(ec_encoder, "LARGE_BLOCK_SIZE", 4096)
    bases = _volumes(tmp_path, ("b", "r"), [50_000, 3_000], seed=14)
    ctx = ECContext(device="cpu")
    ec_batch.encode_volume_files_batch(bases["b"], ctx, grid)
    for base in bases["r"]:
        ec_encoder.write_ec_files(base, ctx)
    _same_shards(bases["b"], bases["r"])
    assert os.path.getsize(bases["b"][0] + ".ec00") > 4096


def test_files_batch_truncates_stale_outputs(grid, shrunk, tmp_path):
    bases = _volumes(tmp_path, ("b", "r"), [20_000], seed=15)
    with open(bases["b"][0] + ".ec03", "wb") as f:
        f.write(b"stale" * 10_000)
    ctx = ECContext(device="cpu")
    ec_batch.encode_volume_files_batch(bases["b"], ctx, grid)
    ec_encoder.write_ec_files(bases["r"][0], ctx)
    _same_shards(bases["b"], bases["r"])


def test_device_grid_shape_and_sync():
    g = DeviceGrid([[CPU, CPU]])
    assert g.shape == {"stripe": 1, "shard": 2}
    g.synchronize()             # no streams on the CPU: nothing to wait
