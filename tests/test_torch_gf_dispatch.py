"""The host side of the port's GF(2^8) kernel launch, on the CPU: the
host copy of the tables that a launch copies into the kernel's
parameters (`rs_cuda.host_tables`), held byte for byte against
`tables_from_numpy` and the JAX package's `rs_pallas.expand_tables`;
and the map from a launch's [R, K] to the kernel template or the
generic body, over every matrix the codec, `staging.WindowedLaunch` and
`parallel.ec_sharded` launch.
"""

import gc
import itertools

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.rs_pallas import expand_tables
from seaweedfs_tpu_torch.ops import rs_cuda, rs_matrix, staging
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
from seaweedfs_tpu_torch.parallel import ec_sharded, make_mesh

META = torch.device("meta")


def _rec_matrix(d, p, lost):
    present = tuple(i not in lost for i in range(d + p))
    return np.asarray(rs_matrix.cached_reconstruction_matrix(
        d, p, present, tuple(lost))[0])


def _matrices():
    rng = np.random.default_rng(3)
    return [
        ("parity_10_4", rs_matrix.parity_matrix(10, 4)),
        ("rebuild_4", _rec_matrix(10, 4, (0, 7, 11, 13))),
        ("rebuild_3", _rec_matrix(10, 4, (2, 5, 12))),
        ("rebuild_2", _rec_matrix(10, 4, (0, 13))),
        ("rebuild_1", _rec_matrix(10, 4, (9,))),
        ("parity_6_3", rs_matrix.parity_matrix(6, 3)),
        ("random_16x16", rng.integers(0, 256, (16, 16), dtype=np.uint8)),
        ("random_32x32", rng.integers(0, 256, (32, 32), dtype=np.uint8)),
    ]


@pytest.mark.parametrize("name,mat", _matrices(),
                         ids=[m[0] for m in _matrices()])
def test_host_tables_equal_tables_from_numpy_and_expand_tables(name, mat):
    """The bytes a launch hands the kernel as its host tables are the
    bit tables themselves, for a table tensor made on a device."""
    dev_tables = rs_cuda.tables_from_numpy(mat, META)
    assert dev_tables.device == META
    host = rs_cuda.host_tables(dev_tables)
    assert host.device.type == "cpu" and host.dtype == torch.int32
    assert host.is_contiguous()
    want = expand_tables(mat)
    assert host.numpy().tobytes() == want.tobytes()
    assert host.numpy().tobytes() == \
        rs_cuda.tables_from_numpy(mat).numpy().tobytes()
    # the same tensor finds the same copy: no second copy per launch
    assert rs_cuda.host_tables(dev_tables) is host


def test_host_tables_of_a_cpu_tensor_is_the_tensor():
    tables = rs_cuda.tables_from_numpy(rs_matrix.parity_matrix(10, 4))
    assert rs_cuda.host_tables(tables) is tables


def test_host_copy_is_not_reused_after_an_in_place_change():
    """A table tensor changed in place no longer matches its kept copy:
    the next launch copies it from the device again (on the meta device
    that copy is refused, which shows that it was asked for)."""
    dev_tables = rs_cuda.tables_from_numpy(rs_matrix.parity_matrix(10, 4),
                                           META)
    rs_cuda.host_tables(dev_tables)
    dev_tables.add_(0)
    with pytest.raises((NotImplementedError, RuntimeError)):
        rs_cuda.host_tables(dev_tables)


def test_host_copy_is_dropped_with_its_tensor():
    before = len(rs_cuda._host)
    dev_tables = rs_cuda.tables_from_numpy(rs_matrix.parity_matrix(6, 3),
                                           META)
    assert len(rs_cuda._host) == before + 1
    del dev_tables
    gc.collect()
    assert len(rs_cuda._host) == before


@pytest.mark.parametrize("r,k,aligned,want", [
    (4, 10, True, "gf_apply_specILi4ELi10ELb1E"),
    (3, 10, False, "gf_apply_specILi3ELi10ELb0E"),
    (1, 10, True, "gf_apply_specILi1ELi10ELb1E"),
    (3, 6, True, "gf_apply_genericILi3ELb1E"),
    (5, 10, True, "gf_apply_genericILi5ELb1E"),
    (4, 9, False, "gf_apply_genericILi4ELb0E"),
    (16, 16, True, "gf_apply_genericILi8ELb1E"),
])
def test_template_map(r, k, aligned, want):
    assert rs_cuda.specialised(r, k) == (k == 10 and r <= 4)
    assert rs_cuda.kernel_symbol(r, k, aligned) == want


def test_every_rs_10_4_rebuild_matrix_has_a_template():
    """Every loss RS(10,4) survives (1 to 4 of 14 shards) rebuilds
    through a [losses, 10] matrix: each has a template of its own."""
    shapes = set()
    for n in (1, 2, 3, 4):
        for lost in itertools.combinations(range(14), n):
            present = tuple(i not in lost for i in range(14))
            m, rows = rs_matrix.cached_reconstruction_matrix(10, 4, present,
                                                             lost)
            assert len(rows) == 10
            shapes.add(np.asarray(m).shape)
    assert shapes == {(1, 10), (2, 10), (3, 10), (4, 10)}
    assert all(rs_cuda.specialised(*s) for s in shapes)


@pytest.fixture
def launches(monkeypatch):
    """Record the [R, K] (and V) of every wrapper call, then run it."""
    seen = []
    single = rs_cuda.gf_apply_matrix_words
    batched = rs_cuda.gf_apply_matrix_words_batch

    def rec_single(tables, data32, stream=None):
        seen.append((tables.numel() // (data32.shape[0] * 8),
                     data32.shape[0], 1))
        return single(tables, data32, stream=stream)

    def rec_batched(tables, batch32, stream=None):
        seen.append((tables.numel() // (batch32.shape[1] * 8),
                     batch32.shape[1], batch32.shape[0]))
        return batched(tables, batch32, stream=stream)

    monkeypatch.setattr(rs_cuda, "gf_apply_matrix_words", rec_single)
    monkeypatch.setattr(rs_cuda, "gf_apply_matrix_words_batch", rec_batched)
    return seen


def test_codec_and_staging_launch_templates(launches, monkeypatch):
    """RS(10,4)'s encode and rebuilds, one-shot and through
    staging.WindowedLaunch, launch only templated shapes; RS(6,3) the
    generic body.  Every launch is one the kernel takes."""
    rng = np.random.default_rng(5)
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.0625")
    codec = ReedSolomonTorch(10, 4, "cpu")
    data = rng.integers(0, 256, (10, 3 * 65536 + 8), dtype=np.uint8)
    win = codec.parity_lazy(data)
    assert isinstance(win, staging.WindowedLaunch)
    win.materialize()
    for lost in ((1,), (0, 13), (2, 5, 12), (0, 7, 11, 13)):
        codec.apply_matrix_lazy(_rec_matrix(10, 4, lost),
                                data[:, :4096]).materialize()
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0")
    codec.parity_lazy(data).materialize()
    rs10 = set(launches)
    assert {(r, k) for r, k, _v in rs10} == {(4, 10), (1, 10), (2, 10),
                                             (3, 10)}
    assert all(rs_cuda.specialised(r, k) for r, k, _v in rs10)
    ReedSolomonTorch(6, 3, "cpu").parity_lazy(data[:6]).materialize()
    assert launches[-1][:2] == (3, 6) and not rs_cuda.specialised(3, 6)
    for r, k, v in launches:
        assert 0 < r <= rs_cuda.MAX_SHARDS and 0 < k <= rs_cuda.MAX_SHARDS
        assert 0 < v <= rs_cuda.MAX_VOLUMES


def test_grid_functions_launch_kernel_shapes(launches):
    """ec_sharded on a grid of eight CPU devices ({stripe: 2, shard: 4}):
    each device's part of the encode is a [1, 10] template launch, the
    batch a batched [1, 10] launch, and the sharded rebuild's partial
    sums ([2, 3] after padding the survivors to 12) the generic body."""
    grid = make_mesh([torch.device("cpu")] * 8)
    rng = np.random.default_rng(6)
    data32 = rng.integers(0, 1 << 32, (10, 4096), dtype=np.uint32)
    _par, _rec, err = ec_sharded.distributed_ec_step(grid, data32,
                                                     lost=(0, 11))
    assert err == 0
    batch = rng.integers(0, 1 << 32, (4, 10, 512), dtype=np.uint32)
    ec_sharded.encode_volume_batch(grid, rs_matrix.parity_matrix(10, 4),
                                   batch)
    shapes = {(r, k, v) for r, k, v in launches}
    assert shapes == {(1, 10, 1), (2, 3, 1), (1, 10, 2)}
    assert rs_cuda.specialised(1, 10) and not rs_cuda.specialised(2, 3)
