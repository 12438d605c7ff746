"""The port's windowed staging (`seaweedfs_tpu_torch.ops.staging`) on the
CPU, against the JAX package's staged codec and the CPU twin, byte for
byte: the cases of tests/test_staged_encode.py that do not concern the
JAX mesh or bench.py, plus the bounded buffer pool and the stager's
shutdown.

On the CPU the staging thread runs the kernel's plain version window by
window, so every line of the windowing logic runs here; the same path on
the card is tests/test_torch_cuda.py's."""

import gc
import os
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs_cpu
from seaweedfs_tpu.ops.rs_jax import ReedSolomonJax
from seaweedfs_tpu.storage import erasure_coding as ec_ref
from seaweedfs_tpu.storage.erasure_coding import ECContext as RefContext
from seaweedfs_tpu_torch import tracing
from seaweedfs_tpu_torch.ops import rs_cuda, rs_matrix, staging
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch, pack_words
from seaweedfs_tpu_torch.storage.erasure_coding import ec_context, ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import ECContext

D, P = 10, 4


@pytest.fixture
def knobs(monkeypatch):
    """Tiny windows (so even small test arrays span many), depth 2."""
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.002")
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_INFLIGHT", "2")
    return monkeypatch


@pytest.fixture
def small_geometry(monkeypatch):
    """4 KB small rows and 16 KB device batches in both packages."""
    monkeypatch.setattr(ec_encoder, "SMALL_BLOCK_SIZE", 4096)
    monkeypatch.setattr(ec_context, "DEVICE_BATCH_SIZE", 16384)
    monkeypatch.setattr(ec_ref.ec_encoder, "SMALL_BLOCK_SIZE", 4096)
    monkeypatch.setattr(ec_ref.ec_context, "SMALL_BLOCK_SIZE", 4096)
    monkeypatch.setattr(ec_ref.ec_context, "TPU_BATCH_SIZE", 16384)
    return monkeypatch


def _data(nbytes: int, rows: int = D, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, size=(rows, nbytes), dtype=np.uint8)


def _codec() -> ReedSolomonTorch:
    return ReedSolomonTorch(D, P, "cpu")


def _stager_threads() -> "list[threading.Thread]":
    return [t for t in threading.enumerate() if t.name == "h2d-stager"]


# -- knobs and the window planner --------------------------------------------

def test_knob_parsing(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.5")
    assert staging.window_bytes() == 512 * 1024
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0")
    assert staging.window_bytes() == 0
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "junk")
    assert staging.window_bytes() == \
        int(staging.DEFAULT_WINDOW_MB * (1 << 20))
    monkeypatch.delenv("SEAWEEDFS_TPU_H2D_WINDOW_MB")
    assert staging.window_bytes() == 32 << 20
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_INFLIGHT", "0")
    assert staging.inflight_depth() == 1  # floor: one slot
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_INFLIGHT", "3")
    assert staging.inflight_depth() == 3
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_INFLIGHT", "x")
    assert staging.inflight_depth() == staging.DEFAULT_INFLIGHT == 2


def test_knobs_mean_the_same_in_both_packages(monkeypatch):
    from seaweedfs_tpu.ops import staging as ref
    for mb in ("0.5", "0", "junk", "7.25"):
        monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", mb)
        assert staging.window_bytes() == ref.window_bytes()
    for depth in ("0", "3", "x"):
        monkeypatch.setenv("SEAWEEDFS_TPU_H2D_INFLIGHT", depth)
        assert staging.inflight_depth() == ref.inflight_depth()


def test_plan_windows_tiles_exactly(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.001")
    for w, ndev in ((1, 8), (7, 8), (1000, 8), (1024, 8), (333, 3),
                    (26, 1), (5, 1), (100_003, 1)):
        plan = staging.plan_windows(D, w, ndev)
        pos = 0
        for (w0, n, npad) in plan:
            assert w0 == pos and n >= 1
            assert npad % ndev == 0 and npad >= n
            pos += n
        assert pos == w, (w, ndev)
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0")
    assert staging.plan_windows(D, 1024, 8) == []  # disabled


@pytest.mark.parametrize("window_mb,k", [("0.001", 10), ("0.002", 10),
                                         ("0.0001", 3), ("32", 10)])
def test_plan_windows_rounds_to_four_words(monkeypatch, window_mb, k):
    """Every window but the tail is a multiple of 4 words, so every
    window's rows start 16-byte aligned (the kernel's uint4 path), and
    the width is the reference's target rounded up by less than 4."""
    from seaweedfs_tpu.ops import staging as ref
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", window_mb)
    w = 3 * (staging.window_bytes() // (4 * k)) + 5
    plan = staging.plan_windows(k, w)
    for w0, n, npad in plan:
        assert w0 % 4 == 0 and npad == n
    for _w0, n, _ in plan[:-1]:
        assert n % staging.WINDOW_WORD_MULTIPLE == 0
    ref_n = ref.plan_windows(k, w, 1)[0][1]
    assert 0 <= plan[0][1] - ref_n < 4


def test_main_path_window_shape(monkeypatch):
    """At the default 32 MiB a 64 MiB-per-row encode batch is 21
    windows of [10, 838,860] words (the main path's launch shape)."""
    monkeypatch.delenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", raising=False)
    plan = staging.plan_windows(10, 16_777_216)
    assert len(plan) == 21
    assert plan[0] == (0, 838_860, 838_860)
    assert sum(n for _, n, _ in plan) == 16_777_216


# -- byte identity: windowed / one-shot / JAX / CPU twin -------------------------

def test_windowed_matches_one_shot_jax_and_cpu(knobs):
    """Payload not a multiple of 4 (pack padding), many windows with a
    short tail."""
    nbytes = 40_003
    data = _data(nbytes, seed=1)
    want = rs_cpu.ReedSolomonCPU(D, P).parity(data)
    codec = _codec()
    pend = codec.parity_lazy(data)
    assert isinstance(pend, staging.WindowedLaunch)
    got = pend.materialize()
    np.testing.assert_array_equal(got, want)
    jax_staged = ReedSolomonJax(D, P).parity_lazy(data)
    assert hasattr(jax_staged, "windows")
    np.testing.assert_array_equal(got, jax_staged.materialize())
    knobs.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0")
    one_shot = codec.parity_lazy(data)
    assert not hasattr(one_shot, "windows")
    np.testing.assert_array_equal(one_shot.materialize(), want)


def test_one_window_batch_launches_in_one_shot(monkeypatch):
    """A batch within one window takes the one-shot path, as the
    reference's _windowed_wanted on one device."""
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "1")
    data = _data(4096, seed=9)
    pend = _codec().parity_lazy(data)
    assert not hasattr(pend, "windows")
    np.testing.assert_array_equal(
        pend.materialize(), rs_cpu.ReedSolomonCPU(D, P).parity(data))


def test_windows_stream_in_order_with_stats(knobs):
    nbytes = 16_000
    data = _data(nbytes, seed=3)
    pend = _codec().parity_lazy(data)
    got = np.empty((P, nbytes), dtype=np.uint8)
    covered = 0
    n_windows = 0
    for byte0, chunk in pend.windows():
        assert byte0 == covered  # strict launch order
        got[:, byte0:byte0 + chunk.shape[1]] = chunk
        covered += chunk.shape[1]
        n_windows += 1
    assert covered == nbytes and n_windows > 1
    np.testing.assert_array_equal(
        got, rs_cpu.ReedSolomonCPU(D, P).parity(data))
    s = pend.stats
    assert s.windows == n_windows
    assert n_windows == len(staging.plan_windows(
        D, pack_words(data, 16).shape[1]))
    assert 0.0 <= s.overlap_fraction <= 1.0
    assert s.h2d_bytes > 0 and s.d2h_bytes > 0
    with pytest.raises(RuntimeError):
        list(pend.windows())  # single-consumer contract


def test_apply_matrix_lazy_windowed_rebuild_path(knobs):
    nbytes = 12_289  # odd tail
    cpu = rs_cpu.ReedSolomonCPU(D, P)
    data = _data(nbytes, seed=4)
    full = np.asarray(cpu.encode(np.concatenate(
        [data, np.zeros((P, nbytes), np.uint8)], axis=0)))
    lost = [2, 11]
    present = [i not in lost for i in range(D + P)]
    coeffs, rows = rs_matrix.reconstruction_matrix(D, P, present, lost)
    pend = _codec().apply_matrix_lazy(coeffs, full[list(rows)])
    assert isinstance(pend, staging.WindowedLaunch)
    got = pend.materialize()
    np.testing.assert_array_equal(got, full[lost])
    ref = ReedSolomonJax(D, P).apply_matrix_lazy(coeffs, full[list(rows)])
    np.testing.assert_array_equal(got, ref.materialize())


def test_aggregate_snapshot(knobs):
    staging.reset_aggregate()
    codec = _codec()
    codec.parity_lazy(_data(8_192, seed=5)).materialize()
    codec.parity_lazy(_data(8_192, seed=6)).materialize()
    snap = staging.snapshot()
    assert snap["launches"] == 2 and snap["windows"] >= 4
    assert snap["h2d_gbps"] > 0
    assert 0.0 <= snap["overlap_fraction"] <= 1.0
    staging.reset_aggregate()
    assert staging.snapshot()["launches"] == 0


def test_launches_stay_zero_on_cpu(knobs):
    """The plain version runs on the CPU: the kernel's counts do not
    move."""
    before = (rs_cuda.LAUNCHES, rs_cuda.LAUNCHES_BATCHED)
    _codec().parity_lazy(_data(9_000, seed=12)).materialize()
    assert (rs_cuda.LAUNCHES, rs_cuda.LAUNCHES_BATCHED) == before


# -- the EC file pipeline through the staged path ---------------------------

def test_generate_ec_files_windowed_byte_identical(knobs, small_geometry,
                                                   tmp_path):
    """reader -> windowed launch -> writer pushing parity windows as
    they land, against the JAX pipeline's shard files (ragged tail)."""
    blob = _data(200_001, rows=1, seed=7).tobytes()
    for kind in ("t", "j"):
        (tmp_path / f"{kind}.dat").write_bytes(blob)
    staging.reset_aggregate()
    ec_encoder.write_ec_files(str(tmp_path / "t"), ECContext(device="cpu"))
    assert staging.snapshot()["launches"] > 0  # the windowed path ran
    ec_ref.ec_encoder.write_ec_files(str(tmp_path / "j"),
                                     RefContext(backend="jax"))
    for i in range(D + P):
        assert (tmp_path / f"t.ec{i:02d}").read_bytes() == \
            (tmp_path / f"j.ec{i:02d}").read_bytes(), f"shard {i}"


@pytest.mark.parametrize("window_mb", ["0", "64"])
def test_generate_ec_files_one_shot(small_geometry, tmp_path, window_mb):
    """Windowing off ("0") or a batch within one window ("64"): the
    accepts_lazy writer materializes the one-shot handle itself."""
    small_geometry.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", window_mb)
    blob = _data(60_000, rows=1, seed=8).tobytes()
    for kind in ("t", "j"):
        (tmp_path / f"{kind}.dat").write_bytes(blob)
    staging.reset_aggregate()
    ec_encoder.write_ec_files(str(tmp_path / "t"), ECContext(device="cpu"))
    assert staging.snapshot()["launches"] == 0
    ec_ref.ec_encoder.write_ec_files(str(tmp_path / "j"),
                                     RefContext(backend="cpu"))
    for i in range(D + P):
        assert (tmp_path / f"t.ec{i:02d}").read_bytes() == \
            (tmp_path / f"j.ec{i:02d}").read_bytes(), f"shard {i}"


def test_rebuild_windowed_byte_identical(knobs, small_geometry, tmp_path):
    base = str(tmp_path / "r")
    (tmp_path / "r.dat").write_bytes(_data(150_001, rows=1, seed=10)
                                     .tobytes())
    ctx = ECContext(device="cpu")
    ec_encoder.write_ec_files(base, ctx)
    golden = {i: (tmp_path / f"r.ec{i:02d}").read_bytes()
              for i in range(D + P)}
    lost = (0, 5, 12)
    for sid in lost:
        os.remove(base + ctx.to_ext(sid))
    staging.reset_aggregate()
    assert ec_encoder.rebuild_ec_files(base, ctx) == list(lost)
    assert staging.snapshot()["launches"] > 0
    for sid in range(D + P):
        assert (tmp_path / f"r.ec{sid:02d}").read_bytes() == golden[sid]


# -- the bounded pool (the repaired fault) -----------------------------------

def test_pool_defaults_match_reference():
    from seaweedfs_tpu.ops import staging as ref
    assert staging.POOL.max_bufs == ref._POOL_CAP_BUFS == 8
    assert staging.POOL.max_bytes == ref._POOL_CAP_BYTES == 256 << 20


def test_pool_fifo_eviction_by_count_and_bytes():
    pool = staging.BufferPool(max_bufs=3, max_bytes=10_000)
    bufs = [torch.zeros((1, 100 + i), dtype=torch.int32) for i in range(5)]
    for b in bufs:
        pool.give(b, pinned=False)
    assert len(pool) == 3             # the two oldest went first
    assert pool.take((1, 100), pinned=False) is not bufs[0]
    assert pool.take((1, 104), pinned=False) is bufs[4]
    big = torch.zeros((1, 2400), dtype=torch.int32)   # 9,600 bytes
    pool.give(big, pinned=False)
    assert pool.nbytes <= 10_000 and len(pool) == 1
    assert pool.take((1, 2400), pinned=False) is big
    # a shape is found only with its own kind of memory (the label is
    # what is matched: there is no pinned memory without a card)
    labelled = torch.zeros((2, 2), dtype=torch.int32)
    pool.give(labelled, pinned=True)
    assert pool.take((2, 2), pinned=False) is not labelled
    assert len(pool) == 1


def test_pool_bounded_after_many_tail_shapes(monkeypatch):
    """Rebuild windows end in a per-volume tail shape; after launches of
    many distinct widths the process pool holds at most 8 buffers and
    256 MiB."""
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.001")
    codec = _codec()
    for i in range(40):
        nbytes = 4_000 + 37 * i
        data = _data(nbytes, seed=100 + i)
        got = codec.parity_lazy(data).materialize()
        assert got.shape == (P, nbytes)
        assert len(staging.POOL) <= staging.POOL.max_bufs
    assert len(staging.POOL) <= 8
    assert staging.POOL.nbytes <= 256 << 20


# -- shutdown -------------------------------------------------------------

def test_abort_stops_undrained_stager(knobs):
    knobs.setenv("SEAWEEDFS_TPU_H2D_INFLIGHT", "1")
    pend = _codec().parity_lazy(_data(60_000, seed=13))
    thread = pend._t
    pend.abort()
    assert not thread.is_alive()
    assert pend._s.ready.empty()    # every staged window released
    with pytest.raises(RuntimeError):
        list(pend.windows())  # an aborted launch is consumed


def test_dropped_handle_stops_stager(knobs):
    knobs.setenv("SEAWEEDFS_TPU_H2D_INFLIGHT", "1")
    pend = _codec().parity_lazy(_data(60_000, seed=14))
    thread = pend._t
    del pend
    gc.collect()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_partial_drain_closes_the_launch(knobs):
    pend = _codec().parity_lazy(_data(30_000, seed=15))
    it = pend.windows()
    next(it)
    it.close()           # the consumer walks away mid-launch
    assert not pend._t.is_alive()


def test_stager_error_raised_after_drain(knobs, monkeypatch):
    calls = []
    real = rs_cuda.gf_apply_matrix_words

    def flaky(tables, words, stream=None):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected launch failure")
        return real(tables, words)

    monkeypatch.setattr(rs_cuda, "gf_apply_matrix_words", flaky)
    pend = _codec().parity_lazy(_data(20_000, seed=16))
    seen = []
    with pytest.raises(RuntimeError, match="injected"):
        for byte0, _chunk in pend.windows():
            seen.append(byte0)
    assert len(seen) == 2           # the windows before the failure
    assert not pend._t.is_alive()


def test_pipeline_unwind_leaves_no_stager(knobs, small_geometry, tmp_path):
    """A writer that fails mid-encode aborts the queued windowed
    launches: no staging thread outlives the encode."""
    (tmp_path / "f.dat").write_bytes(_data(300_001, rows=1, seed=17)
                                     .tobytes())
    before = set(_stager_threads())

    def boom(self, _data):
        raise OSError("disk full")

    from seaweedfs_tpu_torch.storage.erasure_coding import shard_sink
    small_geometry.setattr(shard_sink.LocalShardSink, "write", boom)
    with pytest.raises(OSError, match="disk full"):
        ec_encoder.write_ec_files(str(tmp_path / "f"),
                                  ECContext(device="cpu"))
    for t in set(_stager_threads()) - before:
        t.join(timeout=10)
        assert not t.is_alive()
    assert not list(tmp_path.glob("f.ec*"))


def test_stage_spans_under_windowed_encode(knobs, small_geometry, tmp_path):
    """The windowed writer still feeds the encode stage spans."""
    (tmp_path / "s.dat").write_bytes(_data(100_000, rows=1, seed=18)
                                     .tobytes())
    tracing.reset_buffer()
    with tracing.span("test.encode") as root:
        ec_encoder.write_ec_files(str(tmp_path / "s"),
                                  ECContext(device="cpu"))
    names = {sp["name"] for sp in tracing.spans_for(root.trace_id)}
    assert {"encode.read", "encode.codec", "encode.write"} <= names
