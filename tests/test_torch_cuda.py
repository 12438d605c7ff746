"""The port's CUDA kernel and codec on the card, held against the plain
PyTorch version and the numpy twin (exact: GF arithmetic is integer),
a streamed rebuild between two port volume servers on the card, and a
worker-mode job of the port's maintenance plane on the card.  One test
runs only where there is no card: `worker -device cuda` must fail there.

Marked `cuda`; each test skips when no CUDA device is present.  This
file imports neither JAX nor the JAX package, so on a machine with a
card it runs without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import itertools

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_matrix, staging
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, k, w):
    return rng.integers(-2**31, 2**31, size=(k, w), dtype=np.int64
                        ).astype(np.int32)


@pytest.mark.parametrize("r,k,w", [
    (4, 10, 4096), (4, 10, 4099), (3, 6, 250001), (1, 1, 1),
    (8, 8, 64), (9, 5, 1000), (16, 16, 8192), (31, 1, 17), (1, 32, 515),
    (32, 32, 2048)])
def test_kernel_matches_plain_and_numpy(cuda, r, k, w):
    rng = np.random.default_rng(r * 1000 + k * 10 + w)
    mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
    data = _words(rng, k, w)
    tables = rs_cuda.tables_from_numpy(mat, cuda)
    dev = torch.from_numpy(data).to(cuda)
    before = rs_cuda.LAUNCHES
    got = rs_cuda.gf_apply_matrix_words(tables, dev)
    torch.cuda.synchronize()
    assert rs_cuda.LAUNCHES == before + 1
    plain = rs_cuda.gf_apply_matrix_words_plain(tables, dev)
    assert torch.equal(got, plain)
    want = gf256.gf_apply_matrix(mat, data.view(np.uint8))
    assert np.array_equal(got.cpu().numpy().view(np.uint8), want)


def test_kernel_unaligned_views(cuda):
    """A data view that starts off a 16-byte boundary takes the word
    path and stays exact."""
    rng = np.random.default_rng(5)
    mat = rs_matrix.parity_matrix(10, 4)
    base = torch.from_numpy(_words(rng, 1, 10 * 4096 + 1)).to(cuda)
    dev = base[0, 1:].view(10, 4096)
    tables = rs_cuda.tables_from_numpy(mat, cuda)
    got = rs_cuda.gf_apply_matrix_words(tables, dev)
    assert torch.equal(got, rs_cuda.gf_apply_matrix_words_plain(tables, dev))


def test_wrapper_rejects_bad_inputs(cuda):
    tables = rs_cuda.tables_from_numpy(np.ones((2, 3), np.uint8), cuda)
    data = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rs_cuda.gf_apply_matrix_words(tables, data.to(torch.int64))
    with pytest.raises(ValueError):   # 48 table entries do not fit K=5
        rs_cuda.gf_apply_matrix_words(
            tables, torch.zeros((5, 8), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_matrix_words(tables.cpu(), data)
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_matrix_words(tables, data.t())


@pytest.mark.parametrize("d,p", [(10, 4), (6, 3)])
def test_codec_lazy_on_card_matches_cpu(cuda, d, p):
    rng = np.random.default_rng(d + p)
    gpu = ReedSolomonTorch(d, p, "cuda")
    cpu = ReedSolomonTorch(d, p, "cpu")
    data = rng.integers(0, 256, size=(d, 3 * 65536 + 5), dtype=np.uint8)
    handles = [gpu.parity_lazy(data) for _ in range(3)]
    want = cpu.parity(data)
    for h in handles:
        assert np.array_equal(h.materialize(), want)
    present = [True] * (d + p)
    for i in (0, d - 1, d):
        present[i] = False
    m, rows = rs_matrix.cached_reconstruction_matrix(
        d, p, tuple(present), (0, d - 1, d))
    full = np.concatenate([data, want])
    rec = gpu.apply_matrix_lazy(m, full[list(rows)]).materialize()
    assert np.array_equal(rec, full[[0, d - 1, d]])
    gpu.parity_lazy(data).abort()


@pytest.mark.parametrize("v,r,k,w", [
    (1, 4, 10, 4096), (3, 4, 10, 1001), (8, 4, 10, 4100), (64, 4, 10, 256),
    (5, 9, 5, 333), (2, 16, 16, 2048), (7, 1, 1, 3), (4, 31, 2, 64)])
def test_batched_kernel_matches_plain(cuda, v, r, k, w):
    rng = np.random.default_rng(v * 10000 + r * 100 + k + w)
    mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
    batch = torch.from_numpy(np.stack([_words(rng, k, w) for _ in range(v)])
                             ).to(cuda)
    tables = rs_cuda.tables_from_numpy(mat, cuda)
    before = rs_cuda.LAUNCHES_BATCHED
    got = rs_cuda.gf_apply_matrix_words_batch(tables, batch)
    torch.cuda.synchronize()
    assert rs_cuda.LAUNCHES_BATCHED == before + 1
    assert torch.equal(got,
                       rs_cuda.gf_apply_matrix_words_batch_plain(tables, batch))
    for i in range(v):
        assert torch.equal(got[i], rs_cuda.gf_apply_matrix_words_plain(
            tables, batch[i].contiguous()))


def test_batched_wrapper_rejects_bad_inputs(cuda):
    tables = rs_cuda.tables_from_numpy(np.ones((2, 3), np.uint8), cuda)
    with pytest.raises(ValueError):     # not a [V, K, W] batch
        rs_cuda.gf_apply_matrix_words_batch(
            tables, torch.zeros((3, 8), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):     # 48 entries do not fit K=5
        rs_cuda.gf_apply_matrix_words_batch(
            tables, torch.zeros((2, 5, 8), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):     # too many volumes for the grid
        rs_cuda.gf_apply_matrix_words_batch(
            tables, torch.zeros((65536, 3, 1), dtype=torch.int32,
                                device=cuda))


def test_windowed_parity_matches_one_shot(cuda, monkeypatch):
    """A windowed parity_lazy (many windows, a ragged tail) equals the
    one-shot launch bit for bit, and launches once per window."""
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.25")
    rng = np.random.default_rng(77)
    gpu = ReedSolomonTorch(10, 4, "cuda")
    data = rng.integers(0, 256, size=(10, 5 * 65536 + 12345), dtype=np.uint8)
    before = rs_cuda.LAUNCHES
    win = gpu.parity_lazy(data)
    assert hasattr(win, "windows")
    got = win.materialize()
    w = -(-data.shape[1] // 16) * 4
    assert rs_cuda.LAUNCHES - before == len(staging.plan_windows(10, w))
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0")
    one = gpu.parity_lazy(data)
    assert not hasattr(one, "windows")
    assert np.array_equal(got, one.materialize())
    assert np.array_equal(got, gf256.gf_apply_matrix(
        rs_matrix.parity_matrix(10, 4), data))
    assert len(staging.POOL) <= staging.POOL.max_bufs


def _in_fresh_thread(fn):
    """fn() on a new thread (whose current CUDA device is the default
    one): its result, or its exception re-raised here."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    return out["value"]


def _launches_on(dev: torch.device, monkeypatch):
    """Both wrappers and a WindowedLaunch of several windows, each run
    from a fresh thread with the codec's device given explicitly, held
    against the plain version."""
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.25")
    rng = np.random.default_rng(dev.index or 0)
    mat = rs_matrix.parity_matrix(10, 4)
    tables = rs_cuda.tables_from_numpy(mat, dev)
    data = torch.from_numpy(_words(rng, 10, 65536 + 3)).to(dev)
    got = _in_fresh_thread(
        lambda: rs_cuda.gf_apply_matrix_words(tables, data))
    assert got.device == dev
    assert torch.equal(got, rs_cuda.gf_apply_matrix_words_plain(tables,
                                                                 data))
    batch = torch.from_numpy(_words(rng, 3 * 10, 4096)).to(dev).view(
        3, 10, 4096)
    got = _in_fresh_thread(
        lambda: rs_cuda.gf_apply_matrix_words_batch(tables, batch))
    assert torch.equal(got, rs_cuda.gf_apply_matrix_words_batch_plain(
        tables, batch))
    host = rng.integers(0, 256, size=(10, 5 * 65536 + 12345),
                        dtype=np.uint8)
    codec = ReedSolomonTorch(10, 4, str(dev))

    before = rs_cuda.LAUNCHES
    got = _in_fresh_thread(lambda: codec.parity_lazy(host).materialize())
    n_windows = len(staging.plan_windows(10, -(-host.shape[1] // 16) * 4))
    assert n_windows > 1 and rs_cuda.LAUNCHES - before == n_windows
    assert np.array_equal(got, gf256.gf_apply_matrix(mat, host))


def test_launches_from_a_fresh_thread(cuda, monkeypatch):
    _launches_on(torch.device("cuda", 0), monkeypatch)


def test_launches_on_a_second_device_from_a_fresh_thread(cuda,
                                                         monkeypatch):
    """A codec on cuda:1 launched from threads whose current device is
    0: the wrappers and the staging thread make cuda:1 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    _launches_on(torch.device("cuda", 1), monkeypatch)


def test_batched_kernel_unaligned_base(cuda):
    """A batch whose base is off a 16-byte boundary (W % 4 == 0): no
    volume may take the uint4 path, and every volume stays exact."""
    rng = np.random.default_rng(6)
    v, k, w = 3, 10, 4096
    base = torch.from_numpy(_words(rng, 1, v * k * w + 1)).to(cuda)
    batch = base[0, 1:].view(v, k, w)
    tables = rs_cuda.tables_from_numpy(rs_matrix.parity_matrix(k, 4), cuda)
    got = rs_cuda.gf_apply_matrix_words_batch(tables, batch)
    assert torch.equal(
        got, rs_cuda.gf_apply_matrix_words_batch_plain(tables, batch))


def test_windowed_abort_waits_and_bounds_pool(cuda, monkeypatch):
    """An undrained windowed launch aborted on the card stops its
    staging thread once its in-flight windows are done, and the pinned
    pool stays within its bound."""
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.25")
    rng = np.random.default_rng(78)
    gpu = ReedSolomonTorch(10, 4, "cuda")
    data = rng.integers(0, 256, size=(10, 9 * 65536 + 3), dtype=np.uint8)
    win = gpu.parity_lazy(data)
    win.abort()
    assert not win._t.is_alive()
    assert len(staging.POOL) <= staging.POOL.max_bufs
    assert staging.POOL.nbytes <= staging.POOL.max_bytes
    assert np.array_equal(gpu.parity_lazy(data).materialize(),
                          gf256.gf_apply_matrix(
                              rs_matrix.parity_matrix(10, 4), data))


def _rec_matrix(lost, d=10, p=4):
    present = tuple(i not in lost for i in range(d + p))
    return np.asarray(rs_matrix.cached_reconstruction_matrix(
        d, p, present, tuple(lost))[0])


_TEMPLATE_CASES = [
    ("parity", rs_matrix.parity_matrix(10, 4)),
    ("rebuild4", _rec_matrix((0, 7, 11, 13))),
    ("rebuild3", _rec_matrix((2, 5, 12))),
    ("rebuild2", _rec_matrix((0, 13))),
    ("rebuild1", _rec_matrix((9,))),
    ("parity_6_3", rs_matrix.parity_matrix(6, 3)),
    ("rebuild3_6_3", _rec_matrix((0, 4, 8), 6, 3)),
    ("rebuild2_6_3", _rec_matrix((1, 5), 6, 3)),
    ("rebuild1_6_3", _rec_matrix((3,), 6, 3)),
    ("generic_4_6", np.random.default_rng(3).integers(
        0, 256, (4, 6), dtype=np.uint8)),
    ("generic_5_10", np.random.default_rng(1).integers(
        0, 256, (5, 10), dtype=np.uint8)),
    ("generic_12_20", np.random.default_rng(2).integers(
        0, 256, (12, 20), dtype=np.uint8)),
]


@pytest.mark.parametrize("name,mat", _TEMPLATE_CASES,
                         ids=[c[0] for c in _TEMPLATE_CASES])
@pytest.mark.parametrize("aligned", [True, False], ids=["uint4", "word"])
def test_each_template_matches_plain(cuda, name, mat, aligned):
    """Each specialised template and the generic body, on uint4 columns
    and (from a base off a 16-byte boundary) on word columns, bit for
    bit against the plain version; the launch plan names the body the
    template map chose."""
    r, k = mat.shape
    rng = np.random.default_rng(r * 100 + k)
    w = 4 * 40_009
    base = torch.from_numpy(_words(rng, 1, k * w + 1)).to(cuda)
    dev = (base[0, :k * w] if aligned else base[0, 1:]).view(k, w)
    tables = rs_cuda.tables_from_numpy(mat, cuda)
    got = rs_cuda.gf_apply_matrix_words(tables, dev)
    assert torch.equal(got, rs_cuda.gf_apply_matrix_words_plain(tables, dev))
    plan = rs_cuda.launch_plan(r, k, w, 1, aligned)
    assert plan["specialised"] == rs_cuda.specialised(r, k)
    assert plan["grid_blocks"] <= plan["sms"] * plan["resident_blocks_per_sm"]


def test_every_4_loss_rebuild_matrix_of_rs_10_4(cuda):
    """All 1001 ways to lose 4 of RS(10,4)'s 14 shards: each rebuild
    matrix through the [4, 10] template equals the numpy twin."""
    rng = np.random.default_rng(1001)
    w = 4 * 33
    survivors = rng.integers(0, 256, (10, 4 * w), dtype=np.uint8)
    dev = torch.from_numpy(survivors.view(np.int32)).to(cuda)
    n = 0
    for lost in itertools.combinations(range(14), 4):
        mat = _rec_matrix(lost)
        got = rs_cuda.gf_apply_matrix_words(
            rs_cuda.tables_from_numpy(mat, cuda), dev)
        assert np.array_equal(got.cpu().numpy().view(np.uint8),
                              gf256.gf_apply_matrix(mat, survivors)), lost
        n += 1
    assert n == 1001


@pytest.mark.parametrize("r", [1, 4])
def test_columns_not_a_multiple_of_the_persistent_grid(cuda, r):
    """W such that the persistent grid's threads walk unequal column
    counts (and the volume index wraps mid-walk in the batched entry)."""
    plan = rs_cuda.launch_plan(r, 10, 1 << 24)
    threads = plan["grid_blocks"] * plan["threads"]
    w = 4 * (2 * threads + 37)
    rng = np.random.default_rng(r + 7)
    mat = _rec_matrix(tuple(range(r))) if r < 4 else \
        rs_matrix.parity_matrix(10, 4)
    tables = rs_cuda.tables_from_numpy(mat, cuda)
    dev = torch.from_numpy(_words(rng, 10, w)).to(cuda)
    assert rs_cuda.launch_plan(r, 10, w)["columns_per_thread"] % 1 != 0
    assert torch.equal(rs_cuda.gf_apply_matrix_words(tables, dev),
                       rs_cuda.gf_apply_matrix_words_plain(tables, dev))
    batch = torch.from_numpy(np.stack(
        [_words(rng, 10, threads // 3 + 1) for _ in range(5)])).to(cuda)
    assert torch.equal(rs_cuda.gf_apply_matrix_words_batch(tables, batch),
                       rs_cuda.gf_apply_matrix_words_batch_plain(tables,
                                                                 batch))


@pytest.mark.parametrize("v", [1, 3, 64])
@pytest.mark.parametrize("w", [4097, 4100, 1023])
@pytest.mark.parametrize("mat_name", ["parity", "parity_6_3"])
def test_batched_ragged_volumes(cuda, v, w, mat_name):
    mat = dict(_TEMPLATE_CASES)[mat_name]
    r, k = mat.shape
    rng = np.random.default_rng(v * 7 + w)
    batch = torch.from_numpy(np.stack([_words(rng, k, w) for _ in range(v)])
                             ).to(cuda)
    tables = rs_cuda.tables_from_numpy(mat, cuda)
    got = rs_cuda.gf_apply_matrix_words_batch(tables, batch)
    assert torch.equal(
        got, rs_cuda.gf_apply_matrix_words_batch_plain(tables, batch))


def test_two_streams_two_matrices(cuda):
    """Launches of different matrices on two streams at once, the
    non-default one among them: the tables travel with each launch, so
    neither stream sees the other's."""
    rng = np.random.default_rng(11)
    w = 1 << 20
    dev = torch.from_numpy(_words(rng, 10, w)).to(cuda)
    mats = [rs_matrix.parity_matrix(10, 4), _rec_matrix((0, 7, 11, 13)),
            _rec_matrix((1, 2)), rs_matrix.parity_matrix(6, 3)]
    tables = [rs_cuda.tables_from_numpy(m, cuda) for m in mats]
    srcs = [dev, dev, dev, dev[:6].contiguous()]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    outs = []
    for rep in range(4):
        for i, t in enumerate(tables):
            s = streams[(i + rep) % 2]
            outs.append((i, rs_cuda.gf_apply_matrix_words(t, srcs[i],
                                                          stream=s)))
    torch.cuda.synchronize()
    for i, got in outs:
        assert torch.equal(got, rs_cuda.gf_apply_matrix_words_plain(
            tables[i], srcs[i])), i


def test_host_tables_follow_the_device_tensor(cuda):
    """Tables moved to the card by hand have no kept host copy: the
    first launch copies them back once; after an in-place change the
    next launch sees the new tables."""
    rng = np.random.default_rng(12)
    dev = torch.from_numpy(_words(rng, 10, 4096)).to(cuda)
    tables = rs_cuda.tables_from_numpy(rs_matrix.parity_matrix(10, 4)).to(
        cuda)
    got = rs_cuda.gf_apply_matrix_words(tables, dev)
    assert torch.equal(got, rs_cuda.gf_apply_matrix_words_plain(tables, dev))
    assert rs_cuda.host_tables(tables) is rs_cuda.host_tables(tables)
    tables.copy_(rs_cuda.tables_from_numpy(_rec_matrix((3, 4, 5, 6)), cuda))
    got = rs_cuda.gf_apply_matrix_words(tables, dev)
    assert torch.equal(got, rs_cuda.gf_apply_matrix_words_plain(tables, dev))


def test_grid_functions_on_the_card(cuda):
    """encode_volume_batch and distributed_ec_step on the card's grid
    (every CUDA device): one batched launch per grid device, err 0."""
    from seaweedfs_tpu_torch.parallel import ec_sharded, make_mesh
    grid = make_mesh()
    rng = np.random.default_rng(79)
    s = grid.shape["stripe"]
    batch = rng.integers(0, 256, size=(2 * s, 10, 4 * 4099), dtype=np.uint8)
    batch32 = batch.view(np.uint32)
    before = rs_cuda.LAUNCHES_BATCHED
    got = ec_sharded.encode_volume_batch(
        grid, rs_matrix.parity_matrix(10, 4), batch32)
    n_dev = s * grid.shape["shard"]
    assert rs_cuda.LAUNCHES_BATCHED - before == n_dev
    pm = rs_matrix.parity_matrix(10, 4)
    for i in range(2 * s):
        assert np.array_equal(got[i].cpu().numpy().view(np.uint8),
                              gf256.gf_apply_matrix(pm, batch[i]))
    data32 = rng.integers(0, 1 << 32, size=(10, 4096 * s),
                          dtype=np.uint32)
    for lost in ((0, 11), (3, 7), (10, 13)):
        _par, _rec, err = ec_sharded.distributed_ec_step(grid, data32,
                                                         lost=lost)
        assert err == 0


# --- the streamed rebuild's shapes (two data shards lost) -------------------

@pytest.mark.parametrize("lost", [(1, 8), (0, 13), (4, 9)])
@pytest.mark.parametrize("w", [838_860, 419_432, 157_291, 3],
                         ids=["window", "step-tail", "last-tail", "tiny"])
def test_rebuild_2_of_14_window_and_tail_shapes(cuda, lost, w):
    """[2,10] rebuild matrices at the streamed rebuild's window (8 MiB
    slices of 10 rows cut into 32 MiB windows), its step tail, a ragged
    last tail and a tiny launch."""
    rng = np.random.default_rng(sum(lost) * 7 + w)
    mat = _rec_matrix(lost)
    assert mat.shape == (2, 10)
    data = torch.from_numpy(_words(rng, 10, w)).to(cuda)
    tables = rs_cuda.tables_from_numpy(mat, cuda)
    before = rs_cuda.LAUNCHES
    got = rs_cuda.gf_apply_matrix_words(tables, data)
    torch.cuda.synchronize()
    assert rs_cuda.LAUNCHES == before + 1
    assert torch.equal(got, rs_cuda.gf_apply_matrix_words_plain(tables,
                                                                data))


def test_streamed_rebuild_on_the_card_equals_cpu(cuda, tmp_path,
                                                 monkeypatch):
    """Two in-process port servers: the rebuilder (codec on the card)
    streams the survivors it lacks from the other; the rebuilt shards
    equal the CPU encode's, with one launch per staging window."""
    import os

    from seaweedfs_tpu_torch.server.httpd import http_json
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.erasure_coding import (ec_context,
                                                            ec_encoder)
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    monkeypatch.setattr(ec_context, "DEVICE_BATCH_SIZE", 1 << 20)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_REBUILD_SLICE_MB", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "1")
    src = tmp_path / "src"
    src.mkdir()
    v = Volume(str(src), 1)
    rng = np.random.default_rng(81)
    nid = 0
    while v.dat_size() < 12 << 20:
        nid += 1
        v.write_needle(Needle(cookie=nid, id=nid, data=rng.bytes(
            int(rng.integers(1000, 300_000)))))
    v.close()
    base = str(src / "1")
    cpu = ec_context.ECContext(device="cpu")
    ec_encoder.write_sorted_file_from_idx(base)
    ec_encoder.write_ec_files(base, cpu)
    ec_encoder.save_ec_volume_info(base, cpu, os.path.getsize(base + ".dat"),
                                   3)
    lost = (1, 8)
    dirs = [tmp_path / "a", tmp_path / "b"]
    for i, d in enumerate(dirs):
        d.mkdir()
        for sid in range(14):
            if sid % 2 == i and sid not in lost:
                os.link(f"{base}.ec{sid:02d}", d / f"1.ec{sid:02d}")
        for ext in (".ecx", ".vif"):
            os.link(base + ext, d / f"1{ext}")
    a = VolumeServer([str(dirs[0])]).start()
    b = VolumeServer([str(dirs[1])], device="cpu").start()
    try:
        for vs in (a, b):
            http_json("POST", f"{vs.url}/admin/ec/mount",
                      {"volumeId": 1, "shardIds": []}, timeout=10)
        shard = os.path.getsize(base + ".ec00")
        locs = {str(s): [b.url] for s in range(1, 14, 2) if s not in lost}
        before = rs_cuda.LAUNCHES
        r = http_json("POST", f"{a.url}/admin/ec/rebuild",
                      {"volumeId": 1, "shardLocations": locs}, timeout=120)
        launches = rs_cuda.LAUNCHES - before
    finally:
        a.stop()
        b.stop()
    assert r.get("rebuiltShardIds") == list(lost), r
    for sid in lost:
        with open(dirs[0] / f"1.ec{sid:02d}", "rb") as f, \
                open(f"{base}.ec{sid:02d}", "rb") as g:
            assert f.read() == g.read(), sid
    step = ec_encoder.rebuild_step(shard, cpu, 1 << 20)
    want = sum(len(staging.plan_windows(10, -(-min(step, shard - pos)
                                              // 16) * 4))
               for pos in range(0, shard, step))
    assert launches == want


def _launches_for(k, batch_bytes):
    """Kernel launches of one codec batch of k rows: one a staging window
    when the batch is larger than a window, else one."""
    from seaweedfs_tpu_torch.ops.rs_torch import PACK_MULTIPLE
    w = -(-batch_bytes // PACK_MULTIPLE) * PACK_MULTIPLE // 4
    wb = staging.window_bytes()
    if wb > 0 and k * w * 4 > wb:
        return len(staging.plan_windows(k, w))
    return 1


def test_worker_mode_job_on_the_card(cuda, tmp_path, monkeypatch):
    """The port's admin hands a worker-mode encode to a worker whose
    codec is on the card: the shards its servers mount equal the CPU
    encode's, and the worker launched the kernel once a staging window
    of the encode's work list."""
    import os
    import time

    from seaweedfs_tpu_torch.plugin import (AdminServer, EcEncodeHandler,
                                            PluginWorker)
    from seaweedfs_tpu_torch.server.httpd import http_json
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.erasure_coding import (ec_context,
                                                            ec_encoder)
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    monkeypatch.setattr(ec_context, "DEVICE_BATCH_SIZE", 1 << 20)
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "1")
    src = tmp_path / "src"
    src.mkdir()
    v = Volume(str(src), 1)
    rng = np.random.default_rng(83)
    nid = 0
    while v.dat_size() < 12 << 20:
        nid += 1
        v.write_needle(Needle(cookie=nid, id=nid, data=rng.bytes(
            int(rng.integers(1000, 300_000)))))
    v.close()
    base = str(src / "1")
    cpu = ec_context.ECContext(device="cpu")
    ec_encoder.write_ec_files(base, cpu)
    dat_size = os.path.getsize(base + ".dat")
    want = sum(_launches_for(cpu.data_shards, item[3])
               for item in ec_encoder._encode_work_items(dat_size, cpu))
    dirs = [tmp_path / f"v{i}" for i in range(3)]
    for d in dirs:
        d.mkdir()
    for ext in (".dat", ".idx"):
        os.link(base + ext, dirs[0] / f"1{ext}")
    made = [MasterServer(pulse_seconds=1.0).start()]
    master = made[0].url
    try:
        made += [VolumeServer([str(d)], device="cpu", master=master,
                              pulse_seconds=0.2).start() for d in dirs]
        admin = AdminServer(master, detection_interval=3600).start()
        made.append(admin)
        worker = PluginWorker(admin.url, master, str(tmp_path / "w"),
                              [EcEncodeHandler(device="cuda")],
                              poll_wait=1.0)
        deadline = time.monotonic() + 30
        while len(http_json("GET", f"{master}/cluster/status",
                            timeout=10)["dataNodes"]) < 3:
            assert time.monotonic() < deadline, "servers registered"
            time.sleep(0.05)
        made.append(worker.start())
        before = rs_cuda.LAUNCHES
        jid = http_json("POST", f"{admin.url}/maintenance/submit_job",
                        {"jobType": "erasure_coding",
                         "params": {"volumeId": 1}}, timeout=10)["jobId"]
        deadline = time.monotonic() + 120
        while True:
            job = http_json("GET", f"{admin.url}/maintenance/job?id={jid}",
                            timeout=10)
            if job["status"] in ("done", "failed"):
                break
            assert time.monotonic() < deadline, "job ends"
            time.sleep(0.1)
        launches = rs_cuda.LAUNCHES - before
    finally:
        for s in reversed(made):
            s.stop()
    assert job["status"] == "done", (job["message"], job["trace"])
    assert "(cuda)" in job["message"], job["message"]
    assert launches == want
    seen = set()
    for d in dirs:
        for sid in range(14):
            p = d / f"1.ec{sid:02d}"
            if p.exists():
                with open(p, "rb") as f, \
                        open(f"{base}.ec{sid:02d}", "rb") as g:
                    assert f.read() == g.read(), sid
                seen.add(sid)
    assert seen == set(range(14))


def test_worker_device_cuda_without_a_card_fails(tmp_path):
    """`worker -device cuda` on a machine without a card exits non-zero
    at start, before it registers (runs where there is no card)."""
    import os
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "worker",
         "-admin", "127.0.0.1:1", "-master", "127.0.0.1:1",
         "-dir", str(tmp_path), "-device", "cuda"],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=repo), cwd=str(tmp_path))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "polling" not in out.stdout


def test_degraded_reads_on_a_card_server_launch_nothing(cuda, tmp_path):
    """A volume server whose codec is on the card serves needle reads of
    an EC volume with a data shard lost: every needle equals its payload,
    some reads were degraded, and the kernel was not launched (degraded
    reads rebuild on the host CPU codec, as the reference's do)."""
    import os

    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.server.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage import types
    from seaweedfs_tpu_torch.storage.erasure_coding import (ec_context,
                                                            ec_encoder)
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    src = tmp_path / "src"
    src.mkdir()
    v = Volume(str(src), 1)
    rng = np.random.default_rng(85)
    payloads = {}
    while v.dat_size() < 3 << 20:
        nid = len(payloads) + 1
        payloads[nid] = rng.bytes(int(rng.integers(1000, 300_000)))
        v.write_needle(Needle(cookie=nid, id=nid, data=payloads[nid]))
    v.close()
    base = str(src / "1")
    cpu = ec_context.ECContext(device="cpu")
    ec_encoder.write_sorted_file_from_idx(base)
    ec_encoder.write_ec_files(base, cpu)
    ec_encoder.save_ec_volume_info(base, cpu, os.path.getsize(base + ".dat"),
                                   3)
    # shard 1 (the second MiB of the volume) is lost
    dirs = [tmp_path / "a", tmp_path / "b"]
    for i, d in enumerate(dirs):
        d.mkdir()
        for sid in range(14):
            if sid % 2 == i and sid != 1:
                os.link(f"{base}.ec{sid:02d}", d / f"1.ec{sid:02d}")
        for ext in (".ecx", ".vif"):
            os.link(base + ext, d / f"1{ext}")
    master = MasterServer(pulse_seconds=1.0).start()
    a = VolumeServer([str(dirs[0])], master=master.url,
                     pulse_seconds=0.2).start()
    b = VolumeServer([str(dirs[1])], device="cpu", master=master.url,
                     pulse_seconds=0.2).start()
    try:
        for vs in (a, b):
            http_json("POST", f"{vs.url}/admin/ec/mount",
                      {"volumeId": 1, "shardIds": []}, timeout=10)
        before = (rs_cuda.LAUNCHES, rs_cuda.LAUNCHES_BATCHED,
                  stats.PROCESS.counter_value("ec_degraded_reads_total",
                                              vid=1) or 0)
        for nid, payload in payloads.items():
            st, body, _ = http_bytes(
                "GET", f"{a.url}/{types.FileId(1, nid, nid)}", timeout=60)
            assert st == 200 and body == payload, nid
        assert (rs_cuda.LAUNCHES, rs_cuda.LAUNCHES_BATCHED) == before[:2]
        assert stats.PROCESS.counter_value("ec_degraded_reads_total",
                                           vid=1) > before[2]
    finally:
        a.stop()
        b.stop()
        master.stop()
