"""The port's GF(2^8) kernel function (`seaweedfs_tpu_torch.ops.rs_cuda`)
on the CPU, where the wrapper runs its plain PyTorch version, held
against the JAX package's Pallas kernel (interpret mode), its XLA
network `rs_jax.gf_apply_matrix_words` and the numpy twin
`gf256.gf_apply_matrix`.  Exact: GF arithmetic is integer (tolerance 0).
"""

import ast
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as gf256_ref
from seaweedfs_tpu.ops import rs_jax, rs_matrix as rs_matrix_ref
from seaweedfs_tpu.ops.rs_pallas import (TILE_WORDS, expand_tables,
                                         gf_apply_matrix_pallas)
from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_matrix, rs_torch
from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import ECContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_apply(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """[R,K] x [K,B] uint8 through the port's word-level entry point."""
    b = data.shape[1]
    words = torch.from_numpy(rs_torch.pack_words(data).view(np.int32))
    out = rs_cuda.gf_apply_matrix_words(rs_cuda.tables_from_numpy(mat),
                                        words)
    return rs_torch.unpack_words(out.numpy(), b)


def _rec_matrix(d, p, lost):
    present = tuple(i not in lost for i in range(d + p))
    m, _ = rs_matrix.cached_reconstruction_matrix(d, p, present,
                                                  tuple(lost))
    return np.asarray(m)


def _cases():
    rng = np.random.default_rng(7)
    return [
        ("parity_10_4", rs_matrix.parity_matrix(10, 4), TILE_WORDS * 4),
        ("parity_6_3", rs_matrix.parity_matrix(6, 3), TILE_WORDS * 4),
        ("unaligned_12345", rs_matrix.parity_matrix(4, 2), 12345),
        ("unaligned_1", rs_matrix.parity_matrix(10, 4), 1),
        ("unaligned_1001", rs_matrix.parity_matrix(3, 2), 1001),
        ("arbitrary_3x5",
         rng.integers(0, 256, size=(3, 5)).astype(np.uint8), 4096),
        ("reconstruction_10_4_lost_1_5_12",
         _rec_matrix(10, 4, (1, 5, 12)), 5000),
        ("reconstruction_6_3_lost_0_8", _rec_matrix(6, 3, (0, 8)), 777),
    ]


@pytest.mark.parametrize("name,mat,nbytes", _cases(),
                         ids=[c[0] for c in _cases()])
def test_plain_matches_pallas_xla_and_numpy(name, mat, nbytes):
    rng = np.random.default_rng(nbytes + mat.size)
    data = rng.integers(0, 256, size=(mat.shape[1], nbytes), dtype=np.uint8)
    got = _port_apply(mat, data)
    assert got.shape == (mat.shape[0], nbytes)
    # numpy twin (the port's copy, and the reference's)
    assert np.array_equal(got, gf256.gf_apply_matrix(mat, data))
    assert np.array_equal(got, gf256_ref.gf_apply_matrix(mat, data))
    # the XLA network production calls
    words = rs_jax.pack_words(data)
    xla = np.asarray(rs_jax.gf_apply_matrix_words(jnp.asarray(mat),
                                                  jnp.asarray(words)))
    assert np.array_equal(got, rs_jax.unpack_words(xla, nbytes))
    # the Pallas kernel, in interpret mode
    pallas = np.asarray(gf_apply_matrix_pallas(mat, data))
    assert np.array_equal(got, pallas)


def test_word_level_bits_match_xla_with_high_bits_set():
    """int32 words with the sign bit set give the uint32 result bit for
    bit (arithmetic shifts are masked, products wrap)."""
    mat = rs_matrix.parity_matrix(10, 4)
    words = np.full((10, 64), 0xFFFFFFFF, dtype=np.uint32)
    words[:, ::3] = 0x80808080
    got = rs_cuda.gf_apply_matrix_words(
        rs_cuda.tables_from_numpy(mat),
        torch.from_numpy(words.view(np.int32))).numpy().view(np.uint32)
    want = np.asarray(rs_jax.gf_apply_matrix_words(jnp.asarray(mat),
                                                   jnp.asarray(words)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(4, 10), (3, 6), (1, 1), (16, 16),
                                   (31, 1)])
def test_tables_from_numpy_equals_expand_tables(shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    mat = rng.integers(0, 256, size=shape).astype(np.uint8)
    got = rs_cuda.tables_from_numpy(mat)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    want = expand_tables(mat)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().astype(np.int64),
                          want.astype(np.int64))


def test_tables_and_matrices_equal_reference_copies():
    assert np.array_equal(gf256.MUL_TABLE, gf256_ref.MUL_TABLE)
    assert np.array_equal(gf256.MUL_BY_POW2, gf256_ref.MUL_BY_POW2)
    for d, p in [(10, 4), (6, 3), (4, 2), (20, 12)]:
        assert np.array_equal(rs_matrix.build_matrix(d, d + p),
                              rs_matrix_ref.build_matrix(d, d + p))


def test_launches_stay_zero_on_cpu():
    assert rs_cuda.LAUNCHES == 0
    mat = rs_matrix.parity_matrix(10, 4)
    data = np.random.default_rng(1).integers(0, 256, (10, 4096),
                                             dtype=np.uint8)
    _port_apply(mat, data)
    rs_torch.ReedSolomonTorch(10, 4, "cpu").parity_lazy(data).materialize()
    assert rs_cuda.LAUNCHES == 0


def test_wrapper_checks_inputs():
    tables = rs_cuda.tables_from_numpy(np.ones((2, 3), np.uint8))
    data = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        rs_cuda.gf_apply_matrix_words(tables, data.to(torch.int64))
    with pytest.raises(ValueError):      # 48 entries do not fit K=5
        rs_cuda.gf_apply_matrix_words(
            tables, torch.zeros((5, 8), dtype=torch.int32))
    with pytest.raises(ValueError):      # not contiguous
        rs_cuda.gf_apply_matrix_words(
            tables, torch.zeros((8, 3), dtype=torch.int32).t())
    with pytest.raises(ValueError):      # R = 33 output rows
        rs_cuda.gf_apply_matrix_words(
            rs_cuda.tables_from_numpy(np.ones((33, 3), np.uint8)), data)
    with pytest.raises(ValueError):      # no kernel for this device
        rs_cuda.gf_apply_matrix_words(tables.to("meta"), data.to("meta"))


def test_create_codec_raises_without_cuda(monkeypatch):
    """ECContext() defaults to the card; with none present it raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = ECContext()
    assert ctx.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctx.create_codec()
    assert ECContext(device="cpu").create_codec().device.type == "cpu"


PORT_MODULES_OF_SLICE_2 = (
    "seaweedfs_tpu_torch.stats", "seaweedfs_tpu_torch.profiling",
    "seaweedfs_tpu_torch.tracing", "seaweedfs_tpu_torch.ops.staging",
    "seaweedfs_tpu_torch.parallel", "seaweedfs_tpu_torch.parallel.mesh",
    "seaweedfs_tpu_torch.parallel.ec_sharded",
    "seaweedfs_tpu_torch.parallel.ec_batch")

PORT_MODULES_OF_SLICE_5 = (
    "seaweedfs_tpu_torch.__main__", "seaweedfs_tpu_torch.server",
    "seaweedfs_tpu_torch.server.httpd",
    "seaweedfs_tpu_torch.server.volume_server",
    "seaweedfs_tpu_torch.storage.store",
    "seaweedfs_tpu_torch.storage.erasure_coding.ec_volume")

PORT_MODULES_OF_SLICE_7 = (
    "seaweedfs_tpu_torch.ops.rs_cpu",
    "seaweedfs_tpu_torch.storage.erasure_coding.ec_locate",
    "seaweedfs_tpu_torch.server.store_ec")

PORT_MODULES_OF_SLICE_9 = (
    "seaweedfs_tpu_torch.sequence", "seaweedfs_tpu_torch.benchmark",
    "seaweedfs_tpu_torch.operation")
PORT_MODULES_OF_SLICE_12 = tuple(
    f"seaweedfs_tpu_torch.{m}" for m in (
        "util.group_commit", "util.limiter", "filer", "filer.entry",
        "filer.filechunks", "filer.filer_store", "filer.abstract_sql",
        "filer.meta_log", "filer.meta_plane", "filer.meta_cache",
        "filer.filer", "filer.client", "server.filer_server",
        "shell.fs_commands"))


def test_port_imports_neither_jax_nor_reference_package():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import seaweedfs_tpu_torch as p\n"
        "mods = [m.name for m in\n"
        "        pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or\n"
        "             k.startswith(('jax.', 'jaxlib')) or\n"
        "             k.split('.')[0] == 'seaweedfs_tpu')\n"
        "print(json.dumps([mods, bad]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(mods) >= 31
    assert set(PORT_MODULES_OF_SLICE_2) <= set(mods)
    assert set(PORT_MODULES_OF_SLICE_5) <= set(mods)
    assert set(PORT_MODULES_OF_SLICE_7) <= set(mods)
    assert set(PORT_MODULES_OF_SLICE_9) <= set(mods)
    assert set(PORT_MODULES_OF_SLICE_12) <= set(mods)
    assert bad == []


def _imported_names(path: str) -> "list[str]":
    """Every absolute module a source file imports, at any depth (an
    import inside a function does not run at import time)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_sources_name_neither_jax_nor_reference_package():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO,
                                                   "seaweedfs_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) >= 33
    for path in paths:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "seaweedfs_tpu"), \
                f"{os.path.relpath(path, REPO)} imports {name}"
