"""The port's device telemetry (`profiling`), metrics registry (`stats`)
and span core (`tracing`) against the JAX package's: the same notes give
the same Prometheus text, and an encode and a rebuild leave the same six
stage spans with the same attributes (`backend` becomes `device`).
"""

import logging
import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu import profiling as ref_profiling
from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu import tracing as ref_tracing
from seaweedfs_tpu.storage import erasure_coding as ec_ref
from seaweedfs_tpu.storage.erasure_coding import ECContext as RefContext
from seaweedfs_tpu_torch import profiling, stats, tracing
from seaweedfs_tpu_torch.ops import staging
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
from seaweedfs_tpu_torch.storage.erasure_coding import (ec_decoder,
                                                        ec_encoder)
from seaweedfs_tpu_torch.storage.erasure_coding.ec_context import ECContext

STAGES = ("encode.read", "encode.codec", "encode.write",
          "rebuild.fetch", "rebuild.codec", "rebuild.write")


@pytest.fixture
def registries(monkeypatch):
    """Fresh process registries in both packages."""
    port = stats.Metrics("seaweedfs_tpu")
    ref = ref_stats.Metrics("seaweedfs_tpu")
    monkeypatch.setattr(stats, "PROCESS", port)
    monkeypatch.setattr(ref_stats, "PROCESS", ref)
    return port, ref


def _notes(mod):
    mod.device_note("h2d", 1 << 20, 0.001)
    mod.device_note("h2d", 4096, None)        # bytes only
    mod.device_note("d2h", 1 << 19, 0.002)
    mod.kernel_note("gf_apply_matrix", 0.003, 1 << 19)
    mod.kernel_note("gf_apply_matrix", 0.7)
    mod.overlap_note(0.25, 7, op="encode")
    mod.overlap_note(0.5, 3, op="rebuild")


# -- device telemetry --------------------------------------------------------

def test_notes_land_in_process_registry(registries):
    port, _ref = registries
    profiling.device_note("h2d", 1 << 20, 0.001)
    profiling.kernel_note("gf_apply_matrix", 0.002, 1 << 20)
    profiling.overlap_note(0.5, 4, op="rebuild")
    text = port.render()
    assert 'device_transfer_bytes_total{dir="h2d"}' in text
    assert 'device_kernel_last_ms{kernel="gf_apply_matrix"}' in text
    assert 'device_h2d_overlap_fraction{op="rebuild"} 0.5' in text
    assert port.counter_value("device_staged_windows_total",
                              op="rebuild") == 4.0
    assert port.gauge_value("device_h2d_gbps") == pytest.approx(
        (1 << 20) / 0.001 / 1e9)


def test_render_equals_reference_for_same_notes(registries):
    port, ref = registries
    _notes(profiling)
    _notes(ref_profiling)
    assert port.render() == ref.render()


def test_seconds_none_records_bytes_only(registries):
    port, _ref = registries
    profiling.device_note("d2h", 123, None)
    assert port.counter_value("device_transfer_bytes_total",
                              dir="d2h") == 123.0
    assert port.histogram_merged("device_transfer_seconds") is None
    assert port.gauge_value("device_d2h_gbps") is None


def test_sample_device_memory_without_a_card(registries, monkeypatch):
    port, _ref = registries
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.sample_device_memory() == {}
    assert "device_memory" not in port.render()


def test_sample_device_memory_one_sample_per_card(registries, monkeypatch):
    """Two (stand-in) cards give two samples, labelled cuda:<i>, from
    the allocator's counts and the card's total memory."""
    port, _ref = registries
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (1000 * (i + 1), 80_000 + i))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda i: 10 + i)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda i: 20 + i)
    got = profiling.sample_device_memory()
    assert got == {
        "cuda:0": {"bytes_in_use": 10, "peak_bytes_in_use": 20,
                   "bytes_limit": 80_000},
        "cuda:1": {"bytes_in_use": 11, "peak_bytes_in_use": 21,
                   "bytes_limit": 80_001}}
    assert port.gauge_value("device_memory_bytes_limit",
                            device="cuda:1") == 80_001.0
    assert port.gauge_value("device_memory_peak_bytes",
                            device="cuda:0") == 20.0


def test_windowed_launch_telemetry(registries, monkeypatch):
    """A windowed launch notes every window's h2d and d2h with its
    seconds, one kernel window per launch window, and its overlap."""
    port, _ref = registries
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.002")
    data = np.random.default_rng(3).integers(0, 256, (10, 20_000),
                                             dtype=np.uint8)
    pend = ReedSolomonTorch(10, 4, "cpu").parity_lazy(data)
    pend.materialize()
    n = pend.stats.windows
    assert n > 1
    assert port.counter_value("device_staged_windows_total",
                              op="encode") == n
    assert port.histogram_merged("device_kernel_seconds")["count"] == n
    assert port.histogram_merged("device_transfer_seconds")["count"] == 2 * n
    assert port.counter_value("device_transfer_bytes_total",
                              dir="h2d") == pend.stats.h2d_bytes
    assert port.gauge_value("device_h2d_overlap_fraction",
                            op="encode") == pend.stats.overlap_fraction


def test_one_shot_launch_telemetry(registries, monkeypatch):
    """The one-shot path notes h2d bytes without seconds, and on
    materialize the d2h wait and one kernel window (as the reference's
    _PendingParity)."""
    port, _ref = registries
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0")
    data = np.random.default_rng(4).integers(0, 256, (10, 1000),
                                             dtype=np.uint8)
    pend = ReedSolomonTorch(10, 4, "cpu").parity_lazy(data)
    assert port.counter_value("device_transfer_bytes_total",
                              dir="h2d") == 10 * 1008
    assert port.histogram_merged("device_kernel_seconds") is None
    pend.materialize()
    assert port.histogram_merged("device_kernel_seconds")["count"] == 1
    assert port.counter_value("device_transfer_bytes_total",
                              dir="d2h") == 4 * 1008
    assert port.counter_value("device_staged_windows_total",
                              op="encode") is None


# -- the registry ----------------------------------------------------------------

def test_metrics_registry_matches_reference():
    port, ref = stats.Metrics("ns"), ref_stats.Metrics("ns")
    for m in (port, ref):
        m.counter_add("hits_total", 2.0, help_text="hits",
                      peer='weird"peer\nname')
        m.counter_add("hits_total", 1.0, peer='weird"peer\nname')
        m.gauge_set("depth", 3.5, help_text="depth")
        m.histogram_observe("lat_seconds", 0.03, buckets=(0.01, 0.1))
        m.histogram_observe("lat_seconds", 7.0, buckets=(0.01, 0.1),
                            op="x")
        m.histogram_observe("lat_seconds", 0.005, buckets=(0.01, 0.1),
                            op="x")
    assert port.render() == ref.render()
    assert port.counter_value("hits_total", peer='weird"peer\nname') == 3.0
    assert port.counter_value("hits_total") is None
    assert port.gauge_value("depth") == 3.5
    assert port.histogram_merged("lat_seconds") == \
        ref.histogram_merged("lat_seconds")
    assert port.histogram_merged("lat_seconds")["count"] == 3
    assert port.histogram_merged("nope") is None


# -- the span core -------------------------------------------------------------

def test_span_parentage_and_ids():
    tracing.reset_buffer()
    with tracing.span("outer", role="volume") as outer:
        outer.set("k", 1)
        with tracing.span("inner") as inner:
            assert tracing.current_ids() == (outer.trace_id,
                                             inner.span_id, "volume")
        doc = tracing.emit_span("emitted", 1.0, 0.25, attrs={"a": 2})
    assert tracing.current_ids() is None
    spans = {s["name"]: s for s in tracing.spans_for(outer.trace_id)}
    assert spans["inner"]["parentId"] == outer.span_id
    assert spans["inner"]["role"] == "volume"
    assert spans["emitted"] == doc and doc["durationMs"] == 250.0
    assert doc["parentId"] == outer.span_id and doc["attrs"] == {"a": 2}
    assert spans["outer"]["attrs"] == {"k": 1}
    assert set(spans["outer"]) == {"traceId", "spanId", "parentId",
                                   "role", "name", "start", "durationMs",
                                   "attrs"}


def test_span_doc_keys_match_reference():
    with tracing.span("x", role="r") as sp:
        sp.set("a", 1)
    with ref_tracing.span("x", role="r") as ref_sp:
        ref_sp.set("a", 1)
    a, b = sp.to_dict(), ref_sp.to_dict()
    assert set(a) == set(b)
    assert {k: a[k] for k in ("role", "name", "attrs", "parentId")} == \
        {k: b[k] for k in ("role", "name", "attrs", "parentId")}


def test_span_error_and_double_finish():
    tracing.reset_buffer()
    with pytest.raises(ValueError):
        with tracing.span("fails") as sp:
            raise ValueError("bad")
    sp.finish()                  # a second finish records nothing
    docs = [d for d in tracing.recent_spans() if d["name"] == "fails"]
    assert len(docs) == 1
    assert docs[0]["error"] is True
    assert docs[0]["attrs"]["error"] == "ValueError: bad"


def test_request_id_is_the_trace_id():
    tracing.set_request_id("req-42")
    try:
        with tracing.span("r") as sp:
            pass
        assert sp.trace_id == "req-42"
        assert tracing.get_request_id() == "req-42"
    finally:
        tracing.set_request_id("")


def test_sampling_buffer_and_slow_log(monkeypatch, caplog):
    tracing.reset_buffer()
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE_SAMPLE", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_SLOW_MS", "100")
    with caplog.at_level(logging.WARNING, "seaweedfs_tpu_torch.trace"):
        tracing.emit_span("dropped-but-slow", 0.0, 0.5)
    assert tracing.recent_spans() == []
    assert "slow span dropped-but-slow" in caplog.text
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE_SAMPLE", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE_BUFFER", "20")
    for i in range(30):
        tracing.emit_span(f"s{i}", 0.0, 0.0)
    recent = tracing.recent_spans()
    assert len(recent) == 20 and recent[-1]["name"] == "s29"
    assert [d["name"] for d in tracing.recent_spans(limit=2)] == \
        ["s28", "s29"]
    assert tracing.buffer_size() == 20
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE_BUFFER", "1")
    assert tracing.buffer_size() == 16          # floor
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE_SAMPLE", "7")
    assert tracing.sample_rate() == 1.0
    tracing.reset_buffer()
    assert tracing.recent_spans() == []


# -- the six stage spans -----------------------------------------------------

@pytest.fixture
def patched_blocks(monkeypatch):
    for mod in (ec_ref.ec_encoder, ec_ref.ec_decoder, ec_encoder,
                ec_decoder):
        monkeypatch.setattr(mod, "LARGE_BLOCK_SIZE", 4096)
        monkeypatch.setattr(mod, "SMALL_BLOCK_SIZE", 1024)


def _stage_spans(tr, enc, ctx, base, lost, role):
    """Encode `base`, lose `lost`, rebuild, all under one root span;
    returns (root span, {stage name: span doc})."""
    tr.reset_buffer()
    with tr.span("ec.encode", role=role) as root:
        enc.write_ec_files(base, ctx)
        for sid in lost:
            os.remove(base + ctx.to_ext(sid))
        assert enc.rebuild_ec_files(base, ctx) == list(lost)
    spans = {s["name"]: s for s in tr.spans_for(root.trace_id)
             if s["name"] in STAGES}
    return root, spans


def test_six_stage_spans_match_reference(tmp_path, patched_blocks,
                                         monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.002")
    blob = np.random.default_rng(5).integers(0, 256, 47_001,
                                             dtype=np.uint8).tobytes()
    for kind in ("t", "j"):
        (tmp_path / f"{kind}.dat").write_bytes(blob)
    lost = (0, 7, 13)
    root, spans = _stage_spans(tracing, ec_encoder, ECContext(device="cpu"),
                               str(tmp_path / "t"), lost, "volume")
    assert sorted(spans) == sorted(STAGES)
    for name, sp in spans.items():
        assert sp["parentId"] == root.span_id, name
        assert sp["traceId"] == root.trace_id and sp["role"] == "volume"
        assert sp["attrs"]["calls"] >= 1
        assert 0 <= sp["attrs"]["busySeconds"] <= \
            sp["durationMs"] / 1e3 + 1e-3
    assert spans["encode.codec"]["attrs"]["device"] == "cpu"
    _ref_root, ref_spans = _stage_spans(
        ref_tracing, ec_ref.ec_encoder, RefContext(backend="jax"),
        str(tmp_path / "j"), lost, "volume")
    assert sorted(ref_spans) == sorted(STAGES)
    for name in STAGES:
        got = dict(spans[name]["attrs"])
        want = dict(ref_spans[name]["attrs"])
        for a in (got, want):
            a.pop("busySeconds")
        if name == "encode.codec":
            assert got.pop("device") == "cpu"
            assert want.pop("backend") == "jax"
        assert got == want, name
    assert spans["encode.read"]["attrs"]["datBytes"] == 47_001
    assert spans["rebuild.codec"]["attrs"]["missingShards"] == list(lost)


def test_stage_spans_without_a_parent_get_their_own_trace(tmp_path):
    """Outside any span the stages still land, each as a root span."""
    (tmp_path / "n.dat").write_bytes(bytes(5000))
    tracing.reset_buffer()
    ec_encoder.write_ec_files(str(tmp_path / "n"), ECContext(device="cpu"))
    names = {s["name"]: s for s in tracing.recent_spans()}
    for stage in STAGES[:3]:
        assert names[stage]["parentId"] == ""


def test_failed_encode_marks_write_span_aborted(tmp_path, monkeypatch):
    (tmp_path / "x.dat").write_bytes(bytes(9000))
    from seaweedfs_tpu_torch.storage.erasure_coding import shard_sink

    def boom(self, _data):
        raise OSError("disk full")

    monkeypatch.setattr(shard_sink.LocalShardSink, "write", boom)
    tracing.reset_buffer()
    with tracing.span("ec.encode") as root:
        with pytest.raises(OSError):
            ec_encoder.write_ec_files(str(tmp_path / "x"),
                                      ECContext(device="cpu"))
    spans = {s["name"]: s for s in tracing.spans_for(root.trace_id)}
    assert spans["encode.write"]["attrs"]["aborted"] is True


def test_staging_snapshot_counts_match_notes(registries, monkeypatch):
    port, _ref = registries
    monkeypatch.setenv("SEAWEEDFS_TPU_H2D_WINDOW_MB", "0.002")
    staging.reset_aggregate()
    codec = ReedSolomonTorch(10, 4, "cpu")
    data = np.random.default_rng(6).integers(0, 256, (10, 9_000),
                                             dtype=np.uint8)
    codec.parity_lazy(data).materialize()
    codec.apply_matrix_lazy(np.eye(10, dtype=np.uint8)[:3], data) \
        .materialize()
    snap = staging.snapshot()
    assert snap["launches"] == 2
    assert snap["windows"] == sum(
        port.counter_value("device_staged_windows_total", op=op)
        for op in ("encode", "rebuild"))
