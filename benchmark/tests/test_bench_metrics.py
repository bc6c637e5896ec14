"""The metric arithmetic: the tail over every batch, the idle share and
the kernels of a trace, and the frozen byte counts against
``chip_smoke.py``'s."""

import importlib.util

import numpy as np
import pytest
import torch

from benchmark import harness, roofline, trace
from benchmark.drivers.open_loop_stream import latencies, percentile

ROOT = harness.ROOT


def test_p95_counts_late_and_missing_batches():
    due = np.arange(100) * 0.01
    done = due + 0.002
    done[10] = due[10] + 0.5                 # served late
    done[20:24] = np.nan                     # never refitted
    lat = latencies(due, done, end=5.0)
    assert lat[10] == pytest.approx(0.5)
    assert lat[20] == pytest.approx(5.0 - 0.2)
    # 5 of 100 batches over 2 ms: the nearest-rank p95 is the 95th smallest
    assert percentile(lat, 95) == pytest.approx(0.002)
    done[30] = due[30] + 0.3                 # a sixth slow batch moves the tail
    assert percentile(latencies(due, done, 5.0), 95) == pytest.approx(0.3)
    assert percentile(np.array([3.0]), 95) == 3.0


def _events():
    ev = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    return [
        ev("bench.slice", "user_annotation", 1000.0, 100.0),
        ev("bench.refit", "user_annotation", 1000.0, 60.0),
        ev("aten::sort", "cpu_op", 1005.0, 20.0),
        ev("cudaStreamSynchronize", "cuda_runtime", 1050.0, 10.0),
        ev("bench.ingest", "user_annotation", 1060.0, 40.0),
        ev("k_a", "kernel", 1010.0, 10.0),          # 1010-1020
        ev("k_a", "kernel", 1015.0, 10.0),          # overlaps: busy 1010-1025
        ev("stream_agg_kernel<int>", "kernel", 1030.0, 20.0),   # 1030-1050
        ev("Memcpy HtoD", "gpu_memcpy", 1090.0, 5.0),           # 1090-1095
        ev("k_out", "kernel", 1200.0, 5.0),         # outside the slice
    ]


def test_summary_idle_share_and_kernels():
    s = trace.summarize(_events())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)
    assert [k[0] for k in s.kernels] == ["k_a", "k_a", "stream_agg_kernel<int>"]
    assert s.kernel_time_s("stream_agg") == (pytest.approx(20e-6), 1)
    assert s.device_ops["k_a"] == pytest.approx(20e-6)
    # gaps 1000-1010 (in the sort), 1025-1030 (the refit, between ops),
    # 1050-1090 and 1095-1100 (labelled at their midpoints: the ingest)
    assert s.idle_gaps["bench.refit/aten::sort"] == pytest.approx(10e-6)
    assert s.idle_gaps["bench.refit/bench.refit"] == pytest.approx(5e-6)
    assert s.idle_gaps["bench.ingest/bench.ingest"] == pytest.approx(40e-6 + 5e-6)
    idle = harness.reader("device_idle_share.stream")({"trace": s})
    assert idle == pytest.approx(60.0)
    per_call = harness.reader("device_ms_per_batch.surface")({"trace": s, "calls": 2})
    assert per_call == pytest.approx((20 + 20 + 5) * 1e-3 / 2)
    assert harness.reader("launches_per_batch.surface")({"trace": s, "calls": 3}) == 1.0
    top = s.breakdown()
    assert top["device_ops"][0][0] in ("k_a", "stream_agg_kernel<int>")
    assert len(top["idle_gaps"]) <= 10


def test_readers_return_nothing_without_a_trace():
    for name in ("device_ms_per_batch.surface", "launches_per_batch.surface",
                 "b1_roofline", "device_idle_share.surface",
                 "ingest_ms.stream", "refit_device_ms.stream", "b2_roofline",
                 "device_idle_share.stream"):
        assert harness.reader(name)({}) is None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_roofline_copies_chip_smoke():
    smoke = _chip_smoke()
    assert (roofline.HBM_BYTES_S, roofline.F32_OPS_S, roofline.F64_OPS_S) == (
        smoke.HBM_BYTES_S, smoke.F32_OPS_S, smoke.F64_OPS_S)
    # B1 at the surface step's shape: PR 3-12's table gives 944 MB, 0.2817 ms
    nbytes = roofline.b1_bytes(48, 983040, 4)
    assert nbytes == 943_718_400
    assert roofline.bound_s(nbytes, roofline.b1_ops(48, 983040)) * 1e3 == pytest.approx(0.2817,
                                                                                      abs=1e-4)


def test_b2_bytes_against_chip_smoke():
    from iv_interpolation_tpu_torch.ops.cuda.stream_agg import aggregate_ohlcv_plain
    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(5)
    B, L, S = 4, 64, 16
    minutes = torch.randint(0, S, (B, L), generator=g, dtype=torch.int32)
    price = torch.rand((B, L), generator=g)
    size = torch.rand((B, L), generator=g)
    valid = torch.rand((B, L), generator=g) < 0.7
    ticks = (minutes, price, price, price, price, size, valid)
    got = aggregate_ohlcv_plain(*ticks, bucket_minutes=1, num_segments=S, min_count=1)
    assert roofline.b2_bytes(ticks, got) == smoke.b2_bytes(ticks, got)
    from benchmark.drivers.open_loop_stream import _Stub
    stubbed = tuple(_Stub(a) for a in ticks[:6]) + (valid,)
    assert roofline.b2_bytes(stubbed, got) == smoke.b2_bytes(ticks, got)
