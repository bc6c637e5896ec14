"""Port parity for the streaming slice as a whole: ring buffers, the
window sort, ``streaming_step`` and ``StreamingSession`` against the JAX
package, plus a check that the port never imports JAX.

Tolerances: candles' open/high/low/close/count/valid and every flag match
exactly. Realized vol is float32 arithmetic on identical closes; the two
packages' float32 log and sum orders differ by a few ulps, so it agrees
to 64 ulps relative. The refit scales the surface by
1 + 0.5 (realized/atm - 1) and w goes with its square, so w_grid and
iv_grid agree to 2 x that plus the float64 1e-12. Volume follows the
float32-sum bound of test_torch_stream_agg (against the reference's
cumulative-sum difference path it is eps32 x the window total).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from iv_interpolation_tpu.ops.spline_matrix import build_surface_operators_batched
from iv_interpolation_tpu.pipeline import ringbuffer as ref_ring
from iv_interpolation_tpu.pipeline import stream_service as ref_svc
from iv_interpolation_tpu.pipeline.streaming import streaming_step as ref_step
from iv_interpolation_tpu.surface.surface import common_support_grid
from iv_interpolation_tpu_torch.convert import (
    ring_state_from_numpy,
    spline_operator_from_numpy,
)
from iv_interpolation_tpu_torch.pipeline import ringbuffer as port_ring
from iv_interpolation_tpu_torch.pipeline import stream_service as port_svc
from iv_interpolation_tpu_torch.pipeline.streaming import streaming_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
RV_RTOL = 64 * EPS32
W_RTOL = 2 * RV_RTOL + 1e-12
CANDLE_EXACT = ("open", "high", "low", "close", "count", "valid")


def _chains(B, E, n, rng=None):
    k = np.broadcast_to(np.linspace(-0.8, 0.8, n), (B, E, n)).copy()
    T = np.broadcast_to(np.linspace(0.1, 1.0, E), (B, E)).copy()
    bump = 0.0 if rng is None else 0.01 * rng.normal(size=(B, 1, 1))
    iv = 0.4 + 0.05 * k * k + bump
    return k, iv, T


def _ticks(rng, B, L, n_minutes):
    minute = np.sort(rng.integers(0, n_minutes, (B, L)), axis=-1).astype(np.int32)
    per_min = 0.6 / np.sqrt(365.25 * 24 * 60)
    path = 100 * np.exp(np.cumsum(rng.normal(0, per_min, (B, n_minutes)), -1))
    price = np.take_along_axis(path, minute, -1).astype(np.float32)
    size = rng.uniform(0, 5, (B, L)).astype(np.float32)
    valid = rng.random((B, L)) > 0.1
    return minute, price, size, valid


def _assert_out(got, want, volume_atol):
    for f in CANDLE_EXACT:
        for stage in ("candles_1m", "candles_5m"):
            np.testing.assert_array_equal(
                getattr(getattr(got, stage), f).numpy(),
                np.asarray(getattr(getattr(want, stage), f)),
                err_msg=f"{stage}.{f}")
    for stage in ("candles_1m", "candles_5m"):
        np.testing.assert_allclose(getattr(got, stage).volume.numpy(),
                                   np.asarray(getattr(want, stage).volume),
                                   rtol=0, atol=volume_atol)
    for f in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.realized_vol.numpy(),
                               np.asarray(want.realized_vol), rtol=RV_RTOL,
                               atol=0)
    for f in ("w_grid", "iv_grid"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=W_RTOL, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("operators", [True, False])
def test_streaming_step_matches_jax_pallas_path(rng, operators):
    B, L, n_minutes, E, n, m = 4, 256, 64, 3, 10, 17
    ticks = _ticks(rng, B, L, n_minutes)
    k, iv, T = _chains(B, E, n, rng)
    kw = dict(n_minutes=n_minutes, n_grid=m)
    if operators:
        ops_ref = build_surface_operators_batched(
            jnp.asarray(k), common_support_grid(jnp.asarray(k), m),
            bc_type="not-a-knot")
        kw_ref = dict(kw, spline_ops=ops_ref)
        kw_port = dict(kw, spline_ops=spline_operator_from_numpy(
            jax.tree.map(np.asarray, ops_ref)))
    else:
        kw_ref = kw_port = dict(kw, spline_bc="not-a-knot")
    want = ref_step(*map(jnp.asarray, ticks + (k, iv, T)),
                    use_pallas_agg=True, **kw_ref)
    got = streaming_step(*map(torch.from_numpy, ticks + (k, iv, T)), **kw_port)
    assert got.w_grid.shape == (B, E, m)
    _assert_out(got, want, volume_atol=1e-4)
    assert np.asarray(want.candles_5m.valid).any()


def _ring_pair(B, C, L):
    return port_ring.make_ring(B, C, L), ref_ring.make_ring(B, C, L)


def _assert_ring(port_state, ref_state):
    for f, a, b in zip(port_ring.RingState._fields, port_state, ref_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for a, b in zip(port_ring.window(port_state), ref_ring.window(ref_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("B,C,L,K,pushes,p_valid", [
    (1, 1, 8, 3, 4, 1.0),      # wraps: 12 rows into 8 slots
    (2, 3, 8, 20, 1, 1.0),     # one push larger than the ring
    (3, 2, 16, 6, 7, 0.5),     # ragged pushes with holes mid-block
    (2, 1, 32, 8, 9, 0.15),    # one sparse stream, one dense
])
def test_ring_push_and_window_match_jax(rng, B, C, L, K, pushes, p_valid):
    port, ref = _ring_pair(B, C, L)
    for i in range(pushes):
        rows = rng.normal(size=(B, C, K)).astype(np.float32)
        valid = rng.random((B, K)) < p_valid
        valid[0] = True
        port_ring.push(port, torch.from_numpy(rows), torch.from_numpy(valid))
        ref = ref_ring.push(ref, jnp.asarray(rows), jnp.asarray(valid))
        _assert_ring(port, ref)
    # the reference's ring hands over through convert.py unchanged
    _assert_ring(ring_state_from_numpy(jax.tree.map(np.asarray, ref)), ref)


def test_push_updates_the_ring_in_place(rng):
    ring = port_ring.make_ring(2, 3, 8)
    ptrs = [t.data_ptr() for t in ring]
    out = port_ring.push(ring, torch.ones(2, 3, 5), torch.ones(2, 5, dtype=torch.bool))
    assert out is ring and [t.data_ptr() for t in ring] == ptrs
    np.testing.assert_array_equal(ring.count.numpy(), [5, 5])


def test_sort_window_matches_jax(rng):
    B, L = 3, 40
    minute = rng.integers(0, 10, (B, L)).astype(np.int32)
    price = rng.normal(size=(B, L)).astype(np.float32)
    size = rng.uniform(size=(B, L)).astype(np.float32)
    ok = rng.random((B, L)) > 0.3
    got = port_svc._sort_window_by_minute(
        *map(torch.from_numpy, (minute, price, size, ok)))
    want = ref_svc._sort_window_by_minute(
        *map(jnp.asarray, (minute, price, size, ok)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _tick_frames(rng, unds, n_chunks, per_und, n_minutes):
    frames = []
    for c in range(n_chunks):
        parts = []
        for u in unds:
            minutes = rng.integers(0, n_minutes, per_und)  # unsorted arrivals
            parts.append(pd.DataFrame({
                "underlying": u, "minute": minutes,
                "price": 100 + np.cumsum(rng.normal(0, 0.05, per_und)),
                "size": rng.uniform(0, 5, per_und)}))
        frames.append(pd.concat(parts, ignore_index=True))
    return frames


def test_session_ingest_and_refit_match_jax(rng):
    B, E, n, W = 8, 4, 12, 64
    unds = [f"u{i}" for i in range(B)]
    k, iv, T = _chains(B, E, n, rng)
    port = port_svc.StreamingSession(unds, k, iv, T, window_minutes=W,
                                     tick_capacity=256, n_grid=17)
    ref = ref_svc.StreamingSession(unds, k, iv, T, window_minutes=W,
                                   tick_capacity=256, n_grid=17)
    for f in port.spline_ops._fields:
        a, b = getattr(port.spline_ops, f).numpy(), np.asarray(getattr(ref.spline_ops, f))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * max(1.0, np.abs(b).max()))
    for frame in _tick_frames(rng, unds + ["unknown"], 3, 60, W):
        assert port.ingest_ticks(frame) == ref.ingest_ticks(frame)
        _assert_ring(port.ring, ref.ring)
        # the reference's cumulative-sum volume: eps32 x the window total
        _assert_out(port.refit(), ref.refit(), volume_atol=4e-7 * 5 * 180 + 1e-5)
    assert port.stats() == ref.stats()
    # both compute on one state: the reference's operators and ring,
    # handed over through convert.py
    port.spline_ops = spline_operator_from_numpy(jax.tree.map(np.asarray, ref.spline_ops))
    port.ring = ring_state_from_numpy(jax.tree.map(np.asarray, ref.ring))
    now = ref.latest_minute - 5
    _assert_out(port.refit(now), ref.refit(now), volume_atol=4e-7 * 5 * 180 + 1e-5)


def test_session_epoch_scale_minutes(rng):
    """Epoch minutes (~29.8M, past float32's 2^24 exact integers) bucket
    exactly like the same ticks with small minutes (rebased on ingest)."""
    B, E, n = 2, 3, 10
    k, iv, T = _chains(B, E, n)
    unds = [f"u{i}" for i in range(B)]
    minutes = np.sort(rng.integers(0, 64, 300))
    prices = 100 + np.cumsum(rng.normal(0, 0.01, 300))
    sizes = rng.uniform(0.1, 5, 300)
    und_col = np.array([unds[i % B] for i in range(300)])
    outs = {}
    for label, base in (("small", 0), ("epoch", 29_800_000)):
        sess = port_svc.StreamingSession(unds, k, iv, T, window_minutes=64,
                                         tick_capacity=512, n_grid=17)
        ticks = {"underlying": und_col, "minute": minutes + base,
                 "price": prices, "size": sizes}
        assert sess.ingest_ticks(ticks) == 300
        assert sess.latest_minute == int(minutes.max()) + base
        outs[label] = sess.refit()
    for f in ("w_grid", "realized_vol"):
        torch.testing.assert_close(getattr(outs["small"], f),
                                   getattr(outs["epoch"], f), rtol=0, atol=0)
    for a, b in zip(outs["small"].candles_1m, outs["epoch"].candles_1m):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_zero_tick_underlying_keeps_quoted_surface(rng):
    B, E, n = 2, 3, 10
    k, iv, T = _chains(B, E, n)
    sess = port_svc.StreamingSession(["live", "quiet"], k, iv, T,
                                     window_minutes=64, tick_capacity=512,
                                     n_grid=17)
    minutes = np.sort(rng.integers(0, 64, 200))
    sess.ingest_ticks({"underlying": np.array(["live"] * 200), "minute": minutes,
                       "price": 100 + np.cumsum(rng.normal(0, 0.01, 200)),
                       "size": np.ones(200)})
    out = sess.refit()
    assert float(out.realized_vol[1]) == 0.0
    from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface
    quoted = fit_eval_surface(*(torch.from_numpy(a[1:2]) for a in (k, iv, T)),
                              n_grid=17, spline_bc="not-a-knot")["w_grid"][0]
    torch.testing.assert_close(out.w_grid[1], quoted, rtol=1e-12, atol=1e-12)
    assert not torch.allclose(out.w_grid[0], quoted)


def test_replay_runs_on_cpu_without_jax(tmp_path):
    code = (
        "import sys\n"
        "from iv_interpolation_tpu.config import get_config\n"
        "from iv_interpolation_tpu_torch.pipeline.stream_service import run_stream_replay\n"
        "import iv_interpolation_tpu_torch._build as build\n"
        "r = run_stream_replay(get_config(), n_underlyings=6, window_minutes=40,\n"
        "                      chunks=4, ticks_per_chunk=60)\n"
        "assert r['device'] == 'cpu' and r['ticks_ingested'] == 6 * 4 * 60, r\n"
        "assert r['butterfly_ok'] == 6 and r['realized_vol_mean'] > 0, r\n"
        "assert build._lib is None, 'a CPU run must not build kernels'\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p),
        CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
