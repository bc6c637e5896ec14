"""Port parity: the OHLCV bucket aggregation (kernel B2's wrapper, CPU
plain version) against the JAX package's Pallas kernel in interpret mode
and a float64 numpy oracle.

Open, high, low, close, count and valid must match exactly (selections
and integers). Volume is a float32 sum whose order differs between the
two packages; any float32 sum of a bucket's values lies within
(count - 1) * eps32 * sum|v| of the exact sum, so two of them differ by at
most twice that (plus half an ulp of the result for the final rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops.pallas.stream_agg_pallas import aggregate_ohlcv_pallas
from iv_interpolation_tpu_torch.ops.cuda.stream_agg import (
    MAX_TILE,
    agg_plan,
    aggregate_ohlcv_cuda,
    aggregate_ohlcv_plain,
)
from iv_interpolation_tpu_torch.ops.segment_ohlcv import Candles

EXACT = ("open", "high", "low", "close", "count", "valid")
EPS32 = float(np.finfo(np.float32).eps)


def _ticks(rng, B, L, lo, hi, sort=True, p_valid=0.85):
    minute = rng.integers(lo, hi, (B, L)).astype(np.int32)
    if sort:
        minute = np.sort(minute, axis=-1)
    o = rng.normal(100, 1, (B, L)).astype(np.float32)
    h = o + rng.uniform(0, 1, (B, L)).astype(np.float32)
    l = o - rng.uniform(0, 1, (B, L)).astype(np.float32)
    c = o + rng.normal(0, 0.5, (B, L)).astype(np.float32)
    v = rng.uniform(0, 5, (B, L)).astype(np.float32)
    valid = rng.random((B, L)) < p_valid
    return [minute, o, h, l, c, v, valid]


def _oracle_volume(minute, v, valid, bm, base, ns):
    """float64 per-bucket sum and sum|v| (numpy floor division)."""
    seg = minute.astype(np.int64) // bm - base
    ok = valid & (seg >= 0) & (seg < ns)
    B = minute.shape[0]
    vol = np.zeros((B, ns))
    mag = np.zeros((B, ns))
    for b in range(B):
        np.add.at(vol[b], seg[b][ok[b]], v[b][ok[b]].astype(np.float64))
        np.add.at(mag[b], seg[b][ok[b]], np.abs(v[b][ok[b]]).astype(np.float64))
    return vol, mag


def _assert_candles(got: Candles, want, ticks, bm, base, ns):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    vol64, mag = _oracle_volume(ticks[0], ticks[5], ticks[6], bm, base, ns)
    count = got.count.numpy()
    bound = 2 * np.maximum(count - 1, 0) * EPS32 * mag + EPS32 * np.abs(vol64)
    for vol in (got.volume.numpy(), np.asarray(want.volume)):
        assert (np.abs(vol - vol64) <= bound / 2 + EPS32 * np.abs(vol64)).all()
    assert (np.abs(got.volume.numpy() - np.asarray(want.volume)) <= bound).all()


def _both(ticks, **kw):
    got = aggregate_ohlcv_cuda(*map(torch.from_numpy, ticks), **kw)
    want = aggregate_ohlcv_pallas(*map(jnp.asarray, ticks), interpret=True, **kw)
    return got, want


@pytest.mark.parametrize("bm,base,ns,lo,hi,sort", [
    (1, 0, 64, 0, 64, True),        # ticks -> 1-min
    (5, 0, 40, 0, 200, True),       # 1-min -> 5-min shape
    (5, 0, 40, 0, 200, False),      # unsorted rows
    (5, 3, 30, 0, 200, True),       # base_bucket != 0 drops early ids
    (5, 0, 25, -12, 140, True),     # negative minutes and ids past ns
    (3, -4, 50, -12, 140, False),   # negative base, floor division, unsorted
])
def test_matches_pallas_interpret(rng, bm, base, ns, lo, hi, sort):
    ticks = _ticks(rng, 3, 300, lo, hi, sort=sort)
    kw = dict(bucket_minutes=bm, base_bucket=base, num_segments=ns, min_count=3)
    got, want = _both(ticks, **kw)
    _assert_candles(got, want, ticks, bm, base, ns)


def test_negative_minutes_use_floor_division(rng):
    """minute -1 with bucket_minutes 5 is bucket -1, dropped at base 0: a
    truncating division would count it in bucket 0."""
    minute = np.array([[-4, -1, 0, 3, 4, 5]], np.int32)
    p = np.arange(1, 7, dtype=np.float32)[None]
    ticks = [minute, p, p, p, p, p, np.ones_like(minute, bool)]
    kw = dict(bucket_minutes=5, num_segments=2, min_count=1)
    got, want = _both(ticks, **kw)
    np.testing.assert_array_equal(got.count.numpy(), [[3, 1]])
    np.testing.assert_array_equal(got.open.numpy(), [[3.0, 6.0]])
    _assert_candles(got, want, ticks, 5, 0, 2)


def test_nan_and_inf_in_invalid_rows_never_reach_a_sum(rng):
    ticks = _ticks(rng, 2, 256, 0, 48, sort=False, p_valid=0.6)
    bad = [a.copy() for a in ticks]
    invalid = ~ticks[6]
    for j in range(1, 6):
        bad[j][invalid] = np.nan
    bad[5][0, np.flatnonzero(invalid[0])[:1]] = np.inf
    kw = dict(bucket_minutes=1, num_segments=48, min_count=1)
    clean = aggregate_ohlcv_cuda(*map(torch.from_numpy, ticks), **kw)
    got, want = _both(bad, **kw)
    _assert_candles(got, want, ticks, 1, 0, 48)
    nonempty = clean.count.numpy() > 0
    for f in ("open", "high", "low", "close", "volume"):
        a, b = getattr(got, f).numpy(), getattr(clean, f).numpy()
        np.testing.assert_array_equal(a[nonempty], b[nonempty], err_msg=f)
        assert np.isnan(a[~nonempty]).all() or f == "volume"
    assert (got.volume.numpy()[~nonempty] == 0).all()


def test_shuffled_rows_keep_high_low_volume_count(rng):
    ticks = _ticks(rng, 2, 400, 0, 160)
    perm = rng.permutation(400)
    shuffled = [a[:, perm] for a in ticks]
    kw = dict(bucket_minutes=5, num_segments=32, min_count=1)
    a = aggregate_ohlcv_cuda(*map(torch.from_numpy, ticks), **kw)
    b = aggregate_ohlcv_cuda(*map(torch.from_numpy, shuffled), **kw)
    for f in ("high", "low", "count", "valid"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())
    np.testing.assert_allclose(a.volume.numpy(), b.volume.numpy(), rtol=1e-5)


def test_streaming_stage_two_reads_nan_one_minute_candles(rng):
    """Stage 2 aggregates 1-min candles whose empty buckets are NaN."""
    ticks = _ticks(rng, 2, 200, 0, 60, p_valid=0.5)
    c1 = aggregate_ohlcv_cuda(*map(torch.from_numpy, ticks), bucket_minutes=1,
                              num_segments=60, min_count=1)
    assert torch.isnan(c1.open).any()
    minutes = torch.arange(60, dtype=torch.int32).expand(2, 60)
    stage2 = [minutes, c1.open, c1.high, c1.low, c1.close, c1.volume, c1.valid]
    kw = dict(bucket_minutes=5, num_segments=13, min_count=5)
    got = aggregate_ohlcv_cuda(*stage2, **kw)
    want = aggregate_ohlcv_pallas(*(jnp.asarray(a.numpy()) for a in stage2),
                                  interpret=True, **kw)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert np.isfinite(got.close.numpy()[got.count.numpy() > 0]).all()


def test_wrapper_checks_and_no_launch_on_cpu(rng):
    ticks = [torch.from_numpy(a) for a in _ticks(rng, 2, 16, 0, 8)]
    kw = dict(bucket_minutes=1, num_segments=8, min_count=1)
    before = aggregate_ohlcv_cuda.launches
    got = aggregate_ohlcv_cuda(*ticks, **kw)
    plain = aggregate_ohlcv_plain(*ticks, **kw)
    assert aggregate_ohlcv_cuda.launches == before
    for f in Candles._fields:
        torch.testing.assert_close(getattr(got, f), getattr(plain, f),
                                   equal_nan=True, rtol=0, atol=0)
    assert got.count.dtype == torch.int32 and got.valid.dtype == torch.bool
    with pytest.raises(ValueError, match="empty tick window"):
        aggregate_ohlcv_cuda(*(a[:, :0] for a in ticks), **kw)
    with pytest.raises(ValueError):
        aggregate_ohlcv_cuda(ticks[0][:, :4], *ticks[1:], **kw)
    with pytest.raises(ValueError):
        aggregate_ohlcv_cuda(*ticks, bucket_minutes=0, num_segments=8,
                             min_count=1)
    with pytest.raises(ValueError):
        aggregate_ohlcv_cuda(*(a.to("meta") for a in ticks), **kw)


@pytest.mark.parametrize("L,ns,tiles,threads", [
    (4096, 512, 1, 512),        # streaming 1-min stage
    (512, 103, 1, 128),         # streaming 5-min stage
    (16384, 3278, 1, 512),      # candle stage
    (7, 1, 1, 64),
    (300, MAX_TILE, 1, 128),    # the largest single pass
    (300, MAX_TILE + 1, 2, 128),
    (4096, 20000, 3, 512),
])
def test_launch_plan_single_pass_then_tiles(L, ns, tiles, threads):
    plan = agg_plan(L, ns)
    assert (plan.tiles, plan.threads) == (tiles, threads)
    assert plan.tile == min(ns, MAX_TILE) and plan.tiles * plan.tile >= ns
    assert plan.smem == 24 * plan.tile <= 227 * 1024
    with pytest.raises(ValueError):
        agg_plan(L, 0)


@pytest.mark.parametrize("shift", [3_000_000_000, -3_000_000_000, 5 * (2**31 - 1)])
def test_int64_minutes_beyond_int32_match_jax_on_the_same_ids(rng, shift):
    """int64 minutes outside int32 are accepted wherever their ids land in
    range: shifted by a multiple of bucket_minutes with base_bucket moved
    by the same number of buckets, they give the JAX kernel's candles of
    the unshifted int32 minutes."""
    bm, ns = 5, 40
    ticks = _ticks(rng, 3, 300, -12, 210, sort=False)
    big = [ticks[0].astype(np.int64) + shift] + ticks[1:]
    assert np.abs(big[0]).min() > 2**31
    kw = dict(bucket_minutes=bm, num_segments=ns, min_count=2)
    want = aggregate_ohlcv_pallas(*map(jnp.asarray, ticks), interpret=True, **kw)
    got = aggregate_ohlcv_plain(*map(torch.from_numpy, big),
                                base_bucket=shift // bm, **kw)
    assert got.count.dtype == torch.int32
    _assert_candles(got, want, ticks, bm, 0, ns)


def test_int64_minutes_whose_ids_land_out_of_range_drop(rng):
    ticks = _ticks(rng, 2, 64, 0, 40)
    far = [ticks[0].astype(np.int64) + 2**40] + ticks[1:]
    got = aggregate_ohlcv_plain(*map(torch.from_numpy, far), bucket_minutes=1,
                                num_segments=40, min_count=1)
    assert int(got.count.sum()) == 0 and not got.valid.any()
    assert torch.isnan(got.open).all() and (got.volume == 0).all()
