"""Port parity: candle aggregation (``ops/segment_ohlcv.py``) against the
JAX package's ``aggregate_ohlcv`` in both of its modes, the pandas groupby
the reference ran, and the validation and statistics helpers.

Tolerances: open/high/low/close/count/valid are selections and integers
and must be equal. Volume is a sum taken in another order: in float64 it
agrees to 1e-12 of the row's total |volume| (the JAX sorted mode takes
differences of running sums, whose error scales with the running total,
not with the bucket). float32 inputs stay float32 and are held to the
same rule at 4 eps32.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from iv_interpolation_tpu.ops import segment_ohlcv as ref
from iv_interpolation_tpu_torch.ops import segment_ohlcv as port
from iv_interpolation_tpu_torch.ops.cuda.stream_agg import aggregate_ohlcv_cuda

EXACT = ("open", "high", "low", "close", "count", "valid")


def _bars(rng, B, L, start, keep_frac=0.8, dtype=np.float64):
    minutes = start + np.sort(rng.integers(0, 2 * L, (B, L)), axis=-1)
    close = 100 + np.cumsum(rng.normal(size=(B, L)), axis=-1)
    open_ = close + rng.normal(size=(B, L)) * 0.1
    high = np.maximum(open_, close) + rng.uniform(0, 0.5, (B, L))
    low = np.minimum(open_, close) - rng.uniform(0, 0.5, (B, L))
    volume = rng.uniform(0, 100, (B, L))
    valid = rng.uniform(size=(B, L)) < keep_frac
    cols = [a.astype(dtype) for a in (open_, high, low, close, volume)]
    return [minutes] + cols + [valid]


def _assert_candles(got, want, volume_in):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    vol = got.volume.numpy()
    assert vol.dtype == volume_in.dtype
    eps = 1e-12 if vol.dtype == np.float64 else 4 * float(np.finfo(np.float32).eps)
    total = np.abs(volume_in).sum(axis=-1, keepdims=True)
    assert (np.abs(vol - np.asarray(want.volume)) <= eps * total).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("assume_sorted", [False, True])
@pytest.mark.parametrize("freq,min_count,start", [(5, 5, 7), (5, 1, 0), (15, 15, 3),
                                                  (5, 3, -23)])
def test_single_series_matches_jax(rng, dtype, assume_sorted, freq, min_count, start):
    bars = [a[0] for a in _bars(rng, 1, 400, start, dtype=dtype)]
    base = int(bars[0][0]) // freq
    ns = int(bars[0][-1]) // freq - base + 1
    kw = dict(num_segments=ns, min_count=min_count, assume_sorted=assume_sorted)
    want = ref.aggregate_ohlcv(*map(jnp.asarray, bars), jnp.int32(freq),
                               jnp.int32(base), **kw)
    got = port.aggregate_ohlcv(*map(torch.from_numpy, bars), freq, base, **kw)
    assert got.open.shape == (ns,) and got.open.dtype == torch.from_numpy(bars[1]).dtype
    _assert_candles(got, want, np.where(bars[6], bars[5], 0))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batched_per_row_base_matches_jax(rng, dtype):
    """(B, L) rows with a base bucket each, as the pipeline's candle stage."""
    bars = _bars(rng, 4, 300, 29_000_003, dtype=dtype)
    freq = 5
    base = bars[0][:, 0] // freq
    ns = 130
    want = [ref.aggregate_ohlcv(*(jnp.asarray(a[b]) for a in bars), jnp.int32(freq),
                                jnp.int32(base[b]), num_segments=ns, min_count=5,
                                assume_sorted=True) for b in range(4)]
    got = port.aggregate_ohlcv(*map(torch.from_numpy, bars), freq,
                               torch.from_numpy(base), num_segments=ns, min_count=5)
    for b in range(4):
        row = port.Candles(*(a[b] for a in got))
        _assert_candles(row, want[b], np.where(bars[6][b], bars[5][b], 0))


def test_matches_pandas_groupby(rng):
    minutes, o, h, l, c, v, _ = [a[0] for a in _bars(rng, 1, 600, 7, keep_frac=1.0)]
    minutes = np.unique(minutes)
    o, h, l, c, v = (a[:len(minutes)] for a in (o, h, l, c, v))
    h, l = np.maximum.reduce([o, c, h]), np.minimum.reduce([o, c, l])
    df = pd.DataFrame({"t": minutes // 5, "open": o, "high": h, "low": l,
                       "close": c, "volume": v})
    agg = df.groupby("t").agg(open=("open", "first"), high=("high", "max"),
                              low=("low", "min"), close=("close", "last"),
                              volume=("volume", "sum"), n=("open", "size"))
    agg = agg[agg["n"] >= 5]
    base = int(minutes[0]) // 5
    got = port.aggregate_ohlcv(*map(torch.from_numpy, (minutes, o, h, l, c, v)),
                               torch.ones(len(minutes), dtype=torch.bool), 5, base,
                               num_segments=int(minutes[-1]) // 5 - base + 1,
                               min_count=5)
    sel = np.flatnonzero(got.valid.numpy())
    np.testing.assert_array_equal(base + sel, agg.index.to_numpy())
    for col in ("open", "high", "low", "close", "volume"):
        np.testing.assert_allclose(getattr(got, col).numpy()[sel], agg[col].to_numpy(),
                                   rtol=0, atol=1e-12, err_msg=col)


def test_float64_cpu_aggregation_through_the_kernel_wrapper_keeps_float64(rng):
    """Kernel B2's wrapper on CPU tensors runs its plain version in the
    inputs' dtype: float64 candles for a float64 pipeline."""
    bars = _bars(rng, 3, 256, 1000)
    freq, base, ns = 5, 200, 110
    got = aggregate_ohlcv_cuda(*map(torch.from_numpy, bars), bucket_minutes=freq,
                               base_bucket=base, num_segments=ns, min_count=2)
    assert all(getattr(got, f).dtype == torch.float64
               for f in ("open", "high", "low", "close", "volume"))
    for b in range(3):
        want = ref.aggregate_ohlcv(*(jnp.asarray(a[b]) for a in bars), jnp.int32(freq),
                                   jnp.int32(base), num_segments=ns, min_count=2)
        _assert_candles(port.Candles(*(a[b] for a in got)), want,
                        np.where(bars[6][b], bars[5][b], 0))


def test_float_minutes_raise():
    x = torch.ones(4, dtype=torch.float64)
    with pytest.raises(TypeError, match="minutes must be integers"):
        port.aggregate_ohlcv(x, x, x, x, x, x, x > 0, 5, 0, num_segments=2,
                             min_count=1)


def test_validate_ohlcv_matches_jax():
    o = np.array([1.0, 1.0, 1.0, np.nan, 1.0, 1.0])
    h = np.array([2.0, 0.5, 2.0, 2.0, 2.0, 2.0])
    l = np.array([0.5, 0.4, 0.5, 0.5, 1.5, 0.5])
    c = np.array([1.5, 1.5, 1.5, 1.5, 1.6, 1.5])
    v = np.array([1.0, 1.0, -1.0, 1.0, 1.0, 1.0])
    valid = np.array([True, True, True, True, True, False])
    want_all, want = ref.validate_ohlcv(*map(jnp.asarray, (o, h, l, c, v, valid)))
    got_all, got = port.validate_ohlcv(*map(torch.from_numpy, (o, h, l, c, v, valid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got_all) == bool(want_all) is False
    np.testing.assert_array_equal(got.numpy(), [True, False, False, False, False, True])


def test_reconstruction_stats_match_jax(rng):
    bars = [a[0] for a in _bars(rng, 1, 300, 0)]
    kw = dict(num_segments=130, min_count=3)
    want_c = ref.aggregate_ohlcv(*map(jnp.asarray, bars), jnp.int32(5), jnp.int32(0), **kw)
    got_c = port.aggregate_ohlcv(*map(torch.from_numpy, bars), 5, 0, **kw)
    n_in, vol_in = int(bars[6].sum()), float(bars[5][bars[6]].sum())
    want = ref.reconstruction_stats(n_in, want_c, vol_in)
    got = port.reconstruction_stats(n_in, got_c, vol_in)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-12, err_msg=k)
    assert float(got["volume_preservation"]) < 1.0
