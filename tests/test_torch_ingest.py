"""Port parity: the port's host ingest (``pipeline/ingest.py``), sample
data (``pipeline/sample_data.py``) and ``utils`` against the JAX
package's.

Exact throughout: every ``PackedBatch`` field (NaN where NaN), the skip
reasons, the unpacked frames and the sample frames. The JAX packer runs
with ``max_slots=0``, the packing the port implements.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

from iv_interpolation_tpu import utils as ref_utils
from iv_interpolation_tpu.pipeline import ingest as ref
from iv_interpolation_tpu.pipeline import sample_data as ref_sample
from iv_interpolation_tpu_torch import utils as port_utils
from iv_interpolation_tpu_torch.pipeline import ingest as port
from iv_interpolation_tpu_torch.pipeline import sample_data as port_sample

FIELDS = [f.name for f in dataclasses.fields(port.PackedBatch)]


def _frame():
    """Sample tickers plus the cases the packer must agree on: two rows
    in one minute (the later wins), a row duplicated exactly, rows off a
    5-minute grid, a symbol with too few points, one whose span is too
    large, and a long symbol that lands in a second bucket."""
    df = ref_sample.generate_sample_tickers(num_symbols=6, hours=12, seed=21, drop_frac=0.2)
    first = df["symbol"].iloc[0]
    sub = df[df["symbol"] == first]
    extra = [
        sub.iloc[[2]].assign(date=sub["date"].iloc[2] + pd.Timedelta(seconds=20), iv=0.9),
        sub.iloc[[4]].assign(iv=0.7),
        sub.iloc[[1, 3]].assign(date=sub["date"].iloc[[1, 3]] + pd.Timedelta(minutes=2)),
        sub.head(3).assign(symbol="btc-few-1000-c"),
        pd.DataFrame({"symbol": "btc-wide-1000-c", "iv": 0.5, "underlying_price": 100.0,
                      "time_to_maturity": 0.1,
                      "date": pd.date_range("2023-01-01", periods=12, freq="4D")}),
        ref_sample.generate_sample_tickers(num_symbols=1, hours=60, seed=22).assign(
            symbol="btc-long-25000-p"),
    ]
    return pd.concat([df, *extra], ignore_index=True)


def _assert_batches_equal(got, want):
    assert len(got.batches) == len(want.batches)
    assert got.skipped == want.skipped
    for g, w in zip(got.batches, want.batches):
        for name in FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b or (a is None and b is None), name
        assert g.batch == w.batch and g.batch_padded == w.batch_padded


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("freq", [1, 5])
def test_pack_symbols_matches_jax(compact, dtype, freq):
    df = _frame()
    kw = dict(min_points=5, max_span_days=30, max_timeline_points=100_000,
              freq_minutes=freq, max_batch=4, dtype=dtype, compact=compact)
    buckets = (256, 1024, 4096)
    got = port.pack_symbols(df, buckets, **kw)
    want = ref.pack_symbols(df, buckets, max_slots=0, **kw)
    assert {b.bucket_len for b in got.batches} == ({1024, 4096} if freq == 1 else {256, 1024})
    assert "btc-few-1000-c" in got.skipped and "btc-wide-1000-c" in got.skipped
    _assert_batches_equal(got, want)
    if compact:
        for g, w in zip(got.batches, want.batches):
            g.densify(), w.densify()
            for name in ("values", "obs_mask", "timeline_mask"):
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name))


def test_pack_symbols_guardrails_match_jax():
    df = _frame()
    kw = dict(min_points=5, max_span_days=3, max_timeline_points=900, max_batch=16)
    got = port.pack_symbols(df, (512,), **kw)
    want = ref.pack_symbols(df, (512,), max_slots=0, **kw)
    assert any("timeline too long" in r for r in got.skipped.values())
    assert any("exceeds largest bucket" in r for r in got.skipped.values())
    assert any("time range too large" in r for r in got.skipped.values())
    _assert_batches_equal(got, want)
    assert port.pack_symbols(df.iloc[:0], (512,)).batches == []


def test_unpack_interpolated_matches_jax(rng):
    df = ref_sample.generate_sample_tickers(num_symbols=5, hours=6, seed=23)
    packed = port.pack_symbols(df, (512,), min_points=2, max_batch=16)
    batch = packed.batches[0]
    want_batch = ref.pack_symbols(df, (512,), min_points=2, max_batch=16,
                                  max_slots=0).batches[0]
    B, C, L = batch.values.shape
    for dtype in (np.float32, np.float64):
        filled = rng.normal(size=(B, C, L)).astype(dtype)
        valid = rng.uniform(size=(B, L)) < 0.7
        valid[len(batch.symbols):] = False
        is_interp = valid & (rng.uniform(size=(B, L)) < 0.5)
        greeks = {g: rng.normal(size=(B, L)).astype(dtype)
                  for g in ("delta", "gamma", "theta", "vega", "rho")}
        got = port.unpack_interpolated(batch, filled, valid, is_interp, 17, greeks=greeks,
                                       freq_minutes=2)
        want = ref.unpack_interpolated(want_batch, filled, valid, is_interp, 17,
                                       greeks=greeks, freq_minutes=2)
        pd.testing.assert_frame_equal(got, want)
    empty = port.unpack_interpolated(batch, filled, np.zeros((B, L), bool), is_interp, 1)
    assert empty.empty


@pytest.mark.parametrize("n,hours,seed,drop", [(5, 24, 0, 0.0), (3, 12, 7, 0.3),
                                               (200, 4, 1, 0.1)])
def test_sample_tickers_match_jax(n, hours, seed, drop):
    got = port_sample.generate_sample_tickers(num_symbols=n, hours=hours, seed=seed,
                                              drop_frac=drop)
    pd.testing.assert_frame_equal(got, ref_sample.generate_sample_tickers(
        num_symbols=n, hours=hours, seed=seed, drop_frac=drop))


@pytest.mark.parametrize("n,hours,seed", [(5, 24, 0), (2, 3, 9)])
def test_sample_candles_match_jax(n, hours, seed):
    pd.testing.assert_frame_equal(
        port_sample.generate_sample_candles(num_symbols=n, hours=hours, seed=seed),
        ref_sample.generate_sample_candles(num_symbols=n, hours=hours, seed=seed))
    syms = ["a-x-1-c", "b-y-2-p"]
    pd.testing.assert_frame_equal(
        port_sample.generate_sample_candles(symbols=syms, hours=1, seed=seed),
        ref_sample.generate_sample_candles(symbols=syms, hours=1, seed=seed))


def test_helpers_match_jax():
    ts = pd.Series(pd.to_datetime(["2023-03-20 09:00:59", "1970-01-01 00:01:00",
                                   "2024-02-29 23:59:00"]).as_unit("s"))
    np.testing.assert_array_equal(port_utils.to_epoch_minutes(ts),
                                  ref_utils.to_epoch_minutes(ts))
    for n in (1, 16, 17, 100, 257, 5000):
        assert port_utils.batch_pad(n, 256) == ref_utils.batch_pad(n, 256)
        assert port_utils.choose_bucket(n, (64, 256, 4096)) == \
            ref_utils.choose_bucket(n, (64, 256, 4096))
        assert port.obs_pad(n) == ref.obs_pad(n)
    for bucket, cap, slots in ((16384, 256, 0), (16384, 256, 1 << 20), (64, 512, 4096)):
        assert port.bucket_batch_cap(bucket, cap, slots) == ref.bucket_batch_cap(bucket, cap, slots)
    for dtype in (np.float32, np.float64):
        a, b = port.full_nan((3, 5), dtype), ref.full_nan((3, 5), dtype)
        assert a.dtype == b.dtype and np.isnan(a).all()
    assert port.ALL_COLS == ref.ALL_COLS and port.INTERP_COLS == ref.INTERP_COLS
