"""Port parity: the stage functions (``pipeline/tasks.py``) and the fused
batch (``pipeline/runner.fused_batch``) against the JAX package's
``pipeline/tasks.py`` chained as its fused runner chains them, on the
same ``PackedBatch`` from ``generate_sample_tickers`` -> ``pack_symbols``.

Tolerances:
* masks, counts, price columns and PRNG keys: exact;
* float64 pipeline: values to 1e-12 of max(1, |x|) (1e-12 of each
  greek's largest |value|: the closed forms use each library's own
  exp/log/ndtr); 5-minute volume to 1e-12 of the row's total 1-minute
  volume (the JAX candle stage sums by differences of running sums);
* float32 pipeline: interpolated values within 2 ulps, greeks within
  64 eps32 of their largest |value|, 1-minute OHLC within 8 ulps plus
  one 1e-4 rounding step, with the bridge's minimum-spread flips counted
  as in the bridge tests; 5-minute volume within 4 eps32 of the row's
  total 1-minute volume;
* in both: every valid 5-minute candle is the first/max/min/last of the
  port's own valid 1-minute candles in its bucket (exact), and counts
  and valid flags equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from iv_interpolation_tpu.config import get_config
from iv_interpolation_tpu.ops.bridge import BridgeParams, validate_bridge_quality
from iv_interpolation_tpu.ops.segment_ohlcv import validate_ohlcv
from iv_interpolation_tpu.pipeline import ingest
from iv_interpolation_tpu.pipeline import runner as ref_runner
from iv_interpolation_tpu.pipeline import tasks as ref
from iv_interpolation_tpu.pipeline.sample_data import generate_sample_tickers
from iv_interpolation_tpu_torch.pipeline import runner as port_runner
from iv_interpolation_tpu_torch.pipeline import tasks as port

EPS32 = float(np.finfo(np.float32).eps)
PRICES = ("open", "high", "low", "close")


def _config(dtype="float64", method="linear", **bridge):
    cfg = get_config()
    cfg.processing.dtype = dtype
    cfg.interpolation.method = method
    cfg.interpolation.min_data_points = 5
    for k, v in bridge.items():
        setattr(cfg.data_bridge, k, v)
    return cfg


def _pack(df, cfg, compact=True):
    np_dtype = np.float64 if cfg.processing.dtype == "float64" else np.float32
    packed = ingest.pack_symbols(df, cfg.processing.bucket_sizes,
                                 min_points=cfg.interpolation.min_data_points,
                                 max_batch=16, dtype=np_dtype, compact=compact)
    assert len(packed.batches) == 1, [b.bucket_len for b in packed.batches]
    return packed.batches[0]


def _jax_fused(batch, cfg):
    """The JAX package's fused dispatch + readback for one batch
    (``PipelineRunner.run_pipeline_fused``: dispatch, then finish up to
    numpy), without storage."""
    icfg, bcfg, ccfg = cfg.interpolation, cfg.data_bridge, cfg.candle_reconstruction
    B, L = batch.batch_padded, batch.bucket_len
    freq = ref_runner.parse_frequency(icfg.frequency)
    tgt = ref_runner.parse_frequency(ccfg.target_frequency)
    if batch.values is not None:
        values, obs_mask, tmask = map(jnp.asarray, (batch.values, batch.obs_mask,
                                                    batch.timeline_mask))
    else:
        values, obs_mask, tmask = ref.scatter_batch(
            *map(jnp.asarray, (batch.obs_vals, batch.obs_row, batch.obs_pos,
                               batch.valid_len)), B=B, C=len(batch.columns), L=L)
    np_dtype = np.float64 if cfg.processing.dtype == "float64" else np.float32
    strike = jnp.asarray(pd.to_numeric(pd.Series(batch.const_cols["strike"]),
                                       errors="coerce").to_numpy(np_dtype))
    callput = jnp.asarray([str(c).lower() in ("c", "call")
                           for c in batch.const_cols["callput"]])
    method, obs_pos = icfg.method, None
    if method == "cubic":
        obs_pos, clean = ref_runner._obs_positions(batch)
        if not clean:
            method, obs_pos = "linear", None
    out = ref.interpolate_batch(
        values, obs_mask, tmask, strike, callput, method=method,
        max_gap_minutes=icfg.max_gap_hours * 60 if icfg.max_gap_hours else 0,
        compute_greeks=icfg.compute_greeks, extrapolate=icfg.extrapolate,
        obs_pos=obs_pos)
    price_col = ref.select_price_columns(values, obs_mask)
    hashes = [ref_runner.symbol_fold(s) for s in batch.symbols]
    hashes += [0] * (B - len(hashes))
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.key(bcfg.seed),
                                                   jnp.asarray(hashes))
    minutes = jnp.asarray(batch.t0_minutes)[:, None] + jnp.arange(L)[None, :] * freq
    base_bucket = jnp.asarray(batch.t0_minutes) // tgt
    ohlcv = ref.bridge_batch(
        out["filled"], out["valid"], keys,
        params=BridgeParams(bcfg.base_spread_percent, bcfg.volatility_factor,
                            bcfg.min_spread_percent, bcfg.trend_strength,
                            bcfg.base_volume),
        price_col=price_col, strategy=bcfg.conversion_strategy,
        abs_minutes=minutes)
    base = jnp.take_along_axis(out["filled"], price_col[:, None, None].astype(jnp.int32),
                               axis=1)[:, 0]
    _, quality_ok = validate_bridge_quality(
        ohlcv["open"], ohlcv["high"], ohlcv["low"], ohlcv["close"], base,
        ohlcv["valid"], max_spread_frac=bcfg.max_spread_percent)
    agg = ref.candles_batch(minutes, ohlcv, jnp.int32(tgt), base_bucket,
                            num_segments=(L * freq + tgt - 1) // tgt + 1,
                            min_count=ccfg.min_candles_required)
    res = jax.tree.map(np.asarray, {
        **out, "price_col": price_col, "keys": jax.random.key_data(keys),
        "minutes": minutes, "base_bucket": base_bucket, "ohlcv": ohlcv,
        "quality_ok": quality_ok, "candles": agg._asdict()})
    failed = ref_runner.PipelineRunner._quality_failures(
        batch.symbols, res["quality_ok"], port_runner.QUALITY_REASON)
    for d in (res["ohlcv"], res["candles"]):
        d["valid"] = ref_runner.PipelineRunner._mask_failed_rows(
            batch.symbols, failed, d["valid"])
    res["failed"] = failed
    return res


def _assert_values(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= tol * np.maximum(1.0, np.abs(want[fin]))).all()


def _assert_fused(got, want, cfg):
    for k in ("keys", "price_col", "valid", "is_interpolated", "minutes", "base_bucket",
              "quality_ok"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["failed"] == want["failed"]
    f64 = cfg.processing.dtype == "float64"
    _assert_values(got["filled"], want["filled"], 1e-12 if f64 else 2 * EPS32)
    for name, g in want["greeks"].items():
        tol = (1e-12 if f64 else 64 * EPS32) * np.nanmax(np.abs(g))
        np.testing.assert_array_equal(np.isnan(got["greeks"][name]), np.isnan(g))
        np.testing.assert_allclose(got["greeks"][name], g, rtol=0, atol=tol, err_msg=name)
    o_got, o_want = got["ohlcv"], want["ohlcv"]
    c_got, c_want = got["candles"], want["candles"]
    for k in ("count", "valid"):
        np.testing.assert_array_equal(c_got[k], c_want[k], err_msg=k)
    np.testing.assert_array_equal(o_got["valid"], o_want["valid"])
    vol_total = np.nansum(np.abs(o_want["volume"]), axis=-1, keepdims=True)
    _assert_candles_from_minutes(got, ref_runner.parse_frequency(
        cfg.candle_reconstruction.target_frequency))
    if f64:
        for f in PRICES + ("volume",):
            _assert_values(o_got[f], o_want[f], 1e-12)
        for f in PRICES:
            _assert_values(c_got[f], c_want[f], 1e-12)
        assert (np.abs(c_got["volume"] - c_want["volume"]) <= 1e-12 * vol_total).all()
        return
    ok = o_want["valid"]
    off = np.zeros(ok.shape, bool)
    for f in PRICES + ("volume",):
        a, b = o_got[f].astype(np.float64), o_want[f].astype(np.float64)
        off |= ok & ~(np.abs(a - b) <= 8 * EPS32 * np.abs(b) + 1e-4)
    assert off.sum() <= 0.01 * max(ok.sum(), 1)
    # a row past the bound is a minimum-spread flip in one package
    base = np.take_along_axis(got["filled"], got["price_col"][:, None, None],
                              axis=1)[:, 0].astype(np.float64)
    band = base * cfg.data_bridge.min_spread_percent
    narrow = lambda o: np.abs((o["high"] - o["low"]) - band) <= 2e-4 + 16 * EPS32 * base
    assert (narrow(o_got) | narrow(o_want))[off].all()
    assert (np.abs(c_got["volume"] - c_want["volume"]) <= 4 * EPS32 * vol_total).all()


def _assert_candles_from_minutes(res, tgt):
    """Each valid target candle is the first/max/min/last of the port's
    own valid 1-minute candles in its bucket (selections: exact)."""
    o, c = res["ohlcv"], res["candles"]
    seg = res["minutes"] // tgt - res["base_bucket"][:, None]
    for b, j in zip(*np.nonzero(c["valid"])):
        rows = np.flatnonzero((seg[b] == j) & o["valid"][b])
        assert len(rows) == c["count"][b, j]
        assert c["open"][b, j] == o["open"][b, rows[0]]
        assert c["close"][b, j] == o["close"][b, rows[-1]]
        assert c["high"][b, j] == o["high"][b, rows].max()
        assert c["low"][b, j] == o["low"][b, rows].min()


@pytest.fixture(scope="module")
def tickers():
    return generate_sample_tickers(num_symbols=6, hours=12, seed=3, drop_frac=0.1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("compact", [True, False])
def test_fused_batch_matches_jax(tickers, dtype, compact):
    cfg = _config(dtype)
    batch = _pack(tickers, cfg, compact=compact)
    want = _jax_fused(batch, cfg)
    got = port_runner.fused_batch(batch, cfg, "cpu")
    assert got["method"] == "linear" and not got["failed"]
    assert got["filled"].dtype == np.dtype(dtype) and got["ohlcv"]["open"].dtype == np.dtype(dtype)
    assert got["candles"]["open"].dtype == np.dtype(dtype)
    _assert_fused(got, want, cfg)
    # what the pipeline promises downstream
    n = len(batch.symbols)
    assert got["valid"][:n].any(axis=1).all() and not got["valid"][n:].any()
    for stage in ("ohlcv", "candles"):
        d = got[stage]
        all_ok, _ = validate_ohlcv(*(jnp.asarray(d[f]) for f in PRICES + ("volume",)),
                                   jnp.asarray(d["valid"]))
        assert bool(all_ok), stage
    seg = got["minutes"] // 5 - got["base_bucket"][:, None]
    in_range = got["ohlcv"]["valid"] & (seg >= 0) & (seg < got["candles"]["count"].shape[1])
    assert got["candles"]["count"].sum() == in_range.sum()


def test_cubic_fused_batch_matches_jax():
    df = generate_sample_tickers(num_symbols=5, hours=12, seed=4)
    cfg = _config("float64", method="cubic")
    batch = _pack(df, cfg, compact=False)
    want = _jax_fused(batch, cfg)
    got = port_runner.fused_batch(batch, cfg, "cpu")
    assert got["method"] == "cubic"
    _assert_fused(got, want, cfg)
    # the cubic path through a compact batch of the same data
    compact = port_runner.fused_batch(_pack(df, cfg, compact=True), cfg, "cpu")
    assert compact["method"] == "cubic"
    np.testing.assert_array_equal(compact["filled"], got["filled"])


def test_cubic_with_nan_at_observations_falls_back_to_linear():
    df = generate_sample_tickers(num_symbols=3, hours=12, seed=5)
    df.loc[df.index[4], "iv"] = np.nan
    cfg = _config("float64", method="cubic")
    batch = _pack(df, cfg, compact=False)
    got = port_runner.fused_batch(batch, cfg, "cpu")
    assert got["method"] == "linear"
    _assert_fused(got, _jax_fused(batch, cfg), cfg)


@pytest.mark.parametrize("strategy", ["price_midpoint", "trend_following",
                                      "simple_spread"])
def test_fused_batch_strategies_match_jax(strategy):
    df = generate_sample_tickers(num_symbols=2, hours=6, seed=6)
    cfg = _config("float64", conversion_strategy=strategy, seed=11)
    batch = _pack(df, cfg)
    _assert_fused(port_runner.fused_batch(batch, cfg, "cpu"), _jax_fused(batch, cfg), cfg)


def test_quality_gate_isolates_one_symbol():
    """An alternating 1-minute price drives the spread-simulation close
    negative: that symbol fails the gate alone, and its 1-minute and
    5-minute candles are cleared; the others keep theirs."""
    tickers = generate_sample_tickers(num_symbols=5, hours=6, seed=7)
    syms = sorted(tickers["symbol"].unique())
    victim = syms[2]
    n = 301
    poison = pd.DataFrame({
        "symbol": victim,
        "date": pd.date_range("2023-03-20 09:00", periods=n, freq="1min"),
        "iv": 0.5, "underlying_price": np.where(np.arange(n) % 2 == 0, 100.0, 10.0),
        "time_to_maturity": 0.1, "strike": 24500.0, "callput": "c"})
    tickers = pd.concat([tickers[tickers["symbol"] != victim], poison],
                        ignore_index=True)
    cfg = _config("float64")
    batch = _pack(tickers, cfg)
    got = port_runner.fused_batch(batch, cfg, "cpu")
    want = _jax_fused(batch, cfg)
    assert got["failed"] == {victim: port_runner.QUALITY_REASON}
    _assert_fused(got, want, cfg)
    row = batch.symbols.index(victim)
    assert not got["ohlcv"]["valid"][row].any() and not got["candles"]["valid"][row].any()
    others = [i for i in range(len(batch.symbols)) if i != row]
    assert got["ohlcv"]["valid"][others].any(axis=1).all()
    assert got["candles"]["valid"][others].any(axis=1).all()


def test_misaligned_t0_keeps_its_trailing_bucket():
    """First minute 00:14, 15-minute target: the first (00:14) and the
    last (01:15-01:17) partial buckets are kept, as pandas'
    floor('15min') groupby keeps them."""
    n = 64
    dates = pd.date_range("2023-03-20 00:14", periods=n, freq="1min")
    df = pd.DataFrame({"symbol": "btc-test-opt", "date": dates, "iv": 0.5,
                       "underlying_price": 100.0 + np.arange(n) % 3,
                       "time_to_maturity": 0.1, "strike": 100.0, "callput": "p",
                       "volume": 1.0})
    cfg = _config("float64")
    cfg.candle_reconstruction.target_frequency = "15min"
    cfg.candle_reconstruction.min_candles_required = 1
    batch = _pack(df, cfg)
    got = port_runner.fused_batch(batch, cfg, "cpu")
    _assert_fused(got, _jax_fused(batch, cfg), cfg)
    c = got["candles"]
    assert c["valid"][0].sum() == 6 and c["count"][0].sum() == n
    groups = pd.Series(1.0, index=dates).groupby(dates.floor("15min")).sum()
    np.testing.assert_array_equal(c["count"][0][c["valid"][0]], groups.to_numpy())
    np.testing.assert_allclose(c["volume"][0][c["valid"][0]], groups.to_numpy(),
                               rtol=1e-12)


def test_stage_functions_match_jax(tickers):
    cfg = _config("float64")
    batch = _pack(tickers, cfg)
    B, L, C = batch.batch_padded, batch.bucket_len, len(batch.columns)
    want = ref.scatter_batch(*map(jnp.asarray, (batch.obs_vals, batch.obs_row,
                                                batch.obs_pos, batch.valid_len)),
                             B=B, C=C, L=L)
    got = port.scatter_batch(*map(torch.from_numpy, (batch.obs_vals, batch.obs_row,
                                                     batch.obs_pos, batch.valid_len)),
                             B=B, C=C, L=L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert port.ALL_COLS == ingest.ALL_COLS
    # price-source priority: underlying, else mark, else index
    values = got[0].clone()
    values[0, port.ALL_COLS.index("underlying_price")] = float("nan")
    values[1, port.ALL_COLS.index("underlying_price"), ::2] = float("nan")
    values[1, port.ALL_COLS.index("mark_price")] = float("nan")
    want_col = ref.select_price_columns(jnp.asarray(values.numpy()), want[1])
    got_col = port.select_price_columns(values, got[1])
    np.testing.assert_array_equal(got_col.numpy(), np.asarray(want_col))
    assert got_col[0] == port.ALL_COLS.index("mark_price")
    assert got_col[1] == port.ALL_COLS.index("index_price")


@pytest.mark.parametrize("method,max_gap,extrapolate", [
    ("nearest", 0, False), ("ffill", 0, False), ("linear", 90, True)])
def test_interpolate_batch_options_match_jax(tickers, method, max_gap, extrapolate):
    cfg = _config("float64")
    batch = _pack(tickers, cfg, compact=False)
    strike = np.array([port_runner._to_float(s) for s in batch.const_cols["strike"]])
    call = np.array([str(c).lower() == "c" for c in batch.const_cols["callput"]])
    args = (batch.values, batch.obs_mask, batch.timeline_mask, strike, call)
    kw = dict(method=method, max_gap_minutes=max_gap, extrapolate=extrapolate)
    want = jax.tree.map(np.asarray, ref.interpolate_batch(*map(jnp.asarray, args), **kw))
    got = port.interpolate_batch(*map(torch.from_numpy, args), **kw)
    for k in ("valid", "is_interpolated"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    _assert_values(got["filled"].numpy(), want["filled"], 1e-12)
    for name, g in want["greeks"].items():
        np.testing.assert_allclose(got["greeks"][name].numpy(), g, rtol=0,
                                   atol=1e-12 * np.nanmax(np.abs(g)), err_msg=name)
    none = port.interpolate_batch(*map(torch.from_numpy, args), compute_greeks=False)
    assert "greeks" not in none
    with pytest.raises(ValueError, match="requires obs_pos"):
        port.interpolate_batch(*map(torch.from_numpy, args), method="cubic")


def test_candles_batch_keeps_dtype_and_shifts_rows_exactly(rng):
    """Per-row base buckets through the kernel wrapper's single base:
    float32 and float64 candles match the JAX candle stage."""
    B, L, tgt = 3, 200, 5
    t0 = np.array([29_000_003, 29_000_117, 28_999_998])
    minutes = t0[:, None] + np.arange(L)[None, :]
    for dtype in (np.float64, np.float32):
        close = (100 + np.cumsum(rng.normal(size=(B, L)), axis=-1)).astype(dtype)
        ohlcv = {"open": close, "high": close + 1, "low": close - 1, "close": close,
                 "volume": rng.uniform(0, 5, (B, L)).astype(dtype),
                 "valid": rng.uniform(size=(B, L)) < 0.9}
        kw = dict(num_segments=(L + tgt - 1) // tgt + 1, min_count=3)
        want = ref.candles_batch(jnp.asarray(minutes), jax.tree.map(jnp.asarray, ohlcv),
                                 jnp.int32(tgt), jnp.asarray(t0 // tgt), **kw)
        got = port.candles_batch(torch.from_numpy(minutes),
                                 {k: torch.from_numpy(v) for k, v in ohlcv.items()},
                                 tgt, torch.from_numpy(t0 // tgt), **kw)
        for f in got._fields:
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype, f
            if f == "volume":
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=4 * np.finfo(dtype).eps * ohlcv["volume"].sum())
            else:
                np.testing.assert_array_equal(g, w, err_msg=f)


def test_helpers_match_jax():
    for s in ("BTC-28MAR23-25000-C", "eth-x", ""):
        assert port_runner.symbol_fold(s) == ref_runner.symbol_fold(s)
    for f in ("1min", "5min", "15m", "2h", "45min"):
        assert port_runner.parse_frequency(f) == ref_runner.parse_frequency(f)
    with pytest.raises(ValueError):
        port_runner.parse_frequency("5s")
