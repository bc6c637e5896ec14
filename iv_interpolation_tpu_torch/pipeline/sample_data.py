"""Synthetic fixture generators (port of
``iv_interpolation_tpu/pipeline/sample_data.py``: the same frames for
the same seed).

Vectorised ports of the reference's test-data generator
(``generate_sample_candle_data``, main.py:165-265: 5 BTC option symbols,
24h of Gaussian random-walk 1-minute OHLCV into ``minute_candles``) plus
an hourly-ticker generator for Task-1 input, which the reference could
only source from a live database. Deterministic via numpy Generator seed.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd

SAMPLE_SYMBOLS = [
    "btc-20mar23-24500-c",
    "btc-20mar23-25000-c",
    "btc-20mar23-25500-c",
    "btc-20mar23-24500-p",
    "btc-20mar23-25000-p",
]

_EXPIRY_NAMES = ["20mar23", "27mar23", "03apr23", "28apr23", "26may23",
                 "30jun23", "29sep23", "29dec23"]
_EXPIRY_YEARS = [7 / 365, 14 / 365, 21 / 365, 46 / 365, 74 / 365,
                 109 / 365, 200 / 365, 291 / 365]


def _chain_symbols(num_symbols: int):
    """Option-chain symbol grid: expiries x strikes x call/put, reference
    naming (btc-<expiry>-<strike>-<cp>). The first 5 match SAMPLE_SYMBOLS."""
    if num_symbols <= len(SAMPLE_SYMBOLS):
        return SAMPLE_SYMBOLS[:num_symbols]
    out = []
    strikes = [20000 + 500 * i for i in range(12)]
    for exp in _EXPIRY_NAMES:
        for strike in strikes:
            for cp in ("c", "p"):
                out.append(f"btc-{exp}-{strike}-{cp}")
                if len(out) >= num_symbols:
                    return out
    # wrap with distinct underlyings if a huge count is requested
    i = 0
    while len(out) < num_symbols:
        out.append(f"eth{i}-{_EXPIRY_NAMES[i % 8]}-{1500 + i}-c")
        i += 1
    return out


def _symbol_fields(symbol: str):
    """Parse strike/callput from reference-style symbol names
    (main.py:177-183: btc-20mar23-24500-c)."""
    parts = symbol.split("-")
    strike = float(parts[-2]) if len(parts) >= 2 else np.nan
    callput = "C" if parts[-1].lower() == "c" else "P"
    return strike, callput


def generate_sample_candles(num_symbols: int = 5, hours: int = 24,
                            seed: int = 0,
                            symbols: Optional[List[str]] = None,
                            start="2023-03-20 09:00") -> pd.DataFrame:
    """1-minute random-walk OHLCV candles (reference main.py:165-229).

    Same process: per-minute Gaussian close move (sigma=10), high/low
    offset |N(0,3)|, exponential(50) volume, open = previous close, base
    price ~ N(25000, 500); vectorised with cumsum instead of the
    reference's per-row Python loop.
    """
    rng = np.random.default_rng(seed)
    syms = symbols if symbols is not None else _chain_symbols(num_symbols)
    L = hours * 60
    ts = pd.date_range(start, periods=L, freq="1min")
    frames = []
    for symbol in syms:
        base = 25000 + rng.normal(0, 500)
        moves = rng.normal(0, 10, L)
        closes = base + np.cumsum(moves)
        opens = np.concatenate([[base], closes[:-1]])
        high = np.maximum(opens, closes) + np.abs(rng.normal(0, 3, L))
        low = np.minimum(opens, closes) - np.abs(rng.normal(0, 3, L))
        volume = np.maximum(0, rng.exponential(50, L))
        frames.append(pd.DataFrame({
            "symbol": symbol, "timestamp": ts,
            "open": np.round(opens, 2), "high": np.round(high, 2),
            "low": np.round(low, 2), "close": np.round(closes, 2),
            "volume": np.round(volume, 4),
        }))
    return pd.concat(frames, ignore_index=True)


def generate_sample_tickers(num_symbols: int = 5, hours: int = 24,
                            seed: int = 0,
                            symbols: Optional[List[str]] = None,
                            start="2023-03-20 09:00",
                            drop_frac: float = 0.0) -> pd.DataFrame:
    """Hourly IV ticker rows in the reference ``trading_tickers`` layout
    (src/database/schema.py:21-52): symbol, date, iv, underlying_price,
    time_to_maturity, strike, callput, interest_rate, mark/index price,
    volume, quote_volume.

    ``drop_frac`` randomly removes observations to exercise gap handling.
    """
    rng = np.random.default_rng(seed)
    syms = symbols if symbols is not None else _chain_symbols(num_symbols)
    ts = pd.date_range(start, periods=hours, freq="1h")
    frames = []
    base_under = 25000 + rng.normal(0, 500)
    exp_to_T = dict(zip(_EXPIRY_NAMES, _EXPIRY_YEARS))
    for symbol in syms:
        strike, callput = _symbol_fields(symbol)
        under = base_under + np.cumsum(rng.normal(0, 50, hours))
        # smile-shaped base vol so surface fits on sample data are
        # well-posed: iv rises with |log-moneyness|
        kmon = np.log(max(strike, 1.0) / base_under) if np.isfinite(strike) else 0.0
        iv = np.clip(0.45 + 0.15 * kmon * kmon
                     + 0.05 * np.cumsum(rng.normal(0, 0.02, hours))
                     / np.sqrt(np.arange(1, hours + 1)), 0.05, 3.0)
        exp_name = symbol.split("-")[1] if "-" in symbol else ""
        ttm0 = exp_to_T.get(exp_name, rng.uniform(0.05, 0.5))
        ttm = ttm0 - np.arange(hours) / (24 * 365.0)
        df = pd.DataFrame({
            "symbol": symbol, "date": ts, "iv": iv,
            "underlying_price": under,
            "time_to_maturity": np.maximum(ttm, 1e-4),
            "strike": strike, "callput": callput,
            "interest_rate": 0.03,
            "mark_price": under * 0.02 * iv,
            "index_price": under + rng.normal(0, 5, hours),
            "volume": np.maximum(0, rng.exponential(10, hours)),
            "quote_volume": np.maximum(0, rng.exponential(250, hours)),
        })
        if drop_frac > 0:
            keep = rng.uniform(size=hours) >= drop_frac
            keep[0] = keep[-1] = True
            df = df[keep]
        frames.append(df)
    return pd.concat(frames, ignore_index=True)
