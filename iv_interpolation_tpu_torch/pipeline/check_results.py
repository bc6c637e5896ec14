"""Post-hoc result verification of the pipeline and surface tables (port
of ``iv_interpolation_tpu/pipeline/check_results.py``).

Covers the reference's ``check_results.py`` audits:
  * Task 1: row counts, expansion ratio, top-N symbols by output rows
    (check_results.py:23-82)
  * Task 2: counts, compression ratio, per-symbol breakdown, OHLC
    integrity census (valid-OHLC counts, avg spread/volume,
    check_results.py:169-195)
  * 1-min vs 5-min sample comparison (check_results.py:197-242)
  * quick summary across all four tables (check_results.py:394-438)

Frames are read once (the reference's ``cur.fetchone()[0] if
cur.fetchone()`` consumed two rows, check_results.py:410).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from iv_interpolation_tpu_torch.pipeline import storage as st


def check_interpolation_results(store, top_n: int = 10) -> dict:
    """Task-1 audit (check_results.py:23-82)."""
    src_rows = store.count(st.TICKERS)
    out = store.read(st.INTERPOLATED)
    if out.empty:
        return {"ok": False, "reason": "no interpolated data",
                "source_rows": src_rows}
    per_symbol = out.groupby("symbol").size().sort_values(ascending=False)
    n_interp = int(out["is_interpolated"].sum()) \
        if "is_interpolated" in out.columns else None
    return {
        "ok": True,
        "source_rows": src_rows,
        "output_rows": len(out),
        "symbols": out["symbol"].nunique(),
        "expansion_ratio": (len(out) / src_rows) if src_rows else None,
        "interpolated_rows": n_interp,
        "original_rows": (len(out) - n_interp) if n_interp is not None else None,
        "top_symbols": per_symbol.head(top_n).to_dict(),
        "date_range": (str(out["date"].min()), str(out["date"].max())),
    }


def check_candle_results(store, frequency: str = "5min") -> dict:
    """Task-2 audit with OHLC-integrity census (check_results.py:86-195)."""
    minute_rows = store.count(st.MINUTE_CANDLES)
    out = store.read(st.RECONSTRUCTED)
    if out.empty:
        return {"ok": False, "reason": "no reconstructed candles",
                "minute_rows": minute_rows}
    if "frequency" in out.columns:
        out = out[out["frequency"] == frequency]
    valid_ohlc = ((out["high"] >= out["low"])
                  & (out["high"] >= out["open"]) & (out["high"] >= out["close"])
                  & (out["low"] <= out["open"]) & (out["low"] <= out["close"]))
    per_symbol = out.groupby("symbol").size()
    return {
        "ok": bool(valid_ohlc.all()),
        "minute_rows": minute_rows,
        "reconstructed_rows": len(out),
        "symbols": out["symbol"].nunique(),
        "compression_ratio": (minute_rows / len(out)) if len(out) else None,
        "valid_ohlc_rows": int(valid_ohlc.sum()),
        "invalid_ohlc_rows": int((~valid_ohlc).sum()),
        "avg_spread": float((out["high"] - out["low"]).mean()),
        "avg_volume": float(out["volume"].mean()),
        "negative_volume_rows": int((out["volume"] < 0).sum()),
        "per_symbol": per_symbol.to_dict(),
    }


def compare_minute_vs_reconstructed(store, symbol: Optional[str] = None,
                                    n: int = 12,
                                    frequency: str = "5min") -> pd.DataFrame:
    """Side-by-side sample of source 1-min vs N-min output
    (check_results.py:197-242's CTE UNION, as a merged frame).

    ``frequency`` selects which reconstructed rows to audit AND sizes
    the source aggregation window — the table's unique key
    (symbol, timestamp, frequency) supports multiple frequencies, and a
    hardcoded 5-minute span would compare 15-min rows against a third of
    their source candles (check_candle_results applies the same filter).
    """
    from iv_interpolation_tpu_torch.pipeline.runner import parse_frequency

    window_min = parse_frequency(frequency)
    minute = store.read(st.MINUTE_CANDLES,
                        symbols=[symbol] if symbol else None)
    recon = store.read(st.RECONSTRUCTED,
                       symbols=[symbol] if symbol else None)
    if not recon.empty and "frequency" in recon.columns:
        recon = recon[recon["frequency"] == frequency]
    if minute.empty or recon.empty:
        return pd.DataFrame()
    if symbol is None:
        symbol = recon["symbol"].iloc[0]
        minute = minute[minute["symbol"] == symbol]
        recon = recon[recon["symbol"] == symbol]
    recon = recon.sort_values("timestamp").head(n)
    rows = []
    for _, r in recon.iterrows():
        span = minute[(minute["timestamp"] >= r["timestamp"])
                      & (minute["timestamp"] < r["timestamp"]
                         + pd.Timedelta(minutes=window_min))
                      ].sort_values("timestamp")
        rows.append({
            "timestamp": r["timestamp"],
            "src_count": len(span),
            "src_open": span["open"].iloc[0] if len(span) else np.nan,
            "src_high": span["high"].max() if len(span) else np.nan,
            "src_low": span["low"].min() if len(span) else np.nan,
            "src_close": span["close"].iloc[-1] if len(span) else np.nan,
            "src_volume": span["volume"].sum() if len(span) else np.nan,
            "out_open": r["open"], "out_high": r["high"],
            "out_low": r["low"], "out_close": r["close"],
            "out_volume": r["volume"],
        })
    df = pd.DataFrame(rows)
    if len(df):
        df["matches"] = (
            np.isclose(df["src_open"], df["out_open"])
            & np.isclose(df["src_high"], df["out_high"])
            & np.isclose(df["src_low"], df["out_low"])
            & np.isclose(df["src_close"], df["out_close"])
            & np.isclose(df["src_volume"], df["out_volume"], rtol=1e-6)
        )
    return df


def quick_summary(store) -> dict:
    """Census across all pipeline tables (check_results.py:394-438)."""
    out = {}
    for table in (st.TICKERS, st.INTERPOLATED, st.MINUTE_CANDLES,
                  st.RECONSTRUCTED):
        rows = store.count(table)
        out[table] = {
            "rows": rows,
            "symbols": len(store.list_symbols(table)) if rows else 0,
        }
    t1 = out[st.TICKERS]["rows"]
    ti = out[st.INTERPOLATED]["rows"]
    tm = out[st.MINUTE_CANDLES]["rows"]
    tr = out[st.RECONSTRUCTED]["rows"]
    out["expansion_ratio"] = ti / t1 if t1 else None
    out["compression_ratio"] = tm / tr if tr else None
    out["pipeline_complete"] = all(v["rows"] > 0 for k, v in out.items()
                                   if isinstance(v, dict))
    return out


def check_surface_results(store) -> dict:
    """Vol-surface audit (no reference analogue): per underlying arbitrage
    flags, iv sanity ranges, grid coverage."""
    from iv_interpolation_tpu_torch.pipeline.surface_task import SURFACES
    surf = store.read(SURFACES)
    if surf.empty:
        return {"ok": False, "reason": "no fitted surfaces"}
    aggs = dict(
        rows=("iv", "size"),
        butterfly_ok=("butterfly_ok", "first"),
        calendar_ok=("calendar_ok", "first"),
        iv_min=("iv", "min"), iv_max=("iv", "max"),
        expiries=("expiry_t", "nunique"))
    if "fit_rmse" in surf.columns:
        aggs["fit_rmse"] = ("fit_rmse", "first")
    per = surf.groupby("underlying").agg(**aggs)
    sane_iv = bool(((per["iv_min"] > 0) & (per["iv_max"] < 5)).all())
    report = {
        "ok": sane_iv,
        "surfaces": len(per),
        "grid_rows": len(surf),
        "butterfly_ok": int(per["butterfly_ok"].sum()),
        "calendar_ok": int(per["calendar_ok"].sum()),
        "iv_range": (float(per["iv_min"].min()), float(per["iv_max"].max())),
        "per_underlying": per.to_dict("index"),
    }
    if "fit_rmse" in per.columns:
        report["worst_fit_rmse"] = float(per["fit_rmse"].max())
    return report
