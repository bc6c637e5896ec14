"""Plain reference of the tick-to-refit service: the ticks a ring of fixed
capacity holds, 1-minute and 5-minute candles, realized vol, the refit
rule, and the refit surfaces (``reference.spline``).

Worked out from the raw ticks and quote chains the benchmark generated, in
NumPy (candles, float64 sums) and float64 torch (the splines), with
nothing of the port imported or taken from it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import spline

MINUTES_PER_YEAR = 365.25 * 24 * 60


def ring_contents(underlying: np.ndarray, n_rows: int, capacity: int) -> np.ndarray:
    """Indices, in arrival order within each row, of the ticks a ring of
    ``capacity`` slots a row still holds after all of these arrived: each
    row's newest ``capacity``."""
    order = np.argsort(underlying, kind="stable")
    rows = underlying[order]
    counts = np.bincount(rows, minlength=n_rows)
    end = np.cumsum(counts)[rows]
    pos_from_end = end - np.arange(len(rows))          # 1 for a row's newest tick
    return order[pos_from_end <= capacity]


def _round(a: np.ndarray, r) -> np.ndarray:
    """``a`` through the rounding ``r`` of ``reference.spline`` (float32
    arrays out); unchanged where ``r`` is None."""
    return a if r is None else r(torch.from_numpy(np.ascontiguousarray(a, np.float32))).numpy()


def candles_1m(rows, minute, price, size, n_rows: int, W: int, r=None) -> dict:
    """Per (row, minute of the window) the open (first tick by minute,
    then by arrival), high, low, close (last), float64 volume and count of
    the ticks given (indices already in arrival order within each row,
    minutes relative to the window's start, all in [0, W)). Empty minutes:
    NaN prices, volume 0, not valid."""
    key = rows.astype(np.int64) * W + minute
    order = np.argsort(key, kind="stable")
    key, p, s = key[order], _round(price[order], r), size[order].astype(np.float64)
    if r is not None:
        s = _round(s, r)
    out = _empty(n_rows * W)
    if len(key):
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        ends = np.r_[starts[1:], len(key)]
        cells = key[starts]
        out["open"][cells] = p[starts]
        out["close"][cells] = p[ends - 1]
        out["high"][cells] = np.maximum.reduceat(p, starts)
        out["low"][cells] = np.minimum.reduceat(p, starts)
        out["volume"][cells] = _round(np.add.reduceat(s, starts), r)
        out["count"][cells] = ends - starts
    out["valid"] = out["count"] >= 1
    return {name: a.reshape(n_rows, W) for name, a in out.items()}


def _empty(n: int) -> dict:
    nan = lambda: np.full(n, np.nan, np.float32)
    return {"open": nan(), "high": nan(), "low": nan(), "close": nan(),
            "volume": np.zeros(n), "count": np.zeros(n, np.int64)}


def candles_5m(c1: dict, bucket: int, n_buckets: int, min_count: int) -> dict:
    """Buckets of ``bucket`` valid 1-minute candles: open of the first,
    close of the last, high, low, volume summed, count of the 1-minute
    candles; valid where the count reaches ``min_count``."""
    n_rows, W = c1["count"].shape
    out = _empty(n_rows * n_buckets)
    for name in out:
        out[name] = out[name].reshape(n_rows, n_buckets)
    for b in range(n_buckets):
        lo, hi = b * bucket, min((b + 1) * bucket, W)
        if lo >= W:
            break
        ok = c1["valid"][:, lo:hi]
        cnt = ok.sum(axis=1)
        has = cnt > 0
        first = np.argmax(ok, axis=1)
        last = hi - lo - 1 - np.argmax(ok[:, ::-1], axis=1)
        r = np.arange(n_rows)
        out["open"][has, b] = c1["open"][:, lo:hi][r, first][has]
        out["close"][has, b] = c1["close"][:, lo:hi][r, last][has]
        with np.errstate(invalid="ignore"):
            out["high"][has, b] = np.where(ok, c1["high"][:, lo:hi], -np.inf).max(axis=1)[has]
            out["low"][has, b] = np.where(ok, c1["low"][:, lo:hi], np.inf).min(axis=1)[has]
        out["volume"][:, b] = np.where(ok, c1["volume"][:, lo:hi], 0.0).sum(axis=1)
        out["count"][:, b] = cnt
    out["valid"] = out["count"] >= min_count
    return out


def realized_vol(c5: dict, bucket: int, r=None):
    """Annualised root-mean-square log return of consecutive valid 5-minute
    closes (0 where a row has no such pair), and the count of pairs."""
    close = c5["close"].astype(np.float64)
    ok = c5["valid"]
    pair = ok[:, 1:] & ok[:, :-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        lr = np.where(pair, _round(np.log(_round(close[:, 1:] / close[:, :-1], r)), r), 0.0)
    n = pair.sum(axis=1)
    mean_sq = _round((lr * lr).sum(axis=1) / np.maximum(n, 1), r)
    return _round(np.sqrt(mean_sq * (MINUTES_PER_YEAR / bucket)), r), n


def refit_vols(chain_k, chain_iv, realized, n_pairs, blend: float, clamp) -> np.ndarray:
    """The configuration's refit rule: each row's quoted vols scaled by
    1 + blend (realized / atm - 1), atm the quote nearest k = 0 of each
    expiry (the first on ties), clamped to ``clamp``; a row with no return
    pair, or an atm vol under 1e-6, keeps its quotes."""
    k = np.asarray(chain_k, np.float64)
    iv = np.asarray(chain_iv, np.float64)
    atm_idx = np.argmin(np.abs(k), axis=-1)[..., None]
    atm = np.take_along_axis(iv, atm_idx, axis=-1)
    rv = realized[:, None, None]
    has = (n_pairs > 0)[:, None, None] & (atm > 1e-6)
    scale = np.where(has, 1.0 + blend * (rv / np.maximum(atm, 1e-6) - 1.0), 1.0)
    return iv * np.clip(scale, *clamp)


def refit(ticks: dict, upto: int, now: int, chain: dict, cfg: dict, r=None) -> dict:
    """Everything one refit answers, for the ring state after the first
    ``upto`` ticks of ``ticks`` (arrival order) and the window ending at
    minute ``now``: ``candles_1m``, ``candles_5m``, ``realized_vol`` and
    the surface outputs of :func:`spline.surface` on the refit vols. With
    a rounding ``r`` (``spline.tf32``) every stage is computed in float32
    through it: the control in a lower precision."""
    U, W = cfg["underlyings"], cfg["window_minutes"]
    bucket, n5 = cfg["bucket_minutes"], cfg["window_minutes"] // cfg["bucket_minutes"] + 1
    rows = ticks["underlying"][:upto]
    held = ring_contents(rows, U, cfg["tick_capacity"])
    rel = ticks["minute"][:upto][held] - (now - W + 1)
    inside = (rel >= 0) & (rel < W)
    pick = held[inside]
    c1 = candles_1m(rows[pick], rel[inside], ticks["price"][:upto][pick],
                    ticks["size"][:upto][pick], U, W, r)
    c5 = candles_5m(c1, bucket, n5, cfg["min_candles"])
    if r is not None:
        c5["volume"] = _round(c5["volume"], r)
    rv, n_pairs = realized_vol(c5, bucket, r)
    k = chain["k"].double().cpu().numpy()
    iv_new = _round(refit_vols(k, chain["iv"].double().cpu().numpy(), rv, n_pairs,
                               cfg["refit_blend"], cfg["refit_scale_clamp"]), r)
    dtype = torch.float64 if r is None else torch.float32
    dev = chain["k"].device
    surf = spline.surface(chain["k"].to(dtype), torch.as_tensor(iv_new, dtype=dtype, device=dev),
                          chain["T"].to(dtype), cfg["n_grid"], cfg["butterfly_tolerance"],
                          cfg["calendar_tolerance"], r or spline.exact)
    return {"candles_1m": c1, "candles_5m": c5, "realized_vol": rv, **surf}
