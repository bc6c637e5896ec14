"""Synthetic-OHLCV bridge: interpolated point prices -> 1-minute candles
(port of ``iv_interpolation_tpu/ops/bridge.py``).

All draws come from counter-based keys (``ops.prng``, the JAX package's
threefry bits) derived from (seed, symbol, absolute epoch minute), so a
minute's candle is the same wherever that minute lands in a grid, and
the port draws the JAX package's numbers.

Every function takes a batch: rows ``(..., L)`` with one key ``(..., 2)``
per row, in place of the reference's ``vmap`` over series.

Strategies (as the reference's ``ohlcv_converter.py``):
  * ``spread_simulation``  randomized spread + 30 % trend continuation
  * ``price_midpoint``     symmetric +/- spread/2 around the point price
  * ``trend_following``    5-candle lookback trend (sequential loop)
  * ``simple_spread``      open = base, fixed 0.1 % band
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from iv_interpolation_tpu_torch.ops import prng


class BridgeParams(NamedTuple):
    base_spread_percent: float = 0.002
    volatility_factor: float = 1.5
    min_spread_percent: float = 0.0005
    trend_strength: float = 0.6
    base_volume: float = 50.0


STRATEGIES = ("spread_simulation", "price_midpoint", "trend_following",
              "simple_spread")


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, correctly rounded on every device: CUDA divides by a
    Python scalar as a multiply by its reciprocal, one ulp off the
    quotient for a c that is not a power of two."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _round(x: torch.Tensor, decimals: int) -> torch.Tensor:
    # the reference rounds prices to 4 dp and volume to 6 dp
    f = 10.0 ** decimals
    return _div(torch.round(x * f), f)


def _linear_recurrence(m: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Solve x[t] = a[t] + m[t] x[t-1] (x[-1] = 0) along the last axis.

    A Hillis-Steele doubling scan of the affine maps (m, a): after the
    pass at stride d each slot holds the composition of the 2d maps ending
    there, (m1, a1) then (m2, a2) = (m2 m1, a2 + m2 a1). ceil(log2 L)
    passes of whole-tensor ops; the reference's ``associative_scan``
    composes in another tree order, so the two agree to rounding.
    """
    L = m.shape[-1]
    d = 1
    while d < L:
        m_prev, a_prev = m[..., :-d], a[..., :-d]
        a = torch.cat((a[..., :d], a[..., d:] + m[..., d:] * a_prev), dim=-1)
        m = torch.cat((m[..., :d], m[..., d:] * m_prev), dim=-1)
        d *= 2
    return a


def _per_minute_keys(stream_key: torch.Tensor, abs_minutes: torch.Tensor) -> torch.Tensor:
    """One key per (row, minute): ``fold_in(stream_key, minute)``, with
    stream keys ``(..., 2)`` and minutes ``(..., L)`` -> ``(..., L, 2)``."""
    return prng.fold_in(stream_key[..., None, :], abs_minutes)


def _process_volume(volume, key, base_volume, abs_minutes):
    """Keep positive volumes; impute Exponential(base_volume) draws for
    missing or non-positive ones."""
    imputed = prng.exponential(_per_minute_keys(key, abs_minutes),
                               volume.dtype) * base_volume
    have = torch.isfinite(volume) & (volume > 0)
    return torch.where(have, volume, imputed)


def synthesize_ohlcv(base_price: torch.Tensor, volume: torch.Tensor,
                     valid: torch.Tensor, key: torch.Tensor,
                     params: BridgeParams = BridgeParams(),
                     strategy: str = "spread_simulation",
                     abs_minutes: torch.Tensor | None = None) -> dict:
    """Synthetic 1-minute OHLCV from interpolated point prices.

    Args:
      base_price: ``(..., L)`` interpolated price series.
      volume: ``(..., L)`` source volume (NaN or <= 0 -> imputed).
      valid: ``(..., L)`` bool mask.
      key: ``(..., 2)`` PRNG key of each series.
      params: spread, trend and volume parameters.
      strategy: one of :data:`STRATEGIES`.
      abs_minutes: ``(..., L)`` absolute epoch minutes of the grid rows;
        draws are keyed on them. Defaults to ``arange(L)``.

    Returns a dict of ``(..., L)`` tensors: open, high, low, close, volume
    and ``valid`` (rows with a non-positive or NaN base price are invalid).
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown conversion strategy: {strategy!r}")
    L = base_price.shape[-1]
    dtype, device = base_price.dtype, base_price.device
    ok = valid & torch.isfinite(base_price) & (base_price > 0)
    base = torch.where(ok, base_price, 1.0)  # keep math finite on dead rows
    if abs_minutes is None:
        abs_minutes = torch.arange(L, device=device)
    streams = prng.split(key, 6)
    k_vol, k1, k2, k3, k4, k5 = streams.unbind(-2)

    def u(k, lo, hi):
        return prng.uniform(_per_minute_keys(k, abs_minutes), dtype, lo, hi)

    if strategy == "spread_simulation":
        vol_mult = u(k1, 0.5, params.volatility_factor)
        spread = base * params.base_spread_percent * vol_mult
        o_off = u(k2, -1.0, 1.0) * _div(spread, 3.0)
        c_off = u(k3, -1.0, 1.0) * _div(spread, 3.0)
        # trend_bias = 0.3 (base - prev_close); open += 0.2 tb, close += 0.5 tb,
        # so close = base + c_off + 0.15 base - 0.15 prev_close
        first_ok = torch.argmax(ok.to(torch.uint8), dim=-1, keepdim=True)
        is_first = torch.arange(L, device=device) == first_ok
        m = torch.where(ok & ~is_first, torch.tensor(-0.15, dtype=dtype, device=device),
                        1.0)
        a = torch.where(ok, torch.where(is_first, base + c_off,
                                        base + c_off + 0.15 * base), 0.0)
        close = _linear_recurrence(m, a)
        prev_close = torch.cat((close[..., :1], close[..., :-1]), dim=-1)
        trend_bias = torch.where(is_first, 0.0, 0.3 * (base - prev_close))
        open_ = base + o_off + 0.2 * trend_bias
        high = torch.maximum(open_, close) + u(k4, 0.0, 1.0) * (spread / 2.0)
        low = torch.minimum(open_, close) - u(k5, 0.0, 1.0) * (spread / 2.0)
        # minimum-spread enforcement
        mid_oc = (open_ + close) / 2.0
        narrow = (high - low) < base * params.min_spread_percent
        half = base * (params.min_spread_percent / 2.0)
        high = torch.where(narrow, mid_oc + half, high)
        low = torch.where(narrow, mid_oc - half, low)
    elif strategy == "price_midpoint":
        spread = base * 0.001
        open_ = base + u(k1, -1.0, 1.0) * (spread / 4.0)
        close = base + u(k2, -1.0, 1.0) * (spread / 4.0)
        high = base + spread / 2.0
        low = base - spread / 2.0
    elif strategy == "trend_following":
        noise = prng.normal(_per_minute_keys(k1, abs_minutes), dtype) * (base * 0.001)
        open_, close, trend = _trend_following_scan(base, noise, ok,
                                                    params.trend_strength)
        # high/low asymmetric by the trend's sign
        up = trend > 0
        c = lambda x: torch.tensor(x, dtype=dtype, device=device)
        high = torch.maximum(open_, close) + trend.abs() * torch.where(up, c(0.5), c(0.2))
        low = torch.minimum(open_, close) - trend.abs() * torch.where(up, c(0.2), c(0.5))
    else:  # simple_spread
        spread = base * 0.001
        open_ = base
        close = base + u(k1, -1.0, 1.0) * (spread / 2.0)
        high = base + spread / 2.0
        low = base - spread / 2.0

    vol = _process_volume(volume, k_vol, params.base_volume, abs_minutes)
    nan = torch.full((), float("nan"), dtype=dtype, device=device)
    return {
        "open": torch.where(ok, _round(open_, 4), nan),
        "high": torch.where(ok, _round(high, 4), nan),
        "low": torch.where(ok, _round(low, 4), nan),
        "close": torch.where(ok, _round(close, 4), nan),
        "volume": torch.where(ok, _round(vol, 6), 0.0),
        "valid": ok,
    }


def _trend_following_scan(base, noise, ok, trend_strength):
    """The 5-close-lookback trend, a loop over the L minutes with every
    row of the batch in each step (the reference's ``lax.scan``). It
    launches some fifteen small ops per minute: bound by launches on a
    card, and not the default strategy."""
    L = base.shape[-1]
    closes = torch.full(base.shape[:-1] + (5,), float("nan"), dtype=base.dtype,
                        device=base.device)  # most recent closes, oldest first
    opens, outs, trends = [], [], []
    for t in range(L):
        b, nz, o = base[..., t], noise[..., t], ok[..., t]
        finite = torch.isfinite(closes)
        n_valid = finite.sum(-1)
        first = torch.gather(closes, -1, torch.argmax(finite.to(torch.uint8), -1,
                                                      keepdim=True))[..., 0]
        trend = torch.where(n_valid > 1, (closes[..., -1] - first)
                            / n_valid.clamp_min(1).to(base.dtype), 0.0)
        open_ = b + trend * trend_strength + nz
        close = b + trend * trend_strength * 1.2 + nz
        shifted = torch.cat((closes[..., 1:], close[..., None]), dim=-1)
        closes = torch.where(o[..., None], shifted, closes)
        opens.append(open_)
        outs.append(close)
        trends.append(trend)
    return torch.stack(opens, -1), torch.stack(outs, -1), torch.stack(trends, -1)


def validate_bridge_quality(open_, high, low, close, source_price, valid,
                            max_spread_frac=0.1):
    """Quality gate: OHLC relations, spread <= ``max_spread_frac`` of the
    source price, strictly positive prices, on valid rows. Returns
    (all_ok, per-row ok)."""
    rel = ((high >= low) & (high >= open_) & (high >= close)
           & (low <= open_) & (low <= close))
    spread_ok = (high - low) <= max_spread_frac * source_price
    positive = (open_ > 0) & (high > 0) & (low > 0) & (close > 0)
    ok = ~valid | (rel & spread_ok & positive)
    return ok.all(), ok
