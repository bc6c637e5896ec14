"""Streaming pipeline step: ticks -> candles -> surface refit (port of
``iv_interpolation_tpu/pipeline/streaming.py``).

Stages, all batched over underlyings:
  1. tick -> 1-min OHLCV      (aggregation kernel, bucket_minutes=1)
  2. 1-min -> 5-min OHLCV     (aggregation kernel, incomplete-bucket mask)
  3. realized vol from 5-min closes (annualised root-mean log-return)
  4. surface refit: the quote surface re-scaled by the realized/implied
     ratio, then cubic-spline fit + dense-grid eval + diagnostics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from iv_interpolation_tpu_torch.ops.cuda.stream_agg import aggregate_ohlcv_cuda
from iv_interpolation_tpu_torch.ops.segment_ohlcv import Candles
from iv_interpolation_tpu_torch.ops.spline_matrix import fit_eval_surface_grid_batched
from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface

MINUTES_PER_YEAR = 365.25 * 24 * 60


class StreamingOut(NamedTuple):
    w_grid: torch.Tensor        # (B, E, m) refit total variance
    iv_grid: torch.Tensor       # (B, E, m)
    realized_vol: torch.Tensor  # (B,) annualised realized vol
    butterfly_ok: torch.Tensor  # (B,)
    calendar_ok: torch.Tensor   # (B,)
    candles_1m: Candles         # (B, n_minutes)
    candles_5m: Candles         # (B, n_minutes // bucket_minutes + 1)


def streaming_step(tick_minute: torch.Tensor, tick_price: torch.Tensor,
                   tick_size: torch.Tensor, tick_valid: torch.Tensor,
                   chain_k: torch.Tensor, chain_iv: torch.Tensor,
                   chain_T: torch.Tensor, *, n_minutes: int = 512,
                   bucket_minutes: int = 5, n_grid: int = 50,
                   spline_ops=None,
                   spline_bc: str = "not-a-knot") -> StreamingOut:
    """One streaming batch: refit every underlying's surface from ticks.

    Valid tick rows must be time-sorted per underlying for open/close to
    mean first/last trade (``stream_service._sort_window_by_minute`` sorts
    a ring window); high, low, volume and count do not depend on order.

    Args:
      tick_minute: (B, L) int minutes from window start per tick.
      tick_price:  (B, L) trade prices.
      tick_size:   (B, L) trade sizes.
      tick_valid:  (B, L) bool.
      chain_k/iv/T: (B, E, n) / (B, E, n) / (B, E) quote surfaces.
      n_minutes: window length in minutes.
      spline_ops: optional per-underlying SplineOperator stack ((B, E, n,
        n_grid) tensors from ``ops.spline_matrix.
        build_surface_operators_batched``): the refit is then one batched
        product instead of a tridiagonal solve + piecewise eval.
      spline_bc: boundary condition of the ``spline_ops=None`` refit;
        ignored when ``spline_ops`` is given.
    """
    n5 = n_minutes // bucket_minutes + 1
    c1 = aggregate_ohlcv_cuda(
        tick_minute, tick_price, tick_price, tick_price, tick_price,
        tick_size, tick_valid, bucket_minutes=1, num_segments=n_minutes,
        min_count=1)
    minutes_1m = torch.arange(n_minutes, dtype=torch.int32,
                              device=c1.open.device).expand(c1.open.shape)
    c5 = aggregate_ohlcv_cuda(
        minutes_1m, c1.open, c1.high, c1.low, c1.close, c1.volume,
        c1.valid, bucket_minutes=bucket_minutes, num_segments=n5,
        min_count=bucket_minutes)

    # realized vol from 5-min closes (masked log returns)
    close, ok = c5.close, c5.valid
    pair_ok = ok[..., 1:] & ok[..., :-1]
    safe = torch.where(ok, close.clamp_min(1e-12), torch.ones_like(close))
    lr = torch.where(pair_ok, torch.log(safe[..., 1:] / safe[..., :-1]),
                     torch.zeros_like(safe[..., 1:]))
    n_pairs = pair_ok.sum(dim=-1)
    var_per_bar = (lr * lr).sum(dim=-1) / n_pairs.clamp_min(1)
    realized = torch.sqrt(var_per_bar * (MINUTES_PER_YEAR / bucket_minutes))

    # refit: blend quote IVs toward the realized level at the money. An
    # underlying with no in-window return pairs keeps its quoted surface
    # (scale 1): realized = 0 there means "no data", not "zero vol"
    atm_idx = torch.argmin(chain_k.abs(), dim=-1, keepdim=True)  # first on ties
    atm_iv = torch.gather(chain_iv, -1, atm_idx)
    has_data = (n_pairs > 0)[:, None, None]
    scale = torch.where(
        has_data & (atm_iv > 1e-6),
        1.0 + 0.5 * (realized[:, None, None] / atm_iv.clamp_min(1e-6) - 1.0),
        torch.ones_like(atm_iv))
    iv_new = chain_iv * scale.clamp(0.25, 4.0)
    if spline_ops is not None:
        res = fit_eval_surface_grid_batched(spline_ops, iv_new, chain_T)
    else:
        res = fit_eval_surface(chain_k, iv_new, chain_T, n_grid=n_grid,
                               spline_bc=spline_bc)
    return StreamingOut(
        w_grid=res["w_grid"], iv_grid=res["iv_grid"], realized_vol=realized,
        butterfly_ok=res["butterfly_ok"], calendar_ok=res["calendar_ok"],
        candles_1m=c1, candles_5m=c5)
