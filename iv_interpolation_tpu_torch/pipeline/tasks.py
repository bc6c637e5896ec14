"""Stage functions over packed batches: the device side of the three
pipeline stages (Task 1 interpolation, the OHLCV bridge, Task 2 candles).
Port of ``iv_interpolation_tpu/pipeline/tasks.py``.

Each function works on a ``(B, C, L)`` bucket batch on one device; the
driver that chains them is ``pipeline.runner.fused_batch``.
"""

from __future__ import annotations

import torch

from iv_interpolation_tpu_torch.ops.black_scholes import bs_greeks
from iv_interpolation_tpu_torch.ops.bridge import BridgeParams, synthesize_ohlcv
from iv_interpolation_tpu_torch.ops.cuda.stream_agg import aggregate_ohlcv_cuda
from iv_interpolation_tpu_torch.ops.interp import cubic_resample, masked_interp
from iv_interpolation_tpu_torch.ops.segment_ohlcv import Candles
# the packed grid's columns: the first three interpolated, the rest
# forward-filled
from iv_interpolation_tpu_torch.pipeline.ingest import ALL_COLS, INTERP_COLS

_N_INTERP = len(INTERP_COLS)
_IV, _UP, _TTM = 0, 1, 2
_RATE = ALL_COLS.index("interest_rate")
_VOLUME = ALL_COLS.index("volume")


def scatter_batch(obs_vals: torch.Tensor, obs_row: torch.Tensor,
                  obs_pos: torch.Tensor, valid_len: torch.Tensor,
                  *, B: int, C: int, L: int):
    """Compact observations -> the dense ``(B, C, L)`` NaN grid and masks.

    ``obs_vals`` (N, C) with coordinates ``obs_row``/``obs_pos`` (N,);
    entries outside the grid (padding carries ``obs_row == B``) are
    dropped. Coordinates of kept entries are unique.

    Returns (values, obs_mask, timeline_mask).
    """
    keep = (obs_row >= 0) & (obs_row < B) & (obs_pos >= 0) & (obs_pos < L)
    row, pos = obs_row[keep].long(), obs_pos[keep].long()
    grid = torch.full((B, C, L), float("nan"), dtype=obs_vals.dtype,
                      device=obs_vals.device)
    grid[row, :, pos] = obs_vals[keep]
    obs_mask = torch.zeros((B, L), dtype=torch.bool, device=obs_vals.device)
    obs_mask[row, pos] = True
    timeline_mask = (torch.arange(L, device=valid_len.device)[None, :]
                     < valid_len[:, None])
    return grid, obs_mask, timeline_mask


def interpolate_batch(values: torch.Tensor, obs_mask: torch.Tensor,
                      timeline_mask: torch.Tensor, strike: torch.Tensor,
                      is_call: torch.Tensor, method: str = "linear",
                      max_gap_minutes: int = 0, compute_greeks: bool = True,
                      extrapolate: bool = False,
                      obs_pos: torch.Tensor | None = None) -> dict:
    """Task 1: fill the minute grid of every symbol in the batch.

    Args:
      values: (B, C, L), C = :data:`ALL_COLS`.
      obs_mask / timeline_mask: (B, L) bools.
      strike: (B,) strike per symbol (NaN if unknown).
      is_call: (B,) bool per symbol.
      method: 'linear' | 'nearest' | 'ffill' | 'cubic'. 'cubic' needs
        ``obs_pos`` (B, k), the observations' grid positions with one
        count k for the batch, and NaN-free interpolated columns there.

    Returns a dict: ``filled`` (B, C, L); ``valid`` (B, L), rows with
    finite iv, underlying price and time to maturity inside the
    timeline; ``is_interpolated`` (B, L), valid rows with no
    observation; with ``compute_greeks``, ``greeks``, a dict of (B, L)
    tensors, NaN where an input is missing.
    """
    if method == "cubic":
        if obs_pos is None:
            raise ValueError("method='cubic' requires obs_pos")
        L = values.shape[-1]
        pos = obs_pos[:, None, :].expand(-1, _N_INTERP, -1)
        vals_at_obs = torch.gather(values[:, :_N_INTERP], -1, pos)
        interp_part = cubic_resample(pos, vals_at_obs, L)
        interp_part = torch.where(timeline_mask[:, None], interp_part,
                                  float("nan"))
    else:
        interp_part = masked_interp(values[:, :_N_INTERP], timeline_mask[:, None],
                                    method=method,
                                    max_gap_minutes=max_gap_minutes,
                                    extrapolate=extrapolate)
    ffill_part = masked_interp(values[:, _N_INTERP:], timeline_mask[:, None],
                               method="ffill")
    filled = torch.cat((interp_part, ffill_part), dim=1)

    valid = (timeline_mask & torch.isfinite(filled[:, _IV])
             & torch.isfinite(filled[:, _UP]) & torch.isfinite(filled[:, _TTM]))
    out = {"filled": filled, "valid": valid, "is_interpolated": valid & ~obs_mask}
    if compute_greeks:
        S, sigma, T = filled[:, _UP], filled[:, _IV], filled[:, _TTM]
        r = torch.nan_to_num(filled[:, _RATE], nan=0.0)
        K = strike[:, None]
        g = bs_greeks(S, K, torch.clamp_min(T, 1e-12), r,
                      torch.clamp_min(sigma, 1e-12), is_call[:, None])
        ok = valid & torch.isfinite(K) & (T > 0) & (sigma > 0)
        out["greeks"] = {name: torch.where(ok, arr, float("nan"))
                         for name, arr in g.items()}
    return out


def bridge_batch(filled: torch.Tensor, valid: torch.Tensor, keys: torch.Tensor,
                 params: BridgeParams = BridgeParams(),
                 price_col: torch.Tensor | None = None,
                 strategy: str = "spread_simulation",
                 abs_minutes: torch.Tensor | None = None) -> dict:
    """The bridge: interpolated grids -> synthetic 1-minute OHLCV grids.

    ``keys`` (B, 2) is each symbol's PRNG key; ``price_col`` (B,) the
    column of :data:`ALL_COLS` each symbol's price comes from (default
    underlying_price); ``abs_minutes`` (B, L) the grid rows' epoch
    minutes, on which the draws are keyed.
    """
    B, _, L = filled.shape
    if price_col is None:
        price_col = torch.full((B,), _UP, dtype=torch.int64, device=filled.device)
    base = torch.gather(filled, 1, price_col.long()[:, None, None].expand(B, 1, L))[:, 0]
    if abs_minutes is None:
        abs_minutes = torch.arange(L, device=filled.device).expand(B, L)
    return synthesize_ohlcv(base, filled[:, _VOLUME], valid, keys, params=params,
                            strategy=strategy, abs_minutes=abs_minutes)


def candles_batch(minutes: torch.Tensor, ohlcv: dict, bucket_minutes: int,
                  base_bucket: torch.Tensor, *, num_segments: int,
                  min_count: int) -> Candles:
    """Task 2: 1-minute -> ``bucket_minutes`` candles for every row.

    ``minutes`` (B, L) epoch minutes, time-sorted per row; ``ohlcv`` the
    bridge's dict of (B, L) grids; ``base_bucket`` (B,) the bucket id of
    each row's output slot 0.

    Runs kernel B2's wrapper: a CUDA batch launches the kernel on the
    int64 minutes as they are (float32 values only: other dtypes raise),
    a CPU batch runs its plain version in the values' dtype. The
    kernel takes one base bucket, so each row's minutes are shifted by
    ``base_bucket[b] * bucket_minutes`` and the call uses base 0, which is
    exact: floor((m - b k) / k) = floor(m / k) - b for integers.
    """
    shifted = minutes.long() - base_bucket.long()[:, None] * int(bucket_minutes)
    return aggregate_ohlcv_cuda(
        shifted, ohlcv["open"], ohlcv["high"], ohlcv["low"], ohlcv["close"],
        ohlcv["volume"], ohlcv["valid"], bucket_minutes=int(bucket_minutes),
        base_bucket=0, num_segments=num_segments, min_count=min_count)


def select_price_columns(values: torch.Tensor, obs_mask: torch.Tensor) -> torch.Tensor:
    """The reference's price-source priority rule: the first of
    underlying / mark / index price with >= 80 % of observed rows
    non-null, else the first with any data, else underlying.

    values: (B, C, L) raw (pre-fill) grids; obs_mask: (B, L).
    Returns (B,) int64 column indices into :data:`ALL_COLS`.
    """
    cols = torch.tensor([_UP, ALL_COLS.index("mark_price"),
                         ALL_COLS.index("index_price")], device=values.device)
    n_obs = obs_mask.sum(-1).clamp_min(1)
    fracs = torch.stack([(torch.isfinite(values[:, c]) & obs_mask).sum(-1).double()
                         / n_obs for c in cols.tolist()], dim=-1)   # (B, 3)
    good, any_data = fracs >= 0.8, fracs > 0.0
    first = lambda m: torch.argmax(m.to(torch.uint8), dim=-1)
    choice = torch.where(good.any(-1), first(good),
                         torch.where(any_data.any(-1), first(any_data), 0))
    return cols[choice]
