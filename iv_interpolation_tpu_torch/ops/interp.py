"""Masked timeline interpolation, the Task-1 compute core (port of
``iv_interpolation_tpu/ops/interp.py``).

Observations sit on a fixed-length minute grid (NaN where none landed);
filling is index arithmetic over the grid's last axis:

  * ``prev_idx[i]`` = last valid slot <= i   (``cummax``)
  * ``next_idx[i]`` = first valid slot >= i  (``cummin`` of the flipped grid)

Pandas-parity semantics, as in the reference: interior gaps are linear by
grid position, leading gaps stay NaN, trailing gaps hold the last value;
``max_gap_minutes`` leaves gaps wider than it NaN; ``extrapolate`` extends
the first and last segments' lines instead.
"""

from __future__ import annotations

import torch

from iv_interpolation_tpu_torch.ops.cubic_spline import eval_cubic_spline, fit_cubic_spline


def _prev_next_valid(valid: torch.Tensor):
    """(prev_idx, next_idx) along the last axis: prev_idx[i] is the largest
    j <= i with valid[j] (or -1), next_idx[i] the smallest j >= i (or L)."""
    L = valid.shape[-1]
    iota = torch.arange(L, device=valid.device)
    prev_idx = torch.cummax(torch.where(valid, iota, -1), dim=-1).values
    rev = torch.where(valid, iota, L).flip(-1)
    next_idx = torch.cummin(rev, dim=-1).values.flip(-1)
    return prev_idx, next_idx


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(a, idx, -1)`` with broadcasting of the lead axes."""
    shape = torch.broadcast_shapes(a.shape[:-1], idx.shape[:-1])
    return torch.gather(a.expand(*shape, a.shape[-1]), -1,
                        idx.expand(*shape, idx.shape[-1]))


def masked_interp(values: torch.Tensor, timeline_mask: torch.Tensor,
                  method: str = "linear", max_gap_minutes: int = 0,
                  extrapolate: bool = False) -> torch.Tensor:
    """Fill NaNs in ``values`` along the last (timeline) axis.

    Args:
      values: ``(..., L)`` float tensor; NaN marks missing samples.
      timeline_mask: ``(..., L)`` bool, broadcastable; False marks padding
        beyond the symbol's timeline (those slots stay NaN).
      method: 'linear' | 'nearest' | 'ffill'.
      max_gap_minutes: if > 0, grid points bracketed by observations more
        than this many grid steps apart stay NaN.
      extrapolate: with 'linear', extend the first and last segments'
        lines beyond the first and last valid samples (constant when only
        one exists). Default False: leading gaps stay NaN, trailing gaps
        hold the last value.
    """
    if method not in ("linear", "nearest", "ffill"):
        raise ValueError(f"unknown interpolation method: {method!r}")
    L = values.shape[-1]
    dtype = values.dtype
    iota = torch.arange(L, device=values.device)
    valid = torch.isfinite(values) & timeline_mask
    prev_idx, next_idx = _prev_next_valid(valid)

    has_prev = prev_idx >= 0
    has_next = next_idx < L
    # the gap check sees real neighbours only: extrapolation fabricates
    # has_prev for the head region
    real_has_prev, real_has_next = has_prev, has_next
    prev_c = prev_idx.clamp(0, L - 1)
    next_c = next_idx.clamp(0, L - 1)
    zeros = torch.where(valid, values, torch.zeros((), dtype=dtype, device=values.device))
    prev_val = _take(zeros, prev_c)
    next_val = _take(zeros, next_c)

    if method == "linear":
        span = (next_idx - prev_idx).to(dtype)
        w = torch.where(span > 0, (iota - prev_idx).to(dtype)
                        / torch.where(span > 0, span, 1.0), 0.0)
        interior = prev_val * (1.0 - w) + next_val * w
        filled = torch.where(has_next, interior, prev_val)  # trailing: hold last
        if extrapolate:
            def slope(i1, i2):
                v1 = _take(zeros, i1.clamp(0, L - 1))
                v2 = _take(zeros, i2.clamp(0, L - 1))
                ok2 = (i2 > i1) & (i2 < L) & (i1 >= 0)
                di = torch.where(ok2, (i2 - i1).to(dtype), 1.0)
                return torch.where(ok2, (v2 - v1) / di, 0.0)

            # head: line anchored at the first valid sample, sloped through
            # the second
            i1h = next_idx[..., 0:1]
            i2h = _take(next_idx, (i1h + 1).clamp(0, L - 1))
            v1h = _take(zeros, i1h.clamp(0, L - 1))
            head = v1h + slope(i1h, i2h) * (iota - i1h).to(dtype)
            # tail: anchored at the last valid sample
            i2t = prev_idx[..., L - 1:L]
            i1t = _take(prev_idx, (i2t - 1).clamp(0, L - 1))
            v2t = _take(zeros, i2t.clamp(0, L - 1))
            tail = v2t + slope(i1t, i2t) * (iota - i2t).to(dtype)
            filled = torch.where(has_prev, filled, head)
            filled = torch.where(has_next | ~has_prev, filled, tail)
            # the extrapolated head counts as having a previous sample
            has_prev = has_prev | (i1h < L)
    elif method == "nearest":
        take_next = has_next & (~has_prev | ((next_idx - iota) < (iota - prev_idx)))
        filled = torch.where(take_next, next_val, prev_val)
    else:
        filled = prev_val

    nan = torch.full((), float("nan"), dtype=dtype, device=values.device)
    if max_gap_minutes > 0:
        too_wide = (~valid & real_has_prev & real_has_next
                    & ((next_idx - prev_idx) > max_gap_minutes))
        filled = torch.where(too_wide, nan, filled)

    filled = torch.where(has_prev & timeline_mask, filled, nan)
    return torch.where(valid, values, filled)


def ffill(values: torch.Tensor, timeline_mask: torch.Tensor) -> torch.Tensor:
    """Forward-fill along the last axis (the reference's categorical and
    rate columns)."""
    return masked_interp(values, timeline_mask, method="ffill")


def scatter_observations(obs_pos: torch.Tensor, obs_vals: torch.Tensor,
                         obs_valid: torch.Tensor, timeline_len: int) -> torch.Tensor:
    """Scatter ragged observations onto a dense timeline grid.

    Args:
      obs_pos: ``(K,)`` int grid positions; out-of-range or invalid entries
        must have ``obs_valid`` False.
      obs_vals: ``(..., K)`` values per observation.
      obs_valid: ``(K,)`` bool.
      timeline_len: grid length L.

    Returns the ``(..., L)`` grid, NaN where no observation landed. Of
    several valid observations at one position the last one wins,
    deterministically: the winner is the scatter-max of the observation
    index, and only winners write.
    """
    K = obs_pos.shape[-1]
    pos = torch.where(obs_valid, obs_pos.long(), timeline_len)  # park invalid at L
    order = torch.arange(K, device=obs_pos.device)
    winner = torch.full((timeline_len + 1,), -1, dtype=torch.int64,
                        device=obs_pos.device)
    winner.scatter_reduce_(0, pos, order, "amax")
    keep = obs_valid & (winner[pos] == order)
    pos_w = torch.where(keep, pos, timeline_len)
    nan = torch.full((), float("nan"), dtype=obs_vals.dtype, device=obs_vals.device)
    grid = torch.full(obs_vals.shape[:-1] + (timeline_len + 1,), float("nan"),
                      dtype=obs_vals.dtype, device=obs_vals.device)
    src = torch.where(keep, obs_vals, nan)
    grid.scatter_(-1, pos_w.expand_as(src), src)
    return grid[..., :timeline_len]


def cubic_resample(obs_pos: torch.Tensor, obs_vals: torch.Tensor,
                   timeline_len: int) -> torch.Tensor:
    """Batched not-a-knot cubic-spline resampling onto a dense grid
    (pandas ``Series.interpolate(method='cubic')``).

    ``obs_pos`` ``(..., k)`` strictly increasing grid positions and
    ``obs_vals`` ``(..., k)`` values, k uniform across the batch. Grid
    points outside ``[obs_pos[0], obs_pos[-1]]`` stay NaN. The knot
    curvatures are solved by ``fit_cubic_spline``, so CUDA tensors launch
    the Thomas kernel.
    """
    x = obs_pos.to(obs_vals.dtype)
    M = fit_cubic_spline(x, obs_vals, bc_type="not-a-knot")
    t = torch.arange(timeline_len, dtype=obs_vals.dtype, device=obs_vals.device)
    t = t.expand(*obs_vals.shape[:-1], timeline_len)
    S = eval_cubic_spline(x, obs_vals, M, t)
    inside = (t >= x[..., 0:1]) & (t <= x[..., -1:])
    return torch.where(inside, S, torch.full((), float("nan"), dtype=S.dtype,
                                             device=S.device))
