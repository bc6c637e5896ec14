"""Greek surfaces: Black-Scholes risk grids from fitted vol surfaces (port
of ``iv_interpolation_tpu/surface/greeks.py``).

A fitted surface evaluates straight into price and Greek grids, the risk
view a desk consumes.
"""

from __future__ import annotations

import torch

from iv_interpolation_tpu_torch.ops.black_scholes import bs_greeks, bs_price


def greek_surfaces(k_grid: torch.Tensor, iv_grid: torch.Tensor,
                   expiries: torch.Tensor, spot: torch.Tensor,
                   rate, is_call=True) -> dict:
    """Price + Greeks on an evaluated surface grid.

    Args:
      k_grid: (..., E, m) log-moneyness grid (from ``fit_eval_surface``).
      iv_grid: (..., E, m) implied vols on the grid.
      expiries: (..., E) maturities in years.
      spot: (...,) underlying price per surface.
      rate: (...,) or scalar risk-free rate.
      is_call: bool or bool tensor broadcastable to the grid.

    Returns a dict of (..., E, m) grids: price, delta, gamma, theta (per
    day), vega (per 1 %), rho (per 1 %), in the unit conventions of
    ``ops.black_scholes``.
    """
    device = iv_grid.device
    S = spot[..., None, None]
    K = S * torch.exp(k_grid)
    T = expiries[..., None].clamp_min(1e-12)
    # a Python number takes the grid's dtype, not torch's default
    r = (rate.to(device) if isinstance(rate, torch.Tensor)
         else torch.as_tensor(rate, dtype=iv_grid.dtype, device=device))
    if r.dim():
        r = r[..., None, None]
    is_call = torch.as_tensor(is_call, dtype=torch.bool, device=device)
    sigma = iv_grid.clamp_min(1e-12)
    out = bs_greeks(S, K, T, r, sigma, is_call)
    out["price"] = bs_price(S, K, T, r, sigma, is_call)
    return out
