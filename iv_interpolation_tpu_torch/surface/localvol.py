"""Dupire local volatility and Breeden-Litzenberger risk-neutral density
from a fitted total-variance surface (port of
``iv_interpolation_tpu/surface/localvol.py``).

With w(k, T) total variance and Gatheral's butterfly function g(k)
(``surface.arbitrage.butterfly_g``, primes = d/dk), the Dupire local
variance in total-variance form is

    sigma_loc^2(k, T) = (dw/dT) / g(k)

and the risk-neutral density of log-moneyness is

    p(k) = g(k) / sqrt(2 pi w) * exp(-d_-^2 / 2),
    d_-(k) = -k / sqrt(w) - sqrt(w) / 2 .

Butterfly-freeness (g >= 0) and calendar-freeness (dw/dT >= 0) are
exactly the conditions for a real local vol and a non-negative density.
Everything is elementwise on the evaluated grid. The maturity derivative
follows ``eval_surface``: linear in total variance between slices, so
dw/dT is the backward difference of adjacent slices.
"""

from __future__ import annotations

import math

import torch


def _backward_dwdT(w_grid: torch.Tensor, expiries: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """THE maturity-derivative convention: slice i carries the backward
    derivative on (T_{i-1}, T_i], slice 0 uses (0, T_0] with w(k, 0) = 0.
    The validity mask and the local variance both read this one function."""
    T = expiries[..., None]                              # (..., E, 1)
    dT = T[..., 1:, :] - T[..., :-1, :]                  # (..., E-1, 1)
    dw = w_grid[..., 1:, :] - w_grid[..., :-1, :]
    fwd = dw / dT.clamp_min(eps)                         # (..., E-1, m)
    first = w_grid[..., :1, :] / T[..., :1, :].clamp_min(eps)
    return torch.cat([first, fwd], dim=-2)               # (..., E, m)


def local_variance_grid(w_grid: torch.Tensor, g: torch.Tensor,
                        expiries: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Dupire local variance on an evaluated ``(..., E, m)`` grid.

    Args:
      w_grid: (..., E, m) total variance (expiries ascending along -2).
      g: (..., E, m) butterfly function on the same grid.
      expiries: (..., E) maturities in years.
      eps: floor for g and dT (cells with g <= eps hold clamped values;
        mask them with ``g``).
    """
    return _backward_dwdT(w_grid, expiries, eps) / g.clamp_min(eps)


def risk_neutral_density(k_grid: torch.Tensor, w_grid: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """Breeden-Litzenberger density of log-moneyness per slice:
    p(k) = g(k) / sqrt(2 pi w) * exp(-d_-^2 / 2), d_- = -k/sqrt(w) - sqrt(w)/2.
    Non-negative iff g >= 0."""
    w = w_grid.clamp_min(1e-12)
    sqrt_w = torch.sqrt(w)
    d_minus = -k_grid / sqrt_w - sqrt_w / 2.0
    return g / torch.sqrt(2.0 * math.pi * w) * torch.exp(-0.5 * d_minus ** 2)


def variance_swap_strike(k_grid: torch.Tensor, w_grid: torch.Tensor,
                         g: torch.Tensor, expiries: torch.Tensor) -> torch.Tensor:
    """Model-free variance-swap fair strike per expiry (annualised):
    K_var T = -2 integral k p(k) dk over the evaluated grid (trapezoid),
    normalised by the captured mass. Returns (..., E)."""
    p = risk_neutral_density(k_grid, w_grid, g)
    dk = k_grid[..., 1:] - k_grid[..., :-1]
    mid = lambda a: 0.5 * (a[..., 1:] + a[..., :-1])
    mass = (mid(p) * dk).sum(dim=-1)
    mean_k = (mid(p * k_grid) * dk).sum(dim=-1) / mass.clamp_min(1e-12)
    return -2.0 * mean_k / expiries.clamp_min(1e-12)


def local_vol_surface(out: dict, eps: float = 1e-10, expiries=None) -> dict:
    """Local vol + density from a ``fit_eval_surface`` output dict.

    ``expiries`` defaults to ``out["fit"].expiries``. Returns:
      * ``local_var`` / ``local_vol`` (..., E, m): cells failing
        ``local_vol_valid`` hold eps-clamped values and must be masked;
      * ``local_vol_valid`` (..., E, m): g > eps and backward dw/dT >= 0;
      * ``local_vol_ok`` (...,): every cell valid;
      * ``density`` (..., E, m) Breeden-Litzenberger density;
      * ``var_swap`` (..., E) variance-swap strikes.
    """
    w_grid, g, k_grid = out["w_grid"], out["g"], out["k_grid"]
    if expiries is None:
        expiries = out["fit"].expiries
    dwdT = _backward_dwdT(w_grid, expiries, eps)
    lv = dwdT / g.clamp_min(eps)
    valid = (g > eps) & (dwdT >= 0.0)
    return {
        "local_var": lv,
        "local_vol": torch.sqrt(lv.clamp_min(0.0)),
        "density": risk_neutral_density(k_grid, w_grid, g),
        "var_swap": variance_swap_strike(k_grid, w_grid, g, expiries),
        "local_vol_ok": valid.flatten(-2).all(dim=-1),
        "local_vol_valid": valid,
    }
