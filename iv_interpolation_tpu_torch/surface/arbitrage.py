"""No-arbitrage diagnostics on evaluated surface grids (port of
``iv_interpolation_tpu/surface/arbitrage.py``).

  * Butterfly (static): Gatheral's g on a total-variance slice w(k):
    g(k) = (1 - k w'/(2w))^2 - (w'^2/4)(1/w + 1/4) + w''/2 >= 0.
  * Calendar: total variance non-decreasing in maturity at fixed k.
"""

from __future__ import annotations

import torch


def butterfly_g(k: torch.Tensor, w: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """g(k) for a total-variance slice given w, w' and w'' on a k-grid
    (broadcastable ``(..., m)``). g >= 0 everywhere <=> no butterfly
    arbitrage."""
    w_safe = w.clamp_min(1e-12)
    u = 1.0 - k * w1 / (2.0 * w_safe)
    t1 = u * u
    t2 = (w1 * w1 / 4.0) * (1.0 / w_safe + 0.25)
    return t1 - t2 + w2 / 2.0


def arbitrage_flags(w_grid: torch.Tensor, g: torch.Tensor):
    """Per-surface (butterfly_ok, calendar_ok) of an evaluated
    ``(..., E, m)`` grid and its g.

    Tolerances are 1024 ulps of the grid's dtype, floored at 1e-10 (g) and
    1e-12 (w): a fixed tolerance would sit below float32 evaluation noise,
    and the floors keep float64 at the reference's constants.
    """
    eps = torch.finfo(w_grid.dtype).eps
    tol_g, tol_w = max(1024.0 * eps, 1e-10), max(1024.0 * eps, 1e-12)
    butterfly_ok = (g >= -tol_g).flatten(-2).all(dim=-1)
    calendar_ok = (w_grid[..., 1:, :] >= w_grid[..., :-1, :] - tol_w
                   ).flatten(-2).all(dim=-1)
    return butterfly_ok, calendar_ok


def butterfly_g_fd(k: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g(k) with finite-difference derivatives (uniform interior grid
    assumed; the end points copy their neighbours)."""
    dk = k[..., 1:] - k[..., :-1]
    w1_mid = (w[..., 1:] - w[..., :-1]) / dk
    w1 = torch.cat([w1_mid[..., :1],
                    (w1_mid[..., 1:] + w1_mid[..., :-1]) / 2.0,
                    w1_mid[..., -1:]], dim=-1)
    w2_int = (w1_mid[..., 1:] - w1_mid[..., :-1]) \
        / ((dk[..., 1:] + dk[..., :-1]) / 2.0)
    w2 = torch.cat([w2_int[..., :1], w2_int, w2_int[..., -1:]], dim=-1)
    return butterfly_g(k, w, w1, w2)


def calendar_violations(w_grid: torch.Tensor, tol: float = 0.0) -> torch.Tensor:
    """Count calendar-arbitrage violations on a ``(..., E, m)`` grid of
    total variance (expiries ascending along axis -2)."""
    dec = w_grid[..., 1:, :] < (w_grid[..., :-1, :] - tol)
    return dec.sum(dim=(-2, -1))


def check_surface_arbitrage(k_grid: torch.Tensor, w_grid: torch.Tensor) -> dict:
    """Per-surface butterfly violation count, worst g, calendar violation
    count and worst calendar gap on an evaluated ``(..., E, m)`` grid."""
    g = butterfly_g_fd(k_grid, w_grid)
    return {
        "butterfly_violations": (g < 0).sum(dim=(-2, -1)),
        "worst_g": g.amin(dim=(-2, -1)),
        "calendar_violations": calendar_violations(w_grid),
        "worst_calendar_gap": (w_grid[..., 1:, :] - w_grid[..., :-1, :]).amin(
            dim=(-2, -1)),
    }
