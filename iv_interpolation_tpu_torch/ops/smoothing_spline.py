"""Penalized (smoothing) cubic splines for noisy smiles (port of
``iv_interpolation_tpu/ops/smoothing_spline.py``).

The smoothing spline minimises

    sum_i (y_i - f(x_i))^2 + lam * int f''(t)^2 dt

whose minimiser (Green & Silverman / Reinsch) is a natural cubic spline
with interior curvatures gamma solving

    (R + lam * Q^T Q) gamma = Q^T y,      g = y - lam * Q gamma

with R tridiagonal and Q the second-difference operator. Batched here
with dense (n-2)^2 solves (``torch.linalg.solve``), as the reference
does outside any kernel: at smile sizes (n ~ 50) the banded structure
buys nothing.

Parity oracle: ``scipy.interpolate.make_smoothing_spline`` with explicit
``lam``. lam = 0 recovers the interpolating natural spline. The
reference's fused fit+eval and its per-slice penalty search
(``fit_smoothing_spline_autolam``) have no caller in either package and
are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from iv_interpolation_tpu_torch.ops.cubic_spline import eval_cubic_spline


class SmoothingFit(NamedTuple):
    x: torch.Tensor   # (..., n) knots
    g: torch.Tensor   # (..., n) fitted (smoothed) values
    M: torch.Tensor   # (..., n) second derivatives (natural BCs)


def fit_smoothing_spline(x: torch.Tensor, y: torch.Tensor, lam) -> SmoothingFit:
    """Fit smoothing splines over the trailing axis (batched).

    Args:
      x: (..., n) strictly increasing sites.
      y: (..., n) noisy observations.
      lam: smoothness weight (scalar or (...,) per problem).
    """
    x, y = torch.broadcast_tensors(x, y)
    n = x.shape[-1]
    if n < 3:
        raise ValueError("smoothing spline needs >= 3 points")
    lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device)[..., None, None]
    h = torch.diff(x, dim=-1)                         # (..., n-1)
    batch = tuple(x.shape[:-1])
    m = n - 2
    i = torch.arange(m, device=x.device)
    R = x.new_zeros(batch + (m, m))
    R[..., i, i] = (h[..., :-1] + h[..., 1:]) / 3.0
    R[..., i[:-1], i[:-1] + 1] = h[..., 1:-1] / 6.0
    R[..., i[:-1] + 1, i[:-1]] = h[..., 1:-1] / 6.0
    # Q (n, m): column j has entries at rows j, j+1, j+2
    Q = x.new_zeros(batch + (n, m))
    Q[..., i, i] = 1.0 / h[..., :-1]
    Q[..., i + 1, i] = -1.0 / h[..., :-1] - 1.0 / h[..., 1:]
    Q[..., i + 2, i] = 1.0 / h[..., 1:]

    QtQ = torch.einsum("...nm,...nk->...mk", Q, Q)
    Qty = torch.einsum("...nm,...n->...m", Q, y)
    gamma = torch.linalg.solve(R + lam * QtQ, Qty[..., None])[..., 0]
    g = y - lam[..., 0, 0, None] * torch.einsum("...nm,...m->...n", Q, gamma)
    zero = x.new_zeros(batch + (1,))
    return SmoothingFit(x=x, g=g, M=torch.cat([zero, gamma, zero], dim=-1))


def eval_smoothing_spline(fit: SmoothingFit, t: torch.Tensor) -> torch.Tensor:
    """Evaluate the fitted smoothing spline at (..., q) query points."""
    return eval_cubic_spline(fit.x, fit.g, fit.M, t)
