"""Vol-surface fit and evaluation, spline paths (port of
``iv_interpolation_tpu/surface/surface.py``).

  1. per expiry, fit the smile in log-moneyness as total variance
     w(k) = iv^2 T with a cubic spline (knot curvatures from the Thomas
     kernel) or a smoothing spline (``ops.smoothing_spline``);
  2. evaluate each smile on a dense common k-grid;
  3. interpolate linearly in total variance across maturity at fixed k;
  4. report butterfly/calendar diagnostics on the evaluated grid.

Everything is batched over surfaces (leading dim B). SVI, eSSVI and SABR
are not ported yet and raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import torch

from iv_interpolation_tpu_torch.ops.cubic_spline import (
    eval_cubic_spline,
    eval_cubic_spline_deriv,
    eval_cubic_spline_second_deriv,
    fit_cubic_spline,
)
from iv_interpolation_tpu_torch.ops.smoothing_spline import fit_smoothing_spline
from iv_interpolation_tpu_torch.surface.arbitrage import arbitrage_flags, butterfly_g

_SPLINE_METHODS = ("cubic_spline", "smoothing_spline")
_NOT_PORTED = {"svi": "A5", "essvi": "A5", "sabr": "A5"}


def _check_method(method: str) -> None:
    if method in _SPLINE_METHODS:
        return
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"smile method {method!r} is not ported yet "
            f"(ROADMAP {_NOT_PORTED[method]})")
    raise ValueError(f"unknown smile method: {method!r}")


@dataclasses.dataclass(frozen=True)
class SurfaceFit:
    """Fitted surface state, batched over B.

      k: (B, E, n) log-moneyness knots
      expiries: (B, E) maturities (years, ascending)
      w: (B, E, n) total variance at the knots (the smoothed values for
        'smoothing_spline')
      coefs: (B, E, n) spline second derivatives
    """

    method: str
    k: torch.Tensor
    expiries: torch.Tensor
    w: torch.Tensor
    coefs: torch.Tensor


def fit_surface(k: torch.Tensor, iv: torch.Tensor, expiries: torch.Tensor,
                method: str = "cubic_spline",
                spline_bc: str = "natural",
                smoothing_lam: float = 0.0) -> SurfaceFit:
    """Fit a batch of vol surfaces.

    Args:
      k: (B, E, n) log-moneyness of quotes per expiry (ascending in n).
      iv: (B, E, n) implied vols.
      expiries: (B, E) maturities in years (ascending in E).
      method: 'cubic_spline' or 'smoothing_spline'.
      spline_bc: 'cubic_spline' boundary condition, 'natural' |
        'not-a-knot' | 'clamped'; 'not-a-knot' keeps the butterfly
        diagnostics free of the natural-BC edge artifact.
      smoothing_lam: curvature penalty of 'smoothing_spline'.
    """
    _check_method(method)
    w = iv * iv * expiries[..., None]
    if method == "smoothing_spline":
        fit = fit_smoothing_spline(k, w, smoothing_lam)
        return SurfaceFit(method=method, k=k, expiries=expiries, w=fit.g, coefs=fit.M)
    return SurfaceFit(method=method, k=k, expiries=expiries, w=w,
                      coefs=fit_cubic_spline(k, w, bc_type=spline_bc))


def common_support_grid(k: torch.Tensor, n_grid: int) -> torch.Tensor:
    """Dense eval grid on the common strike support across expiries:
    k (..., E, n) -> (..., E, n_grid) spanning [max k[..., 0], min k[..., -1]].

    When the supports do not overlap, the grid spans the gap between them
    instead (ascending either way). The unit steps are computed as the
    reference's float64 ``linspace(0, 1, n_grid)`` computes them,
    ``i * (1 / (n_grid - 1))`` with the end point exactly 1, and then cast
    to k's dtype, so the grid lands on the reference's values bit for bit.
    """
    k_lo = k[..., 0].amax(dim=-1)
    k_hi = k[..., -1].amin(dim=-1)
    lo = torch.minimum(k_lo, k_hi)
    hi = torch.maximum(k_lo, k_hi)
    steps = torch.arange(n_grid, dtype=torch.float64, device=k.device)
    if n_grid > 1:
        steps = steps * (1.0 / (n_grid - 1))
        steps[-1:].fill_(1.0)
    span = (hi - lo)[..., None] * steps.to(k.dtype) + lo[..., None]
    return span[..., None, :].expand(*k.shape[:-1], n_grid)


def eval_surface(fit: SurfaceFit, k_q: torch.Tensor,
                 T_q: torch.Tensor) -> torch.Tensor:
    """Total variance at (B, Q) query points (k_q, T_q).

    Linear in total variance between the bracketing slices at fixed k;
    flat (the first/last slice) outside the expiry range.
    """
    _check_method(fit.method)
    E = fit.expiries.shape[-1]
    if E > 2:
        ge = (T_q[..., :, None] >= fit.expiries[..., None, 1:-1]).sum(dim=-1)
        lo = ge.clamp(0, E - 2)
    else:
        lo = torch.zeros(T_q.shape, dtype=torch.int64, device=T_q.device)
    T0 = torch.gather(fit.expiries, -1, lo)
    T1 = torch.gather(fit.expiries, -1, lo + 1)
    n = fit.k.shape[-1]

    def eval_at(slice_idx):
        # the bracketing slice's knots per query: (B, Q, n)
        idx = slice_idx[..., :, None].expand(*slice_idx.shape, n)
        k_s, w_s, c_s = (torch.gather(a, -2, idx)
                         for a in (fit.k, fit.w, fit.coefs))
        return eval_cubic_spline(k_s, w_s, c_s, k_q[..., :, None])[..., 0]

    w0 = eval_at(lo)
    w1 = eval_at(lo + 1)
    t = ((T_q - T0) / (T1 - T0).clamp_min(1e-12)).clamp(0.0, 1.0)
    return w0 * (1.0 - t) + w1 * t


def fit_eval_surface(k: torch.Tensor, iv: torch.Tensor, expiries: torch.Tensor,
                     method: str = "cubic_spline", n_grid: int = 50,
                     spline_bc: str = "natural",
                     smoothing_lam: float = 0.0,
                     quote_mask: torch.Tensor | None = None) -> dict:
    """Fit + dense-grid eval + arbitrage diagnostics.

    Returns a dict with ``fit``, the evaluated ``k_grid``/``w_grid``/
    ``iv_grid`` (B, E, n_grid), the butterfly function ``g`` on the grid,
    per-surface ``butterfly_ok`` / ``calendar_ok`` flags, and ``fit_rmse``
    (B,): total-variance RMSE of the fitted smiles at the input quotes,
    restricted to ``quote_mask`` (B, E, n) when given (0 up to rounding
    for the interpolating cubic spline).
    """
    fit = fit_surface(k, iv, expiries, method=method, spline_bc=spline_bc,
                      smoothing_lam=smoothing_lam)
    k_grid = common_support_grid(k, n_grid)
    knots = (fit.k, fit.w, fit.coefs)
    w_grid = eval_cubic_spline(*knots, k_grid)
    # butterfly g from the closed-form w' and w''
    g = butterfly_g(k_grid, w_grid, eval_cubic_spline_deriv(*knots, k_grid),
                    eval_cubic_spline_second_deriv(*knots, k_grid))
    iv_grid = torch.sqrt(w_grid.clamp_min(0.0)
                         / fit.expiries[..., None].clamp_min(1e-12))
    butterfly_ok, calendar_ok = arbitrage_flags(w_grid, g)
    w_obs = iv * iv * expiries[..., None]
    err2 = (eval_cubic_spline(*knots, k) - w_obs) ** 2
    if quote_mask is not None:
        m_ = quote_mask.to(err2.dtype)
        fit_rmse = torch.sqrt((err2 * m_).sum(dim=(-2, -1))
                              / m_.sum(dim=(-2, -1)).clamp_min(1.0))
    else:
        fit_rmse = torch.sqrt(err2.mean(dim=(-2, -1)))
    return {
        "fit": fit,
        "k_grid": k_grid,
        "w_grid": w_grid,
        "iv_grid": iv_grid,
        "g": g,
        "butterfly_ok": butterfly_ok,
        "calendar_ok": calendar_ok,
        "fit_rmse": fit_rmse,
    }
