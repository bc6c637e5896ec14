"""Vol-surface fit and evaluation (port of
``iv_interpolation_tpu/surface/surface.py``).

  1. per expiry, fit the smile in log-moneyness as total variance
     w(k) = iv^2 T: a cubic spline (knot curvatures from the Thomas
     kernel), a smoothing spline (``ops.smoothing_spline``), raw SVI or
     SABR slices by batched Levenberg-Marquardt (``ops.svi``,
     ``ops.sabr``), or one joint eSSVI surface (``ops.essvi``);
  2. evaluate each smile on a dense common k-grid;
  3. interpolate linearly in total variance across maturity at fixed k;
  4. report butterfly/calendar diagnostics on the evaluated grid.

Everything is batched over surfaces (leading dim B).
"""

from __future__ import annotations

import dataclasses

import torch

from iv_interpolation_tpu_torch.monitoring.metrics import span
from iv_interpolation_tpu_torch.ops.cubic_spline import (
    eval_cubic_spline,
    eval_cubic_spline_deriv,
    eval_cubic_spline_second_deriv,
    fit_cubic_spline,
)
from iv_interpolation_tpu_torch.ops.essvi import essvi_g, essvi_w, fit_essvi_batched
from iv_interpolation_tpu_torch.ops.sabr import fit_sabr_batched, sabr_vol
from iv_interpolation_tpu_torch.ops.smoothing_spline import fit_smoothing_spline
from iv_interpolation_tpu_torch.ops.svi import (
    fit_svi_batched,
    svi_g,
    svi_total_variance,
    vega_weights,
)
from iv_interpolation_tpu_torch.surface.arbitrage import (
    arbitrage_flags,
    butterfly_g,
    butterfly_g_fd,
)

_SPLINE_METHODS = ("cubic_spline", "smoothing_spline")
_METHODS = _SPLINE_METHODS + ("svi", "essvi", "sabr")


@dataclasses.dataclass(frozen=True)
class SurfaceFit:
    """Fitted surface state, batched over B.

      k: (B, E, n) log-moneyness knots
      expiries: (B, E) maturities (years, ascending)
      w: (B, E, n) total variance at the knots (the smoothed values for
        'smoothing_spline')
      coefs: splines -> (B, E, n) second derivatives; svi -> (B, E, 5)
        (a, b, rho, m, sigma); essvi -> (B, E, 3) (theta, rho, psi);
        sabr -> (B, E, 4) (alpha, beta, rho, nu) on the forward-normalised
        axis (K = e^k, F = 1)
    """

    method: str
    k: torch.Tensor
    expiries: torch.Tensor
    w: torch.Tensor
    coefs: torch.Tensor


def _fit_slices(k, w, expiries, method: str, svi_iters: int = 64,
                svi_butterfly_penalty: float = 0.0,
                svi_weighting: str = "uniform",
                smoothing_lam: float = 0.0,
                spline_bc: str = "natural",
                svi_loss: str = "linear",
                svi_huber_delta: float = 1e-3):
    """Returns (knot values used by eval, coefficients). For
    'smoothing_spline' the knot values are the smoothed fit, not the
    observations."""
    if method == "cubic_spline":
        return w, fit_cubic_spline(k, w, bc_type=spline_bc)
    if method == "smoothing_spline":
        fit = fit_smoothing_spline(k, w, smoothing_lam)
        return fit.g, fit.M
    if method == "svi":
        weights = vega_weights(k, w) if svi_weighting == "vega" else None
        return w, fit_svi_batched(
            k, w, weights=weights, max_iters=svi_iters,
            butterfly_penalty=svi_butterfly_penalty, loss=svi_loss,
            huber_delta=svi_huber_delta).params
    if method == "essvi":
        weights = vega_weights(k, w) if svi_weighting == "vega" else None
        # one joint 3E-parameter LM per surface: theta increasing and the
        # slices butterfly-free by construction (ops.essvi)
        return w, fit_essvi_batched(
            k, w, weights=weights, max_iters=svi_iters, loss=svi_loss,
            huber_delta=svi_huber_delta).params
    if method == "sabr":
        # strikes on the forward-normalised axis: K = e^k, F = 1
        T = expiries[..., None]
        iv = torch.sqrt(w.clamp_min(1e-12) / T.clamp_min(1e-12))
        fit = fit_sabr_batched(torch.exp(k), iv, torch.ones_like(expiries),
                               expiries, max_iters=svi_iters)
        return w, fit.params
    raise ValueError(f"unknown smile method: {method!r}")


def fit_surface(k: torch.Tensor, iv: torch.Tensor, expiries: torch.Tensor,
                method: str = "cubic_spline", svi_iters: int = 64,
                svi_butterfly_penalty: float = 0.0,
                svi_weighting: str = "uniform",
                smoothing_lam: float = 0.0,
                svi_unroll: bool = False,
                spline_bc: str = "natural",
                svi_loss: str = "linear",
                svi_huber_delta: float = 1e-3) -> SurfaceFit:
    """Fit a batch of vol surfaces.

    Args:
      k: (B, E, n) log-moneyness of quotes per expiry (ascending in n).
      iv: (B, E, n) implied vols.
      expiries: (B, E) maturities in years (ascending in E).
      method: smile parameterisation ('cubic_spline' | 'smoothing_spline'
        | 'svi' | 'essvi' | 'sabr'). 'essvi' fits one joint surface per
        batch element (increasing ATM variance and butterfly-free slices
        by construction, see ``ops.essvi``).
      svi_iters, svi_butterfly_penalty, svi_weighting ('uniform' | 'vega'),
        svi_loss ('linear' | 'huber'), svi_huber_delta: the LM iteration
        count, SVI's hinge on negative g, the residual weights and the
        loss of the calibrated families.
      svi_unroll: accepted for the reference's signature and ignored: it
        inlines the reference's on-device loop for its compiler, and the
        loop here is a Python loop of eager launches either way.
      spline_bc: 'cubic_spline' boundary condition, 'natural' |
        'not-a-knot' | 'clamped'; 'not-a-knot' keeps the butterfly
        diagnostics free of the natural-BC edge artifact.
      smoothing_lam: curvature penalty of 'smoothing_spline'.
    """
    del svi_unroll
    w = iv * iv * expiries[..., None]
    w_fit, coefs = _fit_slices(k, w, expiries, method, svi_iters,
                               svi_butterfly_penalty, svi_weighting,
                               smoothing_lam, spline_bc, svi_loss,
                               svi_huber_delta)
    return SurfaceFit(method=method, k=k, expiries=expiries, w=w_fit, coefs=coefs)


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


def _eval_slices(fit: SurfaceFit, k_grid: torch.Tensor) -> torch.Tensor:
    """Evaluate every fitted slice at (B, E, m) query log-moneyness."""
    if fit.method in _SPLINE_METHODS:
        return eval_cubic_spline(fit.k, fit.w, fit.coefs, k_grid)
    if fit.method == "sabr":
        iv = sabr_vol(fit.coefs, torch.ones_like(fit.expiries),
                      torch.exp(k_grid), fit.expiries)
        return iv * iv * fit.expiries[..., None]
    if fit.method == "essvi":
        return essvi_w(fit.coefs, k_grid)
    if fit.method == "svi":
        return svi_total_variance(fit.coefs, k_grid)
    raise ValueError(f"unknown smile method: {fit.method!r}")


def _slice_derivs(fit: SurfaceFit, k_grid: torch.Tensor):
    """(w', w'') of the spline slices at (B, E, m) query log-moneyness;
    None for the calibrated families, whose g needs no evaluated
    derivatives."""
    if fit.method not in _SPLINE_METHODS:
        return None
    knots = (fit.k, fit.w, fit.coefs)
    return (eval_cubic_spline_deriv(*knots, k_grid),
            eval_cubic_spline_second_deriv(*knots, k_grid))


def _slice_g(fit: SurfaceFit, k_grid: torch.Tensor, w_grid: torch.Tensor,
             derivs) -> torch.Tensor:
    """Butterfly g on the evaluated slices, closed-form where available;
    ``derivs`` is :func:`_slice_derivs`' result on the same grid."""
    if fit.method in _SPLINE_METHODS:
        return butterfly_g(k_grid, w_grid, *derivs)
    if fit.method == "svi":
        return svi_g(fit.coefs, k_grid)
    if fit.method == "essvi":
        return essvi_g(fit.coefs, k_grid)
    return butterfly_g_fd(k_grid, w_grid)


def eval_surface(fit: SurfaceFit, k_q: torch.Tensor,
                 T_q: torch.Tensor) -> torch.Tensor:
    """Total variance at (B, Q) query points (k_q, T_q).

    Linear in total variance between the bracketing slices at fixed k;
    flat (the first/last slice) outside the expiry range.
    """
    if fit.method not in _METHODS:
        raise ValueError(f"unknown smile method: {fit.method!r}")
    E = fit.expiries.shape[-1]
    if E > 2:
        ge = (T_q[..., :, None] >= fit.expiries[..., None, 1:-1]).sum(dim=-1)
        lo = ge.clamp(0, E - 2)
    else:
        lo = torch.zeros(T_q.shape, dtype=torch.int64, device=T_q.device)
    T0 = torch.gather(fit.expiries, -1, lo)
    T1 = torch.gather(fit.expiries, -1, lo + 1)

    def rows(a, slice_idx):
        # the bracketing slice's row of a (B, E, c) array per query: (B, Q, c)
        return torch.gather(a, -2, slice_idx[..., :, None].expand(
            *slice_idx.shape, a.shape[-1]))

    def eval_at(slice_idx):
        # each query is a one-point slice of its own: (B, Q, 1)
        one = SurfaceFit(method=fit.method, k=rows(fit.k, slice_idx),
                         expiries=torch.gather(fit.expiries, -1, slice_idx),
                         w=rows(fit.w, slice_idx), coefs=rows(fit.coefs, slice_idx))
        return _eval_slices(one, k_q[..., :, None])[..., 0]

    w0 = eval_at(lo)
    w1 = eval_at(lo + 1)
    t = ((T_q - T0) / (T1 - T0).clamp_min(1e-12)).clamp(0.0, 1.0)
    return w0 * (1.0 - t) + w1 * t


def fit_eval_surface(k: torch.Tensor, iv: torch.Tensor, expiries: torch.Tensor,
                     method: str = "cubic_spline", n_grid: int = 50,
                     svi_iters: int = 64,
                     svi_butterfly_penalty: float = 0.0,
                     svi_weighting: str = "uniform",
                     smoothing_lam: float = 0.0,
                     svi_unroll: bool = False,
                     spline_bc: str = "natural",
                     svi_loss: str = "linear",
                     svi_huber_delta: float = 1e-3,
                     quote_mask: torch.Tensor | None = None) -> dict:
    """Fit + dense-grid eval + arbitrage diagnostics.

    Returns a dict with ``fit``, the evaluated ``k_grid``/``w_grid``/
    ``iv_grid`` (B, E, n_grid), the butterfly function ``g`` on the grid,
    per-surface ``butterfly_ok`` / ``calendar_ok`` flags, and ``fit_rmse``
    (B,): total-variance RMSE of the fitted smiles at the input quotes,
    restricted to ``quote_mask`` (B, E, n) when given (0 up to rounding
    for the interpolating cubic spline; the serving quality gate of the
    svi, essvi, sabr and smoothing fits). The other arguments are
    :func:`fit_surface`'s.

    The stages are the spans ``iv.surface.fit``, ``.grid``, ``.eval``
    (w, and w' and w'' for the splines), ``.diagnostics`` (g, iv and the
    flags) and ``.fit_rmse``, disjoint and covering the call.
    """
    with span("iv.surface.fit"):
        fit = fit_surface(k, iv, expiries, method=method, svi_iters=svi_iters,
                          svi_butterfly_penalty=svi_butterfly_penalty,
                          svi_weighting=svi_weighting, smoothing_lam=smoothing_lam,
                          svi_unroll=svi_unroll, spline_bc=spline_bc,
                          svi_loss=svi_loss, svi_huber_delta=svi_huber_delta)
    with span("iv.surface.grid"):
        k_grid = common_support_grid(k, n_grid)
    with span("iv.surface.eval"):
        w_grid = _eval_slices(fit, k_grid)
        derivs = _slice_derivs(fit, k_grid)
    with span("iv.surface.diagnostics"):
        g = _slice_g(fit, k_grid, w_grid, derivs)
        del derivs      # w' and w'' are not held through the rest of the call
        iv_grid = torch.sqrt(w_grid.clamp_min(0.0)
                             / fit.expiries[..., None].clamp_min(1e-12))
        butterfly_ok, calendar_ok = arbitrage_flags(w_grid, g)
    with span("iv.surface.fit_rmse"):
        w_obs = iv * iv * expiries[..., None]
        err2 = (_eval_slices(fit, k) - w_obs) ** 2
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
