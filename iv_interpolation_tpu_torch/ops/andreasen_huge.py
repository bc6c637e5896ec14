"""Andreasen-Huge one-step arbitrage-free surfaces (port of
``iv_interpolation_tpu/ops/andreasen_huge.py``).

Each expiry slice is ONE implicit finite-difference step of the Dupire
forward PDE in strike space, dC/dT = (sigma^2(K) K^2 / 2) d^2C/dK^2, on
the grid K = e^x (x uniform in log-moneyness), with a piecewise-constant
(one cell per quote) local vol calibrated so the step reprices the
quotes. The step matrix (I - dt*A) is an M-matrix whose inverse is a
discrete martingale kernel, so every step keeps the call curve positive,
monotone and convex, and stepping forward in maturity only raises prices:
no butterfly and no calendar arbitrage at any grid point.

Design on the card:
  * every step is a batched tridiagonal solve through
    ``ops.tridiag.tridiag_solve`` (kernel B1 on CUDA tensors, the plain
    Thomas loop on the CPU); all functions here are batch-native, with
    the system (grid) dimension LAST and any batch dimensions before it;
  * the per-slice calibration is the batched Levenberg-Marquardt engine
    (``ops.lm``) with a CLOSED-FORM Jacobian: parameter j scales only the
    interior rows of (I - dt*A) whose cell is j, by theta_j^2, so from
    (I - dt*A) c = rhs the tangent solves
    (I - dt*A) dc/dtheta_j = (2/theta_j) [cell(i) = j] (c_i - rhs_i)
    on interior rows and 0 on the two boundary rows. All m tangents of a
    slice are one B1 launch (B*m systems sharing their slice's bands);
  * the reference's scan over expiries is a Python loop over E with the
    whole batch on each step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.special import ndtr

from iv_interpolation_tpu_torch.ops.black_scholes import _pdf
from iv_interpolation_tpu_torch.ops.lm import levenberg_marquardt_batched
from iv_interpolation_tpu_torch.ops.svi import unit_steps
from iv_interpolation_tpu_torch.ops.tridiag import tridiag_solve

_VOL_LO, _VOL_HI = 1e-3, 5.0


def normalized_call(k: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Black call price with unit forward and zero rates:
    c(k, w) = N(d1) - e^k N(d2), d1 = -k/sqrt(w) + sqrt(w)/2; ``w`` is
    total implied variance and w -> 0 gives intrinsic."""
    sw = torch.sqrt(torch.clamp_min(w, 1e-14))
    d1 = -k / sw + 0.5 * sw
    d2 = d1 - sw
    c = ndtr(d1) - torch.exp(k) * ndtr(d2)
    intrinsic = torch.clamp_min(1.0 - torch.exp(k), 0.0)
    return torch.where(w > 1e-14, c, intrinsic)


def _normalized_vega_w(k: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dc/dw (Black vega with respect to total variance, unit forward)."""
    sw = torch.sqrt(torch.clamp_min(w, 1e-14))
    d1 = -k / sw + 0.5 * sw
    return 0.5 * _pdf(d1) / sw


def _step_system(sig2: torch.Tensor, x: torch.Tensor, dt: torch.Tensor):
    """Tridiagonal (I - dt*A) rows of one implicit Dupire step, A the
    strike-space generator (sigma^2 K^2 / 2) d^2/dK^2 as second divided
    differences on K = e^x. Boundary rows pin the slope in K: -1 at the
    deep-ITM edge (row 0: C_0 - C_1), 0 at the deep-OTM edge.

    sig2, x: (..., n); dt: (...). Returns (dl, d, du), each (..., n).
    """
    K = torch.exp(x)
    dK = K[..., 1:] - K[..., :-1]
    h_lo = F.pad(dK, (1, 0))                    # K_i - K_{i-1} (h_lo[0] dummy)
    h_hi = F.pad(dK, (0, 1))                    # K_{i+1} - K_i (h_hi[-1] dummy)
    safe = lambda a: torch.where(a == 0, 1.0, a)
    alpha = 0.5 * dt[..., None] * sig2 * K * K
    dl = -alpha * 2.0 / (safe(h_lo) * safe(h_lo + h_hi))
    du = -alpha * 2.0 / (safe(h_hi) * safe(h_lo + h_hi))
    d = 1.0 + alpha * 2.0 / safe(h_lo * h_hi)
    dl[..., 0], dl[..., -1] = 0.0, -1.0
    du[..., 0], du[..., -1] = -1.0, 0.0
    d[..., 0], d[..., -1] = 1.0, 1.0
    return dl, d, du


def _step_rhs(c_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The step's right-hand side: ``c_prev`` with the boundary rows'
    slope conditions (K_1 - K_0 at row 0, 0 at row n-1)."""
    rhs = c_prev.clone()
    rhs[..., 0] = torch.exp(x[..., 1]) - torch.exp(x[..., 0])
    rhs[..., -1] = 0.0
    return rhs


def _solve(dl, d, du, b):
    """Tridiagonal solve along the last axis (one B1 launch on the card)."""
    to0 = lambda a: a.movedim(-1, 0)
    return tridiag_solve(to0(dl), to0(d), to0(du), to0(b)).movedim(0, -1)


def _matvec(dl, d, du, v):
    """Tridiagonal product along the last axis, summed in the reference's
    order (diagonal, then upper, then lower)."""
    y = d * v
    y[..., :-1] += du[..., :-1] * v[..., 1:]
    y[..., 1:] += dl[..., 1:] * v[..., :-1]
    return y


def ah_step(c_prev: torch.Tensor, sig2: torch.Tensor, x: torch.Tensor,
            dt: torch.Tensor, refine: bool = False) -> torch.Tensor:
    """One implicit step of the Dupire forward PDE: solve
    (I - dt*A(sigma^2)) c = c_prev with linear-wing boundaries.
    ``c_prev``, ``sig2``, ``x``: (..., n); ``dt``: (...).

    refine: one sweep of iterative refinement (residual + correction
    solve), for the final per-slice curves and the eval-time steps."""
    dl, d, du = _step_system(sig2, x, dt)
    rhs = _step_rhs(c_prev, x)
    c = _solve(dl, d, du, rhs)
    if refine:
        c = c + _solve(dl, d, du, rhs - _matvec(dl, d, du, c))
    return c


def _cells(k_q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Each grid node's quote cell (cell boundaries at midpoints between
    adjacent quote strikes): k_q (..., m), x (..., n) -> int64 (..., n)."""
    mids = 0.5 * (k_q[..., 1:] + k_q[..., :-1])
    return (x[..., :, None] > mids[..., None, :]).sum(-1)


def _cells_to_grid(theta: torch.Tensor, k_q: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant vol^2 on the grid, one cell per quote:
    theta, k_q (..., m), x (..., n) -> (..., n)."""
    idx = _cells(k_q, x)
    return torch.gather(theta.expand(*idx.shape[:-1], -1), -1, idx) ** 2


def _interp_weights(x: torch.Tensor, k_q: torch.Tensor):
    """Left grid node ``i0`` and weight ``frac`` of linear interpolation
    at each query strike: x (..., n), k_q (..., Q) -> two (..., Q)."""
    h = x[..., 1:2] - x[..., :1]
    pos = (k_q - x[..., :1]) / h
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, x.shape[-1] - 2)
    frac = torch.clamp(pos - i0.to(pos.dtype), 0.0, 1.0)
    return i0, frac


def _interp_grid(c: torch.Tensor, x: torch.Tensor, k_q: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of grid values ``c`` (..., n) at ``k_q`` (..., Q)."""
    i0, frac = _interp_weights(x, k_q)
    return (torch.gather(c, -1, i0) * (1.0 - frac)
            + torch.gather(c, -1, i0 + 1) * frac)


def _interp_price(c: torch.Tensor, x: torch.Tensor, k_q: torch.Tensor) -> torch.Tensor:
    """Price at the quotes via the TIME VALUE: intrinsic 1 - e^k is
    concave in k, so interpolating c directly undershoots it on the ITM
    wing; interpolate c - intrinsic (>= 0) and add intrinsic back exactly
    at the query."""
    tv = torch.clamp_min(c - torch.clamp_min(1.0 - torch.exp(x), 0.0), 0.0)
    return _interp_grid(tv, x, k_q) + torch.clamp_min(1.0 - torch.exp(k_q), 0.0)


def _slice_residual(theta, c_prev, k_q, c_mkt, wgt, x, dt):
    """Vega-weighted price residuals of one slice's step, batched:
    theta, k_q, c_mkt, wgt (B, m); c_prev, x (B, n); dt (B,) -> (B, m)."""
    c = ah_step(c_prev, _cells_to_grid(theta, k_q, x), x, dt)
    return (_interp_price(c, x, k_q) - c_mkt) * wgt


def _interp_price_tangent(c: torch.Tensor, dc: torch.Tensor, x: torch.Tensor,
                          k_q: torch.Tensor) -> torch.Tensor:
    """Directional derivatives of :func:`_interp_price` at ``c`` (B, n)
    along the P directions ``dc`` (B, P, n), at the quotes ``k_q`` (B, Q):
    returns (B, P, Q). The time value max(c - intrinsic, 0) passes all of
    ``dc`` above 0, none below and half at a tie, as ``jax.jvp`` of
    ``jnp.maximum`` does; the interpolation weights depend on the data
    only."""
    z = c - torch.clamp_min(1.0 - torch.exp(x), 0.0)
    slope = torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0)).to(c.dtype)
    dtv = dc * slope[:, None, :]
    i0, frac = _interp_weights(x, k_q)
    B, P, Q = dc.shape[0], dc.shape[1], k_q.shape[-1]
    at = lambda i: torch.gather(dtv, -1, i[:, None, :].expand(B, P, Q))
    return at(i0) * (1.0 - frac)[:, None, :] + at(i0 + 1) * frac[:, None, :]


def _slice_linearize(theta, c_prev, k_q, c_mkt, wgt, x, dt):
    """Residuals (B, m) and their closed-form Jacobian (B, m, m) with
    respect to theta (shapes as :func:`_slice_residual`), from one step
    solve (B systems) and one tangent solve (B*m systems sharing their
    slice's bands): (I - dt*A) dc/dtheta_j = (2/theta_j) [cell(i) = j]
    (c_i - rhs_i) on interior rows, 0 on the boundary rows."""
    B, m = theta.shape
    n = x.shape[-1]
    idx = _cells(k_q, x)
    th = torch.gather(theta, -1, idx)                      # (B, n)
    dl, d, du = _step_system(th ** 2, x, dt)
    rhs = _step_rhs(c_prev, x)
    c = _solve(dl, d, du, rhs)
    r = (_interp_price(c, x, k_q) - c_mkt) * wgt
    src = 2.0 / th * (c - rhs)
    src[..., 0] = 0.0
    src[..., -1] = 0.0
    own = idx[:, None, :] == torch.arange(m, device=idx.device)[None, :, None]
    bands = [a[:, None, :].expand(B, m, n) for a in (dl, d, du)]
    dc = _solve(*bands, torch.where(own, src[:, None, :], 0.0))   # (B, m, n)
    J = _interp_price_tangent(c, dc, x, k_q) * wgt[:, None, :]    # (B, param, quote)
    return r, J.mT


class AHFit(NamedTuple):
    """Fitted Andreasen-Huge surfaces, batched over B.

    x: (B, n) uniform log-moneyness grid per surface.
    expiries: (B, E) maturities (years, ascending).
    c: (B, E, n) normalized call prices after each calibrated step.
    theta: (B, E, m) calibrated piecewise-constant vols, one per quote.
    k_q: (B, E, m) the quote strikes theta's cells are anchored to.
    fit_rmse: (B,) price-space RMSE at the unmasked quotes (unit forward).
    """
    x: torch.Tensor
    expiries: torch.Tensor
    c: torch.Tensor
    theta: torch.Tensor
    k_q: torch.Tensor
    fit_rmse: torch.Tensor


def fit_ah(k: torch.Tensor, iv: torch.Tensor, expiries: torch.Tensor,
           n_grid: int = 257, n_iters: int = 16, grid_pad: float = 1.0,
           quote_mask: torch.Tensor | None = None) -> AHFit:
    """Calibrate Andreasen-Huge one-step surfaces (batched).

    Args:
      k: (B, E, m) quote log-moneyness, ascending in m.
      iv: (B, E, m) implied vols at the quotes.
      expiries: (B, E) maturities in years, ascending.
      n_grid: grid resolution (uniform in k).
      n_iters: LM iterations per slice.
      grid_pad: minimum grid extension beyond the unmasked quotes on each
        side; the effective pad is max(grid_pad, 3 sqrt(w_max) + w_max/2).
      quote_mask: (B, E, m) bool, False rows get zero residual weight.
        Masked strikes still anchor cell boundaries, so keep them finite.

    Returns an :class:`AHFit` whose curves are free of butterfly and
    calendar arbitrage at every grid point by construction.
    """
    B, E, m = k.shape
    wgt = torch.ones_like(k) if quote_mask is None else quote_mask.to(k.dtype)
    live = wgt > 0
    w_q = iv * iv * expiries[..., None]
    w_max = torch.where(live, w_q, 0.0).amax(dim=(1, 2))
    pad = torch.clamp_min(3.0 * torch.sqrt(w_max) + 0.5 * w_max, grid_pad)
    lo = torch.where(live, k, float("inf")).amin(dim=(1, 2)) - pad
    hi = torch.where(live, k, float("-inf")).amax(dim=(1, 2)) + pad
    x = lo[:, None] + (hi - lo)[:, None] * unit_steps(n_grid, k.dtype, k.device)[None, :]

    # masked quotes may carry anything (NaN iv): their market variance is
    # the slice's unmasked mean, so prices, vega weights and the next
    # slice's init stay finite
    n_live = torch.clamp_min(live.sum(-1, keepdim=True).to(k.dtype), 1.0)
    w_raw = iv * iv * expiries[..., None]
    w_fill = torch.where(live, w_raw, 0.0).sum(-1, keepdim=True) / n_live
    w_mkt = torch.where(live, w_raw, w_fill)
    c_mkt = normalized_call(k, w_mkt)
    # weight each price residual by 1/(dc/dw), floored: equal error in
    # implied variance across strikes
    vega = _normalized_vega_w(k, w_mkt)
    res_w = torch.where(live, wgt / torch.clamp_min(vega, 1e-3), 0.0)
    # forward-variance init theta0^2 ~ (w_j - w_{j-1}) / dt, masked cells
    # at their slice's unmasked mean
    w_prev = F.pad(w_mkt[:, :-1], (0, 0, 1, 0))
    dts = torch.diff(expiries, dim=-1, prepend=torch.zeros_like(expiries[:, :1]))
    theta0 = torch.sqrt(torch.clamp_min(w_mkt - w_prev, 1e-6)
                        / torch.clamp_min(dts[..., None], 1e-12))
    theta0 = torch.clamp(theta0, _VOL_LO, _VOL_HI)
    mean0 = (theta0 * live).sum(-1, keepdim=True) / n_live
    theta0 = torch.where(live, theta0, mean0)

    c_prev = torch.clamp_min(1.0 - torch.exp(x), 0.0)
    thetas, curves, errs = [], [], []
    for j in range(E):
        args = (c_prev, k[:, j], c_mkt[:, j], res_w[:, j], x, dts[:, j])
        res = levenberg_marquardt_batched(
            _slice_residual, theta0[:, j], *args, linearize=_slice_linearize,
            max_iters=n_iters, lower=_VOL_LO, upper=_VOL_HI)
        sig2 = _cells_to_grid(res.params, k[:, j], x)
        c_prev = ah_step(c_prev, sig2, x, dts[:, j], refine=True)
        thetas.append(res.params)
        curves.append(c_prev)
        errs.append(_interp_price(c_prev, x, k[:, j]) - c_mkt[:, j])
    err = torch.stack(errs, 1)
    mask = live.to(err.dtype)
    rmse = torch.sqrt((err * err * mask).sum(dim=(1, 2))
                      / torch.clamp_min(mask.sum(dim=(1, 2)), 1.0))
    return AHFit(x=x, expiries=expiries, c=torch.stack(curves, 1),
                 theta=torch.stack(thetas, 1), k_q=k, fit_rmse=rmse)


def ah_local_vol(fit: AHFit) -> torch.Tensor:
    """The calibrated model's own local vol on its grid: (B, E, n),
    piecewise constant per quote cell (exact: theta is what the
    calibration solves for)."""
    return torch.sqrt(_cells_to_grid(fit.theta, fit.k_q, fit.x[:, None, :]))


def _bracket_lo(expiries: torch.Tensor, T_q: torch.Tensor) -> torch.Tensor:
    """Index of the slice at or below each query maturity; -1 before the
    first expiry (the step then starts from the T=0 intrinsic)."""
    return (T_q[..., :, None] >= expiries[..., None, :]).sum(-1) - 1


def eval_ah(fit: AHFit, k_q: torch.Tensor, T_q: torch.Tensor) -> torch.Tensor:
    """Total variance at scattered (k, T): a PARTIAL implicit step of the
    next slice's calibrated operator from the slice at or below T (dt =
    T - T_j), the Andreasen-Huge interpolation rule, which keeps the
    in-between surface arbitrage-free; beyond the last expiry the last
    slice's operator extrapolates. Each query point solves one full
    n-point system (two B1 launches for all B*Q of them, with the
    refinement sweep).

    k_q, T_q: (B, Q). Returns (B, Q) total implied variance.
    """
    B, E, n = fit.c.shape
    m = fit.theta.shape[-1]
    Q = k_q.shape[-1]
    lo = _bracket_lo(fit.expiries, T_q)                        # (B, Q)
    at = torch.clamp(lo, 0, E - 1)
    c0 = torch.clamp_min(1.0 - torch.exp(fit.x), 0.0)
    c_base = torch.where((lo >= 0)[..., None],
                         torch.gather(fit.c, 1, at[..., None].expand(B, Q, n)),
                         c0[:, None, :])
    T_base = torch.where(lo >= 0, torch.gather(fit.expiries, 1, at), 0.0)
    op = torch.clamp(lo + 1, 0, E - 1)[..., None].expand(B, Q, m)
    theta_op = torch.gather(fit.theta, 1, op)
    kq_op = torch.gather(fit.k_q, 1, op)
    dt = torch.clamp_min(T_q - T_base, 0.0)
    x = fit.x[:, None, :].expand(B, Q, n)
    c_at = ah_step(c_base, _cells_to_grid(theta_op, kq_op, x), x, dt, refine=True)
    c_pts = _interp_price(c_at, x, k_q[..., None])[..., 0]
    return _invert_w(c_pts, k_q, w_hi=_VOL_HI * _VOL_HI * torch.clamp_min(T_q, 1.0))


def _invert_w(c: torch.Tensor, k: torch.Tensor, max_iters: int = 64,
              w_hi=16.0) -> torch.Tensor:
    """Black-invert normalized call prices to total variance by
    safeguarded bisection + Newton on w (dc/dw > 0). ``w_hi`` is the
    bracket's upper edge and must cover the surface's largest total
    variance (callers pass _VOL_HI^2 * max(T, 1)). Prices within 1024 ulps
    of intrinsic carry no variance information and give 0."""
    lo = torch.full_like(c, 1e-10)
    hi = torch.broadcast_to(torch.as_tensor(w_hi, dtype=c.dtype, device=c.device), c.shape)
    w = torch.full_like(c, 0.04)
    for _ in range(max_iters):
        p = normalized_call(k, w)
        too_high = p > c
        lo = torch.where(too_high, lo, w)
        hi = torch.where(too_high, w, hi)
        newton = w - (p - c) / torch.clamp_min(_normalized_vega_w(k, w), 1e-14)
        ok = (newton > lo) & (newton < hi) & torch.isfinite(newton)
        w = torch.where(ok, newton, 0.5 * (lo + hi))
    intrinsic = torch.clamp_min(1.0 - torch.exp(k), 0.0)
    tol = 1024.0 * torch.finfo(c.dtype).eps
    return torch.where(c > intrinsic + tol, w, 0.0)


def _price_space_density(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Discrete density d^2C/dK^2 on K = e^x by divided differences:
    (..., n) -> (..., n-2) interior columns. Float64 only (tests): in
    float32 it divides price rounding by h_K^2."""
    K = torch.exp(x)
    dK_lo = K[..., 1:-1] - K[..., :-2]
    dK_hi = K[..., 2:] - K[..., 1:-1]
    s_lo = (c[..., 1:-1] - c[..., :-2]) / dK_lo
    s_hi = (c[..., 2:] - c[..., 1:-1]) / dK_hi
    return 2.0 * (s_hi - s_lo) / (dK_lo + dK_hi)


def _step_identity_density(c, c_prev, sig2, x, dt) -> torch.Tensor:
    """Discrete density via the step identity, float32-safe: A c =
    (c - c_prev)/dt with A = (sigma^2 K^2/2) d^2/dK^2, so d^2C/dK^2 =
    2 (c - c_prev) / (dt sigma^2 K^2). Boundary rows carry slope
    conditions, not the PDE; callers drop them."""
    denom = torch.clamp_min(dt * sig2 * torch.exp(2.0 * x), 1e-12)
    return 2.0 * (c - c_prev) / denom


def fit_eval_ah_surface(k: torch.Tensor, iv: torch.Tensor, expiries: torch.Tensor,
                        n_grid: int = 257, n_iters: int = 16, grid_pad: float = 1.0,
                        quote_mask: torch.Tensor | None = None) -> dict:
    """Fused AH fit + dense-grid eval + arbitrage diagnostics, with
    ``surface.fit_eval_surface``'s output keys: ``fit`` (AHFit),
    ``k_grid``/``w_grid``/``iv_grid`` (B, E, n_grid), ``g``,
    ``butterfly_ok``/``calendar_ok``, ``fit_rmse``, ``local_vol``.

    ``g`` is the STRIKE-space density d^2C/dK^2 on the grid interior
    (zero in the two boundary columns), from the step identity; the flags
    are read in price space, where the construction's guarantee lives,
    with a tolerance of 1024 ulps of the unit-forward price (float32 Thomas
    carries a few 1e-5 of price noise).
    """
    fit = fit_ah(k, iv, expiries, n_grid=n_grid, n_iters=n_iters,
                 grid_pad=grid_pad, quote_mask=quote_mask)
    x = fit.x[:, None, :]                                       # (B, 1, n)
    k_grid = x.expand(fit.c.shape)
    c_prev = torch.cat([torch.clamp_min(1.0 - torch.exp(x), 0.0), fit.c[:, :-1]], 1)
    dts = torch.diff(fit.expiries, dim=-1,
                     prepend=torch.zeros_like(fit.expiries[:, :1]))
    sig2 = _cells_to_grid(fit.theta, fit.k_q, x)
    dens = _step_identity_density(fit.c, c_prev, sig2, x, dts[..., None])[..., 1:-1]
    g = F.pad(dens, (1, 1))
    tol = 1024.0 * torch.finfo(k.dtype).eps
    butterfly_ok = (fit.c[..., 1:-1] >= c_prev[..., 1:-1] - tol).all(-1).all(-1)
    calendar_ok = (fit.c[:, 1:] >= fit.c[:, :-1] - tol).all(-1).all(-1)
    w_hi = _VOL_HI * _VOL_HI * torch.clamp_min(fit.expiries, 1.0)[..., None]
    w_grid = _invert_w(fit.c, k_grid, w_hi=w_hi.expand(fit.c.shape))
    iv_grid = torch.sqrt(w_grid / torch.clamp_min(fit.expiries[..., None], 1e-12))
    return {
        "fit": fit,
        "k_grid": k_grid,
        "w_grid": w_grid,
        "iv_grid": iv_grid,
        "g": g,
        "butterfly_ok": butterfly_ok,
        "calendar_ok": calendar_ok,
        "fit_rmse": fit.fit_rmse,
        "local_vol": torch.sqrt(sig2),
    }
