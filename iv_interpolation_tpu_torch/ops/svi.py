"""SVI smile calibration: batched 5-parameter fits by Levenberg-Marquardt
(port of ``iv_interpolation_tpu/ops/svi.py``).

Raw SVI (Gatheral): total variance as a function of log-moneyness k,

    w(k) = a + b * (rho * (k - m) + sqrt((k - m)^2 + sigma^2))

with b >= 0, |rho| < 1, sigma > 0. Butterfly arbitrage is checked with
Gatheral's g-function; calendar arbitrage with total-variance
monotonicity across expiries (``surface.arbitrage``).

Every closed form and both initialisations broadcast over leading
dimensions, so a batch of slices is one call; only the LM residual runs
per problem (``ops.lm`` maps it over the batch).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from iv_interpolation_tpu_torch.ops.lm import (
    LMResult,
    levenberg_marquardt,
    levenberg_marquardt_batched,
    robustify,
)
from iv_interpolation_tpu_torch.surface.arbitrage import butterfly_g

# parameter order: (a, b, rho, m, sigma). numpy on purpose: the bounds are
# placed on the inputs' device and dtype at call time, never at import
SVI_LOWER = np.array([-10.0, 1e-6, -0.9999, -10.0, 1e-6])
SVI_UPPER = np.array([10.0, 100.0, 0.9999, 10.0, 100.0])


def linspace_last(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``num`` points from ``start`` to ``stop`` (tensors of one shape) on a
    new last axis, by the reference's ``jnp.linspace`` formula:
    ``start * (1 - i/div) + stop * (i/div)`` for i < div = num - 1 in the
    inputs' dtype, then ``stop`` itself, so the grids agree with the
    reference's within two ulps of the larger end (its compiler may fuse the
    multiply-add).
    ``torch.linspace`` takes scalar ends only."""
    if num < 2:
        raise ValueError(f"linspace_last needs num >= 2, got {num}")
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    body = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([body, stop[..., None]], dim=-1)


def unit_steps(num: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The reference's ``jnp.linspace(0.0, 1.0, num).astype(dtype)``: i/(num-1)
    in float64 (exactly what its formula gives for these ends), cast to
    ``dtype``; ``num=1`` gives [0]."""
    return (torch.arange(num, dtype=torch.float64, device=device) / max(num - 1, 1)).to(dtype)


def svi_total_variance(params: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """w(k) for raw-SVI ``params`` = (..., 5) against ``k`` = (..., n)."""
    a, b, rho, m, sigma = (params[..., i:i + 1] for i in range(5))
    km = k - m
    return a + b * (rho * km + torch.sqrt(km * km + sigma * sigma))


def svi_init(k: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Heuristic initial guess from the observed slices: ``k``, ``w``
    (..., n) -> params (..., 5)."""
    w_min, at = w.min(dim=-1)
    m0 = torch.gather(k, -1, at[..., None])[..., 0]
    span = (k.amax(dim=-1) - k.amin(dim=-1)).clamp_min(1e-3)
    # slope of the wings ~ b(1 +/- rho)
    b0 = ((w.amax(dim=-1) - w_min) / span).clamp_min(1e-3)
    a0 = (w_min * 0.9).clamp_min(1e-6)
    return torch.stack([a0, b0, torch.zeros_like(a0), m0, 0.1 * span], dim=-1)


def adjugate3x3(A: torch.Tensor):
    """Batched 3x3 ``(adjugate, det)`` by elementwise cofactor math: the
    one home of the 9-cofactor block behind :func:`_solve3x3` (SVI
    quasi-init) and ``ops.essvi._inv3x3``.

    adj rows are laid out so that ``x = (adj @ b) / det`` solves
    ``A x = b``.
    """
    a11, a12, a13 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a21, a22, a23 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a31, a32, a33 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = a22 * a33 - a23 * a32
    c12 = a23 * a31 - a21 * a33
    c13 = a21 * a32 - a22 * a31
    det = a11 * c11 + a12 * c12 + a13 * c13
    c21 = a13 * a32 - a12 * a33
    c22 = a11 * a33 - a13 * a31
    c23 = a12 * a31 - a11 * a32
    c31 = a12 * a23 - a13 * a22
    c32 = a13 * a21 - a11 * a23
    c33 = a11 * a22 - a12 * a21
    adj = torch.stack([
        torch.stack([c11, c21, c31], dim=-1),
        torch.stack([c12, c22, c32], dim=-1),
        torch.stack([c13, c23, c33], dim=-1),
    ], dim=-2)
    return adj, det


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 solve (Cramer / adjugate): elementwise math
    instead of a batched LU, for the quasi-init's G x batch tiny systems.
    They are ridge-regularised normal equations, so the determinant is
    bounded away from zero."""
    adj, det = adjugate3x3(A)
    x = torch.einsum("...ij,...j->...i", adj, b)
    return x / det[..., None]


def svi_quasi_init(k: torch.Tensor, w: torch.Tensor, n_m: int = 8,
                   n_sigma: int = 8) -> torch.Tensor:
    """Quasi-explicit initialisation (Zeliade-style): for fixed (m, sigma)
    SVI is linear in (a, c, d) with w = a + c*y + d*sqrt(y^2+1),
    y = (k-m)/sigma, c = b*sigma*rho, d = b*sigma. Grid-search (m, sigma),
    solve the 3x3 normal equations per candidate, keep the best SSE.
    ``k``, ``w`` (..., n) -> params (..., 5).
    """
    k_lo, k_hi = k.amin(dim=-1), k.amax(dim=-1)
    span = (k_hi - k_lo).clamp_min(1e-3)
    m_grid = linspace_last(k_lo, k_hi, n_m)                       # (..., n_m)
    sig_grid = torch.exp(linspace_last(torch.log(0.05 * span), torch.log(span),
                                       n_sigma))                  # (..., n_sigma)
    # every (m, sigma) pair, m-major: (..., G)
    mm = m_grid[..., :, None].expand(*m_grid.shape, n_sigma).flatten(-2)
    ss = sig_grid[..., None, :].expand(*m_grid.shape, n_sigma).flatten(-2)
    y = (k[..., None, :] - mm[..., None]) / ss[..., None]         # (..., G, n)
    root = torch.sqrt(y * y + 1.0)
    X = torch.stack([torch.ones_like(y), y, root], dim=-1)        # (..., G, n, 3)
    A = torch.einsum("...gni,...gnj->...gij", X, X)
    A = A + 1e-10 * torch.eye(3, dtype=w.dtype, device=w.device)
    rhs = torch.einsum("...gni,...n->...gi", X, w)
    sol = _solve3x3(A, rhs)                                       # (..., G, 3) = (a, c, d)
    # project into the valid cone: d >= |c| >= 0
    a_, c_, d_ = sol[..., 0], sol[..., 1], sol[..., 2]
    d_ = d_.clamp_min(1e-8)
    c_ = torch.clamp(c_, -0.999 * d_, 0.999 * d_)
    pred = a_[..., None] + c_[..., None] * y + d_[..., None] * root
    sse = ((pred - w[..., None, :]) ** 2).sum(dim=-1)             # (..., G)
    best = sse.argmin(dim=-1, keepdim=True)
    a0, c0, d0, m0, sigma0 = (torch.gather(t, -1, best)[..., 0]
                              for t in (a_, c_, d_, mm, ss))
    params = torch.stack([a0, d0 / sigma0, c0 / d0, m0, sigma0], dim=-1)
    return torch.clamp(params, _bound(SVI_LOWER, w), _bound(SVI_UPPER, w))


def _bound(bound: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(bound, device=like.device).to(like.dtype)


def _svi_residual(params, k, w, weights, butterfly_penalty):
    r = (svi_total_variance(params, k) - w) * weights
    if butterfly_penalty > 0.0:
        g = svi_g(params, k)
        r = torch.cat([r, butterfly_penalty * g.clamp_max(0.0)], dim=-1)
    return r


def fit_svi(k: torch.Tensor, w: torch.Tensor, weights: torch.Tensor | None = None,
            params0: torch.Tensor | None = None, max_iters: int = 64,
            butterfly_penalty: float = 0.0) -> LMResult:
    """Fit one SVI slice: log-moneyness ``k`` (n,) -> total variance ``w``.

    ``weights`` scales residuals (e.g. vega weights); ``butterfly_penalty``
    adds hinge residuals on negative g(k) so fits stay arbitrage-free.
    Batch with :func:`fit_svi_batched`.
    """
    if weights is None:
        weights = torch.ones_like(w)
    if params0 is None:
        params0 = svi_init(k, w)
    return levenberg_marquardt(
        partial(_svi_residual, butterfly_penalty=butterfly_penalty),
        params0, k, w, weights, max_iters=max_iters,
        lower=SVI_LOWER, upper=SVI_UPPER)


def fit_svi_batched(k: torch.Tensor, w: torch.Tensor,
                    weights: torch.Tensor | None = None,
                    max_iters: int = 64,
                    butterfly_penalty: float = 0.0,
                    init: str = "heuristic",
                    loss: str = "linear",
                    huber_delta: float = 1e-3) -> LMResult:
    """Batched SVI calibration: ``k``, ``w`` of shape (..., n_strikes).

    The whole batch (surfaces x expiries) runs as one batched LM.
    ``init='quasi'`` starts from :func:`svi_quasi_init` instead of
    :func:`svi_init`. ``loss='huber'`` minimises the pseudo-Huber loss
    with scale ``huber_delta`` (in total-variance units) instead of least
    squares: bad quotes pull the fit with bounded force
    (``ops.lm.robustify``).
    """
    if weights is None:
        weights = torch.ones_like(w)
    batch_shape = w.shape[:-1]
    n = w.shape[-1]
    kf, wf, wtf = (a.reshape(-1, n) for a in (k, w, weights))
    p0 = svi_quasi_init(kf, wf) if init == "quasi" else svi_init(kf, wf)
    residual = partial(_svi_residual, butterfly_penalty=butterfly_penalty)
    if loss == "huber":
        residual = robustify(residual, huber_delta)
    elif loss != "linear":
        raise ValueError(f"unknown loss: {loss!r}")
    fit = levenberg_marquardt_batched(residual, p0, kf, wf, wtf, max_iters=max_iters,
                                      lower=SVI_LOWER, upper=SVI_UPPER)
    return LMResult(*(a.reshape(batch_shape + a.shape[1:]) for a in fit))


def vega_weights(k: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Relative Black-Scholes vega weights from log-moneyness and observed
    total variance alone: vega ~ S sqrt(T) phi(d1) with
    d1 = (-k + w/2) / sqrt(w); constant per-slice factors drop out of the
    least-squares weighting. Normalised to mean 1 per slice."""
    w_safe = w.clamp_min(1e-8)
    d1 = (-k + w_safe / 2.0) / torch.sqrt(w_safe)
    phi = torch.exp(-0.5 * d1 * d1)
    return phi / phi.mean(dim=-1, keepdim=True).clamp_min(1e-12)


def svi_g(params: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Gatheral's butterfly-arbitrage function

        g(k) = (1 - k w'/(2w))^2 - (w'^2/4)(1/w + 1/4) + w''/2 .

    g(k) >= 0 for all k (with w > 0) <=> the slice is free of butterfly
    arbitrage. The SVI derivatives are closed-form and go through the one
    shared g formula (``surface.arbitrage.butterfly_g``, which owns the w
    floor).
    """
    a, b, rho, m, sigma = (params[..., i:i + 1] for i in range(5))
    km = k - m
    root = torch.sqrt(km * km + sigma * sigma)
    w = a + b * (rho * km + root)
    w1 = b * (rho + km / root)
    w2 = b * sigma * sigma / (root * root * root)
    return butterfly_g(k, w, w1, w2)


def svi_is_butterfly_free(params: torch.Tensor, k_grid: torch.Tensor,
                          tol: float = -1e-10) -> torch.Tensor:
    """Check g(k) >= tol on a dense grid."""
    return (svi_g(params, k_grid) >= tol).all()
