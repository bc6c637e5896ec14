"""eSSVI global vol-surface calibration (Gatheral-Jacquier SSVI, extended
per expiry as in Hendriks-Martini; port of
``iv_interpolation_tpu/ops/essvi.py``).

One global surface with per-expiry parameters (theta, rho, psi),

    w_i(k) = 1/2 * ( theta_i + rho_i psi_i k
                     + sqrt((psi_i k + theta_i rho_i)^2
                            + theta_i^2 (1 - rho_i^2)) ),

where theta_i = w_i(0) is the ATM total variance. Structural guarantees
baked into the parameter transform (so every LM iterate satisfies them,
not just the converged fit):

  * theta strictly increasing in expiry -> no ATM calendar arbitrage
    (cumulative-softplus parameterisation);
  * |rho| < 1, psi in (0, psi_cap] with
    psi_cap = min(4 / (1+|rho|), sqrt(4 theta / (1+|rho|)))
    -> each slice is free of butterfly arbitrage (the Gatheral-Jacquier
    sufficient conditions with phi = psi/theta).

Off-ATM calendar crossings between slices with different (rho, psi) are
not excluded by those conditions alone; a hinge penalty on
w_{i+1} - w_i over a dense common k-grid is part of the LM residual
(``calendar_weight``).

Each surface is one Levenberg-Marquardt problem over 3E transformed
parameters. Every function here broadcasts over leading (surface)
dimensions: z is (..., 3E), params (..., E, 3), k and w (..., E, n).

The block solver opens ``iv.essvi.init`` once a fit (the start and its
cost) and three spans an iteration (``monitoring.metrics.span``):
``iv.essvi.linearize`` (the slice Jacobians at the quotes and on the
penalty grid, r, g and the blocks D and U), ``iv.essvi.solve`` (the
damping, the block Thomas loop and the pullback to z) and
``iv.essvi.step`` (the trial cost, acceptance and the convergence
tests). The dense solver keeps ``ops.lm``'s ``iv.lm.*`` spans.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from iv_interpolation_tpu_torch.monitoring.metrics import span
from iv_interpolation_tpu_torch.ops.lm import (
    levenberg_marquardt_batched,
    lm_accept,
    robustify,
)
from iv_interpolation_tpu_torch.ops.svi import _solve3x3, linspace_last
from iv_interpolation_tpu_torch.surface.arbitrage import butterfly_g

_RHO_MAX = 0.999
_PSI_FRAC = 0.999     # keep psi strictly inside the butterfly cap
_THETA_MIN = 1e-6     # floor on the first slice's ATM variance
_DTHETA_MIN = 1e-8    # floor on theta increments (strict monotonicity)
# surfaces a dense-solver LM call takes at once: its (E n + (E-1) m, 3E)
# Jacobian and the 3E forward-mode tangents of every intermediate are
# about 10 MB a surface at 30 x 50 in float32
_DENSE_CHUNK = 256


class EssviFit(NamedTuple):
    params: torch.Tensor      # (..., E, 3) per-expiry (theta, rho, psi)
    cost: torch.Tensor        # (...,) final 0.5*sum(r^2)
    n_accepted: torch.Tensor  # (...,) int32 accepted LM steps
    converged: torch.Tensor   # (...,) bool


def essvi_w(params: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Total variance for eSSVI ``params`` (..., 3) against k (..., n)."""
    return essvi_w_derivs(params, k)[0]


def essvi_w_derivs(params: torch.Tensor, k: torch.Tensor):
    """(w, dw/dk, d2w/dk2), all closed-form, for the butterfly g.

    ``params``: (..., 3) = (theta, rho, psi); ``k``: (..., n) with the
    leading dims broadcastable against params' batch dims.
    """
    theta = params[..., 0:1]
    rho = params[..., 1:2]
    psi = params[..., 2:3]
    u = psi * k + theta * rho
    R = torch.sqrt(u * u + theta * theta * (1.0 - rho * rho))
    R = R.clamp_min(1e-12)
    w = 0.5 * (theta + rho * psi * k + R)
    w1 = 0.5 * psi * (rho + u / R)
    w2 = 0.5 * psi * psi * theta * theta * (1.0 - rho * rho) / (R * R * R)
    return w, w1, w2


def essvi_g(params: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Gatheral's butterfly g on a slice, from the closed-form derivatives."""
    w, w1, w2 = essvi_w_derivs(params, k)
    return butterfly_g(k, w, w1, w2)


def psi_butterfly_cap(theta: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Largest psi keeping the slice butterfly-free (sufficient
    conditions, Gatheral-Jacquier Thm 4.2 with phi = psi/theta):
    psi (1+|rho|) <= 4 and psi^2 (1+|rho|) <= 4 theta."""
    one_r = 1.0 + rho.abs()
    return torch.minimum(4.0 / one_r, torch.sqrt(4.0 * theta / one_r))


def psi_butterfly_cap_grads(theta: torch.Tensor, rho: torch.Tensor):
    """(d cap / d theta, d cap / d rho) of :func:`psi_butterfly_cap` in
    closed form, with the conventions of the reference's automatic
    differentiation at the kinks: d|rho|/d rho = +1 at rho = 0 (torch's
    own ``abs`` gives 0 there), and where the two caps tie each
    contributes half."""
    one_r = 1.0 + rho.abs()
    flat = 4.0 / one_r                       # psi (1+|rho|) <= 4
    root = torch.sqrt(4.0 * theta / one_r)   # psi^2 (1+|rho|) <= 4 theta
    sign = torch.where(rho >= 0, 1.0, -1.0).to(rho.dtype)
    flat_rho = -4.0 / (one_r * one_r) * sign
    half_inv_root = 0.5 / root
    root_theta = half_inv_root * (4.0 / one_r)
    root_rho = half_inv_root * (-4.0 * theta / (one_r * one_r)) * sign
    # share of the gradient that goes to `flat`: 1 below, 1/2 at the tie
    share = torch.where(flat < root, 1.0, torch.where(flat == root, 0.5, 0.0))
    share = share.to(theta.dtype)
    return (1.0 - share) * root_theta, share * flat_rho + (1.0 - share) * root_rho


# --- unconstrained z (..., 3E) <-> constrained (theta, rho, psi) (..., E, 3) ---

def _transform(z: torch.Tensor, E: int) -> torch.Tensor:
    """z = [z_theta (E,), z_rho (E,), z_psi (E,)] -> (E, 3) params with
    theta strictly increasing, |rho| < 1, 0 < psi <= butterfly cap."""
    z_th, z_rho, z_psi = z[..., :E], z[..., E:2 * E], z[..., 2 * E:]
    # softplus as logaddexp(x, 0): F.softplus switches to the identity
    # above its threshold, a different function there
    d = torch.logaddexp(z_th, torch.zeros_like(z_th)) + _DTHETA_MIN
    theta = torch.cumsum(d, dim=-1) + _THETA_MIN
    rho = _RHO_MAX * torch.tanh(z_rho)
    psi = _PSI_FRAC * psi_butterfly_cap(theta, rho) * torch.sigmoid(z_psi)
    return torch.stack([theta, rho, psi], dim=-1)


def _inv_softplus(y: torch.Tensor) -> torch.Tensor:
    # stable log(expm1(y)); y > 0
    y = y.clamp_min(1e-8)
    return y + torch.log(-torch.expm1(-y))


def _inv_transform(theta: torch.Tensor, rho: torch.Tensor,
                   psi: torch.Tensor) -> torch.Tensor:
    """Best-effort inverse of :func:`_transform` for initialisation."""
    d = (torch.diff(theta, dim=-1) - _DTHETA_MIN).clamp_min(1e-6)
    d = torch.cat([(theta[..., :1] - _THETA_MIN).clamp_min(1e-6), d], dim=-1)
    z_th = _inv_softplus(d)
    z_rho = torch.atanh((rho / _RHO_MAX).clamp(-0.995, 0.995))
    frac = psi / (_PSI_FRAC * psi_butterfly_cap(theta, rho)).clamp_min(1e-12)
    frac = frac.clamp(0.01, 0.99)
    z_psi = torch.log(frac) - torch.log1p(-frac)
    return torch.cat([z_th, z_rho, z_psi], dim=-1)


def essvi_init(k: torch.Tensor, w: torch.Tensor,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Initial z from per-slice quadratic fits.

    At k=0: w(0) = theta, w'(0) = rho psi,
    w''(0) = psi^2 (1 - rho^2) / (2 theta), so a least-squares quadratic
    w ~ a0 + a1 k + a2 k^2 per slice gives
    psi = sqrt(a1^2 + 4 a2 theta), rho = a1 / psi. The 3x3 normal
    equations are solved closed-form (``ops.svi._solve3x3``).
    ``k``/``w``: (..., E, n); ``weights`` (..., E, n) match the fit's
    residual weights (squared here: the residual form multiplies r by the
    weight), so masked or padded quotes cannot steer the init: a slice of
    placeholder w would otherwise inflate its theta estimate, and the
    running max below would drag every later slice's init up with it.
    """
    X = torch.stack([torch.ones_like(k), k, k * k], dim=-1)      # (..., E, n, 3)
    sq = torch.ones_like(w) if weights is None else weights * weights
    A = torch.einsum("...en,...eni,...enj->...eij", sq, X, X)
    A = A + 1e-8 * torch.eye(3, dtype=w.dtype, device=w.device)
    rhs = torch.einsum("...eni,...en->...ei", X, sq * w)
    sol = _solve3x3(A, rhs)                                       # (..., E, 3)
    theta = sol[..., 0].clamp_min(1e-5)
    # fully-masked slices carry no information: park them at the floor
    # so the running max below takes the preceding live slice's level
    if weights is not None:
        live = sq.sum(dim=-1) > 1e-12
        theta = torch.where(live, theta, 1e-5)
        sol = torch.where(live[..., None], sol, 0.0)
    # enforce increasing ATM variance before inversion (running max)
    theta = torch.cummax(theta, dim=-1).values
    theta = theta + 1e-6 * torch.arange(theta.shape[-1], dtype=theta.dtype,
                                        device=theta.device)
    s = sol[..., 1]                                               # ATM skew
    c = (2.0 * sol[..., 2]).clamp_min(0.0)                        # ATM curvature
    # psi^2 rho^2 = s^2 and psi^2 (1-rho^2) = 2 c theta
    psi = torch.sqrt(s * s + 2.0 * c * theta)
    cap = _PSI_FRAC * psi_butterfly_cap(
        theta, (s / psi.clamp_min(1e-8)).clamp(-0.9, 0.9))
    psi = torch.clamp(psi, 0.05 * cap, 0.95 * cap)
    rho = (s / psi.clamp_min(1e-8)).clamp(-0.95, 0.95)
    return _inv_transform(theta, rho, psi)


def _residual(z, k, w, weights, k_pen, calendar_weight, E):
    """Data residuals (..., E n) followed, when ``calendar_weight`` > 0,
    by the hinge on adjacent-slice crossings over the common dense grid
    ``k_pen`` (..., m): (..., (E-1) m)."""
    params = _transform(z, E)                                     # (..., E, 3)
    r = ((essvi_w(params, k) - w) * weights).flatten(-2)
    if calendar_weight > 0.0:
        wp = essvi_w(params, k_pen[..., None, :])                 # (..., E, m)
        gap = wp[..., 1:, :] - wp[..., :-1, :]
        r = torch.cat([r, calendar_weight * gap.clamp_max(0.0).flatten(-2)], dim=-1)
    return r


# --- block-tridiagonal Gauss-Newton machinery (solver='block') -------------
#
# The generic LM path (ops.lm) forms the dense (3E, 3E) normal equations
# and Cholesky-factorises them. But the problem is block-structured in
# SLICE space: data residuals of slice e depend only on that slice's
# (theta, rho, psi), and the calendar hinge couples only adjacent slices,
# so B = J_s^T J_s is block-TRIDIAGONAL with 3x3 blocks. The z-space
# Jacobian is J_z = J_s Phi with Phi = d(slice params)/dz (triangular
# through the cumsum theta-transform, invertible since softplus' > 0),
# and the undamped GN step satisfies
#   (Phi^T B Phi) dz = -Phi^T g_s  <=>  dz = Phi^{-1} B^{-1} (-g_s),
# i.e. solve the BLOCK-TRIDIAGONAL system in slice space, then pull the
# step back through Phi^{-1} (a diagonal+differencing map, O(E)).
# Marquardt damping is applied to B's diagonal blocks: damping in the
# slice metric rather than the z metric, which changes the iterate path
# but not the fixed points; acceptance still tests the true z-space
# cost, so every structural guarantee of the transform is preserved.
# O(E) 3x3 solves replace the O((3E)^3) dense factorisation.


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse, computed once per block so the forward
    elimination's two solves against the same Schur complement (and the
    backward pass's re-solve) share one determinant and cofactor set.

    The cofactors of row i are the cross product of the other two rows
    (the products and differences of ``ops.svi.adjugate3x3``'s elementwise
    formulas), so an inverse is seven launches on the card where the
    elementwise form took about forty: the loop inverts one block a slice
    step on every surface of the batch, and at the book's 32,768 surfaces
    those launches, each a few microseconds of device time, set the pace of
    the whole fit."""
    r1, r2, r3 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c1 = torch.linalg.cross(r2, r3)
    adj = torch.stack([c1, torch.linalg.cross(r3, r1), torch.linalg.cross(r1, r2)], dim=-1)
    return adj / (r1 * c1).sum(dim=-1)[..., None, None]


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def _block_thomas(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the symmetric block-tridiagonal systems with diagonal blocks
    ``D`` (..., E, 3, 3), superdiagonal blocks ``U`` (..., E-1, 3, 3)
    (subdiagonal = U^T), RHS ``b`` (..., E, 3). A block Thomas loop over
    the E slices, each step batched over the leading dimensions, with
    closed-form 3x3 inverses. Each Schur complement is inverted exactly
    once and reused by the forward elimination (two products) and the
    backward substitution."""
    E = D.shape[-3]
    S_inv = [_inv3x3(D[..., 0, :, :])]
    y = [b[..., 0, :]]
    for e in range(1, E):
        Ut = U[..., e - 1, :, :].mT
        SinvU = S_inv[e - 1] @ U[..., e - 1, :, :]
        Sinvy = _matvec(S_inv[e - 1], y[e - 1])
        S_inv.append(_inv3x3(D[..., e, :, :] - Ut @ SinvU))
        y.append(b[..., e, :] - _matvec(Ut, Sinvy))
    x = [None] * E
    x[E - 1] = _matvec(S_inv[E - 1], y[E - 1])
    for e in range(E - 2, -1, -1):
        x[e] = _matvec(S_inv[e], y[e] - _matvec(U[..., e, :, :], x[e + 1]))
    return torch.stack(x, dim=-2)


def _pullback_step(z, d_slice, E):
    """Map a slice-space step (..., E, 3) = (dtheta, drho, dpsi) to the
    exact z-space step via Phi^{-1} (the transform's inverse tangent map)."""
    z_th, z_rho, z_psi = z[..., :E], z[..., E:2 * E], z[..., 2 * E:]
    params = _transform(z, E)
    theta, rho = params[..., 0], params[..., 1]
    d_th, d_rho, d_psi = d_slice[..., 0], d_slice[..., 1], d_slice[..., 2]
    # theta = cumsum(softplus(z_th) + eps): dz = diff(dtheta)/sigmoid
    d_incr = torch.cat([d_th[..., :1], torch.diff(d_th, dim=-1)], dim=-1)
    dz_th = d_incr / torch.sigmoid(z_th).clamp_min(1e-8)
    # rho = RHO_MAX tanh(z_rho)
    dz_rho = d_rho / (_RHO_MAX * (1.0 - torch.tanh(z_rho) ** 2)).clamp_min(1e-8)
    # psi = PSI_FRAC cap(theta, rho) sigmoid(z_psi): remove the induced
    # (theta, rho) motion, then invert the sigmoid factor
    cap = psi_butterfly_cap(theta, rho)
    cap_th, cap_rho = psi_butterfly_cap_grads(theta, rho)
    sig = torch.sigmoid(z_psi)
    induced = _PSI_FRAC * sig * (cap_th * d_th + cap_rho * d_rho)
    dz_psi = (d_psi - induced) / (_PSI_FRAC * cap * sig * (1.0 - sig)).clamp_min(1e-8)
    return torch.cat([dz_th, dz_rho, dz_psi], dim=-1)


def _slice_jacobians(params: torch.Tensor, k: torch.Tensor):
    """w and dw/d(theta, rho, psi) of every slice at its own strikes:
    ``params`` (B, E, 3), ``k`` (B, E, m) -> (B, E, m), (B, E, m, 3)."""
    B, E, m = k.shape
    pf, kf = params.reshape(B * E, 3), k.reshape(B * E, m)
    J = vmap(jacfwd(essvi_w))(pf, kf)
    return essvi_w(params, k), J.reshape(B, E, m, 3)


def _pad_slices(a: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero slices before/after along the E axis of (B, E', ...)."""
    pad = [0, 0] * (a.dim() - 2) + [before, after]
    return torch.nn.functional.pad(a, pad)


def _fit_essvi_block(k, w, weights, k_pen, max_iters, calendar_weight,
                     tol=1e-12) -> EssviFit:
    """Block-tridiagonal LM for a batch of surfaces (see the banner
    comment): ``k``/``w``/``weights`` (B, E, n), ``k_pen`` (B, m)."""
    B, E, _ = k.shape
    dtype, device = w.dtype, w.device
    cw = float(calendar_weight)
    k_pen_e = k_pen[:, None, :].expand(B, E, k_pen.shape[-1])
    eye = torch.eye(3, dtype=dtype, device=device)

    def cost_of(z):
        r = _residual(z, k, w, weights, k_pen, calendar_weight, E)
        return 0.5 * (r * r).sum(dim=-1)

    with span("iv.essvi.init"):
        z = essvi_init(k, w, weights)
        state = (z, torch.full((B,), 1e-3, dtype=dtype, device=device), cost_of(z),
                 torch.zeros((B,), dtype=torch.int32, device=device),
                 torch.zeros((B,), dtype=torch.bool, device=device))
    for _ in range(max_iters):
        z, lam, cost = state[:3]
        with span("iv.essvi.linearize"):
            params = _transform(z, E)                              # (B, E, 3)
            w_d, J_w = _slice_jacobians(params, k)
            r_d = (w_d - w) * weights                              # (B, E, n)
            J_d = J_w * weights[..., None]                         # (B, E, n, 3)
            g = torch.einsum("benp,ben->bep", J_d, r_d)
            D = torch.einsum("benp,benq->bepq", J_d, J_d)
            if cw > 0.0:
                wp, Dp = _slice_jacobians(params, k_pen_e)         # (B, E, m), (B, E, m, 3)
                gap = wp[:, 1:] - wp[:, :-1]
                r_c = cw * gap.clamp_max(0.0)                      # (B, E-1, m)
                mask = (gap < 0.0).to(dtype)[..., None]
                J_lo = -cw * mask * Dp[:, :-1]                     # d r_c / d slice e
                J_hi = cw * mask * Dp[:, 1:]                       # d r_c / d slice e+1
                g = (g + _pad_slices(torch.einsum("bemp,bem->bep", J_lo, r_c), 0, 1)
                     + _pad_slices(torch.einsum("bemp,bem->bep", J_hi, r_c), 1, 0))
                D = (D + _pad_slices(torch.einsum("bemp,bemq->bepq", J_lo, J_lo), 0, 1)
                     + _pad_slices(torch.einsum("bemp,bemq->bepq", J_hi, J_hi), 1, 0))
                U = torch.einsum("bemp,bemq->bepq", J_lo, J_hi)
            else:
                U = torch.zeros((B, E - 1, 3, 3), dtype=dtype, device=device)

        with span("iv.essvi.solve"):
            diag = torch.diagonal(D, dim1=-2, dim2=-1)             # (B, E, 3)
            # absolute floor keyed to the SURFACE's diagonal scale: a fully
            # masked slice has D = 0, and a lam-proportional damp alone
            # (lam * 1e-12) underflows the float32 3x3 determinant -> NaN
            # step -> every iteration rejected while lam grows
            floor = 1e-8 * diag.flatten(-2).amax(dim=-1).clamp_min(1.0)
            damp = lam[:, None, None] * diag.clamp_min(1e-12) + floor[:, None, None]
            d_slice = _block_thomas(D + damp[..., None] * eye, U, -g)  # (B, E, 3)
            z_new = z + _pullback_step(z, d_slice, E)
        with span("iv.essvi.step"):
            cost_new = cost_of(z_new)
            accept = (cost_new < cost) & torch.isfinite(z_new).all(dim=-1)
            z_next, lam, cost_next, n_acc = lm_accept(state, z_new, cost_new, accept)
            # convergence bookkeeping mirrors ops/lm.py, small_step gated on
            # acceptance; there is no gradient test in slice space
            small_step = accept & (d_slice.abs().flatten(-2).amax(dim=-1)
                                   < tol * (1.0 + z_next.abs().amax(dim=-1)))
            small_impr = accept & (cost - cost_new < tol * cost.clamp_min(1.0))
            state = (z_next, lam, cost_next, n_acc, state[4] | small_step | small_impr)
    z, _, cost, n_acc, converged = state
    return EssviFit(params=_transform(z, E), cost=cost, n_accepted=n_acc,
                    converged=converged)


def _penalty_grid(k: torch.Tensor, weights: torch.Tensor, n_penalty_grid: int) -> torch.Tensor:
    """Calendar-penalty grid (B, m) over the intersection of the QUOTED
    strike ranges, masked by the weights and not the raw first/last
    columns: zero-weight padded or sentinel strikes would collapse the
    range and move the hinge off the quoted region."""
    live = weights > 0
    inf = float("inf")
    k_lo = torch.where(live, k, inf).amin(dim=-1)                  # (B, E)
    k_hi = torch.where(live, k, -inf).amax(dim=-1)
    has = live.any(dim=-1)
    k_lo = torch.where(has, k_lo, k[..., 0])
    k_hi = torch.where(has, k_hi, k[..., -1])
    return linspace_last(k_lo.amax(dim=-1), k_hi.amin(dim=-1), n_penalty_grid)


def fit_essvi_batched(k: torch.Tensor, w: torch.Tensor,
                      weights: torch.Tensor | None = None, max_iters: int = 64,
                      calendar_weight: float = 10.0, n_penalty_grid: int = 33,
                      loss: str = "linear", huber_delta: float = 1e-3,
                      solver: str = "block") -> EssviFit:
    """Batched eSSVI: ``k``/``w`` (..., E, n) -> params (..., E, 3).

    Unlike ``fit_svi_batched`` (which flattens surfaces x expiries into
    independent 5-parameter problems), each SURFACE here is one joint
    3E-parameter problem; only the surface axes are batched. Every iterate
    is butterfly-free per slice with increasing ATM variance by
    construction.

    ``loss='huber'`` makes the data term (and penalty) pseudo-Huber with
    scale ``huber_delta`` so outlier quotes cannot dominate the joint fit
    (``ops.lm.robustify``). ``solver='block'`` (default) exploits the
    block-tridiagonal structure of the normal equations in slice space:
    O(E) 3x3 solves instead of a dense (3E)^3 Cholesky (see the banner
    comment above ``_block_thomas``); ``solver='dense'`` is the generic
    ``ops.lm`` path (also used for ``loss='huber'``, whose row reweighting
    breaks the block assembly), run :data:`_DENSE_CHUNK` surfaces at a
    time to bound its memory.

    Host counters, read by nothing in the loop: ``fit_essvi_batched.calls``
    (calls), ``.iterations`` (``max_iters`` of every call), ``.surfaces``
    (surfaces summed over calls) and ``.by_solver`` (calls by the route
    taken, ``block`` or ``dense``).
    """
    max_iters, n_penalty_grid = int(max_iters), int(n_penalty_grid)
    calendar_weight, huber_delta = float(calendar_weight), float(huber_delta)
    if solver not in ("block", "dense"):
        raise ValueError(f"unknown solver: {solver!r}")
    if loss not in ("linear", "huber"):
        raise ValueError(f"unknown loss: {loss!r}")
    if weights is None:
        weights = torch.ones_like(w)
    batch = w.shape[:-2]
    E, n = w.shape[-2:]
    kf, wf, wtf = (a.reshape(-1, E, n) for a in (k, w, weights))
    route = "block" if solver == "block" and loss == "linear" else "dense"
    fit_essvi_batched.calls += 1
    fit_essvi_batched.iterations += max_iters
    fit_essvi_batched.surfaces += kf.shape[0]
    fit_essvi_batched.by_solver[route] += 1
    k_pen = _penalty_grid(kf, wtf, n_penalty_grid).to(k.dtype)
    if route == "block":
        fit = _fit_essvi_block(kf, wf, wtf, k_pen, max_iters, calendar_weight)
    else:
        residual = partial(_residual, calendar_weight=calendar_weight, E=E)
        if loss == "huber":
            residual = robustify(residual, huber_delta)
        parts = []
        for s in range(0, kf.shape[0], _DENSE_CHUNK):
            part = tuple(a[s:s + _DENSE_CHUNK] for a in (kf, wf, wtf, k_pen))
            res = levenberg_marquardt_batched(
                residual, essvi_init(*part[:3]), *part, max_iters=max_iters)
            parts.append((_transform(res.params, E), *res[1:]))
        fit = EssviFit(*(torch.cat(cols) for cols in zip(*parts)))
    return EssviFit(*(a.reshape(batch + a.shape[1:]) for a in fit))


fit_essvi_batched.calls = 0
fit_essvi_batched.iterations = 0
fit_essvi_batched.surfaces = 0
fit_essvi_batched.by_solver = {"block": 0, "dense": 0}


def fit_essvi(k, w, weights=None, max_iters: int = 64,
              calendar_weight: float = 10.0, n_penalty_grid: int = 33,
              loss: str = "linear", huber_delta: float = 1e-3,
              solver: str = "block") -> EssviFit:
    """Calibrate one eSSVI surface: ``k``/``w`` (E, n) -> params (E, 3).
    See :func:`fit_essvi_batched`."""
    fit = fit_essvi_batched(
        k[None], w[None], None if weights is None else weights[None],
        max_iters=max_iters, calendar_weight=calendar_weight,
        n_penalty_grid=n_penalty_grid, loss=loss, huber_delta=huber_delta,
        solver=solver)
    return EssviFit(*(a[0] for a in fit))
