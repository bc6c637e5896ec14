"""Plain reference of the desk's eSSVI surface: Hendriks and Martini's
extended SSVI (one joint surface, per-expiry theta, rho, psi) calibrated by
Levenberg-Marquardt from the port's documented start, evaluated on the
common strike support, with Gatheral's butterfly function and the calendar
test on the grid.

Written from the published formulas, independent of the port: the slice

    w(k) = 1/2 (theta + rho psi k + sqrt((psi k + theta rho)^2 + theta^2 (1 - rho^2)))

with u = psi k + theta rho and R the square root, its strike derivatives

    w'  = psi (rho + u / R) / 2,
    w'' = psi^2 theta^2 (1 - rho^2) / (2 R^3),

and its partial derivatives in (theta, rho, psi) in closed form (the port
maps ``jacfwd``):

    dw/dtheta = (1 + (u rho + theta (1 - rho^2)) / R) / 2,
    dw/drho   = (psi k + theta psi k / R) / 2,
    dw/dpsi   = (rho k + u k / R) / 2.

The constraint transform is the one the port documents (``ops/essvi.py``):
of z = (z_theta, z_rho, z_psi), each of E entries, theta = cumsum(softplus(
z_theta) + 1e-8) + 1e-6, rho = 0.999 tanh(z_rho), psi = 0.999 cap(theta,
rho) sigmoid(z_psi) with Gatheral and Jacquier's butterfly cap min(4 / (1 +
|rho|), sqrt(4 theta / (1 + |rho|))); a slice-space step is taken back to z
through the transform's inverse tangent map, with the port's guards (each
divisor at least 1e-8; d|rho|/drho = +1 at 0; where the two caps tie, each
carries half). The start is the port's ``essvi_init``: per slice the
least-squares quadratic w ~ a0 + a1 k + a2 k^2 (normal equations with a
1e-8 ridge), theta = a0 (at least 1e-5), made increasing by a running
maximum plus 1e-6 a slice, psi = sqrt(a1^2 + 4 a2 theta) clipped to 5-95 %
of the cap, rho = a1 / psi within +-0.95, then the transform inverted
(increments at least 1e-6, rho / 0.999 within +-0.995, psi's share of the
cap within 1-99 %). The residual is the data term at the quotes followed by
the calendar hinge ``calendar_weight`` min(w_{e+1} - w_e, 0) on a grid of
``n_penalty_grid`` points over the strikes every expiry quotes.

The Levenberg-Marquardt schedule is the one the port documents for its
block solver: lambda0 = 1e-3; the slice-space normal matrix J^T J damped on
its diagonal by lambda times that diagonal (floored at 1e-12) plus 1e-8 x
max(1, the surface's largest diagonal entry); the trial accepted where its
cost is lower and its z finite; lambda divided by 3 on acceptance and
multiplied by 3 otherwise, clamped to [1e-12, 1e12]; a fixed iteration
count; a surface frozen (z and lambda) once an accepted step's largest
slice-space entry falls below 1e-12 (1 + the largest |z|) or its
improvement below 1e-12 max(cost, 1).

Departure from the port's algorithm: the slice-space system is assembled
densely, (3E, 3E) a surface, and solved by ``torch.linalg.solve``, where
the port eliminates its 3 x 3 blocks by a block Thomas loop with
closed-form inverses; in exact arithmetic the step is the same. Every
intermediate goes through the rounding it is given: none in float64 for the
reference, TF32 for the control (the dense solve runs in the inputs' dtype
with its operands and its result rounded). Uniform weights and the linear
loss only: the configuration's. Its entry points hold TF32 off in
PyTorch's products (``calibrate`` and ``surface`` set ``allow_tf32``
False). Imports nothing of the port.
"""

from __future__ import annotations

import torch

from benchmark.reference.spline import Rounding, butterfly_g, common_grid, exact

# surfaces a block: the reference runs block by block beside what the run keeps
BLOCK = 8192

RHO_MAX = 0.999
PSI_FRAC = 0.999
THETA_MIN = 1e-6
DTHETA_MIN = 1e-8
LAMBDA0 = 1e-3
TOL = 1e-12


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _parts(params: torch.Tensor):
    """theta, rho, psi of ``params`` (..., 3), each (..., 1) against k (..., n)."""
    return params[..., 0:1], params[..., 1:2], params[..., 2:3]


def _root(theta, rho, psi, k, r: Rounding):
    u = r(r(psi * k) + r(theta * rho))
    R = r(torch.sqrt(r(r(u * u) + r(r(theta * theta) * r(1.0 - r(rho * rho))))))
    return u, R


def total_variance(params: torch.Tensor, k: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """eSSVI w at log-moneyness ``k`` (..., n) of slice parameters (..., 3)."""
    theta, rho, psi = _parts(params)
    _, R = _root(theta, rho, psi, k, r)
    return r(0.5 * r(r(theta + r(r(rho * psi) * k)) + R))


def derivatives(params: torch.Tensor, k: torch.Tensor, r: Rounding = exact):
    """w, w' and w'' in k, closed form."""
    theta, rho, psi = _parts(params)
    u, R = _root(theta, rho, psi, k, r)
    w = r(0.5 * r(r(theta + r(r(rho * psi) * k)) + R))
    w1 = r(r(0.5 * psi) * r(rho + r(u / R)))
    num = r(r(r(psi * psi) * r(theta * theta)) * r(1.0 - r(rho * rho)))
    w2 = r(num / r(2.0 * r(r(R * R) * R)))
    return w, w1, w2


def jacobian(params: torch.Tensor, k: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """(..., n, 3) partial derivatives of w in (theta, rho, psi)."""
    theta, rho, psi = _parts(params)
    u, R = _root(theta, rho, psi, k, r)
    d_theta = r(0.5 * r(1.0 + r(r(r(u * rho) + r(theta * r(1.0 - r(rho * rho)))) / R)))
    psi_k = r(psi * k)
    d_rho = r(0.5 * r(psi_k + r(r(theta * psi_k) / R)))
    d_psi = r(0.5 * r(r(rho * k) + r(r(u * k) / R)))
    return torch.stack([d_theta, d_rho, d_psi], dim=-1)


def cap(theta: torch.Tensor, rho: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """Gatheral and Jacquier's butterfly cap on psi (their Theorem 4.2 with
    phi = psi / theta): psi (1 + |rho|) <= 4 and psi^2 (1 + |rho|) <= 4 theta."""
    one_r = r(1.0 + rho.abs())
    return torch.minimum(r(4.0 / one_r), r(torch.sqrt(r(r(4.0 * theta) / one_r))))


def _cap_tangent(theta, rho, r: Rounding):
    """(d cap / d theta, d cap / d rho)."""
    one_r = r(1.0 + rho.abs())
    flat = r(4.0 / one_r)
    root = r(torch.sqrt(r(r(4.0 * theta) / one_r)))
    sign = torch.where(rho >= 0, 1.0, -1.0).to(rho.dtype)
    flat_rho = r(r(-4.0 / r(one_r * one_r)) * sign)
    root_theta = r(r(2.0 / one_r) / root)
    root_rho = r(r(r(-2.0 * theta) / r(r(one_r * one_r) * root)) * sign)
    share = torch.where(flat < root, 1.0, torch.where(flat == root, 0.5, 0.0)).to(theta.dtype)
    d_theta = r(r(1.0 - share) * root_theta)
    d_rho = r(r(share * flat_rho) + r(r(1.0 - share) * root_rho))
    return d_theta, d_rho


def transform(z: torch.Tensor, E: int, r: Rounding = exact) -> torch.Tensor:
    """Unconstrained z (..., 3E) -> slice parameters (..., E, 3)."""
    z_th, z_rho, z_psi = z[..., :E], z[..., E:2 * E], z[..., 2 * E:]
    softplus = r(torch.logaddexp(z_th, torch.zeros_like(z_th)))
    theta = r(r(torch.cumsum(r(softplus + DTHETA_MIN), dim=-1)) + THETA_MIN)
    rho = r(RHO_MAX * r(torch.tanh(z_rho)))
    psi = r(r(PSI_FRAC * cap(theta, rho, r)) * r(torch.sigmoid(z_psi)))
    return torch.stack([theta, rho, psi], dim=-1)


def pullback(z: torch.Tensor, step: torch.Tensor, E: int, r: Rounding = exact) -> torch.Tensor:
    """A slice-space step (..., E, 3) taken to z (..., 3E) through the
    transform's inverse tangent map."""
    params = transform(z, E, r)
    theta, rho = params[..., 0], params[..., 1]
    z_th, z_rho, z_psi = z[..., :E], z[..., E:2 * E], z[..., 2 * E:]
    d_th, d_rho, d_psi = step[..., 0], step[..., 1], step[..., 2]
    # theta's increments carry softplus' derivative, the sigmoid
    incr = torch.cat([d_th[..., :1], r(d_th[..., 1:] - d_th[..., :-1])], dim=-1)
    dz_th = r(incr / r(torch.sigmoid(z_th)).clamp_min(1e-8))
    tanh = r(torch.tanh(z_rho))
    dz_rho = r(d_rho / r(RHO_MAX * r(1.0 - r(tanh * tanh))).clamp_min(1e-8))
    # psi follows theta and rho through its cap: take that part out first
    c = cap(theta, rho, r)
    c_th, c_rho = _cap_tangent(theta, rho, r)
    sig = r(torch.sigmoid(z_psi))
    moved = r(r(PSI_FRAC * sig) * r(r(c_th * d_th) + r(c_rho * d_rho)))
    slope = r(r(r(PSI_FRAC * c) * sig) * r(1.0 - sig)).clamp_min(1e-8)
    dz_psi = r(r(d_psi - moved) / slope)
    return torch.cat([dz_th, dz_rho, dz_psi], dim=-1)


def solve(A: torch.Tensor, b: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """x of A x = b for (..., P, P) A by ``torch.linalg.solve``, operands and
    result rounded."""
    return r(torch.linalg.solve(r(A), r(b)[..., None])[..., 0])


def init(k: torch.Tensor, w: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """The start z (S, 3E) of surfaces k, w (S, E, n)."""
    E = k.shape[-2]
    X = torch.stack([torch.ones_like(k), k, r(k * k)], dim=-1)          # (S, E, n, 3)
    A = r((X[..., :, None] * X[..., None, :]).sum(dim=-3))
    A = r(A + 1e-8 * torch.eye(3, dtype=k.dtype, device=k.device))
    b = r((X * w[..., None]).sum(dim=-2))
    a = solve(A, b, r)                                                  # (S, E, 3)
    theta = a[..., 0].clamp_min(1e-5)
    theta = torch.cummax(theta, dim=-1).values
    theta = r(theta + 1e-6 * torch.arange(E, dtype=k.dtype, device=k.device))
    skew, curv = a[..., 1], r(2.0 * a[..., 2]).clamp_min(0.0)
    psi = r(torch.sqrt(r(r(skew * skew) + r(r(2.0 * curv) * theta))))
    c = r(PSI_FRAC * cap(theta, r(skew / psi.clamp_min(1e-8)).clamp(-0.9, 0.9), r))
    psi = torch.minimum(torch.maximum(psi, r(0.05 * c)), r(0.95 * c))
    rho = r(skew / psi.clamp_min(1e-8)).clamp(-0.95, 0.95)
    # the transform inverted
    incr = torch.cat([r(theta[..., :1] - THETA_MIN),
                      r(r(theta[..., 1:] - theta[..., :-1]) - DTHETA_MIN)], dim=-1)
    incr = incr.clamp_min(1e-6)
    z_th = r(incr + r(torch.log(r(-r(torch.expm1(-incr))))))
    z_rho = r(torch.atanh(r(rho / RHO_MAX).clamp(-0.995, 0.995)))
    share = r(psi / r(PSI_FRAC * cap(theta, rho, r)).clamp_min(1e-12)).clamp(0.01, 0.99)
    z_psi = r(r(torch.log(share)) - r(torch.log1p(-share)))
    return torch.cat([z_th, z_rho, z_psi], dim=-1)


def penalty_grid(k: torch.Tensor, m: int, r: Rounding = exact) -> torch.Tensor:
    """(S, m) evenly spaced points over the strikes every expiry of k (S, E, n)
    quotes, where the calendar hinge is taken."""
    lo = k.amin(dim=-1).amax(dim=-1)
    hi = k.amax(dim=-1).amin(dim=-1)
    u = torch.arange(m, dtype=k.dtype, device=k.device) / (m - 1)
    return r(lo[..., None] + r(r(hi - lo)[..., None] * u))


def cost(params: torch.Tensor, k: torch.Tensor, w: torch.Tensor, k_pen: torch.Tensor,
         calendar_weight: float, r: Rounding = exact) -> torch.Tensor:
    """0.5 sum of squared residuals of each surface (S,): the data term at
    the quotes and the calendar hinge on the penalty grid k_pen (S, m)."""
    res = r(total_variance(params, k, r) - w)
    total = r(r(res * res).flatten(-2).sum(dim=-1))
    wp = total_variance(params, k_pen[..., None, :], r)
    hinge = r(calendar_weight * r(wp[..., 1:, :] - wp[..., :-1, :]).clamp_max(0.0))
    total = r(total + r(r(hinge * hinge).flatten(-2).sum(dim=-1)))
    return r(0.5 * total)


def dense(D: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The symmetric block-tridiagonal matrix (S, 3E, 3E) of diagonal blocks
    D (S, E, 3, 3) and superdiagonal blocks U (S, E-1, 3, 3), laid out
    densely: index 3 e + p for parameter p of slice e."""
    S, E = D.shape[:2]
    blocks = torch.zeros((S, E, E, 3, 3), dtype=D.dtype, device=D.device)
    at = torch.arange(E, device=D.device)
    blocks[:, at, at] = D
    blocks[:, at[:-1], at[1:]] = U
    blocks[:, at[1:], at[:-1]] = U.mT
    return blocks.permute(0, 1, 3, 2, 4).reshape(S, 3 * E, 3 * E)


def _outer_sum(a: torch.Tensor, b: torch.Tensor, r: Rounding) -> torch.Tensor:
    """sum over rows of a^T b: (..., m, 3) x (..., m, 3) -> (..., 3, 3)."""
    return r((a[..., :, None] * b[..., None, :]).sum(dim=-3))


def _normal_equations(params, k, w, k_pen, cw, r: Rounding):
    """The slice-space gradient (S, 3E) and normal matrix (S, 3E, 3E),
    assembled densely."""
    S, E = params.shape[:2]
    res = r(total_variance(params, k, r) - w)                           # (S, E, n)
    J = jacobian(params, k, r)                                           # (S, E, n, 3)
    g = r((J * res[..., None]).sum(dim=-2))                              # (S, E, 3)
    D = _outer_sum(J, J, r)                                              # (S, E, 3, 3)
    U = torch.zeros((S, E - 1, 3, 3), dtype=params.dtype, device=params.device)
    if cw > 0.0:
        kp = k_pen[:, None, :].expand(S, E, k_pen.shape[-1])
        wp = total_variance(params, kp, r)
        Jp = jacobian(params, kp, r)                                     # (S, E, m, 3)
        gap = r(wp[:, 1:] - wp[:, :-1])
        hinge = r(cw * gap.clamp_max(0.0))                               # (S, E-1, m)
        live = (gap < 0.0).to(params.dtype)[..., None]
        lo = r(r(-cw * live) * Jp[:, :-1])                               # d hinge / d slice e
        hi = r(r(cw * live) * Jp[:, 1:])                                 # d hinge / d slice e+1
        g[:, :-1] = r(g[:, :-1] + r((lo * hinge[..., None]).sum(dim=-2)))
        g[:, 1:] = r(g[:, 1:] + r((hi * hinge[..., None]).sum(dim=-2)))
        D[:, :-1] = r(D[:, :-1] + _outer_sum(lo, lo, r))
        D[:, 1:] = r(D[:, 1:] + _outer_sum(hi, hi, r))
        U = _outer_sum(lo, hi, r)
    return g.reshape(S, 3 * E), dense(D, U)


def fit(k: torch.Tensor, w: torch.Tensor, iters: int, calendar_weight: float,
        n_penalty_grid: int, r: Rounding = exact) -> tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt of eSSVI on surfaces k, w (S, E, n) from the
    port's start, ``iters`` iterations: (S, E, 3) parameters and (S,) cost."""
    S, E = k.shape[:2]
    cw = float(calendar_weight)
    k_pen = penalty_grid(k, n_penalty_grid, r)
    z = init(k, w, r)
    c = cost(transform(z, E, r), k, w, k_pen, cw, r)
    lam = torch.full((S,), LAMBDA0, dtype=k.dtype, device=k.device)
    frozen = torch.zeros((S,), dtype=torch.bool, device=k.device)
    eye = torch.eye(3 * E, dtype=k.dtype, device=k.device)
    for _ in range(iters):
        g, A = _normal_equations(transform(z, E, r), k, w, k_pen, cw, r)
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        floor = r(1e-8 * diag.amax(dim=-1).clamp_min(1.0))
        damp = r(r(lam[:, None] * diag.clamp_min(1e-12)) + floor[:, None])
        step = solve(r(A + r(damp[..., None] * eye)), -g, r).reshape(S, E, 3)
        z_new = r(z + pullback(z, step, E, r))
        c_new = cost(transform(z_new, E, r), k, w, k_pen, cw, r)
        accept = (c_new < c) & torch.isfinite(z_new).all(dim=-1)
        take = accept & ~frozen
        z_next = torch.where(take[:, None], z_new, z)
        c_next = torch.where(take, c_new, c)
        lam = torch.where(frozen, lam, torch.where(accept, lam / 3.0, lam * 3.0)).clamp(
            1e-12, 1e12)
        small_step = accept & (step.abs().flatten(-2).amax(dim=-1)
                               < TOL * (1.0 + z_next.abs().amax(dim=-1)))
        small_impr = accept & (r(c - c_new) < TOL * c.clamp_min(1.0))
        frozen = frozen | small_step | small_impr
        z, c = z_next, c_next
    return transform(z, E, r), c


def structure_violations(params: torch.Tensor) -> int:
    """Slices of parameters (S, E, 3) that break the structural guarantees:
    theta below the previous expiry's, |rho| not below 1, psi not above 0
    or above the butterfly cap, or any parameter not finite (float64)."""
    p = params.double()
    theta, rho, psi = p[..., 0], p[..., 1], p[..., 2]
    bad = ~torch.isfinite(p).all(dim=-1)
    bad[..., 1:] |= theta[..., 1:] < theta[..., :-1]
    bad |= (rho.abs() >= 1.0) | (psi <= 0.0) | (theta <= 0.0)
    bad |= psi > cap(theta, rho.clamp(-1.0, 1.0))
    return int(bad.sum())


def surface(coefs: torch.Tensor, k: torch.Tensor, iv: torch.Tensor, T: torch.Tensor,
            n_grid: int, tol_g: float, tol_w: float, calendar_weight: float,
            n_penalty_grid: int, r: Rounding = exact) -> dict:
    """The surface outputs of eSSVI parameters ``coefs`` (B, E, 3) fitted to
    quotes k, iv (B, E, n) with maturities T (B, E), in the dtype of the
    inputs: ``w_grid`` and ``iv_grid`` (B, E, n_grid) on the common
    support, the two tests' margins as ``spline.surface`` gives them, the
    total-variance RMSE at the quotes ``fit_rmse`` (B,) and each surface's
    ``cost`` (B,), data term and calendar hinge."""
    _no_tf32()
    w_obs = r(r(iv * iv) * T[..., None])
    grid = common_grid(k, n_grid, r)[..., None, :].expand(*k.shape[:-1], n_grid)
    S, S1, S2 = derivatives(coefs, grid, r)
    g = butterfly_g(grid, S, S1, S2, r)
    res = r(total_variance(coefs, k, r) - w_obs)
    sq = r(res * res)
    k_pen = penalty_grid(k, n_penalty_grid, r)
    return {
        "w_grid": S,
        "iv_grid": r(torch.sqrt(r(S.clamp_min(0.0) / T[..., None].clamp_min(1e-12)))),
        "butterfly_margin": (g + tol_g).flatten(-2).amin(dim=-1),
        "calendar_margin": (S[..., 1:, :] - S[..., :-1, :] + tol_w).flatten(-2).amin(dim=-1),
        "fit_rmse": r(torch.sqrt(sq.flatten(-2).mean(dim=-1))),
        "cost": cost(coefs, k, w_obs, k_pen, calendar_weight, r),
    }


def calibrate(k: torch.Tensor, iv: torch.Tensor, T: torch.Tensor, iters: int,
              calendar_weight: float, n_penalty_grid: int,
              r: Rounding = exact) -> tuple[torch.Tensor, torch.Tensor]:
    """Every surface of quotes k, iv (B, E, n), T (B, E) calibrated:
    (B, E, 3) parameters and (B,) cost."""
    _no_tf32()
    w = r(r(iv * iv) * T[..., None])
    return fit(k, w, iters, calendar_weight, n_penalty_grid, r)
