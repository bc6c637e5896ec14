"""Plain reference of the desk's raw-SVI surface: Gatheral's raw SVI per
expiry, calibrated by Levenberg-Marquardt from the heuristic start,
evaluated on the common strike support, with Gatheral's butterfly
function and the calendar test on the grid.

Written from the published formulas, independent of the port: raw SVI

    w(k) = a + b (rho (k - m) + sqrt((k - m)^2 + sigma^2))

and its partial derivatives in (a, b, rho, m, sigma) in closed form (the
port maps ``jacfwd`` over its residual), w' and w'' in closed form for
g. The start is the heuristic the port documents for ``svi_init``: m at
the least quoted w, a = 0.9 of that least w (at least 1e-6), b = the
spread of w over the spread of k (each at least 1e-3), rho = 0, sigma =
0.1 of the spread of k. The Levenberg-Marquardt schedule is the one the
port documents for ``ops.lm``: lambda0 = 1e-3, damping lambda times the
diagonal of J^T J floored at 1e-12, the trial point projected on the box,
lambda divided by 3 on a lower finite cost and multiplied by 3 otherwise,
clamped to [1e-12, 1e12], a fixed iteration count, and a problem frozen
(parameters and lambda) once a step smaller than 1e-12 (relative), a
gradient below 1e-12 or an improvement below 1e-12 (of max(cost, 1)) is
seen.

Departures from the port's algorithm: the Jacobian is the closed form, not
forward-mode differentiation; the normal equations are summed product by
product; the 5 x 5 systems are solved by an elementwise Cholesky
factorization whose failure (a pivot that is not positive, or a value that
is not finite) gives that problem a NaN step, where the port reads
cuSOLVER's report; the evaluation grid is computed from the raw quotes
(``spline.common_grid``). Every intermediate goes through the rounding it
is given: none in float64 for the reference, TF32 for the control. Its
entry points hold TF32 off in PyTorch's products (``calibrate`` and
``surface`` set ``allow_tf32`` False), though every product here is
elementwise. Imports nothing of the port.
"""

from __future__ import annotations

import torch

from benchmark.reference.spline import Rounding, butterfly_g, common_grid, exact

# surfaces a block: the reference runs block by block beside what the run keeps
BLOCK = 4096

# the box of (a, b, rho, m, sigma), the port's documented bounds
LOWER = (-10.0, 1e-6, -0.9999, -10.0, 1e-6)
UPPER = (10.0, 100.0, 0.9999, 10.0, 100.0)
P = 5


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _parts(p: torch.Tensor):
    return tuple(p[..., i:i + 1] for i in range(P))


def total_variance(p: torch.Tensor, k: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """Raw SVI w at log-moneyness ``k`` (..., n) of parameters ``p`` (..., 5)."""
    a, b, rho, m, sigma = _parts(p)
    km = r(k - m)
    root = r(torch.sqrt(r(r(km * km) + r(sigma * sigma))))
    return r(a + r(b * r(r(rho * km) + root)))


def jacobian(p: torch.Tensor, k: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """(..., n, 5) partial derivatives of w in (a, b, rho, m, sigma)."""
    a, b, rho, m, sigma = _parts(p)
    km = r(k - m)
    root = r(torch.sqrt(r(r(km * km) + r(sigma * sigma))))
    d_a = torch.ones_like(km)
    d_b = r(r(rho * km) + root)
    d_rho = r(b * km)
    d_m = r(-r(b * r(rho + r(km / root))))
    d_sigma = r(r(b * sigma) / root)
    return torch.stack([d_a, d_b, d_rho, d_m, d_sigma], dim=-1)


def derivatives(p: torch.Tensor, k: torch.Tensor, r: Rounding = exact):
    """w, w' and w'' in k, closed form."""
    a, b, rho, m, sigma = _parts(p)
    km = r(k - m)
    s2 = r(sigma * sigma)
    root = r(torch.sqrt(r(r(km * km) + s2)))
    w = r(a + r(b * r(r(rho * km) + root)))
    w1 = r(b * r(rho + r(km / root)))
    w2 = r(r(b * s2) / r(r(root * root) * root))
    return w, w1, w2


def init(k: torch.Tensor, w: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """The heuristic start (..., 5) of slices k, w (..., n)."""
    w_min, at = w.min(dim=-1)
    m0 = torch.gather(k, -1, at[..., None])[..., 0]
    span = r(k.amax(dim=-1) - k.amin(dim=-1)).clamp_min(1e-3)
    b0 = r(r(w.amax(dim=-1) - w_min) / span).clamp_min(1e-3)
    a0 = r(w_min * 0.9).clamp_min(1e-6)
    return torch.stack([a0, b0, torch.zeros_like(a0), m0, r(0.1 * span)], dim=-1)


def _clip(p: torch.Tensor) -> torch.Tensor:
    lo = torch.tensor(LOWER, dtype=p.dtype, device=p.device)
    hi = torch.tensor(UPPER, dtype=p.dtype, device=p.device)
    return torch.minimum(torch.maximum(p, lo), hi)


def cost(p: torch.Tensor, k: torch.Tensor, w: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """0.5 sum of squared residuals of each slice (...,)."""
    res = r(total_variance(p, k, r) - w)
    return r(0.5 * r(res * res).sum(dim=-1))


def cholesky_solve(A: torch.Tensor, b: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """x of A x = b for (..., 5, 5) symmetric A by an elementwise Cholesky
    factorization and two substitutions; NaN for a problem whose pivot is
    not positive or whose factor is not finite."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    ok = torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
    for j in range(n):
        s = A[..., j, j]
        for q in range(j):
            s = r(s - r(L[j][q] * L[j][q]))
        ok = ok & (s > 0)
        L[j][j] = r(torch.sqrt(s.clamp_min(0.0)))
        for i in range(j + 1, n):
            t = A[..., i, j]
            for q in range(j):
                t = r(t - r(L[i][q] * L[j][q]))
            L[i][j] = r(t / L[j][j])
    y = []
    for i in range(n):
        t = b[..., i]
        for q in range(i):
            t = r(t - r(L[i][q] * y[q]))
        y.append(r(t / L[i][i]))
    x = [None] * n
    for i in range(n - 1, -1, -1):
        t = y[i]
        for q in range(i + 1, n):
            t = r(t - r(L[q][i] * x[q]))
        x[i] = r(t / L[i][i])
    out = torch.stack(x, dim=-1)
    ok = ok & torch.isfinite(out).all(dim=-1)
    return torch.where(ok[..., None], out, torch.full_like(out, float("nan")))


def fit(k: torch.Tensor, w: torch.Tensor, iters: int, r: Rounding = exact,
        tol: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt of raw SVI on slices k, w (S, n) from the
    heuristic start, ``iters`` iterations: (S, 5) parameters and (S,) cost."""
    p = _clip(init(k, w, r))
    lam = torch.full(p.shape[:-1], 1e-3, dtype=p.dtype, device=p.device)
    c = cost(p, k, w, r)
    frozen = torch.zeros_like(lam, dtype=torch.bool)
    pairs = [(i, j) for i in range(P) for j in range(i, P)]
    for _ in range(iters):
        res = r(total_variance(p, k, r) - w)
        J = jacobian(p, k, r)
        grad = r(r(J * res[..., None]).sum(dim=-2))
        A = torch.empty((*p.shape, P), dtype=p.dtype, device=p.device)
        for i, j in pairs:
            A[..., i, j] = A[..., j, i] = r(r(J[..., i] * J[..., j]).sum(dim=-1))
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        A = A + torch.diag_embed(r(lam[..., None] * diag.clamp_min(1e-12)))
        delta = cholesky_solve(A, -grad, r)
        p_new = _clip(r(p + delta))
        c_new = cost(p_new, k, w, r)
        accept = (c_new < c) & torch.isfinite(c_new)
        take = accept & ~frozen
        p_next = torch.where(take[..., None], p_new, p)
        c_next = torch.where(take, c_new, c)
        lam = torch.where(frozen, lam, torch.where(accept, lam / 3.0, lam * 3.0)).clamp(
            1e-12, 1e12)
        small_step = accept & (delta.abs().amax(dim=-1) < tol * (1.0 + p_next.abs().amax(dim=-1)))
        small_grad = grad.abs().amax(dim=-1) < tol
        small_impr = accept & (c - c_new < tol * c.clamp_min(1.0))
        frozen = frozen | small_step | small_grad | small_impr
        p, c = p_next, c_next
    return p, c


def surface(coefs: torch.Tensor, k: torch.Tensor, iv: torch.Tensor, T: torch.Tensor,
            n_grid: int, tol_g: float, tol_w: float, r: Rounding = exact) -> dict:
    """The surface outputs of SVI parameters ``coefs`` (B, E, 5) fitted to
    quotes k, iv (B, E, n) with maturities T (B, E), in the dtype of the
    inputs: ``w_grid`` and ``iv_grid`` (B, E, n_grid) on the common
    support, the two tests' margins as ``spline.surface`` gives them, the
    total-variance RMSE at the quotes ``fit_rmse`` (B,) and each slice's
    least-squares ``cost`` (B, E)."""
    _no_tf32()
    w_obs = r(r(iv * iv) * T[..., None])
    grid = common_grid(k, n_grid, r)[..., None, :].expand(*k.shape[:-1], n_grid)
    S, S1, S2 = derivatives(coefs, grid, r)
    g = butterfly_g(grid, S, S1, S2, r)
    res = r(total_variance(coefs, k, r) - w_obs)
    sq = r(res * res)
    return {
        "w_grid": S,
        "iv_grid": r(torch.sqrt(r(S.clamp_min(0.0) / T[..., None].clamp_min(1e-12)))),
        "butterfly_margin": (g + tol_g).flatten(-2).amin(dim=-1),
        "calendar_margin": (S[..., 1:, :] - S[..., :-1, :] + tol_w).flatten(-2).amin(dim=-1),
        "fit_rmse": r(torch.sqrt(sq.flatten(-2).mean(dim=-1))),
        "cost": r(0.5 * sq.sum(dim=-1)),
    }


def calibrate(k: torch.Tensor, iv: torch.Tensor, T: torch.Tensor, iters: int,
              r: Rounding = exact) -> tuple[torch.Tensor, torch.Tensor]:
    """Every slice of quotes k, iv (B, E, n), T (B, E) calibrated:
    (B, E, 5) parameters and (B, E) cost."""
    _no_tf32()
    w = r(r(iv * iv) * T[..., None])
    n = k.shape[-1]
    p, c = fit(k.reshape(-1, n), w.reshape(-1, n), iters, r)
    return p.reshape(*k.shape[:-1], P), c.reshape(k.shape[:-1])
