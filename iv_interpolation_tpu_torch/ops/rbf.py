"""RBF / thin-plate-spline surfaces on scattered quotes (port of
``iv_interpolation_tpu/ops/rbf.py``).

Every function takes a batch of surfaces on a leading axis, or one
surface without it: points (..., N, 2), values (..., N). The dense
algebra is ``torch.linalg`` (LU for the bordered saddle systems, Cholesky
with a p x p Schur step in the penalized solver) and ``torch.matmul`` in
the inputs' dtype; on the card TF32 is held off (``_build.pin_precision``).
A failed factorization gives NaN for its surface, never an exception, and
nothing reads the device on the host.

Kernels (polynomial tails as SciPy's ``RBFInterpolator`` defaults):
  * ``thin_plate``   phi(r) = r^2 log r, degree-1 tail [1, x, y]
  * ``gaussian``     phi(r) = exp(-(eps r)^2), degree-0 tail [1]
  * ``multiquadric`` phi(r) = -sqrt(1 + (eps r)^2), degree-0 tail [1]

``fit_rbf_arbfree`` minimises the data misfit plus a native-space
seminorm and hinge penalties on Gatheral's butterfly g and on calendar
differences over a uniform penalty grid (damped Gauss-Newton with masks
instead of branches, best-feasible tracking); at zero penalty weights it
solves the weighted smoothing-RBF saddle system directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from iv_interpolation_tpu_torch._build import pin_precision
from iv_interpolation_tpu_torch.ops.svi import unit_steps


def _pin(t: torch.Tensor) -> None:
    if t.is_cuda:
        pin_precision()


def _pairwise_r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances between point sets (..., N, 2) x (..., M, 2)
    -> (..., N, M)."""
    d = a[..., :, None, :] - b[..., None, :, :]
    return torch.sqrt((d * d).sum(-1) + 1e-300)


def _kernel(r: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    if kind == "thin_plate":
        # r^2 log r, with the r=0 limit 0
        return torch.where(r > 1e-100, r * r * torch.log(torch.clamp_min(r, 1e-100)), 0.0)
    if kind == "gaussian":
        return torch.exp(-((eps * r) ** 2))
    if kind == "multiquadric":
        return -torch.sqrt(1.0 + (eps * r) ** 2)
    raise ValueError(f"unknown RBF kernel: {kind!r}")


# polynomial-tail terms per kernel: thin_plate [1, x, y], the others [1]
_POLY_TERMS = {"thin_plate": 3, "gaussian": 1, "multiquadric": 1}


def _poly(points: torch.Tensor, p: int) -> torch.Tensor:
    """The tail's basis at ``points`` (..., N, 2): (..., N, p)."""
    ones = torch.ones_like(points[..., :1])
    return ones if p == 1 else torch.cat([ones, points], dim=-1)


def _solve_or_nan(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve`` of (..., P, P) systems by LU; a singular
    system gives NaN for its surface instead of raising."""
    x, info = torch.linalg.solve_ex(A, b, check_errors=False)
    return torch.where((info == 0)[..., None], x, float("nan"))


def fit_rbf(points: torch.Tensor, values: torch.Tensor, smoothing: float = 0.0,
            kernel: str = "thin_plate", epsilon: float = 1.0) -> dict:
    """Fit RBF surfaces through scattered ``points`` -> ``values``.

    Args:
      points: (..., N, 2) quote coordinates (log-moneyness, maturity).
      values: (..., N) observed values (total variance).
      smoothing: ridge on the kernel block (SciPy ``smoothing``).
      kernel/epsilon: kernel family and shape parameter.

    Returns a dict with ``points``, ``coef`` (..., N) and ``poly`` (..., 3)
    (zeros past the kernel's tail terms).
    """
    if kernel not in _POLY_TERMS:
        raise ValueError(f"unknown RBF kernel: {kernel!r}")
    p = _POLY_TERMS[kernel]
    _pin(points)
    n = points.shape[-2]
    eye = torch.eye(n, dtype=values.dtype, device=values.device)
    A = _kernel(_pairwise_r(points, points), kernel, epsilon) + smoothing * eye
    P = _poly(points, p)
    zeros = torch.zeros((*P.shape[:-2], p, p), dtype=values.dtype, device=values.device)
    lhs = torch.cat([torch.cat([A, P], -1), torch.cat([P.mT, zeros], -1)], -2)
    rhs = F.pad(values, (0, p))
    sol = _solve_or_nan(lhs, rhs)
    return {"points": points, "coef": sol[..., :n], "poly": F.pad(sol[..., n:], (0, 3 - p))}


def eval_rbf(fit: dict, query: torch.Tensor, kernel: str = "thin_plate",
             epsilon: float = 1.0) -> torch.Tensor:
    """Evaluate fitted RBF surfaces at ``query`` (..., M, 2) -> (..., M)."""
    _pin(query)
    K = _kernel(_pairwise_r(query, fit["points"]), kernel, epsilon)
    poly = fit["poly"]
    out = (K @ fit["coef"][..., None])[..., 0]
    return out + poly[..., :1] + (query @ poly[..., 1:, None])[..., 0]


def fit_eval_rbf_batched(points, values, query, smoothing=0.0,
                         kernel="thin_plate", epsilon=1.0):
    """Batched fit + eval: leading batch axis on points/values/query."""
    fit = fit_rbf(points, values, smoothing=smoothing, kernel=kernel, epsilon=epsilon)
    return eval_rbf(fit, query, kernel=kernel, epsilon=epsilon)


# ---------------------------------------------------------------------------
# No-arbitrage penalty smoothing: the fit minimises
#
#   ||w(x_i) - y_i||^2  +  s * c^T K c            (native-space seminorm)
#   + lam_b * sum min(g_fd(w_grid), 0)^2          (butterfly hinge)
#   + lam_c * sum min(dw/dT_grid, 0)^2            (calendar hinge)
#   subject to  P^T c = 0                          (CPD side condition)
#
# over a uniform (E_pen, m_pen) penalty grid. The surface is linear in the
# coefficients, so each Gauss-Newton step is a penalized linear least
# squares with the hinge's active set as a mask. The butterfly g uses the
# stencils of ``surface.arbitrage.butterfly_g_fd``. At lam_b = lam_c = 0
# the stationarity reduces to SciPy's smoothing-RBF system.
# ---------------------------------------------------------------------------


def _fd1(w: torch.Tensor, h) -> torch.Tensor:
    """First-derivative stencil along the last axis, uniform spacing ``h``
    (broadcast against w's leading axes): midpoint-slope average inside,
    one-sided ends, as ``butterfly_g_fd``."""
    mid = (w[..., 1:] - w[..., :-1]) / h
    return torch.cat([mid[..., :1], (mid[..., 1:] + mid[..., :-1]) / 2.0, mid[..., -1:]], -1)


def _fd2(w: torch.Tensor, h) -> torch.Tensor:
    """Second-derivative stencil along the last axis, endpoints copying
    their neighbours, as ``butterfly_g_fd``."""
    mid = (w[..., 1:] - w[..., :-1]) / h
    inner = (mid[..., 1:] - mid[..., :-1]) / h
    return torch.cat([inner[..., :1], inner, inner[..., -1:]], -1)


def _g_partials(k, w, w1, w2, eps=1e-12):
    """(g, dg/dw, dg/dw1) of Gatheral's butterfly g in closed form, for the
    Gauss-Newton Jacobian (dg/dw2 = 1/2)."""
    sw = w > eps
    ws = torch.clamp_min(w, eps)
    u = 1.0 - k * w1 / (2.0 * ws)
    g = u * u - (w1 * w1 / 4.0) * (1.0 / ws + 0.25) + w2 / 2.0
    inv_w2 = 1.0 / (ws * ws)
    dg_dw = torch.where(sw, (u * k * w1 + w1 * w1 / 4.0) * inv_w2, 0.0)
    dg_dw1 = -u * k / ws - (w1 / 2.0) * (1.0 / ws + 0.25)
    return g, dg_dw, dg_dw1


def _live_rank_centers(points, wts, n_centers: int):
    """``n_centers`` centers rank-strided over each surface's LIVE sites:
    the j-th holds live-rank round(j (L-1) / (c-1)); fewer live sites than
    centers duplicate ranks. Returns (centers (B, c, 2), their weights)."""
    B, n = wts.shape
    csum = torch.cumsum((wts > 0).to(torch.int64), -1)          # 1-based ranks
    n_live = torch.clamp_min(csum[:, -1], 1)
    frac = torch.arange(n_centers, dtype=torch.float64, device=wts.device) / max(n_centers - 1, 1)
    ranks = 1 + torch.minimum(torch.round(frac[None] * (n_live - 1)[:, None]).to(torch.int64),
                              (n_live - 1)[:, None])
    cidx = torch.clamp(torch.searchsorted(csum, ranks, side="left"), 0, n - 1)
    return torch.gather(points, 1, cidx[..., None].expand(B, n_centers, 2)), torch.gather(wts, 1, cidx)


def fit_rbf_arbfree(points: torch.Tensor, values: torch.Tensor,
                    weights: torch.Tensor | None = None, smoothing: float = 1e-8,
                    kernel: str = "thin_plate", epsilon: float = 1.0,
                    butterfly_weight: float = 1000.0, calendar_weight: float = 1000.0,
                    butterfly_margin: float = 1e-3, calendar_margin: float = 3e-3,
                    n_pen_t: int = 12, n_pen_k: int = 33, n_iters: int = 16,
                    n_centers: int | None = None) -> dict:
    """Fit RBF total-variance surfaces with no-arbitrage hinge penalties.

    Args:
      points: (..., N, 2) scattered (log-moneyness k, maturity T) sites.
      values: (..., N) observed total variance w = iv^2 T.
      weights: optional (..., N) data weights (0 drops a padded quote
        from the data term and pins its coefficient to ~0).
      smoothing: native-space seminorm weight (SciPy-equivalent at zero
        penalty weights).
      butterfly_weight / calendar_weight: hinge weights on the normalised
        objective (data term averaged over quotes, hinges over penalty
        points). Either 0 disables that penalty; with both 0 and the full
        basis the weighted saddle system is solved directly.
      butterfly_margin / calendar_margin: the hinges act below these and
        push the linearised constraint to them.
      n_pen_t / n_pen_k: penalty-grid shape over the live quotes' box.
      n_iters: damped Gauss-Newton iterations.
      n_centers: optional reduced basis size c < N: c centers rank-strided
        over the live sites, the data term over all quotes (least-squares
        RBF); such a fit always runs the damped iterations. None, 0 or
        c >= N keep every site as a center.

    Returns a dict as :func:`fit_rbf` (``points`` = the centers) plus
    ``pen_k_grid`` (..., n_pen_k), ``pen_t_grid`` (..., n_pen_t),
    ``pen_w``/``pen_g`` (..., n_pen_t, n_pen_k) and the penalty-grid flags
    ``butterfly_ok``/``calendar_ok`` (...).
    """
    if kernel not in _POLY_TERMS:
        raise ValueError(f"unknown RBF kernel: {kernel!r}")
    if n_pen_t < 1 or n_pen_k < 3:
        # the butterfly stencils need >= 3 strike points; one T row is
        # fine (no calendar pairs then)
        raise ValueError(f"penalty grid too small: n_pen_t={n_pen_t} "
                         f"(>= 1), n_pen_k={n_pen_k} (>= 3)")
    if calendar_weight > 0.0 and n_pen_t < 2:
        raise ValueError("calendar_weight > 0 needs n_pen_t >= 2 "
                         "(calendar pairs compare adjacent T slices)")
    one = points.dim() == 2                         # one surface, no batch axis
    if one:
        points, values = points[None], values[None]
        weights = None if weights is None else weights[None]
    _pin(points)
    dtype, dev = values.dtype, values.device
    B, n = values.shape
    p = _POLY_TERMS[kernel]
    wts = torch.ones_like(values) if weights is None else weights.to(dtype)
    live = wts > 0
    kern = lambda a, b: _kernel(_pairwise_r(a, b), kernel, epsilon)

    reduced = n_centers is not None and 0 < n_centers < n
    if reduced:
        centers, cw = _live_rank_centers(points, wts, n_centers)
        c = n_centers
    else:
        centers, cw, c = points, wts, n
    P = c + p
    eye = torch.eye(P, dtype=dtype, device=dev)

    # data operator A_d = [K_dc | P_d] (B, N, P); with full centers K_dc is
    # the sites' Gram K_cc
    K_dc = kern(points, centers)
    K_cc = kern(centers, centers) if reduced else K_dc
    P_d, P_c = _poly(points, p), _poly(centers, p)
    A_d = torch.cat([K_dc, P_d], -1)

    # uniform penalty grid over the LIVE quotes' bounding box
    inf = float("inf")
    k_lo = torch.where(live, points[..., 0], inf).amin(-1)
    k_hi = torch.where(live, points[..., 0], -inf).amax(-1)
    t_lo = torch.where(live, points[..., 1], inf).amin(-1)
    t_hi = torch.where(live, points[..., 1], -inf).amax(-1)
    kg = unit_steps(n_pen_k, dtype, dev)[None] * (k_hi - k_lo)[:, None] + k_lo[:, None]
    tg = unit_steps(n_pen_t, dtype, dev)[None] * (t_hi - t_lo)[:, None] + t_lo[:, None]
    # all live quotes at one strike: h_k = 0 would NaN the stencils
    h_k = torch.clamp_min((k_hi - k_lo) / (n_pen_k - 1), 1e-6)
    q = torch.stack([kg.repeat(1, n_pen_t), tg.repeat_interleave(n_pen_k, -1)], -1)
    A_g = torch.cat([kern(q, centers), _poly(q, p)], -1)            # (B, G, P)

    # stencil-transformed operators: A_g's columns per slice, along k
    A3 = A_g.reshape(B, n_pen_t, n_pen_k, P)
    h4 = h_k[:, None, None, None]
    W1A = _fd1(A3.mT, h4).mT.reshape(B, -1, P)
    W2A = _fd2(A3.mT, h4).mT.reshape(B, -1, P)
    CA = (A3[:, 1:] - A3[:, :-1]).reshape(B, -1, P)                 # calendar rows

    # fixed quadratic part, normalised: data by the effective quote count,
    # each hinge by its penalty-point count; the data term is sum w_i r_i^2
    inv_nd = 1.0 / torch.clamp_min(wts.sum(-1), 1.0)
    inv_gb = 1.0 / (n_pen_t * n_pen_k)
    inv_gc = 1.0 / max((n_pen_t - 1) * n_pen_k, 1)
    sqw = torch.sqrt(wts)
    A_dw = sqw[..., None] * A_d
    K_pad = F.pad(K_cc, (0, p, 0, p))
    # duplicated reduced centers make exact zero Gram directions, which
    # the larger ridge absorbs
    ridge = 1e-7 if reduced else 1e-12
    H0 = inv_nd[:, None, None] * (A_dw.mT @ A_dw + smoothing * K_pad) + ridge * eye
    # pin weight-0 sites' coefficients to ~0, relative to H0's diagonal
    pin = F.pad(torch.where(cw > 0, 0.0, 1.0).to(dtype), (0, p))
    H0 = H0 + torch.diag_embed(pin) * 1e6 * torch.diagonal(H0, dim1=-2, dim2=-1).amax(-1)[:, None, None]
    b0 = inv_nd[:, None] * (A_dw.mT @ (sqw * values)[..., None])[..., 0]
    # CPD side condition P^T c = 0 through KKT rows
    Pt = F.pad(P_c, (0, 0, 0, p))                                   # (B, P, p)
    kg_row = kg[:, None, :].expand(B, n_pen_t, n_pen_k)
    h3 = h_k[:, None, None]
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    penalized = butterfly_weight > 0.0 or calendar_weight > 0.0

    def hinge_parts(u):
        """Penalty-grid g (flattened), dg/dw, dg/dw1 and the calendar
        slice differences at coefficients u."""
        w = mv(A_g, u).reshape(B, n_pen_t, n_pen_k)
        g, dg_dw, dg_dw1 = _g_partials(kg_row, w, _fd1(w, h3), _fd2(w, h3))
        return g.reshape(B, -1), dg_dw.reshape(B, -1), dg_dw1.reshape(B, -1), mv(CA, u)

    def cost_of(u):
        """(total cost, data + seminorm cost, feasible on the margin-free
        constraints), each (B,)."""
        r_d = sqw * (mv(A_d, u) - values)
        smooth_c = inv_nd * ((r_d * r_d).sum(-1) + smoothing * (u * mv(K_pad, u)).sum(-1))
        cost = smooth_c
        if not penalized:
            return cost, smooth_c, None
        gf, _, _, dw = hinge_parts(u)
        if butterfly_weight > 0.0:
            cost = cost + butterfly_weight * inv_gb * (
                torch.clamp_max(gf - butterfly_margin, 0.0) ** 2).sum(-1)
        if calendar_weight > 0.0:
            cost = cost + calendar_weight * inv_gc * (
                torch.clamp_max(dw - calendar_margin, 0.0) ** 2).sum(-1)
        feas = (gf >= -1e-8).all(-1) & (dw >= -1e-10).all(-1)
        return cost, smooth_c, feas

    def lm_step(u, mu):
        """One damped Gauss-Newton step from u: the candidate u_new (NaN
        for a surface whose factorization failed)."""
        H, rhs = H0, b0
        if penalized:
            gf, dg_dw, dg_dw1, dw = hinge_parts(u)
        if butterfly_weight > 0.0:
            act_b = (gf < butterfly_margin).to(dtype)
            J = dg_dw[..., None] * A_g + dg_dw1[..., None] * W1A + 0.5 * W2A
            Jm = act_b[..., None] * J
            H = H + butterfly_weight * inv_gb * (Jm.mT @ Jm)
            # linearised target g + J (u' - u) = margin on the active set
            rhs = rhs + butterfly_weight * inv_gb * mv(
                Jm.mT, act_b * (mv(J, u) - (gf - butterfly_margin)))
        if calendar_weight > 0.0:
            act_c = (dw < calendar_margin).to(dtype)
            Cm = act_c[..., None] * CA
            H = H + calendar_weight * inv_gc * (Cm.mT @ Cm)
            rhs = rhs + calendar_weight * inv_gc * mv(Cm.mT, act_c * calendar_margin)
        damp = mu[:, None] * torch.clamp_min(torch.diagonal(H, dim1=-2, dim2=-1), 1e-12)
        H = H + torch.diag_embed(damp)
        rhs = rhs + damp * u
        # KKT saddle solve by Cholesky of the augmented-Lagrangian shift
        # H + rho Pt Pt^T (PD everywhere, same u at the saddle) and a
        # p x p Schur complement
        rho = torch.clamp_min(torch.diagonal(H, dim1=-2, dim2=-1).amax(-1), 1.0)
        Hal = H + rho[:, None, None] * (Pt @ Pt.mT)
        if reduced:
            # the least-squares normal equations square the data operator's
            # condition number: a relative ridge bounds it
            Hal = Hal + 1e-6 * torch.diagonal(Hal, dim1=-2, dim2=-1).amax(-1)[:, None, None] * eye
        L, info = torch.linalg.cholesky_ex(Hal, check_errors=False)
        ok = (info == 0) & torch.isfinite(L).flatten(-2).all(-1)
        L = torch.where(ok[:, None, None], L, eye)
        X = torch.cholesky_solve(torch.cat([rhs[..., None], Pt], -1), L)
        x0, Y = X[..., 0], X[..., 1:]
        lam = _solve_or_nan(Pt.mT @ Y, mv(Pt.mT, x0))
        u_new = x0 - mv(Y, lam)
        return torch.where(ok[:, None], u_new, float("nan"))

    if penalized or reduced:
        # damped iterations from u = 0 (a warm start from the data-optimal
        # surface stalls in its deep violations); a reduced basis runs
        # them even at zero penalty, where one undamped solve of its
        # normal equations is too fragile in float32
        u = torch.zeros((B, P), dtype=dtype, device=dev)
        cost, _, _ = cost_of(u)
        mu = torch.full((B,), 1e-4, dtype=dtype, device=dev)
        u_best, best_smooth = u, torch.full((B,), inf, dtype=dtype, device=dev)
        any_feas = torch.zeros((B,), dtype=torch.bool, device=dev)
        for _ in range(n_iters):
            u_new = lm_step(u, mu)
            cost_new, smooth_new, feas_new = cost_of(u_new)
            accept = (cost_new < cost) & torch.isfinite(u_new).all(-1)
            u = torch.where(accept[:, None], u_new, u)
            cost = torch.where(accept, cost_new, cost)
            mu = torch.clamp(torch.where(accept, mu / 3.0, mu * 5.0), 1e-8, 1e12)
            if penalized:
                # the best FEASIBLE iterate: hinge active sets can cycle
                # near the boundary
                better = feas_new & (~any_feas | (smooth_new < best_smooth))
                u_best = torch.where(better[:, None], u_new, u_best)
                best_smooth = torch.where(better, smooth_new, best_smooth)
                any_feas = any_feas | feas_new
        if penalized:
            u = torch.where(any_feas[:, None], u_best, u)
    else:
        # zero penalty: the weighted smoothing-RBF saddle system
        #   (W K + s_eff I) c + W P p = W y,   P^T c = 0
        # (weight-0 rows need s_eff > 0); uniform weights give SciPy's
        s_eff = smoothing + 1e-12
        eye_n = torch.eye(n, dtype=dtype, device=dev)
        zeros = torch.zeros((B, p, p), dtype=dtype, device=dev)
        lhs = torch.cat([torch.cat([wts[..., None] * K_dc + s_eff * eye_n, wts[..., None] * P_d], -1),
                         torch.cat([P_d.mT, zeros], -1)], -2)
        u = _solve_or_nan(lhs, F.pad(wts * values, (0, p)))

    w_fit = mv(A_g, u).reshape(B, n_pen_t, n_pen_k)
    g_fit, _, _ = _g_partials(kg_row, w_fit, _fd1(w_fit, h3), _fd2(w_fit, h3))
    fit = {
        "points": centers, "coef": u[:, :c], "poly": F.pad(u[:, c:], (0, 3 - p)),
        "pen_k_grid": kg, "pen_t_grid": tg, "pen_w": w_fit, "pen_g": g_fit,
        "butterfly_ok": (g_fit >= -1e-8).all(-1).all(-1),
        "calendar_ok": (w_fit[:, 1:] - w_fit[:, :-1] >= -1e-10).all(-1).all(-1),
    }
    return {key: v[0] for key, v in fit.items()} if one else fit


def fit_eval_rbf_arbfree_batched(points, values, query, weights=None, **kw):
    """Batched penalized fit + eval: leading batch axis on points/values/
    query (and weights). Returns (w_query (B, M), butterfly_ok (B,),
    calendar_ok (B,)), the flags measured on the penalty grid."""
    fit = fit_rbf_arbfree(points, values, weights=weights, **kw)
    w = eval_rbf(fit, query, kernel=kw.get("kernel", "thin_plate"),
                 epsilon=kw.get("epsilon", 1.0))
    return w, fit["butterfly_ok"], fit["calendar_ok"]
