"""Plain reference of the desk's surface: a not-a-knot cubic spline in
total variance per expiry, evaluated on the common strike support, with
Gatheral's butterfly function and the calendar test on the grid.

Independent of the port by construction: it follows SciPy's
``CubicSpline`` (the first derivatives at the knots from a tridiagonal
system whose end rows carry the not-a-knot conditions, then a Hermite
cubic on each interval), where the port solves for second derivatives.
The system is solved by plain elimination in the arithmetic it is given:
float64 for the reference, or an emulated lower precision for the control.
Imports nothing of the port, takes only the raw quotes.
"""

from __future__ import annotations

from typing import Callable

import torch

Rounding = Callable[[torch.Tensor], torch.Tensor]

# surfaces a block: the reference runs block by block so that it fits
# beside what the run keeps
BLOCK = 4096


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (8 exponent bits, 10 mantissa bits),
    to nearest with ties to even, as the card rounds a TF32 product's
    inputs."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + (0x0FFF + lsb)) & ~0x1FFF
    return bits.view(torch.float32)


def not_a_knot_slopes(x: torch.Tensor, y: torch.Tensor, r: Rounding = exact) -> torch.Tensor:
    """S'(x_i) of the not-a-knot cubic through (x, y), shape (..., n),
    n >= 4: SciPy's system (``scipy/interpolate/_cubic.py``), every
    intermediate passed through ``r``."""
    n = x.shape[-1]
    if n < 4:
        raise ValueError("the reference handles n >= 4 knots")
    xs = torch.movedim(x, -1, 0)
    ys = torch.movedim(y, -1, 0)
    dx = r(xs[1:] - xs[:-1])
    slope = r(r(ys[1:] - ys[:-1]) / dx)
    sub = torch.zeros_like(xs)
    diag = torch.zeros_like(xs)
    sup = torch.zeros_like(xs)
    rhs = torch.zeros_like(xs)
    # interior rows: dx[i] s[i-1] + 2 (dx[i-1] + dx[i]) s[i] + dx[i-1] s[i+1]
    #               = 3 (dx[i] slope[i-1] + dx[i-1] slope[i])
    sub[1:-1] = dx[1:]
    diag[1:-1] = r(2.0 * r(dx[:-1] + dx[1:]))
    sup[1:-1] = dx[:-1]
    rhs[1:-1] = r(3.0 * r(r(dx[1:] * slope[:-1]) + r(dx[:-1] * slope[1:])))
    d0 = r(xs[2] - xs[0])
    diag[0] = dx[1]
    sup[0] = d0
    rhs[0] = r(r(r(r(r(dx[0] + r(2.0 * d0)) * dx[1]) * slope[0])
                 + r(r(dx[0] * dx[0]) * slope[1])) / d0)
    d1 = r(xs[-1] - xs[-3])
    diag[-1] = dx[-2]
    sub[-1] = d1
    rhs[-1] = r(r(r(r(dx[-1] * dx[-1]) * slope[-2])
                  + r(r(r(r(2.0 * d1) + dx[-1]) * dx[-2]) * slope[-1])) / d1)
    return torch.movedim(_eliminate(sub, diag, sup, rhs, r), 0, -1)


def _eliminate(sub, diag, sup, rhs, r: Rounding) -> torch.Tensor:
    """Solve the tridiagonal rows along axis 0 by forward elimination and
    back substitution (no pivoting: every pivot of these systems is
    positive)."""
    n = diag.shape[0]
    c = [r(sup[0] / diag[0])]
    d = [r(rhs[0] / diag[0])]
    for i in range(1, n):
        den = r(diag[i] - r(sub[i] * c[-1]))
        c.append(r(sup[i] / den))
        d.append(r(r(rhs[i] - r(sub[i] * d[-1])) / den))
    out = [d[-1]]
    for i in range(n - 2, -1, -1):
        out.append(r(d[i] - r(c[i] * out[-1])))
    return torch.stack(out[::-1])


def hermite(x, y, s, t, r: Rounding = exact):
    """(S, S', S'') at queries t (..., m) of the cubic with knot values y
    and slopes s on knots x (..., n); outside [x0, x_{n-1}] the end pieces
    extend, as SciPy's ``extrapolate=True`` does."""
    n = x.shape[-1]
    idx = (torch.searchsorted(x.contiguous(), t.contiguous(), right=True) - 1).clamp(0, n - 2)
    at = lambda a, j: torch.gather(a, -1, j)
    x0, x1 = at(x, idx), at(x, idx + 1)
    y0, y1 = at(y, idx), at(y, idx + 1)
    s0, s1 = at(s, idx), at(s, idx + 1)
    h = r(x1 - x0)
    slope = r(r(y1 - y0) / h)
    tt = r(r(r(s0 + s1) - r(2.0 * slope)) / h)
    c0 = r(tt / h)
    c1 = r(r(r(slope - s0) / h) - tt)
    z = r(t - x0)
    S = r(r(r(r(r(r(c0 * z) + c1) * z) + s0) * z) + y0)
    S1 = r(r(r(r(r(3.0 * c0) * z) + r(2.0 * c1)) * z) + s0)
    S2 = r(r(r(6.0 * c0) * z) + r(2.0 * c1))
    return S, S1, S2


def butterfly_g(k, w, w1, w2, r: Rounding = exact):
    """Gatheral's g(k) = (1 - k w'/(2w))^2 - (w'^2/4)(1/w + 1/4) + w''/2."""
    w = w.clamp_min(1e-12)
    u = r(1.0 - r(r(k * w1) / r(2.0 * w)))
    return r(r(r(u * u) - r(r(r(w1 * w1) / 4.0) * r(r(1.0 / w) + 0.25))) + r(w2 / 2.0))


def common_grid(k: torch.Tensor, n_grid: int, r: Rounding = exact) -> torch.Tensor:
    """(..., n_grid) evenly spaced points over the strikes that every expiry
    quotes, [max_e k[e, 0], min_e k[e, -1]] of k (..., E, n) (the ends
    swapped where the supports do not overlap)."""
    a = k[..., 0].amax(dim=-1)
    b = k[..., -1].amin(dim=-1)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    u = torch.arange(n_grid, dtype=k.dtype, device=k.device) / (n_grid - 1)
    return r(lo[..., None] + r(r(hi - lo)[..., None] * u))


def surface(k: torch.Tensor, iv: torch.Tensor, T: torch.Tensor, n_grid: int,
            tol_g: float, tol_w: float, r: Rounding = exact) -> dict:
    """The surface outputs of quotes k, iv (B, E, n) with maturities T (B, E),
    in the dtype of the inputs: ``w_grid`` and ``iv_grid`` (B, E, n_grid)
    on the common support, and the margins of the two arbitrage tests,
    ``butterfly_margin`` = min over the grid of g + tol_g and
    ``calendar_margin`` = min over k of w[e+1] - w[e] + tol_w (B,): a
    surface passes a test where its margin is >= 0."""
    w = r(r(iv * iv) * T[..., None])
    s = not_a_knot_slopes(k, w, r)
    grid = common_grid(k, n_grid, r)[..., None, :].expand(*k.shape[:-1], n_grid)
    S, S1, S2 = hermite(k, w, s, grid, r)
    g = butterfly_g(grid, S, S1, S2, r)
    iv_grid = torch.sqrt(r(S.clamp_min(0.0) / T[..., None].clamp_min(1e-12)))
    return {
        "w_grid": S,
        "iv_grid": r(iv_grid),
        "butterfly_margin": (g + tol_g).flatten(-2).amin(dim=-1),
        "calendar_margin": (S[..., 1:, :] - S[..., :-1, :] + tol_w).flatten(-2).amin(dim=-1),
    }
