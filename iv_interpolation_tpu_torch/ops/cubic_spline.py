"""Batched cubic-spline smile fitting and evaluation (port of
``iv_interpolation_tpu/ops/cubic_spline.py``).

A fit solves one tridiagonal system per smile for the knot second
derivatives M; the systems go to the Thomas kernel (``ops.tridiag``) with
the smile batch flattened behind the system dimension.

Boundary conditions, as in SciPy's ``CubicSpline``:
  * ``natural``     S''(x0) = S''(xn) = 0
  * ``clamped``     S'(x0) = fp0, S'(xn) = fpn
  * ``not-a-knot``  S''' continuous at x1 and x[n-2]
"""

from __future__ import annotations

import torch

from iv_interpolation_tpu_torch.ops.tridiag import tridiag_solve


def _solve_batch_last(dl, d, du, b):
    """Tridiagonal solve for ``(..., n)`` coefficient tensors."""
    to_sys = lambda a: torch.movedim(a, -1, 0)
    M = tridiag_solve(to_sys(dl), to_sys(d), to_sys(du), to_sys(b))
    return torch.movedim(M, 0, -1)


def fit_cubic_spline(x: torch.Tensor, y: torch.Tensor, bc_type: str = "natural",
                     fp0=None, fpn=None) -> torch.Tensor:
    """Knot second derivatives M of cubic splines through ``(x, y)``.

    Args:
      x: strictly increasing knots, shape ``(..., n)`` (batch dims leading).
      y: knot values, shape ``(..., n)``, broadcastable with ``x``.
      bc_type: 'natural', 'clamped' or 'not-a-knot'.
      fp0, fpn: end slopes for 'clamped' (broadcastable to the batch shape).

    Returns M with the broadcast shape of ``x`` and ``y``.
    """
    dtype = torch.promote_types(x.dtype, y.dtype)
    x, y = torch.broadcast_tensors(x.to(dtype), y.to(dtype))
    n = x.shape[-1]
    if n < 2:
        raise ValueError("need at least 2 knots")
    if n == 2 and bc_type != "clamped":
        # a straight line (SciPy's n=2 natural / not-a-knot); clamped n=2
        # is the cubic Hermite and goes through the general system below
        return torch.zeros_like(y)

    h = torch.diff(x, dim=-1)                     # (..., n-1)
    s = torch.diff(y, dim=-1) / h                 # slopes (..., n-1)
    zero = torch.zeros_like(h[..., :1])
    cat = lambda *parts: torch.cat(parts, dim=-1)

    if bc_type == "natural":
        one = torch.ones_like(h[..., :1])
        return _solve_batch_last(
            cat(zero, h[..., :-1] / 6.0, zero),
            cat(one, (h[..., :-1] + h[..., 1:]) / 3.0, one),
            cat(zero, h[..., 1:] / 6.0, zero),
            cat(zero, s[..., 1:] - s[..., :-1], zero))

    if bc_type == "clamped":
        if fp0 is None or fpn is None:
            raise ValueError("clamped bc requires fp0 and fpn")
        batch = x.shape[:-1]
        fp0 = torch.as_tensor(fp0, dtype=dtype, device=x.device).broadcast_to(batch)
        fpn = torch.as_tensor(fpn, dtype=dtype, device=x.device).broadcast_to(batch)
        return _solve_batch_last(
            cat(zero, h[..., :-1] / 6.0, h[..., -1:] / 6.0),
            cat(h[..., :1] / 3.0, (h[..., :-1] + h[..., 1:]) / 3.0,
                h[..., -1:] / 3.0),
            cat(h[..., :1] / 6.0, h[..., 1:] / 6.0, zero),
            cat(s[..., :1] - fp0[..., None], s[..., 1:] - s[..., :-1],
                fpn[..., None] - s[..., -1:]))

    if bc_type == "not-a-knot":
        if n == 3:
            # the parabola through 3 points: constant second derivative
            M1 = 2.0 * (s[..., 1:2] - s[..., 0:1]) / (h[..., 0:1] + h[..., 1:2])
            return cat(M1, M1, M1)
        # eliminate M0 and M[n-1] with third-derivative continuity:
        #   M0 = ((h0+h1) M1 - h0 M2) / h1
        #   M[n-1] = ((h[n-2]+h[n-3]) M[n-2] - h[n-2] M[n-3]) / h[n-3]
        # leaving an (n-2) tridiagonal system in M1..M[n-2]
        h0, h1 = h[..., 0:1], h[..., 1:2]
        hm1, hm2 = h[..., -1:], h[..., -2:-1]
        dl = h[..., :-1] / 6.0
        d = (h[..., :-1] + h[..., 1:]) / 3.0
        du = h[..., 1:] / 6.0
        b = s[..., 1:] - s[..., :-1]
        d1 = d[..., 0:1] + dl[..., 0:1] * (h0 + h1) / h1
        du1 = du[..., 0:1] - dl[..., 0:1] * h0 / h1
        dn = d[..., -1:] + du[..., -1:] * (hm1 + hm2) / hm2
        dln = dl[..., -1:] - du[..., -1:] * hm1 / hm2
        M_int = _solve_batch_last(
            cat(torch.zeros_like(d1), dl[..., 1:-1], dln),
            cat(d1, d[..., 1:-1], dn),
            cat(du1, du[..., 1:-1], torch.zeros_like(dn)),
            b)                                    # (..., n-2) = M1..M[n-2]
        M0 = ((h0 + h1) * M_int[..., 0:1] - h0 * M_int[..., 1:2]) / h1
        Mn = ((hm1 + hm2) * M_int[..., -1:] - hm1 * M_int[..., -2:-1]) / hm2
        return cat(M0, M_int, Mn)

    raise ValueError(f"unknown bc_type: {bc_type!r}")


def _bracket(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Index of the knot interval holding each query point.

    The count of interior knots ``<= t`` (``searchsorted(right=True)``,
    the same count as the reference's dense compare), clipped to
    ``[0, n-2]``: points left of x1 use the first interval and points
    right of x[n-2] the last, which extrapolates with the boundary cubic
    as SciPy's ``extrapolate=True`` does.
    """
    n = x.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-1], t.shape[:-1])
    interior = x[..., 1:-1].expand(*batch, n - 2).contiguous()
    queries = t.expand(*batch, t.shape[-1]).contiguous()
    ge = torch.searchsorted(interior, queries, right=True)
    return ge.clamp(0, n - 2)


def _gather_knots(idx: torch.Tensor, *arrays: torch.Tensor):
    batch = idx.shape[:-1]
    return [torch.gather(a.expand(*batch, a.shape[-1]), -1, idx) for a in arrays]


def _interval(x, y, M, t):
    """Per query: the bracketing interval's x0, x1, y0, y1, M0, M1."""
    idx = _bracket(x, t)
    x0, y0, M0 = _gather_knots(idx, x, y, M)
    x1, y1, M1 = _gather_knots(idx + 1, x, y, M)
    return x0, x1, y0, y1, M0, M1


def eval_cubic_spline(x: torch.Tensor, y: torch.Tensor, M: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """S(t) of fitted splines.

    Args:
      x, y, M: knots / values / second derivatives, shape ``(..., n)``.
      t: query points, shape ``(..., m)`` with the same batch dims.

    Returns S(t), shape ``(..., m)``. Points outside [x0, xn] are
    extrapolated with the boundary cubic (SciPy ``extrapolate=True``).
    """
    x, y, M = torch.broadcast_tensors(x, y, M)
    x0, x1, y0, y1, M0, M1 = _interval(x, y, M, t)
    hh = x1 - x0
    a = (x1 - t) / hh
    b = (t - x0) / hh
    return (a * y0 + b * y1
            + ((a * a * a - a) * M0 + (b * b * b - b) * M1) * (hh * hh) / 6.0)


def eval_cubic_spline_deriv(x, y, M, t):
    """First derivative S'(t) of the fitted spline."""
    x, y, M = torch.broadcast_tensors(x, y, M)
    x0, x1, y0, y1, M0, M1 = _interval(x, y, M, t)
    hh = x1 - x0
    a = (x1 - t) / hh
    b = (t - x0) / hh
    return ((y1 - y0) / hh
            + ((-3 * (a * a) + 1) * M0 + (3 * (b * b) - 1) * M1) * hh / 6.0)


def eval_cubic_spline_second_deriv(x, y, M, t):
    """Second derivative S''(t): linear between the knot curvatures."""
    x, M = torch.broadcast_tensors(x, M)
    idx = _bracket(x, t)
    x0, M0 = _gather_knots(idx, x, M)
    x1, M1 = _gather_knots(idx + 1, x, M)
    hh = x1 - x0
    return ((x1 - t) * M0 + (t - x0) * M1) / hh
