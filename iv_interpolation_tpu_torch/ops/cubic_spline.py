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

from functools import reduce

import torch

from iv_interpolation_tpu_torch.monitoring.metrics import span
from iv_interpolation_tpu_torch.ops.cuda.spline_eval import spline_eval_cuda
from iv_interpolation_tpu_torch.ops.tridiag import tridiag_solve_batch_last


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
        return tridiag_solve_batch_last(
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
        return tridiag_solve_batch_last(
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
        M_int = tridiag_solve_batch_last(
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
    as SciPy's ``extrapolate=True`` does. Span ``iv.spline.bracket``.
    """
    with span("iv.spline.bracket"):
        n = x.shape[-1]
        batch = torch.broadcast_shapes(x.shape[:-1], t.shape[:-1])
        interior = x[..., 1:-1].expand(*batch, n - 2).contiguous()
        queries = t.expand(*batch, t.shape[-1]).contiguous()
        ge = torch.searchsorted(interior, queries, right=True)
        return ge.clamp(0, n - 2)


def _evaluate(x, y, M, t, results):
    """The ``results`` (0: S, 1: S', 2: S'') of one evaluation, with x, y,
    M broadcast to one shape and all four promoted to their common dtype,
    as mixed float32 and float64 operands promote in the JAX package."""
    dtype = reduce(torch.promote_types, (a.dtype for a in (x, y, M, t)))
    x, y, M = torch.broadcast_tensors(*(a.to(dtype) for a in (x, y, M)))
    return spline_eval_cuda(x, y, M, t.to(dtype), results)


def eval_cubic_spline_all(x: torch.Tensor, y: torch.Tensor, M: torch.Tensor,
                          t: torch.Tensor, order: int = 2):
    """S(t) of fitted splines and, up to ``order``, S'(t) and S''(t), from
    one bracket search and one read of the knots.

    Args:
      x, y, M: knots / values / second derivatives, shape ``(..., n)``,
        broadcastable against each other.
      t: query points, shape ``(..., m)`` with batch dims that broadcast
        against the knots'.
      order: 0 returns S; 1 returns (S, S'); 2 returns (S, S', S'').

    Each result has shape ``(..., m)``. Points outside [x0, xn] are
    extrapolated with the boundary cubic (SciPy ``extrapolate=True``).
    CUDA tensors launch one kernel (``ops.cuda.spline_eval``), CPU tensors
    run its plain version, in the common dtype of x, y, M and t.
    """
    if order not in (0, 1, 2):
        raise ValueError(f"order must be 0, 1 or 2, got {order!r}")
    out = _evaluate(x, y, M, t, tuple(range(order + 1)))
    return out[0] if order == 0 else out


def eval_cubic_spline(x: torch.Tensor, y: torch.Tensor, M: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """S(t) of fitted splines.

    Args:
      x, y, M: knots / values / second derivatives, shape ``(..., n)``.
      t: query points, shape ``(..., m)`` with the same batch dims.

    Returns S(t), shape ``(..., m)``. Points outside [x0, xn] are
    extrapolated with the boundary cubic (SciPy ``extrapolate=True``).
    """
    return eval_cubic_spline_all(x, y, M, t, order=0)


def eval_cubic_spline_deriv(x, y, M, t):
    """First derivative S'(t) of the fitted spline."""
    (dS,) = _evaluate(x, y, M, t, (1,))
    return dS


def eval_cubic_spline_second_deriv(x, y, M, t):
    """Second derivative S''(t): linear between the knot curvatures."""
    del y                                 # S'' reads x and M only
    (d2S,) = _evaluate(x, M, M, t, (2,))
    return d2S


def fit_eval_smile(x, y, t, bc_type: str = "natural"):
    """Fit then evaluate a batch of smiles: S(t) of the splines through
    ``(x, y)``, shape ``(..., m)``."""
    M = fit_cubic_spline(x, y, bc_type=bc_type)
    return eval_cubic_spline(x, y, M, t)
