"""Matrix-form cubic splines: fit + eval as one contraction (port of
``iv_interpolation_tpu/ops/spline_matrix.py``).

For a fixed knot grid the spline is a linear map of the knot values: the
tridiagonal system ``T M = C y`` gives the curvatures ``M = G y`` with
``G = T^-1 C``, and evaluation at fixed queries t is

    S(t) = E0 y,   S'(t) = E1 y,   S''(t) = E2 y

with (m, n) matrices precomputed once per grid. A batch of smiles on that
grid then evaluates as one batched product. The build functions take any
leading batch dims, so one call builds a whole (B, E) operator stack.

Products run in full float32 (``_build.pin_precision`` holds TF32 off on
the card): the E2 entries scale like 1/h^2 (about +-600 at n=50 on
[-1, 1]), and reduced-precision products flip the sign of butterfly g on
clean smiles.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from iv_interpolation_tpu_torch.monitoring.metrics import span
from iv_interpolation_tpu_torch.ops.cubic_spline import _bracket
from iv_interpolation_tpu_torch.surface.arbitrage import arbitrage_flags, butterfly_g


class SplineOperator(NamedTuple):
    """Precomputed eval operators for knot/query grids (any batch dims)."""

    knots: torch.Tensor    # (..., n)
    queries: torch.Tensor  # (..., m)
    E0: torch.Tensor       # (..., n, m) value operator (for y @ E)
    E1: torch.Tensor       # (..., n, m) first-derivative operator
    E2: torch.Tensor       # (..., n, m) second-derivative operator
    # (..., n, 3m) = [E0 | E1 | E2], stacked once at build time so that a
    # refit reads one operator instead of concatenating per call
    EC: torch.Tensor


def _curvature_operator(x: torch.Tensor, bc_type: str = "natural") -> torch.Tensor:
    """G (..., n, n) with M = G y for the cubic spline on knots x (..., n).

    ``natural`` pins M = 0 at the end knots, which flattens w'' at the grid
    edges and shows up as spurious negative butterfly g there;
    ``not-a-knot`` (SciPy's default) tracks smooth smiles. n=3 not-a-knot
    is the interpolating parabola (the n>=4 rows would be singular) and
    n=2 not-a-knot the straight line.
    """
    n = x.shape[-1]
    batch = x.shape[:-1]
    h = torch.diff(x, dim=-1)
    T = x.new_zeros(*batch, n, n)
    i = torch.arange(1, n - 1, device=x.device)
    T[..., i, i - 1] = h[..., :-1] / 6.0
    T[..., i, i] = (h[..., :-1] + h[..., 1:]) / 3.0
    T[..., i, i + 1] = h[..., 1:] / 6.0
    if bc_type == "natural" or (bc_type == "not-a-knot" and n == 2):
        T[..., 0, 0] = 1.0
        T[..., n - 1, n - 1] = 1.0
    elif bc_type == "not-a-knot" and n >= 4:
        # S''' continuous at x1 and at x[n-2]
        T[..., 0, 0] = 1.0 / h[..., 0]
        T[..., 0, 1] = -1.0 / h[..., 0] - 1.0 / h[..., 1]
        T[..., 0, 2] = 1.0 / h[..., 1]
        T[..., n - 1, n - 3] = 1.0 / h[..., n - 3]
        T[..., n - 1, n - 2] = -1.0 / h[..., n - 3] - 1.0 / h[..., n - 2]
        T[..., n - 1, n - 1] = 1.0 / h[..., n - 2]
    elif bc_type == "not-a-knot" and n == 3:
        # M0 = M1 = M2: the interior row then gives the parabola's curvature
        T[..., 0, 0] = 1.0
        T[..., 0, 1] = -1.0
        T[..., 2, 2] = 1.0
        T[..., 2, 1] = -1.0
    else:
        raise ValueError(f"unsupported bc_type for operator form: {bc_type!r}")
    # C: rhs operator, b = C y with b_i = s_i - s_{i-1} (end rows stay 0)
    C = x.new_zeros(*batch, n, n)
    C[..., i, i - 1] = 1.0 / h[..., :-1]
    C[..., i, i] = -1.0 / h[..., :-1] - 1.0 / h[..., 1:]
    C[..., i, i + 1] = 1.0 / h[..., 1:]
    return torch.linalg.solve(T, C)


def build_spline_operator(knots: torch.Tensor, queries: torch.Tensor,
                          bc_type: str = "natural") -> SplineOperator:
    """Precompute E0/E1/E2 for knots (..., n) and queries (..., m) with the
    same batch dims. O(n^3 + m n) per grid, amortised over every refit."""
    x, t = knots, queries
    n = x.shape[-1]
    G = _curvature_operator(x, bc_type)                      # (..., n, n)
    idx = _bracket(x, t)                                     # (..., m)
    x0 = torch.gather(x, -1, idx)
    x1 = torch.gather(x, -1, idx + 1)
    hh = x1 - x0
    a = (x1 - t) / hh
    b = (t - x0) / hh
    P0 = torch.nn.functional.one_hot(idx, n).to(x.dtype)    # (..., m, n)
    P1 = torch.nn.functional.one_hot(idx + 1, n).to(x.dtype)
    rows = lambda j: torch.gather(G, -2, j[..., None].expand(*j.shape, n))
    G0, G1 = rows(idx), rows(idx + 1)                        # (..., m, n)
    col = lambda v: v[..., None]
    E0 = (col(a) * P0 + col(b) * P1
          + (col(a * a * a - a) * G0 + col(b * b * b - b) * G1)
          * col(hh * hh / 6.0))
    E1 = ((P1 - P0) / col(hh)
          + (col(-3 * (a * a) + 1) * G0 + col(3 * (b * b) - 1) * G1)
          * col(hh / 6.0))
    E2 = col(a) * G0 + col(b) * G1
    E0, E1, E2 = (e.mT.contiguous() for e in (E0, E1, E2))
    return SplineOperator(knots=x, queries=t, E0=E0, E1=E1, E2=E2,
                          EC=torch.cat([E0, E1, E2], dim=-1))


def apply_spline_operator(op: SplineOperator, y: torch.Tensor):
    """(S, S', S'') of a batch of smiles: y (..., n) -> three (..., m)."""
    return y @ op.E0, y @ op.E1, y @ op.E2


def build_surface_operators(k_knots: torch.Tensor, queries: torch.Tensor,
                            bc_type: str = "natural") -> SplineOperator:
    """Per-expiry operators: k_knots (E, n), queries (m,) or (E, m) ->
    stacked (E, n, m) operator tensors."""
    if queries.dim() == 1:
        queries = queries.expand(k_knots.shape[0], queries.shape[0])
    return build_spline_operator(k_knots, queries, bc_type)


def build_surface_operators_batched(k_knots: torch.Tensor, queries: torch.Tensor,
                                    bc_type: str = "natural") -> SplineOperator:
    """Per-underlying, per-expiry operators: k_knots (B, E, n), queries
    (m,) or (B, E, m) -> stacked (B, E, n, m) operator tensors. One-off
    set-up for fixed quote grids; every refit is then one product
    (:func:`fit_eval_surface_grid_batched`)."""
    B, E, _ = k_knots.shape
    if queries.dim() == 1:
        queries = queries.expand(B, E, queries.shape[0])
    return build_spline_operator(k_knots, queries, bc_type)


def _grid_diagnostics(out: torch.Tensor, m: int, k_grid: torch.Tensor,
                      T: torch.Tensor) -> dict:
    """Split the stacked contraction output [w | w' | w''] and compute the
    diagnostics dict (one home for the grid output contract)."""
    w_grid, w1, w2 = out[..., :m], out[..., m:2 * m], out[..., 2 * m:]
    g = butterfly_g(k_grid, w_grid, w1, w2)
    iv_grid = torch.sqrt(w_grid.clamp_min(0.0) / T.clamp_min(1e-12))
    butterfly_ok, calendar_ok = arbitrage_flags(w_grid, g)
    return {
        "k_grid": k_grid,
        "w_grid": w_grid,
        "iv_grid": iv_grid,
        "g": g,
        "butterfly_ok": butterfly_ok,
        "calendar_ok": calendar_ok,
    }


def _expiry_column(expiries: torch.Tensor) -> torch.Tensor:
    return expiries[None, :, None] if expiries.dim() == 1 else expiries[..., None]


def fit_eval_surface_grid(ops: SplineOperator, iv: torch.Tensor,
                          expiries: torch.Tensor) -> dict:
    """Surface fit + eval on shared per-expiry grids.

    Args:
      ops: stacked SplineOperator with (E, n, m) tensors
        (:func:`build_surface_operators`).
      iv: (B, E, n) implied vols.
      expiries: (E,) or (B, E).

    Returns the grid keys of ``surface.fit_eval_surface``'s dict
    (k_grid/w_grid/iv_grid/g/butterfly_ok/calendar_ok). All expiries must
    share one query grid for ``calendar_ok`` to mean anything. Spans
    ``iv.grid.contract`` (w and the product) and ``iv.surface.diagnostics``.
    """
    with span("iv.grid.contract"):
        T = _expiry_column(expiries)
        w = iv * iv * T                                       # (B, E, n)
        out = torch.einsum("ben,enq->beq", w, ops.EC.to(w.dtype))
        m = ops.E0.shape[-1]
        k_grid = ops.queries[None].expand(*w.shape[:-1], m)
    with span("iv.surface.diagnostics"):
        return _grid_diagnostics(out, m, k_grid, T)


def fit_eval_surface_grid_batched(ops: SplineOperator, iv: torch.Tensor,
                                  expiries: torch.Tensor) -> dict:
    """Like :func:`fit_eval_surface_grid` with per-underlying operators:
    ops tensors (B, E, n, m), iv (B, E, n), expiries (E,) or (B, E). The
    streaming refit when every underlying has its own strike grid; all
    expiries of one underlying must share one query grid."""
    T = _expiry_column(expiries)
    w = iv * iv * T
    out = torch.einsum("ben,benq->beq", w, ops.EC.to(w.dtype))
    return _grid_diagnostics(out, ops.E0.shape[-1], ops.queries, T)
