"""Cubic-spline and smoothing-spline smile models (port of
``iv_interpolation_tpu/models/spline.py``).

``cubic_spline`` is the flagship family. It carries the precision switch
``surface.compensated`` (CLI ``--parity``): the surface is fitted and
evaluated in float64 (the knot curvatures from the float64 Thomas kernel)
on the float32-rounded quotes, and persisted as a float32 pair
``(w_grid, w_grid_lo)`` whose float64 sum reproduces SciPy's float64
spline to ~1e-12. The reference builds that pair from double-float32
arithmetic because its chip lacks float64 linear algebra; the card has
native float64, so the port keeps the pair's contract and not the
arithmetic.

``smoothing_spline`` trades exact interpolation for a curvature penalty
(``ops.smoothing_spline``), the noisy-quote regime.
"""

from __future__ import annotations

import numpy as np
import torch

from iv_interpolation_tpu_torch.models._slicewise import slicewise_local_vol, slicewise_model
from iv_interpolation_tpu_torch.models.base import SurfaceModel
from iv_interpolation_tpu_torch.ops.cubic_spline import (  # noqa: F401  (public math)
    eval_cubic_spline,
    eval_cubic_spline_deriv,
    eval_cubic_spline_second_deriv,
    fit_cubic_spline,
    fit_eval_smile,
)
from iv_interpolation_tpu_torch.ops.spline_matrix import (  # noqa: F401  (public math)
    build_surface_operators,
    fit_eval_surface_grid,
)
from iv_interpolation_tpu_torch.surface.arbitrage import arbitrage_flags, butterfly_g


def parity_grid(k: torch.Tensor, n_grid: int) -> torch.Tensor:
    """float64 common-support grid of float32 knots ``k`` (..., E, n):
    ``lo + (hi - lo) * linspace(0, 1, n_grid)`` in float64 between the
    float32 support endpoints (the gap between the supports when they do
    not overlap), the exact-f64-linspace grid the float64 oracle
    evaluates on. Returns (..., E, n_grid)."""
    k_lo = k[..., 0].amax(dim=-1)
    k_hi = k[..., -1].amin(dim=-1)
    lo = torch.minimum(k_lo, k_hi).double()[..., None]
    hi = torch.maximum(k_lo, k_hi).double()[..., None]
    steps = torch.from_numpy(np.linspace(0.0, 1.0, n_grid)).to(k.device)
    grid = (hi - lo) * steps + lo
    return grid[..., None, :].expand(*k.shape[:-1], n_grid)


def fit_eval_surface_parity(k: torch.Tensor, iv: torch.Tensor, expiries: torch.Tensor,
                            n_grid: int = 50, bc_type: str = "not-a-knot") -> dict:
    """Parity-mode surface fit+eval of float32 quotes, computed in float64.

    Args:
      k, iv: (B, E, n) float32 log-moneyness knots and implied vols (the
        exact inputs: the oracle is defined on these float32 values).
      expiries: (B, E) float32 maturities.
      bc_type: 'natural' or 'not-a-knot'.

    Returns ``k_grid``, ``w_grid``, ``iv_grid``, ``g``, ``butterfly_ok``,
    ``calendar_ok`` as float32 (the flags from the float32 hi limbs with
    1024-ulp float32 tolerances) plus ``w_grid_lo``: ``f64(w_grid) +
    f64(w_grid_lo)`` is the float64 surface.
    """
    if bc_type not in ("natural", "not-a-knot"):
        raise ValueError(
            f"compensated spline supports natural/not-a-knot, got {bc_type!r}")
    k64, iv64, T64 = (a.double() for a in (k, iv, expiries))
    w64 = iv64 * iv64 * T64[..., None]
    M = fit_cubic_spline(k64, w64, bc_type=bc_type)
    q = parity_grid(k, n_grid)
    knots = (k64, w64, M)
    w_q = eval_cubic_spline(*knots, q)
    w_grid = w_q.float()
    k_grid = q.float()
    g = butterfly_g(k_grid, w_grid, eval_cubic_spline_deriv(*knots, q).float(),
                    eval_cubic_spline_second_deriv(*knots, q).float())
    butterfly_ok, calendar_ok = arbitrage_flags(w_grid, g)
    return {
        "k_grid": k_grid,
        "w_grid": w_grid,
        "w_grid_lo": (w_q - w_grid.double()).float(),
        "iv_grid": torch.sqrt(w_grid.clamp_min(0.0)
                              / expiries.float()[..., None].clamp_min(1e-12)),
        "g": g,
        "butterfly_ok": butterfly_ok,
        "calendar_ok": calendar_ok,
    }


def _cubic_fit_eval(k, iv, T, quote_mask, scfg, dev=None):
    if not getattr(scfg, "compensated", False):
        return slicewise_model("cubic_spline", "").fit_eval(k, iv, T, quote_mask, scfg, dev)
    # parity mode: the inputs are rounded to float32 first, the contract
    # of the float64 oracle ("exact float32 inputs")
    dev = dev or torch.as_tensor
    f32 = lambda a: dev(np.asarray(a, np.float32)).float()
    out = fit_eval_surface_parity(f32(k), f32(iv), f32(T), n_grid=scfg.grid_strikes,
                                  bc_type=scfg.spline_bc)
    # an interpolating spline reprices the quotes exactly by construction
    out["fit_rmse"] = torch.zeros_like(out["w_grid"][:, 0, 0])
    return out


CUBIC_SPLINE = SurfaceModel(
    name="cubic_spline",
    fit_eval=_cubic_fit_eval,
    attach_local_vol=slicewise_local_vol,
    description="interpolating cubic-spline smiles; surface.compensated "
                "switches to the float64 <=1e-8-parity path")

SMOOTHING_SPLINE = slicewise_model(
    "smoothing_spline",
    "curvature-penalised spline smiles (surface.smoothing_lam)")
