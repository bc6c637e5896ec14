"""RBF/thin-plate scattered surface model (port of
``iv_interpolation_tpu/models/rbf.py``).

Unlike the slice-wise families, RBF fits the whole (k, T) quote cloud of
each underlying as one scattered problem, so ``fit_eval`` owns its
packing: quotes flatten to (B, E*n, 2) sites, the dense eval grid and
the data sites share one eval pass, and arbitrage handling is the
penalty-smoothing solver (``ops.rbf``) when ``surface.rbf_butterfly_penalty``
or ``rbf_calendar_penalty`` > 0; ``surface.rbf_centers`` selects the
reduced-center basis.
"""

from __future__ import annotations

import numpy as np
import torch

from iv_interpolation_tpu_torch.models.base import SurfaceModel
from iv_interpolation_tpu_torch.ops.rbf import (  # noqa: F401  (public math)
    eval_rbf,
    fit_eval_rbf_arbfree_batched,
    fit_eval_rbf_batched,
    fit_rbf,
)
from iv_interpolation_tpu_torch.surface.arbitrage import butterfly_g_fd


def _rbf_fit_eval(k, iv, T, quote_mask, scfg, dev=None):
    """Scattered RBF surfaces over all (k, T) quotes of each underlying,
    evaluated on the slice-wise families' (E, grid) layout. Padded quotes
    enter the penalized fit's data term with weight 0; at zero penalties
    the plain interpolating/smoothing fit runs (and sees every site).
    Flags are the post-hoc finite-difference diagnostics on the grid.
    Returns (B, ...) tensors with a quote-masked ``fit_rmse``."""
    dev = dev or torch.as_tensor
    B, E, n = k.shape
    m = scfg.grid_strikes
    pts = np.stack([k.reshape(B, E * n), np.repeat(T, n, axis=-1)], axis=-1)
    vals = (iv ** 2 * T[..., None]).reshape(B, E * n)
    lo = k[:, :, 0].max(axis=1)
    hi = k[:, :, -1].min(axis=1)
    kg_row = lo[:, None] + (hi - lo)[:, None] * np.linspace(0.0, 1.0, m)
    k_grid = np.broadcast_to(kg_row[:, None, :], (B, E, m))
    # grid queries first, the data sites after: one eval pass serves both
    # the surface grid and fit_rmse
    query = np.concatenate([
        np.stack([k_grid.reshape(B, E * m), np.repeat(T, m, axis=-1)], axis=-1),
        pts,
    ], axis=1)

    if scfg.rbf_butterfly_penalty > 0.0 or scfg.rbf_calendar_penalty > 0.0:
        w_eval, _, _ = fit_eval_rbf_arbfree_batched(
            dev(pts), dev(vals), dev(query),
            weights=dev(quote_mask.reshape(B, E * n).astype(vals.dtype)),
            smoothing=scfg.rbf_smoothing, kernel=scfg.rbf_kernel,
            butterfly_weight=scfg.rbf_butterfly_penalty,
            calendar_weight=scfg.rbf_calendar_penalty,
            n_iters=scfg.rbf_penalty_iters, n_centers=scfg.rbf_centers)
    else:
        w_eval = fit_eval_rbf_batched(dev(pts), dev(vals), dev(query),
                                      smoothing=scfg.rbf_smoothing, kernel=scfg.rbf_kernel)
    w_grid = w_eval[:, :E * m].reshape(B, E, m)
    w_data = w_eval[:, E * m:]
    qm = torch.as_tensor(quote_mask.reshape(B, E * n), device=w_eval.device)
    n_real = torch.clamp_min(qm.sum(-1), 1)
    fit_rmse = torch.sqrt(torch.where(qm, (w_data - dev(vals)) ** 2, 0.0).sum(-1) / n_real)
    k_grid, T = dev(k_grid), dev(T)
    g = butterfly_g_fd(k_grid, w_grid)
    iv_grid = torch.sqrt(torch.clamp_min(w_grid, 0.0) / torch.clamp_min(T[..., None], 1e-12))
    return {
        "k_grid": k_grid,
        "w_grid": w_grid,
        "iv_grid": iv_grid,
        "g": g,
        "butterfly_ok": (g >= -1e-10).all(-1).all(-1),
        "calendar_ok": (w_grid[:, 1:] - w_grid[:, :-1] >= -1e-12).all(-1).all(-1),
        "fit_rmse": fit_rmse,
    }


def _rbf_local_vol(res: dict, T, scfg) -> dict:
    """Dupire extraction from the scattered fit, with dw/dT by backward
    differences on the evaluated grid; cells without a real local vol, and
    densities where w <= 0, persist NaN."""
    from iv_interpolation_tpu_torch.surface.localvol import (_backward_dwdT,
                                                             risk_neutral_density)
    g, w = res["g"], res["w_grid"]
    dwdT = _backward_dwdT(w, torch.as_tensor(T, device=w.device).to(w.dtype), 1e-10)
    lv = dwdT / torch.clamp_min(g, 1e-10)
    valid = (g > 1e-10) & (dwdT >= 0.0)
    nan = float("nan")
    return {
        **res,
        "local_vol": torch.where(valid, torch.sqrt(torch.clamp_min(lv, 0.0)), nan),
        "density": torch.where(w > 0.0, risk_neutral_density(res["k_grid"], w, g), nan),
    }


RBF = SurfaceModel(
    name="rbf",
    fit_eval=_rbf_fit_eval,
    attach_local_vol=_rbf_local_vol,
    description="scattered RBF/thin-plate surfaces with no-arbitrage "
                "penalty smoothing (surface.rbf_*)")
