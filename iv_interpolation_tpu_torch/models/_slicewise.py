"""Shared machinery of the slice-wise families (port of
``iv_interpolation_tpu/models/_slicewise.py``): one smile per expiry,
total-variance interpolation across maturity, Dupire local vol from the
evaluated grid.

``dev`` places a host array on the run's device in its compute dtype (the
reference's mesh-placement hook). ``surface.svi_unroll`` is accepted by
the config and read by no family here: it inlines the reference's
on-device LM loop for its compiler, and the port's LM loop is a Python
loop of eager launches with nothing to unroll.
"""

from __future__ import annotations

import torch

from iv_interpolation_tpu_torch.models.base import SurfaceModel


def slicewise_fit_eval(method: str):
    """fit_eval for the families served by ``surface.fit_eval_surface``."""

    def fit_eval(k, iv, T, quote_mask, scfg, dev=None):
        from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface
        dev = dev or torch.as_tensor
        return fit_eval_surface(
            dev(k), dev(iv), dev(T), method=method, n_grid=scfg.grid_strikes,
            svi_iters=scfg.lm_max_iters,
            svi_butterfly_penalty=scfg.butterfly_penalty,
            svi_weighting=scfg.svi_weighting,
            spline_bc=scfg.spline_bc, smoothing_lam=scfg.smoothing_lam,
            quote_mask=dev(quote_mask))

    return fit_eval


def slicewise_local_vol(res: dict, T, scfg) -> dict:
    """Dupire local vol + risk-neutral density from an evaluated grid.

    Cells where g <= 0 or dw/dT < 0 hold eps-clamped values (~1e10x real
    ones): they persist as NaN. Density is NaN where w <= 0 (the w clamp
    would fabricate ~1e5-scale spikes there); negative density from g < 0
    is a real arbitrage signal and is kept. The maturities are the fit's;
    an output without a ``fit`` (parity mode) takes ``T``.
    """
    from iv_interpolation_tpu_torch.surface.localvol import local_vol_surface
    w = res["w_grid"]
    expiries = res["fit"].expiries if "fit" in res else torch.as_tensor(
        T, device=w.device).to(w.dtype)
    lv = local_vol_surface(res, expiries=expiries)
    nan = torch.tensor(float("nan"), dtype=w.dtype, device=w.device)
    lv["local_vol"] = torch.where(lv["local_vol_valid"], lv["local_vol"], nan)
    lv["density"] = torch.where(w > 0.0, lv["density"], nan)
    return {**res, **lv}


def slicewise_model(name: str, description: str) -> SurfaceModel:
    return SurfaceModel(name=name, fit_eval=slicewise_fit_eval(name),
                        attach_local_vol=slicewise_local_vol,
                        description=description)
