"""Andreasen-Huge one-step surface model (port of
``iv_interpolation_tpu/models/andreasen_huge.py``): arbitrage-free by
construction (martingale-kernel implicit Dupire steps in strike space,
``ops.andreasen_huge``), on the method's own dense PDE grid
(``surface.ah_grid`` / ``ah_iters``).
"""

from __future__ import annotations

import torch

from iv_interpolation_tpu_torch.models.base import SurfaceModel
from iv_interpolation_tpu_torch.ops.andreasen_huge import (  # noqa: F401
    fit_eval_ah_surface,
)


def _ah_fit_eval(k, iv, T, quote_mask, scfg, dev=None):
    dev = dev or torch.as_tensor
    return fit_eval_ah_surface(dev(k), dev(iv), dev(T), n_grid=scfg.ah_grid,
                               n_iters=scfg.ah_iters, quote_mask=dev(quote_mask))


def _ah_local_vol(res: dict, T, scfg) -> dict:
    """AH's local vol is its own calibration product (already in the
    fused output). Its ``g`` is the STRIKE-space density d2C/dK2, while
    every other family persists the LOG-MONEYNESS density, so convert
    (p(k) = K d2C/dK2, K = e^k on the unit forward) before writing the
    shared ``density`` column. The two boundary columns carry no PDE row
    and persist NaN."""
    p_k = torch.exp(res["k_grid"]) * res["g"]
    interior = torch.zeros_like(p_k, dtype=torch.bool)
    interior[..., 1:-1] = True
    return {**res, "density": torch.where(interior, p_k, float("nan"))}


AH = SurfaceModel(
    name="ah",
    fit_eval=_ah_fit_eval,
    attach_local_vol=_ah_local_vol,
    description="Andreasen-Huge one-step surfaces (arb-free by "
                "construction; surface.ah_grid/ah_iters)")
