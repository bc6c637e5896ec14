"""Vol-surface engine: smile fits, maturity interpolation and
no-arbitrage diagnostics (port of ``iv_interpolation_tpu/surface``).
Its public names load with their modules on first access."""

from iv_interpolation_tpu_torch._lazy import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "SurfaceFit": "iv_interpolation_tpu_torch.surface.surface",
    "eval_surface": "iv_interpolation_tpu_torch.surface.surface",
    "fit_surface": "iv_interpolation_tpu_torch.surface.surface",
    "fit_eval_surface": "iv_interpolation_tpu_torch.surface.surface",
    "butterfly_g": "iv_interpolation_tpu_torch.surface.arbitrage",
    "calendar_violations": "iv_interpolation_tpu_torch.surface.arbitrage",
    "check_surface_arbitrage": "iv_interpolation_tpu_torch.surface.arbitrage",
    "local_variance_grid": "iv_interpolation_tpu_torch.surface.localvol",
    "local_vol_surface": "iv_interpolation_tpu_torch.surface.localvol",
    "risk_neutral_density": "iv_interpolation_tpu_torch.surface.localvol",
    "variance_swap_strike": "iv_interpolation_tpu_torch.surface.localvol",
})
