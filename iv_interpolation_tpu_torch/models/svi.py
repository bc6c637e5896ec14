"""SVI slice model: 5-parameter (a, b, rho, m, sigma) raw-SVI smiles
calibrated per expiry with the batched Levenberg-Marquardt engine
(``ops.svi`` / ``ops.lm``); butterfly no-arbitrage available as a hinge
penalty (``surface.butterfly_penalty``), residual weighting through
``surface.svi_weighting``.
"""

from iv_interpolation_tpu_torch.models._slicewise import slicewise_model
from iv_interpolation_tpu_torch.ops.svi import (  # noqa: F401  (public math)
    fit_svi_batched,
    svi_g,
    svi_total_variance,
)

SVI = slicewise_model(
    "svi", "raw-SVI slices via batched LM (surface.lm_max_iters)")
