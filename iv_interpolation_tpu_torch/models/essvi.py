"""eSSVI surface model: one joint (theta_e, rho_e, psi_e) calibration per
surface with increasing ATM total variance and butterfly-free slices by
construction (``ops.essvi``, block-tridiagonal Gauss-Newton solver).
"""

from iv_interpolation_tpu_torch.models._slicewise import slicewise_model
from iv_interpolation_tpu_torch.ops.essvi import (  # noqa: F401  (public math)
    essvi_g,
    essvi_w,
    fit_essvi_batched,
)

ESSVI = slicewise_model(
    "essvi", "joint eSSVI surface calibration (arb-free by construction)")
