"""SABR smile model: Hagan lognormal-vol expansion per expiry, calibrated
with the shared batched LM engine (``ops.sabr``).
"""

from iv_interpolation_tpu_torch.models._slicewise import slicewise_model
from iv_interpolation_tpu_torch.ops.sabr import (  # noqa: F401  (public math)
    fit_sabr_batched,
    sabr_vol,
)

SABR = slicewise_model("sabr", "Hagan SABR slices via batched LM")
