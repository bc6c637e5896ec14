"""SurfaceModel protocol and registry: the dispatch surface of the smile
and surface families (port of ``iv_interpolation_tpu/models/base.py``).

Every family registers a :class:`SurfaceModel` whose two callables own
its family-specific logic:

  * ``fit_eval(k, iv, T, quote_mask, scfg, dev) -> dict``: batched fit +
    dense-grid eval + diagnostics. Inputs are host numpy ``(B, E, n)``
    batches from ``surface_task.pack_chain_group``; ``dev`` places an
    array on the run's device in its compute dtype. The output dict holds
    at least :data:`PERSIST_KEYS` and ``g``.
  * ``attach_local_vol(res, T, scfg) -> dict``: adds the ``local_vol`` and
    ``density`` grids.

Consumers: ``pipeline.surface_task.run_surface_fit`` (method name ->
:func:`get`) and ``cli.py --method`` (choices = :func:`available`). The
module imports no torch, so the CLI can list methods without loading a
backend; family modules import at :func:`get` time.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

# keys every model's fit_eval must produce; surface_task persists these
# (plus local_vol/density after attach_local_vol)
PERSIST_KEYS = ("k_grid", "w_grid", "iv_grid",
                "butterfly_ok", "calendar_ok", "fit_rmse")


@dataclasses.dataclass(frozen=True)
class SurfaceModel:
    """One smile/surface family: name + the two capability callables."""

    name: str
    fit_eval: Callable[..., dict]
    attach_local_vol: Callable[..., dict]
    description: str = ""


# name -> (module, attribute) of every family
_FAMILIES = {
    "cubic_spline": ("iv_interpolation_tpu_torch.models.spline", "CUBIC_SPLINE"),
    "smoothing_spline": ("iv_interpolation_tpu_torch.models.spline",
                         "SMOOTHING_SPLINE"),
    "svi": ("iv_interpolation_tpu_torch.models.svi", "SVI"),
    "essvi": ("iv_interpolation_tpu_torch.models.essvi", "ESSVI"),
    "sabr": ("iv_interpolation_tpu_torch.models.sabr", "SABR"),
    "rbf": ("iv_interpolation_tpu_torch.models.rbf", "RBF"),
    "ah": ("iv_interpolation_tpu_torch.models.andreasen_huge", "AH"),
}


def available() -> tuple:
    """Every family name, in the JAX package's order (CLI --method
    choices)."""
    return tuple(_FAMILIES)


def get(name: str) -> SurfaceModel:
    """Resolve a family by name (imports the family module)."""
    try:
        module, attr = _FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown smile method {name!r}; available: "
            f"{', '.join(available())}") from None
    model = getattr(importlib.import_module(module), attr)
    assert model.name == name, (model.name, name)
    return model
