"""Model families: the smile/surface parameterisations behind
``--task surface`` / ``--method`` (port of ``iv_interpolation_tpu/models``).

Each family registers a :class:`~iv_interpolation_tpu_torch.models.base.
SurfaceModel` that ``pipeline.surface_task.run_surface_fit`` gets by name.
All seven families of the JAX package: the cubic spline (with parity
mode, ``surface.compensated``) and the smoothing spline (:mod:`.spline`),
the calibrated families SVI, eSSVI and SABR (:mod:`.svi`, :mod:`.essvi`,
:mod:`.sabr`), scattered RBF surfaces (:mod:`.rbf`) and Andreasen-Huge
(:mod:`.andreasen_huge`).
"""

from iv_interpolation_tpu_torch.models.base import (  # noqa: F401
    PERSIST_KEYS,
    SurfaceModel,
    available,
    get,
)
