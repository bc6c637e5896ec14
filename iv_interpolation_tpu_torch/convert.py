"""State carry-over from the JAX package to the port.

Each function takes the reference's state with its arrays as numpy
(``jax.tree.map(np.asarray, state)`` gives that) and returns the port's
state on ``device``, dtypes unchanged. This lets a JAX session's
operators, ring or fitted surfaces be handed to the port, so both compute
on the same state. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from iv_interpolation_tpu_torch.ops.spline_matrix import SplineOperator
from iv_interpolation_tpu_torch.pipeline.ringbuffer import RingState
from iv_interpolation_tpu_torch.surface.surface import SurfaceFit


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def spline_operator_from_numpy(op, device: torch.device | str = "cpu") -> SplineOperator:
    """``ops.spline_matrix.SplineOperator`` (numpy fields) -> the port's."""
    return SplineOperator(*(_tensor(getattr(op, f), device)
                            for f in SplineOperator._fields))


def ring_state_from_numpy(ring, device: torch.device | str = "cpu") -> RingState:
    """``pipeline.ringbuffer.RingState`` (numpy fields) -> the port's."""
    return RingState(*(_tensor(getattr(ring, f), device)
                       for f in RingState._fields))


def surface_fit_from_numpy(fit, device: torch.device | str = "cpu") -> SurfaceFit:
    """``surface.surface.SurfaceFit`` (numpy fields) -> the port's."""
    return SurfaceFit(method=fit.method,
                      **{f: _tensor(getattr(fit, f), device)
                         for f in ("k", "expiries", "w", "coefs")})
