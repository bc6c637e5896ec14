"""State carry-over from the JAX package to the port.

Each ``*_from_numpy`` function takes the reference's state with its
arrays as numpy (JAX's ``tree.map(np.asarray, state)`` gives that) and
returns the port's state on ``device`` (the card unless the caller passes
another), dtypes unchanged. This lets a JAX session's operators, ring,
fitted surfaces or PRNG keys be handed to the port, so both compute on
the same state. ``config_from_dict`` takes the JAX package's
``config_to_dict(cfg)``. Stores and run manifests carry across by their
shared on-disk formats. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from iv_interpolation_tpu_torch.config import Config
from iv_interpolation_tpu_torch.ops.spline_matrix import SplineOperator
from iv_interpolation_tpu_torch.pipeline.ringbuffer import RingState
from iv_interpolation_tpu_torch.surface.surface import SurfaceFit


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def spline_operator_from_numpy(op, device: torch.device | str = "cuda") -> SplineOperator:
    """``ops.spline_matrix.SplineOperator`` (numpy fields) -> the port's."""
    return SplineOperator(*(_tensor(getattr(op, f), device)
                            for f in SplineOperator._fields))


def ring_state_from_numpy(ring, device: torch.device | str = "cuda") -> RingState:
    """``pipeline.ringbuffer.RingState`` (numpy fields) -> the port's."""
    return RingState(*(_tensor(getattr(ring, f), device)
                       for f in RingState._fields))


def surface_fit_from_numpy(fit, device: torch.device | str = "cuda") -> SurfaceFit:
    """``surface.surface.SurfaceFit`` (numpy fields) -> the port's, for any
    of the five slice-wise methods: ``coefs`` is (B, E, n) for the splines,
    (B, E, 5) svi, (B, E, 3) essvi, (B, E, 4) sabr."""
    return SurfaceFit(method=fit.method,
                      **{f: _tensor(getattr(fit, f), device)
                         for f in ("k", "expiries", "w", "coefs")})


def prng_key_from_numpy(key_data, device: torch.device | str = "cuda") -> torch.Tensor:
    """A JAX key's ``random.key_data(key)``, a numpy ``(..., 2)`` uint32 array ->
    the port's key tensor (``ops.prng``: int64 words, same bits)."""
    data = np.asarray(key_data)
    if data.shape[-1:] != (2,) or data.dtype != np.uint32:
        raise ValueError(f"expected (..., 2) uint32 key data, got "
                         f"{data.dtype} {data.shape}")
    return torch.from_numpy(data.astype(np.int64)).to(device)


def config_from_dict(d: dict) -> Config:
    """The JAX package's ``config_to_dict(cfg)`` (plain dicts) -> the
    port's ``Config``. Every section and field must be one the port's
    config has; tuples that a JSON round trip turned into lists come
    back as tuples."""
    sections = {f.name: f for f in dataclasses.fields(Config)}
    kw = {}
    for name, value in d.items():
        if name not in sections:
            raise ValueError(f"unknown config section: {name!r}")
        if isinstance(value, dict):
            cls = sections[name].default_factory
            known = {f.name for f in dataclasses.fields(cls)}
            unknown = set(value) - known
            if unknown:
                raise ValueError(f"unknown fields in section {name!r}: {sorted(unknown)}")
            value = cls(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in value.items()})
        kw[name] = value
    return Config(**kw)
