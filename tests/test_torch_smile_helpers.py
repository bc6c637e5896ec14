"""Port parity: the fused fit-then-evaluate helpers
``ops.cubic_spline.fit_eval_smile`` and
``ops.smoothing_spline.fit_eval_smoothed_smile`` (and the first as
``models.spline`` re-exports it) against the JAX package's, on seeded
numpy inputs (CPU tensors).

Tolerances, those of the modules' own suites: the cubic spline within
1e-12 in float64 and 256 ulps of the largest |value| in float32
(``tests/test_torch_cubic_spline.py``); the smoothing spline's
evaluations within 1e-12 in float64
(``tests/test_torch_smoothing_spline.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import cubic_spline as ref_cubic
from iv_interpolation_tpu.ops import smoothing_spline as ref_smooth
from iv_interpolation_tpu_torch.models import spline as models_spline
from iv_interpolation_tpu_torch.ops import cubic_spline, smoothing_spline


def _smiles(rng, shape, n):
    x = np.sort(rng.uniform(-1.0, 1.0, shape + (n,)), axis=-1) + np.arange(n) * 0.05
    y = 0.2 + 0.1 * x * x + 0.01 * rng.normal(size=x.shape)
    t = x[..., :1] + (x[..., -1:] - x[..., :1]) * np.linspace(-0.1, 1.1, 23)
    return x, y, t


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
@pytest.mark.parametrize("n", [2, 3, 12])
def test_fit_eval_smile_matches_jax(rng, n, bc, dtype):
    x, y, t = (a.astype(dtype) for a in _smiles(rng, (4, 3), n))
    got = cubic_spline.fit_eval_smile(*map(torch.from_numpy, (x, y, t)), bc_type=bc)
    want = np.asarray(ref_cubic.fit_eval_smile(*map(jnp.asarray, (x, y, t)), bc_type=bc))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == t.shape
    tol = 1e-12 if dtype == np.float64 else (
        256 * np.finfo(np.float32).eps * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert models_spline.fit_eval_smile is cubic_spline.fit_eval_smile


@pytest.mark.parametrize("lam", [0.0, 1e-4, 1e-1, "per-problem"])
def test_fit_eval_smoothed_smile_matches_jax(rng, lam):
    x, y, t = _smiles(rng, (5,), 14)
    if lam == "per-problem":
        lam = np.logspace(-5, -1, 5)
    got = smoothing_spline.fit_eval_smoothed_smile(
        *map(torch.from_numpy, (x, y)), torch.as_tensor(lam, dtype=torch.float64),
        torch.from_numpy(t))
    want = np.asarray(ref_smooth.fit_eval_smoothed_smile(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(lam), jnp.asarray(t)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
