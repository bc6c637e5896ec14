"""Port parity: ``surface.greeks.greek_surfaces`` against the JAX package's
on the same seeded grids. float64: every grid <= 1e-12 relative to the
grid's scale; float32: within 8 ulp of the grid's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.surface.greeks import greek_surfaces as ref_greeks
from iv_interpolation_tpu_torch.surface.greeks import greek_surfaces

GRIDS = ("price", "delta", "gamma", "theta", "vega", "rho")


def _inputs(rng, dtype, B=3, E=4, m=11):
    k = np.tile(np.linspace(-0.4, 0.4, m), (B, E, 1))
    T = np.cumsum(rng.uniform(0.05, 0.5, (B, E)), -1)
    iv = 0.2 + 0.1 * k * k + 0.02 * np.sqrt(T)[..., None]
    spot = rng.uniform(50, 150, B)
    rate = rng.uniform(0.0, 0.05, B)
    return [a.astype(dtype) for a in (k, iv, T, spot, rate)]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 8 * np.finfo(np.float32).eps)])
@pytest.mark.parametrize("is_call", [True, False, "mixed"])
@pytest.mark.parametrize("scalar_rate", [False, True])
def test_six_grids_match_jax(rng, dtype, tol, is_call, scalar_rate):
    k, iv, T, spot, rate = _inputs(rng, dtype)
    flag = rng.random(k.shape) < 0.5 if is_call == "mixed" else is_call
    r = dtype(0.03) if scalar_rate else rate
    want = ref_greeks(*map(jnp.asarray, (k, iv, T, spot)), jnp.asarray(r),
                      jnp.asarray(flag))
    got = greek_surfaces(*map(torch.from_numpy, (k, iv, T, spot)),
                         float(r) if scalar_rate else torch.from_numpy(r),
                         torch.from_numpy(flag) if is_call == "mixed" else flag)
    assert set(got) == set(want) == set(GRIDS)
    for name in GRIDS:
        a, b = got[name].numpy(), np.asarray(want[name])
        assert a.shape == b.shape == k.shape and a.dtype == dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()),
                                   err_msg=name)


def test_degenerate_inputs_are_clamped_as_in_the_reference(rng):
    """T = 0 and iv = 0 cells are clamped to 1e-12, not NaN."""
    k, iv, T, spot, rate = _inputs(rng, np.float64, B=1, E=2, m=5)
    T[0, 0] = 0.0
    iv[0, 1, 2] = 0.0
    want = ref_greeks(*map(jnp.asarray, (k, iv, T, spot, rate)))
    got = greek_surfaces(*map(torch.from_numpy, (k, iv, T, spot, rate)))
    for name in GRIDS:
        a, b = got[name].numpy(), np.asarray(want[name])
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=name)
        ok = np.isfinite(b)
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-9,
                                   atol=1e-12 * max(1.0, np.abs(b[ok]).max()), err_msg=name)
