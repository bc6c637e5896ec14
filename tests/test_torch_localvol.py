"""Port parity: ``iv_interpolation_tpu_torch/surface/localvol.py`` against
the JAX package's ``surface/localvol.py`` on the same fitted float64
surfaces (each package fits its own from the same seeded quotes).

Tolerances: local variance, local vol, density and variance-swap strikes
within 1e-10 relative to each quantity's scale (float64; the two fits
agree to ~1e-15 and the local variance divides by g >= 0.1 here); the
validity masks and ``local_vol_ok`` exact. The closed-form checks of the
JAX suite (flat surface, lognormal density) hold on the port at the JAX
suite's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.surface import localvol as ref_lv
from iv_interpolation_tpu.surface.surface import fit_eval_surface as ref_fit_eval
from iv_interpolation_tpu_torch.surface import localvol as lv
from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface


def _surface(rng, B=3, E=5, n=24, wiggle=0.0):
    k = np.broadcast_to(np.linspace(-1.0, 1.0, n), (B, E, n)).copy()
    T = np.broadcast_to(np.linspace(0.2, 1.4, E), (B, E)).copy()
    iv = (rng.uniform(0.2, 0.5, (B, 1, 1)) + rng.uniform(0.02, 0.2, (B, 1, 1)) * k * k
          + wiggle * np.sin(20 * k))
    return k, iv, T


def _both(k, iv, T, n_grid=30):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = fit_eval_surface(t(k), t(iv), t(T), n_grid=n_grid, spline_bc="not-a-knot")
    want = ref_fit_eval(jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T), n_grid=n_grid,
                        spline_bc="not-a-knot")
    return got, want


def _close(a, b, rel):
    a, b = a.numpy(), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = max(1.0, float(np.nanmax(np.abs(b))))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0, atol=rel * scale)


@pytest.mark.parametrize("wiggle", [0.0, 0.05])
def test_local_vol_surface_matches_jax(rng, wiggle):
    got, want = _both(*_surface(rng, wiggle=wiggle))
    a, b = lv.local_vol_surface(got), ref_lv.local_vol_surface(want)
    assert set(a) == set(b)
    for key in ("local_vol_valid", "local_vol_ok"):
        np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=key)
    valid = a["local_vol_valid"].numpy()
    for key in ("local_var", "local_vol"):
        # outside the mask the values are eps-clamped and only the mask is
        # the contract
        np.testing.assert_allclose(a[key].numpy()[valid], np.asarray(b[key])[valid],
                                   rtol=1e-10, atol=1e-12, err_msg=key)
    for key in ("density", "var_swap"):
        _close(a[key], b[key], 1e-10)
    if wiggle:
        assert not valid.all()


def test_elementwise_functions_match_jax(rng):
    got, want = _both(*_surface(rng, B=2))
    exp = got["fit"].expiries
    _close(lv.local_variance_grid(got["w_grid"], got["g"], exp),
           ref_lv.local_variance_grid(want["w_grid"], want["g"], want["fit"].expiries), 1e-10)
    _close(lv.risk_neutral_density(got["k_grid"], got["w_grid"], got["g"]),
           ref_lv.risk_neutral_density(want["k_grid"], want["w_grid"], want["g"]), 1e-10)
    _close(lv.variance_swap_strike(got["k_grid"], got["w_grid"], got["g"], exp),
           ref_lv.variance_swap_strike(want["k_grid"], want["w_grid"], want["g"],
                                       want["fit"].expiries), 1e-10)


def test_flat_surface_closed_forms():
    """Flat smile: local vol = sigma, slice 0's derivative is w_0/T_0, and
    the density is the lognormal one (the JAX suite's checks)."""
    sigma, B, E, n = 0.3, 2, 6, 30
    k = torch.linspace(-1.0, 1.0, n, dtype=torch.float64).expand(B, E, n)
    T = torch.linspace(0.25, 1.5, E, dtype=torch.float64).expand(B, E)
    out = fit_eval_surface(k, torch.full((B, E, n), sigma, dtype=torch.float64), T,
                           n_grid=40, spline_bc="not-a-knot")
    res = lv.local_vol_surface(out)
    np.testing.assert_allclose(res["local_vol"].numpy(), sigma, rtol=1e-5)
    assert bool(res["local_vol_ok"].all())
    kk = np.linspace(-4.0, 4.0, 401)
    p = lv.risk_neutral_density(torch.from_numpy(kk), torch.full((401,), sigma**2,
                                                               dtype=torch.float64),
                                torch.ones(401, dtype=torch.float64)).numpy()
    d = -kk / sigma - sigma / 2.0
    np.testing.assert_allclose(p, np.exp(-0.5 * d * d) / (sigma * np.sqrt(2 * np.pi)), rtol=1e-6)
    assert abs(np.trapezoid(p, kk) - 1.0) < 1e-4


def test_local_vol_ok_uses_the_cell_mask():
    """A cell with g exactly 0 passes the butterfly flag but not the
    local-vol mask, and local_vol_ok follows the mask."""
    B, E, n = 2, 6, 30
    k = torch.linspace(-1.0, 1.0, n, dtype=torch.float64).expand(B, E, n)
    T = torch.linspace(0.25, 1.5, E, dtype=torch.float64).expand(B, E)
    out = dict(fit_eval_surface(k, torch.full((B, E, n), 0.3, dtype=torch.float64), T,
                                n_grid=20, spline_bc="not-a-knot"))
    out["g"] = out["g"].clone()
    out["g"][0, 1, 7] = 0.0
    res = lv.local_vol_surface(out)
    assert not bool(res["local_vol_ok"][0]) and bool(res["local_vol_ok"][1])
    assert not bool(res["local_vol_valid"][0, 1, 7])
