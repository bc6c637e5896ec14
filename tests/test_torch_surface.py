"""Port parity: surface fit/eval (cubic-spline path) and the arbitrage
diagnostics against the JAX package's ``surface/surface.py`` and
``surface/arbitrage.py``.

Tolerances: float64 values agree to 1e-12 (Thomas against PCR in the
curvature solve, otherwise the same arithmetic); the float32 run agrees
to 256 ulps of the largest |w|. Flags agree exactly, and the float32
common-support grid is bit-identical to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.surface import arbitrage as ref_arb
from iv_interpolation_tpu.surface import surface as ref
from iv_interpolation_tpu_torch.convert import surface_fit_from_numpy
from iv_interpolation_tpu_torch.surface import arbitrage as port_arb
from iv_interpolation_tpu_torch.surface import surface as port

KEYS = ("k_grid", "w_grid", "iv_grid", "g", "fit_rmse")
FLAGS = ("butterfly_ok", "calendar_ok")


def _chains(rng, B=4, E=5, n=12, dtype=np.float64, wiggle=0.0):
    lo = rng.uniform(-1.0, -0.6, (B, E, 1))
    hi = rng.uniform(0.6, 1.0, (B, E, 1))
    k = lo + (hi - lo) * np.linspace(0.0, 1.0, n)
    T = np.sort(rng.uniform(0.05, 2.0, (B, E)), axis=-1)
    atm = rng.uniform(0.15, 0.6, (B, 1, 1))
    iv = atm + 0.1 * k * k + wiggle * np.sin(20 * k)
    return k.astype(dtype), iv.astype(dtype), T.astype(dtype)


def _close(a, b, dtype):
    if dtype == np.float64:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    else:
        scale = max(1.0, np.abs(b).max())
        np.testing.assert_allclose(
            a, b, rtol=0, atol=256 * np.finfo(np.float32).eps * scale)


def _run_both(k, iv, T, **kw):
    got = port.fit_eval_surface(*map(torch.from_numpy, (k, iv, T)), **{
        key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for key, v in kw.items()})
    want = ref.fit_eval_surface(*map(jnp.asarray, (k, iv, T)), **{
        key: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for key, v in kw.items()})
    return got, want


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
@pytest.mark.parametrize("wiggle", [0.0, 0.08])
def test_fit_eval_surface_matches_jax(rng, bc, dtype, wiggle):
    k, iv, T = _chains(rng, dtype=dtype, wiggle=wiggle)
    got, want = _run_both(k, iv, T, n_grid=17, spline_bc=bc)
    for key in KEYS:
        _close(got[key].numpy(), np.asarray(want[key]), dtype)
    for key in FLAGS:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    _close(got["fit"].coefs.numpy(), np.asarray(want["fit"].coefs), dtype)
    assert got["fit"].method == "cubic_spline"


def test_fit_eval_surface_quote_mask_and_flags_disagreeing_chains(rng):
    k, iv, T = _chains(rng, B=6)
    iv[1] = iv[1, ::-1]           # calendar and butterfly trouble
    iv[2, 2] *= 0.3
    mask = rng.random(k.shape) > 0.3
    got, want = _run_both(k, iv, T, n_grid=21, spline_bc="not-a-knot",
                          quote_mask=mask)
    for key in KEYS:
        _close(got[key].numpy(), np.asarray(want[key]), np.float64)
    for key in FLAGS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert not np.asarray(want["calendar_ok"]).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_grid", [1, 2, 50])
def test_common_support_grid_bit_identical(rng, dtype, n_grid):
    k, _, _ = _chains(rng, dtype=dtype)
    got = port.common_support_grid(torch.from_numpy(k), n_grid).numpy()
    want = np.asarray(ref.common_support_grid(jnp.asarray(k), n_grid))
    np.testing.assert_array_equal(got, want)


def test_common_support_grid_disjoint_supports_ascend():
    k = np.stack([np.linspace(-1.0, -0.5, 6), np.linspace(0.5, 1.0, 6)])[None]
    got = port.common_support_grid(torch.from_numpy(k), 9).numpy()
    want = np.asarray(ref.common_support_grid(jnp.asarray(k), 9))
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got, axis=-1) > 0).all()


@pytest.mark.parametrize("E", [2, 5])
def test_eval_surface_matches_jax_on_converted_fit(rng, E):
    k, iv, T = _chains(rng, E=E)
    fit_ref = ref.fit_surface(*map(jnp.asarray, (k, iv, T)),
                              spline_bc="not-a-knot")
    fit_np = jax.tree.map(np.asarray, fit_ref)
    fit_port = surface_fit_from_numpy(fit_np)
    own = port.fit_surface(*map(torch.from_numpy, (k, iv, T)),
                           spline_bc="not-a-knot")
    _close(own.coefs.numpy(), fit_np.coefs, np.float64)

    B, Q = k.shape[0], 40
    k_q = rng.uniform(-1.2, 1.2, (B, Q))
    T_q = rng.uniform(0.0, 2.5, (B, Q))   # also outside the expiry range
    want = np.asarray(ref.eval_surface(fit_ref, jnp.asarray(k_q),
                                       jnp.asarray(T_q)))
    for fit in (fit_port, own):
        got = port.eval_surface(fit, torch.from_numpy(k_q),
                                torch.from_numpy(T_q)).numpy()
        _close(got, want, np.float64)


def test_unported_methods_name_their_roadmap_item(rng):
    k, iv, T = map(torch.from_numpy, _chains(rng))
    for method in ("svi", "essvi", "sabr", "smoothing_spline"):
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            port.fit_eval_surface(k, iv, T, method=method)
    with pytest.raises(ValueError):
        port.fit_surface(k, iv, T, method="linear")


def test_arbitrage_functions_match_jax(rng):
    k, iv, T = _chains(rng, wiggle=0.05)
    k_grid = np.array(ref.common_support_grid(jnp.asarray(k), 30))
    w = np.array(ref.fit_eval_surface(*map(jnp.asarray, (k, iv, T)),
                                        n_grid=30)["w_grid"])
    w[0, 2] -= 0.2                        # a calendar violation
    w1 = rng.normal(size=w.shape)
    w2 = rng.normal(size=w.shape)
    tk, tw, t1, t2 = map(torch.from_numpy, (k_grid, w, w1, w2))
    _close(port_arb.butterfly_g(tk, tw, t1, t2).numpy(),
           np.asarray(ref_arb.butterfly_g(*map(jnp.asarray, (k_grid, w, w1, w2)))),
           np.float64)
    _close(port_arb.butterfly_g_fd(tk, tw).numpy(),
           np.asarray(ref_arb.butterfly_g_fd(jnp.asarray(k_grid), jnp.asarray(w))),
           np.float64)
    for tol in (0.0, 1e-3):
        np.testing.assert_array_equal(
            port_arb.calendar_violations(tw, tol).numpy(),
            np.asarray(ref_arb.calendar_violations(jnp.asarray(w), tol)))
    got = port_arb.check_surface_arbitrage(tk, tw)
    want = ref_arb.check_surface_arbitrage(jnp.asarray(k_grid), jnp.asarray(w))
    assert set(got) == set(want)
    for key in ("butterfly_violations", "calendar_violations"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("worst_g", "worst_calendar_gap"):
        _close(got[key].numpy(), np.asarray(want[key]), np.float64)
