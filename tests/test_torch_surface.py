"""Port parity: surface fit/eval (the spline paths and the calibrated
families svi, essvi and sabr) and the arbitrage diagnostics against the
JAX package's ``surface/surface.py`` and ``surface/arbitrage.py``.

Tolerances: float64 values agree to 1e-12 (Thomas against PCR in the
curvature solve, otherwise the same arithmetic); the float32 run agrees
to 256 ulps of the largest |w|. Flags agree exactly, and the float32
common-support grid is bit-identical to the reference's. The calibrated
families in float64: ``w_grid``, ``g`` and ``fit_rmse`` within 1e-7 of
their scale after the fit, flags equal; ``eval_surface``, ``_eval_slices``
and ``_slice_g`` on the reference's own fitted parameters (carried across
by ``surface_fit_from_numpy``, no fit in between) within 1e-12.
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
    fit_port = surface_fit_from_numpy(fit_np, device="cpu")
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


CALIBRATED = {
    "svi": dict(),
    "svi_hinge_vega": dict(svi_butterfly_penalty=10.0, svi_weighting="vega"),
    "svi_huber": dict(svi_loss="huber", svi_huber_delta=5e-4),
    "essvi": dict(),
    "essvi_vega_huber": dict(svi_weighting="vega", svi_loss="huber"),
    "sabr": dict(),
}


def _smiles(rng, B=3, E=4, n=15):
    k = np.tile(np.linspace(-0.5, 0.5, n), (B, E, 1)) * rng.uniform(0.8, 1.2, (B, E, 1))
    T = np.cumsum(rng.uniform(0.1, 0.5, (B, E)), -1)
    iv = (0.2 + 0.1 * k * k - 0.05 * k + 0.02 * np.sqrt(T)[..., None]
          + rng.normal(0, 1e-4, (B, E, n)))
    return k, iv, T


@pytest.mark.parametrize("case", list(CALIBRATED))
def test_calibrated_fit_eval_surface_matches_jax(rng, case):
    method = case.split("_")[0]
    k, iv, T = _smiles(rng)
    mask = np.ones(k.shape, bool)
    mask[0, -1, 10:] = False
    got, want = _run_both(k, iv, T, method=method, n_grid=20, svi_iters=24,
                          quote_mask=mask, **CALIBRATED[case])
    for key in KEYS:
        a, b = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7 * max(1.0, np.abs(b).max()),
                                   err_msg=key)
    for key in FLAGS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["fit"].method == method
    np.testing.assert_allclose(got["fit"].coefs.numpy(), np.asarray(want["fit"].coefs),
                               rtol=0, atol=1e-6 if method != "sabr" else 1e-5)
    assert float(got["fit_rmse"].max()) < 2e-3
    # svi_unroll keeps its place in the signature and changes nothing
    again = port.fit_eval_surface(*map(torch.from_numpy, (k, iv, T)), method=method,
                                  n_grid=20, svi_iters=24, svi_unroll=True,
                                  quote_mask=torch.from_numpy(mask), **CALIBRATED[case])
    np.testing.assert_array_equal(again["w_grid"].numpy(), got["w_grid"].numpy())


@pytest.mark.parametrize("method", ["svi", "essvi", "sabr", "cubic_spline",
                                    "smoothing_spline"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_eval_paths_on_the_reference_fit_carried_across(rng, method, dtype):
    """The reference's fitted ``SurfaceFit`` goes through
    ``surface_fit_from_numpy``; ``eval_surface``, ``_eval_slices`` and
    ``_slice_g`` are then held to the reference on its own parameters:
    float64 within 1e-12 of scale, float32 within 256 ulps."""
    k, iv, T = (a.astype(dtype) for a in _smiles(rng))
    fit_ref = ref.fit_surface(*map(jnp.asarray, (k, iv, T)), method=method, svi_iters=16,
                              smoothing_lam=1e-4)
    fit_np = jax.tree.map(np.asarray, fit_ref)
    fit = surface_fit_from_numpy(fit_np, device="cpu")
    assert fit.method == method and fit.coefs.shape == fit_np.coefs.shape
    assert fit.coefs.dtype == torch.from_numpy(k).dtype

    def close(a, b):
        b = np.asarray(b)
        tol = 1e-12 if dtype == np.float64 else 256 * np.finfo(np.float32).eps
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))

    k_grid = np.asarray(ref.common_support_grid(jnp.asarray(k), 20))
    tg = torch.from_numpy(k_grid)
    w_grid = port._eval_slices(fit, tg)
    w_ref = ref._eval_slices(fit_ref, jnp.asarray(k_grid))
    close(w_grid, w_ref)
    close(port._slice_g(fit, tg, torch.from_numpy(np.asarray(w_ref)),
                        port._eval_slices(fit, tg, derivs=True)[1]),
          ref._slice_g(fit_ref, jnp.asarray(k_grid), w_ref))
    B, Q = k.shape[0], 40
    k_q = rng.uniform(-0.45, 0.45, (B, Q)).astype(dtype)
    T_q = rng.uniform(0.0, 2.5, (B, Q)).astype(dtype)   # also outside the expiry range
    close(port.eval_surface(fit, torch.from_numpy(k_q), torch.from_numpy(T_q)),
          ref.eval_surface(fit_ref, jnp.asarray(k_q), jnp.asarray(T_q)))


def test_unported_methods_name_their_roadmap_item(rng):
    k, iv, T = map(torch.from_numpy, _chains(rng))
    # rbf and ah are no slice-wise methods: the registry refuses them by
    # name (tests/test_torch_models.py); here they are unknown, as in the
    # reference
    for method in ("rbf", "ah", "linear"):
        with pytest.raises(ValueError, match="unknown smile method"):
            port.fit_surface(k, iv, T, method=method)
    with pytest.raises(ValueError, match="unknown smile method"):
        port.eval_surface(port.SurfaceFit("rbf", k, T, k, k), k[:, 0], k[:, 0])
    # the smoothing spline is ported (test_smoothing_spline_surface_matches_jax)
    assert port.fit_eval_surface(k, iv, T, method="smoothing_spline")["w_grid"].shape[-1] == 50


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_smoothing_spline_surface_matches_jax(rng, lam):
    """fit_eval_surface and eval_surface with method='smoothing_spline'
    against the JAX package's, float64."""
    k, iv, T = _chains(rng, wiggle=0.02)
    got = port.fit_eval_surface(*map(torch.from_numpy, (k, iv, T)), method="smoothing_spline",
                                n_grid=30, smoothing_lam=lam)
    want = ref.fit_eval_surface(*map(jnp.asarray, (k, iv, T)), method="smoothing_spline",
                                n_grid=30, smoothing_lam=lam)
    for key in ("w_grid", "iv_grid", "g", "fit_rmse"):
        _close(got[key].numpy(), np.asarray(want[key]), np.float64)
    for key in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    B = k.shape[0]
    k_q, T_q = rng.uniform(-0.5, 0.5, (B, 7)), rng.uniform(0.0, 2.5, (B, 7))
    _close(port.eval_surface(got["fit"], torch.from_numpy(k_q), torch.from_numpy(T_q)).numpy(),
           np.asarray(ref.eval_surface(want["fit"], jnp.asarray(k_q), jnp.asarray(T_q))),
           np.float64)


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
