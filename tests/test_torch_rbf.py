"""Port parity: RBF surfaces (``iv_interpolation_tpu_torch/ops/rbf.py``,
its ``models`` entry and ``convert.rbf_fit_from_numpy``) against the JAX
package and SciPy's ``RBFInterpolator``, on seeded numpy inputs (float64,
CPU tensors).

Tolerances:
* thin-plate and gaussian direct fits: evaluated w within 1e-9 of the
  values' scale against JAX and SciPy; thin-plate coefficients within 1e-9
  of their scale against JAX (a gaussian Gram is ill-conditioned enough
  that LU pivoting moves its coefficients by 1e-5 of scale while the
  surface agrees; at eps=2 and smoothing 1e-10 even the surface moves by
  9e-8, so the gaussian case here is eps=3, smoothing 1e-8);
* multiquadric: evaluated w within kappa * eps64 * max|w|, kappa the
  bordered system's condition number from ``np.linalg.cond`` (the JAX
  suite's fixed 5e-8 against SciPy fails for the reference itself,
  ROADMAP C1);
* ``fit_rbf_arbfree``: the zero-penalty and reduced-basis routes hold
  coefficients within 1e-8 of their scale and the penalty-grid w within
  1e-10; the full-basis penalized routes hold the surface (penalty-grid
  w and w at the sites) within 2e-6 of scale and not the coefficients:
  their fixed quadratic part has a condition number of 3e15 on these
  inputs (2e19 with the weight-0 pin), so the two LAPACK Cholesky
  factorizations part at rounding and the hinge's active set carries it
  along; flags equal everywhere; over a batch each surface equals its own
  fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import RBFInterpolator

from iv_interpolation_tpu.ops import rbf as ref
from iv_interpolation_tpu_torch import convert, models
from iv_interpolation_tpu_torch.config import get_config
from iv_interpolation_tpu_torch.ops import rbf

EPS64 = float(np.finfo(np.float64).eps)
SCIPY_KERNEL = {"thin_plate": "thin_plate_spline", "gaussian": "gaussian",
                "multiquadric": "multiquadric"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _quotes(rng, n, wiggle=0.0):
    k = rng.uniform(-1.0, 1.0, n)
    T = rng.uniform(0.05, 2.0, n)
    w = (0.04 + 0.3 * k ** 2) * T + wiggle * np.sin(8 * k) * T + 1e-4 * rng.normal(size=n)
    return np.stack([k, T], axis=1), w


def _close(got, want, rel, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("kernel,eps,smoothing", [
    ("thin_plate", 1.0, 0.0), ("thin_plate", 1.0, 1e-3), ("gaussian", 3.0, 1e-8),
    ("multiquadric", 1.5, 0.0)])
def test_direct_fit_matches_jax_and_scipy(rng, kernel, eps, smoothing):
    pts, w = _quotes(rng, 150)
    q, _ = _quotes(rng, 40)
    fit = rbf.fit_rbf(_t(pts), _t(w), smoothing=smoothing, kernel=kernel, epsilon=eps)
    got = rbf.eval_rbf(fit, _t(q), kernel=kernel, epsilon=eps).numpy()
    want_fit = ref.fit_rbf(jnp.asarray(pts), jnp.asarray(w), smoothing=smoothing,
                           kernel=kernel, epsilon=eps)
    want = np.asarray(ref.eval_rbf(want_fit, jnp.asarray(q), kernel=kernel, epsilon=eps))
    sp = RBFInterpolator(pts, w, kernel=SCIPY_KERNEL[kernel], epsilon=eps,
                         smoothing=smoothing)(q)
    if kernel == "multiquadric":
        n = len(w)
        lhs = np.block([[-np.sqrt(1 + (eps * np.linalg.norm(pts[:, None] - pts[None], axis=-1))
                                  ** 2), np.ones((n, 1))], [np.ones((1, n)), np.zeros((1, 1))]])
        bound = np.linalg.cond(lhs) * EPS64 * np.abs(w).max()
        assert bound > 5e-8          # the reference's fixed bound is below it
        for ref_w in (want, sp):
            np.testing.assert_allclose(got, ref_w, rtol=0, atol=bound)
        return
    _close(got, want, 1e-9, "vs jax")
    _close(got, sp, 1e-9, "vs scipy")
    if kernel == "thin_plate":
        _close(fit["coef"].numpy(), np.asarray(want_fit["coef"]), 1e-9, "coef")
        _close(fit["poly"].numpy(), np.asarray(want_fit["poly"]), 1e-9, "poly")


def test_batched_fit_eval_and_interpolation(rng):
    """``fit_eval_rbf_batched`` on 3 surfaces equals each surface alone,
    and the interpolant reproduces its sites."""
    B, n, m = 3, 80, 20
    pts = np.stack([_quotes(rng, n)[0] for _ in range(B)])
    ws = np.stack([0.04 + 0.3 * p[:, 0] ** 2 * p[:, 1] for p in pts])
    got = rbf.fit_eval_rbf_batched(_t(pts), _t(ws), _t(pts[:, :m])).numpy()
    want = np.asarray(ref.fit_eval_rbf_batched(jnp.asarray(pts), jnp.asarray(ws),
                                               jnp.asarray(pts[:, :m])))
    _close(got, want, 1e-9)
    _close(got, ws[:, :m], 1e-8)
    with pytest.raises(ValueError, match="unknown RBF kernel"):
        rbf.fit_rbf(_t(pts), _t(ws), kernel="cubic")


# (name, kwargs of fit_rbf_arbfree); the small penalty grid keeps the
# JAX compiles short. Full-basis penalized routes compare the surface only.
SMALL = dict(n_pen_t=5, n_pen_k=9, n_iters=6)
SURFACE_ONLY = {"penalized", "zero centers"}
ROUTES = {
    "direct": dict(SMALL, butterfly_weight=0.0, calendar_weight=0.0, smoothing=1e-6),
    "penalized": dict(SMALL),
    "butterfly only": dict(SMALL, calendar_weight=0.0, kernel="gaussian", epsilon=2.0),
    "reduced": dict(SMALL, n_centers=40),
    "reduced, zero penalty": dict(SMALL, n_centers=40, butterfly_weight=0.0,
                                  calendar_weight=0.0),
    "single slice": dict(SMALL, n_pen_t=1, calendar_weight=0.0),
    "zero centers": dict(SMALL, n_centers=0),
    "more centers than live sites": dict(SMALL, n_centers=100),
}


def _weights(n, rng):
    wts = np.ones(n)
    wts[-20:] = 0.0                                   # padding
    wts[:10] = rng.uniform(0.3, 2.0, 10)              # non-binary
    return wts


@pytest.mark.parametrize("route", list(ROUTES))
def test_arbfree_routes_match_jax(rng, route):
    kw = ROUTES[route]
    pts, w = _quotes(rng, 120, wiggle=0.02)
    wts = _weights(len(w), rng)
    if route == "more centers than live sites":
        wts[:70] = 0.0                                # 30 live sites, 100 centers
    if route == "single slice":
        # its one penalty row sits at the shortest maturity, where w is
        # small and g divides by it: with the weight-0 pin there the two
        # packages' factorizations part at 2e-4 of the surface
        wts = np.ones_like(w)
    else:
        pts[-20:, 0] += 3.0                           # padding outside the box
    got = rbf.fit_rbf_arbfree(_t(pts), _t(w), weights=_t(wts), **kw)
    want = jax.tree.map(np.asarray, ref.fit_rbf_arbfree(jnp.asarray(pts), jnp.asarray(w),
                                                        weights=jnp.asarray(wts), **kw))
    assert set(got) == set(want)
    for key in ("points", "pen_k_grid", "pen_t_grid"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=1e-15, err_msg=key)
    if route in SURFACE_ONLY:
        live = wts > 0
        _close(got["pen_w"].numpy(), want["pen_w"], 2e-6, "pen_w")
        _close(rbf.eval_rbf(got, _t(pts[live])).numpy(),
               np.asarray(ref.eval_rbf(want, jnp.asarray(pts[live]))), 2e-6, "w at the sites")
    else:
        _close(got["coef"].numpy(), want["coef"], 1e-8, "coef")
        _close(got["poly"].numpy(), want["poly"], 1e-8, "poly")
        _close(got["pen_w"].numpy(), want["pen_w"], 1e-10, "pen_w")
    for key in ("butterfly_ok", "calendar_ok"):
        assert bool(got[key]) == bool(want[key]), key
    assert np.isfinite(got["coef"].numpy()).all()


def test_arbfree_batch_matches_single_fits_and_scipy(rng):
    """Two surfaces in one call, each against its own single-surface fit;
    at zero penalty with uniform weights the fit is SciPy's smoothing
    RBF; the penalized fit of arbitrage-laden quotes is clean where the
    plain one is not."""
    data = [_quotes(rng, 100, wiggle=0.02) for _ in range(2)]
    pts, w = (np.stack(a) for a in zip(*data))
    q = pts[:, :30]
    kw = dict(SMALL, n_iters=12)
    w_q, bfly, cal = rbf.fit_eval_rbf_arbfree_batched(_t(pts), _t(w), _t(q), **kw)
    for b in range(2):
        one = rbf.fit_rbf_arbfree(_t(pts[b]), _t(w[b]), **kw)
        _close(w_q[b].numpy(), rbf.eval_rbf(one, _t(q[b])).numpy(), 1e-12)
        assert bool(bfly[b]) == bool(one["butterfly_ok"]) and bool(cal[b]) == bool(one["calendar_ok"])
    assert bool(bfly.all())
    zero = dict(SMALL, butterfly_weight=0.0, calendar_weight=0.0, smoothing=1e-6)
    plain = rbf.fit_rbf_arbfree(_t(pts), _t(w), **zero)
    assert not bool(plain["butterfly_ok"].all())
    for b in range(2):
        sp = RBFInterpolator(pts[b], w[b], kernel="thin_plate_spline", smoothing=1e-6)(q[b])
        _close(rbf.eval_rbf({k: v[b] for k, v in plain.items()}, _t(q[b])).numpy(), sp, 1e-8)


def test_arbfree_degenerate_inputs_and_errors(rng):
    pts, w = _quotes(rng, 60)
    pts[:, 0] = 0.25                                  # one strike: h_k floored
    fit = rbf.fit_rbf_arbfree(_t(pts), _t(w), **SMALL)
    assert np.isfinite(fit["pen_w"].numpy()).all()
    with pytest.raises(ValueError, match="unknown RBF kernel"):
        rbf.fit_rbf_arbfree(_t(pts), _t(w), kernel="cubic")
    with pytest.raises(ValueError, match="penalty grid too small"):
        rbf.fit_rbf_arbfree(_t(pts), _t(w), n_pen_k=2)
    with pytest.raises(ValueError, match="needs n_pen_t >= 2"):
        rbf.fit_rbf_arbfree(_t(pts), _t(w), n_pen_t=1)


def test_solve_failure_is_nan_not_an_exception():
    """A singular saddle system (duplicate sites, no smoothing) gives NaN
    for its surface and leaves the other surface of the batch intact."""
    pts = np.stack([np.array([[0.0, 0.5], [0.0, 0.5], [1.0, 1.0], [0.5, 0.2]]),
                    np.array([[0.0, 0.5], [0.3, 0.5], [1.0, 1.0], [0.5, 0.2]])])
    w = np.array([[0.1, 0.1, 0.3, 0.2]] * 2)
    fit = rbf.fit_rbf(_t(pts), _t(w), kernel="gaussian")
    assert np.isnan(fit["coef"][0].numpy()).all() and np.isfinite(fit["coef"][1].numpy()).all()


def test_rbf_fit_from_numpy_evaluates_a_jax_fit(rng):
    pts, w = _quotes(rng, 120, wiggle=0.02)
    q, _ = _quotes(rng, 30)
    want_fit = ref.fit_rbf_arbfree(jnp.asarray(pts), jnp.asarray(w), **ROUTES["reduced"])
    fit = convert.rbf_fit_from_numpy(jax.tree.map(np.asarray, want_fit), device="cpu")
    assert fit["coef"].device.type == "cpu" and fit["butterfly_ok"].dtype == torch.bool
    _close(rbf.eval_rbf(fit, _t(q)).numpy(), np.asarray(ref.eval_rbf(want_fit, jnp.asarray(q))),
           1e-12)


@pytest.mark.parametrize("surface", [{}, {"rbf_butterfly_penalty": 100.0,
                                          "rbf_calendar_penalty": 100.0,
                                          "rbf_penalty_iters": 4, "rbf_centers": 24}])
def test_model_matches_jax(surface):
    """``models.get("rbf")`` on a packed (B, E, n) batch with a padded
    expiry slot, direct and penalized: grids, g, fit_rmse and local vol
    within 1e-8 of scale, flags and NaN masks equal."""
    from iv_interpolation_tpu import models as ref_models
    from iv_interpolation_tpu.config import get_config as ref_get_config

    rng = np.random.default_rng(5)
    B, E, n = 2, 4, 8
    k = np.sort(rng.uniform(-0.6, 0.6, (B, E, n)), axis=-1)
    T = np.broadcast_to(np.array([0.2, 0.5, 1.0, 1.001]), (B, E)).copy()
    iv = 0.25 + 0.15 * k ** 2 + 0.02 * np.sqrt(T)[..., None]
    mask = np.ones((B, E, n), bool)
    mask[:, -1] = False
    scfgs = [get("testing").surface for get in (ref_get_config, get_config)]
    for s in scfgs:
        s.grid_strikes = 12
        for key, v in surface.items():
            setattr(s, key, v)
    model = models.get("rbf")
    assert model.description == ref_models.get("rbf").description
    got = model.attach_local_vol(model.fit_eval(k, iv, T, mask, scfgs[1], dev=_t),
                                 T=_t(T), scfg=scfgs[1])
    want = ref_models.get("rbf").fit_eval(k, iv, T, mask, scfgs[0])
    want = jax.tree.map(np.asarray, ref_models.get("rbf").attach_local_vol(want, T=T,
                                                                           scfg=scfgs[0]))
    for key in ("k_grid", "w_grid", "iv_grid", "g", "fit_rmse", "local_vol", "density"):
        a, b = got[key].numpy(), want[key]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=key)
        _close(np.nan_to_num(a), np.nan_to_num(b), 1e-8, key)
    for key in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
