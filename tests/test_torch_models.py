"""Port parity: the ``models`` registry (``iv_interpolation_tpu_torch/
models``) against the JAX package's, on the same seeded numpy batches as
``surface_task.pack_chain_group`` gives them.

Tolerances:
* registry names and the persisted keys: exact;
* cubic and smoothing ``fit_eval`` in float64 (CPU tensors): grids and
  g within 1e-12 of max(1, |x|) of JAX's x64 results, flags exact;
* svi, essvi and sabr ``fit_eval`` in float64, with the config's
  ``lm_max_iters``, ``butterfly_penalty`` and ``svi_weighting`` passed
  through: grids, g and fit_rmse within 1e-7 of max(1, |x|), flags exact;
* parity mode: the float32 pair's float64 sum within 2e-9 of JAX's
  double-float32 pair and within 1e-9 of SciPy's float64 ``CubicSpline``
  on the same float32 inputs (the JAX suite's bound,
  ``tests/test_spline_compensated.py``); the grid and the hi limbs
  ``k_grid``/``w_grid`` bit-equal; ``iv_grid`` within 4 float32 ulps of
  its scale; ``g`` within 64 (JAX evaluates w' and w'' in float32 from
  the hi limbs, where uneven knot gaps cost it tens of ulps; the port
  evaluates them in float64 and rounds); flags equal on the JAX tests'
  seeds, the adversarial wiggle included;
* local vol and density: the NaN masks exact, values within 1e-10 of
  their scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

from iv_interpolation_tpu import models as ref_models
from iv_interpolation_tpu.config import get_config as ref_get_config
from iv_interpolation_tpu_torch import models
from iv_interpolation_tpu_torch.config import get_config
from iv_interpolation_tpu_torch.models.spline import fit_eval_surface_parity

EPS32 = float(np.finfo(np.float32).eps)


def _scfgs(**surface):
    out = []
    for get in (ref_get_config, get_config):
        scfg = get("testing").surface
        for k, v in surface.items():
            setattr(scfg, k, v)
        out.append(scfg)
    return out


def _batch(rng, B=4, E=5, n=16, wiggle=0.0, uniform=True):
    if uniform:
        k_row = np.broadcast_to(np.linspace(-1.0, 1.0, n), (B, E, n))
    else:
        k_row = np.sort(rng.uniform(-1.2, 1.2, (B, E, n)), axis=-1)
    k = k_row + np.zeros((B, E, n))
    T = np.broadcast_to(np.linspace(0.05, 2.0, E), (B, E)).copy()
    iv = (rng.uniform(0.15, 0.6, (B, 1, 1)) + rng.uniform(0.05, 0.3, (B, 1, 1)) * k * k
          + wiggle * np.sin(20 * k))
    mask = np.ones((B, E, n), bool)
    mask[0, -1] = False            # a padded expiry slot
    return k, iv, T, mask


def _dev(a):
    return torch.as_tensor(np.asarray(a))


def test_registry_names_and_unported_families():
    """Every family of the JAX package resolves, none is left unported
    (the families' fits are held to JAX in their own test files:
    ``test_torch_andreasen_huge.py`` and ``test_torch_rbf.py`` for ah and
    rbf)."""
    assert models.available() == ref_models.available()
    assert len(models.available()) == 7
    assert models.PERSIST_KEYS == ref_models.PERSIST_KEYS
    for name in models.available():
        assert models.get(name).name == name
    for name in ("svi", "essvi", "sabr", "rbf", "ah"):
        assert models.get(name).description == ref_models.get(name).description
    with pytest.raises(ValueError, match="unknown smile method"):
        models.get("nonsense")


@pytest.mark.parametrize("method", ["cubic_spline", "smoothing_spline"])
@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
def test_fit_eval_matches_jax(rng, method, bc):
    k, iv, T, mask = _batch(rng)
    ref_scfg, scfg = _scfgs(spline_bc=bc, smoothing_lam=1e-3, grid_strikes=20)
    got = models.get(method).fit_eval(k, iv, T, mask, scfg, dev=_dev)
    want = ref_models.get(method).fit_eval(k, iv, T, mask, ref_scfg)
    for key in ("k_grid", "w_grid", "iv_grid", "g", "fit_rmse"):
        a, b = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * max(1.0, np.abs(b).max()),
                                   err_msg=key)
    for key in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("method,surface", [
    ("svi", {}), ("svi", {"butterfly_penalty": 10.0, "svi_weighting": "vega"}),
    ("svi", {"lm_max_iters": 5}), ("essvi", {}), ("essvi", {"svi_weighting": "vega"}),
    ("sabr", {}), ("sabr", {"lm_max_iters": 6})])
def test_calibrated_families_fit_eval_matches_jax(rng, method, surface):
    """``lm_max_iters``, ``butterfly_penalty`` and ``svi_weighting`` reach
    the fit (a 5-iteration fit differs from a 24-iteration one in both
    packages alike); ``svi_unroll`` is read by neither result."""
    k, iv, T, mask = _batch(rng, B=3, E=4, n=13)
    ref_scfg, scfg = _scfgs(**{"lm_max_iters": 24, "grid_strikes": 20, "svi_unroll": False,
                               **surface})
    got = models.get(method).fit_eval(k, iv, T, mask, scfg, dev=_dev)
    want = ref_models.get(method).fit_eval(k, iv, T, mask, ref_scfg)
    for key in ("k_grid", "w_grid", "iv_grid", "g", "fit_rmse"):
        a, b = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7 * max(1.0, np.abs(b).max()),
                                   err_msg=key)
    for key in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert got["fit"].method == method
    assert got["fit"].coefs.shape == (3, 4, {"svi": 5, "essvi": 3, "sabr": 4}[method])
    scfg.svi_unroll = True
    again = models.get(method).fit_eval(k, iv, T, mask, scfg, dev=_dev)
    np.testing.assert_array_equal(again["w_grid"].numpy(), got["w_grid"].numpy())


@pytest.mark.parametrize("case", ["clean", "nonuniform", "wiggle"])
@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
def test_parity_mode_matches_jax_pair_and_scipy(rng, case, bc):
    k, iv, T, mask = _batch(rng, B=3, E=4, n=24, wiggle=0.08 if case == "wiggle" else 0.0,
                            uniform=case != "nonuniform")
    ref_scfg, scfg = _scfgs(compensated=True, spline_bc=bc, grid_strikes=30)
    got = models.get("cubic_spline").fit_eval(k, iv, T, mask, scfg, dev=_dev)
    want = ref_models.get("cubic_spline").fit_eval(k, iv, T, mask, ref_scfg)
    assert set(got) == set(want) | {"fit_rmse"}
    pair = lambda hi, lo: np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    w64 = pair(got["w_grid"].numpy(), got["w_grid_lo"].numpy())
    assert got["w_grid"].dtype == got["w_grid_lo"].dtype == torch.float32
    assert np.abs(w64 - pair(want["w_grid"], want["w_grid_lo"])).max() < 2e-9
    for key in ("k_grid", "w_grid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key, ulps in (("iv_grid", 4), ("g", 64)):
        b = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), b, rtol=0,
                                   atol=ulps * EPS32 * max(1.0, np.abs(b).max()), err_msg=key)
    for key in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    if case == "wiggle":
        assert not got["butterfly_ok"].any()
    assert (got["fit_rmse"].numpy() == 0).all()
    # SciPy float64 through the same float32 quotes, on the float64 grid
    k32, iv32, T32 = (np.asarray(a, np.float32).astype(np.float64) for a in (k, iv, T))
    lo = np.minimum(k32[..., 0].max(-1), k32[..., -1].min(-1))
    hi = np.maximum(k32[..., 0].max(-1), k32[..., -1].min(-1))
    worst = 0.0
    for b in range(k.shape[0]):
        q = lo[b] + (hi[b] - lo[b]) * np.linspace(0.0, 1.0, 30)
        for e in range(k.shape[1]):
            ref = CubicSpline(k32[b, e], iv32[b, e] ** 2 * T32[b, e], bc_type=bc)(q)
            worst = max(worst, np.abs(w64[b, e] - ref).max())
    assert worst < 1e-9, worst


def test_parity_mode_refuses_clamped_and_runs_b1_in_float64(rng, monkeypatch):
    k, iv, T, mask = _batch(rng, B=2, E=3, n=12)
    _, scfg = _scfgs(compensated=True, spline_bc="clamped")
    with pytest.raises(ValueError, match="compensated"):
        models.get("cubic_spline").fit_eval(k, iv, T, mask, scfg, dev=_dev)
    from iv_interpolation_tpu_torch.ops import tridiag
    seen = []
    orig = tridiag.tridiag_solve_cuda
    monkeypatch.setattr(tridiag, "tridiag_solve_cuda",
                        lambda *a: seen.append(a[1].dtype) or orig(*a))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    out = fit_eval_surface_parity(f32(k), f32(iv), f32(T), n_grid=10)
    assert seen == [torch.float64] and out["w_grid"].shape == (2, 3, 10)


@pytest.mark.parametrize("method", ["cubic_spline", "smoothing_spline", "essvi"])
def test_local_vol_and_density_nan_masks(rng, method):
    k, iv, T, mask = _batch(rng, wiggle=0.05)
    ref_scfg, scfg = _scfgs(spline_bc="not-a-knot", smoothing_lam=1e-4, grid_strikes=20)
    model, ref_model = models.get(method), ref_models.get(method)
    got = model.attach_local_vol(model.fit_eval(k, iv, T, mask, scfg, dev=_dev),
                                 T=_dev(T), scfg=scfg)
    want = ref_model.attach_local_vol(ref_model.fit_eval(k, iv, T, mask, ref_scfg),
                                      T=jnp.asarray(T), scfg=ref_scfg)
    for key in ("local_vol", "density"):
        a, b = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=key)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0,
                                   atol=1e-10 * max(1.0, np.nanmax(np.abs(b))), err_msg=key)
    # the wiggled splines have cells to mask; eSSVI is arbitrage-free by
    # construction and has none
    assert np.isnan(got["local_vol"].numpy()).any() == (method != "essvi")


def test_parity_mode_local_vol_takes_the_quote_maturities(rng):
    """Parity mode's output has no ``fit`` (as in JAX, whose local vol
    then fails): the port's local vol reads T and gives float32 local vols,
    positive where the mask holds."""
    k, iv, T, mask = _batch(rng, B=2, E=3, n=12)
    _, scfg = _scfgs(compensated=True, grid_strikes=15)
    model = models.get("cubic_spline")
    out = model.attach_local_vol(model.fit_eval(k, iv, T, mask, scfg, dev=_dev),
                                 T=_dev(T), scfg=scfg)
    assert out["local_vol"].dtype == torch.float32
    fin = np.isfinite(out["local_vol"].numpy())
    assert fin.any() and (out["local_vol"].numpy()[fin] > 0).all()
