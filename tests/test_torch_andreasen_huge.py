"""Port parity: Andreasen-Huge (``iv_interpolation_tpu_torch/ops/
andreasen_huge.py``, its ``models`` entry and ``convert.ah_fit_from_numpy``)
against the JAX package, on seeded numpy inputs (CPU tensors, so every
solve is the plain Thomas loop; the JAX package solves by PCR).

Tolerances:
* the step's bands and the closed-form Jacobian: within 1e-13 of scale
  (``jax.jacfwd`` through ``custom_linear_solve``, float64);
* the time-value tangent at exact ties of max(c - intrinsic, 0): within
  1e-15 (JAX passes half of the tangent at a tie);
* fits in float64: prices c within 1e-10, theta within 1e-8, fit_rmse
  within 1e-12, flags equal, local vol within 1e-8; the Black-inverted
  grids are held in price space (normalized_call of both w within 1e-10),
  since the inversion divides by a vega that vanishes in the wings;
* fits in float32: flags equal, c within 1024 ulps of the unit price (the
  reference's own flag policy: Thomas and PCR round differently);
* grids keep their nodes off the quote-cell boundaries (midpoints between
  adjacent strikes): a node on a boundary takes its cell from one ulp of
  x, which XLA's fused multiply-add and PyTorch's separate one round
  apart, and theta in a cell the quotes barely see can then move by 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import andreasen_huge as ref
from iv_interpolation_tpu.ops.tridiag import tridiag_matvec
from iv_interpolation_tpu_torch import convert, models
from iv_interpolation_tpu_torch.config import get_config
from iv_interpolation_tpu_torch.ops import andreasen_huge as ah

EPS32 = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quotes(seed, B=2, E=3, m=9, dtype=np.float64, arb=True):
    """Jittered strikes around k = 0, a skewed smile per surface and, with
    ``arb``, surface 1 carrying an ATM spike (butterfly) and a collapsing
    slice (calendar arbitrage)."""
    rng = np.random.default_rng(seed)
    base = np.linspace(-0.5, 0.5, m)
    k = np.sort(base + rng.uniform(-0.02, 0.02, (B, E, m)), axis=-1)
    T = np.cumsum(rng.uniform(0.2, 0.5, (B, E)), axis=-1)
    level = rng.uniform(0.2, 0.35, (B, 1, 1))
    iv = level + 0.1 * k ** 2 - 0.05 * k + 0.02 * np.sqrt(T)[..., None]
    if arb and B > 1:
        iv[1, :, m // 2] *= 1.4
        iv[1, 1] = iv[1, 0] * 0.5
    return k.astype(dtype), iv.astype(dtype), T.astype(dtype)


def _chain(B=2, E=4, m=13):
    """The JAX suite's chain (tests/test_andreasen_huge.py)."""
    k = np.broadcast_to(np.linspace(-0.6, 0.6, m), (B, E, m)).copy()
    T = np.broadcast_to(np.array([0.1, 0.3, 0.7, 1.2])[:E], (B, E)).copy()
    iv = 0.25 + 0.1 * k ** 2 + 0.02 * np.sqrt(T)[..., None]
    return k, iv, T


# (name, inputs, mask, n_grid, n_iters); n_grid=33 keeps the chain's
# nodes (spacing 0.1 from -1.6) off its cell boundaries (at .x5)
def _poisoned():
    k, iv, T = _chain()
    iv = iv.copy()
    iv[:, :, 4] = 3.0                       # a garbage quote, masked
    mask = np.ones_like(iv, bool)
    mask[:, :, 4] = False
    return (k, iv, T), mask


def _sentinel():
    k, iv, T = _chain()
    k, iv = k.copy(), iv.copy()
    k[:, :, 0] = -9.0                       # a finite sentinel strike
    iv[:, :, 0] = np.nan                    # and a NaN vol, both masked
    mask = np.ones_like(iv, bool)
    mask[:, :, 0] = False
    return (k, iv, T), mask


CASES = {
    "arb": (_quotes(0), None, 49, 8),
    "small": (_quotes(1, E=4, m=13, arb=False), None, 65, 4),
    "poisoned": (*_poisoned(), 33, 6),
    "sentinel": (*_sentinel(), 33, 6),
}


@pytest.fixture(scope="module")
def jax_fits():
    """Each case's JAX ``fit_eval_ah_surface`` output, numpy, computed once."""
    out = {}
    for name, ((k, iv, T), mask, n_grid, n_iters) in CASES.items():
        res = ref.fit_eval_ah_surface(
            jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T), n_grid=n_grid, n_iters=n_iters,
            quote_mask=None if mask is None else jnp.asarray(mask))
        out[name] = jax.tree.map(np.asarray, res)
    return out


def _port(name, dtype=torch.float64):
    (k, iv, T), mask, n_grid, n_iters = CASES[name]
    put = lambda a: _t(a).to(dtype)
    return ah.fit_eval_ah_surface(put(k), put(iv), put(T), n_grid=n_grid, n_iters=n_iters,
                                  quote_mask=None if mask is None else _t(mask))


def test_normalized_call_and_vega_match_jax(rng):
    k = rng.uniform(-2, 2, 200)
    w = np.concatenate([rng.uniform(0, 1, 190), [0.0, 1e-15, 1e-14, 2e-14] + [0.5] * 6])
    np.testing.assert_allclose(ah.normalized_call(_t(k), _t(w)).numpy(),
                               np.asarray(ref.normalized_call(k, w)), rtol=0, atol=1e-15)
    np.testing.assert_allclose(ah._normalized_vega_w(_t(k), _t(w)).numpy(),
                               np.asarray(ref._normalized_vega_w(k, w)), rtol=1e-13, atol=1e-300)


def _system(rng, n=40):
    x = np.linspace(-1.5, 1.5, n)
    sig2 = rng.uniform(0.01, 0.3, n)
    c_prev = np.maximum(1 - np.exp(x), 0) + 0.02 * np.exp(-x * x)
    return x, sig2, c_prev, 0.37


def test_step_system_matches_jax(rng):
    x, sig2, _, dt = _system(rng)
    got = ah._step_system(_t(sig2), _t(x), torch.tensor(dt, dtype=torch.float64))
    want = ref._step_system(jnp.asarray(sig2), jnp.asarray(x), jnp.asarray(dt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14, atol=1e-15)
    # interior rows annihilate constants and K = e^x (a martingale kernel)
    K = np.exp(x)
    for vec in (np.ones_like(K), K):
        y = ah._matvec(*got, _t(vec)).numpy()
        np.testing.assert_allclose(y[1:-1], vec[1:-1], rtol=1e-12)
        np.testing.assert_allclose(
            y, np.asarray(tridiag_matvec(*want, jnp.asarray(vec))), rtol=1e-14)


@pytest.mark.parametrize("refine", [False, True])
def test_ah_step_matches_jax_and_a_dense_solve(rng, refine):
    """Batched over 3 systems with their own dt: the JAX step (PCR)
    system by system, and numpy's dense solve of the same rows."""
    rows = [_system(rng) for _ in range(3)]
    x, sig2, c_prev = (np.stack([r[i] for r in rows]) for i in range(3))
    dt = np.array([0.05, 0.37, 2.0])
    got = ah.ah_step(_t(c_prev), _t(sig2), _t(x), _t(dt), refine=refine).numpy()
    for b in range(3):
        want = np.asarray(ref.ah_step(jnp.asarray(c_prev[b]), jnp.asarray(sig2[b]),
                                      jnp.asarray(x[b]), jnp.asarray(dt[b]), refine=refine))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-14)
        dl, d, du = (a.numpy() for a in ah._step_system(_t(sig2[b]), _t(x[b]),
                                                        torch.tensor(dt[b], dtype=torch.float64)))
        A = np.diag(d) + np.diag(du[:-1], 1) + np.diag(dl[1:], -1)
        rhs = c_prev[b].copy()
        rhs[0], rhs[-1] = np.exp(x[b, 1]) - np.exp(x[b, 0]), 0.0
        np.testing.assert_allclose(got[b], np.linalg.solve(A, rhs), rtol=0, atol=1e-13)


def _slice_args(rng, m=9, n=49):
    k, iv, T = _quotes(3, B=1, E=1, m=m)
    kq, w = k[0, 0], iv[0, 0] ** 2 * T[0, 0]
    x = np.linspace(kq[0] - 1.0, kq[-1] + 1.0, n)
    c_prev = np.maximum(1 - np.exp(x), 0) + 0.01 * np.exp(-x * x)
    c_mkt = np.asarray(ref.normalized_call(kq, w))
    wgt = 1.0 / np.maximum(np.asarray(ref._normalized_vega_w(kq, w)), 1e-3)
    theta = np.sqrt(w / T[0, 0]) * rng.uniform(0.8, 1.2, m)
    return theta, (c_prev, kq, c_mkt, wgt, x, 0.3)


def test_closed_form_jacobian_matches_jacfwd(rng):
    """Two slices batched: residuals and the (quote, param) Jacobian
    against the JAX residual and ``jax.jacfwd`` through its
    ``custom_linear_solve``."""
    slices = [_slice_args(rng) for _ in range(2)]
    batch = lambda i: _t(np.stack([s[1][i] for s in slices]))
    theta = _t(np.stack([s[0] for s in slices]))
    r, J = ah._slice_linearize(theta, *(batch(i) for i in range(5)), torch.tensor([0.3, 0.3], dtype=torch.float64))
    r_alone = ah._slice_residual(theta, *(batch(i) for i in range(5)), torch.tensor([0.3, 0.3], dtype=torch.float64))
    np.testing.assert_array_equal(r.numpy(), r_alone.numpy())
    for b, (th, args) in enumerate(slices):
        args = [jnp.asarray(a) for a in args]
        want_r = np.asarray(ref._slice_residual(jnp.asarray(th), *args))
        want_J = np.asarray(jax.jacfwd(ref._slice_residual)(jnp.asarray(th), *args))
        np.testing.assert_allclose(r[b].numpy(), want_r, rtol=0, atol=1e-13)
        np.testing.assert_allclose(J[b].numpy(), want_J, rtol=0,
                                   atol=1e-13 * np.abs(want_J).max())


def test_time_value_tangent_halves_at_ties(rng):
    """c equal to intrinsic at some nodes (time value exactly 0), above it
    at others and below at one: the port's tangent of ``_interp_price``
    against ``jax.jvp`` of the reference in 4 directions."""
    n, Q, P = 33, 7, 4
    x = np.linspace(-1.0, 1.0, n)
    intr = np.maximum(1 - np.exp(x), 0)
    c = intr + np.where(rng.uniform(size=n) < 0.5, 0.0, rng.uniform(0, 0.05, n))
    c[5] = intr[5] - 1e-3
    kq = np.sort(rng.uniform(-0.95, 0.95, Q))
    dc = rng.normal(size=(P, n))
    got = ah._interp_price_tangent(_t(c)[None], _t(dc)[None], _t(x)[None], _t(kq)[None])[0]
    for p in range(P):
        _, want = jax.jvp(lambda cc: ref._interp_price(cc, jnp.asarray(x), jnp.asarray(kq)),
                          (jnp.asarray(c),), (jnp.asarray(dc[p]),))
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want), rtol=0, atol=1e-15)
    assert (c == intr).sum() > 5


@pytest.mark.parametrize("name", list(CASES))
def test_fit_eval_matches_jax_float64(jax_fits, name):
    got, want = _port(name), jax_fits[name]
    fit, wfit = got["fit"], want["fit"]
    np.testing.assert_allclose(fit.x.numpy(), wfit.x, rtol=0, atol=1e-15)
    np.testing.assert_allclose(fit.c.numpy(), wfit.c, rtol=0, atol=1e-10)
    np.testing.assert_allclose(fit.theta.numpy(), wfit.theta, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["fit_rmse"].numpy(), want["fit_rmse"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["local_vol"].numpy(), want["local_vol"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["g"].numpy(), want["g"], rtol=0,
                               atol=1e-8 * max(1.0, np.abs(want["g"]).max()))
    k_grid = got["k_grid"]
    price = lambda w: ah.normalized_call(k_grid, _t(w)).numpy()
    np.testing.assert_allclose(price(got["w_grid"].numpy()), price(want["w_grid"]),
                               rtol=0, atol=1e-10)
    for key in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
        assert got[key].all(), key                # arbitrage-free by construction
    assert np.isfinite(fit.c.numpy()).all()
    if name == "sentinel":                       # the grid spans the real strikes only
        assert fit.x.min() > -9.0 + 5.0


def test_fit_eval_float32_flags_and_prices():
    """float32 (the production dtype): the flags equal the reference's
    and hold on every surface, c within 1024 ulps of the unit price."""
    (k, iv, T), _, n_grid, n_iters = CASES["arb"]
    got = ah.fit_eval_ah_surface(*(_t(a).float() for a in (k, iv, T)),
                                 n_grid=n_grid, n_iters=n_iters)
    want = ref.fit_eval_ah_surface(*(jnp.asarray(a, jnp.float32) for a in (k, iv, T)),
                                   n_grid=n_grid, n_iters=n_iters)
    assert got["fit"].c.dtype == torch.float32
    np.testing.assert_allclose(got["fit"].c.numpy(), np.asarray(want["fit"].c),
                               rtol=0, atol=1024 * EPS32)
    for key in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert got[key].all()


def test_eval_ah_and_local_vol_match_jax(jax_fits):
    """Scattered queries before the first expiry, between slices, on a
    slice and beyond the last, on the port's own fit and on the JAX fit
    carried over by ``convert.ah_fit_from_numpy``: total variance held in
    price space within 1e-10."""
    wfit = jax_fits["arb"]["fit"]
    fit = convert.ah_fit_from_numpy(wfit, device="cpu")
    assert all(getattr(fit, f).device.type == "cpu" for f in ah.AHFit._fields)
    T = wfit.expiries
    k_q = np.array([[-0.4, -0.1, 0.0, 0.2, 0.45, 0.1], [0.3, -0.3, 0.0, 0.05, -0.45, 0.2]])
    T_q = np.stack([[0.5 * T[b, 0], T[b, 0], 0.5 * (T[b, 0] + T[b, 1]), T[b, 1],
                     T[b, -1] + 0.3, T[b, -1] * 2] for b in range(2)])
    want = np.asarray(ref.eval_ah(jax.tree.map(jnp.asarray, wfit), jnp.asarray(k_q),
                                  jnp.asarray(T_q)))
    mine = ah.eval_ah(_port("arb")["fit"], _t(k_q), _t(T_q)).numpy()
    price = lambda w: ah.normalized_call(_t(k_q), _t(w)).numpy()
    for got in (ah.eval_ah(fit, _t(k_q), _t(T_q)).numpy(), mine):
        np.testing.assert_allclose(price(got), price(want), rtol=0, atol=1e-10)
    assert (want > 0).all()
    np.testing.assert_allclose(ah.ah_local_vol(fit).numpy(),
                               np.asarray(ref.ah_local_vol(jax.tree.map(jnp.asarray, wfit))),
                               rtol=0, atol=1e-15)


def test_invert_w_brackets_up_to_w_hi():
    """iv = 2 at T = 5 is w = 20, above the default bracket 16: the
    caller's w_hi (_VOL_HI^2 * T) recovers it, the default caps it, as in
    the reference; prices at intrinsic invert to 0."""
    k = np.array([0.0, 0.1, -0.2, -3.0])
    w = np.array([20.0, 20.0, 20.0, 0.0])
    c = ref.normalized_call(jnp.asarray(k), jnp.asarray(w))
    for w_hi in (16.0, 125.0):
        got = ah._invert_w(_t(np.asarray(c)), _t(k), w_hi=w_hi).numpy()
        want = np.asarray(ref._invert_w(c, jnp.asarray(k), w_hi=w_hi))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got[:3], 20.0, rtol=1e-9)
    assert got[3] == 0.0


def test_density_diagnostics_match_jax(jax_fits):
    fit = jax_fits["small"]["fit"]
    x = fit.x[:, None, :]
    np.testing.assert_allclose(ah._price_space_density(_t(fit.c), _t(x)).numpy(),
                               np.asarray(ref._price_space_density(jnp.asarray(fit.c),
                                                                   jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)


def test_model_registry_entry_matches_jax(jax_fits):
    """``models.get("ah")``: fit_eval through the surface task's ``dev``
    hook, and the log-moneyness density with NaN in the boundary columns,
    against the JAX model's."""
    from iv_interpolation_tpu import models as ref_models
    from iv_interpolation_tpu.config import get_config as ref_get_config

    (k, iv, T), mask, n_grid, n_iters = CASES["poisoned"]
    scfgs = [get("testing").surface for get in (ref_get_config, get_config)]
    for s in scfgs:
        s.ah_grid, s.ah_iters = n_grid, n_iters
    model = models.get("ah")
    assert model.description == ref_models.get("ah").description
    got = model.fit_eval(k, iv, T, mask, scfgs[1], dev=_t)
    got = model.attach_local_vol(got, T=_t(T), scfg=scfgs[1])
    want = ref_models.get("ah").attach_local_vol(jax_fits["poisoned"], T=T, scfg=scfgs[0])
    dens, want_dens = got["density"].numpy(), np.asarray(want["density"])
    np.testing.assert_array_equal(np.isnan(dens), np.isnan(want_dens))
    assert np.isnan(dens[..., [0, -1]]).all() and np.isfinite(dens[..., 1:-1]).all()
    np.testing.assert_allclose(dens[..., 1:-1], want_dens[..., 1:-1], rtol=0,
                               atol=1e-8 * np.abs(want_dens[..., 1:-1]).max())
    for key in models.PERSIST_KEYS:
        assert key in got, key
