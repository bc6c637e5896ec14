"""Port parity: SABR (``ops/sabr.py``) against the JAX package's on the
same seeded slices.

``sabr_vol`` (the ATM limit and the z < 0 conjugate wing included) float64
<= 1e-12 relative; ``sabr_init`` <= 1e-9; batched fits in float64: fitted
vols at the quotes <= 1e-8 absolute, params <= 1e-6 with beta fixed
(<= 1e-5 with beta free, where alpha and beta trade off along a nearly
flat valley), ``n_accepted`` and ``converged`` equal; in float32: fitted
vols within 5e-5 of the slice's vol scale and cost within a factor 1.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import sabr as ref
from iv_interpolation_tpu_torch.ops import sabr as port


def _slices(rng, B=6, n=15, noise=1e-4):
    F = rng.uniform(80, 120, B)
    T = rng.uniform(0.1, 2.0, B)
    K = F[:, None] * np.exp(np.linspace(-0.4, 0.4, n))[None]
    par = np.stack([rng.uniform(1.5, 3.0, B), np.full(B, 0.5),
                    rng.uniform(-0.5, 0.2, B), rng.uniform(0.2, 0.8, B)], -1)
    iv = np.asarray(ref.sabr_vol(*map(jnp.asarray, (par, F, K, T))))
    return K, iv + noise * rng.normal(size=iv.shape), F, T, par


def test_vol_matches_jax_including_atm_and_both_wings(rng):
    K, _, F, T, par = _slices(rng)
    K[:, 7] = F                                   # exactly at the money: the series branch
    got = port.sabr_vol(*map(torch.from_numpy, (par, F, K, T))).numpy()
    want = np.asarray(ref.sabr_vol(*map(jnp.asarray, (par, F, K, T))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.isfinite(got).all()
    # scalar F and T against one parameter set
    got = port.sabr_vol(torch.from_numpy(par[0]), 100.0, torch.from_numpy(K[0]), 1.5).numpy()
    want = np.asarray(ref.sabr_vol(jnp.asarray(par[0]), 100.0, jnp.asarray(K[0]), 1.5))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # (B, E) slices with (B, E) forwards, as the surface calls it
    p2, K2 = np.tile(par[:, None], (1, 3, 1)), np.tile(K[:, None], (1, 3, 1))
    F2, T2 = np.tile(F[:, None], (1, 3)), np.tile(T[:, None], (1, 3)) * [1.0, 2.0, 3.0]
    np.testing.assert_allclose(
        port.sabr_vol(*map(torch.from_numpy, (p2, F2, K2, T2))).numpy(),
        np.asarray(ref.sabr_vol(*map(jnp.asarray, (p2, F2, K2, T2)))), rtol=1e-12, atol=0)


def test_deep_otm_put_wing_f32_stable():
    """z << 0: the direct numerator cancels (float32 gives <= 0 and a NaN
    log); the conjugate form is exact there. z >> 0 stays on the direct
    branch. Values and forward-mode derivatives are finite in float32 and
    agree with the reference."""
    params = np.array([1e-3, 0.5, 0.3, 5.0])      # tiny alpha -> |z| huge
    K = np.array([1e-3, 0.01, 0.1, 1.0, 10.0])    # K << F -> z << 0
    got64 = port.sabr_vol(torch.from_numpy(params), 100.0, torch.from_numpy(K), 1.0).numpy()
    want64 = np.asarray(ref.sabr_vol(jnp.asarray(params), jnp.float64(100.0), jnp.asarray(K),
                                     jnp.float64(1.0)))
    np.testing.assert_allclose(got64, want64, rtol=1e-12)
    p32, K32 = torch.from_numpy(params).float(), torch.from_numpy(K).float()
    got32 = port.sabr_vol(p32, 100.0, K32, 1.0)
    assert got32.dtype == torch.float32
    assert np.isfinite(got32.numpy()).all() and (got32.numpy() > 0).all()
    np.testing.assert_allclose(got32.numpy(), got64, rtol=2e-3)
    hi32 = port.sabr_vol(p32, 100.0, torch.tensor([1e3, 1e4, 1e5]), 1.0).numpy()
    assert np.isfinite(hi32).all() and (hi32 > 0).all()
    # the unselected branches feed no NaN into forward-mode derivatives
    for Kq in (K32, torch.tensor([1e3, 1e4, 100.0])):
        J = torch.func.jacfwd(lambda p: port.sabr_vol(p, 100.0, Kq, 1.0))(p32)
        assert np.isfinite(J.numpy()).all()
    J64 = torch.func.jacfwd(lambda p: port.sabr_vol(p, 100.0, torch.from_numpy(K), 1.0))(
        torch.from_numpy(params)).numpy()
    Jr = np.asarray(jax.jacfwd(lambda p: ref.sabr_vol(p, jnp.float64(100.0), jnp.asarray(K),
                                                      jnp.float64(1.0)))(jnp.asarray(params)))
    np.testing.assert_allclose(J64, Jr, rtol=1e-9, atol=1e-12 * np.abs(Jr).max())


@pytest.mark.parametrize("beta", [0.5, 0.9])
def test_init_matches_jax(rng, beta):
    K, iv, F, T, _ = _slices(rng)
    got = port.sabr_init(*map(torch.from_numpy, (K, iv, F, T)), beta=beta).numpy()
    want = np.asarray(jax.vmap(lambda k_, i_, f_, t_: ref.sabr_init(k_, i_, f_, t_, beta=beta))(
        *map(jnp.asarray, (K, iv, F, T))))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    one = port.sabr_init(torch.from_numpy(K[0]), torch.from_numpy(iv[0]), float(F[0]), 1.0,
                         beta=beta).numpy()
    np.testing.assert_allclose(one, want[0], rtol=1e-9)


def _fit_both(K, iv, F, T, **kw):
    got = port.fit_sabr_batched(*map(torch.from_numpy, (K, iv, F, T)), **kw)
    want = ref.fit_sabr_batched(*map(jnp.asarray, (K, iv, F, T)), **kw)
    v_got = port.sabr_vol(got.params, *map(torch.from_numpy, (F, K, T))).numpy()
    v_want = np.asarray(ref.sabr_vol(want.params, *map(jnp.asarray, (F, K, T))))
    return got, want, v_got, v_want


@pytest.mark.parametrize("fix_beta,p_tol", [(0.5, 1e-6), (0.7, 1e-6), (None, 1e-5)])
def test_batched_fit_float64_matches_jax(rng, fix_beta, p_tol):
    K, iv, F, T, _ = _slices(rng)
    got, want, v_got, v_want = _fit_both(K, iv, F, T, max_iters=32, fix_beta=fix_beta)
    np.testing.assert_allclose(v_got, v_want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=0, atol=p_tol)
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    if fix_beta is not None:
        assert (got.params.numpy()[:, 1] == fix_beta).all()
    assert np.sqrt(np.mean((v_got - iv) ** 2)) < 5e-4


@pytest.mark.parametrize("fix_beta", [0.5, None])
def test_batched_fit_float32_stays_within_the_float32_bound(rng, fix_beta):
    K, iv, F, T, _ = (a.astype(np.float32) for a in _slices(rng))
    got, want, v_got, v_want = _fit_both(K, iv, F, T, max_iters=32, fix_beta=fix_beta)
    assert got.params.dtype == torch.float32
    scale = np.abs(iv).max(axis=-1, keepdims=True)
    assert (np.abs(v_got - v_want) <= 5e-5 * scale).all()
    ratio = got.cost.numpy() / np.asarray(want.cost)
    assert ((ratio < 1.5) & (ratio > 1 / 1.5)).all(), ratio


def test_batch_shape_and_single_slice(rng):
    K, iv, F, T, _ = _slices(rng, B=6)
    got = port.fit_sabr_batched(*(torch.from_numpy(a.reshape(2, 3, *a.shape[1:]))
                                  for a in (K, iv, F, T)), max_iters=8)
    assert got.params.shape == (2, 3, 4) and got.cost.shape == (2, 3)
    flat = port.fit_sabr_batched(*map(torch.from_numpy, (K, iv, F, T)), max_iters=8)
    np.testing.assert_array_equal(got.params.numpy().reshape(6, 4), flat.params.numpy())
    # one slice, with weights and a start, against the reference
    wt = np.linspace(0.5, 1.5, K.shape[1])
    p0 = np.array([2.0, 0.5, -0.1, 0.4])
    one = port.fit_sabr(torch.from_numpy(K[0]), torch.from_numpy(iv[0]), float(F[0]),
                        float(T[0]), weights=torch.from_numpy(wt),
                        params0=torch.from_numpy(p0), max_iters=24)
    want = ref.fit_sabr(jnp.asarray(K[0]), jnp.asarray(iv[0]), float(F[0]), float(T[0]),
                        weights=jnp.asarray(wt), params0=jnp.asarray(p0), max_iters=24)
    assert one.params.shape == (4,) and one.cost.shape == ()
    np.testing.assert_allclose(one.params.numpy(), np.asarray(want.params), atol=1e-6)
    assert int(one.n_accepted) == int(want.n_accepted)
    default = port.fit_sabr(torch.from_numpy(K[0]), torch.from_numpy(iv[0]), float(F[0]),
                            float(T[0]), max_iters=24)
    np.testing.assert_allclose(default.params.numpy(), flat.params.numpy()[0], atol=1e-3)
