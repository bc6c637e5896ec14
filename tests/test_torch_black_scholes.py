"""Port parity: Black-Scholes price, Greeks and implied vol
(``ops/black_scholes.py``) against the JAX package.

Tolerances: float64 agrees with JAX to 1e-12 of max(1, |x|) (both
evaluate the same closed forms; the normal cdf and the exponentials come
from different libraries and differ in the last bits). float32 agrees
to 64 ulps of max(1, |x|): the closed forms chain log, exp, sqrt and
the normal cdf, each a few ulps apart between the libraries, and theta
and rho subtract terms of similar size. Implied vol recovers the input
vol to 1e-10 (float64) after the fixed 64 iterations wherever vega is
not vanishingly small.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import black_scholes as ref
from iv_interpolation_tpu_torch.ops import black_scholes as port

TOL = {np.float64: 1e-12, np.float32: 64 * float(np.finfo(np.float32).eps)}


def _inputs(rng, n, dtype):
    S = rng.uniform(50, 150, n)
    K = rng.uniform(50, 150, n)
    T = rng.uniform(0.02, 2.0, n)
    r = rng.uniform(0.0, 0.05, n)
    sigma = rng.uniform(0.05, 1.2, n)
    is_call = rng.random(n) < 0.5
    return [a.astype(dtype) for a in (S, K, T, r, sigma)] + [is_call]


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert (np.abs(got - want) <= TOL[dtype] * np.maximum(1.0, np.abs(want))).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_price_and_greeks_match_jax(rng, dtype):
    args = _inputs(rng, 2000, dtype)
    jargs = list(map(jnp.asarray, args))
    targs = list(map(torch.from_numpy, args))
    got = port.bs_price(*targs)
    assert got.dtype == targs[0].dtype
    _close(got.numpy(), ref.bs_price(*jargs), dtype)
    want_g = ref.bs_greeks(*jargs)
    got_g = port.bs_greeks(*targs)
    assert set(got_g) == set(want_g)
    for name in want_g:
        _close(got_g[name].numpy(), want_g[name], dtype)


def test_greeks_broadcast_like_the_pipeline(rng):
    """(B, L) spot / vol / maturity against (B, 1) strikes and flags."""
    S, _, T, r, sigma, _ = _inputs(rng, 60, np.float64)
    K = rng.uniform(80, 120, (3, 1))
    call = np.array([[True], [False], [True]])
    grid = lambda a: a.reshape(3, 20)
    want = ref.bs_greeks(*map(jnp.asarray, (grid(S), K, grid(T), grid(r),
                                            grid(sigma), call)))
    got = port.bs_greeks(*map(torch.from_numpy, (grid(S), K, grid(T), grid(r),
                                                 grid(sigma), call)))
    for name in want:
        assert got[name].shape == (3, 20)
        _close(got[name].numpy(), want[name], np.float64)


def test_implied_vol_matches_jax_and_round_trips(rng):
    """Where vega > 1e-3 the price determines sigma and both inversions
    recover it to 1e-10 and agree to 1e-12. Where vega is tiny (deep
    in or out of the money, short maturity) the price carries no
    information about sigma, neither converges, and the iterates of the
    two packages part at the first ulp; no claim is made there."""
    S, K, T, r, sigma, is_call = _inputs(rng, 500, np.float64)
    price = np.asarray(ref.bs_price(*map(jnp.asarray, (S, K, T, r, sigma, is_call))))
    want = np.asarray(ref.implied_vol(*map(jnp.asarray, (price, S, K, T, r, is_call))))
    got = port.implied_vol(*map(torch.from_numpy, (price, S, K, T, r, is_call))).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    vega = np.asarray(ref.bs_greeks(*map(jnp.asarray, (S, K, T, r, sigma, is_call)))["vega"])
    ok = vega > 1e-3
    assert ok.mean() > 0.8
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[ok], sigma[ok], rtol=0, atol=1e-10)
