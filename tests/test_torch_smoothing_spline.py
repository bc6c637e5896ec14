"""Port parity: ``iv_interpolation_tpu_torch/ops/smoothing_spline.py``
against the JAX package's ``ops/smoothing_spline.py`` and SciPy's
``make_smoothing_spline`` on the same seeded float64 smiles.

Tolerances: the fitted values and evaluations within 1e-12 of JAX, the
curvatures within 1e-10 of their largest |value| (two dense LU solves of
the same (n-2)^2 systems; lam Q^T Q with Q ~ 1/h puts the condition near
1e5 at lam = 1e-2, and the curvatures carry it, the values lam times
less); SciPy within 1e-8, the JAX suite's bound
(``tests/test_smoothing_spline.py``). Fits on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline, make_smoothing_spline

from iv_interpolation_tpu.ops import smoothing_spline as ref
from iv_interpolation_tpu_torch.ops import smoothing_spline as port


def _noisy_smile(rng, n):
    k = np.sort(rng.uniform(-1.2, 1.2, n))
    k += np.arange(n) * 1e-6
    w = 0.04 + 0.12 * k**2 + 0.004 * rng.normal(size=n)
    return k, w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("lam", [0.0, 1e-6, 1e-4, 1e-2])
def test_fit_matches_jax_and_scipy(rng, lam):
    B, n = 6, 40
    smiles = [_noisy_smile(rng, n) for _ in range(B)]
    k = np.stack([s[0] for s in smiles])
    w = np.stack([s[1] for s in smiles])
    got = port.fit_smoothing_spline(_t(k), _t(w), lam)
    want = ref.fit_smoothing_spline(jnp.asarray(k), jnp.asarray(w), lam)
    np.testing.assert_allclose(got.g.numpy(), np.asarray(want.g), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.M.numpy(), np.asarray(want.M), rtol=0,
                               atol=1e-10 * max(1.0, float(np.abs(want.M).max())))
    t = np.stack([np.linspace(kb[0], kb[-1], 120) for kb in k])
    S = port.eval_smoothing_spline(got, _t(t)).numpy()
    np.testing.assert_allclose(S, np.asarray(ref.eval_smoothing_spline(want, jnp.asarray(t))),
                               rtol=0, atol=1e-12)
    for b in range(B):
        oracle = (CubicSpline(k[b], w[b], bc_type="natural") if lam == 0.0
                  else make_smoothing_spline(k[b], w[b], lam=lam))
        np.testing.assert_allclose(S[b], oracle(t[b]), rtol=0, atol=1e-8)


def test_per_problem_lam(rng):
    k, w = zip(*(_noisy_smile(rng, 25) for _ in range(3)))
    k, w = np.stack(k), np.stack(w)
    lam = np.array([1e-5, 1e-3, 1e-1])
    got = port.fit_smoothing_spline(_t(k), _t(w), _t(lam))
    want = ref.fit_smoothing_spline(jnp.asarray(k), jnp.asarray(w), jnp.asarray(lam))
    t = np.broadcast_to(np.linspace(-1.0, 1.0, 50), (3, 50)).copy()
    np.testing.assert_allclose(port.eval_smoothing_spline(got, _t(t)).numpy(),
                               np.asarray(ref.eval_smoothing_spline(want, jnp.asarray(t))),
                               rtol=0, atol=1e-12)
    for b in range(3):
        np.testing.assert_allclose(port.eval_smoothing_spline(got, _t(t))[b].numpy(),
                                   make_smoothing_spline(k[b], w[b], lam=lam[b])(t[b]),
                                   rtol=0, atol=1e-8)


def test_too_few_points_raises():
    with pytest.raises(ValueError, match=">= 3"):
        port.fit_smoothing_spline(torch.zeros(2, dtype=torch.float64),
                                  torch.zeros(2, dtype=torch.float64), 1e-3)
