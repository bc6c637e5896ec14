"""Port parity: cubic-spline fit and evaluation against the JAX package
(``ops/cubic_spline.py``) and SciPy's ``CubicSpline``.

Tolerances: float64 agrees with JAX to 1e-12 (the port solves with
Thomas where JAX uses PCR; both are backward stable on these diagonally
dominant systems) and with SciPy to 1e-8. float32 agrees with JAX to
256 ulps of the largest |value| (the curvature solve and the cubic
evaluation each add a few ulps, scaled by the 1/h^2 of M).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

from iv_interpolation_tpu.ops import cubic_spline as ref
from iv_interpolation_tpu_torch.ops import cubic_spline as port


def _smiles(rng, B, n, dtype=np.float64):
    x = np.sort(rng.uniform(-1.0, 1.0, (B, n)), axis=-1)
    x += np.arange(n) * 0.05  # keep knots apart
    y = 0.2 + 0.1 * x * x + 0.01 * rng.normal(size=(B, n))
    return x.astype(dtype), y.astype(dtype)


def _queries(rng, x, m):
    lo, hi = x[:, :1], x[:, -1:]
    # includes points outside [x0, xn]: extrapolation with the end cubics
    u = rng.uniform(-0.2, 1.2, (x.shape[0], m))
    return (lo + u * (hi - lo)).astype(x.dtype)


def _close(a, b, dtype):
    if dtype == np.float64:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    else:
        scale = max(1.0, np.abs(b).max())
        np.testing.assert_allclose(
            a, b, rtol=0, atol=256 * np.finfo(np.float32).eps * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("bc", ["natural", "clamped", "not-a-knot"])
@pytest.mark.parametrize("n", [2, 3, 4, 12, 50])
def test_fit_and_eval_match_jax(rng, n, bc, dtype):
    B, m = 6, 33
    x, y = _smiles(rng, B, n, dtype)
    t = _queries(rng, x, m)
    kw = {}
    if bc == "clamped":
        kw = dict(fp0=rng.normal(size=B).astype(dtype),
                  fpn=rng.normal(size=B).astype(dtype))
    M_ref = np.array(ref.fit_cubic_spline(
        jnp.asarray(x), jnp.asarray(y), bc_type=bc,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    M = port.fit_cubic_spline(torch.from_numpy(x), torch.from_numpy(y),
                              bc_type=bc,
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert M.dtype == torch.from_numpy(x).dtype
    _close(M.numpy(), M_ref, dtype)

    args = [torch.from_numpy(a) for a in (x, y, M_ref, t)]
    jargs = [jnp.asarray(a) for a in (x, y, M_ref, t)]
    for p_fn, j_fn in ((port.eval_cubic_spline, ref.eval_cubic_spline),
                       (port.eval_cubic_spline_deriv, ref.eval_cubic_spline_deriv),
                       (port.eval_cubic_spline_second_deriv,
                        ref.eval_cubic_spline_second_deriv)):
        _close(p_fn(*args).numpy(), np.asarray(j_fn(*jargs)), dtype)


@pytest.mark.parametrize("knots,queries", [(np.float32, np.float64),
                                            (np.float64, np.float32)])
def test_mixed_dtypes_promote_as_in_jax(rng, knots, queries):
    """float32 knots with float64 queries, or the reverse, evaluate in
    float64 as the JAX package's promotion does; the float32 operand's
    rounding bounds the gap."""
    B, n, m = 5, 12, 31
    x, y = _smiles(rng, B, n, knots)
    M = np.array(ref.fit_cubic_spline(jnp.asarray(x), jnp.asarray(y),
                                      bc_type="not-a-knot"))
    t = _queries(rng, x, m).astype(queries)
    args = [torch.from_numpy(a) for a in (x, y, M, t)]
    jargs = [jnp.asarray(a) for a in (x, y, M, t)]
    got_all = port.eval_cubic_spline_all(*args)
    for i, (p_fn, j_fn) in enumerate(
            ((port.eval_cubic_spline, ref.eval_cubic_spline),
             (port.eval_cubic_spline_deriv, ref.eval_cubic_spline_deriv),
             (port.eval_cubic_spline_second_deriv, ref.eval_cubic_spline_second_deriv))):
        want = np.asarray(j_fn(*jargs))
        got = p_fn(*args)
        assert got.dtype == torch.float64 and want.dtype == np.float64
        assert torch.equal(got, got_all[i])
        _close(got.numpy(), want, np.float32)


@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
def test_matches_scipy(rng, bc):
    B, n, m = 4, 15, 40
    x, y = _smiles(rng, B, n)
    t = _queries(rng, x, m)
    tx, ty, tt = map(torch.from_numpy, (x, y, t))
    M = port.fit_cubic_spline(tx, ty, bc_type=bc)
    S = port.eval_cubic_spline(tx, ty, M, tt).numpy()
    S1 = port.eval_cubic_spline_deriv(tx, ty, M, tt).numpy()
    S2 = port.eval_cubic_spline_second_deriv(tx, ty, M, tt).numpy()
    for i in range(B):
        cs = CubicSpline(x[i], y[i], bc_type=bc)
        np.testing.assert_allclose(S[i], cs(t[i]), atol=1e-8)
        np.testing.assert_allclose(S1[i], cs(t[i], 1), atol=1e-8)
        np.testing.assert_allclose(S2[i], cs(t[i], 2), atol=1e-8)


def test_bracket_matches_jax_and_clips(rng):
    x, _ = _smiles(rng, 3, 9)
    t = _queries(rng, x, 50)
    t[:, 0] = x[:, 3]                     # a query exactly on a knot
    t[:, 1] = x[:, 0] - 5.0               # far left
    t[:, 2] = x[:, -1] + 5.0              # far right
    got = port._bracket(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    want = np.asarray(ref._bracket(jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)
    # shared knots broadcast against a batch of queries
    got_b = port._bracket(torch.from_numpy(x[0]), torch.from_numpy(t)).numpy()
    want_b = np.asarray(ref._bracket(jnp.asarray(x[0]), jnp.asarray(t)))
    np.testing.assert_array_equal(got_b, want_b)


def test_bad_inputs_raise(rng):
    x, y = map(torch.from_numpy, _smiles(rng, 2, 5))
    with pytest.raises(ValueError):
        port.fit_cubic_spline(x, y, bc_type="periodic")
    with pytest.raises(ValueError):
        port.fit_cubic_spline(x, y, bc_type="clamped")    # no end slopes
    with pytest.raises(ValueError):
        port.fit_cubic_spline(x[..., :1], y[..., :1])
