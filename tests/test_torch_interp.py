"""Port parity: masked timeline interpolation (``ops/interp.py``) against
the JAX package's ``ops/interp.py``, with pandas as the oracle where the
reference used it.

Tolerances: float64 agrees with JAX to 1e-12 (absolute, values O(10)).
float32 agrees to 2 ulps of max(1, |x|): both compute the same
interpolation formula, but XLA fuses ``prev (1 - w) + next w`` into a
multiply-add where the port rounds the product first. Masks (which slots
are NaN) and forward-filled / nearest values are selections and exact.
The cubic path adds the spline solve and evaluation (cubic spline tests:
1e-12 in float64).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from iv_interpolation_tpu.ops import interp as ref
from iv_interpolation_tpu_torch.ops import interp as port


def _gappy(rng, shape, frac_missing=0.7, leading=0, trailing=0):
    vals = rng.normal(size=shape) + 5.0
    vals[rng.uniform(size=shape) < frac_missing] = np.nan
    if leading:
        vals[..., :leading] = np.nan
    if trailing:
        vals[..., -trailing:] = np.nan
    vals[..., shape[-1] // 2] = 1.23   # at least one valid point
    return vals


def _both(vals, mask, **kw):
    want = np.asarray(ref.masked_interp(jnp.asarray(vals), jnp.asarray(mask), **kw))
    got = port.masked_interp(torch.from_numpy(vals), torch.from_numpy(mask), **kw)
    return got.numpy(), want


def _close(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if got.dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, equal_nan=True)
    else:
        eps = np.finfo(np.float32).eps
        bound = 2 * eps * np.maximum(1.0, np.abs(want))
        fin = np.isfinite(want)
        assert (np.abs(got[fin] - want[fin]) <= bound[fin]).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method", ["linear", "nearest", "ffill"])
@pytest.mark.parametrize("leading,trailing", [(0, 0), (5, 0), (0, 7), (3, 4)])
def test_masked_interp_matches_jax_and_pandas(rng, dtype, method, leading, trailing):
    vals = _gappy(rng, (500,), leading=leading, trailing=trailing)
    if method == "nearest":     # pandas' nearest differs at the ends
        vals[0], vals[-1] = 2.0, 3.0
    vals = vals.astype(dtype)
    got, want = _both(vals, np.ones(500, bool), method=method)
    _close(got, want)
    series = pd.Series(vals.astype(np.float64))
    oracle = (series.ffill() if method == "ffill"
              else series.interpolate(method=method)).to_numpy()
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, oracle, rtol=0, atol=tol, equal_nan=True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batched_columns_and_padding(rng, dtype):
    vals = _gappy(rng, (4, 3, 300), leading=2).astype(dtype)
    mask = np.arange(300)[None, None, :] < np.array([300, 250, 64, 1])[:, None, None]
    got, want = _both(vals, mask)
    _close(got, want)
    assert np.isnan(got[2, :, 64:]).all()


@pytest.mark.parametrize("max_gap,extrapolate", [(30, False), (30, True),
                                                 (0, True), (5, False)])
def test_max_gap_and_extrapolation(rng, max_gap, extrapolate):
    vals = np.full((3, 100), np.nan)
    vals[0, [0, 10, 90]] = [1.0, 2.0, 10.0]      # a bridged gap and a wide one
    vals[1, [45, 50]] = [10.0, 20.0]             # head region past max_gap
    vals[2, 40] = 3.0                            # one point: constant lines
    got, want = _both(vals, np.ones((3, 100), bool), max_gap_minutes=max_gap,
                      extrapolate=extrapolate)
    _close(got, want)
    if extrapolate:
        np.testing.assert_allclose(got[1, 0], 10.0 - 45 * 2.0)    # head
        np.testing.assert_allclose(got[1, 60], 20.0 + 10 * 2.0)   # tail
        np.testing.assert_allclose(got[2], 3.0)
    else:
        assert np.isnan(got[1, :45]).all() and (got[1, 51:] == 20.0).all()
    if max_gap == 30:
        assert np.isnan(got[0, 11:90]).all() and np.isfinite(got[0, 5])


def test_ffill_matches_jax(rng):
    vals = _gappy(rng, (2, 200), leading=4)
    mask = np.ones((2, 200), bool)
    want = np.asarray(ref.ffill(jnp.asarray(vals), jnp.asarray(mask)))
    got = port.ffill(torch.from_numpy(vals), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown interpolation method"):
        port.masked_interp(torch.ones(4), torch.ones(4, dtype=torch.bool),
                           method="spline")


@pytest.mark.parametrize("pos,valid,expect", [
    ([0, 3, 7, -1], [True, True, True, False], {0: 1.0, 3: 2.0, 7: 3.0}),
    # duplicates: the last valid observation wins
    ([3, 5, 3, 7, 3], [True] * 5, {3: 5.0, 5: 2.0, 7: 4.0}),
    ([3, 5, 3, 7, 3], [True, True, True, True, False], {3: 3.0, 5: 2.0, 7: 4.0}),
])
def test_scatter_observations_matches_jax(pos, valid, expect):
    vals = np.arange(1.0, len(pos) + 1)
    if len(pos) == 4:
        vals[3] = 99.0
    want = np.asarray(ref.scatter_observations(
        jnp.asarray(pos), jnp.asarray(vals), jnp.asarray(valid), 10))
    got = port.scatter_observations(torch.tensor(pos), torch.from_numpy(vals),
                                    torch.tensor(valid), 10).numpy()
    np.testing.assert_array_equal(got, want)
    for p, v in expect.items():
        assert got[p] == v
    assert np.isnan(np.delete(got, list(expect))).all()


def test_scatter_observations_batched_values(rng):
    pos = np.array([2, 9, 2, 4])
    vals = rng.normal(size=(3, 4))
    valid = np.array([True, True, True, False])
    want = np.asarray(ref.scatter_observations(
        jnp.asarray(pos), jnp.asarray(vals), jnp.asarray(valid), 12))
    got = port.scatter_observations(torch.from_numpy(pos), torch.from_numpy(vals),
                                    torch.from_numpy(valid), 12).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cubic_resample_matches_jax_and_pandas(rng, dtype):
    B, L, k = 5, 300, 14
    pos = np.sort(np.stack([rng.choice(L, size=k, replace=False) for _ in range(B)]),
                  axis=-1)
    pos[0, 0], pos[0, -1] = 3, L - 5          # leading and trailing NaN regions
    vals = (rng.normal(size=(B, k)) + 10.0).astype(dtype)
    want = np.asarray(ref.cubic_resample(jnp.asarray(pos), jnp.asarray(vals), L))
    got = port.cubic_resample(torch.from_numpy(pos), torch.from_numpy(vals), L).numpy()
    assert got.dtype == dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, equal_nan=True)
        for b in range(B):
            series = np.full(L, np.nan)
            series[pos[b]] = vals[b]
            oracle = pd.Series(series).interpolate(method="cubic").to_numpy()
            np.testing.assert_allclose(got[b], oracle, rtol=0, atol=1e-8,
                                       equal_nan=True)
    else:
        # the spline solve scales rounding by the 1/h^2 of the curvatures:
        # 256 ulps of the largest value, as the cubic spline tests hold
        bound = 256 * np.finfo(np.float32).eps * np.nanmax(np.abs(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=bound, equal_nan=True)
