"""The plain reference against SciPy and against candles built by hand."""

import math

import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

from benchmark.reference import spline, stream


def test_spline_matches_scipy_not_a_knot():
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.uniform(0.05, 0.3, (4, 3, 9)), axis=-1) - 1.0
    y = rng.normal(size=(4, 3, 9))
    t = np.sort(rng.uniform(x.min() - 0.2, x.max() + 0.2, (4, 3, 13)), axis=-1)
    tx, ty, tt = (torch.tensor(a) for a in (x, y, t))
    s = spline.not_a_knot_slopes(tx, ty)
    S, S1, S2 = spline.hermite(tx, ty, s, tt)
    for b in range(4):
        for e in range(3):
            cs = CubicSpline(x[b, e], y[b, e], bc_type="not-a-knot")
            np.testing.assert_allclose(S[b, e].numpy(), cs(t[b, e]), rtol=1e-11, atol=1e-11)
            np.testing.assert_allclose(S1[b, e].numpy(), cs(t[b, e], 1), rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(S2[b, e].numpy(), cs(t[b, e], 2), rtol=1e-9, atol=1e-9)


def test_surface_grid_flags_and_margins():
    k = torch.linspace(-0.5, 0.5, 8, dtype=torch.float64).expand(2, 3, 8).clone()
    k[:, 1] *= 1.2
    T = torch.tensor([0.1, 0.5, 1.0], dtype=torch.float64).expand(2, 3)
    iv = (0.3 + 0.1 * k * k).clone()
    iv[1] += 0.05 * torch.tensor([1.0, -1.0] * 4, dtype=torch.float64)   # wiggles
    out = spline.surface(k, iv, T, 11, 1e-4, 1e-4)
    grid = torch.linspace(-0.5, 0.5, 11, dtype=torch.float64)
    w = iv * iv * T[..., None]
    cs = CubicSpline(k[0, 1].numpy(), w[0, 1].numpy(), bc_type="not-a-knot")
    np.testing.assert_allclose(out["w_grid"][0, 1].numpy(), cs(grid.numpy()), rtol=1e-12)
    np.testing.assert_allclose(out["iv_grid"][0, 1].numpy(),
                               np.sqrt(cs(grid.numpy()) / 0.5), rtol=1e-12)
    assert float(out["butterfly_margin"][0]) > 0 > float(out["butterfly_margin"][1])
    assert float(out["calendar_margin"][0]) > 0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159, 1e-30])
    r = spline.tf32(x)
    assert r[0] == 1.0
    assert r[1] == 1.0                       # a tie rounds to even
    assert r[2] == 1.0 + 4 * 2**-11          # a tie rounds to even, up
    rel = ((r - x).abs() / x.abs())[3:]
    assert bool((rel <= 2**-11).all())
    bits = r.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


def test_ring_keeps_newest_per_row():
    rows = np.array([0, 1, 0, 0, 1, 0, 2])
    kept = stream.ring_contents(rows, 3, 2)
    assert sorted(kept.tolist()) == [1, 3, 4, 5, 6]
    # arrival order within each row
    assert [i for i in kept if rows[i] == 0] == [3, 5]


def test_candles_by_hand():
    rows = np.array([0, 0, 0, 1, 0, 0])
    minute = np.array([2, 1, 2, 0, 1, 3])           # arrival order; minute 1 arrives late
    price = np.array([10, 11, 12, 50, 9, 13], np.float32)
    size = np.array([1, 2, 3, 4, 5, 6], np.float32)
    c1 = stream.candles_1m(rows, minute, price, size, 2, 4)
    assert c1["open"][0].tolist()[1:] == [11, 10, 13] and math.isnan(c1["open"][0, 0])
    assert c1["close"][0, 1] == 9 and c1["close"][0, 2] == 12
    assert c1["high"][0, 2] == 12 and c1["low"][0, 1] == 9
    assert c1["volume"][0].tolist() == [0, 7, 4, 6]
    assert c1["count"][0].tolist() == [0, 2, 2, 1] and c1["count"][1].tolist() == [1, 0, 0, 0]
    c5 = stream.candles_5m(c1, 2, 3, 2)
    assert c5["count"][0].tolist() == [1, 2, 0]
    assert c5["valid"][0].tolist() == [False, True, False]
    assert c5["open"][0, 1] == 10 and c5["close"][0, 1] == 13
    assert c5["high"][0, 1] == 13 and c5["low"][0, 1] == 10 and c5["volume"][0, 1] == 10
    assert math.isnan(c5["open"][0, 2]) and c5["volume"][0, 2] == 0


def test_realized_vol_and_refit_rule():
    close = np.array([[100.0, 101.0, np.nan, 102.0, 103.0]], np.float32)
    valid = np.array([[True, True, False, True, True]])
    rv, n = stream.realized_vol({"close": close, "valid": valid}, 5)
    lr = [math.log(101 / 100), math.log(103 / 102)]
    expect = math.sqrt(sum(v * v for v in lr) / 2 * stream.MINUTES_PER_YEAR / 5)
    assert n.tolist() == [2] and rv[0] == pytest.approx(expect, rel=1e-12)
    k = np.array([[[-0.1, 0.0, 0.1], [-0.2, 0.05, 0.2]]])
    iv = np.array([[[0.3, 0.25, 0.3], [0.4, 0.35, 0.4]]])
    out = stream.refit_vols(k, iv, np.array([0.5]), np.array([3]), 0.5, (0.25, 4.0))
    np.testing.assert_allclose(out[0, 0], iv[0, 0] * (1 + 0.5 * (0.5 / 0.25 - 1)))
    np.testing.assert_allclose(out[0, 1], iv[0, 1] * (1 + 0.5 * (0.5 / 0.35 - 1)))
    same = stream.refit_vols(k, iv, np.array([0.0]), np.array([0]), 0.5, (0.25, 4.0))
    np.testing.assert_array_equal(same, iv)
