"""The generators repeat from a seed, and draw the shapes and orders the
cells state."""

import numpy as np
import pytest
import torch

from benchmark import generators
from benchmark.tests.small import load_cell


def _traffic(name):
    return load_cell(name).traffic


@pytest.mark.parametrize("strikes", ["own", "common"])
def test_surface_batch_repeats_from_seed(strikes):
    p = dict(_traffic("surface_cubic_30x50.own_strikes"), strikes=strikes, grid_z=2.5)
    seed = 2**33 + 3
    a = generators.surface_batch(seed, 1, 16, 30, 50, p, "cpu")
    b = generators.surface_batch(seed, 1, 16, 30, 50, p, "cpu")
    c = generators.surface_batch(seed + 1, 1, 16, 30, 50, p, "cpu")
    d = generators.surface_batch(seed, 2, 16, 30, 50, p, "cpu")
    for key in ("k", "iv", "T"):
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["iv"], c["iv"])
    assert not torch.equal(a["iv"], d["iv"])
    k = a["k"].expand(16, 30, 50)
    T = a["T"].expand(16, 30)
    assert bool((k[..., 1:] > k[..., :-1]).all())
    assert bool((T[..., 1:] > T[..., :-1]).all())
    assert float(T.min()) >= 1.0 / 365 * (1 - 1e-6) and float(T.max()) <= 2.0 * (1 + 1e-6)
    assert bool((a["iv"] > 0).all())


def test_common_grid_shares_knots_across_slots():
    p = _traffic("surface_cubic_30x50.common_grid")
    a = generators.surface_batch(9, 0, 8, 30, 50, p, "cpu")
    b = generators.surface_batch(10, 5, 8, 30, 50, p, "cpu")
    assert a["k"].shape == (30, 50) and a["T"].shape == (30,)
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["T"], b["T"])


def test_adversarial_share_is_drawn():
    p = dict(_traffic("surface_cubic_30x50.own_strikes"), noise=0.0)
    iv = generators.surface_batch(4, 0, 2000, 4, 12, p, "cpu")["iv"]
    z = (iv[..., 2:] - 2 * iv[..., 1:-1] + iv[..., :-2]).abs().amax(dim=(-2, -1))
    share = float((z > 0.035).double().mean())
    assert 0.03 < share < 0.07


def test_tick_stream_repeats_and_keeps_arrival_order():
    p = _traffic("stream_refit_1k.steady")
    a = generators.tick_stream(2**32 + 1, 64, 30, p, "cpu")
    b = generators.tick_stream(2**32 + 1, 64, 30, p, "cpu")
    c = generators.tick_stream(2**32 + 2, 64, 30, p, "cpu")
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert len(a["price"]) != len(c["price"]) or not np.array_equal(a["price"], c["price"])
    assert np.all(np.diff(a["batch"]) >= 0)
    late = a["minute"] < a["batch"]
    assert np.all(a["batch"] - a["minute"] <= p["late_minutes"])
    assert 0.0 < late.mean() < 0.06
    # popularity: the first row is the busiest
    counts = np.bincount(a["underlying"], minlength=64)
    assert counts[0] == counts.max()
    assert a["price"].dtype == np.float32 and a["size"].dtype == np.float32
    assert np.all(a["size"] > 0) and np.all(a["price"] > 0)


def test_schedule_fixed_rate_and_bursts():
    due = generators.schedule(10, {"rate": 200.0})
    np.testing.assert_allclose(np.diff(due), 1 / 200.0)
    burst = generators.schedule(3000, {"rate": 100.0, "burst_factor": 3.0, "burst_every_s": 3.0,
                                      "burst_s": 1.0})
    assert np.all(np.diff(burst) > 0)
    # 300 batches in each burst second, 100 in each other second
    assert np.searchsorted(burst, 1.0) == pytest.approx(300, abs=1)
    assert np.searchsorted(burst, 3.0) == pytest.approx(500, abs=2)
    assert np.searchsorted(burst, 9.0) == pytest.approx(1500, abs=3)
