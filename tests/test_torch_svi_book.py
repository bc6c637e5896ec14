"""The raw-SVI surface book (``fit_eval_surface(method="svi")``) against the
benchmark's plain float64 reference (``benchmark/reference/svi.py``), on
seeded quotes from the benchmark's own generator: 8 surfaces x 6 expiries
x 12 strikes, each expiry its own strikes, with the book's traffic
parameters (noise, adversarial wiggles).

Tolerances and their reasons:
  * float64 port against the float64 reference, fitted parameters within
    1e-8 and w on the grid within 1e-10 of the slice's largest w: both run
    the same 50-iteration schedule from the same start, but the Jacobian
    (forward mode against the closed form) and the 5 x 5 solve (LAPACK's
    Cholesky against an elementwise one) round differently, and along SVI's
    flat valleys the normal equations magnify a rounding by their
    condition (the gap reads about 1e-11 on 1,920 slices of the book);
  * float32 port: the cell's own limits (``benchmark/limits``), which the
    benchmark holds the card's run to;
  * the replay of the port's own parameters: float64 evaluation of the same
    formula, w within 1e-12 of the slice's largest w and every flag equal
    (float64 port), or within the cell's float32 limits (float32 port);
  * the closed-form Jacobian against central differences with step 1e-6:
    the differences' truncation error, about 1e-10 of the derivative's
    size.
"""

import json

import pytest
import torch

from benchmark import compare, generators, harness
from benchmark.drivers.closed_loop_calibration import surface_numbers
from benchmark.reference import svi
from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface

CELL = "surface_svi_30x50.own_strikes"
TRAFFIC = json.loads((harness.HERE / "traffic" / f"{CELL}.json").read_text())
LIMITS = json.loads((harness.HERE / "limits" / f"{CELL}.json").read_text())
B, E, N, GRID, ITERS = 8, 6, 12, 20, 50
SEEDS = [2**33 + 7, 4000000017]


def _book(seed: int) -> tuple:
    x = generators.surface_batch(seed, 0, B, E, N, TRAFFIC, "cpu")
    return x["k"], x["iv"], x["T"]


def _port(k, iv, T, dtype, iters=ITERS) -> dict:
    return fit_eval_surface(k.to(dtype), iv.to(dtype), T.to(dtype), method="svi",
                            n_grid=GRID, svi_iters=iters)


def _tols(dtype) -> tuple:
    """The port's flag tolerances in ``dtype`` (``arbitrage_flags``)."""
    eps = torch.finfo(dtype).eps
    return max(1024.0 * eps, 1e-10), max(1024.0 * eps, 1e-12)


def _scaled_gap(a, b) -> float:
    scale = b.abs().amax(dim=-1, keepdim=True)
    return float(((a - b).abs() / scale).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_float64_port_matches_the_reference_calibration(seed):
    k, iv, T = (a.double() for a in _book(seed))
    out = _port(k, iv, T, torch.float64)
    coefs, cost = svi.calibrate(k, iv, T, ITERS)
    ref = svi.surface(coefs, k, iv, T, GRID, *_tols(torch.float64))
    assert float((out["fit"].coefs - coefs).abs().max()) < 1e-8
    assert _scaled_gap(out["w_grid"], ref["w_grid"]) < 1e-10
    assert torch.equal(out["butterfly_ok"], ref["butterfly_margin"] >= 0)
    assert torch.equal(out["calendar_ok"], ref["calendar_margin"] >= 0)
    torch.testing.assert_close(out["fit_rmse"], ref["fit_rmse"], rtol=1e-8, atol=0)
    # the reference's own cost is the one its parameters give
    torch.testing.assert_close(svi.cost(coefs, k, iv * iv * T[..., None]), cost,
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_port_meets_the_cells_limits(seed):
    k, iv, T = _book(seed)
    out = _port(k, iv, T, torch.float32)
    k6, iv6, T6 = k.double(), iv.double(), T.double()
    ref = svi.surface(out["fit"].coefs.double(), k6, iv6, T6, GRID, *_tols(torch.float32))
    numbers = surface_numbers({name: out[name] for name in
                               ("w_grid", "iv_grid", "butterfly_ok", "calendar_ok", "fit_rmse")},
                              ref, LIMITS)
    _, best = svi.calibrate(k6, iv6, T6, ITERS)
    worse = ~(ref["cost"] <= best * (1.0 + LIMITS["worse_fit_rel"]) + LIMITS["worse_fit_floor"])
    numbers["worse_fit_share"] = float(worse.double().mean())
    correct, _ = compare.judge(numbers, LIMITS["numbers"])
    assert correct, numbers


def test_half_the_iterations_fits_worse_than_the_limit():
    """The cell's control (b) at this size: the port at 25 of its 50
    iterations leaves more slices worse than the reference than the limit
    admits."""
    k, iv, T = _book(SEEDS[0])
    out = _port(k, iv, T, torch.float32, iters=ITERS // 2)
    k6, iv6, T6 = k.double(), iv.double(), T.double()
    cost = svi.cost(out["fit"].coefs.double(), k6, iv6 * iv6 * T6[..., None])
    _, best = svi.calibrate(k6, iv6, T6, ITERS)
    worse = ~(cost <= best * (1.0 + LIMITS["worse_fit_rel"]) + LIMITS["worse_fit_floor"])
    assert float(worse.double().mean()) > LIMITS["numbers"]["worse_fit_share"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_replay_reproduces_the_programs_own_grid_and_flags(dtype):
    k, iv, T = _book(SEEDS[1])
    out = _port(k, iv, T, dtype)
    ref = svi.surface(out["fit"].coefs.double(), k.double(), iv.double(), T.double(), GRID,
                      *_tols(dtype))
    if dtype == torch.float64:
        assert _scaled_gap(out["w_grid"], ref["w_grid"]) < 1e-12
        assert torch.equal(out["butterfly_ok"], ref["butterfly_margin"] >= 0)
        assert torch.equal(out["calendar_ok"], ref["calendar_margin"] >= 0)
    else:
        part = surface_numbers({name: out[name] for name in
                                ("w_grid", "iv_grid", "butterfly_ok", "calendar_ok", "fit_rmse")},
                               ref, LIMITS)
        limits = LIMITS["numbers"]
        assert part["w_rel_gap"] <= limits["w_rel_gap"], part
        assert part["iv_rel_gap"] <= limits["iv_rel_gap"], part
        assert part["flag_mismatches"] == 0 and part["fit_rmse_rel_gap"] <= limits[
            "fit_rmse_rel_gap"], part


PARAMS = [(0.04, 0.4, -0.4, 0.05, 0.3), (-0.02, 0.15, 0.6, -0.1, 0.05),
          (0.2, 1.5, -0.95, 0.3, 0.8)]


@pytest.mark.parametrize("p", PARAMS)
def test_closed_form_jacobian_matches_central_differences(p):
    p = torch.tensor(p, dtype=torch.float64)
    k = torch.linspace(-1.2, 1.2, 31, dtype=torch.float64)
    J = svi.jacobian(p, k)
    h = 1e-6
    for i in range(5):
        step = torch.zeros(5, dtype=torch.float64)
        step[i] = h
        fd = (svi.total_variance(p + step, k) - svi.total_variance(p - step, k)) / (2 * h)
        torch.testing.assert_close(J[:, i], fd, rtol=0, atol=1e-8 * max(1.0, float(fd.abs().max())))


@pytest.mark.parametrize("p", PARAMS)
def test_closed_form_strike_derivatives_match_central_differences(p):
    p = torch.tensor(p, dtype=torch.float64)
    k = torch.linspace(-1.2, 1.2, 31, dtype=torch.float64)
    w, w1, w2 = svi.derivatives(p, k)
    h = 1e-5
    up, down = svi.total_variance(p, k + h), svi.total_variance(p, k - h)
    torch.testing.assert_close(w, svi.total_variance(p, k), rtol=0, atol=0)
    torch.testing.assert_close(w1, (up - down) / (2 * h), rtol=0, atol=1e-8)
    torch.testing.assert_close(w2, (up - 2 * w + down) / (h * h), rtol=0, atol=1e-4)
