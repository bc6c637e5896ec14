"""The joint eSSVI surface book (``fit_eval_surface(method="essvi")``) against
the benchmark's plain float64 reference (``benchmark/reference/essvi.py``),
on seeded quotes from the benchmark's own generator: 8 surfaces x 30
expiries x 50 strikes, each expiry its own strikes, with the book's traffic
parameters (noise, adversarial wiggles), at 8 Levenberg-Marquardt
iterations.

Tolerances and their reasons:
  * float64 port against the float64 reference, fitted parameters within
    1e-10 and w on the grid within 1e-12 of the slice's largest w: both run
    the same schedule from the same start, but the slice Jacobian (forward
    mode against the closed form) and the step (a block Thomas loop with
    closed-form 3 x 3 inverses against a dense LU) round differently; the
    gap reads about 2e-15 on these books;
  * float32 port: the cell's own limits (``benchmark/limits``), which the
    benchmark holds the card's run to, and no slice that breaks the
    structural guarantees;
  * the closed-form derivatives against central differences: the
    differences' truncation error, about 1e-10 (first) and 1e-6 (second) of
    the derivative's size;
  * the dense solve against the port's block Thomas loop on random
    symmetric positive definite block-tridiagonal systems: 1e-9 of the
    solution's size, the two eliminations' float64 rounding magnified by
    the systems' condition (about 1e4).

The book's size repaired one thing: at 32,768 surfaces the block Thomas
loop is about 1,500 launches an iteration of (32,768, 3, 3) blocks, each
a few microseconds of device time, and the host's pace in launching them
set the pace of the call (on an NVIDIA H100 80GB HBM3 at 700 W, 3.40-3.46 s
a call in one process, against 3.29 s and 0.5 % steady once each 3 x 3
inverse took seven launches in place of about forty). The operation
counts are held here.
"""

import torch_threads  # noqa: F401

import json

import pytest
import torch

from benchmark import compare, generators, harness
from benchmark.drivers.closed_loop_calibration import surface_numbers
from benchmark.reference import essvi
from torch.utils._python_dispatch import TorchDispatchMode

from iv_interpolation_tpu_torch.ops.essvi import _block_thomas, _inv3x3
from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface

CELL = "surface_essvi_30x50.own_strikes"
TRAFFIC = json.loads((harness.HERE / "traffic" / f"{CELL}.json").read_text())
LIMITS = json.loads((harness.HERE / "limits" / f"{CELL}.json").read_text())
CONFIG = json.loads((harness.ROOT / "benchmark" / "configs" / "surface_essvi_30x50.json").read_text())
B, E, N, GRID, ITERS = 8, 30, 50, 50, 8
CW, M = CONFIG["calendar_weight"], CONFIG["n_penalty_grid"]
SEEDS = [2**33 + 7, 4000000017]


def _book(seed: int) -> tuple:
    x = generators.surface_batch(seed, 0, B, E, N, TRAFFIC, "cpu")
    return x["k"], x["iv"], x["T"]


def _port(k, iv, T, dtype) -> dict:
    return fit_eval_surface(k.to(dtype), iv.to(dtype), T.to(dtype), method="essvi",
                            n_grid=GRID, svi_iters=ITERS)


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
    coefs, cost = essvi.calibrate(k, iv, T, ITERS, CW, M)
    ref = essvi.surface(coefs, k, iv, T, GRID, *_tols(torch.float64), CW, M)
    assert float((out["fit"].coefs - coefs).abs().max()) < 1e-10
    assert _scaled_gap(out["w_grid"], ref["w_grid"]) < 1e-12
    assert torch.equal(out["butterfly_ok"], ref["butterfly_margin"] >= 0)
    assert torch.equal(out["calendar_ok"], ref["calendar_margin"] >= 0)
    torch.testing.assert_close(out["fit_rmse"], ref["fit_rmse"], rtol=1e-10, atol=0)
    # the reference's own cost is the one its parameters give
    torch.testing.assert_close(ref["cost"], cost, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_port_meets_the_cells_limits(seed):
    """The cell's judgement at this size: the replay of the program's own
    parameters, the structural guarantees, and the calibration against the
    reference's from the same start."""
    k, iv, T = _book(seed)
    out = _port(k, iv, T, torch.float32)
    k6, iv6, T6 = k.double(), iv.double(), T.double()
    ref = essvi.surface(out["fit"].coefs.double(), k6, iv6, T6, GRID, *_tols(torch.float32),
                        CW, M)
    numbers = surface_numbers({name: out[name] for name in
                               ("w_grid", "iv_grid", "butterfly_ok", "calendar_ok", "fit_rmse")},
                              ref, LIMITS)
    numbers["structure_violations"] = essvi.structure_violations(out["fit"].coefs)
    _, best = essvi.calibrate(k6, iv6, T6, ITERS, CW, M)
    worse = ~(ref["cost"] <= best * (1.0 + LIMITS["worse_fit_rel"]) + LIMITS["worse_fit_floor"])
    numbers["worse_fit_share"] = float(worse.double().mean())
    assert numbers["structure_violations"] == 0
    correct, _ = compare.judge(numbers, LIMITS["numbers"])
    assert correct, numbers


def test_a_fit_stopped_after_one_iteration_fits_worse_than_the_limit():
    """The fit cut short: one Levenberg-Marquardt iteration leaves more
    surfaces worse than the reference's calibration than the limit admits."""
    k, iv, T = _book(SEEDS[0])
    out = fit_eval_surface(k, iv, T, method="essvi", n_grid=GRID, svi_iters=1)
    k6, iv6, T6 = k.double(), iv.double(), T.double()
    cost = essvi.surface(out["fit"].coefs.double(), k6, iv6, T6, GRID, *_tols(torch.float32),
                         CW, M)["cost"]
    _, best = essvi.calibrate(k6, iv6, T6, ITERS, CW, M)
    worse = ~(cost <= best * (1.0 + LIMITS["worse_fit_rel"]) + LIMITS["worse_fit_floor"])
    assert float(worse.double().mean()) > LIMITS["numbers"]["worse_fit_share"]


PARAMS = [(0.04, -0.4, 0.8), (0.3, 0.6, 0.2), (0.02, -0.7, 0.6), (0.5, 0.0, 0.05)]


@pytest.mark.parametrize("p", PARAMS)
def test_closed_form_jacobian_matches_central_differences(p):
    p = torch.tensor(p, dtype=torch.float64)
    k = torch.linspace(-1.2, 1.2, 31, dtype=torch.float64)
    J = essvi.jacobian(p, k)
    h = 1e-6
    for i in range(3):
        step = torch.zeros(3, dtype=torch.float64)
        step[i] = h
        fd = (essvi.total_variance(p + step, k) - essvi.total_variance(p - step, k)) / (2 * h)
        torch.testing.assert_close(J[:, i], fd, rtol=0, atol=1e-8 * max(1.0, float(fd.abs().max())))


@pytest.mark.parametrize("p", PARAMS)
def test_closed_form_strike_derivatives_match_central_differences(p):
    p = torch.tensor(p, dtype=torch.float64)
    k = torch.linspace(-1.2, 1.2, 31, dtype=torch.float64)
    w, w1, w2 = essvi.derivatives(p, k)
    h = 1e-5
    up, down = essvi.total_variance(p, k + h), essvi.total_variance(p, k - h)
    torch.testing.assert_close(w, essvi.total_variance(p, k), rtol=0, atol=0)
    torch.testing.assert_close(w1, (up - down) / (2 * h), rtol=0, atol=1e-8)
    scale = max(1.0, float(w2.abs().max()))
    torch.testing.assert_close(w2, (up - 2 * w + down) / (h * h), rtol=0, atol=1e-4 * scale)


def test_pullback_inverts_the_transform_tangent():
    """The reference's inverse tangent map takes the transform's tangent of
    a z-space step back to that step."""
    g = torch.Generator().manual_seed(11)
    Ez = 6
    z = torch.randn(4, 3 * Ez, generator=g, dtype=torch.float64)
    dz = torch.randn(4, 3 * Ez, generator=g, dtype=torch.float64)
    _, step = torch.func.jvp(lambda zz: essvi.transform(zz, Ez), (z,), (dz,))
    torch.testing.assert_close(essvi.pullback(z, step, Ez), dz, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("E_", [2, 7, 30])
def test_dense_solve_matches_the_block_thomas_loop(E_):
    """Random symmetric positive definite block-tridiagonal systems, the
    normal matrices of random slice-banded Jacobians plus a damping: the
    reference's dense assembly and solve against the port's loop."""
    g = torch.Generator().manual_seed(E_)
    S, rows = 5, 4
    own = torch.randn(S, E_, rows, 3, generator=g, dtype=torch.float64)
    lo = torch.randn(S, E_ - 1, rows, 3, generator=g, dtype=torch.float64)
    hi = torch.randn(S, E_ - 1, rows, 3, generator=g, dtype=torch.float64)
    D = own.mT @ own + 1e-3 * torch.eye(3, dtype=torch.float64)
    D[:, :-1] += lo.mT @ lo
    D[:, 1:] += hi.mT @ hi
    U = lo.mT @ hi
    b = torch.randn(S, E_, 3, generator=g, dtype=torch.float64)
    A = essvi.dense(D, U)
    torch.testing.assert_close(A, A.mT, rtol=0, atol=0)
    assert bool((torch.linalg.eigvalsh(A) > 0).all())
    x = essvi.solve(A, b.reshape(S, 3 * E_)).reshape(S, E_, 3)
    scale = float(x.abs().max())
    torch.testing.assert_close(_block_thomas(D, U, b), x, rtol=0, atol=1e-9 * scale)


def test_structure_violations_counts_each_broken_slice():
    theta = torch.tensor([[0.01, 0.02, 0.03, 0.04, 0.05, 0.06]], dtype=torch.float64)
    rho = torch.tensor([[-0.5, 0.2, 0.0, 0.3, 0.1, -0.2]], dtype=torch.float64)
    psi = 0.5 * essvi.cap(theta, rho)
    p = torch.stack([theta, rho, psi], dim=-1)
    assert essvi.structure_violations(p) == 0
    assert essvi.structure_violations(p.float()) == 0
    bad = p.clone()
    bad[0, 2, 0] = 0.015          # theta below the previous expiry's
    bad[0, 3, 1] = 1.0            # |rho| not below 1
    bad[0, 4, 2] = 1.01 * essvi.cap(theta[0, 4], rho[0, 4])  # psi above the cap
    bad[0, 5, 2] = float("nan")
    assert essvi.structure_violations(bad) == 4


class _Operations(TorchDispatchMode):
    """Counts the tensor operations dispatched inside it, views aside: on
    the card each is a launch."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += not func.is_view
        return func(*args, **(kwargs or {}))


def test_the_block_thomas_loop_takes_a_few_operations_a_slice_step():
    g = torch.Generator().manual_seed(5)
    A = torch.randn(4, 3, 3, generator=g, dtype=torch.float64)
    with _Operations() as ops:
        inv = _inv3x3(A)
    assert ops.count <= 8
    torch.testing.assert_close(inv, torch.linalg.inv(A), rtol=1e-12, atol=1e-12)
    D = torch.randn(4, E, 3, 3, generator=g)
    U = torch.randn(4, E - 1, 3, 3, generator=g)
    b = torch.randn(4, E, 3, generator=g)
    with _Operations() as ops:
        _block_thomas(D, U, b)
    assert ops.count <= 24 * E
