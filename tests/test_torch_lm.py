"""Port parity: the batched Levenberg-Marquardt engine (``ops/lm.py``)
against the JAX package's on the same seeded problems, float64.

One LM step from the same state: every state field <= 1e-10. A full fit:
params <= 1e-7, cost <= 1e-9 relative (plus 1e-18 absolute: the cost of an
exact fit is a sum of squared roundings), ``n_accepted`` and ``converged``
equal. A problem whose normal equations are not positive definite (a NaN
residual row) rejects its steps and keeps its start while the rest of the
batch converges. ``robustify`` <= 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import least_squares

from iv_interpolation_tpu.ops import lm as ref
from iv_interpolation_tpu_torch.ops import lm as port


def _resid_jx(p, t_, y_):
    return p[0] * jnp.exp(-p[1] * t_) + p[2] - y_


def _resid_pt(p, t_, y_):
    return p[0] * torch.exp(-p[1] * t_) + p[2] - y_


def _problems(rng, B=8, n=30, noise=0.0):
    t = np.broadcast_to(np.linspace(0, 2, n), (B, n)).copy()
    trues = rng.uniform(0.5, 2.0, (B, 3))
    ys = trues[:, :1] * np.exp(-trues[:, 1:2] * t) + trues[:, 2:3]
    return t, ys + noise * rng.normal(size=ys.shape), trues


def _assert_same_result(got, want, p_tol, cost_rtol):
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=0, atol=p_tol)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=cost_rtol, atol=1e-18)
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    assert got.n_accepted.dtype == torch.int32 and got.converged.dtype == torch.bool


def test_lm_exponential_fit_matches_scipy_and_jax():
    t = np.linspace(0, 3, 40)
    true = np.array([2.5, 1.3, 0.4])
    y = true[0] * np.exp(-true[1] * t) + true[2]
    p0 = np.array([1.0, 1.0, 0.0])
    sp = least_squares(lambda p: p[0] * np.exp(-p[1] * t) + p[2] - y, p0, method="lm")
    got = port.levenberg_marquardt(_resid_pt, torch.from_numpy(p0), torch.from_numpy(t),
                                   torch.from_numpy(y), max_iters=100)
    want = ref.levenberg_marquardt(_resid_jx, jnp.array(p0), jnp.array(t), jnp.array(y),
                                   max_iters=100)
    np.testing.assert_allclose(got.params.numpy(), sp.x, atol=1e-8)
    assert float(got.cost) < 1e-16 and got.params.shape == (3,) and got.cost.shape == ()
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=0, atol=1e-7)
    assert int(got.n_accepted) == int(want.n_accepted)
    assert bool(got.converged) == bool(want.converged)


def test_lm_respects_bounds():
    def resid(p, x):
        return p - x  # optimum at p = x

    got = port.levenberg_marquardt(resid, torch.zeros(2, dtype=torch.float64),
                                   torch.tensor([5.0, -5.0], dtype=torch.float64),
                                   lower=np.array([-1.0, -1.0]),
                                   upper=torch.tensor([1.0, 1.0]), max_iters=50)
    want = ref.levenberg_marquardt(lambda p, x: p - x, jnp.zeros(2), jnp.array([5.0, -5.0]),
                                   lower=jnp.array([-1.0, -1.0]),
                                   upper=jnp.array([1.0, 1.0]), max_iters=50)
    np.testing.assert_allclose(got.params.numpy(), [1.0, -1.0], atol=1e-10)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), atol=1e-10)
    assert int(got.n_accepted) == int(want.n_accepted)


@pytest.mark.parametrize("lambda0", [1e-3, 1.0])
def test_one_step_from_the_same_state_matches_jax(rng, lambda0):
    """max_iters=1 exposes one iteration's state: every field <= 1e-10."""
    t, ys, _ = _problems(rng, noise=1e-3)
    p0 = rng.uniform(0.5, 1.5, (t.shape[0], 3))
    got = port.levenberg_marquardt_batched(
        _resid_pt, *map(torch.from_numpy, (p0, t, ys)), max_iters=1, lambda0=lambda0)
    want = ref.levenberg_marquardt_batched(
        _resid_jx, *map(jnp.asarray, (p0, t, ys)), max_iters=1, lambda0=lambda0)
    _assert_same_result(got, want, p_tol=1e-10, cost_rtol=1e-10)
    assert got.n_accepted.numpy().sum() > 0


@pytest.mark.parametrize("noise,iters", [(0.0, 100), (1e-3, 32), (1e-2, 8)])
def test_full_batched_fit_matches_jax(rng, noise, iters):
    t, ys, trues = _problems(rng, B=16, noise=noise)
    p0 = np.ones((16, 3))
    got = port.levenberg_marquardt_batched(
        _resid_pt, *map(torch.from_numpy, (p0, t, ys)), max_iters=iters)
    want = ref.levenberg_marquardt_batched(
        _resid_jx, *map(jnp.asarray, (p0, t, ys)), max_iters=iters)
    _assert_same_result(got, want, p_tol=1e-7, cost_rtol=1e-9)
    if noise == 0.0:
        np.testing.assert_allclose(got.params.numpy(), trues, atol=1e-6)


def test_bounded_batched_fit_matches_jax(rng):
    """Bounds active on most problems. 10 iterations: one problem then
    stagnates against its bounds with cost decreases of ~1e-12, where the
    convergence test ``cost - cost_new < tol * cost`` falls inside the
    rounding of the two packages' sums and may latch in one and not the
    other."""
    t, ys, _ = _problems(rng, B=6, noise=1e-3)
    lo, hi = np.array([0.0, 0.8, 0.0]), np.array([1.5, 1.6, 1.2])
    p0 = np.ones((6, 3))
    got = port.levenberg_marquardt_batched(
        _resid_pt, *map(torch.from_numpy, (p0, t, ys)), max_iters=10, lower=lo, upper=hi)
    want = ref.levenberg_marquardt_batched(
        _resid_jx, *map(jnp.asarray, (p0, t, ys)), max_iters=10,
        lower=jnp.asarray(lo), upper=jnp.asarray(hi))
    _assert_same_result(got, want, p_tol=1e-7, cost_rtol=1e-9)
    p = got.params.numpy()
    assert (p >= lo - 1e-15).all() and (p <= hi + 1e-15).all()
    assert (p == lo).any() or (p == hi).any()      # a bound is active


def test_indefinite_system_rejects_that_problem_only(rng):
    """A NaN in one problem's data makes its J^T J non-finite: Cholesky
    fails for that problem alone. It must not raise; that problem rejects
    every step and keeps its start; the others converge as if alone."""
    t, ys, trues = _problems(rng, B=5)
    bad = ys.copy()
    bad[2, 7] = np.nan
    p0 = np.ones((5, 3))
    got = port.levenberg_marquardt_batched(
        _resid_pt, *map(torch.from_numpy, (p0, t, bad)), max_iters=100)
    alone = port.levenberg_marquardt_batched(
        _resid_pt, *map(torch.from_numpy, (p0, t, ys)), max_iters=100)
    others = [0, 1, 3, 4]
    np.testing.assert_array_equal(got.params.numpy()[2], p0[2])
    assert int(got.n_accepted[2]) == 0 and not bool(got.converged[2])
    assert np.isnan(got.cost.numpy()[2])
    np.testing.assert_array_equal(got.params.numpy()[others], alone.params.numpy()[others])
    np.testing.assert_allclose(got.params.numpy()[others], trues[others], atol=1e-6)
    assert got.converged.numpy()[others].all()
    # the reference takes the same path (its Cholesky returns NaN)
    want = ref.levenberg_marquardt_batched(
        _resid_jx, *map(jnp.asarray, (p0, t, bad)), max_iters=100)
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))


def test_solve_spd_marks_only_the_indefinite_matrix(rng):
    M = rng.normal(size=(4, 3, 3))
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(3)
    A[1] = -A[1]                       # negative definite
    A[3, 0, 0] = np.nan
    b = rng.normal(size=(4, 3))
    x = port.solve_spd(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.isnan(x[1]).all() and np.isnan(x[3]).all()
    for i in (0, 2):
        np.testing.assert_allclose(x[i], np.linalg.solve(A[i], b[i]), rtol=1e-10)


def test_the_loop_never_reads_a_tensor_on_the_host(rng, monkeypatch):
    """No ``.item()``, ``bool(tensor)``, ``.tolist()`` or ``.cpu()`` inside
    a fit: the loop is a fixed straight-line program."""
    t, ys, _ = _problems(rng, B=3)

    def refuse(*a, **k):
        raise AssertionError("host read inside the LM loop")

    for name in ("item", "__bool__", "tolist", "cpu", "numpy", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = port.levenberg_marquardt_batched(
        _resid_pt, *map(torch.from_numpy, (np.ones((3, 3)), t, ys)), max_iters=5)
    monkeypatch.undo()
    assert np.isfinite(got.params.numpy()).all()


@pytest.mark.parametrize("delta", [1e-3, 0.5])
def test_robustify_matches_jax(rng, delta):
    scale = np.array([1e-6, -3e-6, 2e-7, 4e-2, -3.0])
    p = rng.normal(size=5)
    got = port.robustify(lambda q: q * torch.from_numpy(scale), delta)(torch.from_numpy(p))
    want = ref.robustify(lambda q: q * jnp.asarray(scale), delta)(jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)
    # quadratic regime below the scale; smooth at zero under jacfwd
    f = port.robustify(lambda q: q * torch.from_numpy(scale[:3]), 1e-3)
    J = torch.func.jacfwd(f)(torch.zeros((), dtype=torch.float64)).numpy()
    Jr = np.asarray(jax.jacfwd(ref.robustify(lambda q: q * jnp.asarray(scale[:3]), 1e-3))(
        jnp.asarray(0.0)))
    np.testing.assert_allclose(J, Jr, rtol=1e-12)
    np.testing.assert_allclose(J, scale[:3], rtol=1e-5)
