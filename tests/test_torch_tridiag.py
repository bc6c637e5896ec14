"""Port parity: the batched tridiagonal solve (kernel B1's wrapper, CPU
plain version) against the JAX package's Thomas scan and its Pallas
kernel in interpret mode.

Tolerances: float64 results agree to 1e-12 (the same Thomas recurrence,
rounding differences only). float32 results agree to 64 ulps of the
largest |x| (diagonally dominant systems: Thomas is backward stable and
the error of a 50-step sweep stays within a few ulps per step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops.pallas.tridiag_pallas import tridiag_solve_pallas
from iv_interpolation_tpu.ops.tridiag import tridiag_matvec as jax_matvec
from iv_interpolation_tpu.ops.tridiag import tridiag_solve as jax_solve
from iv_interpolation_tpu_torch.ops.cuda.tridiag import (
    thomas_plan,
    tridiag_solve_cuda,
    tridiag_solve_plain,
)
from iv_interpolation_tpu_torch.ops.tridiag import tridiag_matvec, tridiag_solve


def _systems(rng, shape, dtype):
    d = rng.uniform(4.0, 6.0, shape).astype(dtype)
    dl = rng.uniform(-1.0, 1.0, shape).astype(dtype)
    du = rng.uniform(-1.0, 1.0, shape).astype(dtype)
    b = rng.normal(size=shape).astype(dtype)
    return dl, d, du, b


def _tol(dtype, ref):
    if dtype == np.float64:
        return 1e-12
    return 64 * np.finfo(np.float32).eps * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(50, 64), (7, 3), (48, 1000), (2, 5),
                                   (1, 4), (20, 6, 9)])
def test_solve_matches_jax_scan_and_pallas(rng, shape, dtype):
    arrays = _systems(rng, shape, dtype)
    got = tridiag_solve(*map(torch.from_numpy, arrays)).numpy()
    ref_scan = np.asarray(jax_solve(*map(jnp.asarray, arrays)))
    ref_pallas = np.asarray(tridiag_solve_pallas(*map(jnp.asarray, arrays),
                                                 interpret=True))
    assert got.dtype == dtype and got.shape == shape
    np.testing.assert_allclose(got, ref_scan, rtol=0, atol=_tol(dtype, ref_scan))
    np.testing.assert_allclose(got, ref_pallas, rtol=0,
                               atol=_tol(dtype, ref_pallas))


def test_solve_n1_is_b_over_d_and_ignores_off_ends(rng):
    dl, d, du, b = _systems(rng, (1, 8), np.float64)
    got = tridiag_solve(*map(torch.from_numpy, (dl, d, du, b))).numpy()
    np.testing.assert_array_equal(got, b / d)
    # dl[0] and du[n-1] are outside the matrix and never read
    dl, d, du, b = _systems(rng, (9, 8), np.float64)
    clean = tridiag_solve(*map(torch.from_numpy, (dl, d, du, b))).numpy()
    dl[0] = np.nan
    du[-1] = np.nan
    dirty = tridiag_solve(*map(torch.from_numpy, (dl, d, du, b))).numpy()
    np.testing.assert_array_equal(clean, dirty)


def test_matvec_matches_jax_and_inverts_solve(rng):
    dl, d, du, x = _systems(rng, (11, 5), np.float64)
    got = tridiag_matvec(*map(torch.from_numpy, (dl, d, du, x))).numpy()
    ref = np.asarray(jax_matvec(*map(jnp.asarray, (dl, d, du, x))))
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=1e-15)
    dl[0], du[-1] = 0.0, 0.0
    t = list(map(torch.from_numpy, (dl, d, du)))
    back = tridiag_solve(*t, tridiag_matvec(*t, torch.from_numpy(x)))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-12)


def test_wrapper_rejects_what_the_kernel_cannot_take(rng):
    dl, d, du, b = (torch.from_numpy(a) for a in _systems(rng, (6, 4), np.float64))
    with pytest.raises(TypeError):
        tridiag_solve_cuda(dl.float(), d, du, b)             # mixed dtypes
    with pytest.raises(TypeError):
        tridiag_solve_cuda(*(a.to(torch.int32) for a in (dl, d, du, b)))
    with pytest.raises(ValueError):
        tridiag_solve_cuda(dl[:, :3], d, du, b)              # shape mismatch
    with pytest.raises(ValueError):
        tridiag_solve_cuda(dl.T, d.T, du.T, b.T)             # not contiguous
    with pytest.raises(ValueError):
        tridiag_solve_cuda(*(a.reshape(-1) for a in (dl, d, du, b)))  # not 2-D
    with pytest.raises(ValueError):
        tridiag_solve_cuda(*(a.to("meta") for a in (dl, d, du, b)))  # no kernel
    with pytest.raises(ValueError):
        tridiag_solve(dl, d, du, b[:, :2])


def test_cpu_tensors_take_the_plain_version_without_a_launch(rng):
    arrays = [torch.from_numpy(a) for a in _systems(rng, (12, 7), np.float32)]
    before = tridiag_solve_cuda.launches
    got = tridiag_solve_cuda(*arrays)
    assert tridiag_solve_cuda.launches == before
    torch.testing.assert_close(got, tridiag_solve_plain(*arrays), rtol=0, atol=0)


# The launch plan: (route, systems a block) for n in float32 and float64.
# The staged route holds 4 n S sizeof(T) bytes a block: S is the largest
# of 128/64/32 that lets two blocks share an SM (<= 113 KiB each), else 32
# alone while it fits in 200 KiB, else the global-scratch route.
PLANS = {
    (1, torch.float32): ("staged", 128), (1, torch.float64): ("staged", 128),
    (2, torch.float32): ("staged", 128), (2, torch.float64): ("staged", 128),
    (48, torch.float32): ("staged", 128), (48, torch.float64): ("staged", 64),
    (50, torch.float32): ("staged", 128), (50, torch.float64): ("staged", 64),
    (166, torch.float32): ("staged", 32), (166, torch.float64): ("staged", 32),
    (257, torch.float32): ("staged", 32), (257, torch.float64): ("scratch", 256),
    (1000, torch.float32): ("scratch", 256), (1000, torch.float64): ("scratch", 256),
}


@pytest.mark.parametrize("n,dtype", sorted(PLANS, key=str))
def test_launch_plan_by_shape(n, dtype):
    plan = thomas_plan(n, dtype)
    assert (plan.route, plan.threads) == PLANS[n, dtype]
    size = dtype.itemsize
    assert plan.smem <= 227 * 1024
    if plan.route == "staged":
        assert plan.smem == 4 * n * plan.threads * size
    # the scratch route exactly where even 32 systems' tiles do not fit
    assert (plan.route == "scratch") == (4 * n * 32 * size > 200 * 1024)


def test_launch_plan_route_boundaries():
    assert thomas_plan(400, torch.float32).route == "staged"
    assert thomas_plan(401, torch.float32).route == "scratch"
    assert thomas_plan(200, torch.float64).route == "staged"
    assert thomas_plan(201, torch.float64).route == "scratch"
    with pytest.raises(ValueError):
        thomas_plan(0, torch.float32)
