"""Port parity: the batched tridiagonal solve (kernel B1's wrapper, CPU
plain version) against the JAX package's Thomas scan and its Pallas
kernel in interpret mode.

Tolerances: float64 results agree to 1e-12 (the same Thomas recurrence,
rounding differences only). float32 results agree to 64 ulps of the
largest |x| (diagonally dominant systems: Thomas is backward stable and
the error of a 50-step sweep stays within a few ulps per step).
"""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops.pallas.tridiag_pallas import tridiag_solve_pallas
from iv_interpolation_tpu.ops.tridiag import tridiag_matvec as jax_matvec
from iv_interpolation_tpu.ops.tridiag import tridiag_solve as jax_solve
from iv_interpolation_tpu_torch.ops import tridiag as ops_tridiag
from iv_interpolation_tpu_torch.ops.cubic_spline import fit_cubic_spline
from iv_interpolation_tpu_torch.ops.cuda.tridiag import (
    LANES,
    LAYOUTS,
    batch_last_rows,
    partitioned_smem,
    thomas_plan,
    tridiag_solve_cuda,
    tridiag_solve_plain,
)
from iv_interpolation_tpu_torch.ops.tridiag import (
    tridiag_matvec,
    tridiag_solve,
    tridiag_solve_batch_last,
)


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
    with pytest.raises(ValueError):                          # neither layout
        tridiag_solve_cuda(*(torch.cat([a, a])[::2] for a in (dl, d, du, b)))
    with pytest.raises(ValueError):                          # mixed layouts
        tridiag_solve_cuda(dl.T.contiguous().T, d, du, b)
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


@pytest.mark.parametrize("n,dtype", [(719, np.float32), (257, np.float64)])
def test_cpu_tensors_on_partitioned_shapes_count_no_route(rng, n, dtype):
    """Shapes the card solves on the partitioned route: CPU tensors still
    take the plain Thomas loop, and no route counts a launch."""
    arrays = [torch.from_numpy(a) for a in _systems(rng, (n, 3), dtype)]
    assert thomas_plan(n, arrays[1].dtype, 3).route == "partitioned"
    before = dict(tridiag_solve_cuda.launches_by_route)
    assert set(before) == {"staged", "partitioned", "scratch"}
    got = tridiag_solve_cuda(*arrays)
    assert tridiag_solve_cuda.launches_by_route == before
    torch.testing.assert_close(got, tridiag_solve_plain(*arrays), rtol=0, atol=0)


# The launch plan: (route, threads a block) for n in float32 and float64
# at a batch that fills the card. The staged route holds 4 n S sizeof(T)
# bytes a block: S is the largest of 128/64/32 that lets two blocks share
# an SM (<= 113 KiB each), else 32 alone while it fits in 200 KiB. Beyond
# that the partitioned route (32 lanes a system, S = 16/8/4 systems a
# block), which takes every shape the global-scratch route took before.
PLANS = {
    (1, torch.float32): ("staged", 128), (1, torch.float64): ("staged", 128),
    (2, torch.float32): ("staged", 128), (2, torch.float64): ("staged", 128),
    (48, torch.float32): ("staged", 128), (48, torch.float64): ("staged", 64),
    (50, torch.float32): ("staged", 128), (50, torch.float64): ("staged", 64),
    (166, torch.float32): ("staged", 32), (166, torch.float64): ("staged", 32),
    (257, torch.float32): ("staged", 32), (257, torch.float64): ("partitioned", 256),
    (1000, torch.float32): ("partitioned", 128), (1000, torch.float64): ("partitioned", 128),
}


@pytest.mark.parametrize("n,dtype", sorted(PLANS, key=str))
def test_launch_plan_by_shape(n, dtype):
    plan = thomas_plan(n, dtype)
    assert (plan.route, plan.threads) == PLANS[n, dtype]
    size = dtype.itemsize
    assert plan.smem <= 227 * 1024
    if plan.route == "staged":
        assert plan.smem == 4 * n * plan.threads * size
        assert plan.systems == plan.threads
    else:
        assert plan.route == "partitioned" and plan.threads == LANES * plan.systems
        assert plan.smem == partitioned_smem(n, dtype, plan.systems) <= 200 * 1024
    # the staged route exactly where 32 systems' tiles fit, as before
    assert (plan.route == "staged") == (4 * n * 32 * size <= 200 * 1024)


def test_launch_plan_route_boundaries():
    assert thomas_plan(400, torch.float32).route == "staged"
    assert thomas_plan(401, torch.float32).route == "partitioned"
    assert thomas_plan(200, torch.float64).route == "staged"
    assert thomas_plan(201, torch.float64).route == "partitioned"
    with pytest.raises(ValueError):
        thomas_plan(0, torch.float32)


def test_launch_plan_scratch_only_beyond_four_systems_tiles():
    """The global-scratch route stays beyond the partitioned route's
    tiles: 4 systems of 32 segments of an odd stride in 200 KiB."""
    for dtype, last in ((torch.float32, 3167), (torch.float64, 1567)):
        for batch in (None, 48, 512, 8192):
            assert thomas_plan(last, dtype, batch).route == "partitioned"
            assert thomas_plan(last, dtype, batch).systems == 4
            assert thomas_plan(last + 1, dtype, batch).route == "scratch"
        assert partitioned_smem(last, dtype, 4) <= 200 * 1024 < partitioned_smem(last + 1, dtype, 4)


@pytest.mark.parametrize("batch", [None, 48, 96, 512, 768, 1024, 8192])
def test_launch_plan_partitions_the_old_scratch_shapes(batch):
    """Every (n, dtype) the scratch route took up to n = 1,000 now takes
    the partitioned route, at the paths' batches (a runner sub-batch, the
    cubic batch, AH's step and tangents); the staged route keeps every
    shape it took."""
    for dtype, first in ((torch.float32, 401), (torch.float64, 201)):
        for n in range(1, 1001):
            plan = thomas_plan(n, dtype, batch)
            assert plan.route == ("staged" if n < first else "partitioned"), (n, dtype)
            if plan.route == "staged":
                assert plan == thomas_plan(n, dtype)         # the batch does not matter
            else:
                assert plan.systems in (4, 8, 16)


@pytest.mark.parametrize("n,dtype,batch,systems", [
    (257, torch.float64, 512, 4), (257, torch.float64, 8192, 8),
    (719, torch.float32, 768, 8), (719, torch.float32, 8192, 8),
    (719, torch.float64, 768, 8), (650, torch.float32, 48, 4),
    (401, torch.float32, 1 << 20, 16), (500, torch.float32, 2048, 16)])
def test_launch_plan_systems_a_block_by_batch(n, dtype, batch, systems):
    """S is the smallest of 4/8/16 whose blocks number at most 132 (one
    an SM), else the largest whose blocks pair on an SM, else 4."""
    plan = thomas_plan(n, dtype, batch)
    assert (plan.route, plan.systems) == ("partitioned", systems)


# -- batch-last systems ---------------------------------------------------------
# B1 reads (n, batch) arrays that are the transposes of row-major (batch, n)
# ones as they lie. On CPU tensors the plain loop walks them in place: the
# same operations on the same values, so x is bit for bit the row-major
# solve's. Sizes: the staged route's n=3, 48 and 166 and the partitioned
# route's n=719, at batches that are no multiple of 32.

def _batch_last(rng, n, batch, dtype):
    """(dl, d, du, b) as (n, batch) transposes of row-major (batch, n)."""
    return [torch.from_numpy(np.ascontiguousarray(a.T)).mT
            for a in _systems(rng, (n, batch), dtype)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,batch", [(3, 37), (48, 45), (166, 13), (719, 5)])
def test_wrapper_takes_batch_last_views(rng, n, batch, dtype):
    arrays = _batch_last(rng, n, batch, dtype)
    assert all(a.stride() == (1, n) for a in arrays)
    got = tridiag_solve_cuda(*arrays)
    assert got.shape == (n, batch) and got.stride() == (1, n)
    want = tridiag_solve_plain(*(a.contiguous() for a in arrays))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [3, 48, 166, 719])
def test_solves_equal_the_row_major_route(rng, n, dtype):
    """tridiag_solve on (n, 5, 7) and tridiag_solve_batch_last on (5, 7, n)
    contiguous arrays, against the plain loop on row-major copies (the
    route every call took before batch-last arrays reached B1)."""
    arrays = [torch.from_numpy(a) for a in _systems(rng, (5, 7, n), dtype)]
    moved = [a.movedim(-1, 0) for a in arrays]
    want = tridiag_solve_plain(*(a.reshape(n, 35).contiguous() for a in moved))
    got = tridiag_solve_batch_last(*arrays)
    assert got.is_contiguous() and got.shape == (5, 7, n)
    assert torch.equal(got, want.reshape(n, 5, 7).movedim(0, -1))
    assert torch.equal(tridiag_solve(*moved), want.reshape(n, 5, 7))
    # row-major (n, ...) arrays keep their route
    rows = [a.contiguous() for a in moved]
    assert torch.equal(tridiag_solve(*rows), want.reshape(n, 5, 7))


@pytest.mark.parametrize("bc_type", ["natural", "clamped", "not-a-knot"])
@pytest.mark.parametrize("n", [4, 50])
def test_fit_cubic_spline_equals_the_row_major_route(rng, monkeypatch, bc_type, n):
    x = np.sort(rng.uniform(-2.0, 2.0, (6, 7, n)), axis=-1)
    x += np.arange(n) * 1e-3
    y = 0.04 + 0.1 * x * x + rng.normal(scale=1e-3, size=x.shape)
    kw = dict(fp0=rng.normal(size=(6, 7)), fpn=rng.normal(size=(6, 7))) \
        if bc_type == "clamped" else {}
    for dtype in (torch.float32, torch.float64):
        xt, yt = (torch.from_numpy(a).to(dtype) for a in (x, y))
        got = fit_cubic_spline(xt, yt, bc_type=bc_type, **kw)
        with monkeypatch.context() as m:
            m.setattr(ops_tridiag, "tridiag_solve_cuda",
                      lambda *a: tridiag_solve_plain(*(t.contiguous() for t in a)))
            want = fit_cubic_spline(xt, yt, bc_type=bc_type, **kw)
        assert got.is_contiguous() and torch.equal(got, want), (bc_type, dtype)


# n=48: the surface step (float32 S=128, float64 S=64, as row-major); n=166
# in float64 and n=14, 30 in float64: the cubic batch's and the surface
# task's parity shapes; n=56 in float32: rows padded to 60 pair two blocks
# on an SM at S=64, where row-major 56 do at S=128; n=400 in float32: rows padded to 404 no longer fit
# 32 systems in 200 KiB; n=3, 166, 257 in float32: no multiple of 16 bytes
@pytest.mark.parametrize("n,dtype,plan", [
    (48, torch.float32, ("staged", 128, 4 * 52 * 4 * 128, 128, "batch_last")),
    (48, torch.float64, ("staged", 64, 4 * 50 * 8 * 64, 64, "batch_last")),
    (166, torch.float64, ("staged", 32, 4 * 166 * 8 * 32, 32, "batch_last")),
    (14, torch.float64, ("staged", 128, 4 * 14 * 8 * 128, 128, "batch_last")),
    (30, torch.float64, ("staged", 64, 4 * 30 * 8 * 64, 64, "batch_last")),
    (56, torch.float32, ("staged", 64, 4 * 60 * 4 * 64, 64, "batch_last")),
    (400, torch.float32, None), (3, torch.float32, None),
    (166, torch.float32, None), (257, torch.float32, None),
])
def test_launch_plan_batch_last(n, dtype, plan):
    """The batch-last kernel's tiles at batch_last_rows (n padded to an odd
    number of 16-byte pieces) set S and the shared bytes; shapes it does
    not take get the row-major plan, which a batch-last call reaches by
    copying."""
    got = thomas_plan(n, dtype, 1000, "batch_last")
    if plan is None:
        assert got == thomas_plan(n, dtype, 1000) and got.layout == "system_major"
    else:
        assert tuple(got) == plan
        assert got.smem == 4 * batch_last_rows(n, dtype) * dtype.itemsize * got.systems
    with pytest.raises(ValueError):
        thomas_plan(n, dtype, 1000, "column_major")


def test_batch_last_rows_is_an_odd_number_of_pieces():
    assert batch_last_rows(48, torch.float32) == 52
    assert batch_last_rows(48, torch.float64) == 50
    assert batch_last_rows(52, torch.float32) == 52
    assert batch_last_rows(2, torch.float64) == 2
    assert [batch_last_rows(n, torch.float32) for n in (1, 2, 3, 6, 47)] == [None] * 5


def test_launches_by_layout_starts_at_zero(rng):
    assert LAYOUTS == ("system_major", "batch_last")
    assert tridiag_solve_cuda.launches_by_layout == {"system_major": 0, "batch_last": 0}
    tridiag_solve_cuda(*_batch_last(rng, 6, 4, np.float32))   # CPU: no launch
    assert tridiag_solve_cuda.launches_by_layout == {"system_major": 0, "batch_last": 0}
