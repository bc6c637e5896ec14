"""Port parity: matrix-form splines (``ops/spline_matrix.py``) against the
JAX package.

Tolerances: operators agree to 1e-12 of their largest entry (the
dense solve G = T^-1 C runs through LAPACK on both sides; the E2 entries
scale like 1/h^2, so the bound scales with them); grid outputs in
float64 agree to 1e-12 (relative and absolute); float32 grid outputs
agree to 1024 ulps of the largest |output| (the float32 LU of T carries
cond(T) into G). Flags agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import spline_matrix as ref
from iv_interpolation_tpu.surface.surface import common_support_grid
from iv_interpolation_tpu_torch.convert import spline_operator_from_numpy
from iv_interpolation_tpu_torch.ops import spline_matrix as port

GRID_KEYS = ("k_grid", "w_grid", "iv_grid", "g")
FLAGS = ("butterfly_ok", "calendar_ok")


def _op_close(a, b):
    scale = max(1.0, np.abs(b).max())
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * scale)


def _grid_close(a, b, dtype):
    if dtype == np.float64:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    else:
        scale = max(1.0, np.abs(b).max())
        np.testing.assert_allclose(
            a, b, rtol=0, atol=1024 * np.finfo(np.float32).eps * scale)


def _knots(rng, n, batch=()):
    x = np.sort(rng.uniform(-1.0, 1.0, batch + (n,)), axis=-1)
    return x + np.arange(n) * 0.05


@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
@pytest.mark.parametrize("n", [2, 3, 4, 12])
def test_curvature_and_operator_match_jax(rng, n, bc):
    x = _knots(rng, n)
    t = np.linspace(x[0] - 0.1, x[-1] + 0.1, 23)
    G = port._curvature_operator(torch.from_numpy(x), bc).numpy()
    _op_close(G, np.asarray(ref._curvature_operator(jnp.asarray(x), bc)))
    got = port.build_spline_operator(torch.from_numpy(x), torch.from_numpy(t), bc)
    want = ref.build_spline_operator(jnp.asarray(x), jnp.asarray(t), bc)
    for f in ("E0", "E1", "E2", "EC"):
        _op_close(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    y = rng.normal(size=(5, n))
    for a, b in zip(port.apply_spline_operator(got, torch.from_numpy(y)),
                    ref.apply_spline_operator(want, jnp.asarray(y))):
        _grid_close(a.numpy(), np.asarray(b), np.float64)


def test_bad_bc_raises(rng):
    x = torch.from_numpy(_knots(rng, 6))
    for bc in ("clamped", "periodic"):
        with pytest.raises(ValueError):
            port._curvature_operator(x, bc)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
def test_surface_grid_paths_match_jax(rng, bc, dtype):
    B, E, n, m = 3, 4, 12, 17
    k_row = np.linspace(-0.9, 0.9, n)
    knots = np.broadcast_to(k_row, (E, n)).astype(dtype)
    queries = np.linspace(-0.9, 0.9, m).astype(dtype)
    T = np.linspace(0.1, 1.5, E).astype(dtype)
    iv = (0.3 + 0.1 * k_row ** 2 + 0.01 * rng.normal(size=(B, E, 1))).astype(dtype)
    ops = port.build_surface_operators(torch.from_numpy(knots),
                                       torch.from_numpy(queries), bc)
    ops_ref = ref.build_surface_operators(jnp.asarray(knots),
                                          jnp.asarray(queries), bc)
    assert ops.E0.shape == (E, n, m) and ops.queries.shape == (E, m)
    got = port.fit_eval_surface_grid(ops, torch.from_numpy(iv), torch.from_numpy(T))
    want = ref.fit_eval_surface_grid(ops_ref, jnp.asarray(iv), jnp.asarray(T))
    for key in GRID_KEYS:
        _grid_close(got[key].numpy(), np.asarray(want[key]), dtype)
    for key in FLAGS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("queries_per_chain", [False, True])
def test_batched_operators_and_refit_match_jax(rng, queries_per_chain):
    B, E, n, m = 4, 3, 10, 13
    k = np.stack([np.broadcast_to(_knots(rng, n), (E, n)) for _ in range(B)])
    T = np.sort(rng.uniform(0.1, 1.5, (B, E)), axis=-1)
    iv = 0.3 + 0.1 * k ** 2 + 0.02 * np.sin(8 * k)
    if queries_per_chain:
        q = np.asarray(common_support_grid(jnp.asarray(k), m))
    else:
        q = np.linspace(-0.5, 0.5, m)
    ops = port.build_surface_operators_batched(
        torch.from_numpy(k), torch.from_numpy(np.array(q)), "not-a-knot")
    ops_ref = ref.build_surface_operators_batched(
        jnp.asarray(k), jnp.asarray(q), "not-a-knot")
    assert ops.EC.shape == (B, E, n, 3 * m)
    for f in port.SplineOperator._fields:
        _op_close(getattr(ops, f).numpy(), np.asarray(getattr(ops_ref, f)))
    # the refit on the port's own operators and on the reference's,
    # handed over through convert.py
    converted = spline_operator_from_numpy(jax.tree.map(np.asarray, ops_ref),
                                           device="cpu")
    want = ref.fit_eval_surface_grid_batched(ops_ref, jnp.asarray(iv),
                                             jnp.asarray(T))
    for o in (ops, converted):
        got = port.fit_eval_surface_grid_batched(o, torch.from_numpy(iv),
                                                 torch.from_numpy(T))
        for key in GRID_KEYS:
            _grid_close(got[key].numpy(), np.asarray(want[key]), np.float64)
        for key in FLAGS:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_grid_diagnostics_float32_tolerances():
    """The 1024-ulp flag tolerances: a float32 g just inside -1024 eps
    passes and just outside fails, in both packages alike."""
    g_edge = -1024 * float(np.finfo(np.float32).eps)
    m = 4
    for g_scale, expect in ((0.99, True), (1.01, False)):
        out = np.zeros((1, 2, 3 * m), np.float32)
        out[..., :m] = 0.25                       # w; w' = 0 and k = 0
        out[..., 2 * m:] = 2 * (g_edge * g_scale - 1.0)  # g = 1 + w''/2
        k = np.zeros((1, 2, m), np.float32)
        T = np.ones((1, 2, 1), np.float32)
        got = port._grid_diagnostics(torch.from_numpy(out), m,
                                     torch.from_numpy(k), torch.from_numpy(T))
        want = ref._grid_diagnostics(jnp.asarray(out), m, jnp.asarray(k),
                                     jnp.asarray(T))
        for key in FLAGS:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert bool(got["butterfly_ok"][0]) is expect
