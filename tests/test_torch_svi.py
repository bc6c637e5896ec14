"""Port parity: SVI (``ops/svi.py``) against the JAX package's on the same
seeded slices.

Closed forms (``svi_total_variance``, ``svi_g``, ``vega_weights``,
``adjugate3x3``, ``_solve3x3``) float64 <= 1e-12 relative; inits
(``svi_init``, ``svi_quasi_init``) <= 1e-9; batched fits in float64:
fitted w at the quotes <= 1e-8 absolute, params <= 1e-6, ``n_accepted``
and ``converged`` equal, also for the raw-SVI kernel's plain version
(the card's route for the linear loss without a penalty); in float32
(accept/reject decisions fall inside rounding, so the iterate paths
differ): fitted w at the quotes within 5e-5 of the slice's w scale and
cost within a factor 1.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import svi as ref
from iv_interpolation_tpu_torch.ops import lm
from iv_interpolation_tpu_torch.ops import svi as port
from iv_interpolation_tpu_torch.ops.cuda.svi_lm import svi_lm_cuda

TRUE_SVI = np.array([0.04, 0.4, -0.4, 0.05, 0.3])  # (a, b, rho, m, sigma)


def _slices(rng, B=6, n=21, noise=1e-4):
    k = np.tile(np.linspace(-0.6, 0.6, n), (B, 1)) * rng.uniform(0.8, 1.3, (B, 1))
    par = np.stack([rng.uniform(0.01, 0.05, B), rng.uniform(0.05, 0.3, B),
                    rng.uniform(-0.6, 0.3, B), rng.uniform(-0.1, 0.1, B),
                    rng.uniform(0.05, 0.3, B)], -1)
    w = np.asarray(ref.svi_total_variance(jnp.asarray(par), jnp.asarray(k)))
    return k, w + noise * rng.normal(size=w.shape), par


def _rel(a, b, tol):
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))


def test_closed_forms_match_jax(rng):
    k, w, par = _slices(rng)
    tk, tw, tp = map(torch.from_numpy, (k, w, par))
    jk, jw, jp = map(jnp.asarray, (k, w, par))
    _rel(port.svi_total_variance(tp, tk), ref.svi_total_variance(jp, jk), 1e-12)
    _rel(port.svi_g(tp, tk), ref.svi_g(jp, jk), 1e-12)
    _rel(port.vega_weights(tk, tw), ref.vega_weights(jk, jw), 1e-12)
    # broadcasting: one parameter set a surface against (B, E, n) strikes
    k3 = np.tile(k[:, None], (1, 3, 1))
    _rel(port.svi_total_variance(tp[:, None], torch.from_numpy(k3)),
         ref.svi_total_variance(jp[:, None], jnp.asarray(k3)), 1e-12)
    assert bool(port.svi_is_butterfly_free(torch.from_numpy(TRUE_SVI),
                                           torch.linspace(-1, 1, 50, dtype=torch.float64)))
    bad = np.array([0.0, 2.0, -0.95, 0.0, 0.01])    # a steep, sharp wing: g < 0
    kk = np.linspace(-1, 1, 200)
    assert bool(port.svi_is_butterfly_free(torch.from_numpy(bad), torch.from_numpy(kk))) \
        == bool(ref.svi_is_butterfly_free(jnp.asarray(bad), jnp.asarray(kk))) is False


def test_3x3_closed_forms_match_jax(rng):
    M = rng.normal(size=(5, 4, 3, 3))
    A = M @ M.swapaxes(-1, -2) + 0.1 * np.eye(3)
    b = rng.normal(size=(5, 4, 3))
    adj, det = port.adjugate3x3(torch.from_numpy(A))
    adj_r, det_r = ref.adjugate3x3(jnp.asarray(A))
    _rel(adj, adj_r, 1e-12)
    _rel(det, det_r, 1e-12)
    x = port._solve3x3(torch.from_numpy(A), torch.from_numpy(b))
    _rel(x, ref._solve3x3(jnp.asarray(A), jnp.asarray(b)), 1e-12)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b[..., None])[..., 0], rtol=1e-9)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_linspace_last_is_the_reference_linspace(rng, dtype):
    lo = rng.uniform(-2, 0, 7).astype(dtype)
    hi = (lo + rng.uniform(0.5, 3, 7)).astype(dtype)
    for num in (2, 8, 33):
        got = port.linspace_last(torch.from_numpy(lo), torch.from_numpy(hi), num).numpy()
        want = np.stack([np.asarray(jnp.linspace(a, b, num)) for a, b in zip(
            jnp.asarray(lo), jnp.asarray(hi))])
        # the same formula; XLA may fuse its multiply-add, so within two
        # ulps of the larger end
        ulp = np.spacing(np.maximum(np.abs(lo), np.abs(hi)).astype(dtype))[:, None]
        assert (np.abs(got - want) <= 2 * ulp).all()
        np.testing.assert_array_equal(got[:, [0, -1]], want[:, [0, -1]])
    with pytest.raises(ValueError):
        port.linspace_last(torch.zeros(1), torch.ones(1), 1)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 2e-5)])
def test_inits_match_jax(rng, dtype, tol):
    k, w, _ = _slices(rng)
    k, w = k.astype(dtype), w.astype(dtype)
    got = port.svi_init(*map(torch.from_numpy, (k, w)))
    want = jax.vmap(ref.svi_init)(jnp.asarray(k), jnp.asarray(w))
    _rel(got, want, tol)
    got = port.svi_quasi_init(*map(torch.from_numpy, (k, w)))
    want = jax.vmap(ref.svi_quasi_init)(jnp.asarray(k), jnp.asarray(w))
    _rel(got, want, tol)
    assert got.dtype == torch.from_numpy(k).dtype
    # one slice, as the reference takes it
    _rel(port.svi_quasi_init(torch.from_numpy(k[0]), torch.from_numpy(w[0]), n_m=5, n_sigma=6),
         ref.svi_quasi_init(jnp.asarray(k[0]), jnp.asarray(w[0]), n_m=5, n_sigma=6), tol)


CASES = {
    "plain": dict(),
    "quasi": dict(init="quasi"),
    "hinge": dict(butterfly_penalty=10.0),
    "huber": dict(loss="huber"),
    "huber_quasi_hinge": dict(loss="huber", huber_delta=5e-4, init="quasi",
                              butterfly_penalty=5.0),
}


def _fit_both(k, w, weights=None, **kw):
    wt_t = None if weights is None else torch.from_numpy(weights)
    wt_j = None if weights is None else jnp.asarray(weights)
    got = port.fit_svi_batched(torch.from_numpy(k), torch.from_numpy(w), wt_t, **kw)
    want = ref.fit_svi_batched(jnp.asarray(k), jnp.asarray(w), wt_j, **kw)
    w_got = port.svi_total_variance(got.params, torch.from_numpy(k)).numpy()
    w_want = np.asarray(ref.svi_total_variance(want.params, jnp.asarray(k)))
    return got, want, w_got, w_want


@pytest.mark.parametrize("case", list(CASES))
def test_batched_fit_float64_matches_jax(rng, case):
    k, w, _ = _slices(rng)
    got, want, w_got, w_want = _fit_both(k, w, max_iters=32, **CASES[case])
    np.testing.assert_allclose(w_got, w_want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-9)
    if "loss" not in CASES[case]:      # the robust fits need more than 32 iterations
        assert np.sqrt(np.mean((w_got - w) ** 2)) < 5e-4


# On CUDA tensors the linear loss without a penalty takes the raw-SVI
# kernel (``ops/cuda/svi_lm.py``), whose algorithm is not the generic
# loop's (closed-form Jacobian, sums in runs of 8, elementwise Cholesky);
# ``svi_lm_cuda`` on CPU tensors runs its plain version, equal to the
# kernel bit for bit on the card. Held to the JAX package at the generic
# loop's float64 tolerances above.
KERNEL_CASES = {
    "heuristic": dict(),
    "quasi": dict(init="quasi"),
    "vega_weights": dict(weights=True),
    "fifty_strikes": dict(n=50, init="quasi"),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_raw_svi_kernel_route_float64_matches_jax(rng, case):
    kw = dict(KERNEL_CASES[case])
    weighted, n = kw.pop("weights", False), kw.pop("n", 21)
    k, w, _ = _slices(rng, B=24, n=n)
    wt = np.array(ref.vega_weights(jnp.asarray(k), jnp.asarray(w))) if weighted else None
    tk, tw = torch.from_numpy(k), torch.from_numpy(w)
    p0 = (port.svi_quasi_init if kw.get("init") == "quasi" else port.svi_init)(tk, tw)
    got = svi_lm_cuda(tk, tw, None if wt is None else torch.from_numpy(wt), p0, 32,
                      lm.LAMBDA0, lm.TOL, port.SVI_LOWER, port.SVI_UPPER)
    want = ref.fit_svi_batched(jnp.asarray(k), jnp.asarray(w),
                               None if wt is None else jnp.asarray(wt), max_iters=32, **kw)
    w_got = port.svi_total_variance(got.params, tk).numpy()
    w_want = np.asarray(ref.svi_total_variance(want.params, jnp.asarray(k)))
    np.testing.assert_allclose(w_got, w_want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-9)
    assert np.sqrt(np.mean((w_got - w) ** 2)) < 5e-4


@pytest.mark.parametrize("case", list(CASES))
def test_batched_fit_float32_stays_within_the_float32_bound(rng, case):
    k, w, _ = _slices(rng)
    k, w = k.astype(np.float32), w.astype(np.float32)
    got, want, w_got, w_want = _fit_both(k, w, max_iters=32, **CASES[case])
    assert got.params.dtype == torch.float32 and got.cost.dtype == torch.float32
    scale = np.abs(w).max(axis=-1, keepdims=True)
    assert (np.abs(w_got - w_want) <= 5e-5 * scale).all()
    ratio = got.cost.numpy() / np.asarray(want.cost)
    assert ((ratio < 1.5) & (ratio > 1 / 1.5)).all(), ratio


def test_vega_weights_and_batch_shape(rng):
    """(B, E, n) batches keep their shape; vega weights go through."""
    k, w, _ = _slices(rng, B=6)
    k3, w3 = k.reshape(2, 3, -1), w.reshape(2, 3, -1)
    wt = np.asarray(ref.vega_weights(jnp.asarray(k3), jnp.asarray(w3)))
    got, want, w_got, w_want = _fit_both(k3, w3, weights=wt, max_iters=24)
    assert got.params.shape == (2, 3, 5) and got.cost.shape == (2, 3)
    assert got.n_accepted.shape == got.converged.shape == (2, 3)
    np.testing.assert_allclose(w_got, w_want, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    with pytest.raises(ValueError, match="unknown loss"):
        port.fit_svi_batched(torch.from_numpy(k), torch.from_numpy(w), loss="cauchy")


def test_single_slice_fit_recovers_truth_and_matches_jax():
    k = np.linspace(-1.0, 1.0, 25)
    w = np.asarray(ref.svi_total_variance(jnp.asarray(TRUE_SVI), jnp.asarray(k)))
    got = port.fit_svi(torch.from_numpy(k), torch.from_numpy(w), max_iters=64)
    want = ref.fit_svi(jnp.asarray(k), jnp.asarray(w), max_iters=64)
    assert got.params.shape == (5,) and got.cost.shape == ()
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), atol=1e-6)
    assert int(got.n_accepted) == int(want.n_accepted)
    w_fit = port.svi_total_variance(got.params, torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(w_fit, w, atol=1e-6)
    # a given start and weights, with the hinge
    p0 = TRUE_SVI * 1.1
    wt = np.linspace(0.5, 1.5, 25)
    got = port.fit_svi(*map(torch.from_numpy, (k, w, wt, p0)), max_iters=20,
                       butterfly_penalty=3.0)
    want = ref.fit_svi(*map(jnp.asarray, (k, w, wt, p0)), max_iters=20,
                       butterfly_penalty=3.0)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), atol=1e-6)


def test_huber_loss_resists_outlier_quote():
    """The reference's own robustness claim holds in the port."""
    k = np.linspace(-1.0, 1.0, 25)
    w = np.asarray(ref.svi_total_variance(jnp.asarray([0.04, 0.12, -0.3, 0.05, 0.2]),
                                          jnp.asarray(k)))
    w_bad = w.copy()
    w_bad[3] *= 3.0
    kb, wb = torch.from_numpy(k)[None], torch.from_numpy(w_bad)[None]
    ls = port.fit_svi_batched(kb, wb, max_iters=64, init="quasi")
    hu = port.fit_svi_batched(kb, wb, max_iters=64, init="quasi", loss="huber",
                              huber_delta=1e-3)
    err = lambda f: float(np.sqrt(np.mean(
        (port.svi_total_variance(f.params, kb).numpy() - w) ** 2)))
    assert err(hu) < err(ls) / 5 and err(hu) < 5e-4
