"""Port parity: eSSVI (``ops/essvi.py``) against the JAX package's on the
same seeded surfaces.

Closed forms (``essvi_w_derivs``, ``essvi_g``, ``psi_butterfly_cap`` and
its gradient, ``_transform``, ``_inv_transform``, ``_pullback_step``,
``_block_thomas``, ``_residual``) float64 <= 1e-12 relative; ``essvi_init``
with and without masked weights <= 1e-9; batched fits in float64: fitted w
at the quotes <= 1e-8 absolute, params <= 1e-6, ``n_accepted`` and
``converged`` equal; in float32 (accept/reject decisions fall inside
rounding): fitted w within 5e-5 of the slice's w scale and cost within a
factor 1.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import essvi as ref
from iv_interpolation_tpu_torch.ops import essvi as port


def _surfaces(rng, B=4, E=5, n=15, noise=1e-4):
    k = np.tile(np.linspace(-0.5, 0.5, n), (B, E, 1)) * rng.uniform(0.9, 1.2, (B, E, 1))
    theta = np.cumsum(rng.uniform(0.01, 0.03, (B, E)), -1)
    rho = rng.uniform(-0.6, 0.1, (B, E))
    cap = np.minimum(4 / (1 + np.abs(rho)), np.sqrt(4 * theta / (1 + np.abs(rho))))
    par = np.stack([theta, rho, cap * rng.uniform(0.2, 0.7, (B, E))], -1)
    w = np.asarray(ref.essvi_w(jnp.asarray(par), jnp.asarray(k)))
    return k, w + noise * rng.normal(size=w.shape), par


def _rel(a, b, tol=1e-12):
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))


def test_closed_forms_match_jax(rng):
    k, _, par = _surfaces(rng)
    tk, tp = torch.from_numpy(k), torch.from_numpy(par)
    jk, jp = jnp.asarray(k), jnp.asarray(par)
    for a, b in zip(port.essvi_w_derivs(tp, tk), ref.essvi_w_derivs(jp, jk)):
        _rel(a, b)
    _rel(port.essvi_w(tp, tk), ref.essvi_w(jp, jk))
    _rel(port.essvi_g(tp, tk), ref.essvi_g(jp, jk))
    _rel(port.psi_butterfly_cap(tp[..., 0], tp[..., 1]),
         ref.psi_butterfly_cap(jp[..., 0], jp[..., 1]))


def test_cap_gradient_is_the_autodiff_gradient_at_the_kinks(rng):
    """rho = 0 (the reference's d|rho| there is +1) and the tie of the two
    caps (theta (1+|rho|) = 4: half each) included: the closed form equals
    ``jax.grad`` of the reference's ``psi_butterfly_cap`` everywhere, and
    ``torch.func.grad`` of the port's wherever rho != 0 (torch's ``abs``
    has derivative 0 at 0)."""
    theta = np.concatenate([rng.uniform(0.005, 8.0, 20), [0.04, 4.0, 2.0, 3.2, 4.0 / 1.5]])
    rho = np.concatenate([rng.uniform(-0.95, 0.95, 20), [0.0, 0.0, 1.0, -0.25, 0.5]])
    one_r = 1 + np.abs(rho)
    assert (4 / one_r == np.sqrt(4 * theta / one_r)).sum() >= 3        # real ties
    got = port.psi_butterfly_cap_grads(torch.from_numpy(theta), torch.from_numpy(rho))
    want = jax.vmap(jax.grad(ref.psi_butterfly_cap, argnums=(0, 1)))(
        jnp.asarray(theta), jnp.asarray(rho))
    auto = torch.func.vmap(torch.func.grad(port.psi_butterfly_cap, argnums=(0, 1)))(
        torch.from_numpy(theta), torch.from_numpy(rho))
    for g, w_, a in zip(got, want, auto):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(g.numpy()[rho != 0], a.numpy()[rho != 0],
                                   rtol=1e-12, atol=1e-15)


def test_transforms_match_jax(rng):
    E = 6
    z = rng.normal(size=(5, 3 * E)) * 2.0
    z[0, :E] = 30.0                      # softplus far above F.softplus' switch
    z[1, :E] = -30.0
    tz = torch.from_numpy(z)
    params = port._transform(tz, E)
    want = jax.vmap(lambda v: ref._transform(v, E))(jnp.asarray(z))
    _rel(params, want)
    p = params.numpy()
    assert (np.diff(p[..., 0], axis=-1) > 0).all() and (np.abs(p[..., 1]) < 1).all()
    back = port._inv_transform(params[..., 0], params[..., 1], params[..., 2])
    want_back = jax.vmap(ref._inv_transform)(want[..., 0], want[..., 1], want[..., 2])
    _rel(back, want_back)
    _rel(port._inv_softplus(torch.from_numpy(np.array([1e-12, 1e-3, 1.0, 40.0]))),
         ref._inv_softplus(jnp.asarray([1e-12, 1e-3, 1.0, 40.0])))
    # one surface, unbatched, as the reference takes it
    _rel(port._transform(tz[2], E), ref._transform(jnp.asarray(z[2]), E))
    d = rng.normal(size=(5, E, 3)) * 1e-2
    _rel(port._pullback_step(tz, torch.from_numpy(d), E),
         jax.vmap(lambda v, s: ref._pullback_step(v, s, E))(jnp.asarray(z), jnp.asarray(d)))


def test_pullback_inverts_the_transform_tangent(rng):
    """Phi^{-1} Phi = I: pushing dz through the transform's Jacobian and
    pulling the slice-space step back returns dz."""
    E = 4
    z = torch.from_numpy(rng.normal(size=3 * E))
    dz = torch.from_numpy(rng.normal(size=3 * E) * 1e-3)
    _, d_slice = torch.func.jvp(lambda v: port._transform(v, E), (z,), (dz,))
    np.testing.assert_allclose(port._pullback_step(z, d_slice, E).numpy(), dz.numpy(),
                               rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("E", [1, 2, 6])
def test_block_thomas_matches_jax_and_a_dense_solve(rng, E):
    B = 3
    M = rng.normal(size=(B, E, 3, 3))
    D = M @ M.swapaxes(-1, -2) + 4.0 * np.eye(3)
    U = 0.3 * rng.normal(size=(B, max(E - 1, 0), 3, 3))
    b = rng.normal(size=(B, E, 3))
    got = port._block_thomas(*map(torch.from_numpy, (D, U, b))).numpy()
    want = np.stack([np.asarray(ref._block_thomas(*map(jnp.asarray, (D[i], U[i], b[i]))))
                     for i in range(B)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    for i in range(B):
        A = np.zeros((3 * E, 3 * E))
        for e in range(E):
            A[3 * e:3 * e + 3, 3 * e:3 * e + 3] = D[i, e]
            if e + 1 < E:
                A[3 * e:3 * e + 3, 3 * e + 3:3 * e + 6] = U[i, e]
                A[3 * e + 3:3 * e + 6, 3 * e:3 * e + 3] = U[i, e].T
        np.testing.assert_allclose(got[i].reshape(-1), np.linalg.solve(A, b[i].reshape(-1)),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 2e-4)])
@pytest.mark.parametrize("masked", [False, True])
def test_init_matches_jax(rng, dtype, tol, masked):
    k, w, _ = _surfaces(rng)
    wt = np.ones_like(w)
    if masked:
        w[:, 2] = 50.0                    # a placeholder slice ...
        wt[:, 2] = 0.0                    # ... fully masked
        wt[:, 0, :3] = 0.0                # and some padded strikes
    k, w, wt = (a.astype(dtype) for a in (k, w, wt))
    args = (k, w, wt) if masked else (k, w)
    got = port.essvi_init(*map(torch.from_numpy, args))
    want = jax.vmap(ref.essvi_init)(*map(jnp.asarray, args))
    _rel(got, want, tol)
    if masked:
        theta = port._transform(got, k.shape[1])[..., 0].numpy()
        assert (theta < 1.0).all()        # the placeholder did not drag theta up


def test_residual_and_penalty_grid_match_jax(rng):
    k, w, _ = _surfaces(rng, B=2, E=4)
    E = 4
    wt = rng.uniform(0.5, 1.5, w.shape)
    wt[0, 1, -2:] = 0.0                   # padded strikes at the end of a slice
    z = rng.normal(size=(2, 3 * E))
    k_pen = port._penalty_grid(torch.from_numpy(k), torch.from_numpy(wt), 9)
    live = wt > 0
    for b in range(2):
        lo = max(k[b, e][live[b, e]].min() for e in range(E))
        hi = min(k[b, e][live[b, e]].max() for e in range(E))
        np.testing.assert_allclose(k_pen[b].numpy(), np.asarray(jnp.linspace(lo, hi, 9)),
                                   rtol=0, atol=4e-16)
    for cw in (10.0, 0.0):
        got = port._residual(*map(torch.from_numpy, (z, k, w, wt)), k_pen, cw, E)
        want = jax.vmap(lambda *a: ref._residual(*a, cw, E))(
            *map(jnp.asarray, (z, k, w, wt, k_pen.numpy())))
        _rel(got, want)
        assert got.shape == (2, E * k.shape[-1] + (9 * (E - 1) if cw else 0))


CASES = {
    "block": dict(),
    "dense": dict(solver="dense"),
    "huber": dict(loss="huber"),
    "huber_block_asks_dense": dict(loss="huber", huber_delta=5e-4, solver="block"),
    "no_calendar_hinge": dict(calendar_weight=0.0),
    "strong_hinge_small_grid": dict(calendar_weight=50.0, n_penalty_grid=9),
}


def _fit_both(k, w, wt=None, **kw):
    targs = [torch.from_numpy(a) for a in (k, w)] + ([torch.from_numpy(wt)] if wt is not None else [])
    jargs = [jnp.asarray(a) for a in (k, w)] + ([jnp.asarray(wt)] if wt is not None else [])
    got = port.fit_essvi_batched(*targs, **kw)
    want = ref.fit_essvi_batched(*jargs, **kw)
    w_got = port.essvi_w(got.params, torch.from_numpy(k)).numpy()
    w_want = np.asarray(ref.essvi_w(want.params, jnp.asarray(k)))
    return got, want, w_got, w_want


@pytest.mark.parametrize("case", list(CASES))
def test_batched_fit_float64_matches_jax(rng, case):
    k, w, _ = _surfaces(rng)
    got, want, w_got, w_want = _fit_both(k, w, max_iters=24, **CASES[case])
    np.testing.assert_allclose(w_got, w_want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-9)
    assert got.params.shape == (4, 5, 3) and got.n_accepted.dtype == torch.int32
    # the structural guarantees hold for every fit
    p = got.params.numpy()
    assert (np.diff(p[..., 0], axis=-1) > 0).all()
    cap = port.psi_butterfly_cap(got.params[..., 0], got.params[..., 1]).numpy()
    assert (p[..., 2] <= cap + 1e-9).all() and (p[..., 2] > 0).all()


@pytest.mark.parametrize("case", ["block", "dense", "huber"])
def test_batched_fit_float32_stays_within_the_float32_bound(rng, case):
    k, w, _ = _surfaces(rng)
    k, w = k.astype(np.float32), w.astype(np.float32)
    got, want, w_got, w_want = _fit_both(k, w, max_iters=24, **CASES[case])
    assert got.params.dtype == torch.float32
    scale = np.abs(w).max(axis=-1, keepdims=True)
    assert (np.abs(w_got - w_want) <= 5e-5 * scale).all()
    ratio = got.cost.numpy() / np.asarray(want.cost)
    assert ((ratio < 1.5) & (ratio > 1 / 1.5)).all(), ratio


def test_dense_against_block_reach_the_same_quality(rng):
    B, E, n = 3, 5, 15
    k = np.tile(np.linspace(-0.8, 0.8, n), (B, E, 1))
    theta = np.cumsum(rng.uniform(0.01, 0.04, (B, E)), -1)
    w = theta[..., None] * (1.0 + 0.08 * k * k)
    tk, tw = torch.from_numpy(k), torch.from_numpy(w)
    fits = {s: port.fit_essvi_batched(tk, tw, max_iters=32, solver=s)
            for s in ("dense", "block")}
    rmse = {s: float(np.sqrt(np.mean((port.essvi_w(f.params, tk).numpy() - w) ** 2)))
            for s, f in fits.items()}
    assert rmse["block"] < 1.5 * rmse["dense"] + 1e-6, rmse
    assert rmse["block"] < 5e-4
    with pytest.raises(ValueError, match="unknown solver"):
        port.fit_essvi_batched(tk, tw, solver="sparse")
    with pytest.raises(ValueError, match="unknown loss"):
        port.fit_essvi_batched(tk, tw, loss="cauchy")


def test_dense_solver_chunks_give_the_unchunked_fit(rng, monkeypatch):
    k, w, _ = _surfaces(rng, B=5, E=3, n=9)
    tk, tw = torch.from_numpy(k), torch.from_numpy(w)
    whole = port.fit_essvi_batched(tk, tw, max_iters=10, solver="dense")
    monkeypatch.setattr(port, "_DENSE_CHUNK", 2)
    parts = port.fit_essvi_batched(tk, tw, max_iters=10, solver="dense")
    # batched products round differently at another batch size
    np.testing.assert_allclose(parts.params.numpy(), whole.params.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(parts.cost.numpy(), whole.cost.numpy(), rtol=1e-9)
    for a, b in zip(whole[2:], parts[2:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("solver", ["block", "dense"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_masked_garbage_slice_matches_jax_and_fits_the_live_slices(rng, solver, dtype):
    """A fully masked slice of placeholder w: the init ignores it, and the
    block solver's zero J^T J block is held up by the absolute damping
    floor (float32: the determinant would underflow without it)."""
    E, n = 5, 15
    k = np.tile(np.linspace(-0.8, 0.8, n), (E, 1))
    theta = np.cumsum(rng.uniform(0.01, 0.04, E))
    w = theta[:, None] * (1.0 + 0.08 * k * k)
    w_bad = w.copy()
    w_bad[2] = 50.0
    wts = np.ones((E, n))
    wts[2] = 0.0
    k_, w_, wt_ = (a.astype(dtype) for a in (k, w_bad, wts))
    fit = port.fit_essvi(*map(torch.from_numpy, (k_, w_, wt_)), max_iters=48, solver=solver)
    want = ref.fit_essvi(*map(jnp.asarray, (k_, w_, wt_)), max_iters=48, solver=solver)
    params = fit.params.numpy()
    assert params.shape == (E, 3) and fit.cost.shape == ()
    assert np.isfinite(params).all() and int(fit.n_accepted) > 0
    pred = port.essvi_w(fit.params, torch.from_numpy(k_)).numpy()
    live = [0, 1, 3, 4]
    assert float(np.sqrt(np.mean((pred[live] - w[live]) ** 2))) < 5e-3
    assert params[2, 0] < 1.0            # not dragged to ~50
    pred_ref = np.asarray(ref.essvi_w(want.params, jnp.asarray(k_)))
    if dtype == np.float64:
        # dense: the masked slice's three directions have J^T J = 0, held up
        # only by lam * 1e-12, so the (3E, 3E) Cholesky is ill-conditioned and
        # amplifies the two packages' rounding: 1e-6 is the bound that holds
        atol = 1e-8 if solver == "block" else 1e-6
        np.testing.assert_allclose(pred[live], pred_ref[live], rtol=0, atol=atol)
        assert int(fit.n_accepted) == int(want.n_accepted)
    else:
        assert (np.abs(pred[live] - pred_ref[live]) <= 5e-5 * np.abs(w[live]).max()).all()


def test_penalty_grid_ignores_padded_sentinel_strikes(rng):
    E, n = 4, 12
    k = np.tile(np.linspace(-0.6, 0.6, n), (E, 1))
    theta = np.cumsum(rng.uniform(0.01, 0.04, E))
    w = theta[:, None] * (1.0 + 0.1 * k * k)
    clean = port.fit_essvi(torch.from_numpy(k), torch.from_numpy(w), max_iters=48)
    k_pad = np.concatenate([k, np.full((E, 1), -999.0)], -1)
    w_pad = np.concatenate([w, np.full((E, 1), 7.0)], -1)
    wts = np.concatenate([np.ones((E, n)), np.zeros((E, 1))], -1)
    padded = port.fit_essvi(*map(torch.from_numpy, (k_pad, w_pad, wts)), max_iters=48)
    np.testing.assert_allclose(padded.params.numpy(), clean.params.numpy(),
                               rtol=1e-4, atol=1e-6)
    want = ref.fit_essvi(*map(jnp.asarray, (k_pad, w_pad, wts)), max_iters=48)
    np.testing.assert_allclose(padded.params.numpy(), np.asarray(want.params), atol=1e-6)


def test_knobs_accept_numpy_scalars_and_leading_batch_dims(rng):
    k, w, _ = _surfaces(rng, B=4, E=3, n=9)
    k4, w4 = k.reshape(2, 2, 3, 9), w.reshape(2, 2, 3, 9)
    fit = port.fit_essvi_batched(torch.from_numpy(k4), torch.from_numpy(w4),
                                 max_iters=np.int64(8), calendar_weight=np.float32(10.0),
                                 huber_delta=np.float64(1e-3))
    flat = port.fit_essvi_batched(torch.from_numpy(k), torch.from_numpy(w), max_iters=8)
    assert fit.params.shape == (2, 2, 3, 3) and fit.cost.shape == (2, 2)
    np.testing.assert_array_equal(fit.params.numpy().reshape(4, 3, 3), flat.params.numpy())
