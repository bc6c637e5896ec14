"""Port parity: the plain version of kernel B1's partitioned route
(``tridiag_solve_partitioned_plain``: a segment a lane, the reduced
system by PCR) against the JAX package's Pallas kernel in
interpret mode, its Thomas scan and its parallel cyclic reduction.

Systems: Andreasen-Huge's implicit step systems at n=257 (the JAX
package's ``_step_system`` and ``ah_step``'s right-hand side), the
not-a-knot spline systems of a 30-day hourly knot set (n=719, as the
pipeline's cubic stage builds them), and random diagonally dominant
systems at n = 201, 401 and 1,000, with P lanes that do and do not
divide n.

Tolerances: float64 within 1e-12 of max(1, max |x|); float32 within 256
ulps of max |x|. The partition method reorders Thomas's eliminations, and
each reference rounds in its own order: the differences measured here are
20-75 ulps of max |x| in either dtype, on the AH systems too (weakly
dominant at their boundary rows, M-matrices throughout), so they share
the bound.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import andreasen_huge as jax_ah
from iv_interpolation_tpu.ops.pallas.tridiag_pallas import tridiag_solve_pallas
from iv_interpolation_tpu.ops.tridiag import tridiag_solve as jax_solve
from iv_interpolation_tpu.ops.tridiag import tridiag_solve_pcr as jax_pcr
from iv_interpolation_tpu_torch.ops import cubic_spline
from iv_interpolation_tpu_torch.ops.cuda.tridiag import (
    tridiag_solve_partitioned_plain,
    tridiag_solve_plain,
)

REFERENCES = {
    "pallas": lambda *a: tridiag_solve_pallas(*a, interpret=True),
    "scan": jax_solve,
    "pcr": jax_pcr,
}


def _bound(dtype, ref):
    if dtype == np.float64:
        return 1e-12 * max(1.0, np.abs(ref).max())
    return 256 * np.finfo(np.float32).eps * np.abs(ref).max()


RANDOM_N = (201, 401, 1000)


@functools.lru_cache(maxsize=None)
def _cases(dtype) -> dict:
    """Every seeded system set in ``dtype`` ("ah", "spline", and
    ("random", n) for n in RANDOM_N) with the three references' solutions,
    made once for every P held to them. The references
    solve all sets in one call, each system padded with identity rows to
    the largest n (its ``du[n-1]`` zeroed, which the solve ignores anyway,
    so the padding decouples), so JAX compiles each reference once a
    dtype."""
    rng = np.random.default_rng(12345)
    sets = {"ah": _ah_systems(rng), "spline": _spline_systems(rng)}
    for n in RANDOM_N:
        shape = (n, 5)
        sets["random", n] = [rng.uniform(-1.0, 1.0, shape), rng.uniform(4.0, 6.0, shape),
                             rng.uniform(-1.0, 1.0, shape), rng.normal(size=shape)]
    N = max(a[1].shape[0] for a in sets.values())
    padded = []
    for dl, d, du, b in sets.values():
        n, width = d.shape
        du = du.copy()
        du[-1] = 0.0
        pad = lambda a, fill: np.concatenate([a, np.full((N - n, width), fill)])
        padded.append([pad(dl, 0.0), pad(d, 1.0), pad(du, 0.0), pad(b, 0.0)])
    joined = [np.concatenate([p[i] for p in padded], axis=1).astype(dtype) for i in range(4)]
    solved = {name: np.asarray(fn(*map(jnp.asarray, joined)))
              for name, fn in REFERENCES.items()}
    out, col = {}, 0
    for key, arrays in sets.items():
        n, width = arrays[1].shape
        out[key] = ([a.astype(dtype) for a in arrays],
                    {name: x[:n, col:col + width] for name, x in solved.items()})
        col += width
    return out


def _hold(case, dtype, P):
    arrays, refs = case
    got = tridiag_solve_partitioned_plain(*map(torch.from_numpy, arrays), P=P).numpy()
    assert got.dtype == dtype and got.shape == arrays[3].shape
    for name, ref in refs.items():
        err = np.abs(got - ref).max()
        assert err <= _bound(dtype, ref), (name, err, _bound(dtype, ref))


def _ah_systems(rng, n=257, batch=4):
    """(n, batch) AH step systems: a log-moneyness grid over [-3, -1.5] ..
    [1.5, 3], local variances 0.01-0.6, dt 0.02-1, built by the JAX
    package's ``_step_system``; the right-hand side as ``ah_step`` sets
    it (slope rows at both ends) on an intrinsic curve plus time value."""
    cols = []
    for _ in range(batch):
        x = np.linspace(rng.uniform(-3.0, -1.5), rng.uniform(1.5, 3.0), n)
        sig2, dt = rng.uniform(0.01, 0.6, n), rng.uniform(0.02, 1.0)
        dl, d, du = (np.asarray(a) for a in jax_ah._step_system(
            jnp.asarray(sig2), jnp.asarray(x), jnp.asarray(dt)))
        rhs = np.maximum(1.0 - np.exp(x), 0.0) + 0.05 * np.exp(-x * x)
        rhs[0], rhs[-1] = np.exp(x[1]) - np.exp(x[0]), 0.0
        cols.append((dl, d, du, rhs))
    return [np.stack([c[i] for c in cols], axis=1) for i in range(4)]


def _spline_systems(rng, hours=721, batch=3):
    """The not-a-knot systems of ``fit_cubic_spline`` on a 30-day span of
    hourly knots in minutes (0 .. 43,200), a few interior hours dropped
    (uneven spacing, as the runner's sub-batches have): n = hours - 2
    minus the dropped ones."""
    keep = np.ones(hours, bool)
    keep[rng.choice(np.arange(1, hours - 1), 2, replace=False)] = False
    x = np.tile(60.0 * np.flatnonzero(keep), (batch, 1))
    y = 0.45 + 0.05 * np.cumsum(rng.normal(0, 0.02, x.shape), axis=1)
    seen = []
    solve = cubic_spline.tridiag_solve_batch_last

    def record(*arrays):
        seen.append([a.numpy().T.copy() for a in arrays])
        return solve(*arrays)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cubic_spline, "tridiag_solve_batch_last", record)
        cubic_spline.fit_cubic_spline(torch.from_numpy(x), torch.from_numpy(y), "not-a-knot")
    (arrays,) = seen
    return arrays


@pytest.mark.parametrize("P", [32, 7, 8, 16])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ah_step_systems(dtype, P):
    _hold(_cases(dtype)["ah"], dtype, P)


@pytest.mark.parametrize("P", [32, 16])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_not_a_knot_30_day_spline_systems(dtype, P):
    case = _cases(dtype)["spline"]
    assert case[0][1].shape == (717, 3)      # 721 knots, 2 dropped, the 2 ends eliminated
    _hold(case, dtype, P)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,P", [(201, 32), (401, 32), (1000, 32), (1000, 8),
                                 (401, 7), (201, 100), (201, 16), (401, 64),
                                 (1000, 64), (1000, 13), (1000, 500), (401, 200)])
def test_random_dominant_systems(n, P, dtype):   # n in RANDOM_N
    _hold(_cases(dtype)["random", n], dtype, P)


def test_off_ends_are_never_read(rng):
    shape = (300, 6)
    dl, d, du, b = (rng.uniform(-1.0, 1.0, shape), rng.uniform(4.0, 6.0, shape),
                    rng.uniform(-1.0, 1.0, shape), rng.normal(size=shape))
    t = lambda *a: [torch.from_numpy(v) for v in a]
    clean = tridiag_solve_partitioned_plain(*t(dl, d, du, b))
    dl[0], du[-1] = np.nan, np.nan
    dirty = tridiag_solve_partitioned_plain(*t(dl, d, du, b))
    torch.testing.assert_close(clean, dirty, rtol=0, atol=0)
    plain = tridiag_solve_plain(*t(dl, d, du, b))
    assert float((dirty - plain).abs().max()) <= 1e-12 * float(plain.abs().max())


def test_rejects_what_the_route_cannot_take(rng):
    arrays = [torch.from_numpy(rng.uniform(4.0, 6.0, (63, 2))) for _ in range(4)]
    with pytest.raises(ValueError):
        tridiag_solve_partitioned_plain(*arrays)              # n < 2P
    with pytest.raises(ValueError):
        tridiag_solve_partitioned_plain(*arrays, P=0)
