"""Port parity: ``ops.tridiag.tridiag_solve_pcr`` (parallel cyclic
reduction, plain tensor code) and ``tridiag_solve_batch_last`` against the
JAX package's, on seeded numpy inputs (CPU tensors).

Tolerances: PCR within 1e-10 in float64 (the JAX suite's own bound for
its PCR, ``tests/test_tridiag.py``), against the JAX PCR and against the
port's Thomas solve (kernel B1's plain version on CPU tensors);
``tridiag_solve_batch_last`` within 1e-12 of the JAX function (the same
Thomas recurrence on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import tridiag as ref
from iv_interpolation_tpu_torch.ops import tridiag as port


def _systems(rng, shape):
    return (rng.uniform(-1.0, 1.0, shape), rng.uniform(4.0, 6.0, shape),
            rng.uniform(-1.0, 1.0, shape), rng.normal(size=shape))


@pytest.mark.parametrize("n", [1, 2, 5, 48, 257])
def test_pcr_matches_jax_pcr_and_thomas(rng, n):
    arrays = _systems(rng, (n, 33))
    got = port.tridiag_solve_pcr(*map(torch.from_numpy, arrays))
    want = np.asarray(ref.tridiag_solve_pcr(*map(jnp.asarray, arrays)))
    assert got.dtype == torch.float64 and got.shape == (n, 33)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    thomas = port.tridiag_solve(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got.numpy(), thomas.numpy(), rtol=0, atol=1e-10)


def test_pcr_ignores_the_off_ends_and_keeps_its_inputs(rng):
    """dl[0] and du[n-1] lie outside the matrix: PCR zeroes them on a copy
    and the caller's tensors are left as they were."""
    dl, d, du, b = map(torch.from_numpy, _systems(rng, (9, 4)))
    before = [a.clone() for a in (dl, d, du, b)]
    x = port.tridiag_solve_pcr(dl, d, du, b)
    dl2, du2 = dl.clone(), du.clone()
    dl2[0], du2[-1] = 1e3, -1e3
    np.testing.assert_array_equal(port.tridiag_solve_pcr(dl2, d, du2, b).numpy(), x.numpy())
    for a, a0 in zip((dl, d, du, b), before):
        assert torch.equal(a, a0)
    np.testing.assert_allclose(port.tridiag_matvec(dl, d, du, x).numpy(), b.numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(40,), (7, 40), (3, 5, 17), (6, 2)])
def test_batch_last_matches_jax(rng, shape):
    arrays = _systems(rng, shape)
    got = port.tridiag_solve_batch_last(*map(torch.from_numpy, arrays))
    want = np.asarray(ref.tridiag_solve_batch_last(*map(jnp.asarray, arrays)))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
