"""Port parity: the counter-based PRNG (``ops/prng.py``) against
``jax.random`` (threefry2x32, partitionable counters).

Keys, ``fold_in``, ``split``, raw bits and ``randint`` must be
bit-identical, for one draw a key and for shaped draws. Uniform
draws must be bit-identical in float32 for any range and in float64 for
the ranges whose affine map is exact (every range the bridge uses).
Elsewhere a float64 draw is within one ulp of max(|lo|, |hi|) (the
rounding of the product that XLA fuses). ``normal`` and ``exponential``
apply each library's own erfinv / log1p to the identical uniform; they
are held to 64 ulps (float32) and 128 ulps (float64) of max(1, |x|): the
two erfinv implementations part most in the tails, where |u| -> 1 and
erfinv's condition number grows, and XLA's float64 log1p is the loosest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu_torch.convert import prng_key_from_numpy
from iv_interpolation_tpu_torch.ops import prng

DTYPES = {"float32": (jnp.float32, torch.float32, 64),
          "float64": (jnp.float64, torch.float64, 128)}


def _keys(seed, n):
    """n JAX keys folded from one root, and the same keys in the port."""
    data = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(seed), jnp.asarray(data.astype(np.uint32)))
    return keys, prng_key_from_numpy(np.asarray(jax.random.key_data(keys)), device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5, 2**40 + 7])
def test_key_matches_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(prng.key(seed, device="cpu").numpy(), want)


def test_fold_in_matches_jax_bit_for_bit():
    data = np.random.default_rng(1).integers(0, 2**32, 4096, dtype=np.uint64)
    root = jax.random.key(123)
    want = jax.random.key_data(jax.vmap(jax.random.fold_in, (None, 0))(
        root, jnp.asarray(data.astype(np.uint32))))
    got = prng.fold_in(prng.key(123, device="cpu"), torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fold_in_wraps_data_modulo_2_32():
    k = prng.key(9, device="cpu")
    np.testing.assert_array_equal(prng.fold_in(k, 2**32 + 17).numpy(),
                                  prng.fold_in(k, 17).numpy())


@pytest.mark.parametrize("n", [1, 6, 37])
def test_split_matches_jax_bit_for_bit(n):
    keys, port_keys = _keys(5, 64)
    want = jax.random.key_data(jax.vmap(lambda k: jax.random.split(k, n))(keys))
    np.testing.assert_array_equal(prng.split(port_keys, n).numpy(), np.asarray(want))


@pytest.mark.parametrize("width,dtype", [(32, jnp.uint32), (64, jnp.uint64)])
def test_bits_match_jax(width, dtype):
    keys, port_keys = _keys(6, 2048)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (), dtype))(keys))
    got = prng.bits(port_keys, width).numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, want.astype(np.uint64))


EXACT_RANGES = ((0.0, 1.0), (-1.0, 1.0), (0.5, 1.5))   # exact affine maps
INEXACT_RANGES = ((0.3, 7.1), (-2.5, 0.1))


@pytest.mark.parametrize("name,lo,hi", [
    *(("float32", lo, hi) for lo, hi in EXACT_RANGES + INEXACT_RANGES),
    *(("float64", lo, hi) for lo, hi in EXACT_RANGES)])
def test_uniform_matches_jax_bit_for_bit(name, lo, hi):
    jdt, tdt, _ = DTYPES[name]
    keys, port_keys = _keys(7, 4096)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), jdt, lo, hi))(keys))
    got = prng.uniform(port_keys, tdt, lo, hi).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= lo and got.max() < hi


def test_uniform_float64_inexact_ranges_within_one_product_ulp():
    keys, port_keys = _keys(8, 4096)
    for lo, hi in INEXACT_RANGES:
        want = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (), jnp.float64, lo, hi))(keys))
        got = prng.uniform(port_keys, torch.float64, lo, hi).numpy()
        assert (np.abs(got - want) <= np.spacing(max(abs(lo), abs(hi)))).all()


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("dist", ["normal", "exponential"])
def test_normal_and_exponential_within_ulps(name, dist):
    jdt, tdt, ulps = DTYPES[name]
    keys, port_keys = _keys(10, 8192)
    want = np.asarray(jax.vmap(lambda k: getattr(jax.random, dist)(k, (), jdt))(keys))
    got = getattr(prng, dist)(port_keys, tdt).numpy()
    assert got.dtype == want.dtype
    eps = np.finfo(want.dtype).eps
    err = np.abs(got.astype(np.float64) - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= ulps * eps, err.max() / eps


SHAPES = ((7,), (3, 4, 5), (2, 1, 1), (4, 300))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 17])
def test_shaped_draws_match_jax(seed, shape):
    """Element i of a draw of shape S is threefry2x32(key, (i >> 32, i &
    0xFFFFFFFF)): uniform and bits bit for bit, normal within its ulps."""
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed, device="cpu")
    np.testing.assert_array_equal(
        prng.bits(tk, 32, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    for lo, hi in ((0.15, 0.6), (0.0, 5.0), (-1.0, 1.0)):
        got = prng.uniform(tk, torch.float32, lo, hi, shape).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax.random.uniform(
            jk, shape, jnp.float32, lo, hi)))
    want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    got = prng.normal(tk, torch.float32, shape).numpy()
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= DTYPES["float32"][2] * np.finfo(np.float32).eps


def test_shaped_draws_batch_over_keys():
    """Keys (K, 2) and shape S give (K,) + S, each key its own draw."""
    keys = prng.split(prng.key(3, device="cpu"), 4)
    got = prng.uniform(keys, torch.float32, 0.0, 1.0, (2, 3))
    assert got.shape == (4, 2, 3)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(),
                                      prng.uniform(keys[i], torch.float32, 0.0, 1.0, (2, 3)).numpy())


@pytest.mark.parametrize("lo,hi", [(0, 512), (0, 64), (-5, 70000), (0, 2**31 - 1),
                                   (-2**31, 2**31 - 1)])
def test_randint_matches_jax_bit_for_bit(lo, hi):
    for seed in (0, 12345):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (4, 300), lo, hi,
                                             jnp.int32))
        got = prng.randint(prng.key(seed, device="cpu"), (4, 300), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        prng.randint(prng.key(0, device="cpu"), (2,), 5, 5)


def test_key_checks():
    with pytest.raises(ValueError):
        prng.fold_in(torch.zeros(3, dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        prng.key(2**64)
    with pytest.raises(ValueError):
        prng_key_from_numpy(np.zeros((2,), np.int32))
    with pytest.raises(TypeError):
        prng.uniform(prng.key(0, device="cpu"), torch.float16)
