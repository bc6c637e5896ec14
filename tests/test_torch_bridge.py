"""Port parity: the synthetic-OHLCV bridge (``ops/bridge.py``) against the
JAX package's ``ops/bridge.py``, on the same keys.

The port draws the JAX package's numbers (``ops.prng``), so the bridge
is compared value by value:

* float64: open/high/low/close/volume to 1e-12 of max(1, |x|) (the
  doubling scan composes the trend recurrence in another order than
  ``associative_scan``; prices are rounded to 1e-4 after it, and a
  float64 difference that crosses a rounding half-step is improbable at
  these sizes); ``valid`` exact.
* float32: each value within 8 ulps of |x| plus one 1e-4 rounding step
  (XLA fuses multiply-adds the port rounds twice, and the 1e-4 rounding
  can land on either side of a half-step). spread_simulation's
  minimum-spread rule is a threshold test on high - low: a row within
  ulps of it may take the other branch in one package, and then its
  high and low sit at the narrow band mid +/- base * min_spread / 2 in
  that package. Such rows are counted (at most 1 % of rows) and each
  must be one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops import bridge as ref
from iv_interpolation_tpu_torch.convert import prng_key_from_numpy
from iv_interpolation_tpu_torch.ops import bridge as port

STRATEGIES = ("spread_simulation", "price_midpoint", "trend_following",
              "simple_spread")
PRICES = ("open", "high", "low", "close")


def _series(rng, B, L, dtype, start_minute=29_000_000):
    base = 100 * np.exp(np.cumsum(rng.normal(0, 0.002, (B, L)), axis=-1))
    base[0, :7] = np.nan                  # leading invalid rows
    base[-1, 50:60] = -1.0                # non-positive price: skipped
    volume = rng.exponential(10, (B, L))
    volume[:, ::9] = 0.0                  # imputed
    volume[-1, ::5] = np.nan              # imputed
    valid = rng.uniform(size=(B, L)) < 0.9
    minutes = start_minute + np.arange(L)[None, :] + 1000 * np.arange(B)[:, None]
    return base.astype(dtype), volume.astype(dtype), valid, minutes


def _run(base, volume, valid, minutes, strategy, params, seed=7):
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(seed), jnp.arange(base.shape[0]))
    want = jax.vmap(lambda b, v, ok, k, m: ref.synthesize_ohlcv(
        b, v, ok, k, params=ref.BridgeParams(*params), strategy=strategy,
        abs_minutes=m))(*map(jnp.asarray, (base, volume, valid)), keys,
                        jnp.asarray(minutes))
    got = port.synthesize_ohlcv(
        *map(torch.from_numpy, (base, volume, valid)),
        prng_key_from_numpy(np.asarray(jax.random.key_data(keys)), device="cpu"),
        params=port.BridgeParams(*params), strategy=strategy,
        abs_minutes=torch.from_numpy(minutes))
    return {k: v.numpy() for k, v in got.items()}, jax.tree.map(np.asarray, want)


def _assert_bridge(got, want, base, params, strategy):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    ok = want["valid"]
    for f in PRICES + ("volume",):
        assert got[f].dtype == want[f].dtype
        np.testing.assert_array_equal(np.isnan(got[f]), np.isnan(want[f]), err_msg=f)
    if got["open"].dtype == np.float64:
        for f in PRICES + ("volume",):
            np.testing.assert_allclose(got[f][ok], want[f][ok], rtol=1e-12, atol=1e-12,
                                       err_msg=f)
        return
    eps = float(np.finfo(np.float32).eps)
    off = np.zeros(ok.shape, bool)
    for f in PRICES + ("volume",):
        a, b = got[f].astype(np.float64), want[f].astype(np.float64)
        off |= ok & (np.abs(a - b) > 8 * eps * np.abs(b) + 1e-4)
    if strategy != "spread_simulation":
        assert not off.any()
        return
    assert off.sum() <= 0.01 * ok.sum()
    band = base.astype(np.float64) * params[2]           # min spread
    for o in (got, want):
        o["narrow"] = np.abs((o["high"] - o["low"]) - band) <= 2e-4 + 16 * eps * base
    assert (got["narrow"] | want["narrow"])[off].all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategies_match_jax(rng, dtype, strategy):
    L = 160 if strategy == "trend_following" else 600
    base, volume, valid, minutes = _series(rng, 4, L, dtype)
    params = tuple(ref.BridgeParams())
    got, want = _run(base, volume, valid, minutes, strategy, params)
    _assert_bridge(got, want, base, params, strategy)
    # OHLC relations hold on every valid row of the port's candles
    _, ok = port.validate_bridge_quality(*(torch.from_numpy(got[f]) for f in PRICES),
                                         torch.from_numpy(base),
                                         torch.from_numpy(got["valid"]))
    assert ok.all()


def test_custom_params_and_default_minutes_match_jax(rng):
    base, volume, valid, _ = _series(rng, 3, 300, np.float64)
    params = (0.004, 2.5, 0.001, 0.3, 20.0)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.key(3), jnp.arange(3))
    want = jax.vmap(lambda b, v, ok, k: ref.synthesize_ohlcv(
        b, v, ok, k, params=ref.BridgeParams(*params)))(
        *map(jnp.asarray, (base, volume, valid)), keys)
    got = port.synthesize_ohlcv(*map(torch.from_numpy, (base, volume, valid)),
                                prng_key_from_numpy(np.asarray(jax.random.key_data(keys)),
                                                    device="cpu"),
                                params=port.BridgeParams(*params))
    # (0.5, 2.5) has an inexact affine map: float64 uniform draws may sit
    # one ulp apart (see the prng tests), well inside 1e-12
    _assert_bridge({k: v.numpy() for k, v in got.items()},
                   jax.tree.map(np.asarray, want), base, params, "spread_simulation")


@pytest.mark.parametrize("L", [1, 2, 7, 64, 1000])
def test_linear_recurrence_matches_associative_scan(rng, L):
    valid = rng.uniform(size=(3, L)) < 0.8
    m = np.where(valid, -0.15, 1.0)
    a = np.where(valid, rng.uniform(90, 110, (3, L)), 0.0)
    want = np.asarray(ref._linear_recurrence(jnp.asarray(m), jnp.asarray(a)))
    got = port._linear_recurrence(torch.from_numpy(m), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    # against the sequential loop it replaces
    x, seq = 0.0, np.empty(L)
    for t in range(L):
        x = a[0, t] + m[0, t] * x
        seq[t] = x
    np.testing.assert_allclose(got[0], seq, rtol=1e-13, atol=0)


def test_deterministic_and_grid_alignment_free(rng):
    """A minute's candle depends on (key, minute), not on its grid slot."""
    base, volume, valid, minutes = _series(rng, 1, 200, np.float64)
    valid[:] = True
    base[:] = np.abs(np.nan_to_num(base, nan=100.0)) + 1.0
    key = prng_key_from_numpy(np.asarray(jax.random.key_data(jax.random.key(5))),
                              device="cpu")[None]
    run = lambda sl: port.synthesize_ohlcv(
        *(torch.from_numpy(a[:, sl]) for a in (base, volume, valid)), key,
        strategy="price_midpoint", abs_minutes=torch.from_numpy(minutes[:, sl]))
    whole, tail = run(slice(0, 200)), run(slice(50, 200))
    for f in ("open", "close", "volume"):
        np.testing.assert_array_equal(whole[f][:, 50:].numpy(), tail[f].numpy())


def test_validate_bridge_quality_matches_jax(rng):
    base, volume, valid, minutes = _series(rng, 2, 300, np.float64)
    got, _ = _run(base, volume, valid, minutes, "spread_simulation",
                  tuple(ref.BridgeParams()))
    got["high"][1, 100] = got["low"][1, 100] - 1.0        # a broken row
    args = [got[f] for f in PRICES] + [base, got["valid"]]
    for frac in (0.1, 1e-4):
        want_all, want = ref.validate_bridge_quality(*map(jnp.asarray, args),
                                                     max_spread_frac=frac)
        ok_all, ok = port.validate_bridge_quality(*map(torch.from_numpy, args),
                                                  max_spread_frac=frac)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(want))
        assert bool(ok_all) == bool(want_all) is False
    assert not ok.numpy()[1, 100] or not got["valid"][1, 100]


def test_unknown_strategy_raises():
    x = torch.ones(1, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown conversion strategy"):
        port.synthesize_ohlcv(x, x, x > 0, torch.zeros(1, 2, dtype=torch.int64),
                              strategy="random_walk")
