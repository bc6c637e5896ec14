"""Port parity: each bench stage (``iv_interpolation_tpu_torch/bench.py``)
at its smoke shape on CPU tensors against the root ``bench.py``'s on
JAX's CPU, both given ``np.random.default_rng(SEED)``, so both draw the
same seeds and make the same inputs (``test_torch_bench.py`` holds the
generators).

Tolerances, each that of the port's own test of the function:
* spline: batch and butterfly fractions equal; the fast path's error
  against SciPy within 1024 float32 ulps of max |w| of JAX's
  (``test_torch_spline_matrix.py``) and under 5e-6;
* parity: the error against SciPy within 2e-9 of JAX's and under 1e-9
  (``test_torch_models.py``: the pair's sum within 2e-9 of JAX's);
* svi, essvi: rmse within 5e-5 of max |w| of JAX's (float32 fits: fitted
  w within 5e-5 of the w scale, ``test_torch_svi.py`` and
  ``test_torch_essvi.py``);
* rbf, rbf_reduced: the arbitrage-free fraction equal;
* ah: the arbitrage-free fraction equal, price rmse within 1024 float32
  ulps of the unit price (``test_torch_andreasen_huge.py``);
* streaming: both measure a rate (its values are held in
  ``test_torch_streaming.py``).
"""

import jax
import numpy as np
import pytest
import torch

from iv_interpolation_tpu_torch import bench as port

SEED = 0
EPS32 = float(np.finfo(np.float32).eps)
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")

# the smoke shapes of bench.py's _stage_* functions
SMOKE = {
    "spline": ("bench_spline", dict(batch_sizes=(512,))),
    "parity": ("bench_parity", dict(B=512)),
    "svi": ("bench_svi", dict(B=16, n_iters=4)),
    "essvi": ("bench_essvi", dict(B=16, n_iters=4)),
    "streaming": ("bench_streaming", dict(B=8, L_ticks=256, n_minutes=64)),
    "rbf": ("bench_rbf", dict(B=2, N=128, n_iters=2)),
    "rbf_reduced": ("bench_rbf", dict(B=2, N=128, n_iters=2, n_centers=32)),
    "ah": ("bench_ah", dict(B=2, n_iters=2, n_grid=65)),
}


@pytest.fixture(scope="module")
def ref():
    """The root ``bench.py``, with JAX's cache settings put back."""
    before = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    import bench
    for k, v in before.items():
        jax.config.update(k, v)
    return bench


def _w_scale(name, kw):
    """max |w| of the stage's first timed input set (the one its rmse is
    taken on), from the port's generator."""
    seed0 = int(np.random.default_rng(SEED).integers(0, 2**31 - 16))
    k_row = np.linspace(-1.2, 1.2, port.N_K, dtype=np.float32)
    if name == "svi":
        w = port._svi_gen(kw["B"], k_row, "cpu")(seed0)
    else:
        k = torch.from_numpy(np.broadcast_to(k_row, (kw["B"], port.E, port.N_K)).copy())
        w = port._essvi_gen(k)(seed0)
    return float(w.abs().max())


def test_smoke_shapes_are_the_stages():
    assert sorted(SMOKE) == sorted(name for name, _ in port.STAGES)


@pytest.mark.parametrize("name", list(SMOKE))
def test_stage_matches_bench(ref, name):
    fn, kw = SMOKE[name]
    want = getattr(ref, fn)(np.random.default_rng(SEED), **kw)
    calls = []
    got = getattr(port, fn)(np.random.default_rng(SEED), device="cpu", calls=calls, **kw)
    assert calls and all(len(c["host_s"]) in (3, 5) for c in calls)
    if name == "streaming":
        assert got > 0 and want > 0
        return
    assert got[0] > 0 and len(got) == len(want)
    if name == "spline":
        assert got[1] == want[1]
        acc, ref_acc = got[2], want[2]
        for key in ("butterfly_clean_frac", "butterfly_adversarial_frac"):
            assert acc[key] == ref_acc[key], key
        assert acc["butterfly_clean_frac"] == 1.0
        w_max = (0.6 + 0.3) ** 2 * 2.0            # atm + curv at |k| = 1, T = 2
        assert abs(acc["parity_max_err"] - ref_acc["parity_max_err"]) <= 1024 * EPS32 * w_max
        assert acc["parity_max_err"] < 5e-6
    elif name == "parity":
        assert abs(got[1] - want[1]) <= 2e-9 and got[1] < 1e-9
    elif name in ("svi", "essvi"):
        assert abs(got[1] - want[1]) <= 5e-5 * _w_scale(name, kw), (got[1], want[1])
    elif name in ("rbf", "rbf_reduced"):
        assert got[1] == want[1]
    else:
        assert got[1] == want[1] == 1.0
        assert abs(got[2] - want[2]) <= 1024 * EPS32, (got[2], want[2])
