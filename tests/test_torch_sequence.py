"""Sequence-parallel interpolation of the port (``parallel/sequence.py``)
in a launched world of four gloo CPU ranks, against the JAX package's
``sharded_masked_interp`` on the suite's 8-device mesh and its
``masked_interp``: the cases of ``tests/test_sequence.py``, float64 within
1e-12 with NaN equal to NaN, and the bfloat16 positions case exact. Each
rank also fills its chunk alone (``local_masked_interp``), which must be
its slice of the whole result bit for bit."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_interpolation_tpu.ops.interp import masked_interp as ref_masked_interp
from iv_interpolation_tpu.parallel.mesh import make_mesh as ref_make_mesh
from iv_interpolation_tpu.parallel.sequence import sharded_masked_interp as ref_sharded
from iv_interpolation_tpu_torch.ops.interp import masked_interp
from iv_interpolation_tpu_torch.parallel import dryrun

RANKS = 4


def _gappy(rng, shape, frac=0.8):
    vals = rng.normal(size=shape) + 5.0
    vals[rng.uniform(size=shape) < frac] = np.nan
    return vals


def _cases():
    """name -> (values, mask, method, max_gap_minutes, bf16)."""
    rng = np.random.default_rng(12345)
    out = {}
    for method in ("linear", "ffill"):
        for frac in (0.5, 0.95):
            vals = _gappy(rng, (1024,), frac)
            vals[1024 // 3] = 7.0  # at least one valid point
            out[f"{method}_{frac}"] = (vals, np.ones(1024, bool), method, 0, False)
    vals = _gappy(rng, (5, 512), 0.7)
    vals[:, 256] = 3.0
    out["columns"] = (vals, np.ones((5, 512), bool), "linear", 0, False)
    vals = np.full(800, np.nan)
    vals[10], vals[790] = 1.0, 2.0  # a gap across every seam
    out["seams"] = (vals, np.ones(800, bool), "linear", 0, False)
    vals = np.full(800, np.nan)
    vals[0], vals[50], vals[700] = 1.0, 2.0, 3.0
    out["max_gap"] = (vals, np.ones(800, bool), "linear", 100, False)
    vals = np.full(2048, np.nan)
    vals[700], vals[1500] = 4.0, 8.0  # positions beyond bf16's exact integers
    out["bf16"] = (vals, np.ones(2048, bool), "linear", 0, True)
    # a timeline mask with padding and a batch of rows of another shape
    vals = _gappy(rng, (3, 2, 640), 0.9)
    vals[..., 5] = 1.5
    mask = np.ones((3, 2, 640), bool)
    mask[..., 600:] = False
    out["masked_rows"] = (vals, mask, "ffill", 0, False)
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence")
    np.savez(tmp / "cases.npz", **{f"{k}_values": v[0] for k, v in CASES.items()},
             **{f"{k}_mask": v[1] for k, v in CASES.items()})
    spec = {k: [v[2], v[3], v[4]] for k, v in CASES.items()}
    args = {"device": "cpu", "out": str(tmp), "cases": str(tmp / "cases.npz"),
            "spec": json.dumps(spec)}
    results = dryrun.spawn_world(RANKS, ["-m", "iv_interpolation_tpu_torch.parallel._ranks",
                                         "sequence", json.dumps(args)],
                                 timeout_s=60, wait_s=120)
    assert all(r["jax_free"] for r in results)
    return dict(np.load(tmp / "sequence.npz"))


@pytest.mark.parametrize("name", [k for k in CASES if k != "bf16"])
def test_sharded_matches_jax_and_masked_interp(got, name):
    vals, mask, method, max_gap, _ = CASES[name]
    ref_mesh = ref_make_mesh((8, 1))
    jax_sharded = np.asarray(ref_sharded(jnp.asarray(vals), jnp.asarray(mask), ref_mesh,
                                         method=method, max_gap_minutes=max_gap))
    jax_whole = np.asarray(ref_masked_interp(jnp.asarray(vals), jnp.asarray(mask),
                                             method=method, max_gap_minutes=max_gap))
    port_whole = masked_interp(torch.as_tensor(vals), torch.as_tensor(mask), method=method,
                               max_gap_minutes=max_gap).numpy()
    np.testing.assert_allclose(got[name], jax_sharded, rtol=0, atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(got[name], jax_whole, rtol=0, atol=1e-12, equal_nan=True)
    # on one package, the sharded fill is the whole-timeline fill bit for bit
    np.testing.assert_array_equal(got[name], port_whole)
    assert bool(got[f"{name}_local_equal"])
    if name == "seams":
        np.testing.assert_allclose(got[name][400], 1.0 + (400 - 10) / 780.0, atol=1e-12)
    if name == "max_gap":
        assert np.isnan(got[name][300]) and np.isfinite(got[name][25])


def test_bf16_positions_survive_all_gather(got):
    """Positions ride an int64 all-gather, not the values' dtype: the
    bfloat16 fill across seams equals the whole-timeline fill exactly."""
    vals, mask, *_ = CASES["bf16"]
    v16 = torch.as_tensor(vals).to(torch.bfloat16)
    port_whole = masked_interp(v16, torch.as_tensor(mask)).float().numpy()
    np.testing.assert_array_equal(got["bf16"], port_whole)
    jax_whole = np.asarray(ref_masked_interp(jnp.asarray(vals, jnp.bfloat16),
                                             jnp.asarray(mask)), np.float32)
    np.testing.assert_array_equal(got["bf16"], jax_whole)
    assert bool(got["bf16_local_equal"])
