"""The port's device mesh (``parallel/mesh.py``) against the contract of
the JAX package's (``tests/test_parallel.py``), put in ranks: a world of
one process here, and a launched world of four gloo CPU ranks
(``parallel._ranks.mesh_contract``), whose results come back as JSON."""

import json

import numpy as np
import pytest
import torch

from iv_interpolation_tpu.parallel import mesh as ref_mesh
from iv_interpolation_tpu_torch.parallel import dryrun
from iv_interpolation_tpu_torch.parallel import mesh as pmesh

N = 4


@pytest.fixture(scope="module")
def world4():
    """Each rank's result of the contract body in a world of 4."""
    results = dryrun.spawn_world(N, ["-m", "iv_interpolation_tpu_torch.parallel._ranks",
                                     "mesh_contract", json.dumps({"device": "cpu"})],
                                 timeout_s=60, wait_s=120)
    assert all(r["jax_free"] for r in results)
    return [r["result"] for r in results]


def test_one_process_is_a_world_of_one():
    mesh = pmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "slice": 1} and mesh.axis_names == ("data", "slice")
    assert pmesh.launched_world() == 1 and pmesh.world_info()["backend"] is None
    with pytest.raises(ValueError, match="!= 1 ranks"):
        pmesh.make_mesh((2, 1), device="cpu")
    # the JAX package's pipeline_mesh contract, put in ranks
    assert pmesh.pipeline_mesh(None, device="cpu") is None
    assert pmesh.pipeline_mesh((1,), device="cpu") is None
    assert pmesh.pipeline_mesh((1, 1), ("data", "slice"), device="cpu") is None
    with pytest.raises(ValueError, match="needs 2 ranks; 1 launched"):
        pmesh.pipeline_mesh((2,), device="cpu")
    with pytest.raises(ValueError, match="visible"):
        ref_mesh.pipeline_mesh((16,))
    x = torch.arange(6.0)
    assert pmesh.shard_rows(None, x) is x and pmesh.gather_rows(None, x) is x
    assert pmesh.shard_rows(mesh, x) is x and pmesh.gather_rows(mesh, x, rows=6) is x


def test_backend_rule():
    """nccl only when every local rank has a card of its own."""
    assert pmesh.choose_backend("cpu", 1) == "gloo"
    assert pmesh.choose_backend("cpu", 4) == "gloo"
    cards = torch.cuda.device_count()
    assert pmesh.choose_backend("cuda", cards + 1) == "gloo"
    if cards:
        assert pmesh.choose_backend("cuda", cards) == "nccl"


def test_pad_to_multiple_matches_jax():
    for n, m in ((5, 4), (8, 4), (0, 3), (17, 8)):
        assert pmesh.pad_to_multiple(n, m) == ref_mesh.pad_to_multiple(n, m)


def test_make_mesh_and_pipeline_mesh_in_ranks(world4):
    """make_mesh's default and pipeline_mesh's shapes, names and refusals
    at a world of 4 ranks, as the JAX package's at 8 devices."""
    jax_default = dict(ref_mesh.make_mesh().shape)
    assert list(jax_default) == ["data", "slice"] and jax_default["slice"] == 1
    jax_gen = dict(ref_mesh.pipeline_mesh((4, 1)).shape)
    jax_2d = dict(ref_mesh.pipeline_mesh((2, 2), ("data", "slice")).shape)
    for r, res in enumerate(world4):
        assert res["world"] == N and res["rank"] == r and res["backend"] == "gloo"
        assert res["default"] == {"data": N, "slice": 1}
        assert res["pipeline_none"] == {"data": N}
        assert res["pipeline_one"] is None
        assert res["pipeline_gen"] == jax_gen == {"data": N, "ax1": 1}
        assert res["pipeline_2d"] == jax_2d == {"data": 2, "slice": 2}
        assert res["pipeline_2d_axes"] == {"data": [2, r // 2], "slice": [2, r % 2]}
        assert f"needs {2 * N} ranks; {N} launched" in res["too_big"]
        assert f"covers {N // 2} of {N} launched ranks" in res["partial"]
        assert f"!= {N} ranks" in res["make_wrong"]


def test_shard_and_gather_rows(world4):
    for r, res in enumerate(world4):
        assert res["block"] == [float(3 * i) for i in range(4 * r, 4 * r + 4)]
        assert res["numpy_block"] == res["block"]
        # a dim 0 below the axis or not a multiple of it passes through
        assert [tuple(s) for s in res["passthrough"]] == [(N - 1, 2), (4 * N + 1, 2)]
        assert tuple(res["expect_dim0"]) == (4 * N, 3)
        assert res["gather_equal"] is True
        assert res["gather_dst0"] == (True if r == 0 else None)
        assert tuple(res["shard_batch_axis1"]) == (3, 2)


def test_collectives_and_agreement(world4):
    for res in world4:
        assert res["psum"] == sum(range(1, N + 1))
        assert res["any_rank"] is True
        assert res["agree"] == f"rank {N - 1}: RuntimeError: boom"
