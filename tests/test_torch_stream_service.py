"""The port's ``StreamingSession`` over a mesh of ranks: a launched world
of 2 gloo CPU ranks (``parallel._ranks.session``), each holding its block
of 16 underlyings' chains, operators and tick ring, fed the same ticks in
3 calls with a refit after each. Every refit equals the one-process
session's bit for bit, and the JAX session on its 8-device mesh
(``tests/test_stream_service.py``'s mesh case) at
``tests/test_torch_streaming.py``'s tolerances."""

import json
import pickle

import numpy as np
import pytest
import torch

from iv_interpolation_tpu.parallel.mesh import pipeline_mesh as ref_pipeline_mesh
from iv_interpolation_tpu.pipeline import stream_service as ref_svc
from iv_interpolation_tpu_torch.parallel import dryrun
from iv_interpolation_tpu_torch.pipeline import stream_service as port_svc
from iv_interpolation_tpu_torch.pipeline.streaming import StreamingOut
from test_torch_streaming import _assert_out, _chains, _tick_frames

B, E, N, W, CAP, GRID = 16, 4, 12, 64, 256, 16


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    unds = [f"u{i}" for i in range(B)]
    k, iv, T = _chains(B, E, N, rng)
    return unds, k, iv, T, _tick_frames(rng, unds + ["unknown"], 3, 40, W)


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("session")
    unds, k, iv, T, frames = inputs
    with open(tmp / "chains.pkl", "wb") as f:
        pickle.dump((unds, k, iv, T), f)
    with open(tmp / "ticks.pkl", "wb") as f:
        pickle.dump(frames, f)
    args = {"device": "cpu", "out": str(tmp), "chains": str(tmp / "chains.pkl"),
            "ticks": str(tmp / "ticks.pkl"), "window": W, "capacity": CAP, "n_grid": GRID}
    results = dryrun.spawn_world(2, ["-m", "iv_interpolation_tpu_torch.parallel._ranks",
                                     "session", json.dumps(args)], timeout_s=60, wait_s=180)
    assert all(r["jax_free"] for r in results)
    return [r["result"] for r in results], dict(np.load(tmp / "session.npz"))


def _unpack(saved, i):
    """Refit ``i`` of the saved arrays as a ``StreamingOut`` of tensors."""
    from iv_interpolation_tpu_torch.ops.segment_ohlcv import Candles
    fields = {}
    for name in StreamingOut._fields:
        if name.startswith("candles"):
            fields[name] = Candles(**{f: torch.as_tensor(saved[f"{i}_{name}_{f}"])
                                      for f in Candles._fields})
        else:
            fields[name] = torch.as_tensor(saved[f"{i}_{name}"])
    return StreamingOut(**fields)


def test_each_rank_holds_its_block(world):
    results, _ = world
    assert [r["rows"] for r in results] == [[0, B // 2], [B // 2, B]]
    assert all(r["ring_rows"] == B // 2 for r in results)


def test_session_over_a_mesh_equals_one_process_and_jax(world, inputs):
    results, saved = world
    unds, k, iv, T, frames = inputs
    port = port_svc.StreamingSession(unds, k, iv, T, window_minutes=W, tick_capacity=CAP,
                                     n_grid=GRID, device="cpu")
    ref = ref_svc.StreamingSession(unds, k, iv, T, window_minutes=W, tick_capacity=CAP,
                                   n_grid=GRID, mesh=ref_pipeline_mesh((8,)))
    for i, frame in enumerate(frames):
        port.ingest_ticks(frame)
        ref.ingest_ticks(frame)
        got, want, jax_out = _unpack(saved, i), port.refit(), ref.refit()
        for a, b in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        _assert_out(got, jax_out, volume_atol=4e-7 * 5 * 180 + 1e-5)
    assert results[0]["stats"] == results[1]["stats"] == port.stats() == ref.stats()
