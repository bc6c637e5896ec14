"""The port's entry points run on the card unless the caller asks for the
CPU: called without ``device``, each one targets ``"cuda"``. On a torch
built without CUDA (the CPU test tier) that raises instead of quietly
computing on the CPU; on a machine with a card the result lies on it.
"""

import inspect
import types

import numpy as np
import pytest
import torch

from iv_interpolation_tpu_torch import convert
from iv_interpolation_tpu_torch.ops import prng
from iv_interpolation_tpu_torch.ops.spline_matrix import SplineOperator
from iv_interpolation_tpu_torch.pipeline import ringbuffer, stream_service
from iv_interpolation_tpu_torch.pipeline.ringbuffer import RingState
from iv_interpolation_tpu_torch.surface.surface import SurfaceFit


def _chains(B=2, E=3, n=10):
    k = np.broadcast_to(np.linspace(-0.8, 0.8, n), (B, E, n)).copy()
    T = np.broadcast_to(np.linspace(0.1, 1.0, E), (B, E)).copy()
    return k, 0.4 + 0.05 * k * k, T


def _fields(cls, shape=(2, 3)):
    return types.SimpleNamespace(**{f: np.zeros(shape) for f in cls._fields})


ENTRY_POINTS = {
    "StreamingSession": (stream_service.StreamingSession,
                         lambda: stream_service.StreamingSession(
                             ["a", "b"], *_chains(), window_minutes=16,
                             tick_capacity=32, n_grid=5),
                         lambda s: s.chain_k),
    "make_ring": (ringbuffer.make_ring, lambda: ringbuffer.make_ring(2, 3, 8),
                  lambda r: r.data),
    "spline_operator_from_numpy": (convert.spline_operator_from_numpy,
                                   lambda: convert.spline_operator_from_numpy(
                                       _fields(SplineOperator)),
                                   lambda op: op[0]),
    "ring_state_from_numpy": (convert.ring_state_from_numpy,
                              lambda: convert.ring_state_from_numpy(_fields(RingState)),
                              lambda r: r.data),
    "surface_fit_from_numpy": (convert.surface_fit_from_numpy,
                               lambda: convert.surface_fit_from_numpy(types.SimpleNamespace(
                                   method="cubic_spline",
                                   **{f: np.zeros((2, 3)) for f in
                                      ("k", "expiries", "w", "coefs")})),
                               lambda fit: fit.w),
    "prng_key_from_numpy": (convert.prng_key_from_numpy,
                            lambda: convert.prng_key_from_numpy(np.zeros((4, 2), np.uint32)),
                            lambda k: k),
    "prng.key": (prng.key, lambda: prng.key(7), lambda k: k),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    fn, call, tensor_of = ENTRY_POINTS[name]
    sig = inspect.signature(fn)
    assert sig.parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert tensor_of(call()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()


def test_replay_without_a_device_targets_the_card(monkeypatch):
    """``run_stream_replay(device=None)`` means the card: with no card it
    raises, and no lookup of ``torch.cuda.is_available`` turns it into a
    CPU run."""
    assert "is_available" not in inspect.getsource(stream_service.run_stream_replay)
    config = types.SimpleNamespace(surface=types.SimpleNamespace(grid_strikes=5))
    replay = lambda: stream_service.run_stream_replay(
        config, n_underlyings=2, window_minutes=16, chunks=2, ticks_per_chunk=8)
    if torch.cuda.is_available():
        assert replay()["device"].startswith("cuda")
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        replay()


def test_cpu_callers_pass_device_cpu():
    """The same entry points run on the CPU when asked to."""
    sess = stream_service.StreamingSession(["a", "b"], *_chains(), window_minutes=16,
                                           tick_capacity=32, n_grid=5, device="cpu")
    assert sess.ring.data.device.type == "cpu"
    assert prng.key(7, device="cpu").device.type == "cpu"
    assert ringbuffer.make_ring(2, 3, 8, device="cpu").valid.device.type == "cpu"
    config = types.SimpleNamespace(surface=types.SimpleNamespace(grid_strikes=5))
    out = stream_service.run_stream_replay(config, n_underlyings=2, window_minutes=16,
                                           chunks=2, ticks_per_chunk=8, device="cpu")
    assert out["device"] == "cpu" and out["ticks_ingested"] == 2 * 2 * 8


def test_runner_and_cli_default_to_the_card(monkeypatch, tmp_path):
    """``PipelineRunner`` and ``iv-tpu-torch`` target ``"cuda"`` unless
    told ``device="cpu"`` / ``--device cpu``; without a card they raise
    before reading the store."""
    from iv_interpolation_tpu_torch import cli
    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline.runner import PipelineRunner
    from iv_interpolation_tpu_torch.pipeline.storage import MemoryStore

    monkeypatch.chdir(tmp_path)
    assert inspect.signature(PipelineRunner).parameters["device"].default == "cuda"
    assert cli.build_parser().get_default("device") == "cuda"
    argv = ["--task", "pipeline", "--storage", "memory", "--test", "--json"]
    if torch.cuda.is_available():
        assert PipelineRunner(get_config("testing"), MemoryStore()).device.type == "cuda"
        assert cli.main(argv) == 0
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        PipelineRunner(get_config("testing"), MemoryStore())
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        cli.main(argv)
    assert PipelineRunner(get_config("testing"), MemoryStore(), device="cpu").device.type == "cpu"
    assert cli.main(argv + ["--device", "cpu"]) == 0


def test_surface_and_serve_entry_points_default_to_the_card():
    """``run_surface_fit``, ``build_session``, ``run_serve`` and
    ``run_serve_flight`` target ``"cuda"`` unless told ``device="cpu"``;
    without a card they raise instead of fitting on the CPU."""
    import pandas as pd

    from iv_interpolation_tpu_torch.config import get_config
    from iv_interpolation_tpu_torch.pipeline import flight_service, serve, surface_task
    from iv_interpolation_tpu_torch.pipeline import storage as st

    for fn in (surface_task.run_surface_fit, serve.build_session, serve.run_serve,
               flight_service.run_serve_flight):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        return
    cfg = get_config("testing")
    store = st.MemoryStore()
    store.write(st.INTERPOLATED, pd.DataFrame({
        "symbol": [f"btc-27mar23-{k}-c" for k in (20000, 22000, 24000, 26000)],
        "date": pd.Timestamp("2023-03-20"), "iv": 0.5, "underlying_price": 23000.0,
        "time_to_maturity": 0.25}))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        surface_task.run_surface_fit(cfg, store)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        serve.build_session(cfg, st.MemoryStore())
    assert surface_task.run_surface_fit(cfg, store, device="cpu")["surfaces"] == 1
